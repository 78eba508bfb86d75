#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on the card, with nothing of JAX or
of the JAX package ``repro``: the brain simulation (phases 3-4), LM
serving of three architectures (phase 5) and of the mixture of experts
(phase ``serve_qwen3_moe``), the vlm and audio front ends (phase
``frontends``), LM training (phase ``train``) and the sharding layer, DTensor
and GPipe (phase ``sharding``).  Every main path runs as a user's
call runs it on the card: each step after the first replays a CUDA graph
of one step (``repro_torch.graphs``); the same run op by op
(``graph=False``, the launchers' ``--eager``) is its check.  Each phase
prints one JSON line; any failed check raises, so the script exits
nonzero.

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, the kernel build's seconds (one ``nvcc`` per source,
   all started together); TF32 off.
2. Kernels: each hand-written kernel against its plain PyTorch version
   at the main paths' shapes, two runs bit-identical.  Spike accumulation
   (firing 0 %, 1 %, one fully active block, every row, weighted spikes;
   ``spike_accum`` also at the single-device oracle's W f32[32768, 32768]
   at 2 % firing) against the plain versions on float64 copies with
   ``rtol=1e-5, atol=1e-4`` (the kernels sum in another order than the
   einsum).
   Attention on transposed views as the model passes them, float32 and
   bfloat16 at the reference's tolerances: the reference's sweep (MQA,
   bidirectional, window 96, 384 tokens, ragged ``seq_lens``),
   phi4-mini-3.8b's shapes, recurrentgemma-9b's (MQA with 16 q heads, head
   dim 256, window 2,048; decode with ``slot_pos``, also a misaligned ring
   whose valid slots are not a prefix; the window bound ``slot_lo`` a device
   scalar, as the model passes it), qwen3-moe-30b-a3b's (32 q / 4 KV heads:
   a 4-slot prefill of 1,024 tokens, decode of 4 slots at 1,040 of 1,056),
   llava-next-mistral-7b's (32 q / 8 KV heads: 2 rows of 1,024 positions,
   decode at 1,032 of 1,040) and musicgen-large's (32 / 32 heads of 64: 2
   rows of 512, decode at 520 of 528); deepseek-7b's (MHA, 32 heads of
   128), qwen2.5-14b's (GQA group 5) and yi-34b's (group 7) at phi4's wave
   shapes, mixtral-8x22b's (group 6: window 4,096 over a batch-1 prefill
   of 8,192, decode over its 4,096-slot ring after a misaligned 6,000-token
   prefill) and phi4's decode over 32,800 slots; K3 over S = 32,768 (phi4
   at batch 1; bf16 only at the dry-run's prefill_32k, batch 32, 3.2 G
   elements of q) and K4 over decode_32k's cache (bf16, batch 128, 4.3 G
   elements of K), held to the plain version on the first and last 512 q
   rows of every batch row and head / on batch rows 0, 63 and 127, with a
   zeroed 32-key tile planted past 2^31 elements that must fail the bf16
   row bound.  The sharded serving route's splits
   on one card: K3 on the second half of phi4's 1,024 prefill rows with
   ``q_offset = 512``, K4 with ``return_lse`` on each half of phi4's
   1,040-slot decode cache and of recurrentgemma's misaligned ring, each
   held to its plain version and to K3's or K4's whole run (the halves
   combined by ``combine_partials``, their log-sum-exps against the plain
   version's).  The scans against their plain
   versions on float64 copies at the reference's ``3e-3``: ``ssd_scan`` at
   the reference's sweep, chunks of 127 and 96, and mamba2-1.3b's prefill,
   its final state too; ``rglru_scan`` at the sweep and at the four shapes
   recurrentgemma-9b's prefills give it (batch 4 at 1,024 and 512 tokens,
   batch 1 at 1,024 and 4,096), each with its launch geometry
   (``rglru_plan``), the hash of its trace and the exact traces of a = b =
   1 (t + 1) and a = 0 (b).  ``threefry`` (JAX's threefry2x32 draws, no
   Pallas counterpart) against ``random.draw_ref`` at the main paths'
   shapes (``THREEFRY_CASES``: a rank-stacked LIF draw after a split, phi4's
   sampler, one full-width phi4 bf16 leaf): keys, split and bits bit-equal,
   float32 normals and gumbels within 2 ulp, bf16 normals within one bf16
   ulp; ``torch.randn`` of the same shape as the library yardstick.  Kernel, plain, library-yardstick (none for
   the scans) and bound times (``ssd_scan``'s 3xTF32 products at the TF32
   peak); at the main paths' shapes, and for every spike-accumulation
   case, also the kernel's device time (``torch.profiler``).
3. The launcher (``repro_torch.launch.run_brainsim.main``) for each of the
   four exchanges, at its defaults and with channel noise (``--noise 2``,
   which spreads the firing over the run so the rasters depend on the
   synapses and on every message): sparse == ragged == flat == two_level
   bit for bit, each replayed raster equal to the same run's with
   ``--eager``, one ``spike_accum_blocks`` launch per step, and a
   communicator that loses a message changes the noisy raster.  Then
   ``repro_torch.launch.brainsim.main`` (the port of ``examples/brainsim.py``)
   with ``--method greedy`` and ``--method multilevel``, each over the flat,
   two-level, sparse and ragged exchanges: one raster, one
   ``spike_accum_blocks`` launch per sparse or ragged step, the multilevel
   cut beside the greedy one.
4. Real size through the public API: 2,048 populations x 16 neurons =
   32,768 neurons on 8 ranks in a (2, 4) mesh under a per-neuron drive
   ``U(3, 8)`` (firing spread over the run, a few percent of the neurons
   per step), 200 steps of sparse, ragged/fused and ragged/per_round
   (identical rasters, executed bytes == ``exchange_volume`` on every
   step), replayed and, uncounted, eager: rasters and ledgers equal, ms
   per step of each, capture seconds; for sparse and ragged a profile of
   each (device ms, CUDA kernels and graph launches per step, busy share,
   and whether the profiler sees the graph's kernels).  Every replayed
   step's synaptic current equals the dense ``s @ W`` in float64; the
   raster equals the single-device engine's with the ``spike_accum``
   kernel as its current hook (replayed, and eager as its check), whose
   device time per step under the raster's own spikes is profiled in a
   second, uncounted run; a lost ragged payload changes the raster.
   ``noise_2``: the sparse run again at ``noise_sigma=2``, replayed (one
   ``threefry`` launch a step, counted), equal to its eager run, beside the
   noise-free run's ms a step, with its CUDA kernels a step.
   Beside the greedy plan, ``multilevel_partition``'s cut and host seconds
   on the same graph, and beside the closed-form latency the netsim one
   (``estimate(model="netsim")``, one switch and the reference benchmarks'
   two-tier fabric).  After the counted ragged run, planlint Layer 1 over
   the ragged plan that engine executed on ``netsim.two_tier(8, 4)``: any
   error fails the run, warnings are printed; beside the card's ms per step,
   the netsim replay of the plan's rounds (predicted wire seconds per step,
   bytes conserved and equal to the plan's; a loopback on one card, so no
   agreement is claimed).
   ``plan_paper_scale`` (host only): the paper's experiment planned by the
   port's numpy planning layer as ``benchmarks/paper_scale.py`` plans it with
   the reference's — 10 billion neurons in 8,000 populations, the
   out-of-core planner over 2,000 devices in pods of 100, the shard lints
   with PL160, Fig. 4's connection counts, the netsim replays on
   ``two_tier(2000, 100)`` and the closed-form estimates.  Zero shard lint
   errors, cross-shard conservation, conserved bytes and the reference's
   counts, or the run fails; host seconds per stage and every count beside
   the reference's value.
``recovery`` (after phase 4; replanning and recovery on phase 4's network
   and device tiles, nothing expanded again): the network laid out as
   phase 4's routing table groups it (``group_mesh_permutation``, the
   tiles moved on the card by ``permute_ranks``) runs the table's ragged
   plan; then (a) ``replan`` of an edit batch (``_edit_batch(tb, 0, 16)``)
   and (b) the fault path (a bridge of the table evacuated,
   ``replan(dead=[d])``, PL170/PL171 silent on the fault table) are each
   planned on the new table's bridges, staged in a ``PlanBuffer`` and
   flipped into the running engine (a device that changes group moves the
   layout, the tiles and the drive with it), and run 200 replayed steps:
   the raster equals an engine built from scratch on that plan and those
   tiles, the ledger the plan's ``exchange_volume`` on every step, one K1
   launch and one capture a run, and after the fault no round makes rank
   ``d`` carry a payload across the slow axis; whether each raster also
   equals phase 4's is printed.  (c) ``benchmarks/fault_bench.py``'s
   supervised LIF trajectory with its state on the card under the port's
   ``Supervisor``, ``Checkpointer`` and chaos ``supervisor_hook``: the
   committed raster bit-equal to a failure-free run, ``steps_lost`` and
   availability the reference's, every kept checkpoint verified and
   restored onto the card; beside it fault_bench's recovery
   (``evacuate_devices`` + ``replan(dead=...)``) against a rebuild, host
   seconds.  (d) ``python -m repro_torch.analysis --all --stats`` exits 0
   and ``--rules-md`` equals ``docs/RULES.md``.
``comm`` (after phase 4; the spike exchange across real processes, one
   rank each over ``torch.distributed``, phase 4's host tiles shared with
   them through ``share_memory_()``): (a) phase 4's network on 8 gloo
   processes sharing the card (mesh ``(2, 4)``, collectives staged through
   pinned host buffers, eager), 200 steps of ``sparse`` and ``ragged``:
   each process runs K1 on its own rank's tiles, 200 launches a run, and
   the gathered raster and the summed ledger (``ledger_total()``) equal
   phase 4's loopback run's on every step; the wall ms a step beside the
   loopback's (a record of the host-staged path, not a time of NCCL or of
   a fabric); (b) the launcher as a user starts it, ``python -m
   torch.distributed.run --standalone --nproc-per-node 4 -m
   repro_torch.launch.run_brainsim --backend gloo`` at its size, ``(2,
   2)``, ``--noise 2``, one run per exchange, the four side by side: rank
   0's lines, the raster and the ledger equal to the loopback launcher's;
   (c) NCCL at world size 1 on ``(1,)`` and ``(1, 1)``: the hierarchical
   collectives are the identity, and every exchange, replayed from a CUDA
   graph over the NCCL communicator, gives the loopback's raster and
   ledger (the captured NCCL calls are flat's and two_level's
   ``all_gather``; at one rank a ``ppermute`` is a local copy, and sparse
   and ragged call no collective).  Then the ``comm_nccl_multi`` line:
   NCCL across ranks takes a card per rank, so with one card it says it
   was not run.
5. Serving (``repro_torch.serve``) of phi4-mini-3.8b (attention: prefill
   runs ``flash_attention``, decode ``decode_attention``), mamba2-1.3b (24
   of its 48 ssm layers, ``SERVE_LAYERS``: prefill runs ``ssd_scan``,
   decode plain recurrence steps)
   and recurrentgemma-9b (26 rglru layers running ``rglru_scan`` in
   prefill, 12 local-attention layers with a ring-buffer cache), each
   freed before the next: (a) the reduced config, prefill of 64 tokens and
   8 teacher-forced decode steps on the card and on the CPU from the same
   numpy parameters (``init_params`` drawn on both, every leaf held card
   against CPU, then every zero-initialised leaf, such as the q/k/v
   biases, QK-norm and norm scales, made ``0.1 · normal``), logits within two bf16 steps (bf16) and 1e-3 (float32);
   (b) full width and depth, bf16, random weights from a seed (one
   ``threefry`` launch a leaf; ``leaf_card_vs_cpu``: 2^21 values of the
   last bf16 normal leaf drawn again on the CPU, within one bf16 ulp): 8
   requests (prompt lengths 64-1,000) through ``ServeEngine.generate``
   (waves of 4) and ``generate_continuous``, 64 greedy tokens each (for
   recurrentgemma-9b also one batch-1 request of 4,096 tokens, two
   windows, replayed and op by op), every prefill and every decode step launching exactly one
   kernel per layer of its mixer (no scan in decode), finite logits; the
   first wave's tokens equal under both schedulers (phi4-mini-3.8b), or,
   under float32 compute, its last request's (the only one the reference's
   initial fill of ``generate_continuous`` leaves with its own state);
   prefill(S) + decode(S) against prefill(S + 1) within 0.05 under float32
   compute (S = 861, 127, 4,096); no ssm layer recomputing its final state
   with the CPU path's closed form; prefill / decode times, tokens/s,
   launches and device busy share of decode steps, peak memory.  Each
   prefill bucket ``(batch, plen, max_len)`` is captured at its second
   call and replayed after (the continuous scheduler's batch-1 bucket: its
   eager and replayed ms a call, capture s, and both engines' device ms a
   call from the profiler, ``prefill_profile``); decode
   replays a CUDA graph per batch; the same requests eager (uncounted,
   both schedulers) give the same greedy tokens, and a teacher-forced
   window of each (profiled: device ms, kernels and graph launches per
   step, busy share) gives logits within two bf16 steps (bit-equality
   reported); capture seconds and the peak memory of each.  (c) the
   serving launcher ``python -m repro_torch.launch.serve`` at its
   defaults.
``serve_qwen3_moe`` (after phase 5): qwen3-moe-30b-a3b, layers of 128
   experts (top-8) and 32 q / 4 KV heads with QK-norm, at full width cut
   to 16 of its 48 layers (``SERVE_LAYERS``, for the script's clock; whole
   it is 30.5 B parameters, 61 GB of bf16 made on the card from seed 0),
   through phase 5's (b) with 32 greedy tokens a request (both schedulers
   run again eagerly give the replayed tokens); (a) the reduced
   qwen3-moe and mixtral-8x22b (``swa``, window 64, 8 experts: the
   reference's TP mode; at 281 GB mixtral runs reduced only) card against
   CPU; layer 0's ``moe_block`` at full width on the hidden state of a
   1,000-token prompt, card against CPU under float32 compute (the same
   experts for every token, the same kept (token, slot) pairs at the same
   places, outputs within 1e-4 of the largest); prefill(S) + decode against
   prefill(S + 1), which with experts holds to 0.05 only when prefill(S + 1)
   dropped none of the last token's slots and its capacity is prefill(S)'s
   (the drop count and both capacities are printed); the decode profile and
   peak memory as in phase 5.
``serve_deepseek_7b``, ``serve_qwen2_5_14b``, ``serve_yi_34b`` (after
   ``frontends``): the three dense configs at full width, deepseek at full
   depth (13.8 GB of bf16 from seed 0), qwen2.5 24 of its 48 layers and yi
   30 of its 60 (``SERVE_LAYERS``, for the clock; whole they are 29.6 and
   68.8 GB) through phase 5's (b) with 16 greedy tokens a request; (a) card
   against CPU at the full configs' GQA groups (qwen2.5 10 / 2, with its
   q/k/v biases; yi 14 / 2; deepseek MHA as it reduces).
``serve_mixtral_cut``: mixtral-8x22b at full width cut to its first 2 of 56
   layers (8 experts top-2 in the reference's TP mode, ``swa`` window
   4,096, 48 q / 8 KV heads), the same, plus a batch-1 prompt of 6,000
   tokens (bucket 8,192), the prefill + decode check at S = 6,000 (a
   misaligned ring) and layer 0's ``moe_block`` card against CPU; (a) at
   12 / 2 heads (group 6).
``long_context``: phi4-mini-3.8b at full width and depth, batch 1, a
   32,000-token prompt through ``generate_continuous`` (bucket 32,768, a
   cache of 32,800 slots): K3 at S = 32,768 and K4 over the whole cache in
   every layer (their call shapes checked), 16 greedy tokens replayed equal
   to eager, prefill and decode ms with device ms, peak memory; the float32
   prefill(S) + decode against prefill(S + 1) at S = 32,767 on phi4 cut to
   8 of 32 layers at full width, within 0.05.
``frontends`` (after ``serve_qwen3_moe``): llava-next-mistral-7b (576 random
   patch embeddings before 448 text tokens, 2 rows) and musicgen-large (2 ×
   512 steps of 4 codebooks) at full width and depth through ``lm.prefill``
   and 16 greedy ``lm.decode_step`` calls (the engine serves text archs, as
   the reference's): one K3 launch a layer in the prefill, one K4 launch a
   layer a step and nothing else, finite logits of the front end's shape
   (musicgen ``[B, 4, Vp]``), prefill(S) + decode against prefill(S + 1)
   within 0.05 under float32 compute, and each reduced config card against
   CPU.
``train`` (after phase 5; the lines ``train_phi4``, ``train_mamba2``, the six
   of ``TRAIN_FULL``, ``train_reduced`` and ``train_serve``): the training
   path (``repro_torch.data``, ``lm.loss_fn``, ``repro_torch.train``) on
   the card.  (a) phi4-mini-3.8b at full width,
   8 of its 32 layers (full depth's params, AdamW state and gradient sums
   alone are 76.8 GB; the reckoning is printed), and (b) mamba2-1.3b at full
   width, 24 of its 48 layers (both cut for the script's clock):
   ``SyntheticLM`` batches of 4 × 1,024 tokens (seed 0) in 2 microbatches,
   3 steps of ``compile_train_step`` (step 1 eager, step 2 captured into a
   CUDA graph and replayed, step 3 replayed; (a) under the ``Supervisor``
   with one checkpoint, step 0's; (b) in a plain loop timed the same way,
   so the script writes one multi-GB checkpoint, not two): the loss finite and
   lower at step 3 than at step 1, no gradient leaf None, all zero or
   non-finite at any step, no hand-written kernel launched (the training
   route, as the reference's training forward calls no Pallas kernel); ms
   a step (step 1 eager, the rest replayed), the capture's seconds,
   tokens/s and the model-FLOP share of the bf16 dense peak at the
   replayed steps, peak memory with the graph, (a)'s checkpoint bytes and
   wait, and a fourth, replayed step under the profiler (device and wall
   ms, busy share, the graph's CUDA kernels).  The gradient check runs
   inside the captured step and is read after each step.  Then the
   replayed-against-eager check (``_replay_vs_eager``) at full width cut
   to 2 layers, batch 4 × 512: 4 steps from one seed, two eager runs and a
   replayed one, losses, learning rates and every parameter, moment,
   master and count bit for bit (or within twice the eager runs' spread,
   should they differ), and a planted fault, a replay whose ``count`` does
   not advance, that must fail it.
   (c) ``examples/train_lm.py``'s 100m preset trained 30 steps, then served
   greedy from its trained params on the card through K3 and K4 (counted):
   the card's tokens under float32 compute equal the CPU's.  In every part
   the hand-written kernels refuse a grad-requiring input (a
   ``RuntimeError`` naming the training route, nothing launched), and step
   1's loss on the card (bf16) is within 2e-2 relative of the same params
   and batch on the CPU under float32 compute (computed in a thread while
   the Supervisor waits for its last checkpoint write: (a)'s, (b)'s and
   the small-batch ones below in (a)'s wait).
   ``TRAIN_FULL``: the families that had only served on the card, at full
   width with layers cut, in (b)'s plain loop (3 steps, 2 microbatches, AdamW
   with one warmup step to a peak of 1e-5) and (b)'s record:
   qwen3-moe-30b-a3b 2 of 48 layers (128 experts, top-8), mixtral-8x22b 1 of
   56 (top-2 of 8, GQA group 6, ``swa``), recurrentgemma-9b 3 of 38 at 2 ×
   4,096 tokens (its 2,048-token local window bites; ``rglru_trace``'s
   backward at 4,096 channels), llava-next-mistral-7b 2 of 32 (576 vision
   rows + 448 text tokens a row), musicgen-large 2 of 48 (4 codebooks),
   qwen2.5-14b 2 of 48 (q/k/v biases, group 5); the model-FLOP share counts
   the experts a token runs and the (query, key) pairs each attention layer
   keeps (``_model_flops``).  Step 1's params on row 0 of batch 0 cut to 256
   tokens (llava: 576 vision rows + 64 text tokens): the card's bf16 loss
   within 2e-2 of the CPU's float32 loss.  Each path, and ``train_reduced``
   for deepseek-7b and yi-34b, also holds its reduced config
   (``SERVE_PATHS``' heads: groups 5, 6 and 7; every zero-initialised leaf
   non-zero) card against CPU at 2 × 128 tokens, past the reduced windows of
   64 (``_train_card_vs_cpu``): float32 loss within 1e-5 and each gradient
   leaf within 1e-4 · max|g_cpu| + 1e-6, bf16 loss within 2e-2 and each
   leaf's cosine at least 0.99, and a planted fault (``TRAIN_FAULTS``)
   outside the float32 bound; and the replayed-against-eager check on the
   same reduced config at 2 × 128 (int8 residuals on deepseek, top-k on
   yi, inside the capture).
``sharding`` (after ``train``): the sharding layer (``repro_torch.sharding``)
   on the card.  (a) The DTensor train step: a world-size-1 NCCL group and
   a ``(1, 1)`` ``("data", "model")`` ``DeviceMesh``, ``make_policy``, the
   params from ``lm.distribute_params``; phi4-mini-3.8b at full width, 4 of
   its 32 layers (1.02 B parameters), ``SyntheticLM`` batch 4 x 1,024 in 2
   microbatches, AdamW, 3 steps, against the unsharded step on the same
   params and batches: every leaf and moment a DTensor whose local shard is
   the whole leaf, losses falling, step 1's loss within 2e-2 of the
   unsharded one (the largest loss and parameter differences and whether
   each is bit-equal are printed), ms a step both ways (the difference is
   DTensor's dispatch on the host) and one profiled step each way (CUDA
   kernels a step); a DTensor sent to K3's wrapper is refused with a
   ``TypeError`` and nothing launched.  (b) ``gpipe`` through
   ``LoopbackComm`` on a ``(4,)`` mesh: phi4's first 8 layers at full width,
   2 a stage, on the inference route, 4 microbatches of 2 x 1,024 tokens:
   K3 launched once a layer, stage and tick (56, counted), the output within
   two bf16 steps a row of the 8 layers applied in sequence to the whole
   batch (uncounted; bit-equality printed), ms of both, and
   ``bubble_fraction(4, 4) = 3/7``.  (c) Sharded serving: phi4 at full width
   and depth through ``ServeEngine(..., pol=make_policy(mesh))`` on a fresh
   one-rank NCCL ``(1, 1)`` mesh (params from ``lm.distribute_params``),
   phase 5's 8 requests on 4 slots, 32 greedy tokens each, both
   schedulers: every call launches its layers' K3 / K4 (counted), the
   greedy tokens equal the unsharded engine's (uncounted), decode ms a
   step (replayed: capture works at world size 1) and prefill ms a call.
   (d) ``repro_torch.roofline.count`` of phi4's decode step on that mesh at
   phase 5's decode profile's batch and cache, priced with ``H100``: the
   predicted bound, its dominant term and memory term beside phase 5's
   measured replayed device ms a step.
6. The launches of ``rglru_scan`` on recurrentgemma-9b's main path by
   input shape and by batch; a ``kernels`` line (all seven kernels; K2 at 1 %
   firing on W f32[32768, 4096] and at the oracle's shape, K3 and K4 at
   phi4-mini-3.8b's, recurrentgemma-9b's, qwen3-moe's, llava's, musicgen's,
   deepseek's, qwen2.5's, yi's and mixtral's shapes and at S = 32,768
   (phi4, the dry-run's prefill_32k and decode_32k), K6 at the batch-4
   wave and the batch-1 prefill of 1,024 tokens; K3 with ``q_offset`` and K4
   with ``return_lse`` at phi4's split shapes and recurrentgemma's ring),
   the card's name and power
   limit, and the last line, ``{"ok": true, "device": {...}}``.

Each main path (phases 3-4, each model of phase 5, ``serve_qwen3_moe``,
``frontends``, the serving paths after it, each part of phase ``train``, phase
``sharding``) runs with the
launch counts set to 0 just before it and read just after, and must have
launched each of its kernels (every path but ``recovery`` ``threefry``:
noise or weights; the training parts (a) and (b) no other; ``sharding`` K3
and K4, from its pipeline and its sharded serving); the
``kernels`` line sums them.  A process
rank of phase ``comm`` counts its own launches the same way, and K1's
row of the ``kernels`` line gives them per rank.  Runs made
only to check (probed currents, planted faults, the card-vs-CPU and
consistency checks, the profiled windows) leave the counts as they were.
Exits 2 without CUDA.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

STEPS = 100  # the launcher's default
REAL_STEPS = 200
DRIVE = (3.0, 8.0)  # per-neuron external drive at real size, uniform
TOL = dict(rtol=1e-5, atol=1e-4)
LONG_PROMPT = 4096  # recurrentgemma-9b's batch-1 request: two local windows
F32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores (data sheet)
TF32_PEAK = 494.7e12  # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """Print one JSON line; a phase's line also gets ``at_s``, the
    script's seconds when it ended."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> tuple[float, str]:
    """Published memory rate of the card (bytes/s) and which part it is."""
    if "PCIe" in name:
        return 2.0e12, "H100 PCIe, 2.0 TB/s"
    if "NVL" in name:
        return 3.9e12, "H100 NVL, 3.9 TB/s"
    return 3.35e12, "H100 SXM, 3.35 TB/s"


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(kern, plain, lib, main: bool, device: bool = False, reps: int = 20) -> dict:
    """Times of a kernel, its plain version and the library call (None
    where no single PyTorch call computes the function).  ``ms`` keys: CUDA
    events around back-to-back calls, which include the host's dispatch
    where the host is the slower side.  For a case of the main path
    (``main``), or with ``device``, also the kernel's ``device_ms``: the
    device time of the CUDA kernels a call launches, from
    ``torch.profiler``, and ``device_kernels``, its time per CUDA kernel.
    A kernel launches each of its CUDA kernels once a call, so its
    ``device_ms`` sums each CUDA kernel's mean over the calls the profiler
    saw (it now and then misses some).  The plain versions and the library
    calls are timed by events only (their profiles were cut for the
    script's clock).  ``reps``: the kernel's timed calls (the plain version
    and the library call take at most 5, the profile at most 10), fewer for
    the calls that take a large share of a second."""
    out = {"ms": cuda_ms(kern, reps), "plain_ms": cuda_ms(plain, min(5, reps)),
           "library_ms": None if lib is None else cuda_ms(lib, min(5, reps))}
    if main or device:
        for _ in range(3):  # the profiler now and then reads no device time
            prof = _device_profile(lambda n: [kern() for _ in range(n)], min(10, reps),
                                   warmup=min(2, reps))
            if prof["device_busy_s"] > 0:
                break
        out["device_ms"] = sum(k["device_ms"] / k["calls"] for k in prof["kernels"])
        out["device_kernels"] = [{**k, "device_ms": k["device_ms"] / k["calls"]}
                                 for k in prof["kernels"]]
    return out


@contextlib.contextmanager
def uncounted():
    """Kernel launches made inside are checks, not the main path's run:
    the launch counts are put back as they were."""
    from repro_torch.kernels import LAUNCHES

    saved, shapes = dict(LAUNCHES), dict(SHAPES)
    try:
        yield
    finally:
        LAUNCHES.update(saved)
        SHAPES.clear()
        SHAPES.update(shapes)


#: launches of ``rglru_scan`` by input shape ``(B, S, D)`` while
#: :func:`shapes_of_rglru` is on, kept like the launch counts
SHAPES: dict[tuple, int] = {}


@contextlib.contextmanager
def shapes_of_rglru():
    """Counts the shapes ``rglru_scan`` launches at, where the model's
    dispatch (``kernels.ops.rglru``) calls it; launches made inside
    :func:`uncounted` are put back as they were.  A CUDA graph's shapes
    are counted as its launches are: recorded at the capture and credited
    at each replay (``graphs.StepGraph``)."""
    from repro_torch import graphs
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import scan

    real, real_capture, real_call = (scan.rglru_scan, graphs.StepGraph._capture,
                                     graphs.StepGraph.__call__)

    def counted(a, b):
        before = LAUNCHES["rglru_scan"]
        out = real(a, b)
        if LAUNCHES["rglru_scan"] > before:
            key = tuple(a.shape)
            SHAPES[key] = SHAPES.get(key, 0) + 1
        return out

    def capture(self):
        before = dict(SHAPES)
        try:
            real_capture(self)
        finally:
            self.rglru_shapes = {k: n - before.get(k, 0) for k, n in SHAPES.items()
                                 if n != before.get(k, 0)}
            SHAPES.clear()
            SHAPES.update(before)

    def call(self):
        out = real_call(self)
        if self.graph is not None:  # a replay (the capture's call replays too)
            for k, n in getattr(self, "rglru_shapes", {}).items():
                SHAPES[k] = SHAPES.get(k, 0) + n
        return out

    SHAPES.clear()
    scan.rglru_scan = counted
    graphs.StepGraph._capture, graphs.StepGraph.__call__ = capture, call
    try:
        yield SHAPES
    finally:
        scan.rglru_scan = real
        graphs.StepGraph._capture, graphs.StepGraph.__call__ = real_capture, real_call


@contextlib.contextmanager
def captures():
    """The seconds of every CUDA-graph capture made inside
    (``repro_torch.graphs.StepGraph``), listed as they happen."""
    from repro_torch import graphs

    real, seen = graphs.StepGraph._capture, []

    def timed(self):
        real(self)
        seen.append(self.capture_s)

    graphs.StepGraph._capture = timed
    try:
        yield seen
    finally:
        graphs.StepGraph._capture = real


def lossy_comm(mesh, dev):
    """A planted fault: a communicator that loses the first message of
    every ``ppermute`` and every block gathered across the slow axis."""
    import torch

    from repro_torch.snn import LoopbackComm

    class Lossy(LoopbackComm):
        def ppermute(self, x, pairs, axis):
            out = super().ppermute(x, pairs, axis)
            if pairs:
                out[pairs[0][1] * (self.r if axis == "slow" else 1)] = 0
            return out

        def all_gather(self, x, axis):
            out = super().all_gather(x, axis)
            return out if axis == "inner" else torch.zeros_like(out)

    return Lossy(mesh, dev)


def sustained(raster, min_active: int) -> dict:
    """Firing spread over the run: spikes on at least ``min_active`` steps
    and after the first volley's refractory hold (20 steps)."""
    import torch

    active = torch.nonzero(raster.sum(1)).flatten()
    check(active.numel() >= min_active, f"spikes on only {active.numel()} steps")
    first = int(active[0])
    check(float(raster[first + 21:].sum()) > 0, "no spikes after the first volley")
    return {"active_steps": int(active.numel()), "first_spike_step": first}


# -- phase 2 ---------------------------------------------------------------


def _bound(nbytes: float, flops: float, rate: float, peak: float = F32_PEAK) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / rate * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, rate: float) -> dict:
    """K1 / K2 against their plain versions at the main path's shapes: K1
    on 8 ranks of 8 tiles of 4,096 x 4,096, K2 on one rank's W f32[32768,
    4096] and, as ``oracle_2pct``, on the single-device oracle's W
    f32[32768, 32768] (the same storage viewed whole) at 2 % firing."""
    import torch

    from repro_torch.kernels import spike_accum as k
    from repro_torch.kernels.ref import spike_accum_blocks_ref, spike_accum_ref

    n_dev, n_blocks, b = 8, 8, 4096
    gen = torch.Generator(device=dev).manual_seed(0)
    # dense tiles drawn like the model's weights (expand_synapses): positive
    # magnitudes, every presynaptic row inhibitory (negative) with p = 0.2
    blocks = torch.empty((n_dev, n_blocks, b, b), device=dev).exponential_(generator=gen)
    inhib = torch.rand((n_dev, n_blocks, b, 1), generator=gen, device=dev) < 0.2
    blocks.mul_(1.0 - 2.0 * inhib.float())
    src = torch.arange(n_blocks, dtype=torch.int32, device=dev).repeat(n_dev, 1)
    w2 = blocks[0].reshape(n_blocks * b, b)  # K2: W f32[32768, 4096]
    w_oracle = blocks.view(n_blocks * b, n_dev * b)  # K2: W f32[32768, 32768]
    rank = torch.arange(n_dev, device=dev)[:, None]
    # the plain versions on float64 copies are the yardstick of correctness:
    # at 32,768 fired rows a float32 sum in any order drifts by about
    # sqrt(n) roundings, near the tolerance itself
    blocks64 = blocks.double()
    w2_64 = blocks64[0].reshape(n_blocks * b, b)
    w_oracle64 = blocks64.view(n_blocks * b, n_dev * b)

    def spikes(case: str, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=gen, device=dev)
        if case == "rate_0":
            return torch.zeros(shape, device=dev)
        if case == "rate_1pct":
            return (u < 0.01).float()
        if case == "oracle_2pct":  # the real-size network's firing (phase 4)
            return (u < 0.02).float()
        if case == "all_fire":  # the densest step there can be
            return torch.ones(shape, device=dev)
        if case == "one_active_block":
            s = torch.zeros(shape, device=dev)
            s.view(-1, b)[3] = 1.0
            return s
        return u * (torch.rand(shape, generator=gen, device=dev) < 0.05)  # weighted

    result = {}
    common = ("rate_0", "rate_1pct", "one_active_block", "all_fire", "weighted")
    for name in ("spike_accum_blocks", "spike_accum"):
        cases, worst = {}, 0.0
        for case in common + (("oracle_2pct",) if name == "spike_accum" else ()):
            if name == "spike_accum_blocks":
                s = spikes(case, (n_dev, n_blocks, b))
                kern = lambda: k.spike_accum_blocks(s, src, blocks)  # noqa: E731
                plain = lambda: spike_accum_blocks_ref(s, src, blocks)  # noqa: E731
                sel = s[rank, src.long()]
                lib = lambda: torch.einsum("dkb,dkbj->dj", sel, blocks)  # noqa: E731
                exact = spike_accum_blocks_ref(s.double(), src, blocks64)
                fired = float((s[rank, src.long()] != 0).sum())
                nbytes = fired * b * 4 + s.numel() * 4 + src.numel() * 4 + n_dev * b * 4
                flops = 2 * fired * b
            else:
                w, w64 = (w_oracle, w_oracle64) if case == "oracle_2pct" else (w2, w2_64)
                s = spikes(case, (n_blocks * b,))
                kern = lambda: k.spike_accum(s, w)  # noqa: E731
                plain = lambda: spike_accum_ref(s, w)  # noqa: E731
                lib = lambda: torch.mv(w.t(), s)  # noqa: E731
                exact = spike_accum_ref(s.double(), w64)
                fired = float((s != 0).sum())
                n_cols = w.shape[1]
                nbytes = fired * n_cols * 4 + s.numel() * 4 + n_cols * 4
                flops = 2 * fired * n_cols
            out, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"{name}/{case}: reruns differ")
            err = float((out.double() - exact).abs().max())
            check(torch.allclose(out.double(), exact, **TOL),
                  f"{name}/{case}: max err {err}")
            bound_ms, bound_by = _bound(nbytes, flops, rate)
            cases[case] = {
                "fired_rows": fired, "max_abs_err": err, "bit_identical_rerun": True,
                "max_abs_diff_vs_plain_f32": float((out - want).abs().max()),
                **timings(kern, plain, lib, case in ("rate_1pct", "oracle_2pct"), device=True),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            worst = max(worst, err)
        result[name] = {"cases": cases, "max_abs_err": worst}
    del blocks, w2, w_oracle, blocks64, w2_64, w_oracle64
    torch.cuda.empty_cache()
    return result


BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
ATTN_TOL = {"float32": dict(rtol=3e-3, atol=3e-3),  # tests/test_kernels.py:19-20
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# recurrentgemma's bf16 cases average 400-4,000 keys (ROW_BOUND's others
# 500 to 32,768), so their outputs are a few hundredths and 2e-2 would let
# a lost 32-key tile through.  They are also held to one bf16 step of the
# reference value plus two steps of the rms of its row (the head dim of
# one query): K3 and K4 round P to bf16 before P V, as the TPU kernels do
# (flash_attention.py:97, decode_attention.py:76), and that error scales
# with the row, not with the whole output.  ``bf16_row_bound_used`` is the share of the row's
# allowance the worst element takes.  A planted fault (the values of one
# 32-key tile zeroed) must fail the same bound.
BF16_REL, BF16_ROW = 2**-7, 2**-6


def _bf16_row_excess(got, want) -> float:
    """max((|got - want| - 2^-7 |want|) / rms_row(want)) - 2^-6: <= 0 passes."""
    import torch

    got, want = got.float(), want.float()
    row = want.double().pow(2).mean(-1, keepdim=True).sqrt().float()
    row = row.clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs() - BF16_REL * want.abs()).div(row).max()) - BF16_ROW


def _zero_tile(v, start: int):
    """A copy of the [B, H, S, D] view ``v`` with rows [start, start + 32) zeroed."""
    bad = v.clone()
    bad[:, :, start:start + 32] = 0
    return bad

# (name, b, hq, hkv, sq, sk, d, causal, window): the reference's sweep
# (tests/test_kernels.py:23-44), then phi4-mini-3.8b's prefill (a 4-slot wave
# padded to 1,024 tokens) and recurrentgemma-9b's local layers (MQA, head
# dim 256, window 2,048: a 4-slot wave of 1,024 tokens, and the batch-1
# 4,096-token prompt), then qwen3-moe-30b-a3b's (GQA group 8: a 4-slot wave
# padded to 1,024 tokens), llava-next-mistral-7b's (2 rows of 576 patch
# embeddings and 448 tokens) and musicgen-large's (2 rows of 512 steps),
# then the remaining text configs' shapes: deepseek-7b's (MHA,
# 32 heads of 128), qwen2.5-14b's (GQA group 5) and yi-34b's (group 7), each
# a 4-slot wave padded to 1,024 tokens, and mixtral-8x22b's swa layer (group
# 6, window 4,096) over a batch-1 prompt of 6,000 tokens padded to 8,192
FLASH_CASES = [
    ("gqa", 2, 4, 2, 256, 256, 64, True, None),
    ("mqa", 1, 8, 1, 128, 128, 32, True, None),
    ("bidirectional", 2, 4, 4, 256, 256, 64, False, None),
    ("window_96", 1, 4, 2, 256, 256, 64, True, 96),
    ("seq_384", 1, 2, 2, 384, 384, 16, True, 128),
    ("phi4_prefill", 4, 24, 8, 1024, 1024, 128, True, None),
    ("rg_prefill", 4, 16, 1, 1024, 1024, 256, True, 2048),
    ("rg_prefill_4096", 1, 16, 1, 4096, 4096, 256, True, 2048),
    ("qwen3_prefill", 4, 32, 4, 1024, 1024, 128, True, None),
    ("llava_prefill", 2, 32, 8, 1024, 1024, 128, True, None),
    ("musicgen_prefill", 2, 32, 32, 512, 512, 64, True, None),
    ("deepseek_prefill", 4, 32, 32, 1024, 1024, 128, True, None),
    ("qwen25_prefill", 4, 40, 8, 1024, 1024, 128, True, None),
    ("yi_prefill", 4, 56, 8, 1024, 1024, 128, True, None),
    ("mixtral_prefill", 1, 48, 8, 8192, 8192, 128, True, 4096),
]
# (name, b, hq, hkv, s, d, valid): valid rows None for all, "ragged", a
# prefix length, or slot_pos handed to the kernel with slot_lo = pos -
# 2,048: ("prefix", n) fills slots [0, n) at decode position n - 1,
# ("ring", n[, window]) holds positions [n - s, n) after a prefill of n
# tokens, slot n % s then overwritten by position n (window 2,048 unless
# given).  tests/test_kernels.py:47-61, then
# phi4-mini-3.8b's decode (4 slots, cache 1,088 = 1,024 + 64 rows, 1,056 of
# them valid half-way through the wave), recurrentgemma-9b's local decode
# (the same wave: window 2,048 > 1,088, so its slot_pos is a prefix) and its
# ring after a misaligned 3,000-token prefill (slot 952 holds position
# 3,000; slot 0 holds 952, outside the window), then qwen3-moe-30b-a3b's
# decode (4 slots, cache 1,056 = 1,024 + 32 rows, 1,040 valid half-way),
# llava's (2 rows, cache 1,040 = 1,024 + 16, 1,032 valid half-way) and
# musicgen's (2 rows, cache 528 = 512 + 16, 520 valid half-way), then
# deepseek-7b's, qwen2.5-14b's and yi-34b's (phi4's wave: cache 1,088, 1,056
# valid), mixtral-8x22b's ring of 4,096 slots after a misaligned prefill of
# 6,000 tokens (slot 1,904 holds position 6,000; slot 0 holds 1,904, outside
# the window) and phi4's long-context decode (batch 1, a cache of 32,768 + 32
# slots, 32,768 valid: generate_continuous's 32,000-token request)
DECODE_CASES = [
    ("full_cache", 2, 4, 2, 1024, 64, None),
    ("ragged_g4", 3, 8, 2, 512, 32, "ragged"),
    ("ragged_d128", 1, 2, 1, 2048, 128, "ragged"),
    ("phi4_decode", 4, 24, 8, 1088, 128, 1056),
    ("rg_decode", 4, 16, 1, 1088, 256, ("prefix", 1056)),
    ("rg_ring_misaligned", 1, 16, 1, 2048, 256, ("ring", 3000)),
    ("qwen3_decode", 4, 32, 4, 1056, 128, 1040),
    ("llava_decode", 2, 32, 8, 1040, 128, 1032),
    ("musicgen_decode", 2, 32, 32, 528, 64, 520),
    ("deepseek_decode", 4, 32, 32, 1088, 128, 1056),
    ("qwen25_decode", 4, 40, 8, 1088, 128, 1056),
    ("yi_decode", 4, 56, 8, 1088, 128, 1056),
    ("mixtral_ring", 1, 48, 8, 4096, 128, ("ring", 6000, 4096)),
    ("phi4_decode_32k", 1, 24, 8, 32800, 128, 32768),
]
RG_WINDOW = 2048
# the cases whose outputs average hundreds to thousands of keys, a few
# hundredths each: held also to the bf16 row bound, with a zeroed 32-key
# tile planted
ROW_BOUND = ("rg_", "mixtral_", "phi4_decode_32k", "deepseek_", "qwen25_", "yi_")
# the main paths' cases: their kernels' device time is profiled
MAIN_CASES = ("phi4", "rg_", "qwen3", "llava", "musicgen", "deepseek", "qwen25", "yi_",
              "mixtral")
REPS = {"mixtral_prefill": 5}  # the float32 kernel takes about a tenth of a second


def _valid_pairs(sq: int, sk: int, causal: bool, window, q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps: the work this input needs.  Query
    row ``r`` holds position ``q_offset + r``; it keeps the keys ``(p -
    window, p]`` (causal) or ``(p - window, sk)`` of the ``sk`` keys."""
    import numpy as np

    qp = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(qp, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def phase_attention(dev, rate: float) -> dict:
    """K3 / K4 against their plain versions, on transposed views of
    [B, S, H, D] activations and of a [B, W, Hkv, D] cache as the model
    passes them: the reference's sweep with its tolerances, and
    phi4-mini-3.8b's full-width shapes; float32 and bfloat16; two runs
    bit-identical; then the shapes of the remaining text configs
    (deepseek-7b, qwen2.5-14b, yi-34b, mixtral-8x22b's window and ring,
    phi4's decode over 32,800 slots) and, in ``_long_checks``, K3 over
    S = 32,768 and K4 over the dry-run's decode_32k cache.  The library
    yardstick is one ``scaled_dot_product_attention`` call on KV heads
    repeated beforehand (the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import attention_ref, decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    result = {"flash_attention": {}, "decode_attention": {}}

    def randn(*shape, dtype):
        if math.prod(shape) > 1 << 30:  # the long cases: no float32 copy
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(table, key, kern, plain, lib, nbytes, flops, dtype, planted=None, reps=20):
        out, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{key}: reruns differ")
        err = float((out.float() - want.float()).abs().max())
        check(torch.allclose(out.float(), want.float(), **ATTN_TOL[dtype]), f"{key}: max err {err}")
        extra = {}
        if planted is not None:  # ROW_BOUND's bf16 cases
            excess, fault = _bf16_row_excess(out, want), _bf16_row_excess(planted(), want)
            check(excess <= 0, f"{key}: {excess} rms of its row over the bf16 bound")
            check(fault > 0, f"{key}: a zeroed 32-key tile passes the bf16 bound")
            extra = {"bf16_row_excess": excess, "planted_fault_row_excess": fault,
                     "bf16_row_bound_used": 1.0 + excess / BF16_ROW}
        bound_ms, bound_by = _bound(nbytes, flops, rate,
                                    BF16_PEAK if dtype == "bfloat16" else F32_PEAK)
        table[key] = {"max_abs_err": err, "bit_identical_rerun": True, **extra,
                      **timings(kern, plain, lib, key.startswith(MAIN_CASES), reps=reps),
                      "bound_ms": bound_ms, "bound_by": bound_by}

    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for name, b, hq, hkv, sq, sk, d, causal, window in FLASH_CASES:
            q = randn(b, sq, hq, d, dtype=td).transpose(1, 2)
            kk, v = (randn(b, sk, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
            kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kk, v))
            mask = None
            if window is not None and window < sk:  # a window >= S cuts nothing
                qp = torch.arange(sq, device=dev)[:, None]
                kp = torch.arange(sk, device=dev)[None, :]
                mask = kp > qp - window
                if causal:
                    mask &= kp <= qp
            lib = (lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)) \
                if mask is not None else \
                (lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=causal))
            pairs = _valid_pairs(sq, sk, causal, window)
            nbytes = (q.numel() * 2 + kk.numel() * 2) * q.element_size()  # q, k, v, out
            planted = (lambda: attention_ref(q, kk, _zero_tile(v, sk // 2), causal=causal,
                                             window=window)) \
                if dtype == "bfloat16" and name.startswith(ROW_BOUND) else None
            record(result["flash_attention"], f"{name}/{dtype}",
                   lambda: k.flash_attention(q, kk, v, causal=causal, window=window),
                   lambda: attention_ref(q, kk, v, causal=causal, window=window),
                   lib, nbytes, 4.0 * b * hq * pairs * d, dtype, planted, REPS.get(name, 20))
            del q, kk, v, kr, vr, mask
        for name, b, hq, hkv, s, d, valid in DECODE_CASES:
            q = randn(b, hq, d, dtype=td)
            kk, v = (randn(b, s, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
            idx = torch.arange(s, dtype=torch.int32, device=dev)
            if isinstance(valid, tuple):  # slot_pos, as the windowed decode passes it
                kind, n, *win = valid
                window = win[0] if win else RG_WINDOW
                if kind == "prefix":
                    sp, lo = torch.where(idx < n, idx, -1).to(torch.int32), n - 1 - window
                else:  # a prefill of n rows kept the last s; decode at n wrote slot n % s
                    sp, lo = idx + (n - s), n - window
                    sp[n % s] = n
                # the bound as the model passes it: a device scalar
                kw = {"slot_pos": sp, "slot_lo": torch.tensor(lo, dtype=torch.int32, device=dev)}
                keep = ((sp >= 0) & (sp > lo)).expand(b, s)
            else:
                sl = (torch.randint(1, s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
                      if valid == "ragged" else
                      torch.full((b,), valid or s, dtype=torch.int32, device=dev))
                kw = {"seq_lens": sl}
                keep = idx[None, :] < sl[:, None]
            kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kk, v))
            rows = float(keep.sum())
            index_bytes = 4 * next(iter(kw.values())).numel()
            nbytes = (2 * rows * hkv * d + 2 * q.numel()) * q.element_size() + index_bytes
            planted = (lambda: decode_attention_ref(q, kk, _zero_tile(v, s // 2), **kw)) \
                if dtype == "bfloat16" and name.startswith(ROW_BOUND) else None
            record(result["decode_attention"], f"{name}/{dtype}",
                   lambda: k.decode_attention(q, kk, v, **kw),
                   lambda: decode_attention_ref(q, kk, v, **kw),
                   lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr,
                                                          attn_mask=keep[:, None, None, :]),
                   nbytes, 4.0 * rows * hq * d, dtype, planted)
            del q, kk, v, kr, vr
        _split_checks(dev, dtype, result, randn, record)
        _long_checks(dev, dtype, result, randn, rate)
    for table in result.values():
        table["max_abs_err"] = max(c["max_abs_err"] for c in table.values())
    torch.cuda.empty_cache()
    return result


SPLIT_PREFILL = ("phi4_prefill_q_offset", 4, 24, 8, 1024, 128)  # q rows [512, 1024)
# (name, b, hq, hkv, slots, d, valid): phi4's decode cache of 1,040 slots
# (1,024 + 16) at 1,032 valid, and recurrentgemma's misaligned ring (as
# DECODE_CASES' rg_ring_misaligned), each split in two halves over the slots
SPLIT_DECODE = [("phi4_decode_lse_half", 4, 24, 8, 1040, 128, 1032),
                ("rg_ring_lse_half", 1, 16, 1, 2048, 256, ("ring", 3000))]


def _split_checks(dev, dtype: str, result: dict, randn, record) -> None:
    """The sharded serving route's splits, emulated on one card: K3 on the
    second half of phi4's prefill rows with ``q_offset`` (a rank's rows of
    the sequence over ``tp``) and K4 with ``return_lse`` on each half of a
    cache's slots (a rank's slots), each held to its plain version (timed,
    bound and library call as phase 2's cases), and to K3's or K4's own
    whole run: the rows, and the halves combined by ``combine_partials``
    (with the log-sum-exps against the plain version's)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import attention_ref, combine_partials, decode_attention_ref

    td, tol = getattr(torch, dtype), ATTN_TOL[dtype]
    name, b, hq, hkv, s, d = SPLIT_PREFILL
    off = s // 2
    q = randn(b, s, hq, d, dtype=td).transpose(1, 2)
    kk, v = (randn(b, s, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
    rows = q[:, :, off:]
    kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kk, v))
    qp, kp = torch.arange(off, s, device=dev)[:, None], torch.arange(s, device=dev)[None, :]
    pairs = _valid_pairs(s - off, s, True, None, off)
    key = f"{name}/{dtype}"
    record(result["flash_attention"], key,
           lambda: k.flash_attention(rows, kk, v, q_offset=off),
           lambda: attention_ref(rows, kk, v, q_offset=off),
           lambda: F.scaled_dot_product_attention(rows, kr, vr, attn_mask=kp <= qp),
           (2 * rows.numel() + 2 * kk.numel()) * q.element_size(), 4.0 * b * hq * pairs * d,
           dtype)
    whole = k.flash_attention(q, kk, v)[:, :, off:]
    got = k.flash_attention(rows, kk, v, q_offset=off)
    diff = float((got.float() - whole.float()).abs().max())
    check(torch.allclose(got.float(), whole.float(), **tol), f"{key}: vs K3's whole run {diff}")
    result["flash_attention"][key]["max_abs_diff_vs_whole_run"] = diff
    del q, kk, v, rows, kr, vr, whole, got

    for name, b, hq, hkv, w, d, valid in SPLIT_DECODE:
        q = randn(b, hq, d, dtype=td)
        kk, v = (randn(b, w, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
        idx = torch.arange(w, dtype=torch.int32, device=dev)
        if isinstance(valid, tuple):  # the ring after a prefill of n rows, slot n % w rewritten
            n = valid[1]
            sp = idx + (n - w)
            sp[n % w] = n
            lo = torch.tensor(n - RG_WINDOW, dtype=torch.int32, device=dev)
        else:
            sp, lo = torch.where(idx < valid, idx, -1).to(torch.int32), -1
        half = w // 2
        halves = [(kk[:, :, a:a + half], v[:, :, a:a + half], sp[a:a + half].contiguous())
                  for a in (0, half)]
        hk, hv, hsp = halves[0]
        keep = ((hsp >= 0) & (hsp > lo)).expand(b, half)
        kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (hk, hv))
        n_rows = float(keep.sum())
        key = f"{name}/{dtype}"
        record(result["decode_attention"], key,
               lambda: k.decode_attention(q, hk, hv, slot_pos=hsp, slot_lo=lo, return_lse=True)[0],
               lambda: decode_attention_ref(q, hk, hv, slot_pos=hsp, slot_lo=lo,
                                            return_lse=True)[0],
               lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr,
                                                      attn_mask=keep[:, None, None, :]),
               (2 * n_rows * hkv * d + 2 * q.numel()) * q.element_size() + 4 * half
               + 4 * b * hq, 4.0 * n_rows * hq * d, dtype)
        parts = [k.decode_attention(q, a, c, slot_pos=p, slot_lo=lo, return_lse=True)
                 for a, c, p in halves]
        got = combine_partials(torch.stack([o for o, _ in parts]),
                               torch.stack([l for _, l in parts]))
        whole = k.decode_attention(q, kk, v, slot_pos=sp, slot_lo=lo)
        want = decode_attention_ref(q, kk, v, slot_pos=sp, slot_lo=lo)
        diffs = {"vs_whole_run": float((got.float() - whole.float()).abs().max()),
                 "vs_plain_whole": float((got.float() - want.float()).abs().max())}
        check(torch.allclose(got.float(), whole.float(), **tol), f"{key}: combined vs K4 {diffs}")
        check(torch.allclose(got.float(), want.float(), **tol), f"{key}: combined vs plain {diffs}")
        lse_err = 0.0
        for (_, l), (a, c, p) in zip(parts, halves):
            _, wl = decode_attention_ref(q, a, c, slot_pos=p, slot_lo=lo, return_lse=True)
            both = torch.isfinite(wl)
            check(torch.equal(both, torch.isfinite(l)), f"{key}: -inf rows of lse differ")
            lse_err = max(lse_err, float((l - wl)[both].abs().max()) if both.any() else 0.0)
            check(torch.allclose(l[both], wl[both], **ATTN_TOL["float32"]), f"{key}: lse {lse_err}")
        result["decode_attention"][key].update(
            combined_max_abs_diff=diffs, lse_max_abs_err=lse_err)
        del q, kk, v, halves, parts, got, whole, want


ROW_BLOCK = 512  # K3's first and last q rows held to the plain version at S = 32,768
# (name, b, hq, hkv, s, d, dtypes, reps): K3 over a whole prompt of S =
# 32,768, phi4's at batch 1 and one phi4 layer of the dry-run's prefill_32k
# at batch 32 (3.2 G elements of q), and K4 over the dry-run's decode_32k
# cache at batch 128 (32,768 slots, all valid: 4.3 G elements of K).  The
# plain version cannot hold them whole (phi4's [B, H, S, S] scores alone
# take 103 GB at batch 1): K3 is held to it on the first and last ROW_BLOCK
# q rows of every batch row and head (``q_offset`` places the last), K4 on
# the batch rows LONG_DECODE names.  A zeroed 32-key tile planted in the
# last batch row (past 2^31 elements of q at prefill_32k, of K and V at
# decode_32k) must fail the bf16 row bound, so that a wrapped 32-bit offset
# cannot pass unnoticed.  Timed with fewer repetitions.
LONG_PREFILL = [("phi4_prefill_32k", 1, 24, 8, 32768, 128, ("float32", "bfloat16"), 2),
                ("dryrun_prefill_32k", 32, 24, 8, 32768, 128, ("bfloat16",), 2)]
LONG_DECODE = [("dryrun_decode_32k", 128, 24, 8, 32768, 128, (0, 63, 127), 3)]


def _long_checks(dev, dtype: str, result: dict, randn, rate: float) -> None:
    """K3 and K4 at S = 32,768 (``LONG_PREFILL``, ``LONG_DECODE``), each
    held to its plain version on the rows it can hold, with its times
    (``plain_ms`` on those rows of batch row 0), its bound and one
    ``scaled_dot_product_attention`` call over the whole input (bf16: the
    flash backend with ``enable_gqa``, which repeats no KV head; float32:
    KV heads repeated beforehand)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import attention_ref, decode_attention_ref

    td, tol = getattr(torch, dtype), ATTN_TOL[dtype]
    bf16 = dtype == "bfloat16"

    def sdpa(q, kk, v, **kw):
        if bf16:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(q, kk, v, enable_gqa=True, **kw)
        g = q.shape[1] // kk.shape[1]
        return F.scaled_dot_product_attention(q, kk.repeat_interleave(g, dim=1),
                                              v.repeat_interleave(g, dim=1), **kw)

    def held(key, pairs, bad) -> dict:
        """Each (got, want) of ``pairs`` within the tolerance (and, in bf16,
        the row bound); ``bad`` (got, want on a planted fault) past it."""
        err, excess = 0.0, -math.inf
        for where, got, want in pairs:
            e = float((got.float() - want.float()).abs().max())
            check(torch.allclose(got.float(), want.float(), **tol), f"{key} {where}: max err {e}")
            err = max(err, e)
            if bf16:
                excess = max(excess, _bf16_row_excess(got, want))
        if not bf16:
            return {"max_abs_err": err}
        fault = _bf16_row_excess(*bad)
        check(excess <= 0, f"{key}: {excess} rms of its row over the bf16 bound")
        check(fault > 0, f"{key}: a zeroed 32-key tile in the last batch row passes the bound")
        return {"max_abs_err": err, "bf16_row_excess": excess, "planted_fault_row_excess": fault,
                "bf16_row_bound_used": 1.0 + excess / BF16_ROW}

    for name, b, hq, hkv, s, d, dtypes, reps in LONG_PREFILL:
        if dtype not in dtypes:
            continue
        key = f"{name}/{dtype}"
        q = randn(b, s, hq, d, dtype=td).transpose(1, 2)
        kk, v = (randn(b, s, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
        kern = lambda: k.flash_attention(q, kk, v)  # noqa: E731
        out, again = kern(), kern()
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{key}: reruns differ")
        del again
        last = s - ROW_BLOCK

        def rows(i, lo, hi, vv=None):
            return attention_ref(q[i:i + 1, :, lo:hi], kk[i:i + 1],
                                 v[i:i + 1] if vv is None else vv, q_offset=lo)

        pairs = ((f"batch row {i}, q rows [{lo}, {hi})", out[i:i + 1, :, lo:hi], rows(i, lo, hi))
                 for i in range(b) for lo, hi in ((0, ROW_BLOCK), (last, s)))
        bad = (out[b - 1:, :, last:], rows(b - 1, last, s, _zero_tile(v[b - 1:], s // 2)))
        rec = held(key, pairs, bad)
        flops = 4.0 * b * hq * _valid_pairs(s, s, True, None) * d
        bound_ms, bound_by = _bound((2 * q.numel() + 2 * kk.numel()) * q.element_size(), flops,
                                    rate, BF16_PEAK if bf16 else F32_PEAK)
        result["flash_attention"][key] = {
            **rec, "bit_identical_rerun": True, "q_elements": q.numel(),
            "compared": f"q rows [0, {ROW_BLOCK}) and [{last}, {s}) of every batch row and head",
            **timings(kern, lambda: rows(0, last, s), lambda: sdpa(q, kk, v, is_causal=True),
                      bf16, reps=reps),
            "plain_rows": f"q rows [{last}, {s}) of batch row 0",
            "bound_ms": bound_ms, "bound_by": bound_by}
        del q, kk, v, out, bad
        torch.cuda.empty_cache()

    for name, b, hq, hkv, s, d, batch_rows, reps in LONG_DECODE:
        if not bf16:
            continue
        key = f"{name}/{dtype}"
        q = randn(b, hq, d, dtype=td)
        kk, v = (randn(b, s, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
        sl = torch.full((b,), s, dtype=torch.int32, device=dev)
        kern = lambda: k.decode_attention(q, kk, v, seq_lens=sl)  # noqa: E731
        out, again = kern(), kern()
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{key}: reruns differ")

        def plain(i, vv=None):
            return decode_attention_ref(q[i:i + 1], kk[i:i + 1], v[i:i + 1] if vv is None else vv,
                                        seq_lens=sl[i:i + 1])

        pairs = ((f"batch row {i}", out[i:i + 1], plain(i)) for i in batch_rows)
        bad = (out[b - 1:], plain(b - 1, _zero_tile(v[b - 1:], s // 2)))
        rec = held(key, pairs, bad)
        idx = torch.tensor(batch_rows, device=dev)
        bound_ms, bound_by = _bound((2 * kk.numel() + 2 * q.numel()) * q.element_size() + 4 * b,
                                    4.0 * b * s * hq * d, rate, BF16_PEAK)
        result["decode_attention"][key] = {
            **rec, "bit_identical_rerun": True, "k_elements": kk.numel(),
            "compared": f"batch rows {list(batch_rows)}",
            **timings(kern, lambda: decode_attention_ref(q[idx], kk[idx], v[idx],
                                                         seq_lens=sl[idx]),
                      lambda: sdpa(q[:, :, None], kk, v), True, reps=reps),
            "plain_rows": f"batch rows {list(batch_rows)}",
            "bound_ms": bound_ms, "bound_by": bound_by}
        del q, kk, v, out, again, bad
        torch.cuda.empty_cache()


SCAN_TOL = dict(rtol=3e-3, atol=3e-3)  # tests/test_kernels.py:74-76, 101-103
# (name, b, s, h, g, p, n, chunk): the reference's sweep (tests/test_kernels.py:
# 64-76), chunks that are not powers of two (127 = min(128, S) at S = 127;
# 96), then mamba2-1.3b's prefill (a 4-slot wave of 1,024 tokens)
SSD_CASES = [
    ("sweep_1", 2, 256, 4, 2, 32, 16, 64),
    ("sweep_2", 1, 128, 2, 1, 16, 8, 128),
    ("sweep_3", 1, 512, 8, 2, 64, 32, 128),
    ("chunk_127", 1, 127, 64, 1, 64, 128, 128),
    ("chunk_96", 2, 384, 8, 2, 32, 16, 96),
    ("mamba2_prefill", 4, 1024, 64, 1, 64, 128, 128),
]
# (name, b, s, d): tests/test_kernels.py:94-103, then the shapes
# recurrentgemma-9b's prefills give it (lru_width 4,096): a 4-slot wave of
# 1,024 tokens and of 512 (``generate``'s two waves), a batch-1 prefill of
# 1,024 (``generate_continuous``) and the batch-1 request of 4,096 tokens
RGLRU_CASES = [
    ("sweep_1", 2, 256, 128), ("sweep_2", 1, 128, 256), ("sweep_3", 3, 512, 64),
    ("rg_prefill", 4, 1024, 4096), ("rg_wave2", 4, 512, 4096),
    ("rg_continuous", 1, 1024, 4096), ("rg_long", 1, LONG_PROMPT, 4096),
]


def phase_scans(dev, rate: float) -> dict:
    """K5 / K6 against their plain versions on float64 copies (the
    reference's tolerance), two runs bit-identical; K5 also returns its
    final state, held to the plain version's carried state.  No single
    PyTorch call computes either function, so there is no library time.

    K5's bound counts the work its design needs: per (batch, group, chunk)
    C Bᵀ, 2 T N, and per (batch, head, chunk) 2 T P + 4 L N P, where T =
    L (L + 1) / 2 are the (t, s <= t) pairs the causal mask keeps, as
    ``_valid_pairs`` counts them for K3; each product three times (3xTF32)
    at the TF32 tensor-core peak; bytes x, a, B, C and y once and the final
    state.  ``bound_ms_bytes`` is the byte term alone (what a single TF32
    pass would leave as the bound); ``bound_ms_f32`` keeps the float32
    CUDA-core bound of the kernel before it (C Bᵀ per head, no state), for
    comparison."""
    import torch

    from repro_torch.kernels import scan as k
    from repro_torch.kernels.ref import rglru_ref, ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(2)
    result = {"ssd_scan": {}, "rglru_scan": {}}

    def record(table, name, kern, plain, exact, nbytes, flops, main, peak=F32_PEAK):
        out, again = kern(), kern()
        torch.cuda.synchronize()
        out, again = (o[0] if isinstance(o, tuple) else o for o in (out, again))
        check(torch.equal(out, again), f"{name}: reruns differ")
        err = float((out.double() - exact).abs().max())
        check(torch.allclose(out.double(), exact, **SCAN_TOL), f"{name}: max err {err}")
        bound_ms, bound_by = _bound(nbytes, flops, rate, peak)
        want = plain()
        want = want[0] if isinstance(want, tuple) else want
        table[name] = {"max_abs_err": err, "bit_identical_rerun": True,
                       "max_abs_diff_vs_plain_f32": float((out - want).abs().max()),
                       **timings(kern, plain, None, main),
                       "bound_ms": bound_ms, "bound_by": bound_by}
        return table[name]

    for name, b, s, h, g, p, n, chunk in SSD_CASES:
        x = torch.randn((b, s, h, p), generator=gen, device=dev)
        a = 0.85 + 0.149 * torch.rand((b, s, h), generator=gen, device=dev)
        bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev) for _ in "bc")
        ell = min(chunk, s)
        exact, exact_state = ssd_chunked(x.double(), a.double(), bm.double(), cm.double(),
                                         chunk=chunk, return_state=True)
        pairs = _valid_pairs(ell, ell, True, None)
        nc = s // ell
        flops = 3 * (b * g * nc * 2 * pairs * n + b * h * nc * (2 * pairs * p + 4 * ell * n * p))
        nbytes = (2 * x.numel() + a.numel() + 2 * bm.numel() + b * h * n * p) * 4
        # prefill asks for the final state (models/layers.mamba2_block)
        row = record(result["ssd_scan"], name,
                     lambda: k.ssd_scan(x, a, bm, cm, chunk=chunk, return_state=True),
                     lambda: ssd_chunked(x, a, bm, cm, chunk=chunk, return_state=True),
                     exact, nbytes, flops, name.startswith("mamba2"), TF32_PEAK)
        (_, state), (_, again) = (k.ssd_scan(x, a, bm, cm, chunk=chunk, return_state=True)
                                  for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(state, again), f"{name}: final states of two runs differ")
        err = float((state.double() - exact_state).abs().max())
        check(torch.allclose(state.double(), exact_state, **SCAN_TOL),
              f"{name}: final state max err {err}")
        old_flops = b * h * nc * (2 * pairs * n + 2 * pairs * p + 4 * ell * n * p)
        row.update(state_max_abs_err=err, tf32_products=3, bound_ms_bytes=nbytes / rate * 1e3,
                   bound_ms_f32=_bound(nbytes - b * h * n * p * 4, old_flops, rate)[0],
                   plan=k.ssd_plan(b, s, h, g, p, n, chunk))
        del exact, exact_state
    for name, b, s, d in RGLRU_CASES:
        a = 0.8 + 0.199 * torch.rand((b, s, d), generator=gen, device=dev)
        bb = torch.randn((b, s, d), generator=gen, device=dev)
        row = record(result["rglru_scan"], name, lambda: k.rglru_scan(a, bb),
                     lambda: rglru_ref(a, bb), rglru_ref(a.double(), bb.double()),
                     3 * a.numel() * 4, 2 * a.numel(), name.startswith("rg"))
        # the trace's bytes, to hold it bit for bit to another build's
        row["trace_sha256"] = hashlib.sha256(
            k.rglru_scan(a, bb).cpu().numpy().tobytes()).hexdigest()
        # exact traces: with a = 1, b = 1 every h_t is t + 1 (integers below
        # 2^24); with a = 0 it is b.  A carry lost or doubled across ring
        # stages, tiles or tails fails these exactly.
        ones = torch.ones_like(a)
        steps = torch.arange(1, s + 1, device=dev, dtype=torch.float32)[None, :, None]
        check(torch.equal(k.rglru_scan(ones, ones), steps.expand(b, s, d)),
              f"{name}: a = b = 1 does not give t + 1")
        check(torch.equal(k.rglru_scan(torch.zeros_like(a), bb), bb), f"{name}: a = 0 is not b")
        row["exact_traces"] = True
        if hasattr(k, "rglru_plan"):  # absent in a tree before the channel-tile ring
            row["plan"] = k.rglru_plan(b, s, d)
    for table in result.values():
        table["max_abs_err"] = max(c["max_abs_err"] for c in table.values())
    result["ssd_scan"]["state_max_abs_err"] = max(
        c["state_max_abs_err"] for c in result["ssd_scan"].values() if isinstance(c, dict))
    torch.cuda.empty_cache()
    return result


INT32_PEAK = F32_PEAK / 4  # H100 SXM INT32 op/s: 64 INT32 lanes an SM to 128 FP32, an FMA counts 2
# float operations a value of each map after the hash, about (an FMA as two):
# uniform's subtract, multiply-add and max; normal's log1p (two degree-7
# polynomials and a quotient), erf_inv's degree-8 polynomial and the scale;
# gumbel's two logarithms (Cephes' degree-8 polynomial each)
# no Pallas kernel: the reference's draws are jax.random calls, which XLA
# lowers to threefry2x32 itself
THREEFRY_REPLACES = ("none (XLA's threefry2x32 under jax.random: src/repro/snn/neuron.py:80, "
                     "src/repro/serve/engine.py:70, src/repro/models/lm.py:253)")
THREEFRY_FLOPS = {"bits": 0, "uniform": 4, "normal": 75, "gumbel": 75}
THREEFRY_ULPS = {"normal/float32": 2, "gumbel/float32": 2, "normal/bfloat16": 1}
# name, key rows, values a row, kind, dtype, split first: the main paths'
# draws (a rank-stacked LIF step of the real-size network, 8 ranks of 4,096
# neurons; phi4's sampler, Gumbel noise over 4 rows of its vocabulary from one
# key; one full-width phi4 leaf, the stacked attention wk [32, 3072, 1024])
THREEFRY_CASES = [
    ("lif_noise", 8, 4096, "normal", "float32", True),
    ("phi4_sampler", 1, 4 * 200064, "gumbel", "float32", False),
    ("phi4_leaf", 1, 32 * 3072 * 1024, "normal", "bfloat16", False),
]


def _ulps(got, want, dtype) -> float:
    """Largest ``|got - want|`` in units of ``want``'s last place in
    ``dtype`` (float32 or bfloat16); equal values, infinities too, count 0."""
    import torch

    got, want = got.double(), want.double()
    mant = 7 if dtype == torch.bfloat16 else 23  # stored mantissa bits
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0**-126))) - mant)
    diff = torch.where(got == want, 0.0, (got - want).abs())
    return float((diff / step).max())


def phase_threefry(dev, rate: float) -> dict:
    """The ``threefry`` kernel against its plain version
    (``random.draw_ref`` / ``split_ref``, PyTorch on the card) at the main
    paths' shapes: keys and split bit-equal, the raw bits of every value
    bit-equal, float32 normals and gumbels within 2 ulp, bfloat16 normals
    within one bfloat16 ulp, two runs bit-identical.  ``torch.randn`` of the
    same shape and dtype is the library yardstick (another generator, Philox:
    not the same numbers).  The bound counts the bytes written (keys read
    once), about 73 INT32 operations a value (one threefry2x32 hash and the
    xor of its words; with ``split_first`` two hashes a row more) at the INT32
    rate, and the map's float operations at the FP32 rate."""
    import torch

    from repro_torch import random
    from repro_torch.kernels import threefry as k

    cases, worst = {}, 0.0
    for name, rows, n, kind, dtype_name, split_first in THREEFRY_CASES:
        dtype = getattr(torch, dtype_name)
        root = random.PRNGKey(3, device=dev)[None]
        keys = k.split(root, rows)[0]
        check(torch.equal(keys, random.split_ref(root, rows)[0]), f"{name}: split differs")
        bits = k.draw(keys, n, random.KINDS["bits"], torch.int64)
        check(torch.equal(bits, random.draw_ref(keys, n, random.KINDS["bits"], torch.int64)),
              f"{name}: bits differ")
        del bits
        lo, diff = random.bounds(kind, dtype)
        code = random.KINDS[kind]
        kern = lambda: k.draw(keys, n, code, dtype, lo, diff, split_first=split_first)  # noqa: E731
        plain = lambda: random.draw_ref(keys, n, code, dtype, lo, diff,  # noqa: E731
                                        split_first=split_first)
        lib = lambda: torch.randn((rows, n), dtype=dtype, device=dev)  # noqa: E731
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        if split_first:
            check(torch.equal(got[0], want[0]) and torch.equal(got[0], again[0]),
                  f"{name}: new keys differ")
            got, again, want = got[1], again[1], want[1]
        check(torch.equal(got, again), f"{name}: reruns differ")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite draws")
        ulps = _ulps(got, want, dtype)
        limit = THREEFRY_ULPS[f"{kind}/{dtype_name}"]
        check(ulps <= limit, f"{name}: {ulps} ulp from the plain version (limit {limit})")
        values = rows * n
        nbytes = rows * 16 * (2 if split_first else 1) + values * got.element_size()
        int_ops = values * (k.HASH_OPS + 1) + (2 * rows * k.HASH_OPS if split_first else 0)
        t_ops = max(int_ops / INT32_PEAK, values * THREEFRY_FLOPS[kind] / F32_PEAK) * 1e3
        t_bytes = nbytes / rate * 1e3
        cases[name] = {
            "rows": rows, "values_per_row": n, "kind": kind, "dtype": dtype_name,
            "split_first": split_first, "max_ulp_vs_plain": ulps, "ulp_limit": limit,
            "bit_equal_share": float((got == want).double().mean()), "bits_equal": True,
            "bit_identical_rerun": True, "max_abs_diff_vs_plain": float(
                (got.double() - want.double()).abs().max()),
            **timings(kern, plain, lib, True),
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "int_ops": int_ops, "library": "torch.randn (Philox)"}
        worst = max(worst, cases[name]["max_abs_diff_vs_plain"])
        del got, again, want
    torch.cuda.empty_cache()
    return {"threefry": {"cases": cases, "max_abs_err": worst}}


# -- phase 3 ---------------------------------------------------------------


def phase_launcher(device: str, argv: list[str] | None = None) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import run_brainsim

    argv = list(argv or [])
    per_run_launches = device == "cuda"  # a CPU run takes the plain version
    out = {}
    for tag, extra in (("defaults", []), ("noise_2", ["--noise", "2.0"])):
        rasters, runs, engines = {}, {}, {}
        for exch in ("flat", "two_level", "sparse", "ragged"):
            line = [*argv, *extra, "--exchange", exch, "--device", device]
            before = LAUNCHES["spike_accum_blocks"]
            t0 = time.perf_counter()
            with captures() as caps:
                res = run_brainsim.main(line)  # replayed from a CUDA graph on the card
            wall = time.perf_counter() - t0
            rasters[exch], engines[exch] = res["raster"], res["engine"]
            runs[exch] = {"spike_accum_blocks": LAUNCHES["spike_accum_blocks"] - before,
                          "wall_s": wall, "capture_s": sum(caps), "graph": res["engine"].graph}
            with uncounted():  # the same run op by op, its check
                t0 = time.perf_counter()
                eager = run_brainsim.main([*line, "--eager"])["raster"]
                runs[exch]["eager_wall_s"] = time.perf_counter() - t0
            check(np.array_equal(eager, rasters[exch]), f"{tag}/{exch}: replayed != eager")
        steps = rasters["flat"].shape[0]
        for exch in ("two_level", "sparse", "ragged"):
            check(np.array_equal(rasters[exch], rasters["flat"]), f"{tag}: {exch} != flat")
        for exch in ("sparse", "ragged"):
            check(runs[exch]["spike_accum_blocks"] == (steps if per_run_launches else 0),
                  f"{tag}/{exch}: {runs[exch]} kernel launches for {steps} steps")
        row = {"steps": steps, "spikes": int(rasters["flat"].sum()), "runs": runs,
               "replayed_equals_eager": True}
        if extra:
            row.update(sustained(torch.from_numpy(rasters["flat"]), steps // 2))
            with uncounted():
                for exch, eng in engines.items():
                    lost = eng.run(steps, comm=lossy_comm(eng.mesh, eng.device))
                    check(not np.array_equal(lost.cpu().numpy(), rasters[exch]),
                          f"{tag}/{exch}: a lost message left the raster unchanged")
            row["planted_faults_seen"] = True
        out[tag] = row
    out["brainsim"] = phase_brainsim(device, per_run_launches)
    return out


def phase_brainsim(device: str, per_run_launches: bool) -> dict:
    """``python -m repro_torch.launch.brainsim`` (the port of
    ``examples/brainsim.py``) with each partitioner: the flat and
    two-level exchanges (and, on the block-CSR kernel's path, sparse and
    ragged) give one raster; the multilevel cut beside the greedy one."""
    import numpy as np

    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import brainsim

    out = {}
    for method in ("greedy", "multilevel"):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        res = brainsim.main(["--method", method, "--device", device, "--steps", str(STEPS),
                             "--exchanges", "flat", "two_level", "sparse", "ragged"])
        wall = time.perf_counter() - t0
        rasters = res["rasters"]
        for exch in ("two_level", "sparse", "ragged"):
            check(np.array_equal(rasters[exch], rasters["flat"]),
                  f"brainsim/{method}: {exch} != flat")
        launched = {k: v - before[k] for k, v in LAUNCHES.items() if v > before[k]}
        want = 2 * STEPS if per_run_launches else 0  # sparse and ragged, one a step
        check(launched.get("spike_accum_blocks", 0) == want,
              f"brainsim/{method}: {launched} kernel launches for 2 x {STEPS} steps")
        part = res["partition"]
        out[method] = {"cut": part.cut, "max_load": float(part.loads.max()),
                       "groups": res["table"].n_groups,
                       "latency_ms": {k: v * 1e3 for k, v in res["latency_s"].items()},
                       "spikes": int(rasters["flat"].sum()), "rasters_equal": True,
                       "kernels_launched": launched, "wall_s": wall}
    out["cut_multilevel_over_greedy"] = out["multilevel"]["cut"] / out["greedy"]["cut"]
    return out


# -- phase 4 ---------------------------------------------------------------


def _device_profile(run, steps: int, match: tuple[str, ...] = (), warmup: int = 2,
                    cpu: bool = True) -> dict:
    """Where ``run(steps)``'s time goes, after ``run(warmup)`` (profiled
    apart, unread): device time by kernel under ``torch.profiler`` and the
    device's busy share of the run's wall time (the profiler's own cost is inside that wall time; a
    CUDA-graph capture made inside is not: ``capture_s``), CUDA kernels and
    graph launches (``cudaGraphLaunch`` calls; 0 without ``cpu``, which
    leaves the host's ops out of the trace: a train step has some 10⁵).
    With ``match``, also the device time and calls of every kernel whose
    name contains one of its strings."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if cpu else []
    if warmup:
        # under a profiler too: the first profiled program span of a process sets up
        # its annotation (about 0.2 s on the card), which the measured run must not hold
        with profile(activities=activities + [ProfilerActivity.CUDA]):
            run(warmup)
    torch.cuda.synchronize()
    with captures() as caps, profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - sum(caps)

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    # kernel events only: an aten op's device time is its kernels' time again, and
    # a program span's device copy (a user annotation) is the interval it covers
    events = prof.key_averages()
    rows = sorted((e for e in events if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not e.is_user_annotation),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    out = {"wall_s": wall, "capture_s": sum(caps), "device_busy_s": busy,
           "device_busy_share": busy / wall,
           "kernels": [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
                        "calls": e.count} for e in rows[:8]],
           "kernel_launches": sum(e.count for e in rows),
           "graph_launches": sum(e.count for e in events if "cudaGraphLaunch" in e.key)}
    if match:
        hit = [e for e in rows if any(s in e.key for s in match)]
        out["matched"] = {"device_ms": sum(dev_us(e) for e in hit) / 1e3,
                          "calls": sum(e.count for e in hit)}
    return out



def _lint_executed_plan(syn, mesh, plan, ms_per_step: float) -> dict:
    """planlint Layer 1 over the ragged plan an engine executed, on the
    two-tier fabric of the mesh (pods of 4): an error fails the run,
    warnings are reported.  Beside it, the netsim replay of the plan's
    rounds on that fabric (predicted wire seconds a step) and the card's
    measured ms a step (a loopback on one card: no agreement is claimed)."""
    import numpy as np

    from repro_torch import netsim
    from repro_torch.analysis import PlanContext, run_lints

    t0 = time.perf_counter()
    topo = netsim.two_tier(int(np.prod(mesh)), mesh[1])
    ctx = PlanContext.from_synapses(syn, mesh, name="real_size_ragged", plan=plan,
                                    topology=topo)
    found = run_lints(ctx)
    lint_s = time.perf_counter() - t0
    errors = [f for f in found if f.severity == "error"]
    check(not errors, f"planlint: errors in the executed plan: {errors}")
    t0 = time.perf_counter()
    rounds = netsim.ragged_rounds(plan)
    res = netsim.simulate(rounds, topo)
    res.assert_conserved()
    check(netsim.total_bytes(rounds) == plan.bytes_per_step,
          "netsim: replayed bytes != the plan's bytes a step")
    return {"topology": topo.name, "errors": 0,
            "warnings": [f"{f.rule_id}: {f.message}" for f in found if f.severity == "warning"],
            "info": [f"{f.rule_id}: {f.message}" for f in found if f.severity == "info"],
            "lint_host_s": lint_s,
            "netsim_replay": {"messages": sum(len(r) for r in rounds),
                              "bytes_per_step": plan.bytes_per_step,
                              "predicted_wire_s_per_step": res.t_total,
                              "conserved": True, "host_s": time.perf_counter() - t0},
            "card_ms_per_step": ms_per_step}


def _per_step(prof: dict, steps: int) -> dict:
    """A profile of ``steps`` steps with its per-step rates."""
    return {**prof, "device_ms_per_step": prof["device_busy_s"] * 1e3 / steps,
            "kernels_per_step": prof["kernel_launches"] / steps,
            "graph_launches_per_step": prof["graph_launches"] / steps}


def phase_real_size(device: str, n_pop: int = 2048, npp: int = 16,
                    steps: int = REAL_STEPS, keep: dict | None = None) -> dict:
    """Real size through the public API (see the module's docstring).
    ``keep``: filled with what phase ``comm`` reuses — the host tiles, the
    drive, the mesh, the neuron constants, the ragged plan and, per
    exchange, the replayed raster, its ledger and its ms per step."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.analysis._support import paper_fabric
    from repro_torch.core import (
        device_traffic_csr, estimate, greedy_partition, multilevel_partition, p2p_routing,
        step_latency, two_level_routing,
    )
    from repro_torch.kernels import LAUNCHES, spike_currents
    from repro_torch.snn import (
        DistributedSNN, LIFParams, LoopbackComm, SNNEngine,
        expand_synapses_sparse, generate_brain_model,
    )

    dev = torch.device(device)
    per_run = steps if dev.type == "cuda" else 0  # a CPU run takes the plain version
    n_dev, mesh = 8, (2, 4)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out: dict = {"populations": n_pop, "neurons_per_pop": npp, "ranks": n_dev,
                 "mesh": list(mesh), "steps": steps, "drive": list(DRIVE)}
    t0 = time.perf_counter()
    bm = generate_brain_model(n_populations=n_pop, n_regions=max(8, n_pop // 16),
                              total_neurons=1_000_000, seed=0)
    part = greedy_partition(bm.graph, n_dev, seed=0)
    t, wg = device_traffic_csr(bm.graph, part.assign, n_dev)
    tb = two_level_routing(t, wg, max(2, n_dev // 4))
    out["plan"] = {"cut": part.cut, "groups": tb.n_groups,
                   "latency_p2p_ms": step_latency(p2p_routing(t, wg)).t_total * 1e3,
                   "latency_two_level_ms": step_latency(tb).t_total * 1e3,
                   "host_s": time.perf_counter() - t0}
    # beside it, the multilevel partitioner on the same graph and the
    # netsim replay of the same table (the engine below runs the greedy plan)
    t0 = time.perf_counter()
    ml = multilevel_partition(bm.graph, n_dev, seed=0)
    out["plan"]["multilevel"] = {"cut": ml.cut, "max_load": float(ml.loads.max()),
                                 "host_s": time.perf_counter() - t0}
    out["plan"]["greedy_max_load"] = float(part.loads.max())
    t0 = time.perf_counter()
    out["plan"]["latency_two_level_netsim_ms"] = {
        "single_switch": estimate(tb, model="netsim").t_total * 1e3,
        "paper_fabric": estimate(tb, model="netsim", topology=paper_fabric(n_dev)).t_total * 1e3,
        "host_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    # Algorithm 1's population partition is not equal-count: contiguous slabs
    syn, _ = expand_synapses_sparse(bm.graph, npp, n_dev, seed=0)
    np.multiply(syn.blocks, np.float32(0.05), out=syn.blocks)  # the launcher's scale
    out["expand"] = {"host_s": time.perf_counter() - t0, "tiles": syn.nnzb,
                     "block": syn.block_size, "tile_bytes": int(syn.blocks.nbytes),
                     "synapses": int(np.count_nonzero(syn.blocks))}
    m = syn.n_neurons
    drive = np.random.default_rng(0).uniform(*DRIVE, m).astype(np.float32)
    params = LIFParams(noise_sigma=0.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tiles = convert.padded_tiles(syn, dev)  # one device copy, shared by every engine
    sync()
    out["stage_tiles_s"] = time.perf_counter() - t0

    def engine(exch: str, mode: str = "fused", graph: bool | None = None) -> DistributedSNN:
        return DistributedSNN(mesh=mesh, params=params, exchange=exch, i_ext=drive,
                              syn=syn, ragged_scatter=mode, tiles=tiles, device=dev,
                              graph=graph)

    def timed(run):
        """(result, wall seconds, seconds of the captures inside)."""
        sync()
        t0 = time.perf_counter()
        with captures() as caps:
            res = run()
        sync()
        return res, time.perf_counter() - t0, sum(caps)

    # the counted runs replay a CUDA graph of one step (the engines' default
    # on the card); the same runs op by op are their checks, uncounted
    runs, rasters, profiles, ledgers = {}, {}, {}, {}
    for tag, exch, mode in (("sparse", "sparse", "fused"),
                            ("ragged_fused", "ragged", "fused"),
                            ("ragged_per_round", "ragged", "per_round")):
        eng = engine(exch, mode)
        with uncounted():  # warm up, the card's clocks too
            eng.run(steps)
        comm = LoopbackComm(mesh, dev)
        before = LAUNCHES["spike_accum_blocks"]
        raster, wall, capture_s = timed(lambda: eng.run(steps, comm=comm))
        launched = LAUNCHES["spike_accum_blocks"] - before
        vol = eng.exchange_stats()
        check(launched == per_run, f"{tag}: {launched} kernel launches for {steps} steps")
        check(comm.step_bytes == [vol[exch]] * steps,
              f"{tag}: executed bytes {set(comm.step_bytes)} != {vol[exch]}")
        with uncounted():
            eager, eager_comm = engine(exch, mode, graph=False), LoopbackComm(mesh, dev)
            eager.run(steps)
            eager_raster, eager_wall, _ = timed(lambda: eager.run(steps, comm=eager_comm))
        check(torch.equal(eager_raster, raster), f"{tag}: replayed raster != eager")
        check(eager_comm.step_bytes == comm.step_bytes, f"{tag}: eager bytes differ")
        rasters[tag], ledgers[tag] = raster, list(comm.step_bytes)
        replay_s = wall - capture_s
        runs[tag] = {"graph": eng.graph, "ms_per_step": replay_s / steps * 1e3,
                     "steps_per_s": steps / replay_s, "capture_s": capture_s,
                     "wall_ms_per_step_with_capture": wall / steps * 1e3,
                     "eager_ms_per_step": eager_wall / steps * 1e3,
                     "bytes_per_step": vol[exch], "spike_accum_blocks_launches": launched,
                     "replayed_equals_eager": True}
        if tag == "ragged_fused":
            plan = eng._ragged_plan()
            out["planlint"] = _lint_executed_plan(syn, mesh, plan, runs[tag]["ms_per_step"])
        if dev.type == "cuda" and mode == "fused":
            profiles[tag] = {"replayed": _per_step(_device_profile(engine(exch).run, steps),
                                                   steps)}
            with uncounted():
                profiles[tag]["eager"] = _per_step(
                    _device_profile(engine(exch, graph=False).run, steps), steps)
    for prof in profiles.values():  # the profiler sees a graph's kernel nodes
        prof["profiler_sees_graph_kernels"] = (
            prof["replayed"]["kernels_per_step"] >= 0.9 * prof["eager"]["kernels_per_step"])
    if profiles:
        out["profile"] = profiles
    runs["ragged_fused"]["step_profile"] = engine("ragged").step_profile(4)
    out["noise_2"] = _noisy_real_size(mesh, drive, syn, tiles, dev, steps, runs["sparse"],
                                      rasters["sparse"], timed)
    raster = rasters["sparse"]
    for tag in ("ragged_fused", "ragged_per_round"):
        check(torch.equal(rasters[tag], raster), f"{tag} != sparse")
    out.update(sustained(raster, steps // 2))
    half = steps // 2
    out.update(spikes=int(raster.sum()), mean_rate=float(raster.mean()),
               rate_second_half=float(raster[half:].mean()), runs=runs)

    # the dense synapse matrix, for the single-device engine and the yardstick
    b = syn.block_size
    w = torch.zeros((m, m), dtype=torch.float32, device=dev)
    for kk, dst in enumerate(syn.dst_of()):
        src = int(syn.src_ids[kk])
        w[src * b:(src + 1) * b, dst * b:(dst + 1) * b] = torch.from_numpy(syn.blocks[kk])
    # every step's synaptic current against the dense s @ W, in float64
    prev = torch.cat([torch.zeros_like(raster[:1]), raster[:-1]]).double()
    want = prev @ w.double()
    currents = {}
    with uncounted():
        for tag, exch in (("sparse", "sparse"), ("ragged_fused", "ragged")):
            cur = []
            again = engine(exch).run(steps, probe=lambda _t, i: cur.append(i.clone()))
            check(torch.equal(again, raster), f"{tag}: the probed run differs")
            got = torch.stack(cur).double()
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, **TOL), f"{tag}: currents off by {err}")
            currents[tag] = {"max_abs_err": err, "max_abs_current": float(want.abs().max())}
        lost = engine("ragged").run(steps, comm=lossy_comm(mesh, dev))
        check(not torch.equal(lost, raster), "a lost ragged payload left the raster unchanged")
    del want, prev
    out["currents_vs_dense_f64"] = currents
    out["planted_fault_seen"] = True
    # the raster oracle: the single-device engine, its current hook the
    # spike_accum kernel (on the card), replayed; op by op as its check
    before = LAUNCHES["spike_accum"]
    res, oracle_s, capture_s = timed(lambda: SNNEngine(
        w_syn=w, params=params, i_ext=drive, device=dev).run(steps, current_fn=spike_currents))
    oracle = res.spikes
    check(LAUNCHES["spike_accum"] - before == per_run, "oracle did not run the kernel")
    check(torch.equal(oracle, raster), "distributed != single-device oracle")
    with uncounted():
        eager = SNNEngine(w_syn=w, params=params, i_ext=drive, device=dev, graph=False)
        res, eager_s, _ = timed(lambda: eager.run(steps, current_fn=spike_currents))
    check(torch.equal(res.spikes, oracle), "oracle: replayed raster != eager")
    out["oracle"] = {"ms_per_step": (oracle_s - capture_s) / steps * 1e3,
                     "capture_s": capture_s, "eager_ms_per_step": eager_s / steps * 1e3,
                     "equal": True, "replayed_equals_eager": True}
    if dev.type == "cuda":
        # the spike_accum kernel's device time per step (one call a step)
        # under the raster's own spikes: its two CUDA kernels, compaction
        # and ring, averaged over the calls the profiler saw
        from repro_torch.kernels.spike_accum import dense_plan
        with uncounted():
            eng = SNNEngine(w_syn=w, params=params, i_ext=drive, device=dev)
            prof = _device_profile(lambda n: eng.run(n, current_fn=spike_currents), steps,
                                   match=("compact_tiles_kernel", "spike_accum_ring_kernel"))
            eager_prof = _device_profile(lambda n: eager.run(n, current_fn=spike_currents),
                                         steps)
        k2 = prof.pop("matched")
        calls = k2["calls"] / 2  # the profiler may miss a launch of the window
        out["oracle"].update(profile={"replayed": _per_step(prof, steps),
                                      "eager": _per_step(eager_prof, steps)},
                             plan=dense_plan(m, m), spike_accum_calls_seen=calls,
                             spike_accum_device_ms_per_step=k2["device_ms"] / calls if calls
                             else None,
                             fired_rows_per_step=float(raster.sum(1).mean()))
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if keep is not None:
        keep.update(syn=syn, drive=drive, mesh=mesh, params=params, steps=steps,
                    plan=plan, ledgers=ledgers, table=tb, device_weights=wg, tiles=tiles,
                    rasters={tag: r.to(torch.uint8).cpu().numpy() for tag, r in rasters.items()},
                    ms_per_step={tag: run["ms_per_step"] for tag, run in runs.items()})
    del w, tiles
    return out


def _noisy_real_size(mesh, drive, syn, tiles, dev, steps: int, quiet: dict, quiet_raster,
                     timed) -> dict:
    """The real-size ``sparse`` run again with channel noise
    (``noise_sigma=2``), replayed: every step splits each rank's key and
    draws its 4,096 normals in one ``threefry`` launch (counted, one a step),
    beside one ``spike_accum_blocks`` launch.  Its ms a step beside the
    noise-free run's (``quiet``, ``quiet_raster``), its CUDA kernels a step
    (profiled), and, uncounted, the same run op by op: the same raster; the
    noise changes it."""
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.snn import DistributedSNN, LIFParams, LoopbackComm

    def engine(graph=None):
        return DistributedSNN(mesh=mesh, params=LIFParams(noise_sigma=2.0), exchange="sparse",
                              i_ext=drive, syn=syn, tiles=tiles, device=dev, graph=graph)

    per_run = steps if dev.type == "cuda" else 0  # a CPU run takes the plain versions
    eng = engine()
    with uncounted():  # warm up
        eng.run(steps)
    before = dict(LAUNCHES)
    raster, wall, capture_s = timed(lambda: eng.run(steps, comm=LoopbackComm(mesh, dev)))
    launched = {k: LAUNCHES[k] - before[k] for k in ("threefry", "spike_accum_blocks")}
    # threefry: the split of PRNGKey(seed) into the ranks' keys, then a step each
    want = {"threefry": per_run + (per_run > 0), "spike_accum_blocks": per_run}
    check(launched == want, f"noise_2: launches {launched} for {steps} steps, not {want}")
    check(not torch.equal(raster, quiet_raster), "noise_2: the noise left the raster unchanged")
    with uncounted():
        eager = engine(graph=False).run(steps)
        check(torch.equal(eager, raster), "noise_2: replayed raster != eager")
        prof = (_per_step(_device_profile(engine().run, steps), steps)
                if dev.type == "cuda" else None)
    ms = (wall - capture_s) / steps * 1e3
    out = {"ms_per_step": ms, "noise_free_ms_per_step": quiet["ms_per_step"],
           "delta_ms_per_step": ms - quiet["ms_per_step"], "capture_s": capture_s,
           "launches": launched,
           "spikes": int(raster.sum()), "mean_rate": float(raster.mean()),
           "replayed_equals_eager": True, "profile": prof}
    out.update(sustained(raster, steps // 2))
    return out


# -- phase comm --------------------------------------------------------------

COMM_TIMEOUT = 600  # seconds a group of ranks may take; a hung collective fails


def _spawn(fn, n: int, backend: str, *args) -> list:
    """``[fn(rank, n, *args) for rank in range(n)]``, each rank in a process
    of its own in a ``backend`` group on the card
    (:func:`repro_torch.multiproc.spawn`: NCCL a card per rank, gloo the
    cards shared).  A rank that raises, dies or outlasts
    :data:`COMM_TIMEOUT` fails the run; every process is stopped."""
    from repro_torch.multiproc import spawn

    return spawn(fn, n, *args, backend=backend, device="cuda", timeout=COMM_TIMEOUT)


def _raster_digest(raster) -> str:
    return hashlib.sha256(raster.tobytes()).hexdigest()


def _real_size_rank(rank: int, n: int, backend: str, blocks, meta_path: str) -> dict:
    """Phase 4's network, one rank in this process: its own tiles staged
    from the shared host copy, sparse and ragged steps through a
    ``ProcessGroupComm``; K1 launches, the gathered raster, the ledgers and
    the wall time of the run.  ``meta_path``: the pickled rest of the
    network (drive, plan, ...)."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.snn import (
        BlockSynapses, DistributedSNN, ProcessGroupComm, gather_raster,
    )

    t_start = time.perf_counter()
    meta = pickle.loads(Path(meta_path).read_bytes())
    # from the parent's spawn to here: the process, its imports, the group
    # (the host's clock, shared with the parent)
    out = {"started_s": time.time() - meta["t_spawn"]}
    dev = torch.device("cuda", torch.cuda.current_device())
    held = range(rank, rank + 1)
    syn = BlockSynapses(indptr=meta["indptr"], src_ids=meta["src_ids"],
                        blocks=blocks.numpy(), n_blocks=meta["n_blocks"])
    t0 = time.perf_counter()
    tiles = convert.padded_tiles(syn, dev, ranks=held)
    torch.cuda.synchronize(dev)
    out.update(stage_tiles_s=time.perf_counter() - t0, tiles=tuple(tiles[1].shape),
               real_tiles=int(syn.indptr[rank + 1] - syn.indptr[rank]))
    t0 = time.perf_counter()
    comm = ProcessGroupComm(meta["mesh"], backend, dev)
    out["comm_s"] = time.perf_counter() - t0
    steps = meta["steps"]
    for tag, exch in (("sparse", "sparse"), ("ragged_fused", "ragged")):
        eng = DistributedSNN(mesh=meta["mesh"], params=meta["params"], exchange=exch,
                             i_ext=meta["drive"], syn=syn, tiles=tiles, tile_ranks=held,
                             device=dev, plan=meta["plan"] if exch == "ragged" else None,
                             graph=None if comm.capturable else False)
        t0 = time.perf_counter()
        eng.run(2, comm=comm)  # warm-up: kernels, pinned buffers, connections
        out[f"{tag}_warm_up_s"] = time.perf_counter() - t0
        comm.step_bytes.clear()
        dist.barrier()
        reset_launches()
        t0 = time.perf_counter()
        local = eng.run(steps, comm=comm)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launched = LAUNCHES["spike_accum_blocks"]
        raster = gather_raster(local, comm).to(torch.uint8).cpu().numpy()
        out[tag] = {"spike_accum_blocks_launches": launched, "wall_s": wall,
                    "digest": _raster_digest(raster), "raster": raster if rank == 0 else None,
                    "step_bytes": list(comm.step_bytes), "ledger_total": comm.ledger_total()}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["rank_s"] = time.perf_counter() - t_start
    return out


def _comm_real_size(kept: dict, backend: str) -> dict:
    """(a): phase 4's network, 8 processes of one rank each, every rank's
    raster, ledger and K1 launches against phase 4's loopback run."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    syn, steps, mesh = kept["syn"], kept["steps"], kept["mesh"]
    n = int(np.prod(mesh))
    t0 = time.perf_counter()
    blocks = torch.from_numpy(syn.blocks).share_memory_()  # every process maps this copy
    share_s = time.perf_counter() - t0
    meta = {"indptr": syn.indptr, "src_ids": syn.src_ids, "n_blocks": syn.n_blocks,
            "mesh": mesh, "params": kept["params"], "drive": kept["drive"],
            "plan": kept["plan"], "steps": steps}
    t0 = time.perf_counter()
    # a spawned process reads its arguments from a pipe as it imports what
    # they need: arguments over the pipe's 64 KB would start the ranks one
    # after another, so the drive and the plan go through a file
    with tempfile.TemporaryDirectory() as d:
        meta_path = Path(d, "meta.pkl")
        meta_path.write_bytes(pickle.dumps({**meta, "t_spawn": time.time()}))
        ranks = _spawn(_real_size_rank, n, backend, backend, blocks, str(meta_path))
    out = {"backend": backend, "processes": n,
           "mesh": list(mesh), "steps": steps, "share_host_tiles_s": share_s,
           "spawn_and_run_s": time.perf_counter() - t0,
           "rank_s_max": {key: max(r[key] for r in ranks) for key in
                          ("comm_s", "sparse_warm_up_s", "ragged_fused_warm_up_s", "rank_s")},
           "started_s": [r["started_s"] for r in ranks],
           "tiles_per_rank": [r["real_tiles"] for r in ranks],
           "padded_tiles_shape": list(ranks[0]["tiles"]),
           "stage_tiles_s_max": max(r["stage_tiles_s"] for r in ranks),
           "max_memory_allocated_per_rank": [r["max_memory_allocated"] for r in ranks]}
    del blocks
    for tag in ("sparse", "ragged_fused"):
        runs = [r[tag] for r in ranks]
        launches = [run["spike_accum_blocks_launches"] for run in runs]
        check(launches == [steps] * n,
              f"comm/{tag}: K1 launches per rank {launches}, want {steps} each")
        check(len({run["digest"] for run in runs}) == 1, f"comm/{tag}: ranks gathered "
              "different rasters")
        check(np.array_equal(runs[0]["raster"], kept["rasters"][tag]),
              f"comm/{tag}: the gathered raster != phase 4's loopback raster")
        for rank, run in enumerate(runs):
            check(run["ledger_total"] == kept["ledgers"][tag],
                  f"comm/{tag}: rank {rank}'s summed ledger != the loopback's")
        summed = np.sum([run["step_bytes"] for run in runs], axis=0).tolist()
        check(summed == kept["ledgers"][tag], f"comm/{tag}: the ranks' ledgers do not sum")
        walls = [run["wall_s"] for run in runs]
        out[tag] = {"raster_equals_loopback": True, "ledger_equals_loopback": True,
                    "bytes_per_step": kept["ledgers"][tag][0],
                    "spike_accum_blocks_launches_per_rank": steps,
                    "wall_ms_per_step": max(walls) / steps * 1e3,
                    "wall_ms_per_step_by_rank": [w / steps * 1e3 for w in walls],
                    "loopback_replayed_ms_per_step": kept["ms_per_step"][tag],
                    "spikes": int(runs[0]["raster"].sum())}
    return out


def _comm_launcher(backend: str, n: int = 4) -> dict:
    """(b): the launcher at its size as a user starts it, ``python -m
    torch.distributed.run --standalone --nproc-per-node n -m
    repro_torch.launch.run_brainsim --backend ...``, one run per exchange,
    the four side by side; each against the same launcher on the loopback
    in this process: rank 0's lines (the loopback's plus the executed
    ledger), the raster every rank gathered, the ledger and each rank's K1
    launches (``--save``)."""
    import os
    import signal
    import tempfile

    import numpy as np

    from repro_torch.launch import run_brainsim

    exchanges = ("flat", "two_level", "sparse", "ragged")
    argv = ["--ranks", str(n), "--noise", "2.0", "--steps", str(STEPS)]
    here = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(here / "src"), os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = {exch: subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), "-m", "repro_torch.launch.run_brainsim", *argv,
             "--backend", backend, "--exchange", exch, "--save", f"{d}/{exch}.npz"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=here,
            start_new_session=True) for exch in exchanges}
        deadline = time.monotonic() + COMM_TIMEOUT
        printed = {}
        try:
            for exch, proc in procs.items():
                printed[exch] = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for proc in procs.values():  # a run past its time: every rank of every run
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        saved = {}
        for exch, proc in procs.items():
            check(proc.returncode == 0, f"comm/launcher/{exch}: torch.distributed.run exited "
                  f"{proc.returncode}:\n{printed[exch][1][-3000:]}")
            with np.load(f"{d}/{exch}.npz") as z:
                saved[exch] = {key: z[key] for key in z.files}
    out = {"backend": backend, "processes": n, "steps": STEPS, "noise": 2.0,
           "started_by": "python -m torch.distributed.run --standalone",
           "runs_side_by_side_s": time.perf_counter() - t0}
    for exch in exchanges:
        loop_lines = io.StringIO()
        with uncounted(), contextlib.redirect_stdout(loop_lines):  # the loopback, the check
            want = run_brainsim.main([*argv, "--exchange", exch])
        got, lines = saved[exch], printed[exch][0].strip().splitlines()
        check(lines[:-1] == loop_lines.getvalue().strip().splitlines()
              and lines[-1] == f"executed slow-axis bytes/step over {n} processes "
                               f"({backend}): {want['ledger'][0]}",
              f"comm/launcher/{exch}: rank 0 printed {lines}")
        check(len(set(got["digests"].tolist())) == 1, f"comm/launcher/{exch}: ranks differ")
        check(np.array_equal(got["raster"], want["raster"]),
              f"comm/launcher/{exch}: raster != the loopback launcher's")
        check(got["ledger"].tolist() == want["ledger"],
              f"comm/launcher/{exch}: ledger != the loopback's")
        launches = [r["spike_accum_blocks"] for r in json.loads(str(got["launches"]))]
        want_launches = STEPS if exch in ("sparse", "ragged") else 0
        check(launches == [want_launches] * n,
              f"comm/launcher/{exch}: K1 launches per rank {launches}")
        out[exch] = {"raster_equals_loopback": True, "ledger_equals_loopback": True,
                     "spikes": int(want["raster"].sum()), "bytes_per_step": want["ledger"][0],
                     "spike_accum_blocks_launches_per_rank": want_launches,
                     "rank0_lines": lines}
    return out


def _nccl_one_rank(rank: int, n: int) -> dict:
    """(c): NCCL at world size 1 — the hierarchical collectives give the
    identity, and the engine, replayed from a CUDA graph over a
    ``ProcessGroupComm``, gives the loopback's raster and ledger."""
    import numpy as np
    import torch

    from repro_torch.core import hierarchical as h
    from repro_torch.snn import (
        BlockSynapses, DistributedSNN, LIFParams, LoopbackComm, ProcessGroupComm,
        expand_synapses, generate_brain_model,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # as in the parent
    dev = torch.device("cuda", torch.cuda.current_device())
    out: dict = {}
    comm = ProcessGroupComm((1, 1), "nccl", dev)
    x = torch.arange(30, dtype=torch.float32, device=dev).reshape(1, 1, 6, 5)
    flat, two = h.make_exchange_fns(comm)
    for name, got in (("flat_all_to_all", flat(x)), ("two_level_all_to_all", two(x)),
                      ("flat_psum", h.flat_psum(x[0], comm)),
                      ("hierarchical_psum", h.hierarchical_psum(x[0], comm)),
                      ("two_level_all_gather", h.two_level_all_gather(x[0], comm))):
        check(torch.equal(got.reshape(x.shape), x), f"comm/nccl: {name} is not the identity")
    out["hierarchical_identity"] = True
    out["capturable"] = comm.capturable
    bm = generate_brain_model(n_populations=128, n_regions=8, total_neurons=1_000_000, seed=0)
    w = expand_synapses(bm.graph, 4, seed=0)[0].astype(np.float32) * np.float32(0.05)
    params = LIFParams(noise_sigma=2.0)
    syn = BlockSynapses.from_dense(w, 1)
    for mesh, exchanges in (((1,), ("flat", "sparse", "ragged")),
                            ((1, 1), ("flat", "two_level", "sparse", "ragged"))):
        for exch in exchanges:
            kw = {"w_syn": w} if exch in ("flat", "two_level") else {"syn": syn}
            eng = DistributedSNN(mesh=mesh, params=params, exchange=exch, i_ext=3.5,
                                 device=dev, **kw)
            loop = LoopbackComm(mesh, dev)
            want = eng.run(STEPS, comm=loop)
            pg = ProcessGroupComm(mesh, "nccl", dev)
            with captures() as caps:
                got = eng.run(STEPS, comm=pg)
            check(torch.equal(got, want), f"comm/nccl/{mesh}/{exch}: raster != loopback")
            check(pg.ledger_total() == loop.step_bytes, f"comm/nccl/{mesh}/{exch}: ledger")
            check(eng.graph and len(caps) == 1,
                  f"comm/nccl/{mesh}/{exch}: {len(caps)} captures, graph={eng.graph}")
            out["x".join(map(str, mesh)) + "/" + exch] = {
                "replayed": True, "capture_s": caps[0], "raster_equals_loopback": True,
                "spikes": int(want.sum())}
    return out


def phase_comm(dev, kept: dict) -> dict:
    """The spike exchange across real processes (see the module's
    docstring): (a) phase 4's network on 8 gloo processes sharing the card,
    (b) the launcher on 4, (c) NCCL at world size 1."""
    import gc

    import torch

    gc.collect()  # phase 4's dense W and graphs, before 8 more contexts
    torch.cuda.empty_cache()
    out = {"real_size": _comm_real_size(kept, "gloo"), "launcher": _comm_launcher("gloo")}
    out["nccl_world_1"] = _spawn(_nccl_one_rank, 1, "nccl")[0]
    return out


# -- phase recovery ----------------------------------------------------------

#: ``benchmarks/fault_bench.py``'s fixed disaster (a 256-device, 16-group
#: planted deployment; crashes of devices 37 and 121 at steps 3 and 7, a
#: leaf uplink down, device 200 four times slower) and the trajectory gates
#: its CPU run prints with the JAX package: ``fault/steps_lost`` 2 and
#: ``fault/availability`` 12 committed steps of 14 attempted
FAULT_N, FAULT_G, FAULT_STEPS = 256, 16, 12
FAULT_REFERENCE = {"steps_lost": 2, "attempts": 14}


def fault_bench_setup():
    """fault_bench's seed table, device weights, fat tree and schedule,
    built by the port: ``(tm, wg, tb, topo, outage_link, schedule)``."""
    import numpy as np

    from repro_torch.chaos import FaultEvent, FaultSchedule
    from repro_torch.core import TrafficMatrix, planted_partition_graph, two_level_routing
    from repro_torch.netsim import fat_tree

    graph, _ = planted_partition_graph(FAULT_N, n_blocks=FAULT_G, avg_degree=32,
                                       p_in_frac=0.9, seed=0)
    tm = TrafficMatrix.from_coo(graph.rows(), graph.indices, graph.edge_traffic(),
                                FAULT_N).symmetrized(halve=True)
    wg = np.ones(FAULT_N)
    tb = two_level_routing(tm, wg, FAULT_G, seed=0)
    topo = fat_tree(FAULT_N, FAULT_N // FAULT_G)
    link = int(topo.params["leaf_up"][37 // (FAULT_N // FAULT_G)][0])
    schedule = FaultSchedule(events=(
        FaultEvent("device_crash", step=3, device=37),
        FaultEvent("device_crash", step=7, device=121),
        FaultEvent("link_down", step=5, link=link, t_down=0.0, t_up=4.0e-5),
        FaultEvent("straggler", step=0, device=200, slowdown=4.0),
    ), seed=0)
    return tm, wg, tb, topo, link, schedule


def lif_trajectory(schedule, ckpt_dir: str, device, n_steps: int = FAULT_STEPS):
    """fault_bench's toy LIF membrane loop (``_lif_run``: 64 neurons,
    float64, a checkpoint every 2 steps) under the port's ``Supervisor``,
    its state tensors on ``device``; ``schedule`` (or ``None``) drives the
    chaos ``supervisor_hook``.  Returns ``(raster, history, states)``:
    ``raster[step]`` the spikes the step committed (a replay overwrites),
    ``states[step]`` the membrane after ``step`` steps."""
    import numpy as np
    import torch

    from repro_torch.chaos import supervisor_hook
    from repro_torch.train import Supervisor, SupervisorConfig

    dev = torch.device(device)
    n = 64
    w = torch.as_tensor(np.random.default_rng(42).uniform(-0.2, 0.5, (n, n)), device=dev)
    raster: dict = {}
    states: dict = {0: torch.zeros(n, dtype=torch.float64, device=dev)}

    def data_iter(step):
        # per-step input current, recomputable after a rollback
        g = np.random.default_rng(1000 + step)
        return {"i_ext": torch.as_tensor(g.uniform(0.0, 1.2, n), device=dev), "step": step}

    def train_step(params, opt_state, batch):
        v = params["v"]
        spikes = (v >= 1.0).double()
        v = torch.where(spikes > 0, 0.0, v)
        v = 0.9 * v + batch["i_ext"] + 0.3 * (w @ spikes)
        raster[batch["step"]] = spikes
        states[batch["step"] + 1] = v
        return float(spikes.sum()), {"v": v}, opt_state, None

    sup = Supervisor(
        train_step, {"v": states[0].clone()},
        {"t": torch.zeros(1, dtype=torch.float64, device=dev)}, data_iter,
        SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=2, seed=0),
        failure_hook=None if schedule is None else supervisor_hook(schedule),
        evacuate_hook=lambda devs: True,
    )
    return raster, sup.run(n_steps), states


def _slots_of(perm, n: int):
    """Inverse of a rank layout: ``out[device]`` is its mesh slot."""
    import numpy as np

    out = np.empty(n, dtype=np.int64)
    out[perm] = np.arange(n)
    return out


def _natural(raster, perm):
    """A raster in a layout's slot order put back in device order."""
    import torch

    t, m = raster.shape
    slots = raster.reshape(t, len(perm), m // len(perm))
    out = torch.empty_like(slots)
    out[:, torch.as_tensor(perm, device=raster.device)] = slots
    return out.reshape(t, m)


def _recovery_network(device, kept: dict) -> dict:
    """(a) and (b) of phase ``recovery`` on phase 4's network: the table's
    layout, an incremental replan and the fault path, each plan staged and
    flipped into the running engine and run as the main path runs."""
    import numpy as np
    import torch

    from repro_torch.analysis import PlanContext, run_lints
    from repro_torch.analysis._support import _edit_batch
    from repro_torch.core import evacuate_device, replan
    from repro_torch.kernels import LAUNCHES
    from repro_torch.snn import (
        DistributedSNN, LoopbackComm, PlanBuffer, bridge_inner_from_table,
        build_ragged_plan, group_mesh_permutation, permute_ranks,
    )

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    syn, drive, mesh, params = kept["syn"], kept["drive"], kept["mesh"], kept["params"]
    steps, tb, wg = kept["steps"], kept["table"], kept["device_weights"]
    n_dev = syn.n_blocks
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    phase4 = torch.as_tensor(kept["rasters"]["ragged_fused"], device=dev).float()
    state = {"perm": np.arange(n_dev), "syn": syn, "tiles": kept["tiles"], "drive": drive}

    def relayout(table) -> dict:
        """The rank layout ``table`` asks for (``group_mesh_permutation``);
        when it differs from the running one, the synapses, their tiles
        (moved on the card) and the drive follow it."""
        perm, shape = group_mesh_permutation(table)
        check(shape == tuple(mesh), f"table's mesh {shape} != the engine's {mesh}")
        info = {"layout": perm.tolist(), "moved_ranks": 0, "relayout_s": 0.0}
        if not np.array_equal(perm, state["perm"]):
            t0 = time.perf_counter()
            rel = _slots_of(state["perm"], n_dev)[perm]
            state["syn"], state["tiles"] = permute_ranks(state["syn"], rel, state["tiles"])
            state["drive"] = drive.reshape(n_dev, -1)[perm].ravel()
            state["perm"] = perm
            sync()
            info.update(moved_ranks=int(np.count_nonzero(rel != np.arange(n_dev))),
                        relayout_s=time.perf_counter() - t0)
        return info

    def plan_for(table):
        t0 = time.perf_counter()
        plan = build_ragged_plan(state["syn"], tuple(mesh),
                                 bridge_inner=bridge_inner_from_table(table))
        return plan, time.perf_counter() - t0

    def counted_run(eng) -> tuple:
        """A main-path run: one K1 launch a step, one capture on the card,
        the executed ledger equal to the plan's bytes on every step."""
        comm = LoopbackComm(mesh, dev)
        before = LAUNCHES["spike_accum_blocks"]
        sync()
        t0 = time.perf_counter()
        with captures() as caps:
            raster = eng.run(steps, comm=comm)
        sync()
        wall = time.perf_counter() - t0
        launched = LAUNCHES["spike_accum_blocks"] - before
        vol = eng.exchange_stats()["ragged"]
        check(launched == (steps if on_card else 0), f"{launched} K1 launches in {steps} steps")
        check(comm.step_bytes == [vol] * steps,
              f"executed bytes {set(comm.step_bytes)} != exchange_volume {vol}")
        if on_card:
            check(eng.graph and len(caps) == 1, f"{len(caps)} captures: the run did not replay")
        return raster, {"ms_per_step": (wall - sum(caps)) / steps * 1e3,
                        "capture_s": sum(caps), "graph": eng.graph, "K1_launches": launched,
                        "bytes_per_step": vol}

    def from_scratch(plan):
        with uncounted():
            return DistributedSNN(mesh=mesh, params=params, exchange="ragged",
                                  i_ext=state["drive"], syn=state["syn"], plan=plan,
                                  tiles=state["tiles"], device=dev).run(steps)

    def flip_in(buf, table, tag: str, out: dict):
        """Stage ``table``'s ragged plan beside the running engine, flip it
        in, run it, and hold it to an engine built from scratch on it."""
        old_syn = state["syn"]
        out.update(relayout(table))
        plan, plan_s = plan_for(table)
        if state["syn"] is old_syn:  # same layout: the running engine's tiles
            reuse = buf.stage(plan)
        else:
            reuse = buf.stage(plan, syn=state["syn"], tiles=state["tiles"],
                              i_ext=state["drive"])
        eng = buf.flip()
        check(eng.tiles[1] is state["tiles"][1], f"{tag}: the flipped engine re-staged its tiles")
        raster, run = counted_run(eng)
        check(torch.equal(raster, from_scratch(plan)),
              f"{tag}: flipped raster != an engine built from scratch on its plan")
        out.update(plan_s=plan_s, stage_reuses_step=reuse, run=run,
                   equals_from_scratch=True, bridge_inner=bridge_inner_from_table(table).tolist(),
                   equals_phase4=bool(torch.equal(_natural(raster, state["perm"]), phase4)))
        return plan, raster

    out: dict = {"steps": steps, "mesh": list(mesh), "groups": tb.group_of.tolist(),
                 "bridge": tb.bridge.tolist()}
    # the running engine: phase 4's network on the table phase 4 planned
    # (phase 4 itself ran the ranks in device order with round-robin bridges)
    base = out["base"] = relayout(tb)
    plan0, base["plan_s"] = plan_for(tb)
    buf = PlanBuffer(DistributedSNN(mesh=mesh, params=params, exchange="ragged",
                                    i_ext=state["drive"], syn=state["syn"], plan=plan0,
                                    tiles=state["tiles"], device=dev))
    raster0, base["run"] = counted_run(buf.engine)
    base["equals_phase4"] = bool(torch.equal(_natural(raster0, state["perm"]), phase4))

    # (a) an incremental replan of an edit batch, flipped in
    t0 = time.perf_counter()
    res = replan(tb, wg, _edit_batch(tb, 0, 16))
    edit = out["replan"] = {"host_s": time.perf_counter() - t0,
                            "moved_devices": res.moved_devices,
                            "reelected_groups": res.reelected_groups.tolist(),
                            "groups": res.table.group_of.tolist(),
                            "bridge": res.table.bridge.tolist()}
    _, raster1 = flip_in(buf, res.table, "replan", edit)
    edit["case"] = ("a device changed group: layout, tiles and drive followed the table"
                    if edit["moved_ranks"] else "no device changed group: tiles taken over")
    edit["equals_base"] = bool(torch.equal(_natural(raster1, state["perm"]),
                                           _natural(raster0, base["layout"])))

    # (b) the fault path: a bridge of the table dies
    d = int(tb.bridge[tb.bridge >= 0].ravel()[0])
    slot0 = int(_slots_of(np.asarray(base["layout"]), n_dev)[d])
    check(any(slot0 in pair for rnd in plan0.rounds for pair in rnd.perm),
          f"device {d} carried no slow-axis payload before the fault")
    t0 = time.perf_counter()
    delta, wg2, host = evacuate_device(tb, wg, d)
    fault = replan(tb, wg2, delta, dead=[d]).table
    fb = out["fault"] = {"dead": d, "host": int(host), "host_s": time.perf_counter() - t0,
                         "groups": fault.group_of.tolist(), "bridge": fault.bridge.tolist()}
    check(not np.any(fault.bridge == d), f"the fault table keeps device {d} as a bridge")
    findings = run_lints(PlanContext.from_table(fault, name="recovery.fault", wg=wg2, dead=[d]))
    check(not [f for f in findings if f.rule_id in ("PL170", "PL171")],
          f"PL170/PL171 fired on the fault table: {[str(f) for f in findings]}")
    fb["lint"] = {"findings": len(findings), "PL170_PL171": 0,
                  "errors": sum(f.severity == "error" for f in findings)}
    plan_f, _ = flip_in(buf, fault, "fault", fb)
    slot = int(_slots_of(state["perm"], n_dev)[d])
    check(not any(slot in pair for rnd in plan_f.rounds for pair in rnd.perm),
          f"a round of the fault plan makes rank {d} forward a payload across the slow axis")
    fb["dead_rank_off_bridge_duty"] = True
    return out


def _recovery_supervised(device) -> dict:
    """(c) of phase ``recovery``: fault_bench's supervised trajectory with
    its state on ``device``, and its recover-vs-rebuild host seconds."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import evacuate_devices, replan, two_level_routing
    from repro_torch.train import restore, verify_checkpoint

    dev = torch.device(device)
    tm, wg, tb, _topo, _link, schedule = fault_bench_setup()
    dead = list(schedule.dead_devices())
    out: dict = {"dead": dead}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d_fault, tempfile.TemporaryDirectory() as d_clean:
        raster_f, hist, states = lif_trajectory(schedule, d_fault, dev)
        raster_c, _, _ = lif_trajectory(None, d_clean, dev)
        out["trajectory_s"] = time.perf_counter() - t0
        check(sorted(raster_f) == sorted(raster_c) == list(range(FAULT_STEPS)),
              "the supervised run committed other steps than the failure-free one")
        check(all(raster_f[s].device.type == dev.type and torch.equal(raster_f[s], raster_c[s])
                  for s in raster_c), "supervised raster != failure-free raster")
        steps_lost, availability = len(hist) - FAULT_STEPS, FAULT_STEPS / len(hist)
        check(steps_lost == FAULT_REFERENCE["steps_lost"]
              and len(hist) == FAULT_REFERENCE["attempts"],
              f"steps_lost {steps_lost}, availability {availability} != the reference's")
        kept = sorted(int(n.split("_")[1]) for n in os.listdir(d_fault)
                      if n.startswith("step_") and not n.endswith(".tmp"))
        for s in kept:
            check(verify_checkpoint(d_fault, s), f"checkpoint {s}: manifest does not verify")
            like = {"v": torch.empty(64, dtype=torch.float64, device=dev)}
            params, opt, manifest = restore(d_fault, s, like,
                                            {"t": torch.empty(1, dtype=torch.float64)},
                                            device=dev)
            check(params["v"].device.type == dev.type and opt["t"].device.type == dev.type
                  and manifest["step"] == s and torch.equal(params["v"], states[s]),
                  f"checkpoint {s} did not restore the committed state onto {dev}")
    out.update(trajectory_bit_equal=True, steps_lost=steps_lost, availability=availability,
               attempts=len(hist), retried_steps=[h.step for h in hist if h.restarted],
               checkpoints_restored=kept,
               spikes=int(sum(float(r.sum()) for r in raster_c.values())))

    # fault_bench's recovery vs rebuild, host seconds, best of 3
    def best(fn):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = fn()
            ts.append(time.perf_counter() - t0)
        return res, min(ts)

    def recover():
        ev = evacuate_devices(tb, wg, dead)
        return replan(tb, ev.wg_after, ev.delta, dead=dead), ev

    (res, ev), t_rec = best(recover)
    _, t_reb = best(lambda: two_level_routing(tm.apply_delta(*ev.delta), ev.wg_after,
                                               FAULT_G, seed=0))
    tmd = res.table.device_traffic
    check(not np.any(np.isin(tmd.rows(), dead)) and not np.any(np.isin(tmd.indices, dead))
          and not np.any(np.isin(res.table.bridge, dead)), "the recovered plan uses a dead device")
    out["recover_vs_rebuild"] = {"recover_host_ms": t_rec * 1e3, "rebuild_host_ms": t_reb * 1e3,
                                 "speedup": t_reb / t_rec}
    return out


def _recovery_cli() -> dict:
    """(d) of phase ``recovery``: the planlint CLI as a user runs it."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    out = {}
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--all", "--stats"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=root)
    check(run.returncode == 0, f"planlint --all --stats exited {run.returncode}: "
          f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
    lines = run.stdout.splitlines()
    out["all_stats"] = {"rc": 0, "s": time.perf_counter() - t0,
                        "contexts_ok": sum(ln.startswith("ok [") for ln in lines),
                        "summary": [ln for ln in lines if "error(s)" in ln]}
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--rules-md"],
                         capture_output=True, text=True, env=env, timeout=120, cwd=root)
    check(run.returncode == 0 and run.stdout == (root / "docs" / "RULES.md").read_text(),
          "planlint --rules-md differs from docs/RULES.md")
    out["rules_md_equals_docs"] = True
    return out


def phase_recovery(device, kept: dict) -> dict:
    """Replanning and recovery (see the module's docstring): (a)-(b) on
    phase 4's network and tiles, (c) the supervised trajectory, (d) the
    planlint CLI."""
    t0 = time.perf_counter()
    out = _recovery_network(device, kept)
    out["network_s"] = time.perf_counter() - t0
    out["supervised"] = _recovery_supervised(device)
    out["cli"] = _recovery_cli()
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- plan_paper_scale --------------------------------------------------------

#: the paper-scale plan's deterministic outputs as the JAX package's
#: ``python -m benchmarks.paper_scale`` prints them (numpy on a CPU)
PAPER_SCALE_REFERENCE = {
    "tm_nnz": 274_636, "conn_p2p_max": 396, "conn_two_level_max": 165,
    "msgs_two_level": 212_865, "msgs_p2p": 274_636,
    "closed_ratio_p2p_over_two_level": 6.217, "wire_ratio_p2p_over_two_level": 1.146,
    "peak_dense_frac": 0.01,
}


def phase_plan_paper_scale() -> dict:
    """The paper's experiment planned on the host by the port's numpy
    planning layer, as ``benchmarks/paper_scale.py`` plans it with the
    reference's: a 10-billion-neuron model of 8,000 populations, the
    out-of-core planner over 2,000 devices in pods of 100, the shard
    lints with PL160, Fig. 4's connection counts, the netsim replays on
    the two-tier fabric and the closed-form estimates."""
    import numpy as np

    from repro_torch import netsim
    from repro_torch.core import (
        ClusterModel, connection_counts, estimate, p2p_routing, plan_out_of_core,
    )
    from repro_torch.snn import generate_brain_model

    n, pod = 2000, 100
    host_s = {}
    t_phase = t0 = time.perf_counter()
    bm = generate_brain_model(n_populations=8000, n_regions=90,
                              total_neurons=10_000_000_000, lambda_mm=30.0,
                              inter_degree=36.0, long_range_frac=0.5, seed=0)
    host_s["model"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_out_of_core(bm.graph, n, pod, block_size=4, seed=0, sym_mode="both")
    host_s["planner"] = time.perf_counter() - t0
    host_s.update({f"planner.{k}": v for k, v in plan.wall_s.items()})
    dcn_errors = sum(1 for f in plan.dcn_findings if f.severity == "error")

    t0 = time.perf_counter()
    tb_p2p = p2p_routing(plan.traffic, plan.wg)
    cc_p2p, cc_two = connection_counts(tb_p2p), connection_counts(plan.pod_table)
    host_s["connections"] = time.perf_counter() - t0

    cl = ClusterModel(bytes_per_traffic_unit=2.0e5)
    topo = netsim.two_tier(n, pod)
    t0 = time.perf_counter()
    rounds = netsim.sharded_rounds(plan, bytes_per_unit=cl.bytes_per_traffic_unit)
    p2p = netsim.p2p_rounds(plan.traffic, bytes_per_unit=cl.bytes_per_traffic_unit)
    res_two = netsim.simulate(rounds, topo, alpha_msg=cl.alpha_conn, barriers=True)
    res_p2p = netsim.simulate(p2p, topo, alpha_msg=cl.alpha_conn)
    host_s["netsim"] = time.perf_counter() - t0
    conserved = True
    for res in (res_two, res_p2p):
        try:
            res.assert_conserved()
        except AssertionError:
            conserved = False
    t0 = time.perf_counter()
    e_two = estimate(plan.pod_table, cl, model="closed_form")
    e_p2p = estimate(tb_p2p, cl, model="closed_form")
    host_s["closed_form"] = time.perf_counter() - t0

    got = {
        "tm_nnz": int(plan.traffic.nnz), "conn_p2p_max": int(cc_p2p.max()),
        "conn_two_level_max": int(cc_two.max()),
        "msgs_two_level": sum(len(r) for r in rounds), "msgs_p2p": sum(len(r) for r in p2p),
        "closed_ratio_p2p_over_two_level": round(e_p2p.t_total / e_two.t_total, 3),
        "wire_ratio_p2p_over_two_level": round(res_p2p.t_total / res_two.t_total, 3),
        "peak_dense_frac": round(plan.peak_dense_elems / float(n) ** 2, 4),
    }
    host_s["phase"] = time.perf_counter() - t_phase
    vs = {k: {"port": v, "reference": PAPER_SCALE_REFERENCE[k],
              "equal": bool(v == PAPER_SCALE_REFERENCE[k])} for k, v in got.items()}
    out = {"devices": n, "pod_size": pod, "pods": plan.n_pods,
           "populations": bm.n_populations, "host_s": host_s,
           "shard_lint_errors": plan.shard_lint_errors,
           "shard_lint_warnings": plan.shard_lint_warnings,
           "shard_warnings": [f"pod {sh.pod}: {f.rule_id}: {f.message}" for sh in plan.shards
                              for f in sh.findings if f.severity == "warning"],
           "dcn_findings": len(plan.dcn_findings), "cross_shard_ok": dcn_errors == 0,
           "bytes_conserved": conserved,
           "mean_shard_groups": float(np.mean([s.mesh_shape[0] for s in plan.shards])),
           "conn_reduction_max": float(cc_p2p.max()) / float(cc_two.max()),
           "conn_reduction_mean": float(cc_p2p.mean()) / float(cc_two.mean()),
           "t_two_level_wire_s": res_two.t_total, "t_p2p_wire_s": res_p2p.t_total,
           "t_two_level_closed_s": e_two.t_total, "t_p2p_closed_s": e_p2p.t_total,
           "vs_reference": vs, "all_equal_reference": all(c["equal"] for c in vs.values())}
    counts = ("tm_nnz", "conn_p2p_max", "conn_two_level_max", "msgs_two_level", "msgs_p2p")
    check(all(vs[k]["equal"] for k in counts),
          f"paper scale: counts differ from the reference's: { {k: vs[k] for k in counts} }")
    check(plan.shard_lint_errors == 0, f"paper scale: {plan.shard_lint_errors} shard lint errors")
    check(dcn_errors == 0, f"paper scale: cross-shard check failed: {plan.dcn_findings}")
    check(conserved, "paper scale: a netsim replay did not conserve bytes")
    return out


# -- phase 5 ---------------------------------------------------------------

SERVE_ARCH = "phi4-mini-3.8b"
MOE_ARCH = "qwen3-moe-30b-a3b"
# the remaining dense text configs (phase name -> arch), at full
# width and depth
DENSE_PATHS = {"serve_deepseek_7b": "deepseek-7b", "serve_qwen2_5_14b": "qwen2.5-14b",
               "serve_yi_34b": "yi-34b"}
MIXTRAL_LAYERS = 2  # of mixtral-8x22b's 56: about 10.8 GB of its 281 GB
# layers served of the paths cut in depth to keep the script's clock: with
# phase train's full-width paths (PR 28) qwen3-moe and mamba2, whose depth is
# the largest host cost among the serving paths (eager decode, the float32
# checks); with the replayed-against-eager train checks, the prefill profiles
# and both schedulers' eager runs (PR 29) the two largest dense paths
SERVE_LAYERS = {MOE_ARCH: 16, "mamba2-1.3b": 24, "yi-34b": 30, "qwen2.5-14b": 24}
MIXTRAL_PROMPT = 6000
SERVE_REQUESTS, SERVE_SLOTS = 8, 4
F32_LOGIT_BOUND = 0.05  # tests/test_models.py:94-114, float32 compute
MOE_F32_REL = 1e-4  # one full-width MoE layer, card vs CPU, float32 compute
_TEXT = {"kv": None, "heads": None, "consistency_len": None,
         "first_wave": False, "new": 64, "reduced": None,
         "eager": ("generate", "generate_continuous"), "long_prompt": None}
# the paths of DENSE_PATHS and mixtral, cut for the clock: 16 tokens
_NEW = {**_TEXT, "new": 16}
# per serving path: n_kv_heads and n_heads of the reduced config checked card
# vs CPU (phi4 with 2 KV heads for GQA; qwen2.5, mixtral and yi at their full
# configs' groups, 5, 6 and 7, where reduced() makes them MHA), the prompt
# length S + 1 of the prefill(S) + decode vs prefill(S + 1) check (None: the
# first request's prompt plus one token; mamba2: S = 127, since prefill(S)
# needs min(128, S) to divide S), whether the first wave's tokens must agree
# between the schedulers (False: only its last request's, under float32
# compute), the greedy tokens a request, the reduced configs held card
# against CPU (None: the arch's own), the schedulers run again op by op, and
# a batch-1 request of that many tokens
SERVE_PATHS = {
    "phi4-mini-3.8b": {**_TEXT, "kv": 2, "first_wave": True},
    "mamba2-1.3b": {**_TEXT, "consistency_len": 128},
    "recurrentgemma-9b": {**_TEXT, "consistency_len": LONG_PROMPT + 1,
                          "long_prompt": LONG_PROMPT},
    MOE_ARCH: {**_TEXT, "new": 32, "reduced": (MOE_ARCH, "mixtral-8x22b")},
    "deepseek-7b": _NEW,
    "qwen2.5-14b": {**_NEW, "heads": 10, "kv": 2},
    "yi-34b": {**_NEW, "heads": 14, "kv": 2},
    # mixtral-8x22b (281 GB of bf16) at full width, cut to MIXTRAL_LAYERS of
    # its 56 layers: a batch-1 prompt of 6,000 tokens (the engine's bucket of
    # 8,192 fills the 4,096-slot ring twice) and the prefill(S) + decode
    # check at S = 6,000, whose ring is misaligned
    "mixtral-8x22b": {**_NEW, "heads": 12, "kv": 2, "consistency_len": MIXTRAL_PROMPT + 1,
                      "long_prompt": MIXTRAL_PROMPT},
}


@contextlib.contextmanager
def compute_dtype(dtype):
    """The model's matmul dtype (``layers.COMPUTE_DTYPE``) for a check."""
    from repro_torch.models import layers

    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = saved


def _bf16_close(got, want, n_vocab: int) -> tuple[float, float]:
    """(max |got - want|, its allowance): two bf16 steps of the reference
    value plus two steps of its rms (tests/test_torch_lm.py's bound)."""
    got, want = got[..., :n_vocab].float().cpu(), want[..., :n_vocab].float().cpu()
    rms = float(want.double().pow(2).mean().sqrt())
    excess = float(((got - want).abs() - 2**-6 * want.abs()).max())
    return float((got - want).abs().max()), excess - 2**-6 * rms


def _numpy_params(cfg, seed: int, dev) -> dict:
    """The LM's parameter tree as numpy float32, ``init_params(cfg, seed)``
    drawn on the host; also drawn on ``dev`` (``threefry``) and held to the
    host's leaf by leaf: float32 leaves within 2 ulp, bfloat16 within one
    bfloat16 ulp."""
    import torch

    from repro_torch.models import lm

    host = lm.init_params(cfg, seed, device="cpu")
    card = dict(_paths(lm.init_params(cfg, seed, device=dev)))
    for path, want in _paths(host):
        ulps = _ulps(card[path].cpu(), want, want.dtype)
        check(ulps <= (2 if want.dtype == torch.float32 else 1),
              f"{cfg.name} {'/'.join(path)}: card and CPU draws {ulps} ulp apart")
    return _to_numpy(host)


def _to_numpy(node):
    """A parameter tree as numpy float32, on the host."""
    return {k: _to_numpy(v) for k, v in node.items()} if isinstance(node, dict) \
        else node.float().cpu().numpy()


def _front_end_batch(cfg, b: int, s: int, seed: int) -> tuple[dict, int]:
    """Numpy inputs of ``cfg``'s front end: ``tokens`` [b, s] (audio: [b,
    s, ncb]) and for vlm ``vision_embed`` [b, Nv, D] (the data pipeline's
    standard normal); and Nv, where the text's positions start."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.modality == "audio" else (b, s)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.modality != "vlm":
        return batch, 0
    batch["vision_embed"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model),
                                                dtype=np.float32)
    return batch, cfg.vision_tokens


def _nonzero_leaves(tree: dict, cfg, seed: int) -> list[str]:
    """Every leaf of the numpy tree ``tree`` that ``init_params`` makes zero
    (``PDef.init == "zeros"``: q/k/v biases, QK-norm and norm scales, the
    ssm skip) replaced in place by seeded ``0.1 · normal`` float32 values,
    so that a bias or scale the card dropped shows; their paths."""
    import numpy as np

    from repro_torch.models import lm

    rng, done = np.random.default_rng(seed), []
    for path, pd in _paths(lm.param_defs(cfg)):
        if pd.init == "zeros":
            node = tree
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = (0.1 * rng.standard_normal(pd.shape)).astype(np.float32)
            done.append("/".join(path))
    return done


def _reduced(arch: str, kv=None, heads=None):
    """``arch``'s reduced config with ``kv`` KV heads and ``heads`` q heads
    where given."""
    import dataclasses

    from repro_torch.configs import ARCHS

    over = {k: v for k, v in (("n_heads", heads), ("n_kv_heads", kv)) if v}
    return dataclasses.replace(ARCHS[arch].reduced(), **over)


def _card_vs_cpu(dev, arch: str, kv, heads=None) -> dict:
    """(a) ``arch`` reduced (with ``kv`` KV heads and ``heads`` q heads
    where given, its zero-initialised leaves made non-zero): prefill of 64
    tokens (a vlm's after its patch embeddings; audio's of 4 codebooks) and
    8 teacher-forced decode steps, on the card
    (kernels) and on the CPU (plain versions), from one set of numpy
    parameters; bf16 and float32 compute."""
    import torch

    from repro_torch import convert
    from repro_torch.models import lm

    cfg = _reduced(arch, kv, heads)
    tree = _numpy_params(cfg, 0, dev)  # the card's draw held to the CPU's
    out = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "nonzero_leaves": _nonzero_leaves(tree, cfg, 2)}
    batch, nv = _front_end_batch(cfg, 2, 72, 1)
    for dtype, label in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        logits = {}
        with compute_dtype(dtype):
            for where in (str(dev), "cpu"):
                params = convert.lm_params(tree, cfg, where)
                bt = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
                t = bt.pop("tokens")
                lg, cache = lm.prefill(params, {**bt, "tokens": t[:, :64]}, cfg,
                                       max_len=nv + 72)
                steps = [lg]
                for i in range(8):
                    lg, cache = lm.decode_step(params, cache, {"tokens": t[:, 64 + i : 65 + i]},
                                               nv + 64 + i, cfg)
                    steps.append(lg)
                logits[where] = torch.stack(steps).cpu()
        card, cpu = logits[str(dev)], logits["cpu"]
        check(bool(torch.isfinite(card[..., : cfg.vocab_size]).all()), f"{label}: non-finite logits")
        if label == "bfloat16":
            err, over = _bf16_close(card, cpu, cfg.vocab_size)
            check(over <= 0, f"card vs CPU, bf16: {err} exceeds two bf16 steps by {over}")
            bound = "rtol 2^-6 + atol 2^-6 rms"
        else:
            err = float((card - cpu)[..., : cfg.vocab_size].abs().max())
            check(err <= 1e-3, f"card vs CPU, float32: max logits diff {err}")
            bound = "1e-3"
        out[label] = {"max_abs_logit_diff": err, "bound": bound,
                      "max_abs_logit": float(cpu[..., : cfg.vocab_size].abs().max()),
                      "same_argmax": bool(torch.equal(card[..., : cfg.vocab_size].argmax(-1),
                                                      cpu[..., : cfg.vocab_size].argmax(-1)))}
    return out


@contextlib.contextmanager
def moe_routes():
    """The routing (``layers.moe_route``'s result) of every ``moe_block``
    call made inside, in order: one a layer per forward."""
    from repro_torch.models import layers

    real, seen = layers.moe_route, []

    def recorded(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    layers.moe_route = recorded
    try:
        yield seen
    finally:
        layers.moe_route = real


def _prefill_decode_consistency(params, cfg, batch: dict, dev, nv: int = 0) -> dict:
    """prefill(S) then decode_step(token S) against the last logits of
    prefill(S + 1): the prefill kernels held against the decode path at
    full width.  ``batch``: tensors on the card, ``tokens`` [B, S + 1] (audio
    [B, S + 1, ncb]) after ``nv`` patch embeddings (vlm's
    ``vision_embed``).  float32 compute holds to the reference's 0.05; bf16
    is reported.

    With experts this is no identity: prefill(S + 1) drops the slots over
    capacity (``cap = int((S + 1) · k · 1.25 / E) + 1``) and a decode step
    none.  So the bound holds only when prefill(S + 1) dropped none of the
    last token's slots, in any layer, and its capacity is prefill(S)'s
    (then the first S tokens route alike in both); otherwise the difference
    is printed beside the drop count."""
    import torch

    from repro_torch.models import lm

    toks = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    s = toks.shape[1] - 1
    out = {"S": s}
    v = cfg.vocab_size
    for dtype, label in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        with compute_dtype(dtype), torch.inference_mode(), moe_routes() as routes:
            _, cache = lm.prefill(params, {**extra, "tokens": toks[:, :s]}, cfg,
                                  max_len=nv + s + 1)
            dec, _ = lm.decode_step(params, cache, {"tokens": toks[:, s:]}, nv + s, cfg)
            del cache
            n_short = len(routes)
            full, _ = lm.prefill(params, {**extra, "tokens": toks}, cfg)
        check(bool(torch.isfinite(dec[..., :v]).all() and torch.isfinite(full[..., :v]).all()),
              f"{label}: non-finite logits")
        err = float((dec - full)[..., :v].abs().max())
        out[label] = {"max_abs_logit_diff": err, "max_abs_logit": float(full[..., :v].abs().max()),
                      "same_argmax": bool(torch.equal(dec[..., :v].argmax(-1),
                                                      full[..., :v].argmax(-1)))}
        if cfg.n_experts:
            last = routes[n_short:]  # prefill(S + 1), one routing a layer
            check(len(last) == cfg.n_layers, f"{len(last)} MoE layers routed")
            out[label]["last_token_slots_dropped"] = sum(
                int((~r["keep"][:, -1]).sum()) for r in last)
            out[label]["prefill_S1_slots_dropped"] = sum(int((~r["keep"]).sum()) for r in last)
            out[label]["slots"] = sum(r["keep"].numel() for r in last)
    if cfg.n_experts:
        caps = [int(n * cfg.top_k * 1.25 / cfg.n_experts) + 1 for n in (nv + s, nv + s + 1)]
        out["cap_S"], out["cap_S1"] = caps
        held = caps[0] == caps[1] and out["float32"]["last_token_slots_dropped"] == 0
        out["bound_asserted"] = held
        if not held:
            return out
    check(out["float32"]["max_abs_logit_diff"] < F32_LOGIT_BOUND,
          f"prefill+decode vs prefill(S+1): {out['float32']}")
    return out


MOE_LAYER_PROMPT = 1000


def _moe_layer_vs_cpu(params, cfg, dev) -> dict:
    """Layer 0's ``moe_block`` at full width on its real input (the hidden
    state of a 1,000-token prompt after layer 0's attention and norm), on
    the card and on the CPU from the same bf16 weights, float32 compute:
    every token chooses the same experts, the same (token, expert) pairs
    are kept at the same places in the experts' buffers, and the outputs
    agree within ``MOE_F32_REL`` of the largest."""
    import numpy as np
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import lm

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, MOE_LAYER_PROMPT)).astype(np.int32)).to(dev)
    lp = lm._layer(params["seg0"], 0)
    with torch.inference_mode():
        x = lm.embed_inputs(params, {"tokens": toks}, cfg)
        x = x + L.attention_block(L.rms_norm(x, lp["ln1_0"]), lp["m0"], cfg,
                                  cfg.layer_pattern[0])
        y = L.rms_norm(x, lp["ln2_0"])
        host = {k: v.cpu() for k, v in lp["mlp0"].items()}
        res, t = {}, {}
        with compute_dtype(torch.float32):
            for where, w, yy in ((str(dev), lp["mlp0"], y), ("cpu", host, y.cpu())):
                t0 = time.perf_counter()
                with moe_routes() as routes:
                    out = L.moe_block(yy, w, cfg)
                res[where] = (out.float().cpu(), {k: v.cpu() if torch.is_tensor(v) else v
                                                  for k, v in routes[0].items()})
                t[where] = time.perf_counter() - t0

    def by_expert(r):  # [S, E]: each (token, expert) pair's place, -1 when not chosen
        te = torch.full((MOE_LAYER_PROMPT, cfg.n_experts), -1, dtype=torch.long)
        te.scatter_(1, r["gate_i"][0].long(), r["pos"][0])
        kept = torch.zeros((MOE_LAYER_PROMPT, cfg.n_experts), dtype=torch.bool)
        kept.scatter_(1, r["gate_i"][0].long(), r["keep"][0])
        return te, kept

    (card, rc), (cpu, rh) = res[str(dev)], res["cpu"]
    (pc, kc), (ph, kh) = by_expert(rc), by_expert(rh)
    same_experts = torch.equal(pc >= 0, ph >= 0)
    check(same_experts, "MoE layer: a token chose other experts on the card than on the CPU")
    check(torch.equal(pc, ph) and torch.equal(kc, kh),
          "MoE layer: the card kept other (token, slot) pairs than the CPU")
    err, top = float((card - cpu).abs().max()), float(cpu.abs().max())
    check(bool(torch.isfinite(card).all()) and err <= MOE_F32_REL * top,
          f"MoE layer card vs CPU (float32): {err} of {top}")
    return {"tokens": MOE_LAYER_PROMPT, "cap": rh["cap"], "slots": int(rh["keep"].numel()),
            "slots_dropped": int((~rh["keep"]).sum()),
            "same_experts": same_experts, "same_kept_pairs": True,
            "same_slot_order": bool(torch.equal(rc["gate_i"], rh["gate_i"])),
            "max_abs_diff": err, "max_abs_out": top, "bound": f"{MOE_F32_REL} of the largest",
            "card_s": t[str(dev)], "cpu_s": t["cpu"]}


def _launches_per_call(cfg) -> tuple[dict, dict]:
    """The kernel launches one prefill and one decode step must make: one
    per layer of the kernel its mixer runs, nothing else."""
    pat = cfg.layer_pattern
    n_attn = sum(m in ("full", "swa", "local") for m in pat)
    zero = {"spike_accum_blocks": 0, "spike_accum": 0, "threefry": 0}  # greedy: no draws
    prefill = {**zero, "flash_attention": n_attn, "decode_attention": 0,
               "ssd_scan": pat.count("ssm"), "rglru_scan": pat.count("rglru")}
    decode = {**zero, "flash_attention": 0, "decode_attention": n_attn,
              "ssd_scan": 0, "rglru_scan": 0}
    return prefill, decode


class _Timed:
    """Counts and times (synchronised, on the host clock) calls of a
    prefill bucket (``serve.engine._Prefill``) and of a batch's decode step
    (``serve.engine._Decode``): each the first eager, the second capturing
    its CUDA graph and replaying it, the rest replaying, as the engine makes
    them; records each call's kernel launches and checks its logits are
    finite."""

    def __init__(self, fn, n_vocab: int):
        self.fn, self.n_vocab, self.ms, self.launches = fn, n_vocab, [], []
        self.first = None  # the first call's logits over the vocabulary, float32

    def __call__(self, *args, **kw):
        import torch

        from repro_torch.kernels import LAUNCHES

        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.launches.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        logits = out[0] if isinstance(out, tuple) else out
        if hasattr(logits, "full_tensor"):  # a DTensor: the sharded route's prefill
            logits = logits.full_tensor()
        check(bool(torch.isfinite(logits[..., : self.n_vocab]).all()), "non-finite logits")
        if self.first is None:
            self.first = logits[..., : self.n_vocab].float().clone()
        return out


def _serve_timed(eng, name: str, prompts, cfg, per_call, new: int) -> dict:
    """One scheduler of ``eng`` over ``prompts`` (``new`` greedy tokens
    each), every prefill and decode call timed and its launches held to
    ``per_call``."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.serve import engine as serve_engine

    real = serve_engine._Prefill.__call__, serve_engine._Decode.__call__
    pre, dec = _Timed(real[0], cfg.vocab_size), _Timed(real[1], cfg.vocab_size)
    serve_engine._Prefill.__call__ = lambda self, tokens: pre(self, tokens)
    serve_engine._Decode.__call__ = lambda self, tokens: dec(self, tokens)
    try:
        t0 = time.perf_counter()
        with captures() as caps:
            toks = getattr(eng, name)(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serve_engine._Prefill.__call__, serve_engine._Decode.__call__ = real
    for kind, timed, want in (("prefill", pre, per_call[0]), ("decode", dec, per_call[1])):
        for i, got in enumerate(timed.launches):
            check(got == want, f"{name}: {kind} call {i} launched {got}, expected {want}")
    check(len(toks) == len(prompts) and all(len(t) == new for t in toks),
          f"{name}: {[len(t) for t in toks]} tokens per request")
    check(all(0 <= t < cfg.vocab_size for r in toks for t in r), f"{name}: token outside vocab")
    slots = eng.sc.batch_slots
    return {"tokens_out": toks, "first_decode_logits": dec.first, "graph": eng.graph,
            "captures": len(caps),
            "capture_s": caps, "wall_s": wall, "tokens": len(prompts) * new,
            "tokens_per_s": len(prompts) * new / wall,
            "prefill_calls": len(pre.ms), "prefill_ms": pre.ms,
            # one bucket a scheduler here: call 1 eager, call 2 captures, 3+ replay
            "prefill_ms_eager": pre.ms[0],
            "prefill_ms_replayed": float(np.mean(pre.ms[2:])) if len(pre.ms) > 2 else None,
            "prefill_buckets": {"x".join(map(str, key)): {
                "calls": getattr(b.run, "calls", None),
                "capture_s": getattr(b.run, "capture_s", None)}
                for key, b in eng._prefills.items()},
            "decode_steps": len(dec.ms), "decode_ms_per_step_mean": float(np.mean(dec.ms)),
            "decode_ms_per_step_median": float(np.median(dec.ms)),
            "decode_tokens_per_s": slots * len(dec.ms) / (sum(dec.ms) / 1e3),
            "launches_per_prefill": per_call[0], "launches_per_decode_step": per_call[1],
            "distinct_tokens_per_request": [len(set(t)) for t in toks]}


def phase_serve(dev, arch: str, cfg=None) -> dict:
    """(b) ``arch`` at full width and depth, or as ``cfg`` gives it (bf16,
    random weights from a seed): 8 requests through ``ServeEngine.generate``
    (two waves of 4) and ``generate_continuous``, every prefill and decode
    step launching exactly its layers' kernels; for recurrentgemma-9b and
    mixtral-8x22b also one batch-1 request of 4,096 / 6,000 tokens
    (``_long_request``: replayed and op by op, the same tokens).  Decode
    replays a CUDA graph per batch (the engine's default on the card); the
    same requests through the path's schedulers op by op (``graph=False``)
    must give the same greedy tokens.  (a),
    the eager runs, the prefill + decode consistency, the profiled decode
    windows (eager and replayed, their logits compared) and, with experts,
    one full-width MoE layer card against CPU run outside the launch
    counts."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine

    opts = SERVE_PATHS[arch]
    cfg, new = ARCHS[arch] if cfg is None else cfg, opts["new"]
    out: dict = {"arch": arch, "n_layers": cfg.n_layers}
    with uncounted():
        out["card_vs_cpu_reduced"] = {a: _card_vs_cpu(dev, a, opts["kv"], opts["heads"])
                                      for a in opts["reduced"] or (arch,)}
    per_call = _launches_per_call(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    out["init_params_s"] = time.perf_counter() - t0
    out["param_bytes"] = sum(int(t.numel() * t.element_size()) for t in _leaves(params))
    with uncounted():
        out["leaf_card_vs_cpu"] = _leaf_vs_cpu(params, cfg, 0)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1001, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    out["prompt_lens"] = [int(n) for n in lens]
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=SERVE_SLOTS), device=dev)

    schedulers = ("generate", "generate_continuous")
    runs = {name: _serve_timed(eng, name, prompts, cfg, per_call, new) for name in schedulers}
    out["peak_memory_replayed"] = torch.cuda.max_memory_allocated(dev)
    # the pool as the two schedulers left it (the float32 checks below add
    # buckets of their own)
    out["prefill_graph_bytes"] = _prefill_graph_bytes(eng)
    torch.cuda.reset_peak_memory_stats(dev)
    with uncounted():  # the same requests op by op: the replayed tokens' check
        eager = ServeEngine(cfg, params, ServeConfig(batch_slots=SERVE_SLOTS), device=dev,
                            graph=False)
        eager_runs = {name: _serve_timed(eager, name, prompts, cfg, per_call, new)
                      for name in opts["eager"]}
    out["peak_memory_eager"] = torch.cuda.max_memory_allocated(dev)
    for name in opts["eager"]:
        check(eager_runs[name]["tokens_out"] == runs[name]["tokens_out"],
              f"{name}: replayed greedy tokens differ from eager")
    out["replayed_tokens_equal_eager"] = list(opts["eager"])
    same = [runs["generate_continuous"]["tokens_out"][i] == runs["generate"]["tokens_out"][i]
            for i in range(SERVE_SLOTS)]
    if opts["first_wave"]:
        check(all(same), "the first wave's tokens differ between the schedulers")
    else:
        # the reference's quirk: generate_continuous's initial fill leaves
        # every slot with the last prefilled request's state, so only that
        # request decodes as in a wave (phi4's requests each repeat one token
        # and agree all the same).  Under float32 compute, where bf16
        # rounding of a batch-4 against a batch-1 prefill cannot flip a
        # token, that request must agree between the schedulers.
        with uncounted(), compute_dtype(torch.float32):
            first = prompts[:SERVE_SLOTS]
            f32 = [eng.generate(first, max_new_tokens=8)[-1],
                   eng.generate_continuous(first, max_new_tokens=8)[-1]]
        check(f32[0] == f32[1], f"float32: the first wave's last request differs: {f32}")
        out["first_wave_last_equal_float32"] = True
    out["first_wave_equal"] = same
    for run in (*runs.values(), *eager_runs.values()):
        run.pop("tokens_out")
        run.pop("first_decode_logits")
    if opts["long_prompt"]:
        long_prompt = rng.integers(0, cfg.vocab_size, opts["long_prompt"]).tolist()
        runs["long_prompt_batch1"] = _long_request(dev, params, cfg, long_prompt, per_call, new)
    out["runs"] = runs
    out["eager_runs"] = eager_runs

    with uncounted():
        n = opts["consistency_len"]
        prompt = (prompts[0] + [int(rng.integers(0, cfg.vocab_size))] if n is None
                  else rng.integers(0, cfg.vocab_size, n).tolist())
        out["prefill_decode_consistency"] = _prefill_decode_consistency(
            params, cfg, {"tokens": torch.tensor([prompt], dtype=torch.int32, device=dev)}, dev)
        if cfg.n_experts:
            out["moe_layer_card_vs_cpu"] = _moe_layer_vs_cpu(params, cfg, dev)
        out["decode_profile"] = _decode_profile(params, cfg, dev, rng, SERVE_SLOTS, 1024)
        out["prefill_profile"] = {"replayed": _prefill_profile(eng),
                                  "eager": _prefill_profile(eager)}
    out["peak_memory"] = torch.cuda.max_memory_allocated(dev)
    del params, eng, eager
    torch.cuda.empty_cache()
    return out


def _prefill_profile(eng, calls: int = 2) -> dict:
    """Device time and kernels of a call of the continuous scheduler's
    prefill bucket ``(1, plen, max_len)`` as ``eng`` left it (replayed where
    it captured), over ``calls`` calls of its last request's tokens."""
    import torch

    key = next(k for k in eng._prefills if k[0] == 1)
    bucket = eng._prefills[key]
    with torch.inference_mode():
        toks = bucket.tokens.clone()
        for _ in range(3):  # the profiler now and then reads no device time
            prof = _per_step(_device_profile(lambda n: [bucket(toks) for _ in range(n)], calls,
                                             warmup=1, cpu=False), calls)
            if prof["device_busy_s"] > 0:
                break
    prof["bucket"] = list(key)
    prof["kernels"] = prof["kernels"][:5]
    return prof


def _prefill_graph_bytes(eng) -> dict:
    """The device memory of ``eng``'s prefill pool (each captured bucket's
    static caches and logits, and its capture's temporaries): the reserved
    and allocated bytes of the allocator's segments in that pool."""
    import torch

    pool = tuple(eng._prefill_pool)
    segs = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool]
    return {"reserved": sum(seg["total_size"] for seg in segs),
            "allocated": sum(seg["allocated_size"] for seg in segs)}


def _long_request(dev, params, cfg, prompt, per_call, new: int,
                  scheduler: str = "generate") -> dict:
    """One batch-1 request of ``prompt`` through ``ServeEngine.<scheduler>``
    (``new`` greedy tokens), decode replayed, then again op by op
    (uncounted): the same tokens; with the shapes K3 and K4 were called at
    in the replayed run (``kernel_shapes``)."""
    from repro_torch.serve import ServeConfig, ServeEngine

    one = ServeConfig(batch_slots=1)
    with attention_shapes() as shapes:
        run = _serve_timed(ServeEngine(cfg, params, one, device=dev), scheduler, [prompt], cfg,
                           per_call, new)
    with uncounted():
        eager = _serve_timed(ServeEngine(cfg, params, one, device=dev, graph=False), scheduler,
                             [prompt], cfg, per_call, new)
    check(eager.pop("tokens_out") == run["tokens_out"],
          f"{scheduler}, {len(prompt)} tokens: replayed greedy tokens differ from eager")
    for r in (run, eager):
        r.pop("first_decode_logits")
    return {**run, "prompt_tokens": len(prompt), "kernel_shapes": shapes,
            "replayed_tokens_equal_eager": True, "eager": eager}


def _decode_profile(params, cfg, dev, rng, slots: int, plen: int) -> dict:
    """Launches and busy share of decode steps, eager and replayed, and
    their logits: ``slots`` rows prefilled with ``plen`` random tokens, then
    teacher-forced steps, each mode on its own copy of the caches (the
    profile's steps 3-10; the capture is the second step); the replayed
    logits within two bf16 steps of the eager ones."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import engine as serve_engine

    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (slots, plen + 16))
                            .astype(np.int32)).to(dev)
    modes = {}
    with torch.inference_mode():
        _, cache0 = lm.prefill(params, {"tokens": toks[:, :plen]}, cfg, max_len=plen + 16)
        for graph in (False, True):
            cache = _clone(cache0)
            decode = serve_engine._Decode(ServeEngine(cfg, params, device=dev, graph=graph),
                                          cache, slots, plen)
            seen = []

            def steps(n, decode=decode, seen=seen):
                for _ in range(n):
                    seen.append(decode(toks[:, plen + len(seen)]).clone())

            modes[graph] = (_per_step(_device_profile(steps, 8), 8), torch.stack(seen))
            del cache, decode
        del cache0
    (eager_prof, want), (prof, got) = modes[False], modes[True]
    err, over = _bf16_close(got, want, cfg.vocab_size)
    check(over <= 0, f"replayed vs eager decode logits: {err} exceeds two bf16 steps")
    return {"slots": slots, "prompt_tokens": plen, "replayed": prof, "eager": eager_prof,
            "logits_bit_equal": bool(torch.equal(got, want)), "max_abs_logit_diff": err,
            "bound": "rtol 2^-6 + atol 2^-6 rms",
            "profiler_sees_graph_kernels":
                prof["kernels_per_step"] >= 0.9 * eager_prof["kernels_per_step"]}


LEAF_VALUES = 1 << 21  # values of one weight leaf drawn again on the CPU


def _leaf_vs_cpu(params, cfg, seed: int) -> dict:
    """One leaf of ``init_params(cfg, seed)`` as the card drew it (one
    ``threefry`` launch) against the same values drawn on the CPU by the
    plain version: the last bfloat16 ``normal`` leaf in the reference's
    leaf order, its first ``LEAF_VALUES`` values, which the CPU draws alone
    under the leaf's key (row ``i`` of ``split(PRNGKey(seed), n_leaves)``,
    ``i`` its place in that order), since each value hashes its own flat
    index.  Within one bfloat16 ulp."""
    import torch

    from repro_torch import random
    from repro_torch.models import lm

    defs = list(_paths(lm.param_defs(cfg)))
    i, (path, pd) = [(j, d) for j, d in enumerate(defs)
                     if d[1].init == "normal" and d[1].dtype == torch.bfloat16][-1]
    key = random.split(random.PRNGKey(seed), len(defs))[i]
    t0 = time.perf_counter()
    scale = torch.tensor(pd.scale, dtype=torch.float32).to(pd.dtype)
    want = random.normal(key, (LEAF_VALUES,), pd.dtype) * scale
    cpu_s = time.perf_counter() - t0
    leaf = params
    for k in path:
        leaf = leaf[k]
    got = leaf.reshape(-1)[:LEAF_VALUES].cpu()
    ulps = _ulps(got, want, pd.dtype)
    check(ulps <= 1, f"{'/'.join(path)}: card and CPU draws {ulps} bfloat16 ulp apart")
    return {"leaf": "/".join(path), "shape": list(pd.shape), "leaf_index": i,
            "n_leaves": len(defs), "values": LEAF_VALUES, "max_ulp": ulps,
            "bit_equal_share": float((got == want).double().mean()), "cpu_draw_s": cpu_s}


def _paths(tree: dict, prefix: tuple = ()):
    """``(path, leaf)`` of a parameter tree in sorted-key order, the
    reference's ``jax.tree.flatten`` order."""
    for k in sorted(tree):
        v = tree[k]
        yield from _paths(v, (*prefix, k)) if isinstance(v, dict) else [((*prefix, k), v)]


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else [v]


def _clone(tree):
    """A copy of a nested cache (lists and dicts of tensors)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@contextlib.contextmanager
def attention_shapes():
    """The shapes K3 (q) and K4 (the K cache view) are called at inside, as
    ``kernels.ops`` calls them: ``{"flash_attention": {shape: calls},
    "decode_attention": {...}}`` (a replayed decode step calls the wrapper
    once, at its capture)."""
    from repro_torch.kernels import attention as k

    seen: dict = {"flash_attention": {}, "decode_attention": {}}
    real = k.flash_attention, k.decode_attention

    def count(name, shape):
        key = "x".join(map(str, shape))
        seen[name][key] = seen[name].get(key, 0) + 1

    def flash(q, *args, **kw):
        count("flash_attention", q.shape)
        return real[0](q, *args, **kw)

    def decode(q, kk, *args, **kw):
        count("decode_attention", kk.shape)
        return real[1](q, kk, *args, **kw)

    k.flash_attention, k.decode_attention = flash, decode
    try:
        yield seen
    finally:
        k.flash_attention, k.decode_attention = real


LONG_CONTEXT = 32_000  # phi4's batch-1 prompt: the engine's bucket of 32,768 tokens
LONG_NEW = 16  # greedy tokens: a cache of 32,768 + 2 · 16 slots
LONG_CUT = 8  # phi4 layers of the float32 prefill(S) + decode check at S = 32,767


def phase_long_context(dev) -> dict:
    """phi4-mini-3.8b at full width and depth, batch 1, a prompt of 32,000
    tokens through ``ServeEngine.generate_continuous`` (bucket 32,768, a
    cache of 32,800 slots, 4.3 GB of K/V) by phase 5's ``_long_request``:
    K3 at S = 32,768 in every layer of the prefill and K4 over the whole
    cache in every decode step (their call shapes checked), 16 greedy tokens
    replayed and again op by op (equal); the device ms of one prefill and
    phase 5's decode profile at that length (``torch.profiler``,
    uncounted), peak memory; then prefill(S) + decode against prefill(S +
    1) at S = 32,767 on phi4 cut to its first LONG_CUT layers at full width
    (for the clock), within 0.05 under float32 compute.  Phase 5's
    requests are not served again: its ``serve`` path serves them."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import lm

    cfg = ARCHS[SERVE_ARCH]
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, LONG_CONTEXT).tolist()
    run = _long_request(dev, params, cfg, prompt, _launches_per_call(cfg), LONG_NEW,
                        "generate_continuous")
    bucket = 1 << (LONG_CONTEXT - 1).bit_length()
    want = {"flash_attention": ["x".join(map(str, (1, cfg.n_heads, bucket, cfg.head_dim)))],
            "decode_attention": ["x".join(map(str, (1, cfg.n_kv_heads, bucket + 2 * LONG_NEW,
                                                    cfg.head_dim)))]}
    shapes = run["kernel_shapes"]
    check({k: sorted(v) for k, v in shapes.items()} == want,
          f"long context: kernel shapes {shapes}, expected {want}")
    out: dict = {"arch": SERVE_ARCH, "new": LONG_NEW, "tokens": run.pop("tokens_out"),
                 "run": run, "peak_memory_replayed": torch.cuda.max_memory_allocated(dev)}
    with uncounted():
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, bucket))
                                .astype(np.int32)).to(dev)

        def prefill(n):
            for _ in range(n):
                lm.prefill(params, {"tokens": toks}, cfg, max_len=bucket + 16)

        with torch.inference_mode():
            out["prefill_profile"] = _device_profile(prefill, 1, warmup=0)
        out["decode_profile"] = _decode_profile(params, cfg, dev, rng, 1, bucket)
    out["peak_memory"] = torch.cuda.max_memory_allocated(dev)
    del params
    torch.cuda.empty_cache()
    with uncounted():
        cut = _depth_cut(SERVE_ARCH, LONG_CUT)
        params = lm.init_params(cut, 0, device=dev)
        toks = torch.from_numpy(rng.integers(0, cut.vocab_size, (1, bucket)).astype(np.int32))
        out["prefill_decode_consistency"] = {
            "n_layers": LONG_CUT, **_prefill_decode_consistency(
                params, cut, {"tokens": toks.to(dev)}, dev)}
    del params
    torch.cuda.empty_cache()
    return out


def phase_serve_launcher() -> dict:
    """(c) ``python -m repro_torch.launch.serve --arch phi4-mini-3.8b`` on
    the card at its defaults."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", SERVE_ARCH],
                         capture_output=True, text=True, env=env, cwd=root, timeout=300)
    check(res.returncode == 0, f"serve launcher failed:\n{res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    check(len(lines) == 2 and all(" -> [" in ln for ln in lines), f"launcher printed {lines}")
    return {"wall_s": time.perf_counter() - t0, "lines": lines}


# -- phase frontends ---------------------------------------------------------

# arch -> (batch rows, text steps): llava's 576 patch embeddings come before
# its 448 text tokens (1,024 positions), musicgen's steps are 4 codebooks each
FRONT_ENDS = {"llava-next-mistral-7b": (2, 448), "musicgen-large": (2, 512)}
FRONT_NEW = 16  # greedy decode steps after the prefill


def _front_end(dev, arch: str) -> dict:
    """``arch`` at full width and depth (bf16, random weights from a seed)
    through ``lm.prefill`` and ``lm.decode_step`` (the engine serves text
    archs only, as the reference's): a prefill of ``FRONT_ENDS[arch]``
    (llava: 576 random patch embeddings, the data pipeline's standard
    normal, then the text), then ``FRONT_NEW`` greedy decode steps (musicgen:
    tokens [B, 1, 4], logits [B, 4, Vp]) at positions after the prefix; one
    K3 launch a layer in the prefill and one K4 launch a layer a step,
    nothing else; finite logits of the front end's shape.  (a) the reduced
    config card against CPU and the prefill + decode consistency under
    float32 compute run outside the launch counts."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm

    cfg = ARCHS[arch]
    b, s = FRONT_ENDS[arch]
    out: dict = {"arch": arch, "batch": b, "text_steps": s}
    with uncounted():
        out["card_vs_cpu_reduced"] = _card_vs_cpu(dev, arch, None)
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(cfg, 0, device=dev)
    out["param_bytes"] = sum(int(t.numel() * t.element_size()) for t in _leaves(params))
    host, nv = _front_end_batch(cfg, b, s + 1, 0)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in host.items()}
    toks = batch.pop("tokens")
    out["positions"] = nv + s
    v, vp = cfg.vocab_size, lm.padded_vocab(cfg)
    head = (b, cfg.n_codebooks, vp) if cfg.modality == "audio" else (b, vp)
    before = dict(LAUNCHES)
    ms, made = [], []
    with torch.inference_mode():
        for i in range(FRONT_NEW + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                logits, cache = lm.prefill(params, {**batch, "tokens": toks[:, :s]}, cfg,
                                           max_len=nv + s + FRONT_NEW)
            else:
                logits, cache = lm.decode_step(params, cache, {"tokens": tok[:, None]},
                                               nv + s + i - 1, cfg)
            tok = logits[..., :v].argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            check(tuple(logits.shape) == head, f"{arch}: logits {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits[..., :v]).all()), f"{arch}: non-finite logits")
            check(bool((logits[..., v:] == -1e30).all()), f"{arch}: padded vocabulary unmasked")
            made.append(tok.cpu().tolist())
        del cache
    got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    want = {k: 0 for k in LAUNCHES}
    want.update(flash_attention=cfg.n_layers, decode_attention=FRONT_NEW * cfg.n_layers)
    check(got == want, f"{arch}: launched {got}, expected {want}")
    out.update(launches=got, prefill_ms=ms[0], decode_ms=ms[1:],
               decode_ms_median=float(np.median(ms[1:])), tokens=made[1:],
               peak_memory=torch.cuda.max_memory_allocated(dev))
    with uncounted():
        out["prefill_decode_consistency"] = _prefill_decode_consistency(
            params, cfg, {**batch, "tokens": toks}, dev, nv)
    del params, batch, toks
    torch.cuda.empty_cache()
    return out


def phase_frontends(dev) -> dict:
    """The vlm and audio front ends at full width, one model after the
    other (each freed before the next)."""
    return {arch.split("-")[0]: _front_end(dev, arch) for arch in FRONT_ENDS}


# -- phase train -----------------------------------------------------------

BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES, TRAIN_STEPS = 4, 1024, 2, 3
# layers trained of each model's depth, at full width: phi4 8 of 32 (full
# depth's AdamW state does not fit 80 GB), mamba2 24 of 48; both cut to keep
# the script's clock (its checkpoint and CPU losses are host work)
TRAIN_LAYERS = {"phi4-mini-3.8b": 8, "mamba2-1.3b": 24}
TRAIN_LOSS_RTOL = 2e-2  # the card's bf16 step-1 loss against the CPU's float32
# examples/train_lm.py's 100m preset and its optimizer, 30 steps, then served
TRAIN_SERVE_PRESET = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                          d_ff=3072, vocab_size=32768, seq=256, batch=8)
TRAIN_SERVE_STEPS = 30
TRAIN_SERVE_PROMPTS = [[1, 2, 3], [10, 20]]


def _refuses_grad(dev) -> dict:
    """The hand-written kernels refuse an input that requires grad (their
    results would be cut from the autograd graph): each dispatch raises,
    naming the training route, and launches nothing."""
    import torch

    from repro_torch.kernels import LAUNCHES, ops

    q = torch.randn((1, 2, 64, 64), device=dev, dtype=torch.bfloat16).requires_grad_()
    kv = torch.randn((1, 1, 64, 64), device=dev, dtype=torch.bfloat16)
    x, b = torch.randn((1, 64, 2, 16), device=dev), torch.randn((1, 64, 1, 8), device=dev)
    a = torch.full((1, 64, 2), 0.9, device=dev)
    ra = torch.full((1, 64, 32), 0.9, device=dev)
    calls = {"flash_attention": lambda: ops.attention(q, kv, kv),
             "decode_attention": lambda: ops.decode_attention(q[:, :, 0], kv, kv),
             "ssd_scan": lambda: ops.ssd(x, a, b, b.clone().requires_grad_(), chunk=64),
             "rglru_scan": lambda: ops.rglru(ra, ra.clone().requires_grad_())}
    before = dict(LAUNCHES)
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as err:
            check("training route" in str(err), f"{name}: {err}")
        else:
            raise AssertionError(f"{name}: a grad-requiring input reached the kernel")
    check(dict(LAUNCHES) == before, "a refused call launched a kernel")
    return {"refused": sorted(calls)}


def _tree_cpu(tree):
    return {k: _tree_cpu(v) if isinstance(v, dict) else v.detach().cpu() for k, v in tree.items()}


def _train_sizes(cfg) -> dict:
    """Parameter counts from the parameter tree and what AdamW training
    holds per parameter: bf16 (or f32) params, the f32 m, v and master
    (12 B), the f32 microbatch sum (4 B) and one microbatch's grads (the
    param's dtype)."""
    from repro_torch.models import lm

    tree = lm.abstract_params(cfg)
    n = sum(t.numel() for t in _leaves(tree))
    pbytes = sum(t.numel() * t.element_size() for t in _leaves(tree))
    embed = tree["embed"]["tok"].numel()
    return {"params": n, "embed_params": embed, "param_bytes": pbytes,
            "state_bytes": 2 * pbytes + 16 * n,
            "layer_params": (n - embed - (0 if cfg.tie_embeddings else embed) - cfg.d_model)
            / cfg.n_layers}


class _GradCheck:
    """Per step, the gradient leaves that are all zero or non-finite: the
    check runs inside the step (so inside its CUDA graph) and writes its
    count to a device tensor made at the step's first, eager call;
    ``read()`` after each step appends that step's count."""

    def __init__(self):
        self.slot, self.counts = None, []

    def read(self) -> None:
        self.counts.append(int(self.slot))

    def __len__(self) -> int:
        return len(self.counts)

    def __iter__(self):
        return iter(self.counts)

    def __repr__(self) -> str:
        return repr(self.counts)


@contextlib.contextmanager
def _checked_grads():
    """Checks, in every call of ``adamw_update`` from the train step, the
    gradient leaves (a None leaf fails at once, at the eager call or the
    capture); yields a :class:`_GradCheck`, read after each step."""
    import torch

    from repro_torch.train import train_step as train_step_mod
    from repro_torch.train.optimizer import tree_leaves

    real, rec = train_step_mod.adamw_update, _GradCheck()

    def checked(params, grads, opt_state, cfg_):
        leaves = tree_leaves(grads)
        check(all(g is not None for g in leaves), "a gradient leaf is None")
        amax = torch.stack([g.detach().abs().amax().float() for g in leaves])
        bad = ((amax == 0) | ~torch.isfinite(amax)).sum()
        if rec.slot is None:  # the first call is eager: no capture holds this tensor's memory
            rec.slot = torch.zeros_like(bad)
        rec.slot.copy_(bad)
        return real(params, grads, opt_state, cfg_)

    train_step_mod.adamw_update = checked
    try:
        yield rec
    finally:
        train_step_mod.adamw_update = real


def _cpu_job(cfg, seed: int = 0, *, dev, data) -> tuple:
    """What the CPU's loss needs: ``init_params(cfg, seed)`` drawn on the
    card (the params step 1 starts from), copied to the host, and batch 0."""
    from repro_torch.models import lm

    return cfg, _tree_cpu(lm.init_params(cfg, seed, device=dev)), data(0)


def _train_supervised(dev, cfg, data, ts, steps: int, ckpt_every: int, cpu_jobs: dict):
    """The compiled train step (``compile_train_step``: step 1 eager, step 2
    captured and replayed, then replayed) under the ``Supervisor`` for
    ``steps`` steps from ``init_params(cfg, 0)`` on the card, batches from
    ``data`` (a ``SyntheticLM``), every step's gradients checked.
    ``cpu_jobs`` (name → ``_cpu_job``) are computed in a thread started
    after the last step, while the Supervisor waits for its checkpoint
    write.  Returns (the supervisor, its history, a record: each job's CPU
    loss and seconds, the checkpoints, the wait, the capture seconds)."""
    import shutil
    import tempfile
    import threading

    import torch

    from repro_torch.models import lm
    from repro_torch.train import Supervisor, SupervisorConfig, init_opt_state
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.train_step import compile_train_step

    params = lm.init_params(cfg, 0, device=dev)
    record: dict = {"cpu": {}}
    threads: list = []
    step = compile_train_step(cfg, ts, device=dev)

    def cpu_losses():
        for name, job in cpu_jobs.items():
            t0 = time.perf_counter()
            record["cpu"][name] = (_cpu_loss(*job), time.perf_counter() - t0)

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    with _checked_grads() as bad, captures() as caps:

        def counted_step(params, opt_state, batch):
            out = step(params, opt_state, batch)
            bad.read()
            if len(bad) == steps:  # the last step: the card is done with the run
                torch.cuda.synchronize()
                record["t_last_step"] = time.perf_counter()
                threads.append(threading.Thread(target=cpu_losses))
                threads[0].start()
            return out

        try:
            sup = Supervisor(counted_step, params, init_opt_state(params),
                             lambda s: {k: torch.from_numpy(v).to(dev) for k, v in data(s).items()},
                             SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every))
            del params
            hist = sup.run(steps)
            record["checkpoint_wait_s"] = time.perf_counter() - record.pop("t_last_step")
            for th in threads:
                th.join()
            kept = sorted(ck._steps(ckpt_dir))
            check(bool(kept) and kept[-1] == steps // ckpt_every * ckpt_every,
                  f"checkpoints written: {kept}")
            record["checkpoints"] = {"steps": kept, "bytes": sum(
                os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(ckpt_dir)
                for f in files), "disk_free_bytes": shutil.disk_usage(ckpt_dir).free}
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(len(bad) == steps and not any(bad),
          f"gradient leaves all zero or non-finite, by step: {bad}")
    check(sorted(record["cpu"]) == sorted(cpu_jobs), "a CPU loss was not computed")
    record["graph"] = _graph_record(step, caps, steps)
    return sup, hist, record, step


def _graph_record(step, caps: list, steps: int) -> dict:
    """How a run of the compiled step replayed: one capture (on the card,
    at step 2 of ``steps`` >= 2), its seconds."""
    check(step.graph and len(step.runs) == 1 and len(caps) == (steps >= 2),
          f"the train step was captured {len(caps)} times over {len(step.runs)} batch shapes")
    return {"replayed": True, "capture_s": caps[0] if caps else None,
            "eager_steps": 1, "replayed_steps": steps - 1}


def _train_loop(dev, cfg, data, ts, steps: int, params=None):
    """The compiled train step in a plain loop for ``steps`` steps from
    ``params`` (default ``init_params(cfg, 0)`` on the card), each step
    timed as the Supervisor times one (the batch to the card, the step, its
    loss read back), every step's gradients checked.  Returns (the step,
    params, opt_state, history, the graph's record)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.train import StepResult, init_opt_state
    from repro_torch.train.train_step import compile_train_step

    if params is None:
        params = lm.init_params(cfg, 0, device=dev)
    opt_state, step, hist = init_opt_state(params), compile_train_step(cfg, ts, device=dev), []
    with _checked_grads() as bad, captures() as caps:
        for s in range(steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data(s).items()}
            loss, params, opt_state, _ = step(params, opt_state, batch)
            hist.append(StepResult(s + 1, float(loss), time.perf_counter() - t0))
            bad.read()
    check(len(bad) == steps and not any(bad),
          f"gradient leaves all zero or non-finite, by step: {bad}")
    return step, params, opt_state, hist, _graph_record(step, caps, steps)


def _cpu_loss(cfg, host_params, batch) -> float:
    """The loss of the same params and batch on the CPU, float32 compute."""
    import torch

    from repro_torch.models import lm

    with compute_dtype(torch.float32), torch.no_grad():
        return float(lm.loss_fn(host_params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                cfg))


EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def _model_flops(cfg, batch: int, seq: int) -> dict:
    """Model FLOPs of one train step of ``batch`` × ``seq`` positions
    (forward 1, backward 2): 6 a weight a position for every weight that
    multiplies each position, and 12 · head_dim a head for each (query,
    key) pair an attention layer keeps, causal and windowed
    (``_valid_pairs``).  The lookups (``embed/tok`` unless tied,
    ``embed/codebooks``) multiply nothing; ``embed/vision_proj``
    multiplies the ``vision_tokens`` rows alone; the experts count at
    ``top_k / n_experts`` of their weights, since a token runs ``top_k``
    of them (the router runs whole).  The recurrences' scans and the
    norms' arithmetic are not counted."""
    from repro_torch.models import lm

    count = {"/".join(p): t.numel() for p, t in _paths(lm.abstract_params(cfg))}
    lookup = count["embed/tok"] * (not cfg.tie_embeddings) + count.get("embed/codebooks", 0)
    vision = count.get("embed/vision_proj", 0)
    experts = sum(n for p, n in count.items() if p.rsplit("/", 1)[-1] in EXPERT_LEAVES)
    active = experts * cfg.top_k // cfg.n_experts if cfg.n_experts else 0
    dense = sum(count.values()) - lookup - vision - experts
    windows = {"full": None, "swa": cfg.window, "local": cfg.local_window}
    pairs = sum(_valid_pairs(seq, seq, True, windows[m]) for m in cfg.layer_pattern
                if m in windows)
    weights = 6 * (batch * seq * (dense + active) + batch * cfg.vision_tokens * vision)
    attention = 12 * batch * pairs * cfg.n_heads * cfg.head_dim
    return {"weights": weights, "attention": attention, "total": weights + attention,
            "active_weights": dense + active, "attention_pairs": pairs}


def _train_record(hist, cfg, batch: int, seq: int, falls: bool = True) -> dict:
    """Losses (finite; with ``falls`` the last below the first), wall ms a
    step, tokens/s (positions: a vlm's vision rows count) and the
    model-FLOP share of the bf16 dense peak (``_model_flops``), the last two
    at the replayed steps' mean (step 1 runs eagerly, step 2 captures)."""
    import numpy as np

    losses = [h.loss for h in hist]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(not falls or losses[-1] < losses[0], f"loss did not fall: {losses}")
    ms = [h.wall_time * 1e3 for h in hist]
    steady = float(np.mean(ms[2:])) if len(ms) > 2 else ms[-1]
    tokens = batch * seq
    flops = _model_flops(cfg, batch, seq)
    return {"losses": losses, "ms_per_step": ms, "eager_ms_step1": ms[0],
            "steady_ms_per_step": steady,
            "tokens_per_step": tokens, "tokens_per_s": tokens / (steady / 1e3),
            "model_flops_per_step": flops["total"], "model_flops": flops,
            "bf16_peak_flops": BF16_PEAK,
            "model_flop_share": flops["total"] / (steady / 1e3) / BF16_PEAK,
            "restarts": sum(h.restarted for h in hist)}


def _loss_vs_cpu(card: float, cpu: tuple) -> dict:
    """Step 1's loss on the card (bf16 compute) against the CPU's (float32
    compute) on the same params and batch, within ``TRAIN_LOSS_RTOL``."""
    loss, seconds = cpu
    rel = abs(card - loss) / abs(loss)
    check(rel <= TRAIN_LOSS_RTOL, f"step-1 loss {card} vs the CPU's {loss}")
    return {"step1_loss_vs_cpu_float32": {"cpu": loss, "rel_diff": rel, "bound": TRAIN_LOSS_RTOL,
                                          "cpu_s": seconds}}


def _profiled_step(dev, step, data, params, opt_state) -> dict:
    """Where a replayed step's time goes: a fourth call of the run's
    compiled ``step`` (off the run's record, on batch ``TRAIN_STEPS``: one
    graph replay) under the profiler; its CUDA kernels are the graph's, and
    the five longest."""
    import torch

    batch = {k: torch.from_numpy(v).to(dev) for k, v in data(TRAIN_STEPS).items()}
    state = [params, opt_state]
    replays = [r for _, r in step.runs.values()]

    def one(n):
        for _ in range(n):
            _, state[0], state[1], _ = step(state[0], state[1], batch)

    t0 = time.perf_counter()
    calls = [r.calls for r in replays]
    prof = _per_step(_device_profile(one, 1, warmup=0, cpu=False), 1)
    check(len(step.runs) == 1 and [r.calls for r in replays] == [c + 1 for c in calls],
          "the profiled step was not a replay of the run's graph")
    prof["profiler_s"] = time.perf_counter() - t0
    prof["kernels"] = prof["kernels"][:5]
    prof["replayed"] = True
    return prof


def _train_cfg(arch: str):
    """``arch`` at full width, cut to its ``TRAIN_LAYERS`` first layers."""
    return _depth_cut(arch, TRAIN_LAYERS[arch])


def _train_part(dev, arch: str, shared: dict) -> dict:
    """(a) phi4-mini-3.8b at full width, 8 of 32 layers, under the
    Supervisor with one checkpoint (step 0's), or (b) mamba2-1.3b at full
    width, 24 of 48 layers, in a plain loop of the same step: batch 4 ×
    1,024 tokens in 2 microbatches, 3 steps.  The CPU's float32 losses of
    both, and the small-batch ones of ``TRAIN_FULL``'s paths, run in (a)'s
    checkpoint wait (``shared["cpu"]`` carries them on)."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import AdamWConfig, TrainStepConfig

    full, cfg = ARCHS[arch], _train_cfg(arch)
    out: dict = {"arch": arch, "grad_refusal": _refuses_grad(dev)}
    whole, cut = _train_sizes(full), _train_sizes(cfg)
    out["depth_cut"] = {
        "layers": f"{cfg.n_layers} of {full.n_layers}", "full_depth": whole, "cut": cut,
        "why": f"the script's clock (host: checkpoint, CPU loss); full depth: "
               f"{whole['state_bytes'] / 1e9:.1f} GB of params, AdamW state and gradient sums "
               f"before activations, of 80 GB; {cfg.n_layers} layers: "
               f"{cut['state_bytes'] / 1e9:.1f} GB"}
    sizes = _train_sizes(cfg)
    out.update(n_layers=cfg.n_layers, sizes=sizes, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               microbatches=TRAIN_MICROBATCHES)
    ts = TrainStepConfig(n_microbatches=TRAIN_MICROBATCHES,
                         adamw=AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS))

    def data_of(c):
        return SyntheticLM(c, DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))

    data = data_of(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if arch == "phi4-mini-3.8b":
        mamba2 = _train_cfg("mamba2-1.3b")
        jobs = {arch: _cpu_job(cfg, dev=dev, data=data),
                mamba2.name: _cpu_job(mamba2, dev=dev, data=data_of(mamba2)),
                **{args[0]: _small_job(dev, *args) for args in TRAIN_FULL.values()}}
        torch.cuda.empty_cache()
        sup, hist, rec, step = _train_supervised(dev, cfg, data, ts, TRAIN_STEPS,
                                                 ckpt_every=TRAIN_STEPS + 1, cpu_jobs=jobs)
        params, opt_state = sup.params, sup.opt_state
        del sup
        shared["cpu"] = rec.pop("cpu")
        out.update(rec)
    else:
        step, params, opt_state, hist, out["graph"] = _train_loop(dev, cfg, data, ts,
                                                                  TRAIN_STEPS)
    out["train_s"] = time.perf_counter() - t0
    out["peak_memory"] = torch.cuda.max_memory_allocated(dev)
    out.update(_train_record(hist, cfg, TRAIN_BATCH, TRAIN_SEQ))
    out.update(_loss_vs_cpu(out["losses"][0], shared["cpu"].pop(arch)))
    out["step_profile"] = _profiled_step(dev, step, data, params, opt_state)
    del step, params, opt_state, hist
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["replay_vs_eager"] = _replay_vs_eager(dev, _depth_cut(arch, REPLAY_FULL[0]),
                                              *REPLAY_FULL[1:])
    out["replay_vs_eager"]["s"] = time.perf_counter() - t0
    return out


def _serve_prompt(cfg):
    """A 2 × 64 prompt of uniform tokens (numpy, seeded)."""
    import numpy as np

    return np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)


def _train_then_serve(dev) -> dict:
    """(c) ``examples/train_lm.py``'s 100m preset trained 30 steps, then
    served greedy from the trained params on the card (K3 and K4, counted),
    its tokens held to the same params served on the CPU under float32
    compute, and the prefill logits of a 64-token prompt within the
    card-vs-CPU bound of phase 5 (the card's float32 runs uncounted).  The
    synthetic stream is i.i.d. Zipf, so a trained model's greedy token is
    the most frequent one: the logits are the finer check."""
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    from repro_torch.train import AdamWConfig, TrainStepConfig

    pre = TRAIN_SERVE_PRESET
    cfg = ArchConfig(name="demo-lm", family="dense", n_layers=pre["n_layers"],
                     d_model=pre["d_model"], n_heads=pre["n_heads"],
                     n_kv_heads=pre["n_kv_heads"], head_dim=pre["head_dim"], d_ff=pre["d_ff"],
                     vocab_size=pre["vocab_size"], layer_pattern=("full",) * pre["n_layers"])
    out: dict = {"arch": "train_lm 100m", "grad_refusal": _refuses_grad(dev),
                 "params": cfg.param_count(), "batch": pre["batch"], "seq": pre["seq"]}
    ts = TrainStepConfig(n_microbatches=2, adamw=AdamWConfig(
        peak_lr=6e-4, warmup_steps=20, total_steps=TRAIN_SERVE_STEPS))
    torch.cuda.reset_peak_memory_stats(dev)
    data = SyntheticLM(cfg, DataConfig(seq_len=pre["seq"], global_batch=pre["batch"]))
    sup, hist, rec, step = _train_supervised(
        dev, cfg, data, ts, TRAIN_SERVE_STEPS, ckpt_every=max(TRAIN_SERVE_STEPS // 4, 10),
        cpu_jobs={"100m": _cpu_job(cfg, dev=dev, data=data)})
    run = _train_record(hist, cfg, pre["batch"], pre["seq"], falls=False)
    out.update({k: run[k] for k in ("ms_per_step", "eager_ms_step1", "steady_ms_per_step",
                                     "tokens_per_s", "restarts")},
               losses_first_last=[run["losses"][0], run["losses"][-1]])
    out.update(_loss_vs_cpu(run["losses"][0], rec.pop("cpu")["100m"]), **rec)
    trained = sup.params
    del sup, step
    new = 12
    tokens = ServeEngine(cfg, trained, device=dev).generate(TRAIN_SERVE_PROMPTS, new)
    on_cpu = _tree_cpu(trained)
    prompt = torch.from_numpy(_serve_prompt(cfg)).to(dev)
    with uncounted(), compute_dtype(torch.float32), torch.inference_mode():
        card32 = ServeEngine(cfg, trained, device=dev).generate(TRAIN_SERVE_PROMPTS, new)
        cpu32 = ServeEngine(cfg, on_cpu, device="cpu").generate(TRAIN_SERVE_PROMPTS, new)
        logits = [lm.prefill(p, {"tokens": prompt.to(where)}, cfg)[0].cpu()
                  for p, where in ((trained, dev), (on_cpu, "cpu"))]
    check(card32 == cpu32, f"trained params served: card {card32} != CPU {cpu32} (float32)")
    err = float((logits[0] - logits[1])[:, : cfg.vocab_size].abs().max())
    check(err <= 1e-3, f"trained params, prefill logits card vs CPU (float32): {err}")
    out.update(tokens_bf16=tokens, tokens_float32=card32, bf16_equals_float32=tokens == card32,
               prefill_logits_card_vs_cpu_float32={"max_abs_diff": err, "bound": 1e-3},
               peak_memory=torch.cuda.max_memory_allocated(dev))
    del trained
    torch.cuda.empty_cache()
    return out


# -- phase train: the families that had only served on the card --------------

# phase -> (arch, layers kept of its depth, batch, sequence), at full width,
# cut in depth to fit 80 GB with AdamW's state (20 B a parameter) and to keep
# the script's clock; recurrentgemma at 2 x 4,096 so that its 2,048-token
# local window bites.  2 microbatches, TRAIN_STEPS steps each.
TRAIN_FULL = {
    "train_qwen3_moe": ("qwen3-moe-30b-a3b", 2, 4, 1024),
    "train_mixtral_cut": ("mixtral-8x22b", 1, 4, 1024),
    "train_recurrentgemma": ("recurrentgemma-9b", 3, 2, 4096),
    "train_llava": ("llava-next-mistral-7b", 2, 4, 1024),
    "train_musicgen": ("musicgen-large", 2, 4, 1024),
    "train_qwen2_5_14b": ("qwen2.5-14b", 2, 4, 1024),
}
# AdamW's peak learning rate on these paths (one warmup step; the cosine
# then runs toward AdamW's default min_lr, 3e-5, so step 2 takes 2e-5).
# Their first updates move every weight by about the rate, which at a
# width of 4,096 or more overshoots: at 3e-4 step 2's loss was 1.8-2.1
# times step 1's for mixtral, llava and qwen2.5, and from 2e-5 up some
# path's step-3 loss stayed above step 1's (tools/train_lr_sweep.py); at
# 1e-5 every path's loss falls at every step
TRAIN_FULL_LR = 1e-5
# check (2): row 0 of batch 0 cut to this many tokens (llava: its 576
# vision rows and 64 text tokens): the CPU's float32 loss of the whole batch
# would take minutes at a vocabulary of 256,000
TRAIN_SMALL, TRAIN_SMALL_TEXT = 256, 64
# check (3): the reduced configs' loss and gradients card vs CPU, at a batch
# past the reduced windows of 64; the bounds of tests/test_torch_train.py
TRAIN_GRAD_BATCH, TRAIN_GRAD_SEQ = 2, 128
TRAIN_F32_LOSS, TRAIN_F32_LEAF, TRAIN_F32_ATOL = 1e-5, 1e-4, 1e-6
TRAIN_BF16_LOSS, TRAIN_BF16_COS = 2e-2, 0.99
# the configs that train on the card reduced only: no training path that
# TRAIN_FULL's lack (MHA; GQA group 7)
TRAIN_REDUCED_ONLY = ("deepseek-7b", "yi-34b")
TRAIN_CARD_VS_CPU = (*(arch for arch, *_ in TRAIN_FULL.values()), *TRAIN_REDUCED_ONLY)


@contextlib.contextmanager
def attention_changed(**over):
    """The training route's attention (``layers.blocked_attention``) with
    the keywords ``over`` in place of the model's: ``window=None`` drops
    the window, ``causal=False`` the causal mask."""
    from repro_torch.models import layers

    real = layers.blocked_attention
    layers.blocked_attention = lambda *a, **kw: real(*a, **{**kw, **over})
    try:
        yield
    finally:
        layers.blocked_attention = real


@contextlib.contextmanager
def heads_regrouped():
    """The training route's GQA grouped the wrong way: q head ``h`` reads
    KV head ``h mod Hkv`` in place of ``h // group``."""
    import torch

    from repro_torch.models import layers

    real = layers.blocked_attention

    def regrouped(q, k, v, **kw):
        hq, hkv = q.shape[2], k.shape[2]
        h = torch.arange(hq, device=q.device)
        at = (h % hkv) * (hq // hkv) + h // hkv  # the place that reads KV head h mod Hkv
        return real(q[:, :, torch.argsort(at)], k, v, **kw)[:, :, at]

    layers.blocked_attention = regrouped
    try:
        yield
    finally:
        layers.blocked_attention = real


# check (3)'s planted fault of each config, which the float32 bound must
# catch: (what, a context the faulty gradients are taken in, or the path of
# the gradient zeroed after)
TRAIN_FAULTS = {
    "qwen3-moe-30b-a3b": ("the router's gradient zeroed", None, ("seg0", "mlp0", "router")),
    "mixtral-8x22b": ("the router's gradient zeroed", None, ("seg0", "mlp0", "router")),
    "recurrentgemma-9b": ("the local layer's window dropped",
                          lambda: attention_changed(window=None), None),
    "llava-next-mistral-7b": ("vision_proj's gradient zeroed", None, ("embed", "vision_proj")),
    "musicgen-large": ("the first extra codebook's embedding gradient zeroed", None,
                       ("embed", "codebooks", 0)),
    "qwen2.5-14b": ("the q bias's gradient zeroed", None, ("seg0", "m0", "bq")),
    "deepseek-7b": ("the causal mask dropped", lambda: attention_changed(causal=False), None),
    "yi-34b": ("the KV heads regrouped (h mod Hkv)", heads_regrouped, None),
}


def _reduced_heads(arch: str) -> tuple:
    """(n_kv_heads, n_heads) of ``arch``'s reduced config in the card-vs-CPU
    checks, as ``SERVE_PATHS`` gives them (None: ``reduced()``'s own)."""
    p = SERVE_PATHS.get(arch, _TEXT)
    return p["kv"], p["heads"]


def _zero_grad(grads: dict, path: tuple) -> None:
    node = grads
    for key in path:
        node = node[key]
    node.zero_()


def _train_card_vs_cpu(dev, arch: str, kv=None, heads=None) -> dict:
    """(3) ``arch`` reduced (``kv`` KV heads and ``heads`` q heads where
    given, its zero-initialised leaves made non-zero), one numpy tree on
    both sides: the loss and every gradient leaf of ``SyntheticLM``'s batch
    0 at ``TRAIN_GRAD_BATCH`` × ``TRAIN_GRAD_SEQ`` (one microbatch), the
    card's against the CPU's.  float32 compute and float32 parameters: the
    loss within 1e-5 relative, each leaf within 1e-4 · max|g_cpu| + 1e-6;
    bf16 compute: the loss within 2e-2 relative, each leaf's cosine with
    the CPU's at least 0.99.  The planted fault of ``TRAIN_FAULTS``, taken
    on the card under float32, must exceed the float32 bound."""
    import torch

    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.train import make_grad_fn
    from repro_torch.train.optimizer import tree_map

    cfg = _reduced(arch, kv, heads)
    # the card's draw (the serving paths hold it to the CPU's), to the host
    tree = _to_numpy(lm.init_params(cfg, 0, device=dev))
    out = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "batch": [TRAIN_GRAD_BATCH, TRAIN_GRAD_SEQ], "window": cfg.window or cfg.local_window,
           "nonzero_leaves": _nonzero_leaves(tree, cfg, 2)}
    batch = _train_data(cfg, TRAIN_GRAD_BATCH, TRAIN_GRAD_SEQ)(0)
    grad_fn = make_grad_fn(cfg, 1)

    def grads(where, dtype, fault=None):
        params = convert.lm_params(tree, cfg, where)
        if dtype == torch.float32:
            params = tree_map(lambda t: t.float(), params)
        on = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        with compute_dtype(dtype), (fault[1]() if fault and fault[1]
                                    else contextlib.nullcontext()):
            loss, g = grad_fn(params, on)
        if fault and fault[2]:
            _zero_grad(g, fault[2])
        return float(loss), [("/".join(p), x.float().cpu()) for p, x in _paths(g)]

    def f32_excess(got, want) -> dict:
        """Each bound's excess (> 0: outside it), and the worst leaf."""
        (gl, gg), (wl, wg) = got, want
        leaf = []
        for (p, x), (_, w) in zip(gg, wg):
            diff = float((x - w).abs().max())
            bound = TRAIN_F32_LEAF * float(w.abs().max()) + TRAIN_F32_ATOL
            leaf.append((diff - bound, p, diff / bound))
        worst = max(leaf)
        return {"loss_rel_diff": abs(gl - wl) / abs(wl),
                "loss_excess": abs(gl - wl) - TRAIN_F32_LOSS * abs(wl),
                "worst_leaf": worst[1], "leaf_excess": worst[0],
                "leaf_diff_over_bound": max(ratio for _, _, ratio in leaf)}

    f32 = torch.float32
    cpu32 = grads("cpu", f32)
    res = f32_excess(grads(dev, f32), cpu32)
    check(res["loss_excess"] <= 0 and res["leaf_excess"] <= 0,
          f"{arch} reduced, float32 loss and gradients card vs CPU: {res}")
    out["float32"] = {**res, "bound": "loss 1e-5 rel; leaf 1e-4 max|g_cpu| + 1e-6",
                      "loss": cpu32[0]}
    (cl, cg), (wl, wg) = grads(dev, torch.bfloat16), grads("cpu", torch.bfloat16)
    cos = []
    for (p, x), (_, w) in zip(cg, wg):
        x, w = x.double().reshape(-1), w.double().reshape(-1)
        cos.append((float(x @ w / max(float(x.norm() * w.norm()), 1e-300)), p))
    rel = abs(cl - wl) / abs(wl)
    check(rel <= TRAIN_BF16_LOSS and min(cos)[0] >= TRAIN_BF16_COS,
          f"{arch} reduced, bf16 loss {rel} / least gradient cosine {min(cos)}")
    out["bfloat16"] = {"loss_rel_diff": rel, "least_cosine": min(cos)[0],
                       "least_cosine_leaf": min(cos)[1], "bound": "loss 2e-2 rel; cosine 0.99"}
    fault = TRAIN_FAULTS[arch]
    res = f32_excess(grads(dev, f32, fault), cpu32)
    excess = max(res["loss_excess"], res["leaf_excess"])
    check(excess > 0, f"{arch} reduced: planted fault ({fault[0]}) within the float32 bound")
    out["planted_fault"] = {"fault": fault[0], **res, "excess": excess}
    out["leaves"] = len(cpu32[1])
    return out


def _small_batch(cfg, batch: dict) -> dict:
    """Check (2)'s batch: row 0 of ``batch`` cut to ``TRAIN_SMALL`` tokens
    (a vlm's vision rows whole and ``TRAIN_SMALL_TEXT`` text tokens)."""
    n = TRAIN_SMALL_TEXT if cfg.modality == "vlm" else TRAIN_SMALL
    return {k: v[:1] if k == "vision_embed" else v[:1, :n] for k, v in batch.items()}


def _train_data(cfg, batch: int, seq: int):
    """``SyntheticLM`` (seed 0) of ``batch`` × ``seq`` for ``cfg``."""
    from repro_torch.data import DataConfig, SyntheticLM

    return SyntheticLM(cfg, DataConfig(seq_len=seq, global_batch=batch))


def _small_job(dev, arch: str, n_layers: int, batch: int, seq: int) -> tuple:
    """``_cpu_job`` of a ``TRAIN_FULL`` path's check (2): step 1's params
    (drawn on the card) on the host and ``_small_batch`` of batch 0."""
    cfg = _depth_cut(arch, n_layers)
    data = _train_data(cfg, batch, seq)
    return _cpu_job(cfg, dev=dev, data=lambda s: _small_batch(cfg, data(s)))


def _train_full(dev, arch: str, n_layers: int, batch: int, seq: int,
                cpu: dict | None = None) -> dict:
    """One of ``TRAIN_FULL``'s paths: ``arch`` at full width, cut to its
    first ``n_layers`` layers, trained ``TRAIN_STEPS`` steps of ``batch`` ×
    ``seq`` in 2 microbatches from ``init_params(cfg, 0)`` on the card in a
    plain loop, AdamW with one warmup step to ``TRAIN_FULL_LR``.  (1) the run: every gradient
    leaf of every step non-zero and finite, the losses finite and falling,
    ms a step, tokens/s, the model-FLOP share, the peak memory and one
    profiled step; (2) step 1's params on ``_small_batch``: the card's bf16
    loss within ``TRAIN_LOSS_RTOL`` of the CPU's float32 loss, taken from
    ``cpu`` (arch → (loss, seconds): phase ``train``'s (a) computes them in
    its checkpoint wait) or computed here; (3) the reduced config's
    gradients card vs CPU (``_train_card_vs_cpu``)."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, TrainStepConfig

    full, cfg = ARCHS[arch], _depth_cut(arch, n_layers)
    whole, sizes = _train_sizes(full), _train_sizes(cfg)
    out: dict = {
        "arch": arch, "n_layers": n_layers, "sizes": sizes, "batch": batch, "seq": seq,
        "microbatches": TRAIN_MICROBATCHES,
        "depth_cut": {"layers": f"{n_layers} of {full.n_layers}", "full_depth": whole,
                      "why": f"full depth: {whole['state_bytes'] / 1e9:.1f} GB of params, "
                             f"AdamW state and gradient sums before activations, of 80 GB; "
                             f"{n_layers} layers: {sizes['state_bytes'] / 1e9:.1f} GB"}}
    ts = TrainStepConfig(n_microbatches=TRAIN_MICROBATCHES, adamw=AdamWConfig(
        peak_lr=TRAIN_FULL_LR, warmup_steps=1, total_steps=TRAIN_STEPS))
    data = _train_data(cfg, batch, seq)
    small = _small_batch(cfg, data(0))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    out["init_params_s"] = time.perf_counter() - t0
    with torch.no_grad():
        card = float(lm.loss_fn(params, {k: torch.from_numpy(v).to(dev)
                                         for k, v in small.items()}, cfg))
    done = (cpu or {}).pop(arch, None)
    waited = done is not None
    if not waited:
        t0 = time.perf_counter()
        done = (_cpu_loss(cfg, _tree_cpu(params), small), time.perf_counter() - t0)
    small_rec = _loss_vs_cpu(card, done)
    t0 = time.perf_counter()
    step, params, opt_state, hist, out["graph"] = _train_loop(dev, cfg, data, ts, TRAIN_STEPS,
                                                              params)
    out["train_s"] = time.perf_counter() - t0
    out["peak_memory"] = torch.cuda.max_memory_allocated(dev)
    out.update(_train_record(hist, cfg, batch, seq))
    out["small_batch"] = {"shape": {k: list(v.shape) for k, v in small.items()},
                          **small_rec["step1_loss_vs_cpu_float32"], "card_bf16": card,
                          "cpu_in_checkpoint_wait": waited}
    out["step_profile"] = _profiled_step(dev, step, data, params, opt_state)
    del step, params, opt_state, hist
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["grads_card_vs_cpu"] = _train_card_vs_cpu(dev, arch, *_reduced_heads(arch))
    out["grads_card_vs_cpu"]["s"] = time.perf_counter() - t0
    out["replay_vs_eager"] = _replay_vs_eager_reduced(dev, arch)
    return out


def _train_reduced(dev) -> dict:
    """Check (3) and the replayed-against-eager check for the configs that
    train on the card reduced only."""
    return {arch: {**_train_card_vs_cpu(dev, arch, *_reduced_heads(arch)),
                   "replay_vs_eager": _replay_vs_eager_reduced(dev, arch)}
            for arch in TRAIN_REDUCED_ONLY}


# the replayed-against-eager check: REPLAY_STEPS steps from one seed, the
# reduced configs of check (3) at its batch (2 microbatches of 1 row; the
# gradient compressions on two of them, inside the capture) and phi4 and
# mamba2 at full width cut to REPLAY_FULL's layers, batch and sequence
REPLAY_STEPS = 4
REPLAY_FULL = (2, 4, 512)
REPLAY_COMPRESSION = {"deepseek-7b": "int8_ef", "yi-34b": "topk_ef"}


def _replay_vs_eager_reduced(dev, arch: str) -> dict:
    t0 = time.perf_counter()
    out = _replay_vs_eager(dev, _reduced(arch, *_reduced_heads(arch)), TRAIN_GRAD_BATCH,
                           TRAIN_GRAD_SEQ, REPLAY_COMPRESSION.get(arch, "none"))
    out["s"] = time.perf_counter() - t0
    return out


def _replay_vs_eager(dev, cfg, batch: int, seq: int, compression: str = "none") -> dict:
    """``cfg`` trained ``REPLAY_STEPS`` steps from ``init_params(cfg, 0)``
    on the card (bf16, 2 microbatches, AdamW with one warmup step, the
    batches of ``SyntheticLM`` seed 0), twice eagerly (``make_train_step``)
    and once replayed (``compile_train_step(graph=True)``: step 1 eager,
    step 2 captured and replayed, steps 3-4 replayed).  The replayed run's
    losses, learning rates, count and every parameter, ``m``, ``v``,
    ``master`` (and residual) leaf equal the first eager run's bit for bit;
    where the two eager runs already differ (atomics), the replayed run's
    largest difference from the first, per quantity, is at most twice the
    eager runs' own.  The planted fault — the same replayed run with
    ``count`` put back after every step, a replay that does not advance it —
    must fail the same check."""
    import torch

    from repro_torch.models import lm
    from repro_torch.train import AdamWConfig, TrainStepConfig, init_opt_state, make_train_step
    from repro_torch.train.train_step import compile_train_step
    from repro_torch.train.optimizer import tree_leaves, tree_map

    ts = TrainStepConfig(n_microbatches=2, compression=compression,
                         adamw=AdamWConfig(warmup_steps=1, total_steps=REPLAY_STEPS))
    data = _train_data(cfg, batch, seq)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data(s).items()}
               for s in range(REPLAY_STEPS)]
    init = lm.init_params(cfg, 0, device=dev)

    def run(kind: str) -> dict:
        params = tree_map(lambda t: t.clone(), init)
        opt = init_opt_state(params)
        step = (make_train_step(cfg, ts) if kind == "eager"
                else compile_train_step(cfg, ts, device=dev, graph=True))
        losses, lrs = [], []
        for b in batches:
            loss, params, opt, metrics = step(params, opt, b)
            if kind == "frozen":
                opt["count"].sub_(1)
            losses.append(loss.clone())
            lrs.append(metrics["lr"].clone())
        torch.cuda.synchronize()
        return {"loss": [torch.stack(losses)], "lr": [torch.stack(lrs)],
                "count": [opt["count"]], "params": tree_leaves(params),
                **{k: tree_leaves(opt[k]) for k in ("m", "v", "master", "ef") if k in opt}}

    def diff(a: dict, b: dict) -> dict:
        """Per quantity: (bit-equal, the largest |a - b| over its leaves)."""
        out = {}
        for key in a:
            pairs = list(zip(a[key], b[key]))
            eq = [torch.equal(x, y) for x, y in pairs]
            out[key] = (all(eq), max([float((x.float() - y.float()).abs().max())
                                      for (x, y), e in zip(pairs, eq) if not e], default=0.0))
        return out

    first = run("eager")
    spread = diff(first, run("eager"))
    exact = all(eq for eq, _ in spread.values())

    def holds(got: dict) -> tuple[bool, dict]:
        d = diff(first, got)
        if exact:
            return all(eq for eq, _ in d.values()), d
        return all(d[k][1] <= 2 * spread[k][1] for k in d), d

    ok, got = holds(run("replayed"))
    check(ok, f"{cfg.name} ({cfg.n_layers} layers): replayed train steps differ from eager: "
              f"{got} (eager spread {spread})")
    bad, planted = holds(run("frozen"))
    check(not bad, f"{cfg.name}: the planted frozen count passed the replay check: {planted}")
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "batch": [batch, seq], "compression": compression, "steps": REPLAY_STEPS,
            "eager_runs_bit_equal": exact,
            "check": "bit for bit" if exact else "within 2x the eager runs' spread",
            "eager_spread": {k: d for k, (_, d) in spread.items()},
            "replayed_diff": {k: d for k, (_, d) in got.items()},
            "planted_frozen_count": {"fault": "count put back after every replayed step",
                                     "failed_the_check": True,
                                     "diff": {k: d for k, (_, d) in planted.items()}}}


# -- phase sharding -----------------------------------------------------------

SHARD_ARCH = "phi4-mini-3.8b"
SHARD_TRAIN_LAYERS = 4  # (a): phi4 at full width, 4 of its 32 layers
SHARD_PIPE_LAYERS, SHARD_STAGES, SHARD_MICROBATCHES = 8, 4, 4  # (b): 2 layers a stage
SHARD_PIPE_BATCH = 8  # (b): 4 microbatches of 2 x 1,024 tokens


def _depth_cut(arch: str, n: int):
    """``arch`` at full width, cut to its first ``n`` layers."""
    import dataclasses

    from repro_torch.configs import ARCHS

    full = ARCHS[arch]
    return dataclasses.replace(full, n_layers=n, layer_pattern=full.layer_pattern[:n])


def _timed_steps(step, params, opt_state, batches):
    """``step`` over ``batches`` in order, each timed on the host (its loss
    read back): (losses, ms a step, params, opt_state)."""
    losses, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss, params, opt_state, _ = step(params, opt_state, batch)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, params, opt_state


@contextlib.contextmanager
def _one_rank_mesh(dev):
    """A world-size-1 group (NCCL on the card, gloo on the CPU) and its
    ``(1, 1)`` ``("data", "model")`` ``DeviceMesh``."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = tempfile.mkdtemp(prefix="chip_smoke_group_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        yield init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _sharded_train(dev, cfg=None, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH) -> dict:
    """(a) The train step under a ``ShardingPolicy`` on a one-rank
    ``DeviceMesh`` (1, 1) ``("data", "model")`` (NCCL on the card, gloo on
    the CPU) against the unsharded step on the same params and batches:
    by default phi4 at full width, 4 of 32 layers, batch 4 x 1,024 in 2
    microbatches, AdamW, 3 steps each way; on the card also one profiled
    step each way."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import LAUNCHES, ops
    from repro_torch.models import lm
    from repro_torch.sharding import ShardingPolicy, make_policy
    from repro_torch.train import AdamWConfig, TrainStepConfig, init_opt_state, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    cfg = cfg or _depth_cut(SHARD_ARCH, SHARD_TRAIN_LAYERS)
    data = SyntheticLM(cfg, DataConfig(seq_len=seq, global_batch=batch))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data(s).items()}
               for s in range(TRAIN_STEPS + 1)]  # the last one for the profiled step
    ts = TrainStepConfig(n_microbatches=TRAIN_MICROBATCHES,
                         adamw=AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS))
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "params": sum(
        t.numel() for t in _leaves(lm.abstract_params(cfg))), "batch": batch, "seq": seq,
        "microbatches": TRAIN_MICROBATCHES, "steps": TRAIN_STEPS}
    # a world-size-1 NCCL group on the card, as phase comm's (c) sets one up
    with _one_rank_mesh(dev) as mesh:
        runs: dict = {}
        for name, pol in (("unsharded", ShardingPolicy()), ("sharded", make_policy(mesh))):
            params = lm.distribute_params(lm.init_params(cfg, 0, device=dev), cfg, pol)
            opt_state = init_opt_state(params)
            step = make_train_step(cfg, ts, pol)
            losses, ms, params, opt_state = _timed_steps(step, params, opt_state,
                                                         batches[:TRAIN_STEPS])
            final = [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(params)]
            runs[name] = {"losses": losses, "ms_per_step": ms,
                          "steady_ms_per_step": sum(ms[1:]) / len(ms[1:])}
            if name == "sharded":
                check(all(isinstance(t, DTensor) for t in tree_leaves(params))
                      and all(isinstance(t, DTensor) for t in tree_leaves(opt_state["m"])),
                      "sharding: a parameter or moment is not a DTensor")
                check(all(tuple(t.to_local().shape) == tuple(t.shape)
                          for t in tree_leaves(params)),
                      "sharding: a one-rank mesh's local shard is not the whole leaf")
                want = runs["unsharded"].pop("final")
                diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(final, want)]
                runs["params_max_abs_diff"] = max(diffs)
                runs["params_bit_equal"] = all(torch.equal(a, b) for a, b in zip(final, want))
                del want
            else:
                runs[name]["final"] = [t.clone() for t in final]
            del final

            if dev.type == "cuda":
                def one(n, state=[params, opt_state], step=step):
                    for _ in range(n):
                        _, state[0], state[1], _ = step(state[0], state[1], batches[-1])

                prof = _per_step(_device_profile(one, 1, warmup=0, cpu=False), 1)
                runs[name]["step_profile"] = {k: prof[k] for k in (
                    "device_ms_per_step", "kernels_per_step", "device_busy_share", "wall_s")}
                del one
                torch.cuda.empty_cache()
            del params, opt_state, step
        plain, shard = runs["unsharded"]["losses"], runs["sharded"]["losses"]
        check(all(map(math.isfinite, shard)) and shard[-1] < shard[0],
              f"sharding: sharded losses {shard}")
        rel = abs(shard[0] - plain[0]) / abs(plain[0])
        check(rel <= TRAIN_LOSS_RTOL, f"sharding: step-1 loss {shard[0]} vs unsharded {plain[0]}")
        runs["loss_max_abs_diff"] = max(abs(a - b) for a, b in zip(shard, plain))
        runs["losses_bit_equal"] = shard == plain
        runs["step1_loss_rel_diff"] = {"value": rel, "bound": TRAIN_LOSS_RTOL}
        runs["dtensor_dispatch_ms_per_step"] = (runs["sharded"]["steady_ms_per_step"]
                                                - runs["unsharded"]["steady_ms_per_step"])
        # a DTensor sent to K3's wrapper is refused, nothing launched
        q = DTensor.from_local(torch.randn((1, 2, 64, 64), device=dev).to(torch.bfloat16),
                               mesh, [Replicate(), Replicate()])
        before = dict(LAUNCHES)
        try:
            ops.attention(q, q, q)
        except TypeError as err:
            check("DTensor" in str(err), f"sharding: K3's refusal: {err}")
            runs["k3_refuses_dtensor"] = str(err)
        else:
            raise AssertionError("sharding: a DTensor reached K3")
        check(dict(LAUNCHES) == before, "sharding: the refused call launched a kernel")
        out.update(runs)
    return out


def _gpipe_on_card(dev) -> dict:
    """(b) ``gpipe`` through ``LoopbackComm`` on a (4,) mesh: phi4's first 8
    layers at full width, 2 a stage, on the inference route (K3 in every
    stage, counted), 4 microbatches of 2 x 1,024 tokens, against the 8
    layers applied in sequence to the whole batch (uncounted)."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.sharding import bubble_fraction, gpipe
    from repro_torch.snn import LoopbackComm
    from repro_torch.train.optimizer import tree_map

    cfg = _depth_cut(SHARD_ARCH, SHARD_PIPE_LAYERS)
    per_stage = SHARD_PIPE_LAYERS // SHARD_STAGES
    ((unit, r),) = lm.segments(cfg)
    params = lm.init_params(cfg, 0, device=dev)
    stages = tree_map(lambda t: t.reshape(SHARD_STAGES, per_stage, *t.shape[1:]),
                      params["seg0"])
    toks = SyntheticLM(cfg, DataConfig(seq_len=TRAIN_SEQ, global_batch=SHARD_PIPE_BATCH))(0)
    out: dict = {"layers": f"{r} of 32", "stages": SHARD_STAGES, "layers_per_stage": per_stage,
                 "microbatches": SHARD_MICROBATCHES,
                 "microbatch": [SHARD_PIPE_BATCH // SHARD_MICROBATCHES, TRAIN_SEQ],
                 "bubble_fraction": bubble_fraction(SHARD_STAGES, SHARD_MICROBATCHES)}
    check(out["bubble_fraction"] == 3 / 7, "sharding: bubble_fraction(4, 4) != 3/7")

    def layers(lps, h):
        for lp in lm._unbound(lps, len(next(iter(_leaves(lps))))):
            h = lm._unit_apply(h, lp, unit, cfg, False)
        return h

    run = gpipe(layers, LoopbackComm((SHARD_STAGES,), dev), axis="slow",
                n_microbatches=SHARD_MICROBATCHES)
    with torch.inference_mode():
        x = lm.embed_inputs(params, {"tokens": torch.from_numpy(toks["tokens"]).to(dev)}, cfg)
        before = LAUNCHES["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = run(stages, x)
        torch.cuda.synchronize()
        out["gpipe_ms"] = (time.perf_counter() - t0) * 1e3
        out["k3_launches"] = LAUNCHES["flash_attention"] - before
        ticks = SHARD_STAGES + SHARD_MICROBATCHES - 1
        check(out["k3_launches"] == ticks * SHARD_STAGES * per_stage,
              f"sharding: {out['k3_launches']} K3 launches, not one a layer, stage and tick")
        with uncounted():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = layers(params["seg0"], x)
            torch.cuda.synchronize()
            out["sequential_ms"] = (time.perf_counter() - t0) * 1e3
    check(tuple(y.shape) == tuple(x.shape) and bool(torch.isfinite(y).all()),
          "sharding: gpipe output shape or finiteness")
    excess = _bf16_row_excess(y, want)
    check(excess <= 0, f"sharding: gpipe vs sequential, bf16 row excess {excess}")
    out["vs_sequential"] = {"bf16_row_excess": excess, "bound": 0.0,
                            "max_abs_diff": float((y.float() - want.float()).abs().max()),
                            "bit_equal": bool(torch.equal(y, want))}
    del params, stages, x, y, want
    torch.cuda.empty_cache()
    return out


SHARD_SERVE_NEW = 32  # (c): greedy tokens a request
SHARD_LOGITS_TOL = 1e-2  # (c): first decode logits, max |mesh - unsharded| / max |unsharded|


def _sharded_serve(dev, mesh, cfg=None, new: int = SHARD_SERVE_NEW) -> dict:
    """(c) ``ServeEngine(..., pol=make_policy(mesh))`` on the one-rank
    mesh (the params from ``lm.distribute_params``), by default phi4 at full
    width and depth: phase 5's 8 requests and 4 slots, ``new`` greedy tokens
    each, both schedulers, every prefill and decode call launching exactly
    its layers' K3 / K4 (counted) and its tokens equal to the unsharded
    engine's on the same params (uncounted), and each scheduler's first
    decode step's logits within ``SHARD_LOGITS_TOL`` of the largest of the
    unsharded engine's (the continuous one reads the tiled fill).  Decode
    replays a CUDA graph (the engine's default on a one-rank NCCL mesh) of
    the DTensor step."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.sharding import make_policy

    cfg = cfg or ARCHS[SHARD_ARCH]
    per_call = _launches_per_call(cfg)
    params = lm.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)  # phase 5's requests
    lens = rng.integers(64, 1001, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    schedulers = ("generate", "generate_continuous")
    sc = ServeConfig(batch_slots=SERVE_SLOTS)
    with uncounted():
        plain = ServeEngine(cfg, params, sc, device=dev)
        plain_runs = {n: _serve_timed(plain, n, prompts, cfg, per_call, new) for n in schedulers}
    pol = make_policy(mesh)
    eng = ServeEngine(cfg, lm.distribute_params(params, cfg, pol), sc, pol=pol, device=dev)
    runs = {n: _serve_timed(eng, n, prompts, cfg, per_call, new) for n in schedulers}
    first_err = {}
    for n in schedulers:
        check(runs[n]["tokens_out"] == plain_runs[n]["tokens_out"],
              f"sharding: {n}'s greedy tokens under the mesh differ from the unsharded engine's")
        got, want = runs[n]["first_decode_logits"], plain_runs[n]["first_decode_logits"]
        first_err[n] = float((got - want).abs().max() / want.abs().max())
        check(first_err[n] <= SHARD_LOGITS_TOL,
              f"sharding: {n}'s first decode logits under the mesh are {first_err[n]} of the "
              f"largest off the unsharded engine's (limit {SHARD_LOGITS_TOL})")
    keys = ("graph", "captures", "capture_s", "prefill_calls", "prefill_ms", "decode_steps",
            "decode_ms_per_step_median", "decode_ms_per_step_mean", "tokens_per_s")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "requests": len(prompts),
           "slots": SERVE_SLOTS, "new_tokens": new, "tokens_equal_unsharded": list(schedulers),
           "first_decode_logits_err": first_err,
           "sharded": {n: {k: runs[n][k] for k in keys} for n in schedulers},
           "unsharded": {n: {k: plain_runs[n][k] for k in keys} for n in schedulers}}
    del params, eng, plain
    torch.cuda.empty_cache()
    return out


def _dryrun_vs_card(mesh, serve: dict | None) -> dict:
    """(d) ``roofline.count`` of phi4's decode step on the same one-rank
    mesh with phase 5's decode profile's batch and cache (4 slots, 1,040
    slots at position 1,024), priced with ``H100``, beside that profile's
    measured replayed device ms a step."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.roofline import H100, model_flops, roofline
    from repro_torch.roofline.count import count
    from repro_torch.sharding import make_policy

    cfg, pol = ARCHS[SHARD_ARCH], make_policy(mesh)
    t0 = time.perf_counter()
    params = lm.abstract_params(cfg, pol)
    cache = lm.init_cache(cfg, SERVE_SLOTS, 1024 + 16, pol=pol, device="meta")
    batch = {"tokens": torch.empty((SERVE_SLOTS, 1), dtype=torch.int32, device="meta")}
    with torch.no_grad():
        t = count(lm.decode_step, params, cache, batch, 1024, cfg, pol=pol, n_devices=1)
    rep = roofline(t, n_devices=1, hw=H100,
                   model_flops_global=model_flops(cfg.active_param_count(), SERVE_SLOTS,
                                                  "inference"))
    out = {"count_s": time.perf_counter() - t0, "hw": H100.name,
           "flops_per_step": t.flops, "hbm_bytes_per_step": t.hbm_bytes,
           "collectives": t.coll_counts, "predicted_bound_s": rep.bound_s,
           "dominant": rep.dominant, "memory_s": rep.memory_s, "compute_s": rep.compute_s,
           "collective_s": rep.collective_s}
    if serve is not None:
        prof = serve["decode_profile"]["replayed"]
        out["measured_replayed_device_ms_per_step"] = prof["device_ms_per_step"]
        out["measured_over_predicted"] = prof["device_ms_per_step"] / (rep.bound_s * 1e3)
    check(t.flops > 0 and rep.bound_s > 0, "sharding: the dry-run counted nothing")
    return out


def phase_sharding(dev, serve: dict | None = None) -> dict:
    """(a) the DTensor train step on a one-rank NCCL mesh against the
    unsharded one, (b) GPipe over the loopback's (4,) mesh with K3, (c)
    sharded serving through ``ServeEngine(pol=...)`` on a one-rank NCCL
    mesh against the unsharded engine, (d) the dry-run's count of the
    decode step priced against phase 5's measured one (``serve``: phase
    5's result)."""
    import torch

    out = {"torch": torch.__version__}
    t0 = time.perf_counter()
    out["train_dtensor"] = _sharded_train(dev)
    out["gpipe"] = _gpipe_on_card(dev)
    out["ab_s"] = time.perf_counter() - t0
    with _one_rank_mesh(dev) as mesh:
        t0 = time.perf_counter()
        out["serve_dtensor"] = _sharded_serve(dev, mesh)
        out["c_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dryrun_vs_card"] = _dryrun_vs_card(mesh, serve)
        out["d_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import LAUNCHES, _build, reset_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    rate, rate_note = mem_rate(name)
    t0 = time.perf_counter()
    sources = ("spike_accum", "attention", "scan", "random")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        for fut in [pool.submit(_build.build_library, src) for src in sources]:
            fut.result()
    for src in sources:
        _build.load_library(src)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": time.perf_counter() - t0, "nvcc_s": _build.BUILD_SECONDS,
          "mem_rate": rate_note, "tf32": False})

    kern = phase_kernels(dev, rate)
    kern.update(phase_attention(dev, rate))
    kern.update(phase_scans(dev, rate))
    kern.update(phase_threefry(dev, rate))
    emit({"phase": "kernels_check", **kern})

    # each main path runs with the counts set to 0 just before it and read
    # just after, and must have launched each of its kernels
    launches = dict.fromkeys(LAUNCHES, 0)

    results = {}

    def path(kernels, *phases):
        reset_launches()
        for phase, fn in phases:
            results[phase] = fn()
            emit({"phase": phase, **results[phase]})
        got = dict(LAUNCHES)
        for kname in kernels:
            check(got[kname] > 0, f"{phases[0][0]}: main path never launched {kname}")
        for kname, n in got.items():
            launches[kname] += n
        return got

    kept: dict = {}
    path(("spike_accum_blocks", "spike_accum", "threefry"),
         ("launcher", lambda: phase_launcher("cuda")),
         ("real_size", lambda: phase_real_size("cuda", keep=kept)))
    # replanned plans flipped into phase 4's network, on its device tiles
    path(("spike_accum_blocks",), ("recovery", lambda: phase_recovery(dev, kept)))
    del kept["tiles"]
    # the spike exchange across processes, phase 4's tiles shared with them:
    # each process rank counts its own kernel launches
    results["comm"] = phase_comm(dev, kept)
    emit({"phase": "comm", **results["comm"]})
    cards = torch.cuda.device_count()
    if cards >= 4:  # NCCL across ranks takes one card per rank
        multi = {"run": True, "cards": cards, "launcher": _comm_launcher("nccl", 4)}
        if cards >= int(np.prod(kept["mesh"])):
            multi["real_size"] = _comm_real_size(kept, "nccl")
    else:
        multi = {"run": False, "cards": cards}
    emit({"phase": "comm_nccl_multi", **multi})
    kept.clear()
    # the paper's experiment planned on the host (no kernel: outside the counts)
    emit({"phase": "plan_paper_scale", **phase_plan_paper_scale()})
    # every LM path draws its weights on the card: threefry, one launch a leaf
    path(("flash_attention", "decode_attention", "threefry"),
         ("serve", lambda: phase_serve(dev, SERVE_ARCH)))
    path(("ssd_scan", "threefry"), ("serve_mamba2", lambda: phase_serve(
        dev, "mamba2-1.3b", _depth_cut("mamba2-1.3b", SERVE_LAYERS["mamba2-1.3b"]))))
    with shapes_of_rglru() as shapes:
        got = path(("rglru_scan", "flash_attention", "decode_attention", "threefry"),
                   ("serve_recurrentgemma", lambda: phase_serve(dev, "recurrentgemma-9b")))
    by_batch: dict[int, int] = {}
    for (b, _, _), n in shapes.items():
        by_batch[b] = by_batch.get(b, 0) + n
    check(sum(shapes.values()) == got["rglru_scan"],
          f"rglru_scan shapes {shapes} do not add up to the path's launches")
    emit({"phase": "rglru_scan_shapes", "path": "serve_recurrentgemma",
          "launches_by_shape": {"x".join(map(str, k)): n for k, n in sorted(shapes.items())},
          "launches_by_batch": by_batch})
    emit({"phase": "serve_launcher", **phase_serve_launcher()})
    # the mixture of experts served at full width (16 of 48 layers), then the vlm
    # and audio front ends through lm.prefill / lm.decode_step
    path(("flash_attention", "decode_attention", "threefry"),
         ("serve_qwen3_moe", lambda: phase_serve(dev, MOE_ARCH,
                                                 _depth_cut(MOE_ARCH, SERVE_LAYERS[MOE_ARCH]))))
    path(("flash_attention", "decode_attention", "threefry"),
         ("frontends", lambda: phase_frontends(dev)))
    # the remaining text configs and the dry-run's lengths: deepseek-7b,
    # qwen2.5-14b and yi-34b at full width (the last two cut in depth,
    # SERVE_LAYERS), mixtral-8x22b at full width cut to its first layers,
    # phi4 over a 32,000-token prompt
    for phase, arch in DENSE_PATHS.items():
        cut = _depth_cut(arch, SERVE_LAYERS[arch]) if arch in SERVE_LAYERS else None
        path(("flash_attention", "decode_attention", "threefry"),
             (phase, lambda arch=arch, cut=cut: phase_serve(dev, arch, cut)))
    path(("flash_attention", "decode_attention", "threefry"),
         ("serve_mixtral_cut", lambda: phase_serve(
             dev, "mixtral-8x22b", _depth_cut("mixtral-8x22b", MIXTRAL_LAYERS))))
    path(("flash_attention", "decode_attention", "threefry"),
         ("long_context", lambda: phase_long_context(dev)))
    # training: (a) and (b) take the training route, which launches no
    # hand-written kernel but threefry's weights; (c) serves the trained
    # params through K3 and K4
    shared: dict = {}
    path(("threefry",), ("train_phi4", lambda: _train_part(dev, "phi4-mini-3.8b", shared)),
         ("train_mamba2", lambda: _train_part(dev, "mamba2-1.3b", shared)))
    # the families that had only served on the card, at full width with
    # layers cut, and the reduced configs' gradients card vs CPU
    for phase, args in TRAIN_FULL.items():
        path(("threefry",), (phase, lambda args=args: _train_full(dev, *args, shared["cpu"])))
    path(("threefry",), ("train_reduced", lambda: _train_reduced(dev)))
    path(("flash_attention", "decode_attention", "threefry"),
         ("train_serve", lambda: _train_then_serve(dev)))
    # sharding: (a) the DTensor train step on a one-rank NCCL mesh (training
    # route, no kernel), (b) GPipe over the loopback's (4,) mesh (K3), (c)
    # sharded serving on the one-rank mesh (K3, K4), (d) the dry-run's count
    path(("flash_attention", "decode_attention", "threefry"),
         ("sharding", lambda: phase_sharding(dev, results["serve"])))

    csrc = "src/repro_torch/kernels/csrc/"
    comm_real = results["comm"]["real_size"]
    per_rank = sum(comm_real[tag]["spike_accum_blocks_launches_per_rank"]
                   for tag in ("sparse", "ragged_fused"))
    rows = []
    for kname, source, replaces, case in (
        ("spike_accum_blocks", "spike_accum.cu", "spike_accum.py:133", "rate_1pct"),
        ("spike_accum", "spike_accum.cu", "spike_accum.py:62", "rate_1pct"),
        ("spike_accum", "spike_accum.cu", "spike_accum.py:62", "oracle_2pct"),
        ("flash_attention", "attention.cu", "flash_attention.py:116", "phi4_prefill/bfloat16"),
        ("flash_attention", "attention.cu", "flash_attention.py:116", "rg_prefill/bfloat16"),
        ("flash_attention", "attention.cu", "flash_attention.py:116", "qwen3_prefill/bfloat16"),
        ("flash_attention", "attention.cu", "flash_attention.py:116", "llava_prefill/bfloat16"),
        ("flash_attention", "attention.cu", "flash_attention.py:116",
         "musicgen_prefill/bfloat16"),
        ("flash_attention", "attention.cu", "flash_attention.py:116",
         "phi4_prefill_q_offset/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94", "phi4_decode/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94",
         "rg_ring_misaligned/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94", "qwen3_decode/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94", "llava_decode/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94",
         "musicgen_decode/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94",
         "phi4_decode_lse_half/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94",
         "rg_ring_lse_half/bfloat16"),
        *(("flash_attention", "attention.cu", "flash_attention.py:116", f"{case}/bfloat16")
          for case in ("deepseek_prefill", "qwen25_prefill", "yi_prefill", "mixtral_prefill",
                       "phi4_prefill_32k", "dryrun_prefill_32k")),
        *(("decode_attention", "attention.cu", "decode_attention.py:94", f"{case}/bfloat16")
          for case in ("deepseek_decode", "qwen25_decode", "yi_decode", "mixtral_ring",
                       "phi4_decode_32k", "dryrun_decode_32k")),
        ("ssd_scan", "scan.cu", "ssd_scan.py:81", "mamba2_prefill"),
        ("rglru_scan", "scan.cu", "rglru_scan.py:53", "rg_prefill"),
        ("rglru_scan", "scan.cu", "rglru_scan.py:53", "rg_continuous"),
        ("threefry", "random.cu", None, "lif_noise"),
        ("threefry", "random.cu", None, "phi4_sampler"),
        ("threefry", "random.cu", None, "phi4_leaf"),
    ):
        table = kern[kname]
        c = table["cases"][case] if "cases" in table else table[case]
        if case == "oracle_2pct":  # the device time it took on the main path
            c = {**c, "main_path_device_ms":
                 results["real_size"]["oracle"]["spike_accum_device_ms_per_step"]}
        rows.append({"name": kname, "route": "cuda", "source": csrc + source,
                     "replaces": THREEFRY_REPLACES if replaces is None
                     else "src/repro/kernels/" + replaces, "launches": launches[kname],
                     "max_abs_err": table["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                     "device_ms": c["device_ms"], "case": case,
                     **({"process_rank_launches": {"ranks": comm_real["processes"],
                                                   "per_rank": per_rank}}
                        if kname == "spike_accum_blocks" else {}),
                     **{key: c[key] for key in ("bound_ms_bytes", "main_path_device_ms",
                                                "plain_rows") if key in c}})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (name and power limit, as nvidia-smi gives them) and the
     build of every CUDA kernel from the sources in this checkout, one
     nvcc per source, all started together, with each kernel's registers
     and spills as ptxas reports them;
  2. every kernel against its plain PyTorch version on the card:
     - K1 (paged decode) over the reference's shape sweep, window/softcap
       cases, split counts given through the C argument (ranges wholly
       before a window among them), the full-width shape with and
       without a window, each half of its slots gathered as a decode
       shard of phase 3d-2 launches it (its own split count at B 4), and
       zamba2-7b's shared-block shape (B 8, H = KVH = 32, D 112,
       2048-token slots), the attention families' serving shapes
       (gemma2-2b's 8/4 heads of D 256 at softcap 50 with and without its
       4096-token window over 8192-token slots, internlm2-1.8b's 16/8 of
       128 and granite-moe-3b's 24/8 of 64 over 1024, gemma3-12b's 16/8 of
       256 over 2048 with and without its 1024-token window), with hot
       pages on the card, cold pages in pinned host memory and unmapped
       (FREE) table entries;
     - K4 (Mamba2 SSD scan) over the reference's SSD sweep, a start state,
       S < chunk, a bf16 P of 12, the full-width zamba2-7b layer (S 4096,
       H 112, P = N = 64) and one rank's heads of it under a rank context
       (B 2, H 56 and 28: phase 13), in f32 and bf16, each on the kernel
       the wrapper
       picks (bf16 with P, N multiples of 8: the tensor-core kernel; else
       the SIMT kernel), then the tensor-core kernel at given segment
       counts, with h0 and a ragged last chunk; then K4 through ops.ssd at
       zamba2's layer on prompt lengths of 700 and 1300 (not whole
       256-token chunks: ops.ssd pads them) from a random start state;
  3. serving smollm-360m at full width (bf16, random weights from seed 0)
     through the paged-pool ContinuousBatcher: tiered hot windows against
     an all-hot run (tokens must be identical), K1's launch count against
     decode steps x layers, and a small fp32 run on the card against the
     same run on the CPU (plain path); then K1's time beside its bound, its
     plain version's and one PyTorch library call's, at the wrapper's split
     count and at one split in turns, decode tokens/s and a profile of a
     few decode steps (device-busy share, top device kernels);
  3c. the other three engine layouts on phase 3's requests, weights and
     width: all-HBM, concat (a global 256-token hot window) and
     paged-merged (phase 3's per-slot windows): identical tokens, and the
     per-slot boundaries move fewer bytes than the global one; the pools
     run's tokens against all-HBM's are counted, not gated.  Then
     _paged_decode_core (K1 over a dense cache split at per-slot
     boundaries) for one decode step over the all-HBM run's cache against
     the dense step, and generate (8 prompts of 256 tokens, 32 greedy
     tokens, twice);
  3c-F1. ROADMAP F1's case on the card: smollm-360m and deepseek-v2-lite
     reduced in fp32 on all-HBM, concat and paged-merged, a slot finished
     at max_seq decoding on at index max_seq (a write the port drops):
     tokens and counters == the CPU's, no device assert;
  3b. the rates behind H100_COST's measured constants (a device copy,
     pinned host<->device copies, one page demotion), each printed beside
     its constant; then Sentinel's loop at the same width, weights and
     requests: profile the stream (serve_trace_for), plan at 20 % of its
     peak KV on H100_COST and re-plan at 10 % (runtime.plan, plan_delta),
     serve with the first plan and apply the PlanDelta a third of the way
     in: tokens must equal an all-hot run's, the delta must demote pages on
     the card, K1 must run once per decode step and layer, and the
     engine's integer counters must equal predict_pool_counters'; decode
     tokens/s and the pure-decode step time beside the plan's prediction;
  3d. the disaggregated engine at the same width, weights and requests:
     3d-1, one shard (prefill and decode alias the card) on 3b's first
     plan with prefill_chunk_tokens 0: tokens identical to the colocated
     pools engine's on that plan, no repack, the mesh ledger (xdev bytes
     above 0, per-edge bytes, hot peaks, migration series) equal to
     predict_pool_counters(dense_admit=True), K1 == decode steps x 32;
     3d-2, two decode shards aliased on the card (devices=[cuda:0] * 4,
     groups 2 + 2) on a plan_serving(decode_devices=2) plan, every slot
     re-homed to the other shard before step 22: every ledger edge (both
     shard-to-shard edges above 0), the hot peaks and the migration
     series equal predict_pool_counters(plan_schedule=...), K1 == the
     shards with an active slot summed over decode steps x 32, and the
     tokens that agree with 3d-1's counted (not gated); then the same on
     smollm-360m reduced in fp32 on the card against the CPU (tokens and
     ledger) and a colocated all-hot run (tokens); each run's decode
     tokens/s and pure-decode step; 3d-3, price_disagg on H100_COST for
     phase 3's trace and the reference's prefill-heavy mix; 3d-4, the
     serving CLI (python -m repro_torch.launch.serve --arch smollm-360m
     -n 32) at full width, which must exit 0;
  4. zamba2-7b: its reduced fp32 variant on the card against the CPU
     (logits and loss, and the tokens of a small pools-layout serving run),
     then the full width in bf16 (random weights from
     seed 0, B 2 x S 4096): the loss and the forward (finite), K4's
     launches against 65 MAMBA layers x forwards, the first Mamba layer's
     K4 output (on the tensor-core kernel) against the plain version on the
     same activations, the forward's time and tokens/s, a profile of one
     forward with K4's share, and K4's time at B 2 and B 1 beside both its
     bounds (bytes or tensor-core operations; f32 CUDA-core operations) and
     its plain version's, against the SIMT kernel in turns and at other
     segment counts;
  4b. zamba2-7b serving at full width with the same weights on the pools
     layout (8 slots of 2048 tokens, page 16, hand hot windows of 256-480
     tokens), 12 requests of 200-1500 prompt tokens, four sharing a
     256-token prefix, 32 decode tokens each: tokens == an all-hot run's,
     K4 launches == admissions x 65 (each admission's dense prefill), K1
     launches == decode steps x 16 (the shared block's uses), counters ==
     predict_pool_counters(dense_admit=True); prefill ms per admission,
     decode tokens/s, the pure-decode step, peak memory and a profile;
  5. the training side:
     5a. ops.ssd under autograd (K4's forward, the plain version's
         backward) against the plain version's forward and backward over
         the reference's SSD sweep, with h0, and at zamba2-7b's layer: y,
         h and every input gradient within K4's limits, K4 launches ==
         forward calls; K4's forward time beside the plain backward's;
     5b. smollm-360m and zamba2-7b reduced in fp32, the card against the
         CPU from the same parameters: loss and gradients in the four
         Sentinel modes at MI 1 and 2, the offload counter (carries and
         bytes) against estimate_offload_traffic, K4's launches; and adamw.update with
         its moments streamed from pinned host memory against the same
         update with them on the card (identical);
     5c. smollm-360m at full width and depth (bf16, B 8 x S 1024): the
         training CLI for 2 steps; the step profiled on the meta device and
         planned on H100_COST; 6 steps in each mode (full, remat, save_hbm,
         offload at the planned MI) from one state: losses and gradient
         norms agree step by step, and a planted fault (one block's carry
         zeroed) moves the gradient norm past that limit; offload's
         carries out and back == estimate_offload_traffic, offload's peak
         below full's and its rise below save_hbm's by the carries it
         moved off the card; step time, tokens/s, peak memory and
         device-busy share of each mode, offload's time and memory over
         full's;
     5d. zamba2-7b at full width on 11 of its 81 layers (its Mamba
         prologue and ZAMBA_TRAIN_PERIODS, 2 of 16 periods; cut for the
         script's time limit), bf16, B 1 x S 4096, offload at the
         planned MI with the AdamW moments in pinned host memory, 2 steps
         on a repeated batch: the loss finite and falling, K4 once a
         Mamba layer a forward and once a period's Mamba layer a
         recompute; step time, adamw.update's time, peak memory, pinned
         host bytes;
     5e. A1, the fused AdamW pass (``check_adamw_fused``): the kernels
         against their plain version bit for bit on small leaves;
         smollm-360m's 290 leaves fused against the eager ops, one step at
         a time from the same state, bit for bit with the clip off and,
         with it on, the moments within ADAMW_MOMENT_REL and every
         parameter the step its own moments give; its device ops and
         launches a step; its ms against 22 B a parameter at HBM's rate;
  6. the attention families (ROADMAP item 9), each loaded alone and freed
     before the next, bf16 from seed 0 at full width, 8 slots,
     page 16, 32 decode tokens a request:
     6a. the five reduced fp32 configs on the card against the CPU (the
         pools with a prefill chunk; deepseek-v2-lite on the pools with
         chunk 0 and on concat): every forward's logits within atol 1e-4,
         tokens and integer counters identical;
     6b. gemma3-12b on the pools (2048-token slots, chunk 256, hot windows
         256-480), at a quarter of its depth (12 of 48 layers,
         DEPTH_PARTS; cut for the script's time limit), 12 prompts of
         300-1800 tokens, four over 1024 and four sharing a 256-token
         prefix: tiered == all-hot tokens, K1 == decode steps x 12 with its LOCAL
         window and without, counters == predict_pool_counters;
     6c. gemma2-2b on the pools (8192-token slots), on 6 of its 26
         layers (the same cut), 8 prompts of 500-6000 tokens, two over
         4096: the same gates, K1 == steps x 6 with softcap 50 in every
         launch, every logit within +-30; then the serving CLI at full
         width and depth (--arch gemma2-2b -n 16), exit 0;
     6d. internlm2-1.8b and granite-moe-3b (40 experts, top 8) on the
         pools (1024-token slots) over phase 3's requests, on a quarter
         of their layers (6 and 8; the same cut): the same gates;
     6e. deepseek-v2-lite (MLA, 64 experts top 6 and 2 shared, a dense
         first layer) on all-HBM and concat (a global 256-token hot
         window: the latent's cold prefix in pinned host memory), 12
         prompts of 100-500 tokens, on 7 of its 27 layers (the same cut
         as 6b): identical tokens, no kernel launch, the latent 7 x 576 x
         2 bytes a token;
     each run's prefill ms per admission (a chunk on the pools), decode
     tokens/s, pure-decode step, peak device memory and a profile of
     decode steps;
  7. the recurrent families, which run none of K1-K4 (their launches
     counted 0 on each path; A1's recorded):
     7a. xlstm-1.3b and lstm-ptb reduced in fp32 on the card against the
         CPU: the four engine layouts (logits, tokens, integer counters;
         tiered == all-HBM), the loss and gradients of the full mode, and
         each Sentinel mode's loss and gradient norm against full's at MI
         1 and 2; the chunked mLSTM against the sequential scan at
         xlstm-1.3b's head shape, each timed;
     7b. xlstm-1.3b at full width on 16 of its 48 layers (bf16, seed 0,
         chunks of 64; the depth cut for the script's time limit): 8 slots
         of 2048 tokens, 12 prompts of 128-1024 tokens, all-HBM then the
         pools (identical tokens); then B 1 x S 1024 training, offload at
         the MI planned on H100_COST against full, the moments in pinned
         host memory; the training and serving CLIs at full depth;
     7c. lstm-ptb at full width: B 20 x BPTT 35 training in the four modes,
         planned on its own profile, beside the simulator's fast-only,
         slow-only, Sentinel and IAL steps on H100_COST (paper Fig. 10's
         shape, which must hold); the training CLI; 8 slots of 512 tokens,
         12 prompts of 35-350 tokens, all-HBM then the pools; the serving
         CLI;
  8. the modality stubs (ROADMAP 9c, 9d), which run none of K1-K4
     (their launches counted 0 on each path; A1's recorded):
     8a. musicgen-medium and paligemma-3b reduced in fp32 on the card
         against the CPU: the forward's logits (codebooks; the prefix of
         patch embeddings and the text alone), generate's tokens, the loss
         and gradients of the full mode, and each Sentinel mode's loss and
         gradient norm against full's at MI 1 and 2; paligemma's batcher
         on all-HBM, concat and paged-merged (a prompt shorter than the
         prefix among five: ROADMAP R9), tokens and counters == the CPU's,
         tiered == all-HBM, no pools;
     8b. at full width on a quarter of their depth (12 of 48 and 4 of 18
         layers, DEPTH_PARTS; cut for the script's time limit), bf16,
         seed 0: musicgen-medium's generate at B 8 on 256 frames of 4
         codes, 32 tokens, and the serving CLI at full depth;
         paligemma-3b's generate at B 4 on 256 patch
         embeddings and 64 text tokens, 32 tokens, then its batcher (8
         slots of 2048, phase 3's 12 requests) on all-HBM, concat and
         paged-merged with use_paged_decode set: identical tokens, no
         pools and no K1 launch (K1 has no prefix mask); prefill ms,
         decode step, peak memory and a profile of decode steps;
     8c. one B 1 training step a mode at full width on 8b's depth (for
         the script's clock): musicgen at 1024
         frames of 4 codes, paligemma at 256 patches + 768 text tokens,
         full against offload at the MI planned on H100_COST from the
         step's meta-device profile, the moments in pinned host memory:
         offload's loss and gradient norm == full's, its carries ==
         estimate_offload_traffic; step ms, peak and carry bytes;
  9. MoE under Sentinel's blocked modes (ROADMAP item 12), which runs none
     of K1-K4 (their launches counted 0 on each path; A1's recorded):
     9a. granite-moe-3b and deepseek-v2-lite reduced in fp32 on the card
         against the CPU: the loss (with every MoE layer's aux) and every
         gradient in the four modes at MI 1 and 2, each mode == full,
         offload's bytes == estimate_offload_traffic;
     9b. granite-moe-3b at full width on GRANITE_TRAIN_LAYERS, 8 of its
         32 layers (for the script's clock), bf16 from seed 0, B 1 x S
         1024, two steps in each of the four modes at the MI planned on
         H100_COST, the moments in pinned host memory: losses finite and falling,
         every mode == full, offload's carries == the estimate;
     9c. deepseek-v2-lite at full width on its dense first layer and 4 of
         its 26 MoE layers (all 27 layers' moments, about 126 GB, pass the
         machine's 96 GiB of host memory; 4, not 8, for the script's
         clock), the same steps and gates;
  10. the disaggregated engine on the attention families (ROADMAP item
     13):
     10a. each family reduced in fp32, one shard (all five) and two
         shards aliased on the device (the four GQA families, slots
         re-homed mid-run) on the card and on the CPU: tokens and ledger
         == the CPU's, tokens == a colocated all-hot run's, K1 == shard
         forwards x attention layers; deepseek refused at two shards;
     10b. each family at full width on a quarter of its layers
         (DEPTH_PARTS, the cut for the script's time limit), bf16 from seed 0, 12 prompts of 300-512
         tokens on 8 slots of 1024, whole-prompt admission: the colocated
         pools engine (admitting densely), one shard (tokens ==
         colocated, ledger == predict_pool_counters(dense_admit=True), K1
         == decode steps x attention layers) and, for the four GQA
         families, two shards aliased on the card (ledger ==
         predict_pool_counters, K1 == shard forwards x attention layers,
         the tokens' agreement with one shard printed);
  2b. (run right after phase 2) the attention entry points
     ops.flash_attention (K2) and ops.decode_attention (K3), which no model
     path of the reference calls:
     - both kernels against their plain versions over the reference's
       sweeps in f32 and bf16, window/softcap cases, Sq < Skv, ragged Sq,
       G 1, 3, 5 and 8, D 8, 64, 112 and 256, strided inputs, and rows with
       no visible key (causal Sq > Skv; a length-0 slot; a window past S),
       K3 also at split counts 1, 2 and the wrapper's, and a CUDA query
       with host KV refused; K2 again at each D its wgmma kernel takes (64,
       112, 128) through the masking sweep;
     - K3 on the KV of the smollm-360m serving run gathered densely from
       its pools, against K1 on those pools and against the plain version;
     - K2 on the q, k, v of zamba2-7b's first SHARED_ATTN layer at full
       width (B 2 x S 4096), against the plain version and that layer's
       _gqa_core, and K3 on the same activations against K2's last row;
       K3 at zamba2-7b's shared-block decode shape (B 8 x S 4096);
     - each kernel's time beside its bound, its plain version's and one
       F.scaled_dot_product_attention call's; K2's wgmma kernel against its
       mma.sync kernel in turns at zamba2's shape and at D 64 and 128; K3
       at the wrapper's split count against one split in turns at both of
       its shapes;
  11. tensor-parallel prefill over the disaggregated engine's prefill
     group (ROADMAP item 11b), last:
     11a. smollm-360m, internlm2-1.8b and granite-moe-3b reduced in fp32,
         a 12-token prompt through TensorParallelPrefill on [cuda:0] * 2
         and * 4 ranks against the same on [cpu] * n and the card's
         one-device prefill: logits and caches within atol 1e-4, the
         collectives' ledger (bytes and counts) == the CPU's;
     11b. devices=[cuda:0] * 4 (two decode shards, a prefill group of two
         aliased ranks), bf16 from seed 0: smollm-360m at full depth on
         phase 3's requests under phase 3d's two-shard plan, and
         internlm2-1.8b at half depth on phase 10b's, each without and
         with tp_prefill: both edge ledgers == predict_pool_counters(
         dense_admit=True), K1 the same with and without TP, the ledger's
         bytes == the closed form (all-reduce (2L + 1) x S x d x 2 B,
         smollm's cut heads add all-gather L x S x (960 + 320 + 320) x 2
         B, S the admitted prompt tokens), and each admission's last-row
         logits no farther from an fp32 one-device prefill than 1.5 times
         the bf16 one-device prefill's; each admission's ms with and
         without TP and the tokens' agreement printed.
  12. the partitioned train step (train.loop.PartitionedStep: TP and DP
     over a (data, model) mesh, FSDP; ROADMAP item 11b part 1), last:
     12a. smollm-360m and granite-moe-3b reduced in fp32, one step on a
         (2, 2) mesh of [cuda:0] * 4 against the same on [cpu] * 4 and the
         card's one-device step, in each mode at MI 1 (offload with pinned
         moments), FSDP off and on: loss, gradient norm and every
         reassembled parameter within atol 1e-4, ledgers == the CPU's,
         every replicated leaf equal across its ranks (a lost rank context
         or a backward on autograd's shared device thread fails here);
     12b. smollm-360m at full width and depth, bf16, B 4 x S 1024, two
         steps in full and two in offload at phase 5c's planned MI, on
         (2, 2) of [cuda:0] * 4 with FSDP against the card's one-device
         step: loss and gradient norm within 2**-10 and 2**-6 of it,
         offload == full, the ledger == train_expected_ledger's closed
         form, each rank's carries == estimate_offload_traffic; step ms
         and peak memory printed.  K1-K4 launch 0 times.
  13. MLA and Mamba under a rank context (ROADMAP item 11b part 2a,
     items 1-2); K4 runs on each rank's block of the SSM heads:
     13a. deepseek-v2-lite, zamba2-7b and granite-moe-3b with 6 experts
         (ROADMAP F4) reduced in fp32, 12a's gates on (2, 2) of [cuda:0] *
         4 in the four modes x FSDP off/on and in full on (1, 2) (granite:
         (2, 4)); K4 == ranks x (Mamba layers + recomputes) a step;
     13b. zamba2-7b on its prologue and one period (0.71 B parameters)
         and deepseek-v2-lite on its dense layer and 2 MoE layers (1.67
         B), full width, bf16, B 2 x S 1024, two steps in full and in
         offload at MI 1 on (2, 2) with FSDP against the card's
         one-device step: 12b's gates, the ledger == the dry run's ledger
         of the same step, K4 == steps x ranks x (Mamba layers +
         recomputes);
     13c. both at 13b's depth, TP prefill on a disaggregated engine with
         one decode shard and a prefill group of two aliased ranks
         (prefill_devices=[cuda:0] * 2), phase 10b's 12 prompts on 8
         slots of 1024: 11b's gates, but the TP logits' and caches'
         distances from an fp32 prefill held as means over the admissions
         (a Mamba stack's single prompt reads them noisily), the TP
         ledger == the dry run's ledger of each admitted prompt summed, K1
         (zamba2's shared block; deepseek 0) the same with and without
         TP, K4 with TP twice without.
  14. the recurrences and the modality stubs under a rank context
     (ROADMAP item 11b part 2a, items 3-4), last; no kernel launches:
     14a. xlstm-1.3b (one period), lstm-ptb, musicgen-medium and
         paligemma-3b reduced in fp32, 12a's gates on (2, 2) of [cuda:0]
         * 4 in the four modes, FSDP off in two and on in two, and in
         full on (1, 4) where
         the cut differs (xlstm, lstm-ptb), and xlstm's 2-head variant on
         (1, 4), whose heads stay whole; the xLSTM held to XLSTM_REL of
         the largest |value| (its fp32 conditioning);
     14b. each at full width and reduced depth (xlstm-1.3b on one period,
         fp32, B 2 x S 64, its mLSTM chunkwise; lstm-ptb whole, B 20 x
         35; musicgen-medium on 4 layers, B 2 x 256 frames; paligemma-3b
         on 3 layers, B 2 x (256 patches + 64 tokens); bf16), two steps
         in full and in offload at MI 1 on (2, 2) with FSDP: 13b's gates;
         then xlstm-1.3b's first step in bf16 on (2, 2), its loss,
         gradient norm and every leaf's gradient no farther from the fp32
         step's than 1.5 times the farthest of four one-device bf16 steps
         (three from starts moved one ulp);
     14c. xlstm-1.3b at 14b's depth, TP prefill on a disaggregated engine
         with one decode shard (13c's gates, 8 prompts of whole 64-token
         chunks); musicgen-medium and paligemma-3b, which the engine does
         not take, through TensorParallelPrefill on [cuda:0] * 2 against
         one device's prefill (the ledger == the dry run's, the TP logits'
         and caches' distance from fp32 within 1.5 times bf16's).
  15. long_500k's sequence-sharded decode and Megatron-SP (ROADMAP item
     11b part 2b), on (2, 2) of [cuda:0] * 4; K4 runs on zamba2-7b's SP
     training alone, on each rank's heads over the gathered sequence:
     15a. smollm-360m, zamba2-7b (one period) and xlstm-1.3b (14a's
         cut) reduced in fp32, the Megatron-SP step against [cpu] * 4 and the card's one
         device in each mode once (12a's gates), K4 == ranks x (Mamba
         layers + recomputes); gemma2-2b, gemma3-12b, zamba2-7b and
         xlstm-1.3b reduced, 4 decode steps with the attention caches'
         rows split over the data axis, from an index in each data block,
         against one device;
     15b. smollm-360m on 4 layers and zamba2-7b on its prologue and one
         period, full width, bf16, B 2 x S 1024, two steps in full and in
         offload at MI 1 with FSDP under Megatron-SP against plain TP on
         the same mesh: 12b's loss and gradient-norm limits, each leaf's
         gradient within 0.1 of plain TP's or within 1.5 times its
         distance from the fp32 step, the ledger == the dry run's, each
         rank's carries half of plain TP's;
     15c. long_500k at full width, B 1 x S 524,288, bf16: gemma2-2b on 2
         layers and zamba2-7b on its prologue and one period, the cache
         filled from seed 0 below index 524,280, 8 decode steps
         sequence-sharded against one device: the logits' distance from
         an fp32 one-device decode within 1.5 times bf16's, every rank's
         cache block equal to the one device's rows, the ledger == 8 x
         the dry run's decode cell.

Every kernel time is the median over launches that each follow an L2
flush and a device-side spin, so the events time the card's work and not
the host's launch overhead.

Then one JSON line with the kernels' record (K1-K4 and A1, each with its
launches on every path, counted from 0 before the path ran), the card
line again, and the last line ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero; without a card the script exits with 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 outside tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 on tensor cores
P_ROUNDING = 2.0 ** -8           # bf16 rounding moves a value by at most this
SPIN_CYCLES = 1_000_000          # about 0.5 ms at the H100's clocks
MAX_SEQ, SLOTS, PAGE, DECODE = 1024, 8, 16, 32
SWEEP = [(2, 64, 4, 2, 16, 8), (3, 128, 8, 4, 32, 16), (1, 32, 2, 1, 128, 8),
         (2, 96, 6, 2, 64, 16)]
WINDOW_SOFTCAP = [(0, 0.0), (24, 0.0), (0, 30.0), (16, 50.0)]
FULL_WIDTH = (SLOTS, MAX_SEQ, 15, 5, 64, PAGE)   # B, S, H, KVH, D, page
# K1 at the head shapes of the wider configs: paligemma-3b (D 256, 1 KV
# head: 64 lanes of 16 bytes a key row in f32), musicgen-medium (24 KV
# heads), gemma3-12b (8 KV heads of D 256), and D 256 at 64-token pages
K1_WIDE = [(2, 128, 8, 1, 256, 16), (2, 64, 24, 24, 64, 16),
           (2, 64, 16, 8, 256, 16), (2, 256, 8, 1, 256, 64)]
# K1 at zamba2-7b's shared block on the serving path: 32 query heads, one
# per KV head, of D 112, over the engine's 2048-token slots
ZAMBA_MAX_SEQ = 2048
K1_ZAMBA = (SLOTS, ZAMBA_MAX_SEQ, 32, 32, 112, PAGE)
# K1 at the attention families' serving shapes (phase 6): gemma2-2b's
# (8 query and 4 KV heads of D 256, softcap 50, its LOCAL layers' 4096-token
# window) over 8192-token slots, internlm2-1.8b's and granite-moe-3b's over
# 1024-token slots, each with its (window, softcap) cases; and gemma3-12b's
# over 2048-token slots, timed with its LOCAL window and without
K1_FAMILIES = {
    "gemma2-2b": ((SLOTS, 8192, 8, 4, 256, PAGE), ((0, 50.0), (4096, 50.0))),
    "internlm2-1.8b": ((SLOTS, MAX_SEQ, 16, 8, 128, PAGE), ((0, 0.0),)),
    "granite-moe-3b": ((SLOTS, MAX_SEQ, 24, 8, 64, PAGE), ((0, 0.0),))}
K1_GEMMA3 = (SLOTS, 2048, 16, 8, 256, PAGE)
K1_GEMMA3_WINDOW = 1024
KERNELS = ("paged_decode", "ssd", "decode_attention",
           "flash_attention", "adamw")            # csrc/<name>.cu
FOUR = KERNELS[:4]                                # K1-K4, not A1


def reset_counts():
    """Every kernel wrapper's launch count to 0, just before a path runs."""
    from repro_torch.kernels import adamw as a1
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ssd as k4
    pd.paged_decode_attention.launches = 0
    k4.ssd.launches = 0
    k3.decode_attention.launches = 0
    k2.flash_attention.launches = 0
    a1.fused_update.launches = 0


def _launch_counts() -> dict:
    """Every kernel wrapper's launches since the last ``reset_counts``,
    keyed by KERNELS."""
    from repro_torch.kernels import adamw as a1
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ssd as k4
    return {"paged_decode": pd.paged_decode_attention.launches,
            "flash_attention": k2.flash_attention.launches,
            "decode_attention": k3.decode_attention.launches,
            "ssd": k4.ssd.launches,
            "adamw": a1.fused_update.launches}


def _counts(**kw) -> dict:
    """A tally of every kernel's launches: ``kw``'s, the others 0."""
    return dict(dict.fromkeys(KERNELS, 0), **kw)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Each kernel's registers and spills from ``nvcc -Xptxas -v``: the
    kernel's name and template argument, then what ptxas said of it."""
    out, name, spill = [], None, ""
    names = {"f": "f32", "13__nv_bfloat16": "bf16"}
    for ln in log.splitlines():
        m = re.search(r"\d+([a-z_]+_kernel)I((?:Li\d+E|Lb\dE|f|"
                      r"13__nv_bfloat16)+)E", ln)
        if "Compiling entry function" in ln and m:
            args = re.findall(r"Li(\d+)E|Lb(\d)E|(f|13__nv_bfloat16)",
                              m.group(2))
            arg = ", ".join(i or b or names[t] for i, b, t in args)
            name = f"{m.group(1)}<{arg}>"
        elif "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else "?"
        elif "spill" in ln and name:
            spill = ", ".join(x.strip() for x in ln.split(",")[1:])
        elif "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append(f"{name} {regs.group(1) if regs else '?'} registers, "
                       f"{spill}")
            name = None
    return "; ".join(out)


# --------------------------------------------------------------- kernels ----

def k1_case(shape, dtype, seed, *, lengths=None, free_row=False):
    """Inputs for the paged decode kernel: dense caches packed into pools
    with the first half of each slot's tokens cold (pinned host memory),
    table entries past each slot's length FREE (-1), and optionally a last
    slot that is wholly unmapped, as an inactive engine slot is."""
    import torch
    from repro_torch.kernels.paged_decode import pack_kv_pools
    B, S, H, KVH, D, page = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, D, generator=g).to(dtype)
    kd = torch.randn(B, S, KVH, D, generator=g).to(dtype)
    vd = torch.randn(B, S, KVH, D, generator=g).to(dtype)
    if lengths is None:
        lengths = [S - 1 - (5 * b) % (S // 2) for b in range(B)]
    cold = [int(n * 0.5) for n in lengths]
    kh, vh, kc, vc, tab, tier = pack_kv_pools(kd, vd, cold, page)
    for b, n in enumerate(lengths):
        used = 0 if (free_row and b == B - 1) else -(-n // page)
        tab[b, used:] = -1
        tier[b, used:] = -1
    dev = "cuda"
    return {"q": q.to(dev), "k_hot": kh.to(dev), "v_hot": vh.to(dev),
            "k_cold": kc.pin_memory(), "v_cold": vc.pin_memory(),
            "page_table": tab.to(dev), "page_tier": tier.to(dev),
            "lengths": torch.tensor(lengths, dtype=torch.int32, device=dev),
            "dense": (kd.to(dev), vd.to(dev)), "shape": shape}


def k1_args(c, cold_on_device=False):
    kc, vc = c["k_cold"], c["v_cold"]
    if cold_on_device:
        kc, vc = kc.to("cuda"), vc.to("cuda")
    return (c["q"], c["k_hot"], c["v_hot"], kc, vc, c["page_table"],
            c["page_tier"], c["lengths"])


def check_kernels():
    """Phase 2: the kernel against its plain version on the card.  Returns
    the full-width bf16 case and its max abs error, and the same at
    zamba2-7b's shared-block shape."""
    import torch
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False     # plain version in fp32
    # (shape, dtype, window, softcap, splits): splits None is the wrapper's
    # own count (plan_splits: every page its own split at these B and NP)
    cases = [(s, dt, 0, 0.0, None) for s in SWEEP + K1_WIDE
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((2, 96, 4, 2, 32, 16), torch.float32, w, cap, None)
              for w, cap in WINDOW_SOFTCAP]
    # explicit split counts through the C argument: one split for the
    # whole slot, ranges that straddle pages, ranges wholly before a window
    cases += [((3, 128, 8, 4, 32, 16), dt, w, 0.0, n)
              for dt in (torch.float32, torch.bfloat16) for w in (0, 20)
              for n in (1, 3, 5, 8)]
    # the plans K1_WIDE must take on this card: fewer KV heads per CTA, and
    # at one KV head tiles shorter than a page, so each path runs above
    plans = {(s, dt): pd.plan(torch.empty(s[0], s[2], s[4], dtype=dt,
                                          device="cuda"), s[3], s[5],
                              s[1] // s[5])
             for s in K1_WIDE for dt in (torch.float32, torch.bfloat16)}
    if not (any(g < s[3] for (s, _), (_, g, _) in plans.items())
            and any(t < s[5] for (s, _), (_, _, t) in plans.items())):
        raise AssertionError(f"k1 wide cases miss a path: {plans}")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (shape, dt, window, cap, splits) in enumerate(cases):
        c = k1_case(shape, dt, seed=i)
        if splits is None:
            out = pd.paged_decode_attention(*k1_args(c), window=window,
                                            softcap_val=cap)
        else:
            _, group, tile = pd.plan(c["q"], shape[3], shape[5],
                                     shape[1] // shape[5])
            out = pd._launch(*k1_args(c), window, cap, splits, group,
                             tile)
        want = ref.paged_decode_attention_ref(*k1_args(c, True),
                                              window=window, softcap_val=cap)
        torch.cuda.synchronize()
        err = _attn_close(out, want, f"k1 {shape} {dt} w{window} cap{cap} "
                                     f"splits {splits}")[0]
        worst[dt] = max(worst[dt], err)
    # the main path's shape, lengths 100-1000 and a wholly unmapped slot, in
    # both dtypes, at the wrapper's split count and with a 64-token window
    # (most splits wholly before it): f32 holds the kernel's arithmetic to
    # the plain version's, bf16 its loads and its rounding of the output
    lengths = [int(n) for n in np.random.default_rng(1).integers(
        100, 1000, SLOTS)]
    full = {}
    for dt in (torch.float32, torch.bfloat16):
        c = k1_case(FULL_WIDTH, dt, seed=99, free_row=True, lengths=lengths)
        for window in (0, 64):
            out = pd.paged_decode_attention(*k1_args(c), window=window)
            want = ref.paged_decode_attention_ref(*k1_args(c, True),
                                                  window=window)
            torch.cuda.synchronize()
            err = _attn_close(out, want, f"k1 full width {FULL_WIDTH} {dt} "
                                         f"w{window}")[0]
            if window == 0:
                full[dt] = (c, err)
            else:
                worst[dt] = max(worst[dt], err)
    # the disaggregated engine's shape (phase 3d-2): each of two decode
    # shards launches K1 on its half of the slots, q and table rows
    # gathered, against B-slot pools, so the wrapper takes its split count
    # from B / 2; both halves, the unmapped slot in one of them
    halves = [torch.arange(h, SLOTS, 2, device="cuda") for h in (0, 1)]
    sub = {}
    for dt in (torch.float32, torch.bfloat16):
        c = full[dt][0]
        for h, idx in enumerate(halves):
            args, plain = list(k1_args(c)), list(k1_args(c, True))
            for a in (args, plain):
                for j in (0, 5, 6, 7):                 # q, table, tier, len
                    a[j] = a[j][idx]
            out = pd.paged_decode_attention(*args)
            want = ref.paged_decode_attention_ref(*plain)
            torch.cuda.synchronize()
            err = _attn_close(out, want, f"k1 shard half {h} of "
                                         f"{FULL_WIDTH} {dt}")[0]
            sub[dt] = max(sub.get(dt, 0.0), err)
    # zamba2-7b's shared-block shape, lengths of the serving prompts
    zl = [int(n) for n in np.random.default_rng(4).integers(
        200, 1533, SLOTS)]
    zamba = {}
    for dt in (torch.float32, torch.bfloat16):
        c = k1_case(K1_ZAMBA, dt, seed=98, lengths=zl)
        out = pd.paged_decode_attention(*k1_args(c))
        want = ref.paged_decode_attention_ref(*k1_args(c, True))
        torch.cuda.synchronize()
        zamba[dt] = (c, _attn_close(out, want, f"k1 zamba2 shape {K1_ZAMBA} "
                                              f"{dt}")[0])
    z_plan = pd.plan(zamba[torch.bfloat16][0]["q"], K1_ZAMBA[3], PAGE,
                     ZAMBA_MAX_SEQ // PAGE)
    print(f"k1 zamba2 shape {K1_ZAMBA} (lengths {min(zl)}-{max(zl)}, cold "
          f"pages pinned): == plain, max_abs_err f32 "
          f"{zamba[torch.float32][1]:.3e} within "
          f"{_tol_text(torch.float32)}, bf16 {zamba[torch.bfloat16][1]:.3e} "
          f"within {_tol_text(torch.bfloat16)}; (splits, KV heads a CTA, "
          f"tile) {z_plan}", flush=True)
    families = check_k1_families()
    B, S, _, KVH = FULL_WIDTH[:4]
    full_plan = pd.plan(full[torch.bfloat16][0]["q"], KVH, PAGE, S // PAGE)
    sub_plan = pd.plan(full[torch.bfloat16][0]["q"][halves[0]], KVH, PAGE,
                       S // PAGE)
    print(f"k1 disaggregated shard shape: slots {SLOTS // 2} of {SLOTS} "
          f"gathered from {FULL_WIDTH}, both halves == plain, max_abs_err "
          f"f32 {sub[torch.float32]:.3e} within {_tol_text(torch.float32)}, "
          f"bf16 {sub[torch.bfloat16]:.3e} within "
          f"{_tol_text(torch.bfloat16)}; (splits, KV heads a CTA, tile) "
          f"{sub_plan} against {full_plan} at {SLOTS} slots", flush=True)
    wide = "; ".join(f"{s} {str(dt)[6:]}: {g} KV heads a CTA, tile {t}"
                     for (s, dt), (_, g, t) in plans.items())
    print(f"k1 check: {len(cases) + 8} cases match the plain version, cold "
          f"pages read from pinned host memory by cp.async; splits 1-8 "
          f"given, and the wrapper's (splits, KV heads a CTA, tile) "
          f"{full_plan} at the full width; wide heads ({wide}); "
          f"max_abs_err f32 {worst[torch.float32]:.3e} "
          f"(sweep) {full[torch.float32][1]:.3e} (full width) within "
          f"{_tol_text(torch.float32)}; bf16 {worst[torch.bfloat16]:.3e} "
          f"(sweep) {full[torch.bfloat16][1]:.3e} (full width) within "
          f"{_tol_text(torch.bfloat16)}", flush=True)
    return full[torch.bfloat16], zamba[torch.bfloat16], families


def check_k1_families():
    """K1 at the attention families' serving shapes, in f32 and bf16,
    against its plain version: K1_FAMILIES with their windows and softcaps
    (gemma2-2b's lengths run past its 4096-token window), then gemma3-12b's
    shape with its 1024-token window and without.  Returns gemma3's bf16
    case and its max abs error by window, for the timing."""
    import torch
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    rng = np.random.default_rng(5)
    for arch, (shape, options) in K1_FAMILIES.items():
        S = shape[1]
        lengths = [int(n) for n in rng.integers(S // 16, S - DECODE,
                                                SLOTS)]
        lengths[:2] = [S - DECODE, S // 2 + 3]       # past any window
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            c = k1_case(shape, dt, seed=97, lengths=lengths)
            for window, cap in options:
                out = pd.paged_decode_attention(*k1_args(c), window=window,
                                                softcap_val=cap)
                want = ref.paged_decode_attention_ref(
                    *k1_args(c, True), window=window, softcap_val=cap)
                torch.cuda.synchronize()
                errs[str(dt)[6:], window, cap] = _attn_close(
                    out, want, f"k1 {arch} shape {shape} {dt} w{window} "
                               f"cap{cap}")[0]
            del c
        plan = pd.plan(torch.empty(SLOTS, shape[2], shape[4],
                                   dtype=torch.bfloat16, device="cuda"),
                       shape[3], PAGE, S // PAGE)
        print(f"k1 {arch} shape {shape} (lengths {min(lengths)}-"
              f"{max(lengths)}, cold pages pinned): == plain, max_abs_err "
              + ", ".join(f"{d} w{w} cap{c:g} {e:.3e}"
                          for (d, w, c), e in errs.items())
              + f" (f32 within {_tol_text(torch.float32)}, bf16 within "
              f"{_tol_text(torch.bfloat16)}); bf16 (splits, KV heads a CTA, "
              f"tile) {plan}", flush=True)
    lengths = [int(n) for n in rng.integers(300, 1833, SLOTS)]
    lengths[0] = 1800
    gemma3, errs = None, {}
    for dt in (torch.float32, torch.bfloat16):
        c = k1_case(K1_GEMMA3, dt, seed=96, lengths=lengths)
        for window in (K1_GEMMA3_WINDOW, 0):
            out = pd.paged_decode_attention(*k1_args(c), window=window)
            want = ref.paged_decode_attention_ref(*k1_args(c, True),
                                                  window=window)
            torch.cuda.synchronize()
            errs[dt, window] = _attn_close(out, want, f"k1 gemma3-12b shape "
                                           f"{K1_GEMMA3} {dt} w{window}")[0]
        if dt == torch.bfloat16:
            gemma3 = (c, {w: errs[dt, w] for w in (K1_GEMMA3_WINDOW, 0)})
    print(f"k1 gemma3-12b shape {K1_GEMMA3} (lengths {min(lengths)}-"
          f"{max(lengths)}): == plain, max_abs_err " + ", ".join(
              f"{str(d)[6:]} w{w} {e:.3e}" for (d, w), e in errs.items()),
          flush=True)
    return gemma3


def _tol(dtype):
    """f32: the same math summed in another order.  bf16: the output's
    rounding may differ by one bf16 ulp, at most 2**-7 of the value, so
    rtol 8e-3 at the output's own scale (atol for values near zero)."""
    import torch
    return dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=2e-3, rtol=8e-3)


def _tol_text(dtype) -> str:
    t = _tol(dtype)
    return f"atol {t['atol']:g} + rtol {t['rtol']:g}"


def _attn_close(got, want, what, *, p_abs_v=None):
    """An attention kernel's output against another's at ``_tol``; for
    bf16 plus 2**-8 (p . |v|) where ``p_abs_v`` is given: K2 and K3 keep p
    in f32 (or round it unnormalised) where their plain versions, as the
    reference's oracles, round the normalised p to bf16 before P.V, which
    moves each p by at most 2**-8 of itself.  Returns (max abs error, its
    largest share of the limit); raises above the limit."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    tol = _tol(want.dtype)
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = tol["atol"] + tol["rtol"] * want.abs()
    if p_abs_v is not None:
        limit = limit + P_ROUNDING * p_abs_v.float()
    share = float((err / limit).max())
    if not share <= 1.0:        # also fails on a NaN
        raise AssertionError(f"{what}: max_abs_err {float(err.max()):.3e}, "
                             f"{share:.3f} of its limit")
    return float(err.max()), share


# --------------------------------------------------------------- serving ----

def requests(vocab: int, seed: int = 0):
    """12 prompts of 100-700 tokens; four share a 256-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 256)
    reqs = []
    for i, n in enumerate(rng.integers(100, 701, 12)):
        if i % 3 == 1:                  # 4 of 12 share the system prompt
            n = max(int(n), 300)
            toks = np.concatenate([prefix, rng.integers(0, vocab, n - 256)])
            reqs.append((toks, "sys"))
        else:
            reqs.append((rng.integers(0, vocab, int(n)), None))
    return reqs


def serve(params, cfg, plan, reqs, *, max_seq, slots, decode, device,
          schedule=(), paged=True, on_engine=None, disagg=False,
          devices=None, tp_prefill=False, prefill_devices=None):
    """Run one engine to completion (the pools layout where ``cfg`` has
    ``use_paged_decode`` and ``paged``; see serve/engine.py for the other
    layouts; with ``disagg`` a DisaggregatedEngine over ``devices``, its
    own default when None, with ``tp_prefill`` and ``prefill_devices``
    passed on).  ``schedule`` lists ``(step, plan or
    PlanDelta)`` re-plans, each applied before the engine step of that
    index; ``on_engine(b)`` runs on the new engine before its first step.
    Returns a dict: sorted outputs ``out`` and the same in the order the
    requests finished ``seq``, the engine ``b``, the K1 and K4 launches
    ``k1`` and ``k4`` of the run, ``cold_steps`` (decode steps that ran
    with cold pages mapped), ``wall`` seconds, ``step_s`` (seconds of each
    pure decode step) and ``moved`` (bytes each re-plan moved)."""
    import torch
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ssd as k4
    from repro_torch.serve.disagg import DisaggregatedEngine
    from repro_torch.serve.engine import ContinuousBatcher
    if disagg:
        b = DisaggregatedEngine(params, cfg, slots, max_seq, plan=plan,
                                devices=devices, tp_prefill=tp_prefill,
                                prefill_devices=prefill_devices)
    else:
        b = ContinuousBatcher(params, cfg, slots, max_seq, plan=plan,
                              paged=paged, device=device)
    if on_engine is not None:
        on_engine(b)
    for toks, key in reqs:
        b.submit(torch.as_tensor(toks), decode, prefix_key=key)
    results, cold_steps, step_s, moved = [], 0, [], []
    pending = sorted(schedule, key=lambda e: e[0])
    if b.device.type == "cuda":
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    while b.queue or b._jobs or any(b.active):
        while pending and pending[0][0] <= len(b.step_migration_bytes):
            moved.append(b.apply_plan(pending.pop(0)[1]))
        cold_mapped = b.pool is not None and any(
            b.ptable.tier[s][i] == 1 for s in range(b.B) if b.active[s]
            for i in range(b.ptable.n_pages[s]))
        d0, ts = b.decode_steps, time.perf_counter()
        if not b.step():
            break
        # step() reads the decoded tokens back, so the host clock is synced
        if b.decode_steps > d0:
            cold_steps += cold_mapped
            if b.step_prefill_tokens[-1] == 0:
                step_s.append(time.perf_counter() - ts)
        for i in range(b.B):
            if not b.active[i] and b.outputs[i]:
                results.append(tuple(b.outputs[i]))
                b.outputs[i] = []
    wall = time.perf_counter() - t0
    return {"out": sorted(results), "seq": results, "b": b,
            "k1": pd.paged_decode_attention.launches, "k4": k4.ssd.launches,
            "cold_steps": cold_steps, "wall": wall, "step_s": step_s,
            "moved": moved}


def check_serving():
    """Phase 3.  Returns the tiered run's numbers and what phase 4 needs to
    profile it."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              use_paged_decode=True)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    reqs = requests(cfg.vocab_size)
    windows = [128 + 16 * s for s in range(SLOTS)]          # 128..240 tokens
    tiered = PlacementPlan(hot_window=192, slot_hot_windows=windows,
                           page_tokens=PAGE, prefill_chunk_tokens=256)
    all_hot = dataclasses.replace(tiered, hot_window=MAX_SEQ,
                                  slot_hot_windows=[MAX_SEQ] * SLOTS)
    runs = {}
    for name, plan in (("tiered", tiered), ("all_hot", all_hot)):
        run = serve(params, cfg, plan, reqs, max_seq=MAX_SEQ, slots=SLOTS,
                    decode=DECODE, device="cuda")
        out, launches, cold_steps = run["out"], run["k1"], run["cold_steps"]
        wall, step_s = run["wall"], run["step_s"]
        cnt = run["b"].counters()
        if launches != cnt["decode_steps"] * cfg.num_layers:
            raise AssertionError(f"{name}: {launches} kernel launches for "
                                 f"{cnt['decode_steps']} decode steps x "
                                 f"{cfg.num_layers} layers")
        if len(out) != len(reqs) or any(len(o) != DECODE for o in out) or \
                any(not 0 <= t < cfg.vocab_size for o in out for t in o):
            raise AssertionError(f"{name}: malformed outputs")
        runs[name] = (out, cnt, launches, cold_steps, wall, step_s)
        print(f"serve {name}: {len(out)} requests, {cnt['decode_steps']} "
              f"decode steps, {launches} kernel launches, {cold_steps} decode "
              f"steps with cold pages mapped, page_copies "
              f"{cnt['page_copies']}, prefill compute/skipped tokens "
              f"{cnt['prefill_compute_tokens']}/"
              f"{cnt['prefill_skipped_tokens']}, wall {wall:.3f} s",
              flush=True)
    out_t, cnt_t, launches, cold_steps = runs["tiered"][:4]
    if out_t != runs["all_hot"][0]:
        raise AssertionError("tiered tokens differ from the all-hot run")
    if not (cnt_t["page_copies"] > 0 and cold_steps > 0
            and cnt_t["prefill_skipped_tokens"] > 0):
        raise AssertionError(f"tiered run did not exercise cold pages and "
                             f"prefix sharing: {cnt_t}")
    print("serve check: tiered tokens == all-hot tokens; launches == decode "
          f"steps x {cfg.num_layers}", flush=True)
    check_small_against_cpu()
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s", flush=True)
    return runs["tiered"], (params, cfg, tiered, reqs)


def check_layouts(params, cfg, tiered, reqs, pools_out, card):
    """Phase 3c: phase 3's requests on the other three engine layouts at
    the same width and weights: all-HBM (no plan), concat (one global hot
    window of 256 tokens) and paged-merged (phase 3's per-slot windows,
    paged=True without use_paged_decode).  All three run the plain
    _gqa_core over the same values, so their tokens must be identical, and
    the per-slot boundaries must move fewer bytes than the global one.
    The pools run (K1 against the f32-score _gqa_core in bf16) is compared
    token by token and not gated.  Then _paged_decode_core over the
    all-HBM run's dense cache, and generate.  Returns K1's launches in the
    _paged_decode_core step."""
    from repro_torch.runtime.plan import PlacementPlan
    t0 = time.perf_counter()
    dense = dataclasses.replace(cfg, use_paged_decode=False)
    layouts = {"all-HBM": (None, False),
               "concat": (PlacementPlan(hot_window=256, page_tokens=PAGE),
                          False),
               "paged-merged": (dataclasses.replace(
                   tiered, prefill_chunk_tokens=0), True)}
    runs = {}
    for name, (plan, paged) in layouts.items():
        run = runs[name] = serve(params, dense, plan, reqs, max_seq=MAX_SEQ,
                                 slots=SLOTS, decode=DECODE, device="cuda",
                                 paged=paged)
        decode_tokens = sum(len(o) - 1 for o in run["out"])
        print(f"layout {name}: {len(run['out'])} requests, "
              f"{run['b'].decode_steps} decode steps, sim_migration_bytes "
              f"{run['b'].sim_migration_bytes:.0f}, {run['k1']} K1 launches; "
              f"{decode_tokens / run['wall']:.1f} decode tokens/s over the "
              f"run ({run['wall']:.3f} s), mean pure decode step "
              f"{1e3 * float(np.mean(run['step_s'])):.3f} ms [{card}]",
              flush=True)
    base = runs["all-HBM"]["out"]
    if not base == runs["concat"]["out"] == runs["paged-merged"]["out"]:
        raise AssertionError("layouts: all-HBM, concat and paged-merged "
                             "tokens differ")
    if len(base) != len(reqs) or any(r["k1"] for r in runs.values()):
        raise AssertionError("layouts: malformed outputs or a K1 launch on "
                             "a dense layout")
    paged_b = runs["paged-merged"]["b"].sim_migration_bytes
    concat_b = runs["concat"]["b"].sim_migration_bytes
    if not 0 < paged_b < concat_b:
        raise AssertionError(f"layouts: paged-merged moved {paged_b} B, "
                             f"concat {concat_b} B")
    same = sum(a == b for o, p in zip(base, pools_out) for a, b in zip(o, p))
    total = sum(len(o) for o in base)
    print(f"layouts check: all-HBM == concat == paged-merged tokens; "
          f"paged-merged moved {paged_b:.0f} B < concat's {concat_b:.0f} B "
          f"({paged_b / concat_b:.3f} of it); pools (K1) against all-HBM "
          f"(_gqa_core): {same} of {total} tokens agree (sorted outputs), "
          f"{sum(o == p for o, p in zip(base, pools_out))} of {len(base)} "
          f"requests whole (not gated)", flush=True)
    core_launches = check_paged_decode_core(params, dense,
                                            runs["all-HBM"]["b"])
    del runs
    check_generate(params, dense)
    print(f"phase 3c took {time.perf_counter() - t0:.1f} s", flush=True)
    return core_launches


def check_paged_decode_core(params, cfg, b):
    """_paged_decode_core at full width: one decode step over the all-HBM
    run's dense cache (every slot at its final, stale length) with
    per-slot boundaries at half of each length, so cold pages exist.  The
    first layer's attention through K1 on the pool layout is held to the
    dense _gqa_core on the same q and cache at K1's bf16 limit plus the
    p rounding the plain version does (2**-8 p.|v|); the step's logits
    against the dense step's are printed, and every slot's argmax must
    agree where the dense top-1/top-2 margin exceeds twice the largest
    logit difference.  K1 runs once per layer."""
    import torch
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models import model
    from repro_torch.models.attention import (_gqa_core, _paged_decode_core,
                                              attn_bias)
    from repro_torch.models.layers import embed, rmsnorm
    pcfg = dataclasses.replace(cfg, use_paged_decode=True)
    lengths = b.lengths.clone()
    n = lengths.tolist()
    view = {"boundaries": [(x // 2) // PAGE * PAGE for x in n],
            "page_tokens": PAGE}
    tok = b.last_tok[:, None].clone()
    dense, _ = model.decode_step(params, cfg, tok, b.caches, lengths)
    reset_counts()
    paged = model.forward(params, pcfg, {"tokens": tok}, caches=b.caches,
                          cache_index=lengths, decode=True,
                          paged_view=view)[:, -1]
    torch.cuda.synchronize()
    launches = pd.paged_decode_attention.launches
    if launches != cfg.num_layers:
        raise AssertionError(f"_paged_decode_core: {launches} K1 launches "
                             f"for {cfg.num_layers} layers")
    # the first layer on identical inputs: its q, and the cache the step
    # just wrote
    B, KV, hd = b.B, cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    layer = params.layers[0]
    h = rmsnorm(embed(params.table, cfg, tok), layer.ln1, cfg.norm_eps)
    pos = lengths[:, None]
    q = layer.attn.qkv(cfg, h, pos)[0].reshape(B, 1, KV, G, hd)
    k_all, v_all = b.caches[0]["k"], b.caches[0]["v"]
    S = k_all.shape[1]
    k4d, v4d = k_all.view(B, S, KV, hd), v_all.view(B, S, KV, hd)
    want = _gqa_core(q, k4d, v4d, attn_bias(pos, torch.arange(
        S, device="cuda")), cfg.attn_softcap).reshape(B, KV * G, hd)
    got = _paged_decode_core(pcfg, q, k_all, v_all, lengths, view,
                             0).reshape(B, KV * G, hd)
    err, share = _attn_close(got, want, "_paged_decode_core layer 0",
                             p_abs_v=_p_abs_v_k3(q.reshape(B, KV * G, hd),
                                                 k4d, v4d, lengths + 1))
    diff = (paged.float() - dense.float()).abs()
    top2 = dense[:, :cfg.vocab_size].float().topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = paged[:, :cfg.vocab_size].argmax(-1) == \
        dense[:, :cfg.vocab_size].argmax(-1)
    if not bool((agree | (margin <= 2 * diff.max())).all()):
        raise AssertionError(f"_paged_decode_core: argmax differs where the "
                             f"margin {margin.tolist()} exceeds twice the "
                             f"logit difference {float(diff.max()):.3e}")
    tol = _tol(torch.bfloat16)
    within = bool((diff <= tol["atol"] + tol["rtol"]
                   * dense.float().abs()).all())
    print(f"paged decode core check: {B} slots, lengths {min(n)}-{max(n)}, "
          f"boundaries {view['boundaries']}; layer 0 through K1 == dense "
          f"_gqa_core, max_abs_err {err:.3e} ({share:.3f} of "
          f"{_limit_text(torch.bfloat16)}); logits max_abs_err "
          f"{float(diff.max()):.3e} ({'within' if within else 'outside'} "
          f"K1's {_tol_text(torch.bfloat16)}), argmax agrees in "
          f"{int(agree.sum())} of {B} slots (top-1/top-2 margins "
          f"{min(margin.tolist()):.3e}-{max(margin.tolist()):.3e}); "
          f"{launches} K1 launches", flush=True)
    return launches


def check_generate(params, cfg, n=8, prompt=256, tokens=32):
    """generate on ``n`` prompts of ``prompt`` random tokens, ``tokens``
    each, greedy: the same tokens in two calls, and the first token is the
    prefill's argmax."""
    import torch
    from repro_torch.serve.engine import generate, make_prefill
    g = torch.Generator(device="cuda").manual_seed(9)
    prompts = {"tokens": torch.randint(0, cfg.vocab_size, (n, prompt),
                                       generator=g, device="cuda")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = generate(params, cfg, prompts, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b = generate(params, cfg, prompts, tokens)
    last, _ = make_prefill(cfg)(params, prompts)
    first = last[:, :cfg.vocab_size].argmax(-1)
    if tuple(a.shape) != (n, tokens) or not torch.equal(a, b) or \
            not torch.equal(a[:, 0], first):
        raise AssertionError("generate: not deterministic, or its first "
                             "token is not the prefill's argmax")
    print(f"generate check: {n} prompts of {prompt} tokens, {tokens} greedy "
          f"tokens each, identical in two calls, first token == prefill "
          f"argmax; {n * tokens / wall:.1f} tokens/s (prefill included, "
          f"{wall:.3f} s)", flush=True)


def check_small_against_cpu():
    """The reduced fp32 model served on the card (kernel) and on the CPU
    (plain path) from the same parameters: identical tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              use_paged_decode=True)
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, cfg.vocab_size, 9)
    reqs = [(np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, 3 + i)]),
             "sys") for i in range(3)] + \
        [(rng.integers(0, cfg.vocab_size, 21), None)]
    plan = PlacementPlan(hot_window=8, slot_hot_windows=[4, 8],
                         page_tokens=4, prefill_chunk_tokens=8)
    got = {}
    for dev, p in (("cuda", params_gpu), ("cpu", params_cpu)):
        got[dev] = serve(p, cfg, plan, reqs, max_seq=48, slots=2, decode=10,
                         device=dev)
    if got["cuda"]["out"] != got["cpu"]["out"]:
        raise AssertionError("reduced fp32 model: card tokens differ from "
                             "the CPU's plain path")
    if got["cuda"]["k1"] != got["cuda"]["b"].decode_steps * cfg.num_layers \
            or got["cuda"]["cold_steps"] == 0:
        raise AssertionError("reduced run did not go through the kernel "
                             "with cold pages mapped")
    print("small check: reduced fp32 engine tokens on the card == on the CPU "
          "plain path", flush=True)


def check_planned_serving(params, cfg, reqs, card):
    """Phase 3b, Sentinel's loop on the card: profile the request stream
    (serve_trace_for), plan at 20 % of its peak KV on H100_COST, re-plan at
    10 % and diff the two into a PlanDelta, serve with the first plan and
    apply the delta a third of the way in, against an all-hot run.  Fails
    unless the tokens equal the all-hot run's, the delta demoted pages on
    the card, K1 ran once per decode step and layer, and the engine's
    integer counters equal predict_pool_counters' replay.  Returns the
    first plan and the profiled trace, for phase 3d."""
    import torch
    from repro_torch import runtime
    from repro_torch.models import kvcache, model
    from repro_torch.runtime import H100_COST, PlacementPlan, plan_delta
    from repro_torch.serve.engine import (predict_pool_counters,
                                          serve_trace_for)
    t0 = time.perf_counter()
    trace = serve_trace_for(cfg, [(len(t), DECODE, k) for t, k in reqs],
                            slots=SLOTS, block_tokens=PAGE, layer_group=8,
                            shared_prefix_tokens=256, params=params)
    peak = trace.peak_kv_bytes()
    print(f"planned serve profile: {len(trace.objects)} KV objects over "
          f"{trace.num_steps} trace steps, peak KV {peak:.0f} B, "
          f"{time.perf_counter() - t0:.3f} s on the host", flush=True)
    plans, pred_decode = {}, {}
    for name, frac in (("plan_a", 0.2), ("plan_b", 0.1)):
        t1 = time.perf_counter()
        p = runtime.plan(trace, H100_COST, frac * peak, objective="latency",
                         prefill_chunk_tokens=256)
        host_s = time.perf_counter() - t1
        plans[name] = p
        pred_decode[name] = float(np.mean(
            [t for i, t in enumerate(p.predicted_step_times)
             if not trace.prefill_tokens.get(i)]))
        print(f"planned serve {name}: {frac:.0%} of peak KV on "
              f"{H100_COST.name}, policy {p.policy}, page {p.page_tokens}, "
              f"hot window {p.hot_window}, slot windows "
              f"{p.slot_hot_windows}, lookahead {p.lookahead}; predicted "
              f"{1e3 * p.predicted_time:.4f} ms over "
              f"{len(p.predicted_step_times)} steps, pure-decode step "
              f"{1e3 * pred_decode[name]:.4f} ms, "
              f"{p.predicted_decode_throughput:.1f} tokens/s; planner "
              f"{host_s:.3f} s on the host", flush=True)
    plan_a = plans["plan_a"]
    row_bytes = kvcache.kv_token_bytes(
        cfg, torch.finfo(model.param_dtype(cfg)).bits // 8) * cfg.num_layers
    preq = [(tuple(int(x) for x in t), DECODE, None, k) for t, k in reqs]
    common = dict(slots=SLOTS, max_seq=MAX_SEQ, page_tokens=PAGE,
                  row_bytes=row_bytes, prefill_chunk_tokens=256)
    steps = len(predict_pool_counters(preq, plan_a, **common)
                ["step_migration_bytes"])
    at = steps // 3
    delta = plan_delta(plan_a, plans["plan_b"], step=at,
                       reason="smoke:shrink")
    if delta is None or "slot_hot_windows" not in delta.changes:
        raise AssertionError(f"the 10 % re-plan leaves the windows as they "
                             f"are: {delta}")
    schedule = [(at, delta)]
    pred = predict_pool_counters(preq, plan_a, plan_schedule=schedule,
                                 **common)
    run = serve(params, cfg, plan_a, reqs, max_seq=MAX_SEQ, slots=SLOTS,
                decode=DECODE, device="cuda", schedule=schedule)
    out, b, launches, cold_steps = run["out"], run["b"], run["k1"], \
        run["cold_steps"]
    wall, step_s, moved = run["wall"], run["step_s"], run["moved"]
    all_hot = PlacementPlan(hot_window=MAX_SEQ,
                            slot_hot_windows=[MAX_SEQ] * SLOTS,
                            page_tokens=PAGE, prefill_chunk_tokens=256)
    out_h = serve(params, cfg, all_hot, reqs, max_seq=MAX_SEQ, slots=SLOTS,
                  decode=DECODE, device="cuda")["out"]
    cnt = b.counters()
    print(f"planned serve: {len(out)} requests, {cnt['decode_steps']} "
          f"decode steps of {steps} engine steps, delta at step {at} "
          f"({sorted(delta.changes)}) moved {moved} B, page_copies "
          f"{cnt['page_copies']}, {cold_steps} decode steps with cold pages "
          f"mapped, {launches} K1 launches", flush=True)
    if out != out_h:
        raise AssertionError("planned serve: tiered tokens differ from the "
                             "all-hot run")
    if len(moved) != 1 or moved[0] <= 0 or cnt["page_copies"] <= 0 or \
            cold_steps <= 0:
        raise AssertionError(f"planned serve: the delta did not demote "
                             f"pages on the card ({moved}, {cnt})")
    if launches != cnt["decode_steps"] * cfg.num_layers:
        raise AssertionError(f"planned serve: {launches} K1 launches for "
                             f"{cnt['decode_steps']} decode steps x "
                             f"{cfg.num_layers} layers")
    got = {k: cnt[k] for k in ("sim_migration_bytes", "step_migration_bytes",
                               "page_copies", "admit_page_writes",
                               "tenant_hot_peak")}
    want = {"sim_migration_bytes": pred["migration_bytes"],
            "step_migration_bytes": pred["step_migration_bytes"],
            "page_copies": pred["page_copies"],
            "admit_page_writes": pred["admit_page_writes"],
            "tenant_hot_peak": pred["tenant_hot_peak"]}
    if got != want:
        raise AssertionError(f"planned serve: engine counters {got} != "
                             f"predict_pool_counters {want}")
    decode_tokens = sum(len(o) - 1 for o in out)
    print(f"planned serve check: tiered tokens == all-hot tokens; the delta "
          f"demoted {moved[0]} B; launches == decode steps x "
          f"{cfg.num_layers}; counters == predict_pool_counters", flush=True)
    print(f"planned serve time: {decode_tokens / wall:.1f} decode tokens/s "
          f"over the whole run ({wall:.3f} s, prefill included); mean pure "
          f"decode step {1e3 * float(np.mean(step_s)):.3f} ms over "
          f"{len(step_s)} steps, against H100_COST's predicted pure-decode "
          f"step {1e3 * pred_decode['plan_a']:.4f} ms "
          f"({plan_a.predicted_decode_throughput:.1f} tokens/s) [{card}]",
          flush=True)
    print(f"phase 3b took {time.perf_counter() - t0:.1f} s", flush=True)
    return plan_a, trace


# ---------------------------------------------------------- disaggregated ----

DISAGG_REPLAN_AT = 22            # phase 3d-2 re-homes slots before this step
# tests/test_disagg.py's prefill-heavy mix: (prompt, decode tokens)
HEAVY_MIX = [(480, 24), (512, 16), (448, 32), (500, 20)]


def _count_shard_forwards(b, counts):
    """Wrap ``b``'s decode step so each call appends the number of decode
    shards with an active slot: the sub-batch forwards the step runs, each
    one K1 launch a layer."""
    step = b._pool_decode_step

    def counted():
        counts.append(len({b.slot_devices[s] if b.slot_devices else 0
                           for s in range(b.B) if b.active[s]}))
        return step()
    b._pool_decode_step = counted


def _ledger(b) -> dict:
    c = b.counters()
    return {k: c[k] for k in ("edge_migration_bytes", "device_hot_peak",
                              "sim_migration_bytes", "step_migration_bytes",
                              "xdev_migration_bytes")}


def _pred_ledger(pred) -> dict:
    return {"edge_migration_bytes": pred["edge_migration_bytes"],
            "device_hot_peak": pred["device_hot_peak"],
            "sim_migration_bytes": pred["migration_bytes"],
            "step_migration_bytes": pred["step_migration_bytes"],
            "xdev_migration_bytes": pred["xdev_migration_bytes"]}


def _step_ms(run) -> float:
    return 1e3 * float(np.mean(run["step_s"]))


def check_disagg(params, cfg, reqs, plan_a, trace, card):
    """Phase 3d, the disaggregated engine at phase 3's width, weights and
    requests.  3d-1: one shard (devices=None: prefill and decode alias the
    card) on phase 3b's plan with prefill_chunk_tokens 0, against the
    colocated pools engine on the same plan: identical tokens, no repack,
    the mesh ledger and K1's launches exact.  3d-2: two decode shards
    aliased on the card (devices=[cuda:0] * 4) on a plan_serving plan for
    two shards, every slot re-homed to the other shard before engine step
    DISAGG_REPLAN_AT: every ledger edge, the per-shard hot peaks and the
    migration series equal predict_pool_counters', K1 once a layer per
    shard with an active slot; then the reduced fp32 scenario on the card
    against the CPU and a colocated run.  3d-3: price_disagg on H100_COST.
    3d-4: the serving CLI at full width.  Returns K1's launches on the two
    full-width paths."""
    import torch
    from repro_torch import runtime
    from repro_torch.runtime import H100_COST
    from repro_torch.serve.disagg import price_disagg
    from repro_torch.serve.engine import (predict_pool_counters,
                                          serve_trace_for)
    t0 = time.perf_counter()
    L = cfg.num_layers
    preq = [(tuple(int(x) for x in t), DECODE, None, k) for t, k in reqs]
    run = dict(max_seq=MAX_SEQ, slots=SLOTS, decode=DECODE, device="cuda")

    # 3d-1: one shard against the colocated pools engine
    plan1 = dataclasses.replace(plan_a, prefill_chunk_tokens=0)
    col = serve(params, cfg, plan1, reqs, **run)
    one = serve(params, cfg, plan1, reqs, disagg=True, **run)
    b1 = one["b"]
    common = dict(slots=SLOTS, max_seq=MAX_SEQ, page_tokens=b1.page_tokens,
                  row_bytes=b1._row_bytes, dense_admit=True)
    pred1 = predict_pool_counters(preq, plan1, **common)
    cnt1 = b1.counters()
    b1.mesh_table.check()
    print(f"disagg one shard: {b1.n_shards} shard, prefill "
          f"{b1.prefill_device} and decode {b1.decode_device}, "
          f"{cnt1['decode_steps']} decode steps, {one['k1']} K1 launches, "
          f"xdev {b1.xdev_migration_bytes:.0f} B (predicted "
          f"{pred1['xdev_migration_bytes']:.0f} B), sim_migration_bytes "
          f"{b1.sim_migration_bytes:.0f} (colocated "
          f"{col['b'].sim_migration_bytes:.0f}), repacks {cnt1['repacks']}",
          flush=True)
    if one["out"] != col["out"]:
        same = sum(a == b for o, p in zip(one["out"], col["out"])
                   for a, b in zip(o, p))
        raise AssertionError(f"disagg one shard: tokens differ from the "
                             f"colocated pools engine ({same} agree)")
    if not (cnt1["repacks"] == 0 and b1.xdev_migration_bytes > 0
            and b1.xdev_migration_bytes == pred1["xdev_migration_bytes"]
            and b1.sim_migration_bytes == col["b"].sim_migration_bytes
            and _ledger(b1) == _pred_ledger(pred1)):
        raise AssertionError(f"disagg one shard: ledger {_ledger(b1)} != "
                             f"predicted {_pred_ledger(pred1)}")
    if one["k1"] != cnt1["decode_steps"] * L:
        raise AssertionError(f"disagg one shard: {one['k1']} K1 launches "
                             f"for {cnt1['decode_steps']} decode steps")
    for name, r in (("colocated pools", col), ("disagg one shard", one)):
        tokens = sum(len(o) - 1 for o in r["out"])
        print(f"{name} time: {tokens / r['wall']:.1f} decode tokens/s over "
              f"the run ({r['wall']:.3f} s, prefill included), mean pure "
              f"decode step {_step_ms(r):.3f} ms over {len(r['step_s'])} "
              f"steps [{card}]", flush=True)
    print("disagg one shard check: tokens == colocated pools engine; "
          "repacks 0; xdev, sim_migration_bytes and the ledger == "
          f"predict_pool_counters(dense_admit=True); K1 == decode steps x {L}",
          flush=True)

    # 3d-2: two decode shards aliased on the card, re-homed mid-run
    plan2 = runtime.plan_serving(trace, H100_COST, 0.2 * trace.peak_kv_bytes(),
                                 objective="latency", decode_devices=2)
    moved_plan = dataclasses.replace(
        plan2, slot_devices=[1 - d for d in plan2.slot_devices])
    schedule = [(DISAGG_REPLAN_AT, moved_plan)]
    forwards = []
    two = serve(params, cfg, plan2, reqs, disagg=True,
                devices=[torch.device("cuda", 0)] * 4, schedule=schedule,
                on_engine=lambda e: _count_shard_forwards(e, forwards), **run)
    b2 = two["b"]
    common["page_tokens"] = b2.page_tokens
    pred2 = predict_pool_counters(preq, plan2, plan_schedule=schedule,
                                  **common)
    cnt2 = b2.counters()
    b2.mesh_table.check()
    edges = b2.edge_migration_bytes
    print(f"disagg two shards: groups {len(b2.prefill_devices)} + "
          f"{len(b2.decode_devices)} on {b2.decode_device}, page "
          f"{b2.page_tokens}, slot windows {plan2.slot_hot_windows}, "
          f"slot_devices {plan2.slot_devices} -> {moved_plan.slot_devices} "
          f"before step {DISAGG_REPLAN_AT} (moved {two['moved']} B); "
          f"{cnt2['decode_steps']} decode steps, {sum(forwards)} shard "
          f"forwards, {two['k1']} K1 launches; edges "
          f"{ {f'{s}->{d}': v for (s, d), v in edges.items()} }; hot peaks "
          f"{cnt2['device_hot_peak']}", flush=True)
    if not (b2.n_shards == 2 and len(b2.prefill_devices) == 2):
        raise AssertionError("disagg two shards: the groups are not 2 + 2")
    if _ledger(b2) != _pred_ledger(pred2):
        raise AssertionError(f"disagg two shards: ledger {_ledger(b2)} != "
                             f"predicted {_pred_ledger(pred2)}")
    if not (edges.get(("dev0", "dev1"), 0) > 0
            and edges.get(("dev1", "dev0"), 0) > 0 and cnt2["repacks"] == 0):
        raise AssertionError("disagg two shards: no slot was re-homed each "
                             "way, or a repack ran")
    if len(forwards) != cnt2["decode_steps"] or two["k1"] != sum(forwards) * L:
        raise AssertionError(f"disagg two shards: {two['k1']} K1 launches "
                             f"for {sum(forwards)} shard forwards x {L}")
    if len(two["out"]) != len(reqs) or \
            any(len(o) != DECODE for o in two["out"]):
        raise AssertionError("disagg two shards: malformed outputs")
    same = sum(a == b for o, p in zip(two["seq"], one["seq"])
               for a, b in zip(o, p))
    print(f"disagg two shards check: every edge, the hot peaks, "
          f"sim_migration_bytes and the step series == predict_pool_counters"
          f"(dense_admit=True, plan_schedule); K1 == shard forwards x {L}; "
          f"{same} of {sum(len(o) for o in one['seq'])} tokens agree with "
          f"the one-shard run (not gated: K1's split count follows the "
          f"batch it is given, here each shard's sub-batch, so bf16 partial "
          f"softmaxes merge in another order; phase 2 holds K1 to its plain "
          f"version at this sub-batch shape)", flush=True)
    tokens = sum(len(o) - 1 for o in two["out"])
    print(f"disagg two shards time: {tokens / two['wall']:.1f} decode "
          f"tokens/s over the run ({two['wall']:.3f} s, prefill included), "
          f"mean pure decode step {_step_ms(two):.3f} ms over "
          f"{len(two['step_s'])} steps, {_step_ms(two) / _step_ms(one):.3f} "
          f"times the one-shard step [{card}]", flush=True)
    check_disagg_small()

    # 3d-3: the planner's price of the trade on this card's cost model
    heavy = serve_trace_for(cfg, HEAVY_MIX, slots=4, layer_group=8)
    for name, tr in (("phase 3's trace", trace), ("prefill-heavy mix", heavy)):
        r = price_disagg(tr, H100_COST, 0.2 * tr.peak_kv_bytes())
        c, d = r["colocated"].tokens_per_s, r["disagg"].tokens_per_s
        print(f"price_disagg on {H100_COST.name}, {name}: colocated "
              f"{c:.1f} tokens/s, disaggregated {d:.1f} tokens/s "
              f"({d / c:.4f} of colocated: "
              f"{'disaggregation' if d >= c else 'colocation'} wins), KV "
              f"stream {r['edge_bytes']:.0f} B over the prefill->decode "
              f"edge", flush=True)

    # 3d-4: the serving CLI, as a user runs it
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-360m", "-n", "32"], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if res.returncode != 0 or "tok/s" not in res.stdout:
        raise AssertionError(f"serving CLI exited {res.returncode}: "
                             f"{res.stdout[-1000:]} {res.stderr[-2000:]}")
    print(f"serving CLI: {res.stdout.strip().splitlines()[-2]} (exit 0, "
          f"{time.perf_counter() - t1:.1f} s with start-up) [{card}]",
          flush=True)
    print(f"phase 3d took {time.perf_counter() - t0:.1f} s", flush=True)
    return one["k1"], two["k1"]


def check_disagg_small():
    """Phase 3d-2 on smollm-360m reduced in fp32 (tests/
    test_disagg_multidev.py's scenario: 4 slots of 32 tokens, page 4, six
    requests sharing a 9-token prefix, slots re-homed [0,0,1,1] ->
    [1,0,1,0] before step 3), with two decode shards aliased on the card
    and on the CPU from the same parameters: the card's tokens and ledger
    equal the CPU's, and its tokens a colocated all-hot run's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              use_paged_decode=True)
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    rng = np.random.default_rng(3)
    pref = rng.integers(0, cfg.vocab_size, 9)
    reqs = [(np.concatenate([pref, rng.integers(0, cfg.vocab_size, n - 9)]),
             "sys") for n in (12, 13, 11, 12, 14, 12)]
    plan = PlacementPlan(hot_window=16, page_tokens=4,
                         slot_hot_windows=[8] * 4, slot_devices=[0, 0, 1, 1])
    plan2 = dataclasses.replace(plan, slot_hot_windows=[4, 8, 4, 8],
                                slot_devices=[1, 0, 1, 0])
    run = dict(max_seq=32, slots=4, decode=6)
    got, forwards = {}, []
    for dev, p in ((torch.device("cuda", 0), params_gpu),
                   (torch.device("cpu"), params_cpu)):
        got[dev.type] = serve(
            p, cfg, plan, reqs, device=dev, disagg=True, devices=[dev] * 4,
            schedule=[(3, plan2)],
            on_engine=(lambda e: _count_shard_forwards(e, forwards))
            if dev.type == "cuda" else None, **run)
    col = serve(params_gpu, cfg, dataclasses.replace(
        plan, hot_window=32, slot_hot_windows=None, slot_devices=None), reqs,
        device="cuda", **run)
    g, c = got["cuda"], got["cpu"]
    if g["out"] != c["out"] or _ledger(g["b"]) != _ledger(c["b"]):
        raise AssertionError("disagg reduced: card tokens or ledger differ "
                             "from the CPU's")
    if g["out"] != col["out"]:
        raise AssertionError("disagg reduced: two-shard tokens differ from "
                             "the colocated all-hot run")
    edges = g["b"].edge_migration_bytes
    if not (g["k1"] == sum(forwards) * cfg.num_layers and
            edges.get(("dev0", "dev1"), 0) > 0):
        raise AssertionError(f"disagg reduced: {g['k1']} K1 launches for "
                             f"{sum(forwards)} shard forwards, edges {edges}")
    g["b"].mesh_table.check()
    print(f"disagg reduced check: fp32 two-shard tokens and ledger on the "
          f"card == on the CPU; tokens == colocated all-hot; {g['k1']} K1 "
          f"launches == shard forwards x {cfg.num_layers}", flush=True)


# ------------------------------------------------ the attention families ----

# phase 6: the families of ROADMAP item 9 the port serves beside smollm and
# zamba2 (arch, its attention layers' K1 uses a decode step)
FAMILIES = ("gemma2-2b", "gemma3-12b", "internlm2-1.8b",
            "granite-moe-3b-a800m", "deepseek-v2-lite-16b")
GEMMA3_MAX_SEQ, GEMMA2_MAX_SEQ = 2048, 8192
# fp32 card-vs-CPU logits, as phase 4's reduced check holds them
SMALL_LOGITS_TOL = dict(atol=1e-4, rtol=0.0)


def _record_forwards(on_logits):
    """Patch ``model.forward`` (the engine's, prefill_suffix's and
    prefill's) to hand each call's logits to ``on_logits``.  Returns the
    undo."""
    from repro_torch.models import model
    orig = model.forward

    def forward(*args, **kw):
        logits = orig(*args, **kw)
        on_logits(logits)
        return logits
    model.forward = forward
    return lambda: setattr(model, "forward", orig)


def _record_k1_options(seen):
    """Patch ``ops.paged_decode_attention`` (the attention layers' K1
    entry) to note each call's (window, softcap).  Returns the undo."""
    from repro_torch.kernels import ops
    orig = ops.paged_decode_attention

    def paged(*args, window=0, softcap_val=0.0, **kw):
        seen[(window, softcap_val)] = seen.get((window, softcap_val), 0) + 1
        return orig(*args, window=window, softcap_val=softcap_val, **kw)
    ops.paged_decode_attention = paged
    return lambda: setattr(ops, "paged_decode_attention", orig)


def _pools_counters(b, reqs, decode, max_seq, chunk):
    """The engine's integer books against predict_pool_counters' replay
    (a dense admission's where the engine admits so); raises on a
    difference."""
    from repro_torch.serve.engine import predict_pool_counters
    preq = [(tuple(int(x) for x in t), decode, None, k) for t, k in reqs]
    pred = predict_pool_counters(
        preq, b.plan, slots=b.B, max_seq=max_seq, page_tokens=b.page_tokens,
        row_bytes=b._row_bytes, prefill_chunk_tokens=chunk,
        dense_admit=not b._pool_prefill_ok)
    cnt = b.counters()
    got = {k: cnt[k] for k in ("sim_migration_bytes", "step_migration_bytes",
                               "page_copies", "admit_page_writes")}
    want = {"sim_migration_bytes": pred["migration_bytes"],
            "step_migration_bytes": pred["step_migration_bytes"],
            "page_copies": pred["page_copies"],
            "admit_page_writes": pred["admit_page_writes"]}
    if got != want:
        raise AssertionError(f"{b.cfg.name}: engine counters {got} != "
                             f"predict_pool_counters {want}")


def _n_k1_layers(cfg):
    """Layers whose decode reads the pools through K1 (MLA's latent stays
    dense: none of deepseek's)."""
    from repro_torch.models.kvcache import ATTN_KINDS
    return sum(cfg.layer_kind(l) in ATTN_KINDS for l in range(cfg.num_layers))


def small_family_requests(vocab):
    """Phase 3's small set: three prompts sharing a 9-token prefix, one of
    21 tokens."""
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, vocab, 9)
    return [(np.concatenate([sys_p, rng.integers(0, vocab, 3 + i)]), "sys")
            for i in range(3)] + [(rng.integers(0, vocab, 21), None)]


def check_families_small(device="cuda"):
    """Phase 6a: each family's reduced fp32 config served on ``device`` (the
    kernels) and on the CPU (the plain path) from the same parameters, 2
    slots of 32 tokens, page 4, hot windows 4 and 8: the pools with a
    prefill chunk of 8 (deepseek: the pools with chunk 0, and concat, a
    global hot window of 8).  Every forward's logits within
    SMALL_LOGITS_TOL, the tokens and the integer counters identical, K1
    once a decode step and attention layer on the card.  Returns K1's
    launches summed over the runs on ``device``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    counters = ("sim_migration_bytes", "step_migration_bytes", "page_copies",
                "admit_page_writes", "table_uploads", "prefill_compute_tokens",
                "prefill_skipped_tokens", "decode_steps")
    total_k1, worst = 0, 0.0
    for arch in FAMILIES:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  use_paged_decode=True)
        params_cpu = init_params(cfg, seed=0, device="cpu")
        params_dev = copy.deepcopy(params_cpu).to(device)
        reqs = small_family_requests(cfg.vocab_size)
        pools = PlacementPlan(hot_window=8, slot_hot_windows=[4, 8],
                              page_tokens=4, prefill_chunk_tokens=8)
        runs = {"pools": (cfg, pools, True)}
        if cfg.kv_lora_rank:
            runs = {"pools, chunk 0": (cfg, dataclasses.replace(
                        pools, prefill_chunk_tokens=0), True),
                    "concat": (dataclasses.replace(
                        cfg, use_paged_decode=False),
                        PlacementPlan(hot_window=8, page_tokens=4), False)}
        for name, (c, plan, paged) in runs.items():
            got = {}
            for dev, p in ((device, params_dev), ("cpu", params_cpu)):
                log = []
                undo = _record_forwards(lambda l: log.append(l.float().cpu()))
                try:
                    got[dev] = serve(p, c, plan, reqs, max_seq=32, slots=2,
                                     decode=10, device=dev, paged=paged)
                finally:
                    undo()
                got[dev]["log"] = log
            g, h = got[device], got["cpu"]
            if g["out"] != h["out"] or len(g["log"]) != len(h["log"]):
                raise AssertionError(f"reduced {arch} {name}: tokens on the "
                                     f"card differ from the CPU's")
            for a, b in zip(g["log"], h["log"]):
                worst = max(worst, float((a - b).abs().max()))
                torch.testing.assert_close(a, b, **SMALL_LOGITS_TOL)
            cg, ch = g["b"].counters(), h["b"].counters()
            if any(cg[k] != ch[k] for k in counters if k in ch):
                raise AssertionError(f"reduced {arch} {name}: counters "
                                     f"{cg} != the CPU's {ch}")
            want_k1 = g["b"].decode_steps * _n_k1_layers(c) if paged else 0
            if g["k1"] != want_k1 or (want_k1 and not g["cold_steps"]):
                raise AssertionError(f"reduced {arch} {name}: {g['k1']} K1 "
                                     f"launches (want {want_k1}), "
                                     f"{g['cold_steps']} cold decode steps")
            total_k1 += g["k1"]
            print(f"small family check {arch} ({name}): fp32 tokens and "
                  f"counters on the card == on the CPU, {len(g['log'])} "
                  f"forwards' logits within atol "
                  f"{SMALL_LOGITS_TOL['atol']:g}; K1 {g['k1']} launches",
                  flush=True)
    print(f"small family check: logits max_abs_err {worst:.3e} over the "
          f"five families' runs", flush=True)
    return total_k1


def family_requests(vocab, lengths, seed, shared=4, prefix=256):
    """Prompts of the given lengths; every third of the first ``3 *
    shared`` (``shared`` of them) opens with one ``prefix``-token prefix."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, prefix)
    reqs = []
    for i, n in enumerate(lengths):
        if i % 3 == 1 and i < 3 * shared:
            reqs.append((np.concatenate([sys_p, rng.integers(
                0, vocab, int(n) - prefix)]), "sys"))
        else:
            reqs.append((rng.integers(0, vocab, int(n)), None))
    return reqs


def serve_family(arch, card, *, lengths, seed, max_seq, windows,
                 layouts=("tiered", "all_hot"), chunk=256, shared=4,
                 prefix=256, cli=None, layers=None):
    """One family at full width and depth (bf16, random weights from seed
    0) on the card: ``layouts`` are "tiered" and "all_hot" (the pools, per
    slot hot ``windows``, page 16, prefill chunk ``chunk``) or "all-HBM"
    and "concat" (a global hot window of ``windows[0]`` tokens); ``shared``
    prompts open with one ``prefix``-token prefix; ``layers`` cuts the
    depth (default: the config's).  Every run's tokens must equal the
    first's; on the pools K1 runs once a
    decode step and attention layer and the counters equal
    predict_pool_counters'; elsewhere K1 never runs.  Prints prefill ms
    per admission, decode tokens/s, the mean pure-decode step, peak
    device memory and a profile of decode steps.  Returns the first run's
    K1 launches, the (window, softcap) pairs K1 took in it, its largest
    |logit| and the engine's KV bytes a token."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    t0 = time.perf_counter()
    pools = layouts[0] == "tiered"
    cfg = dataclasses.replace(get_config(arch), use_paged_decode=pools)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0)
    n_params = sum(p.numel() for p in params.parameters())
    reqs = family_requests(cfg.vocab_size, lengths, seed, shared, prefix)
    if pools:
        tiered = PlacementPlan(hot_window=max(windows), page_tokens=PAGE,
                               slot_hot_windows=list(windows),
                               prefill_chunk_tokens=chunk)
        plans = {"tiered": tiered, "all_hot": dataclasses.replace(
            tiered, hot_window=max_seq, slot_hot_windows=[max_seq] * SLOTS)}
    else:
        plans = {"all-HBM": None, "concat": PlacementPlan(
            hot_window=windows[0], page_tokens=PAGE)}
    admit_ms, seen, biggest = [], {}, []

    def time_admissions(b):
        name = "_run_chunk" if b._pool_prefill_ok else "_admit_dense"
        admit = getattr(b, name)

        def timed(*args):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            admit(*args)
            torch.cuda.synchronize()
            admit_ms.append(1e3 * (time.perf_counter() - ts))
        setattr(b, name, timed)

    def note_logits(logits):
        m = logits.abs().amax()
        biggest[:] = [m if not biggest else torch.maximum(biggest[0], m)]

    runs, n_k1 = {}, _n_k1_layers(cfg)
    for i, name in enumerate(layouts):
        undo = [_record_k1_options(seen), _record_forwards(note_logits)] \
            if i == 0 else []
        try:
            run = runs[name] = serve(
                params, cfg, plans[name], reqs, max_seq=max_seq, slots=SLOTS,
                decode=DECODE, device="cuda", paged=pools,
                on_engine=time_admissions if i == 0 else None)
        finally:
            for u in undo:
                u()
        b = run["b"]
        steps = b.decode_steps
        if len(run["out"]) != len(reqs) or \
                any(len(o) != DECODE for o in run["out"]) or \
                any(not 0 <= t < cfg.vocab_size
                    for o in run["out"] for t in o):
            raise AssertionError(f"{arch} {name}: malformed outputs")
        want_k1 = steps * n_k1 if pools else 0
        if run["k1"] != want_k1:
            raise AssertionError(f"{arch} {name}: {run['k1']} K1 launches "
                                 f"for {steps} decode steps x {n_k1}")
        if pools:
            _pools_counters(b, reqs, DECODE, max_seq, chunk)
        cnt = b.counters()
        if name in ("tiered", "concat") and not b.sim_migration_bytes > 0 \
                or name == "tiered" and not run["cold_steps"]:
            raise AssertionError(f"{arch} {name}: nothing moved to host "
                                 f"memory ({cnt})")
        print(f"{arch} serve {name}: {len(run['out'])} requests, {steps} "
              f"decode steps, K1 {run['k1']} = {steps} x {n_k1}, page_copies "
              f"{cnt.get('page_copies', 0)}, {run['cold_steps']} decode steps "
              f"with cold pages mapped, sim_migration_bytes "
              f"{b.sim_migration_bytes:.0f}, KV {b._row_bytes:.0f} B a token, "
              f"wall {run['wall']:.3f} s", flush=True)
        run["row_bytes"] = b._row_bytes
        del b
        run.pop("b")
        gc.collect()         # the timing wrapper holds the engine in a cycle
    first, rest = runs[layouts[0]], [runs[n] for n in layouts[1:]]
    if any(r["out"] != first["out"] for r in rest):
        raise AssertionError(f"{arch}: {layouts[0]} tokens differ from "
                             f"{layouts[1:]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    decode_tokens = sum(len(o) - 1 for o in first["out"])
    lens = [len(t) for t, _ in reqs]
    books = "; counters == predict_pool_counters" if pools else ""
    print(f"{arch} serve check: {' == '.join(layouts)} tokens; K1 == decode "
          f"steps x {n_k1}{books}; prompts {min(lens)}-{max(lens)} tokens, "
          f"{cfg.num_layers} layers, {n_params / 1e9:.2f} B parameters",
          flush=True)
    print(f"{arch} serve time: prefill {float(np.mean(admit_ms)):.1f} ms per "
          f"admission (mean of {len(admit_ms)} "
          f"{'chunks' if pools else 'admissions'}, "
          f"{min(admit_ms):.1f}-{max(admit_ms):.1f}); "
          f"{decode_tokens / first['wall']:.1f} decode tokens/s over the "
          f"whole {layouts[0]} run ({first['wall']:.3f} s, prefill "
          f"included); mean pure decode step "
          f"{1e3 * float(np.mean(first['step_s'])):.3f} ms over "
          f"{len(first['step_s'])} steps of {SLOTS} slots; peak device "
          f"memory {peak:.1f} GB [{card}]", flush=True)
    # budgets that keep the first slot decoding until the last is admitted
    profile_decode(params, cfg, plans[layouts[-1] if not pools else "tiered"],
                   reqs, card, steps=4, max_seq=max_seq, paged=pools,
                   what=f"{arch} decode",
                   decode=max_seq - max(len(t) for t, _ in reqs[:SLOTS]) - 1)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if cli is not None:
        cli()
    print(f"{arch} phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return first["k1"], seen, float(biggest[0]) if biggest else 0.0, \
        first["row_bytes"]


def run_serving_cli(arch, n):
    """The serving CLI at full width, as a user runs it; must exit 0."""
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "-n", str(n)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if res.returncode != 0 or "tok/s" not in res.stdout:
        raise AssertionError(f"serving CLI ({arch}) exited "
                             f"{res.returncode}: {res.stdout[-1000:]} "
                             f"{res.stderr[-2000:]}")
    return res.stdout.strip().splitlines()[-2], time.perf_counter() - t1


def check_families(card):
    """Phase 6, the attention families: 6a the reduced fp32 configs on the
    card against the CPU; 6b gemma3-12b, 6c gemma2-2b (and the serving CLI
    on it), 6d internlm2-1.8b and granite-moe-3b on the pools, 6e
    deepseek-v2-lite on all-HBM and concat, each at full width and depth
    (6b-6e on a quarter of their period layers, DEPTH_PARTS, for the
    script's clock; the CLI at full depth).  Returns K1's launches by
    path."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    k1 = {"reduced families, card == CPU (phase 6a)": check_families_small()}
    rng = np.random.default_rng(21)
    # 6b: 12 prompts of 300-1800 tokens, four over 1024 (the LOCAL window
    # bites in pool prefill and in K1), four sharing a 256-token prefix
    g3 = [int(n) for n in rng.integers(300, 1025, 8)] + \
        [int(n) for n in rng.integers(1100, 1801, 4)]
    g3 = [g3[i] for i in rng.permutation(12)]
    launches, seen, _, _ = serve_family(
        "gemma3-12b", card, lengths=g3, seed=22, max_seq=GEMMA3_MAX_SEQ,
        windows=[256 + 32 * s for s in range(SLOTS)],
        layers=_half_depth(get_config("gemma3-12b"), DEPTH_PARTS).num_layers)
    if set(seen) != {(0, 0.0), (1024, 0.0)}:
        raise AssertionError(f"gemma3-12b: K1 took {seen}")
    k1["gemma3-12b serving, pools (phase 6b)"] = launches
    # 6c: 8 prompts of 500-6000 tokens, two over 4096 (the window bites)
    g2 = [int(n) for n in rng.integers(500, 4001, 6)] + [4600, 6000]
    g2 = [g2[i] for i in rng.permutation(8)]
    cli = {}
    launches, seen, biggest, _ = serve_family(
        "gemma2-2b", card, lengths=g2, seed=23, max_seq=GEMMA2_MAX_SEQ,
        windows=[512 + 64 * s for s in range(SLOTS)],
        layers=_half_depth(get_config("gemma2-2b"), DEPTH_PARTS).num_layers,
        cli=lambda: cli.update(line=run_serving_cli("gemma2-2b", 16)))
    if set(seen) != {(0, 50.0), (4096, 50.0)}:
        raise AssertionError(f"gemma2-2b: K1 took {seen}, not softcap 50 "
                             f"in every launch with and without the window")
    if not 0 < biggest <= 30.0:
        raise AssertionError(f"gemma2-2b: a logit of {biggest} past the "
                             f"final softcap of 30")
    print(f"gemma2-2b check: every K1 launch with softcap 50 ({seen}); "
          f"largest |logit| {biggest:.4f} <= 30", flush=True)
    line, secs = cli["line"]
    print(f"serving CLI gemma2-2b: {line} (exit 0, {secs:.1f} s with "
          f"start-up) [{card}]", flush=True)
    k1["gemma2-2b serving, pools (phase 6c)"] = launches
    # 6d: phase 3's 12 requests (100-700 tokens, four sharing 256), at
    # a quarter of their depth, for the script's time limit
    lens = [len(t) for t, _ in requests(49152)]
    for arch in ("internlm2-1.8b", "granite-moe-3b-a800m"):
        launches, seen, _, _ = serve_family(
            arch, card, lengths=lens, seed=24, max_seq=MAX_SEQ,
            windows=[128 + 16 * s for s in range(SLOTS)],
            layers=get_config(arch).num_layers // DEPTH_PARTS)
        k1[f"{arch} serving, pools (phase 6d)"] = launches
    # 6e: 12 prompts of 100-500 tokens (one dense admission prefill each,
    # within the MoE group rule), the latent tiered to pinned host memory,
    # on a quarter of its depth, for the script's time limit
    n_ds = _half_depth(get_config("deepseek-v2-lite-16b"),
                       DEPTH_PARTS).num_layers
    launches, _, _, row_bytes = serve_family(
        "deepseek-v2-lite-16b", card,
        lengths=[int(n) for n in rng.integers(100, 501, 12)], seed=25,
        max_seq=MAX_SEQ, windows=[256], layouts=("all-HBM", "concat"),
        shared=0, layers=n_ds)
    _assert_no_launch("deepseek-v2-lite serving")
    if launches != 0 or row_bytes != n_ds * 576 * 2:
        raise AssertionError(f"deepseek: {launches} K1 launches, "
                             f"{row_bytes} latent bytes a token")
    print(f"deepseek-v2-lite check: concat == all-HBM tokens; no kernel "
          f"launch; latent {row_bytes:.0f} B a token == {n_ds} x 576 x 2",
          flush=True)
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s", flush=True)
    return k1


# ------------------------------------------------- F1: stale slot length ----

# ROADMAP F1: a slot that finished at max_seq keeps its stale length, and
# the lockstep decode still writes its row there, at index max_seq
F1_REQUESTS = [(28, 5), (8, 12)]      # (prompt tokens, decode tokens)
F1_MAX_SEQ = 32


def _run_budgets(b, reqs):
    """Submit (prompt, decode tokens) pairs and run the engine to its end;
    returns the sorted outputs."""
    import torch
    for toks, d in reqs:
        b.submit(torch.as_tensor(toks), d)
    return sorted(tuple(o) for o in b.run())


def check_f1():
    """Phase 3c-F1: F1's case on the card.  smollm-360m and
    deepseek-v2-lite (its MLA latent) reduced in fp32, 2 slots of 32
    tokens, prompts of 28 and 8 tokens decoding 5 and 12, on all-HBM,
    concat and paged-merged (hot windows 4 and 8, page 4): the first slot
    finishes at max_seq and decodes on at index 32 for 7 steps, a write
    the port drops.  Tokens and integer counters == the CPU's, no kernel
    launch, and the card raises no device assert (each run ends in a
    synchronize)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    from repro_torch.serve.engine import ContinuousBatcher
    t0 = time.perf_counter()
    plan = PlacementPlan(hot_window=16, slot_hot_windows=[4, 8],
                         page_tokens=4)
    layouts = {"all-HBM": (None, False), "concat": (plan, False),
               "paged-merged": (plan, True)}
    counters = ("sim_migration_bytes", "step_migration_bytes",
                "table_version", "prefill_compute_tokens", "decode_steps")
    for arch in ("smollm-360m", "deepseek-v2-lite-16b"):
        cfg = get_config(arch).reduced()
        params_cpu = init_params(cfg, seed=0, device="cpu")
        params_dev = copy.deepcopy(params_cpu).to("cuda")
        rng = np.random.default_rng(40)
        reqs = [(rng.integers(0, cfg.vocab_size, p), d)
                for p, d in F1_REQUESTS]
        for name, (pl, paged) in layouts.items():
            got = {}
            for dev, p in (("cuda", params_dev), ("cpu", params_cpu)):
                b = ContinuousBatcher(p, cfg, 2, F1_MAX_SEQ, plan=pl,
                                      paged=paged, device=dev)
                reset_counts()
                out = _run_budgets(b, reqs)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    _assert_no_launch(f"F1 {arch} {name}")
                got[dev] = (out, b)
            (out, b), (out_cpu, b_cpu) = got["cuda"], got["cpu"]
            if out != out_cpu or sorted(len(o) for o in out) != \
                    sorted(d for _, d in F1_REQUESTS):
                raise AssertionError(f"F1 {arch} {name}: card tokens {out} "
                                     f"!= the CPU's {out_cpu}")
            c, h = b.counters(), b_cpu.counters()
            if any(c[k] != h[k] for k in counters):
                raise AssertionError(f"F1 {arch} {name}: counters {c} != "
                                     f"the CPU's {h}")
            if b._host_len[0] != F1_MAX_SEQ or b.active[0]:
                raise AssertionError(f"F1 {arch} {name}: slot 0 did not "
                                     f"finish at max_seq ({b._host_len})")
        print(f"F1 check {arch} reduced: all-HBM, concat and paged-merged "
              f"on the card == on the CPU (tokens, counters); the slot "
              f"finished at {F1_MAX_SEQ} decoded on for "
              f"{F1_REQUESTS[1][1] - F1_REQUESTS[0][1]} steps, no device "
              f"assert, no kernel launch", flush=True)
    print(f"phase 3c-F1 took {time.perf_counter() - t0:.1f} s", flush=True)


# ----------------------------------------- the recurrent families (phase 7) --

# phase 7: xlstm-1.3b (mLSTM and sLSTM) and the paper's lstm-ptb, which hold
# O(1) state a slot and no KV: no kernel of K1-K4 runs on their paths
RECURRENT = ("xlstm-1.3b", "lstm-ptb")
# the reduced xlstm's fp32 results are ill-conditioned (the mLSTM's
# normaliser max(|n.q|, exp(-m)) amplifies rounding): two fp32 runs of it
# each lie up to 1e-4 of a tensor's largest |value| from float64
# (tests/test_torch_xlstm.py), so the card and the CPU are held to each
# other within twice that, where it is wider than the absolute limit
XLSTM_REL = 2e-4
XLSTM_CHUNK = 64                      # the mLSTM's chunk on the card
XLSTM_MAX_SEQ, LSTM_MAX_SEQ = 2048, 512
# B x S of phase 7b's training step: 1024 tokens; at 2048 a step took
# 33.6-44.3 s on H100 hosts with a slower CPU (the sLSTM's steps and their
# backward are eager launches), leaving the script 107 s inside its limit
XLSTM_TRAIN = (1, 1024)
# phase 7b serves and trains xlstm-1.3b on 16 of its 48 layers (2 of 6
# periods) at full width, cut for the script's time limit (at full depth
# it took 120.4 s of an 813 s run, at 24 layers 68.3-75.5 s of runs of
# 1047.1-1188.8 s, on H100 80GB HBM3 hosts at 700 W); its CLIs run the
# full depth.  Not fewer: on one period (8 layers) offload keeps the one
# block's carry and its peak is not below full's
XLSTM_LAYERS = 16
XLSTM_PROFILE_S = 128                 # the sequence its plan profiles
LSTM_TRAIN = (20, 35)                 # B x BPTT, Zaremba et al.'s medium
LSTM_TRAIN_STEPS = 6


def _close_rel(got, want, tol, rel, what):
    """``got`` within ``tol`` of ``want``, its absolute part widened to
    ``rel`` x the largest |want| where that is larger; returns the max
    |difference|."""
    import torch
    atol = max(tol["atol"], rel * float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=atol, rtol=tol.get("rtol", 0),
                               msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


def _recurrent_launches(what):
    """Every kernel's launches since the last reset_counts, which must be
    0 on these paths."""
    got = _launch_counts()
    _assert_no_launch(what)
    return got


def check_recurrent_small(note):
    """Phase 7a: xlstm-1.3b and lstm-ptb reduced in fp32, parameters from
    seed 0 on the CPU and the same values on the card.  Serving: three
    requests (8 + 5, 17 + 7 and 7 + 4 tokens), 2 slots of 32, on all-HBM,
    concat, paged-merged and the pools (hot windows 4 and 8, page 4):
    every forward's logits within SMALL_LOGITS_TOL (xlstm: or XLSTM_REL of
    the largest |logit|), tokens and integer counters == the CPU's, and
    the tiered layouts' tokens == all-HBM's.  Training: the loss and every
    gradient of the full mode == the CPU's (SMALL_LOSS_TOL,
    SMALL_GRAD_TOL; xlstm's gradients also XLSTM_REL of a leaf's largest
    |value|), and each mode's loss and gradient norm at MI 1 and 2 == full's
    on the card (MODE_LOSS_RTOL, MODE_GNORM_RTOL), all finite.  Then the
    chunked mLSTM (chunks of 64) against the sequential scan on the card at
    xlstm-1.3b's head shape (B 1, S 512, 4 heads, Dk 512, Dv 1024), from
    the empty state and carried on, each timed.  ``note(what)`` reads (and
    resets) the kernels' launches of what ran."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import offload
    from repro_torch.kernels import ref
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.runtime.plan import PlacementPlan
    from repro_torch.serve.engine import ContinuousBatcher
    t0 = time.perf_counter()
    counters = ("sim_migration_bytes", "step_migration_bytes", "page_copies",
                "admit_page_writes", "table_uploads", "table_version",
                "prefill_compute_tokens", "decode_steps")
    reset_counts()
    for arch in RECURRENT:
        cfg = get_config(arch).reduced()
        rel = XLSTM_REL if arch == "xlstm-1.3b" else 0.0
        params_cpu = init_params(cfg, seed=0, device="cpu")
        params_dev = copy.deepcopy(params_cpu).to("cuda")
        rng = np.random.default_rng(3)
        reqs = [(rng.integers(0, cfg.vocab_size, p), d)
                for p, d in ((8, 5), (17, 7), (7, 4))]
        plan = PlacementPlan(hot_window=16, slot_hot_windows=[4, 8],
                             page_tokens=4)
        layouts = {"all-HBM": (None, False, False),
                   "concat": (plan, False, False),
                   "paged-merged": (plan, True, False),
                   "pools": (plan, True, True)}
        outs, err = {}, 0.0
        for name, (pl, paged, pools) in layouts.items():
            c = dataclasses.replace(cfg, use_paged_decode=pools)
            got = {}
            for dev, p in (("cuda", params_dev), ("cpu", params_cpu)):
                log = []
                undo = _record_forwards(lambda l: log.append(l.float().cpu()))
                try:
                    b = ContinuousBatcher(p, c, 2, 32, plan=pl, paged=paged,
                                          device=dev)
                    got[dev] = (_run_budgets(b, reqs), b, log)
                finally:
                    undo()
            (out, b, log), (out_cpu, b_cpu, log_cpu) = got["cuda"], \
                got["cpu"]
            if out != out_cpu or len(log) != len(log_cpu):
                raise AssertionError(f"reduced {arch} {name}: card tokens "
                                     f"{out} != the CPU's {out_cpu}")
            for a, h in zip(log, log_cpu):
                err = max(err, _close_rel(a, h, SMALL_LOGITS_TOL, rel,
                                          f"reduced {arch} {name} logits"))
            cg, ch = b.counters(), b_cpu.counters()
            if any(cg[k] != ch[k] for k in counters if k in ch):
                raise AssertionError(f"reduced {arch} {name}: counters {cg} "
                                     f"!= the CPU's {ch}")
            outs[name] = out
        if any(o != outs["all-HBM"] for o in outs.values()):
            raise AssertionError(f"reduced {arch}: the layouts' tokens "
                                 f"differ: {outs}")
        print(f"small recurrent check {arch} (fp32): all-HBM, concat, "
              f"paged-merged and pools on the card == on the CPU (tokens, "
              f"counters), tiered == all-HBM tokens; logits max_abs_err "
              f"{err:.3e}", flush=True)

        # training: full on the card against the CPU, then every mode
        # against full on the card
        cpu = init_params(cfg, seed=0, device="cpu", requires_grad=True)
        gpu = copy.deepcopy(cpu).to("cuda")
        toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 17))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:])}
        res, gerr = {}, 0.0
        for mode in MODES:
            for mi in (1, 2):
                kw = offload.loss_kwargs(offload.SentinelConfig(
                    mode=mode, mi_periods=mi))
                sides = (("cuda", gpu), ("cpu", cpu)) if mode == "full" \
                    else (("cuda", gpu),)
                for dev, p in sides:
                    loss = loss_fn(p, cfg, {k: v.to(dev) for k, v in
                                            batch.items()}, **kw)
                    grads = torch.autograd.grad(loss, list(p.parameters()))
                    if not (torch.isfinite(loss) and all(
                            torch.isfinite(g).all() for g in grads)):
                        raise AssertionError(f"reduced {arch} {mode} mi {mi} "
                                             f"on {dev}: not finite")
                    gn = float(torch.sqrt(sum(g.double().square().sum()
                                              for g in grads)))
                    res[dev, mode, mi] = (float(loss.detach()), gn,
                                          [g.cpu() for g in grads])
        what = f"reduced {arch} full"
        lc, gc_, g_cpu = res["cpu", "full", 1]
        lg, gg, g_dev = res["cuda", "full", 1]
        _close_rel(torch.tensor(lg), torch.tensor(lc), SMALL_LOSS_TOL, 0.0,
                   f"{what} loss")
        for a, h in zip(g_dev, g_cpu):
            gerr = max(gerr, _close_rel(a, h, SMALL_GRAD_TOL, rel,
                                        f"{what} gradient"))
        for (dev, mode, mi), (l, gn, _) in res.items():
            if dev == "cuda" and not (
                    abs(l - lg) <= MODE_LOSS_RTOL * abs(lg)
                    and abs(gn - gg) <= MODE_GNORM_RTOL * gg):
                raise AssertionError(f"reduced {arch} {mode} mi {mi}: loss "
                                     f"{l}, gradient norm {gn}; full's {lg}, "
                                     f"{gg}")
        print(f"small recurrent training {arch} (fp32): full on the card == "
              f"on the CPU (loss {lg:.6f} / {lc:.6f}; gradients "
              f"max_abs_err {gerr:.3e}); every mode at MI 1 and 2 == full's "
              f"loss and gradient norm on the card (limits "
              f"{MODE_LOSS_RTOL:g}, {MODE_GNORM_RTOL:g}), all finite",
              flush=True)

    # the chunked mLSTM against the sequential scan at the full head shape
    g = torch.Generator(device="cuda").manual_seed(12)
    B, S, H, Dk, Dv = 1, 512, 4, 512, 1024
    q = torch.randn(B, S, H, Dk, generator=g, device="cuda")
    k = torch.randn(B, S, H, Dk, generator=g, device="cuda")
    v = torch.randn(B, S, H, Dv, generator=g, device="cuda")
    li = torch.randn(B, S, H, generator=g, device="cuda") * 2
    lf = torch.nn.functional.logsigmoid(
        torch.randn(B, S, H, generator=g, device="cuda") + 1)
    ms = {}
    for name, fn in (("sequential", ref.mlstm_ref),
                     ("chunked", lambda *a, **kw: ref.mlstm_chunked_ref(
                         *a, chunk=XLSTM_CHUNK, **kw))):
        fn(q[:, :64], k[:, :64], v[:, :64], li[:, :64], lf[:, :64])
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = fn(q, k, v, li, lf)
        torch.cuda.synchronize()
        ms[name] = (1e3 * (time.perf_counter() - ts), out)
    (h0, s0), (h1, s1) = ms["sequential"][1], ms["chunked"][1]
    chunk_tol = dict(atol=2e-4, rtol=0.0)
    e0 = _close_rel(h1, h0, chunk_tol, 1e-4, "chunked mLSTM")
    h0c = ref.mlstm_ref(q, k, v, li, lf, state=s0)[0]
    h1c = ref.mlstm_chunked_ref(q, k, v, li, lf, chunk=XLSTM_CHUNK,
                                state=s1)[0]
    e1 = _close_rel(h1c, h0c, chunk_tol, 1e-4, "chunked mLSTM, carried")
    note("phase 7a")
    print(f"mLSTM check: chunks of {XLSTM_CHUNK} == the sequential scan on "
          f"the card at B {B}, S {S}, H {H}, Dk {Dk}, Dv {Dv} (max_abs_err "
          f"{e0:.3e} of |h| up to {float(h0.abs().max()):.1f}; carried on "
          f"{e1:.3e}; limit 2e-4 or 1e-4 of the largest |h|); sequential "
          f"{ms['sequential'][0]:.1f} ms, chunked {ms['chunked'][0]:.1f} ms "
          f"(host clock, eager); phase 7a took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def serve_recurrent(arch, card, note, *, lengths, seed, max_seq,
                    layers=None):
    """One recurrent config at full width and depth (bf16, random weights
    from seed 0) on all-HBM, then on the pools (per-slot windows of 128 to
    240 tokens, page 16: the pages carry no KV, so nothing moves): 12
    requests of ``lengths`` prompt tokens, 32 decode tokens each.  The
    tokens must be identical, the pools' counters == predict_pool_counters
    (dense admission, 0 migration bytes).  Prints ms an admission, decode
    tokens/s, the mean pure-decode step, peak device memory and a profile
    of three decode steps of 8 slots.  ``layers`` cuts the depth (default:
    the config's); ``note`` reads each run's kernel launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    t0 = time.perf_counter()
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0)
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, cfg.vocab_size, n), None) for n in lengths]
    pools = PlacementPlan(hot_window=240, page_tokens=PAGE,
                          slot_hot_windows=[128 + 16 * s
                                            for s in range(SLOTS)])
    runs, admit_ms = {}, []

    def time_admissions(b):
        admit = b._admit_dense

        def timed(*args):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            admit(*args)
            torch.cuda.synchronize()
            admit_ms.append(1e3 * (time.perf_counter() - ts))
        b._admit_dense = timed

    for name, (c, plan, paged) in (
            ("all-HBM", (cfg, None, False)),
            ("pools", (dataclasses.replace(cfg, use_paged_decode=True),
                       pools, True))):
        run = runs[name] = serve(
            params, c, plan, reqs, max_seq=max_seq, slots=SLOTS,
            decode=DECODE, device="cuda", paged=paged,
            on_engine=time_admissions if name == "all-HBM" else None)
        note(f"{arch} serving, {name}")
        b = run["b"]
        if len(run["out"]) != len(reqs) or \
                any(len(o) != DECODE for o in run["out"]) or \
                any(not 0 <= t < cfg.vocab_size
                    for o in run["out"] for t in o):
            raise AssertionError(f"{arch} {name}: malformed outputs")
        if name == "pools":
            if b._pool_prefill_ok or b.sim_migration_bytes:
                raise AssertionError(f"{arch} pools: {b.counters()}")
            _pools_counters(b, reqs, DECODE, max_seq, 0)
        print(f"{arch} serve {name}: {len(run['out'])} requests, "
              f"{b.decode_steps} decode steps, page_copies "
              f"{b.counters().get('page_copies', 0)}, sim_migration_bytes "
              f"{b.sim_migration_bytes:.0f}, wall {run['wall']:.3f} s",
              flush=True)
    if runs["pools"]["out"] != runs["all-HBM"]["out"]:
        raise AssertionError(f"{arch}: pools tokens differ from all-HBM's")
    first = runs["all-HBM"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    decode_tokens = sum(len(o) - 1 for o in first["out"])
    state = sum(a.numel() * a.element_size() for layer in
                first["b"].caches for a in layer.values()) / SLOTS
    print(f"{arch} serve check: pools == all-HBM tokens; counters == "
          f"predict_pool_counters; prompts {min(lengths)}-{max(lengths)} "
          f"tokens; {cfg.num_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters; {state:.0f} B of state a slot", flush=True)
    print(f"{arch} serve time: prefill {float(np.mean(admit_ms)):.1f} ms per "
          f"admission (mean of {len(admit_ms)}, "
          f"{min(admit_ms):.1f}-{max(admit_ms):.1f}); "
          f"{decode_tokens / first['wall']:.1f} decode tokens/s over the "
          f"whole all-HBM run ({first['wall']:.3f} s, prefill included); mean "
          f"pure decode step {1e3 * float(np.mean(first['step_s'])):.3f} ms "
          f"over {len(first['step_s'])} steps of {SLOTS} slots; peak device "
          f"memory {peak:.2f} GB [{card}]", flush=True)
    # three more decode steps of all 8 slots on the finished engine's state
    b = first["b"]
    wall_us, rows = device_profile(b._dense_decode_step, 3)
    print_profile(f"{arch} decode (8 slots)", wall_us, rows, 3, card)
    note(f"{arch} decode profile")
    del runs, first, b, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{arch} serving took {time.perf_counter() - t0:.1f} s",
          flush=True)


def train_recurrent(cfg, card, note, *, B, S, steps, scfg, prof, modes):
    """``steps`` train steps of ``cfg`` (bf16, seed 0) in each of
    ``modes`` from one state, on one repeated make_batch batch (K codes a
    token, or a prefix of patch embeddings before the S tokens, where the
    config has them), with the planned config ``scfg`` (its moments where
    it places them).  Fails
    unless every loss is finite, every mode's losses and gradient norms ==
    full's step by step (MODE_LOSS_RTOL, MODE_GNORM_RTOL) and offload's
    carries out and back == estimate_offload_traffic.  Returns each mode's
    step ms (the median after the first step; the one step's when it ran
    one), peak device memory and bytes to host a step; ``note`` reads the
    kernel launches."""
    import torch
    from repro_torch.core import offload
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import loop
    ocfg = OptConfig(total_steps=steps, warmup_steps=1)
    batch = make_batch(DataConfig(
        seed=0, vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
        num_codebooks=cfg.num_codebooks,
        num_prefix_tokens=cfg.num_prefix_tokens, d_model=cfg.d_model), 0)
    state = loop.init_state(cfg, ocfg, seed=0,
                            offload_opt_state=scfg.offload_opt_state)
    init = [p.detach().clone() for p in state["params"].parameters()]
    carry = B * (S + cfg.num_prefix_tokens) * cfg.d_model * 2
    est = offload.estimate_offload_traffic(prof, scfg.mi_periods, carry)
    res = {}
    for mode in modes:
        with torch.no_grad():
            for p, p0 in zip(state["params"].parameters(), init):
                p.copy_(p0)
            for k in ("m", "v"):
                for t in state["opt"][k].values():
                    t.zero_()
            state["opt"]["count"].zero_()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step = loop.make_train_step(cfg, dataclasses.replace(scfg, mode=mode),
                                    ocfg)
        losses, gnorms, times, moved = [], [], [], []
        for _ in range(steps):
            offload.reset_traffic()
            ts = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - ts))
            moved.append(dict(offload.traffic))
        res[mode] = dict(losses=losses, gnorms=gnorms, times=times,
                         ms=float(np.median(times[1:] or times)),
                         peak=torch.cuda.max_memory_allocated(),
                         d2h=moved[-1]["d2h"])
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{cfg.name} {mode}: losses {losses}")
        if mode == "offload" and any(
                mv["d2h"] + mv["h2d"] != est["bytes_offloaded"] or
                mv["in"] != est["blocks"] for mv in moved):
            raise AssertionError(f"{cfg.name} offload: {moved}, estimate "
                                 f"{est}")
        print(f"{cfg.name} train {mode} (MI {scfg.mi_periods} of "
              f"{cfg.num_periods} periods, B {B} x S {S}): losses "
              f"{', '.join(f'{x:.5f}' for x in losses)}; gradient norms "
              f"{', '.join(f'{x:.6g}' for x in gnorms)}; steps "
              f"{', '.join(f'{t:.1f}' for t in times)} ms, "
              f"{B * S / (res[mode]['ms'] * 1e-3):.0f} tokens/s; peak device "
              f"memory {res[mode]['peak'] / 1e9:.2f} GB; "
              f"{res[mode]['d2h']} B of carries to pinned host a step "
              f"[{card}]", flush=True)
    full = res["full"]
    for mode, r in res.items():
        for s in range(steps):
            a, b = r["losses"][s], full["losses"][s]
            g, h = r["gnorms"][s], full["gnorms"][s]
            if not (abs(a - b) <= MODE_LOSS_RTOL * abs(b)
                    and abs(g - h) <= MODE_GNORM_RTOL * h):
                raise AssertionError(f"{cfg.name} train: {mode} at step {s}: "
                                     f"loss {a}, gradient norm {g}; full's "
                                     f"{b}, {h}")
    note(f"{cfg.name} training")
    del state, init, batch
    release_pinned()
    torch.cuda.empty_cache()
    return res


def run_xlstm_full(card, note):
    """Phase 7b: xlstm-1.3b at full width (d_model 2048, 4 heads; 2.723 B
    parameters as the reference builds it at its 48 layers) on
    XLSTM_LAYERS of its layers, bf16 from seed 0, the mLSTM chunkwise with
    chunks of 64.  Serving: 8 slots
    of 2048 tokens, 12 prompts of 128-1024 tokens (whole chunks), all-HBM
    then the pools.  Training: B 1 x S 1024, the moments in pinned host
    memory, offload at the MI runtime.plan picks on H100_COST from the
    port's profile (of a B 1 x S 128 step: the meta-device tracer records
    about 600 data objects a token here, so a 2048-token profile and its
    plan take minutes) against full, one step each (a step takes tens of
    seconds: the sLSTM's steps are each some 20 eager launches a layer,
    and their backward more).  Then the training CLI (2 steps
    of B 1 x S 128 at the planned MI, given, so it does not profile the
    same step again) and the serving CLI (-n 8), both at full depth."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train
    t0 = time.perf_counter()
    ops.mlstm_chunk_mode(XLSTM_CHUNK)
    try:
        rng = np.random.default_rng(31)
        serve_recurrent("xlstm-1.3b", card, note,
                        lengths=[64 * int(n) for n in rng.integers(2, 17, 12)],
                        seed=32, max_seq=XLSTM_MAX_SEQ, layers=XLSTM_LAYERS)
        cfg = dataclasses.replace(get_config("xlstm-1.3b"),
                                  num_layers=XLSTM_LAYERS)
        B, S = XLSTM_TRAIN
        prof, _, scfg = plan_step(cfg, B, XLSTM_PROFILE_S, card,
                                  offload_opt_state=True)
        res = train_recurrent(cfg, card, note, B=B, S=S, steps=1, scfg=scfg,
                              prof=prof, modes=("full", "offload"))
        # both CLIs at full width, as a user runs them
        ts = time.perf_counter()
        with tempfile.TemporaryDirectory() as ckpt_dir:
            out = train.main(["--arch", "xlstm-1.3b", "--steps", "2",
                              "--batch", "1", "--seq", str(XLSTM_PROFILE_S),
                              "--mi", str(scfg.mi_periods),
                              "--ckpt-dir", ckpt_dir])
        if not all(np.isfinite(out["losses"])):
            raise AssertionError(f"training CLI xlstm-1.3b: "
                                 f"{out['losses']}")
        del out
        serve_cli.main(["--arch", "xlstm-1.3b", "-n", "8"])
        note("the CLIs, xlstm-1.3b")
        gc.collect()
        torch.cuda.empty_cache()
        print(f"xlstm-1.3b CLIs: training (B 1 x S {XLSTM_PROFILE_S}, 2 "
              f"steps) and serving (-n 8) exit 0 in "
              f"{time.perf_counter() - ts:.1f} s [{card}]", flush=True)
    finally:
        ops.mlstm_chunk_mode(0)
    if not res["offload"]["peak"] < res["full"]["peak"]:
        raise AssertionError("xlstm-1.3b: offload's peak is not below "
                             "full's")
    print(f"xlstm-1.3b train check: offload == full (loss and gradient "
          f"norm); offload's peak below full's; offload step / full step "
          f"{res['offload']['ms'] / res['full']['ms']:.3f} at "
          f"{res['offload']['peak'] / res['full']['peak']:.3f} of full's "
          f"peak; {res['offload']['d2h']} B of carries a step; phase 7b "
          f"took {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


def run_lstm_full(card, note):
    """Phase 7c: lstm-ptb at full width (2 x 650, vocab 10000; 19.77 M
    parameters), bf16 from seed 0.  Training: B 20 x BPTT 35, profiled by
    the port's own trace_profile and planned on H100_COST at 0.3 of its
    peak; the simulator's fast-only, slow-only, Sentinel and IAL step times
    on H100_COST (paper Fig. 10's shape, which must hold: fast <= Sentinel
    <= 1.5 x slow, Sentinel <= IAL) beside each mode's measured step and
    peak over 6 steps (the carries, 1.82 MB a step, are too small to move
    the peak, which the logits and the optimizer's state hold: no peak
    gate here); the training CLI for 2 steps.  Serving: 8 slots of
    512 tokens, 12 prompts of 35-350 tokens, all-HBM then the pools, and
    the serving CLI (-n 32)."""
    from repro_torch import runtime
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train
    t0 = time.perf_counter()
    cfg = get_config("lstm-ptb")
    B, S = LSTM_TRAIN
    prof, plan, scfg = plan_step(cfg, B, S, card)
    peak = prof.peak_bytes()
    cost = runtime.H100_COST
    sim = {"fast-only": runtime.simulate(prof, cost, 0.0,
                                         "all_fast").step_time,
           "slow-only": runtime.simulate(prof, cost, 0.0,
                                         "all_slow").step_time,
           "Sentinel": plan.sim.step_time,
           "IAL": runtime.simulate(prof, cost, 0.3 * peak, "ial").step_time}
    print(f"lstm-ptb simulated step on H100_COST at 0.3 of the profile's "
          f"peak ({peak / 1e6:.2f} MB): " +
          ", ".join(f"{k} {1e3 * v:.4f} ms" for k, v in sim.items()),
          flush=True)
    if not (sim["fast-only"] <= sim["Sentinel"] <= 1.5 * sim["slow-only"]
            and sim["Sentinel"] <= sim["IAL"]):
        raise AssertionError(f"lstm-ptb: the Fig. 10 shape fails on "
                             f"H100_COST: {sim}")
    res = train_recurrent(cfg, card, note, B=B, S=S, steps=LSTM_TRAIN_STEPS,
                          scfg=scfg, prof=prof, modes=MODES)
    print("lstm-ptb train check: every mode == full (loss and gradient "
          "norm, every step); measured step and peak by mode: " +
          ", ".join(f"{m} {r['ms']:.2f} ms {r['peak'] / 1e6:.1f} MB"
                    for m, r in res.items()) +
          f"; simulated fast-only {1e3 * sim['fast-only']:.4f} ms, Sentinel "
          f"{1e3 * sim['Sentinel']:.4f} ms [{card}]", flush=True)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train.main(["--arch", "lstm-ptb", "--steps", "2", "--batch",
                          str(B), "--seq", str(S), "--ckpt-dir", ckpt_dir])
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"training CLI lstm-ptb: {out['losses']}")
    note("the training CLI, lstm-ptb")
    rng = np.random.default_rng(33)
    serve_recurrent("lstm-ptb", card, note,
                    lengths=[int(n) for n in rng.integers(35, 351, 12)],
                    seed=34, max_seq=LSTM_MAX_SEQ)
    serve_cli.main(["--arch", "lstm-ptb", "-n", "32"])
    note("the serving CLI, lstm-ptb")
    print(f"phase 7c took {time.perf_counter() - t0:.1f} s", flush=True)


def release_pinned():
    """Hand back to the system the pinned host blocks that PyTorch's
    caching host allocator keeps after their tensors die: otherwise each
    training phase's pinned AdamW moments (43 GB for zamba2-7b) stay
    reserved, the next phase's, of other block sizes, add to them, and
    the process passes the machine's 96 GiB of host memory."""
    import torch
    gc.collect()
    torch._C._host_emptyCache()


def _no_kernel_paths(runs):
    """Run each ``(what, run)`` of a phase whose paths launch none of
    K1-K4: ``run(note)``, where ``note(part)`` reads (and fails on) every
    kernel's launches since the last read and resets them.  Returns each
    kernel's launches summed over each path's parts, counted from 0 before
    it ran."""
    import torch
    release_pinned()
    torch.cuda.empty_cache()
    paths = {}
    for what, run in runs:
        tally = _counts()

        def note(part, tally=tally):
            for name, n in _recurrent_launches(part).items():
                tally[name] += n
            reset_counts()
        reset_counts()
        run(note)
        paths[what] = tally
    return paths


def check_recurrent(card):
    """Phase 7: 7a, 7b and 7c.  Returns each kernel's launches summed over
    the runs of each sub-phase, counted from 0 before each run and read
    after it (all 0: none of K1-K4 is on these paths)."""
    t0 = time.perf_counter()
    paths = _no_kernel_paths((
        ("xlstm and lstm-ptb reduced (phase 7a)", check_recurrent_small),
        ("xlstm-1.3b serving and training (phase 7b)",
         lambda note: run_xlstm_full(card, note)),
        ("lstm-ptb training and serving (phase 7c)",
         lambda note: run_lstm_full(card, note))))
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s; K1-K4 launches "
          f"on its paths: {paths}", flush=True)
    return paths


# ------------------------------------------- the modality stubs (phase 8) --

# phase 8: musicgen-medium's codebooks and paligemma-3b's prefix-LM with its
# vision prefix (ROADMAP 9c, 9d).  No kernel of K1-K4 is on their paths:
# musicgen serves through generate only (the batcher decodes one token id a
# slot), and a prefix-LM decode stays on the dense core (K1 has no prefix
# mask), so paligemma's batcher never builds the pools.
MODALITY = ("musicgen-medium", "paligemma-3b")
MUSICGEN_GENERATE = (8, 256, 32)      # B, frames of 4 codes, decode tokens
PALIGEMMA_GENERATE = (4, 64, 32)      # B, text tokens after 256 patches,
                                      # decode tokens
PALIGEMMA_MAX_SEQ = 2048
# phase 8c's one step a mode at B 1: musicgen S frames of 4 codes,
# paligemma S text tokens after its 256 patches
MODALITY_TRAIN_S = {"musicgen-medium": 1024, "paligemma-3b": 768}


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _modality_prompts(cfg, B, S, seed, dev):
    """Prompts for ``generate``: tokens (B, S), or (B, S, K) codes, and a
    prefix of the config's patch embeddings (B, P, d) float32 where it has
    one, from a generator seeded with ``seed`` on ``dev``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    K = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S) + K,
                                   generator=g, device=dev)}
    if cfg.num_prefix_tokens:
        out["prefix_embed"] = torch.randn(B, cfg.num_prefix_tokens,
                                          cfg.d_model, generator=g,
                                          device=dev)
    return out


def _modality_batcher_runs(params, cfg, reqs, *, max_seq, slots, decode,
                           windows, concat_window, dev, on_engine=None):
    """The request stream on the three dense layouts, with
    ``use_paged_decode`` set so that ``paged=True`` would build the pools
    for a config without the prefix: all-HBM, concat (a global hot window
    of ``concat_window`` tokens) and paged-merged (per-slot ``windows``,
    page 4 or PAGE).  Fails unless no layout built the pools and every
    run's K1 launches are 0.  Returns the runs by layout name (serve()'s
    dicts)."""
    from repro_torch.runtime.plan import PlacementPlan
    page = 4 if max_seq <= 64 else PAGE
    c = dataclasses.replace(cfg, use_paged_decode=True)
    layouts = {"all-HBM": (None, False),
               "concat": (PlacementPlan(hot_window=concat_window,
                                        page_tokens=page), False),
               "paged-merged": (PlacementPlan(
                   hot_window=max(windows), slot_hot_windows=list(windows),
                   page_tokens=page), True)}
    runs = {}
    for i, (name, (plan, paged)) in enumerate(layouts.items()):
        run = runs[name] = serve(
            params, c, plan, reqs, max_seq=max_seq, slots=slots,
            decode=decode, device=dev, paged=paged,
            on_engine=on_engine if i == 0 else None)
        b = run["b"]
        if b.pool is not None or run["k1"] or b._pool_prefill_ok or \
                (paged and b.paged is None):
            raise AssertionError(f"{cfg.name} {name}: pools {b.pool}, "
                                 f"{run['k1']} K1 launches")
        if name != "all-HBM" and not b.sim_migration_bytes > 0:
            raise AssertionError(f"{cfg.name} {name}: nothing moved to host "
                                 f"memory ({b.counters()})")
    return runs


def check_modality_small(note, dev="cuda"):
    """Phase 8a: musicgen-medium and paligemma-3b reduced in fp32,
    parameters from seed 0 on the CPU and the same values on ``dev``.  The
    forward's logits on a pipeline batch (2 x 16 tokens of 4 codes; 4
    patch embeddings, then 16 tokens, and the tokens alone) within
    SMALL_LOGITS_TOL of the CPU's; generate's 6 greedy tokens == the
    CPU's; the loss and every gradient of the full mode == the CPU's
    (SMALL_LOSS_TOL, SMALL_GRAD_TOL) and each mode's loss and gradient
    norm at MI 1 and 2 == full's (MODE_LOSS_RTOL, MODE_GNORM_RTOL).  Then
    paligemma's batcher, 2 slots of 32, five prompts (one of 3 tokens,
    shorter than its prefix: ROADMAP R9), on all-HBM, concat and
    paged-merged: tokens and integer counters == the CPU's, tiered ==
    all-HBM tokens, no pools and no K1 launch.  ``note(what)`` reads the
    kernels' launches of what ran."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import offload
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.model import forward, init_params, loss_fn
    from repro_torch.serve.engine import generate
    t0 = time.perf_counter()
    counters = ("sim_migration_bytes", "step_migration_bytes", "page_copies",
                "admit_page_writes", "table_version",
                "prefill_compute_tokens", "decode_steps")
    for arch in MODALITY:
        cfg = get_config(arch).reduced()
        cpu = init_params(cfg, seed=0, device="cpu", requires_grad=True)
        card = copy.deepcopy(cpu).to(dev)
        batch = make_batch(DataConfig(
            seed=0, vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
            num_codebooks=cfg.num_codebooks,
            num_prefix_tokens=cfg.num_prefix_tokens, d_model=cfg.d_model),
            0, device="cpu")
        prompts = [{k: v for k, v in batch.items() if k != "labels"}]
        if cfg.num_prefix_tokens:
            prompts.append({"tokens": batch["tokens"]})
        err = 0.0
        for pr in prompts:
            on = {k: v.to(dev) for k, v in pr.items()}
            err = max(err, _close_rel(forward(card, cfg, on).cpu(),
                                      forward(cpu, cfg, pr),
                                      SMALL_LOGITS_TOL, 0.0,
                                      f"reduced {arch} logits"))
            got = generate(card, cfg, on, 6).cpu()
            want = generate(cpu, cfg, pr, 6)
            if not torch.equal(got, want):
                raise AssertionError(f"reduced {arch}: generate on the card "
                                     f"{got.tolist()} != the CPU's "
                                     f"{want.tolist()}")
        # training: full on the card against the CPU, then every mode
        # against full on the card
        res, gerr = {}, 0.0
        for mode in MODES:
            for mi in (1, 2):
                kw = offload.loss_kwargs(offload.SentinelConfig(
                    mode=mode, mi_periods=mi))
                sides = ((dev, card), ("cpu", cpu)) if mode == "full" \
                    else ((dev, card),)
                for d, p in sides:
                    loss = loss_fn(p, cfg, {k: v.to(d) for k, v in
                                            batch.items()}, **kw)
                    grads = torch.autograd.grad(loss, list(p.parameters()))
                    if not (torch.isfinite(loss) and all(
                            torch.isfinite(g).all() for g in grads)):
                        raise AssertionError(f"reduced {arch} {mode} mi {mi} "
                                             f"on {d}: not finite")
                    gn = float(torch.sqrt(sum(g.double().square().sum()
                                              for g in grads)))
                    res[d, mode, mi] = (float(loss.detach()), gn,
                                        [g.cpu() for g in grads])
        lc, _, g_cpu = res["cpu", "full", 1]
        lg, gg, g_dev = res[dev, "full", 1]
        _close_rel(torch.tensor(lg), torch.tensor(lc), SMALL_LOSS_TOL, 0.0,
                   f"reduced {arch} full loss")
        for a, h in zip(g_dev, g_cpu):
            gerr = max(gerr, _close_rel(a, h, SMALL_GRAD_TOL, 0.0,
                                        f"reduced {arch} full gradient"))
        for (d, mode, mi), (l, gn, _) in res.items():
            if d == dev and not (abs(l - lg) <= MODE_LOSS_RTOL * abs(lg)
                                 and abs(gn - gg) <= MODE_GNORM_RTOL * gg):
                raise AssertionError(f"reduced {arch} {mode} mi {mi}: loss "
                                     f"{l}, gradient norm {gn}; full's {lg}, "
                                     f"{gg}")
        print(f"small modality check {arch} (fp32): logits on the card == "
              f"on the CPU (max_abs_err {err:.3e}, "
              f"{'with and without the prefix, ' * bool(len(prompts) - 1)}"
              f"atol {SMALL_LOGITS_TOL['atol']:g}); generate's tokens "
              f"identical; full's loss {lg:.6f} / {lc:.6f}, gradients "
              f"max_abs_err {gerr:.3e}; every mode at MI 1 and 2 == full's "
              f"loss and gradient norm on the card", flush=True)
        if not cfg.num_prefix_tokens:
            continue
        rng = np.random.default_rng(3)
        reqs = [(rng.integers(0, cfg.vocab_size, p), None)
                for p in (9, 14, 3, 6, 11)]
        params_cpu = init_params(cfg, seed=0, device="cpu")
        params_dev = copy.deepcopy(params_cpu).to(dev)
        got = {d: _modality_batcher_runs(p, cfg, reqs, max_seq=32, slots=2,
                                         decode=6, windows=[4, 8],
                                         concat_window=16, dev=d)
               for d, p in ((dev, params_dev), ("cpu", params_cpu))}
        for name, run in got[dev].items():
            cg, ch = run["b"].counters(), got["cpu"][name]["b"].counters()
            if run["out"] != got["cpu"][name]["out"] or \
                    run["out"] != got[dev]["all-HBM"]["out"] or \
                    any(cg[k] != ch[k] for k in counters if k in ch):
                raise AssertionError(f"reduced {arch} {name}: card tokens "
                                     f"or counters differ from the CPU's "
                                     f"or from all-HBM's")
        print(f"small modality check {arch} batcher (fp32): all-HBM, concat "
              f"and paged-merged on the card == on the CPU (tokens, "
              f"counters), tiered == all-HBM tokens, a 3-token prompt "
              f"under the 4-patch prefix among them; no pools, no K1 "
              f"launch", flush=True)
    note("phase 8a")
    print(f"phase 8a took {time.perf_counter() - t0:.1f} s", flush=True)


def generate_full(params, cfg, prompts, decode, card, what, dev="cuda"):
    """``generate`` on ``prompts`` for ``decode`` greedy tokens, twice
    (identical, the first token == the prefill's argmax, in range), timed;
    then the prefill alone and ``decode`` decode steps on its cache, each
    timed; then a profile of 4 decode steps.  Prints tokens/s, prefill ms,
    the mean decode step and the device-busy share."""
    import torch
    from repro_torch.models import model
    from repro_torch.serve.engine import generate, make_serve_step
    B = prompts["tokens"].shape[0]
    K = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    S = prompts["tokens"].shape[1] + (
        cfg.num_prefix_tokens if "prefix_embed" in prompts else 0)
    _sync(dev)
    ts = time.perf_counter()
    a = generate(params, cfg, prompts, decode)
    _sync(dev)
    wall = time.perf_counter() - ts
    b = generate(params, cfg, prompts, decode)
    _sync(dev)
    ts = time.perf_counter()
    last, caches = model.prefill(params, cfg, prompts, max_seq=S + decode + 8)
    _sync(dev)
    prefill_ms = 1e3 * (time.perf_counter() - ts)
    first = last[..., :cfg.vocab_size].argmax(-1)
    if tuple(a.shape) != (B, decode) + K or not torch.equal(a, b) or \
            not torch.equal(a[:, 0], first) or \
            not bool(((a >= 0) & (a < cfg.vocab_size)).all()):
        raise AssertionError(f"{what}: generate's tokens {tuple(a.shape)} "
                             f"not deterministic, not the prefill's argmax "
                             f"or out of range")
    step = make_serve_step(cfg)
    tok = first[:, None]
    _sync(dev)
    ts = time.perf_counter()
    for i in range(decode):
        logits, caches = step(params, tok, caches, S + i)
        tok = logits[..., :cfg.vocab_size].argmax(-1)[:, None]
    _sync(dev)
    step_ms = 1e3 * (time.perf_counter() - ts) / decode
    i = iter(range(S + decode, S + decode + 8))

    def one():
        step(params, tok, caches, next(i))
    wall_us, rows = device_profile(one, 4)
    print_profile(f"{what} decode (B {B})", wall_us, rows, 4, card)
    rows = f"{S} rows" + (f" ({cfg.num_prefix_tokens} patches, then text)"
                          if "prefix_embed" in prompts else "") + \
        (f" of {K[0]} codes" if K else "")
    print(f"{what} generate: B {B}, prompts of {rows}, {decode} greedy "
          f"tokens, identical in two calls, first == the prefill's argmax; "
          f"{B * decode / wall:.1f} tokens/s ({wall:.3f} s, prefill "
          f"included); prefill {prefill_ms:.1f} ms; mean decode step "
          f"{step_ms:.3f} ms [{card}]", flush=True)


def run_musicgen_full(card, note, dev="cuda"):
    """Phase 8b, musicgen-medium at full width (d_model 1536, 24 heads of
    64, 4 codebooks of 2048) on 24 of its 48 layers, bf16 from seed 0:
    generate at B 8 on prompts of 256 frames of 4 codes, 32 greedy tokens
    of 4 codes; then the serving CLI at full width and depth (-n 32)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    cfg = _half_depth(get_config("musicgen-medium"), DEPTH_PARTS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    B, S, decode = MUSICGEN_GENERATE
    generate_full(params, cfg, _modality_prompts(cfg, B, S, 41, dev),
                  decode, card, "musicgen-medium", dev)
    note("musicgen-medium generate")
    print(f"musicgen-medium: {n_params / 1e9:.3f} B parameters; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]",
          flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ts = time.perf_counter()
    out = serve_cli.main(["--arch", "musicgen-medium", "-n", "32"])
    if tuple(out.shape) != (4, 32, 4):
        raise AssertionError(f"serving CLI musicgen-medium: {out.shape}")
    note("the serving CLI, musicgen-medium")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    print(f"musicgen-medium serving CLI (-n 32) exit 0 in "
          f"{time.perf_counter() - ts:.1f} s; musicgen-medium phase took "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


def run_paligemma_full(card, note, dev="cuda"):
    """Phase 8b, paligemma-3b at full width (d_model 2048, 8 query heads and
    1 KV head of 256, vocab 257,216) on 9 of its 18 layers, bf16 from
    seed 0: generate at B 4 on 256 patch
    embeddings and 64 text tokens, 32 greedy tokens; then the batcher, 8
    slots of 2048 tokens, phase 3's 12 text prompts (100-700 tokens, four
    sharing a 256-token prefix) on all-HBM, concat (a global hot window of
    256 tokens) and paged-merged (per-slot windows of 128-240 tokens, page
    16): identical tokens, no pools and no K1 launch; prefill ms per
    admission, decode tokens/s, the mean pure-decode step, peak memory and
    a profile of decode steps on paged-merged."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    cfg = _half_depth(get_config("paligemma-3b"), DEPTH_PARTS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    B, S, decode = PALIGEMMA_GENERATE
    generate_full(params, cfg, _modality_prompts(cfg, B, S, 42, dev),
                  decode, card, "paligemma-3b", dev)
    note("paligemma-3b generate")
    reqs = requests(cfg.vocab_size, seed=43)
    admit_ms = []

    def time_admissions(b):
        admit = b._admit_dense

        def timed(*args):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            admit(*args)
            torch.cuda.synchronize()
            admit_ms.append(1e3 * (time.perf_counter() - ts))
        b._admit_dense = timed

    windows = [128 + 16 * s for s in range(SLOTS)]
    runs = _modality_batcher_runs(
        params, cfg, reqs, max_seq=PALIGEMMA_MAX_SEQ, slots=SLOTS,
        decode=DECODE, windows=windows, concat_window=256, dev=dev,
        on_engine=time_admissions)
    note("paligemma-3b batcher")
    first = runs["all-HBM"]
    for name, run in runs.items():
        b = run["b"]
        if len(run["out"]) != len(reqs) or \
                any(len(o) != DECODE for o in run["out"]) or \
                any(not 0 <= t < cfg.vocab_size
                    for o in run["out"] for t in o):
            raise AssertionError(f"paligemma-3b {name}: malformed outputs")
        if run["out"] != first["out"]:
            raise AssertionError(f"paligemma-3b: {name} tokens differ from "
                                 f"all-HBM's")
        print(f"paligemma-3b serve {name}: {len(run['out'])} requests, "
              f"{b.decode_steps} decode steps, sim_migration_bytes "
              f"{b.sim_migration_bytes:.0f}, K1 {run['k1']}, mean pure "
              f"decode step {1e3 * float(np.mean(run['step_s'])):.3f} ms, "
              f"wall {run['wall']:.3f} s", flush=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    decode_tokens = sum(len(o) - 1 for o in first["out"])
    lens = [len(t) for t, _ in reqs]
    print(f"paligemma-3b serve check: concat == paged-merged == all-HBM "
          f"tokens; no pools, K1 0 launches; prompts {min(lens)}-{max(lens)} "
          f"text tokens (all under the 256-patch prefix's length: ROADMAP "
          f"R9); {n_params / 1e9:.3f} B parameters; KV "
          f"{first['b']._row_bytes:.0f} B a token", flush=True)
    print(f"paligemma-3b serve time: prefill {float(np.mean(admit_ms)):.1f} "
          f"ms per admission (mean of {len(admit_ms)}, "
          f"{min(admit_ms):.1f}-{max(admit_ms):.1f}); "
          f"{decode_tokens / first['wall']:.1f} decode tokens/s over the "
          f"whole all-HBM run ({first['wall']:.3f} s, prefill included); "
          f"mean pure decode step {1e3 * float(np.mean(first['step_s'])):.3f}"
          f" ms over {len(first['step_s'])} steps of {SLOTS} slots; peak "
          f"device memory {peak:.2f} GB [{card}]", flush=True)
    plan = runs["paged-merged"]["b"].plan
    del runs, first
    gc.collect()
    b = profile_decode(params, dataclasses.replace(cfg, use_paged_decode=True),
                       plan, reqs, card, steps=4, max_seq=PALIGEMMA_MAX_SEQ,
                       what="paligemma-3b paged-merged decode",
                       decode=PALIGEMMA_MAX_SEQ - max(lens[:SLOTS]) - 1)
    if b.pool is not None:
        raise AssertionError("paligemma-3b: the profile built the pools")
    note("paligemma-3b decode profile")
    del b, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"paligemma-3b phase took {time.perf_counter() - t0:.1f} s",
          flush=True)


def train_modality(card, note):
    """Phase 8c: one training step a mode at full width and 8b's depth
    (``_half_depth``, for the script's clock; phase 8b's depth), B 1,
    bf16 from seed 0, the AdamW moments in pinned host memory: musicgen
    at S 1024 frames of 4 codes, paligemma at 256 patches + S 768 text
    tokens (the loss over the text).  Full against offload at the MI
    runtime.plan picks on H100_COST from the port's meta-device profile of
    the same step: offload's loss and gradient norm == full's, its
    carries == estimate_offload_traffic; step ms, peak memory and carry
    bytes of each."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    for arch in MODALITY:
        cfg = _half_depth(get_config(arch), DEPTH_PARTS)
        S = MODALITY_TRAIN_S[arch]
        prof, _, scfg = plan_step(cfg, 1, S, card, offload_opt_state=True)
        res = train_recurrent(cfg, card, note, B=1, S=S, steps=1, scfg=scfg,
                              prof=prof, modes=("full", "offload"))
        f, o = res["full"], res["offload"]
        print(f"{arch} train check: offload == full (loss and gradient "
              f"norm); full {f['ms']:.1f} ms at {f['peak'] / 1e9:.2f} GB, "
              f"offload {o['ms']:.1f} ms at {o['peak'] / 1e9:.2f} GB "
              f"({o['ms'] / f['ms']:.3f} of full's step, "
              f"{o['peak'] / f['peak']:.3f} of its peak), {o['d2h']} B of "
              f"carries a step [{card}]", flush=True)
    print(f"phase 8c took {time.perf_counter() - t0:.1f} s", flush=True)


def check_modality(card):
    """Phase 8: 8a, 8b and 8c.  Returns each kernel's launches summed over
    the runs of each sub-phase, counted from 0 before each run and read
    after it (all 0: none of K1-K4 is on these paths)."""
    t0 = time.perf_counter()
    paths = _no_kernel_paths((
        ("musicgen-medium and paligemma-3b reduced (phase 8a)",
         check_modality_small),
        ("musicgen-medium generate and serving CLI (phase 8b)",
         lambda note: run_musicgen_full(card, note)),
        ("paligemma-3b generate and batcher (phase 8b)",
         lambda note: run_paligemma_full(card, note)),
        ("musicgen-medium and paligemma-3b training (phase 8c)",
         lambda note: train_modality(card, note))))
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s; K1-K4 launches "
          f"on its paths: {paths}", flush=True)
    return paths


# ------------------------------ MoE under Sentinel's blocked modes (phase 9) --

# phase 9: granite-moe-3b and deepseek-v2-lite train in every Sentinel mode
# (ROADMAP item 12); none of K1-K4 is on a training path
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MOE_TRAIN = (1, 1024)                 # B x S of phases 9b and 9c
MOE_TRAIN_STEPS = 2
# 9c's cut: deepseek-v2-lite's dense first layer and 4 of its 26 MoE
# layers: all 27 layers' moments, about 126 GB, pass the machine's 96 GiB
# of host memory (on 8 MoE layers: 5.18 B parameters, 41.4 GB of f32
# moments; 4 since phase 15 came, for the script's clock)
DEEPSEEK_TRAIN_LAYERS = 1 + 4
# 9b's cut, for the script's clock: granite-moe-3b on 8 of its 32 layers
# (whole, it took 36.7 s of a 1188.8 s run, on 16 layers 18.2 s of a
# 928.3 s run, on H100 80GB HBM3 hosts at 700 W)
GRANITE_TRAIN_LAYERS = 8


def check_moe_train_small(note):
    """Phase 9a: granite-moe-3b and deepseek-v2-lite reduced, fp32,
    parameters from seed 0 on the CPU and the same values on the card: the
    loss (the NLL plus every MoE layer's aux) and every gradient on the
    card == on the CPU, in all four modes at MI 1 and 2; each mode's loss
    and gradient norm on the card == full's (MODE_LOSS_RTOL,
    MODE_GNORM_RTOL); offload's bytes == estimate_offload_traffic."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import offload
    from repro_torch.core.profiler import TraceProfile
    from repro_torch.models.model import init_params, loss_fn
    worst, runs = 0.0, 0
    for arch in MOE_ARCHS:
        cfg = get_config(arch).reduced()
        cpu = init_params(cfg, seed=0, device="cpu", requires_grad=True)
        gpu = copy.deepcopy(cpu).to("cuda")
        toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 17))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:])}
        prof = TraceProfile(num_periods=cfg.num_periods, num_steps=0)
        carry = 2 * 16 * cfg.d_model * 4
        full = None
        for mode in MODES:
            for mi in (1, 2):
                scfg = offload.SentinelConfig(mode=mode, mi_periods=mi)
                got = {}
                for dev, p in (("cuda", gpu), ("cpu", cpu)):
                    offload.reset_traffic()
                    loss = loss_fn(p, cfg, {k: v.to(dev) for k, v in
                                            batch.items()},
                                   **offload.loss_kwargs(scfg))
                    grads = torch.autograd.grad(loss, list(p.parameters()))
                    gn = float(torch.sqrt(sum((g.double() ** 2).sum()
                                              for g in grads)))
                    got[dev] = (loss.detach().cpu(), [g.cpu() for g in grads],
                                dict(offload.traffic), gn)
                what = f"{arch} reduced {mode} mi {mi}"
                torch.testing.assert_close(
                    got["cuda"][0], got["cpu"][0], **SMALL_LOSS_TOL,
                    msg=lambda m: f"{what} loss: {m}")
                for a, b in zip(got["cuda"][1], got["cpu"][1]):
                    torch.testing.assert_close(
                        a, b, **SMALL_GRAD_TOL,
                        msg=lambda m: f"{what} grad: {m}")
                    worst = max(worst, float((a - b).abs().max()))
                est = offload.estimate_offload_traffic(prof, mi, carry)
                want = est["bytes_offloaded"] if mode == "offload" else 0
                blocks = est["blocks"] if mode == "offload" else 0
                tr = got["cuda"][2]
                if tr["d2h"] + tr["h2d"] != want or \
                        tr["out"] != tr["in"] or tr["in"] != blocks:
                    raise AssertionError(f"{what}: offloaded {tr}, estimate "
                                         f"{want} B in {blocks} carries")
                l, g = float(got["cuda"][0]), got["cuda"][3]
                full = full or (l, g)
                if not (abs(l - full[0]) <= MODE_LOSS_RTOL * abs(full[0])
                        and abs(g - full[1]) <= MODE_GNORM_RTOL * full[1]):
                    raise AssertionError(f"{what}: loss {l}, gradient norm "
                                         f"{g}; full's {full}")
                runs += 1
    note("MoE reduced training")
    print(f"small MoE training check: {runs} runs (granite-moe-3b and "
          f"deepseek-v2-lite reduced, fp32, 4 modes x MI 1 and 2): loss with "
          f"the aux and every gradient on the card == on the CPU (loss atol "
          f"{SMALL_LOSS_TOL['atol']:g}; gradients atol "
          f"{SMALL_GRAD_TOL['atol']:g} + rtol {SMALL_GRAD_TOL['rtol']:g}), "
          f"max_abs_err {worst:.3e}; every mode == full on the card; offload "
          f"bytes == estimate_offload_traffic", flush=True)


def train_moe_full(card, note):
    """Phases 9b and 9c: granite-moe-3b at full width on
    GRANITE_TRAIN_LAYERS layers and deepseek-v2-lite at full width on
    DEEPSEEK_TRAIN_LAYERS layers, bf16 from seed 0, B 1 x S 1024 from
    make_batch, MOE_TRAIN_STEPS steps in each of the four modes from one
    state at the MI runtime.plan picks on H100_COST, the AdamW moments in
    pinned host memory: every loss finite and falling on the repeated
    batch, each mode's losses and gradient norms == full's, offload's
    carries == estimate_offload_traffic (train_recurrent's gates)."""
    from repro_torch.configs import get_config
    B, S = MOE_TRAIN
    for arch, layers in (("granite-moe-3b-a800m", GRANITE_TRAIN_LAYERS),
                         ("deepseek-v2-lite-16b", DEEPSEEK_TRAIN_LAYERS)):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
        release_pinned()
        prof, _, scfg = plan_step(cfg, B, S, card, offload_opt_state=True)
        res = train_recurrent(cfg, card, note, B=B, S=S,
                              steps=MOE_TRAIN_STEPS, scfg=scfg, prof=prof,
                              modes=MODES)
        for mode, r in res.items():
            if not r["losses"][-1] < r["losses"][0]:
                raise AssertionError(f"{arch} {mode}: losses {r['losses']} "
                                     f"do not fall")
        f, o = res["full"], res["offload"]
        print(f"{arch} train check ({cfg.num_layers} layers): losses fall in "
              f"every mode, and every mode == full (loss and gradient "
              f"norm); full {f['ms']:.1f} ms at {f['peak'] / 1e9:.2f} GB, "
              f"offload {o['ms']:.1f} ms at {o['peak'] / 1e9:.2f} GB "
              f"({o['ms'] / f['ms']:.3f} of full's step, "
              f"{o['peak'] / f['peak']:.3f} of its peak), {o['d2h']} B of "
              f"carries a step; remat {res['remat']['ms']:.1f} ms, save_hbm "
              f"{res['save_hbm']['ms']:.1f} ms; took "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


def check_moe_train(card):
    """Phase 9: 9a, 9b and 9c.  Returns each kernel's launches on each
    path (all 0)."""
    t0 = time.perf_counter()
    paths = _no_kernel_paths((
        ("granite-moe-3b and deepseek-v2-lite reduced training (phase 9a)",
         check_moe_train_small),
        ("granite-moe-3b and deepseek-v2-lite training, four modes "
         "(phases 9b, 9c)", lambda note: train_moe_full(card, note))))
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s; K1-K4 launches "
          f"on its paths: {paths}", flush=True)
    return paths


# --------------------- the disaggregated engine on the families (phase 10) --

def _other_kernels_idle(what):
    """K2, K3 and K4 launched nothing since the last reset_counts."""
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ssd as k4
    if k2.flash_attention.launches or k3.decode_attention.launches or \
            k4.ssd.launches:
        raise AssertionError(f"{what}: K2, K3 or K4 launched")


# the share of the period layers that phases 6b-6e, 8b, 8c and 10b run
# (``_half_depth``), for the script's clock: a half until phase 15 came,
# whose whole run then took 1426.8 s on an H100 80GB HBM3 host at 700 W
DEPTH_PARTS = 4


def _half_depth(cfg, parts=2):
    """``cfg`` on its prologue and ``1 / parts`` of its period layers, a
    whole number of periods (at least one)."""
    n = cfg.num_layers - len(cfg.prologue)
    periods = max(1, n // parts // cfg.period_len)
    return dataclasses.replace(
        cfg, num_layers=len(cfg.prologue) + periods * cfg.period_len)


def check_disagg_families_small():
    """Phase 10a: each family reduced in fp32, the disaggregated engine on
    the card and on the CPU from the same parameters (4 slots of 32 tokens,
    page 4, six requests sharing a 9-token prefix): one shard for all five,
    and two shards aliased on each device for the four GQA families, slots
    re-homed [0,0,1,1] -> [1,0,1,0] before step 3.  The card's tokens and
    ledger == the CPU's, the tokens == a colocated all-hot run's on the
    card, K1 once a layer per shard forward; deepseek is refused at two
    shards on the card as on the CPU.  Returns K1's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    total = 0
    for arch in FAMILIES:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  use_paged_decode=True)
        params_cpu = init_params(cfg, seed=0, device="cpu")
        params_gpu = copy.deepcopy(params_cpu).to("cuda")
        rng = np.random.default_rng(3)
        pref = rng.integers(0, cfg.vocab_size, 9)
        reqs = [(np.concatenate([pref, rng.integers(0, cfg.vocab_size,
                                                    n - 9)]), "sys")
                for n in (12, 13, 11, 12, 14, 12)]
        plan = PlacementPlan(hot_window=16, page_tokens=4,
                             slot_hot_windows=[8] * 4,
                             slot_devices=[0, 0, 1, 1])
        plan2 = dataclasses.replace(plan, slot_hot_windows=[4, 8, 4, 8],
                                    slot_devices=[1, 0, 1, 0])
        one_plan = dataclasses.replace(plan, slot_devices=None)
        run = dict(max_seq=32, slots=4, decode=6)
        n_k1 = _n_k1_layers(cfg)
        col = serve(params_gpu, cfg, dataclasses.replace(
            one_plan, hot_window=32, slot_hot_windows=None), reqs,
            device="cuda", **run)
        cases = [("one shard", one_plan, 1, ())]
        if n_k1 == cfg.num_layers:
            cases.append(("two shards", plan, 4, [(3, plan2)]))
        else:
            for dev in ("cuda", "cpu"):
                try:
                    serve(params_gpu if dev == "cuda" else params_cpu, cfg,
                          plan, reqs, device=dev, disagg=True,
                          devices=[torch.device(dev)] * 4, **run)
                except ValueError as e:
                    if "pure-attention stack" not in str(e):
                        raise
                else:
                    raise AssertionError(f"{arch}: two shards not refused")
        for name, p, n_dev, schedule in cases:
            got, forwards = {}, []
            for dev, prm in (("cuda", params_gpu), ("cpu", params_cpu)):
                got[dev] = serve(
                    prm, cfg, p, reqs, device=dev, disagg=True,
                    devices=[torch.device(dev)] * n_dev, schedule=schedule,
                    on_engine=(lambda e: _count_shard_forwards(e, forwards))
                    if dev == "cuda" else None, **run)
            g, c = got["cuda"], got["cpu"]
            if g["out"] != c["out"] or _ledger(g["b"]) != _ledger(c["b"]):
                raise AssertionError(f"disagg reduced {arch} {name}: card "
                                     f"tokens or ledger differ from the "
                                     f"CPU's")
            if g["out"] != col["out"]:
                raise AssertionError(f"disagg reduced {arch} {name}: tokens "
                                     f"differ from the colocated all-hot "
                                     f"run")
            if g["k1"] != sum(forwards) * n_k1:
                raise AssertionError(f"disagg reduced {arch} {name}: "
                                     f"{g['k1']} K1 launches for "
                                     f"{sum(forwards)} shard forwards x "
                                     f"{n_k1}")
            g["b"].mesh_table.check()
            _other_kernels_idle(f"disagg reduced {arch} {name}")
            total += g["k1"]
            print(f"disagg reduced check {arch} ({name}): fp32 tokens and "
                  f"ledger on the card == on the CPU; tokens == colocated "
                  f"all-hot; K1 {g['k1']} == {sum(forwards)} shard forwards "
                  f"x {n_k1}", flush=True)
    return total


def disagg_family(arch, card):
    """Phase 10b, one family at full width on half its layers (bf16, seed
    0), 12 prompts of 300-512 tokens (four sharing a 256-token prefix; a
    whole MoE prompt must fill whole 512-token dispatch groups, as in the
    reference) on 8 slots of 1024 tokens, page 16, hot windows 128-240,
    whole-prompt admission (chunk 0): the colocated pools engine admitting
    densely, the one-shard engine (tokens == colocated, ledger ==
    predict_pool_counters(dense_admit=True), K1 == decode steps x
    attention layers) and, for a GQA family, two shards aliased on the
    card (slot_devices alternating: ledger == predict_pool_counters, K1 ==
    shard forwards x attention layers; its tokens' agreement with the
    one-shard run printed, not gated, as phase 3d-2's).  Returns K1's
    launches on the one- and two-shard runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    from repro_torch.serve.engine import predict_pool_counters
    t0 = time.perf_counter()
    cfg = _half_depth(dataclasses.replace(get_config(arch),
                                          use_paged_decode=True), DEPTH_PARTS)
    params = init_params(cfg, seed=0)
    lengths = np.random.default_rng(26).integers(300, 513, 12)
    reqs = family_requests(cfg.vocab_size, lengths, seed=27)
    preq = [(tuple(int(x) for x in t), DECODE, None, k) for t, k in reqs]
    plan = PlacementPlan(hot_window=192, page_tokens=PAGE,
                         slot_hot_windows=[128 + 16 * s
                                           for s in range(SLOTS)])
    run = dict(max_seq=MAX_SEQ, slots=SLOTS, decode=DECODE, device="cuda")
    n_k1 = _n_k1_layers(cfg)
    # the colocated engine admits whole prompts by one dense prefill, as
    # the disaggregated one does: pool-direct admission computes the same
    # KV in other kernels, whose bf16 roundings moved internlm2's tokens
    col = serve(params, cfg, plan, reqs,
                on_engine=lambda b: setattr(b, "_pool_prefill_ok", False),
                **run)
    one = serve(params, cfg, plan, reqs, disagg=True,
                devices=[torch.device("cuda", 0)], **run)
    _other_kernels_idle(f"{arch} disagg one shard")
    b1 = one["b"]
    common = dict(slots=SLOTS, max_seq=MAX_SEQ, page_tokens=b1.page_tokens,
                  row_bytes=b1._row_bytes, dense_admit=True)
    pred = predict_pool_counters(preq, plan, **common)
    b1.mesh_table.check()
    if one["out"] != col["out"]:
        same = sum(a == b for o, p in zip(one["seq"], col["seq"])
                   for a, b in zip(o, p))
        raise AssertionError(f"{arch} disagg one shard: tokens differ from "
                             f"the colocated pools engine ({same} agree)")
    if _ledger(b1) != _pred_ledger(pred) or b1.counters()["repacks"]:
        raise AssertionError(f"{arch} disagg one shard: ledger "
                             f"{_ledger(b1)} != predicted "
                             f"{_pred_ledger(pred)}")
    steps = b1.decode_steps
    if one["k1"] != steps * n_k1:
        raise AssertionError(f"{arch} disagg one shard: {one['k1']} K1 "
                             f"launches for {steps} decode steps x {n_k1}")
    print(f"{arch} disagg one shard ({cfg.num_layers} layers): tokens == "
          f"colocated pools; ledger == predict_pool_counters(dense_admit="
          f"True) (xdev {b1.xdev_migration_bytes:.0f} B, "
          f"sim_migration_bytes {b1.sim_migration_bytes:.0f}); K1 "
          f"{one['k1']} = {steps} decode steps x {n_k1}; mean pure decode "
          f"step {_step_ms(one):.3f} ms (colocated {_step_ms(col):.3f}) "
          f"[{card}]", flush=True)
    two_k1 = None
    if n_k1 == cfg.num_layers:
        plan2 = dataclasses.replace(plan, slot_devices=[s % 2 for s in
                                                        range(SLOTS)])
        forwards = []
        two = serve(params, cfg, plan2, reqs, disagg=True,
                    devices=[torch.device("cuda", 0)] * 4,
                    on_engine=lambda e: _count_shard_forwards(e, forwards),
                    **run)
        _other_kernels_idle(f"{arch} disagg two shards")
        b2 = two["b"]
        pred2 = predict_pool_counters(preq, plan2, **common)
        b2.mesh_table.check()
        if _ledger(b2) != _pred_ledger(pred2) or b2.counters()["repacks"]:
            raise AssertionError(f"{arch} disagg two shards: ledger "
                                 f"{_ledger(b2)} != predicted "
                                 f"{_pred_ledger(pred2)}")
        if len(forwards) != b2.decode_steps or \
                two["k1"] != sum(forwards) * n_k1:
            raise AssertionError(f"{arch} disagg two shards: {two['k1']} K1 "
                                 f"launches for {sum(forwards)} shard "
                                 f"forwards x {n_k1}")
        if len(two["out"]) != len(reqs) or \
                any(len(o) != DECODE for o in two["out"]):
            raise AssertionError(f"{arch} disagg two shards: malformed "
                                 f"outputs")
        same = sum(a == b for o, p in zip(two["seq"], one["seq"])
                   for a, b in zip(o, p))
        edges = {f"{s}->{d}": v for (s, d), v in
                 b2.edge_migration_bytes.items()}
        print(f"{arch} disagg two shards: ledger == predict_pool_counters "
              f"(edges {edges}, hot peaks {b2.counters()['device_hot_peak']}"
              f"); K1 {two['k1']} = {sum(forwards)} shard forwards x {n_k1}; "
              f"{same} of {sum(len(o) for o in one['seq'])} tokens agree "
              f"with the one-shard run (not gated, as phase 3d-2); mean pure "
              f"decode step {_step_ms(two):.3f} ms, "
              f"{_step_ms(two) / _step_ms(one):.3f} times one shard's "
              f"[{card}]", flush=True)
        two_k1 = two["k1"]
    one_k1 = one["k1"]
    del params, col, one
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{arch} phase 10b took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return one_k1, two_k1


def check_disagg_families(card):
    """Phase 10: 10a and 10b.  Returns K1's launches by path."""
    t0 = time.perf_counter()
    k1 = {"reduced families disaggregated, card == CPU (phase 10a)":
          check_disagg_families_small()}
    for arch in FAMILIES:
        one, two = disagg_family(arch, card)
        k1[f"{arch} disaggregated, one shard (phase 10b)"] = one
        if two is not None:
            k1[f"{arch} disaggregated, two aliased shards (phase 10b)"] = two
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)
    return k1


# ------------------------------ tensor-parallel prefill (phase 11) ----------

# phase 11a's reduced configs: the main path's smollm (whose reduced heads
# split whole at 2 ranks, its KV heads cut at 4), internlm2 and granite's
# experts
TP_SMALL = ("smollm-360m", "internlm2-1.8b", "granite-moe-3b-a800m")
# 11b: a TP admission's last-row logits may lie at most this many times as
# far from an fp32 one-device prefill as the bf16 one-device prefill's do
TP_BF16_RATIO = 1.5


def check_tp_small(card):
    """Phase 11a: each TP_SMALL config reduced in fp32, a 12-token prompt
    (max_seq 32) through ``TensorParallelPrefill`` on ``[cuda:0] * n`` and
    ``[cpu] * n`` ranks, n = 2 and 4, from the same parameters: the last
    row's logits and the caches on the card within atol 1e-4 of the CPU's
    and of the card's one-device prefill, and the collectives' ledger
    (bytes and counts, type for type) equal to the CPU's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serve.disagg import TensorParallelPrefill
    worst = 0.0
    for arch in TP_SMALL:
        cfg = get_config(arch).reduced()
        params_cpu = model.init_params(cfg, seed=0, device="cpu")
        params_gpu = copy.deepcopy(params_cpu).to("cuda")
        tokens = torch.as_tensor(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (1, 12)))
        one = model.prefill(params_gpu, cfg, {"tokens": tokens.cuda()},
                            max_seq=32)[0]
        for n in (2, 4):
            got = {}
            for dev, prm in (("cuda", params_gpu), ("cpu", params_cpu)):
                d = torch.device(dev, 0) if dev == "cuda" else \
                    torch.device(dev)
                tp = TensorParallelPrefill(prm, cfg, [d] * n, max_seq=32)
                try:
                    got[dev] = tp({"tokens": tokens}) + (tp.ledger,)
                finally:
                    tp.close()
            (g_last, g_kv, g_led), (c_last, c_kv, c_led) = \
                got["cuda"], got["cpu"]
            for a, b, what in [(g_last, c_last.cuda(), "CPU's TP logits"),
                               (g_last, one, "the one-device logits")] + \
                    [(g[k], c[k].cuda(), f"CPU's cache {k}")
                     for g, c in zip(g_kv, c_kv) for k in g]:
                err = float((a - b).abs().max())
                worst = max(worst, err)
                if not err <= SMALL_LOGITS_TOL["atol"]:
                    raise AssertionError(f"TP reduced {arch} x{n}: {err} "
                                         f"from the {what}")
            if g_led != c_led:
                raise AssertionError(f"TP reduced {arch} x{n}: ledger "
                                     f"{g_led} != the CPU's {c_led}")
            nz = {k: v for k, v in g_led["bytes"].items() if v}
            print(f"TP reduced check {arch} x{n} ranks on {card.split(',')[0]}"
                  f": logits and caches within atol 1e-4 of the CPU's TP "
                  f"run and the card's one-device prefill; ledger == the "
                  f"CPU's ({nz} B, counts "
                  f"{ {k: v for k, v in g_led['counts'].items() if v} })",
                  flush=True)
    print(f"phase 11a: worst max_abs_err {worst:.3g} [{card}]", flush=True)


def _record_admissions(b, out):
    """Wrap ``b``'s prefill seam: each admission appends (its tokens, its
    last-row logits, its ms, the card synchronized before and after, its
    fresh KV)."""
    import torch
    inner = b._prefill

    def timed(p, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        last, fresh = inner(p, batch)
        torch.cuda.synchronize()
        out.append((batch["tokens"], last, 1e3 * (time.perf_counter() - t),
                    fresh))
        return last, fresh
    b._prefill = timed


def _tp_expected_bytes(cfg, tokens: int, n: int) -> dict:
    """The ledger's closed form for a TP prefill of ``tokens`` prompt
    tokens over n ranks (per-device result shapes, so the same at every
    n where the heads split the same way): an all-reduce of (S, d) after
    each layer's two row-split products and the embedding; where the
    query heads do not split whole, q, k and v gathered every layer, and
    where only the KV heads do not, k and v."""
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    b = 2 if cfg.dtype == "bfloat16" else 4
    out = {"all-reduce": float((2 * L + 1) * tokens * d * b)}
    cols = 0
    if cfg.num_heads % n:
        cols = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    elif cfg.num_kv_heads % n:
        cols = 2 * cfg.num_kv_heads * hd
    if cols:
        out["all-gather"] = float(L * tokens * cols * b)
    return out


def train_expected_ledger(cfg, B: int, S: int, D: int, M: int, *,
                          blocked: bool, fsdp: bool) -> dict:
    """The ledger's closed form for one partitioned train step of a dense
    GQA stack (ATTN/LOCAL layers, no QK-norm, no MoE) on a (D, M) (data,
    model) mesh under tp_dp_rules, B x S tokens: mesh position (0, 0)'s
    collectives, per-device result bytes and executions by type.  With
    T = B / D x S tokens a rank and e bytes an element, per layer forward:
    an all-reduce of (T, d) after each row-split product (wo where the
    query columns split, the MLP's wo where d_ff splits); q gathered
    (T, H hd) where the split cuts a head, k and v (T, KV hd) each where
    the KV columns do not split into the KV heads the rank's queries
    read.  Backward: an all-reduce of (T, d) at each split product's
    input (Megatron's f: the attention's q, k, v share one where k and v
    split, else k and v (T, KV hd) each get one; the MLP's), a
    reduce-scatter (T, cols / M) for each gather.  The embedding (vocab
    split): an all-reduce of (T, d) forward, and the unembedding's f an
    all-reduce of (T, d) backward; the vocab-parallel loss, a max of (T)
    and a sum of (2, T) in float32.  FSDP: every leaf with a d_model dim
    gathered over data where it is used (its model block, e bytes an
    element), once a forward, and reduce-scattered to its block back (/
    D); without FSDP the gradients (every leaf's model block) summed over
    data in one all-reduce.  The loss averaged over data (4 B); the
    clip's norm one 4-byte all-reduce per set of split axes (model; with
    FSDP data and data x model).  Blocked modes run each layer's forward
    collectives twice (the backward's recompute)."""
    assert cfg.moe is None and not cfg.qk_norm and not cfg.prologue
    e = 2 if cfg.dtype == "bfloat16" else 4
    d, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    V, L = cfg.padded_vocab, cfg.num_layers
    T = B // D * S
    led = {"bytes": {}, "counts": {}}

    def add(kind, nbytes, n=1):
        led["bytes"][kind] = led["bytes"].get(kind, 0.0) + float(nbytes) * n
        led["counts"][kind] = led["counts"].get(kind, 0) + n

    split = (lambda n: M > 1 and n % M == 0)
    q_split, kv_split, mlp_split, v_split = (
        split(H * hd), split(KV * hd), split(F), split(V))
    Mq, Mk, Mf, Mv = (M if s else 1 for s in
                      (q_split, kv_split, mlp_split, v_split))
    # the rank's heads (sharding: _RankHeads at position (0, 0))
    qc, G = H * hd // Mq, H // KV
    Hl = qc // hd
    whole = q_split and qc % hd == 0 and (Hl % G == 0 or G % Hl == 0)
    gather_q = q_split and not whole
    KVl = max(1, Hl // G) if whole else KV
    gather_kv = kv_split and KV * hd // Mk != KVl * hd
    layer_fwd, layer_bwd = [], []
    if q_split:
        layer_fwd.append(("all-reduce", T * d * e))
        if kv_split:
            layer_bwd.append(("all-reduce", T * d * e))
        else:
            layer_bwd += [("all-reduce", T * d * e)] + \
                [("all-reduce", T * KV * hd * e)] * 2
    if gather_q:
        layer_fwd.append(("all-gather", T * H * hd * e))
        layer_bwd.append(("reduce-scatter", T * H * hd // M * e))
    if gather_kv:
        layer_fwd += [("all-gather", T * KV * hd * e)] * 2
        layer_bwd += [("reduce-scatter", T * KV * hd // M * e)] * 2
    if mlp_split:
        layer_fwd.append(("all-reduce", T * d * e))
        layer_bwd.append(("all-reduce", T * d * e))
    # each leaf's model block (elements), one layer's, then the rest
    layer_leaves = [d, d, d * H * hd // Mq, d * KV * hd // Mk,
                    d * KV * hd // Mk, H * hd // Mq * d,
                    d * F // Mf, d * F // Mf, F // Mf * d]
    other = [V // Mv * d, d] + ([] if cfg.tie_embeddings else [V // Mv * d])
    with_fsdp = fsdp and D > 1 and d % D == 0
    if with_fsdp:
        layer_fwd += [("all-gather", n * e) for n in layer_leaves]
        layer_bwd += [("reduce-scatter", n // D * e) for n in layer_leaves]
    for kind, nbytes in layer_fwd * (2 if blocked else 1) + layer_bwd:
        add(kind, nbytes, L)
    if v_split:
        add("all-reduce", T * d * e, 2)            # embedding; unembed's f
        add("all-reduce", T * 4)                    # the loss's max
        add("all-reduce", 2 * T * 4)                # its sums
    if with_fsdp:
        for n in other:
            add("all-gather", n * e)
            add("reduce-scatter", n // D * e)
    if D > 1:
        if not with_fsdp:
            add("all-reduce", (L * sum(layer_leaves) + sum(other)) * e)
        add("all-reduce", 4)                        # the loss
    # the clip's norm: one per set of split axes
    norm_sets = 0
    if with_fsdp:
        norm_sets = 2 if M > 1 else 1
    elif M > 1 and (q_split or mlp_split or v_split):
        norm_sets = 1
    add("all-reduce", 4, norm_sets) if norm_sets else None
    return {k: {t: v for t, v in led[k].items() if v}
            for k in ("bytes", "counts")}


def tp_family(name, cfg, params, plan, reqs, card, *, prefill_devices=None,
              expected=None, phase="11b", per_admission=True):
    """Phase 11b, one model at full width: ``reqs`` on 8 slots of 1024,
    page 16, under ``plan`` (two decode shards), through the disaggregated
    engine on ``devices=[cuda:0] * 4`` (two decode shards, a prefill group
    of two aliased ranks) without and with ``tp_prefill``; with
    ``prefill_devices`` (phase 13c) on one decode shard on the card and
    that prefill group.  Gates: both
    edge ledgers == predict_pool_counters(dense_admit=True), and each
    other; K1's launches the same (and above 0 where the decode reads
    pools); K4's launches with TP twice those without (each of the two
    ranks scans its heads; none without a Mamba layer); the TP ledger's
    bytes == the closed form (``expected(cfg, admissions, ranks)``,
    default ``_tp_expected_bytes``); each admission's last-row logits and
    its fresh caches (every layer's leaves) no farther from an fp32
    one-device prefill's than TP_BF16_RATIO times the bf16 one-device
    prefill's; with ``per_admission`` False (phase 13c) the mean of those
    distances over the admissions, since a Mamba stack's single prompt
    reads them noisily (on the CPU, zamba2-7b's 6 layers in bf16 over 128
    tokens: one device's max_abs from fp32 0.117-0.286 from prompt to
    prompt, TP's 0.67-0.95 of it).  Returns (K1's, K4's) launches with
    TP."""
    import torch
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.models import model
    from repro_torch.serve.engine import predict_pool_counters
    t0 = time.perf_counter()
    preq = [(tuple(int(x) for x in t), DECODE, None, k) for t, k in reqs]
    run = dict(max_seq=MAX_SEQ, slots=SLOTS, decode=DECODE, device="cuda")
    card0 = torch.device("cuda", 0)
    got = {}
    for tp in (False, True):
        adm = []
        got[tp] = serve(params, cfg, plan, reqs, disagg=True,
                        devices=[card0] if prefill_devices else [card0] * 4,
                        prefill_devices=prefill_devices, tp_prefill=tp,
                        on_engine=lambda e, adm=adm: _record_admissions(e,
                                                                        adm),
                        **run)
        if k2.flash_attention.launches or k3.decode_attention.launches:
            raise AssertionError(f"{name} TP={tp}: K2 or K3 launched")
        got[tp]["adm"] = adm
    base, tpr = got[False], got[True]
    b0, b1 = base["b"], tpr["b"]
    if not b1.tp_prefill or b0.tp_prefill or len(b1.prefill_devices) != 2:
        raise AssertionError(f"{name}: tp_prefill not on the 2-rank group")
    pred = predict_pool_counters(
        preq, plan, slots=SLOTS, max_seq=MAX_SEQ, page_tokens=b1.page_tokens,
        row_bytes=b1._row_bytes, dense_admit=True)
    for b in (b0, b1):
        b.mesh_table.check()
        if _ledger(b) != _pred_ledger(pred) or b.counters()["repacks"]:
            raise AssertionError(f"{name}: ledger {_ledger(b)} != predicted "
                                 f"{_pred_ledger(pred)}")
    if tpr["k1"] != base["k1"] or bool(tpr["k1"]) != bool(_n_k1_layers(cfg)):
        raise AssertionError(f"{name}: {tpr['k1']} K1 launches with TP, "
                             f"{base['k1']} without")
    if tpr["k4"] != 2 * base["k4"] or \
            (base["k4"] == 0) != (_n_mamba(cfg) == 0):
        raise AssertionError(f"{name}: {tpr['k4']} K4 launches with TP, "
                             f"{base['k4']} without")
    S = sum(int(t.shape[1]) for t, *_ in tpr["adm"])
    led = b1.counters()["collectives"]
    nz = {k: v for k, v in led["bytes"].items() if v}
    want = _tp_expected_bytes(cfg, S, len(b1.prefill_devices)) \
        if expected is None else \
        expected(cfg, tpr["adm"], len(b1.prefill_devices))
    if nz != want:
        raise AssertionError(f"{name}: collectives {nz} B != the closed "
                             f"form {want} B for {S} prompt tokens")
    # the fp32 one-device prefill of every admitted prompt
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = copy.deepcopy(params).float()
    ratios, kv_ratios, lines, dists = [], [], [], []

    def kv_dist(fresh, fresh32):
        """max_abs over every layer's k and v (the engine's caches hold
        max_seq rows, the prompt's first)."""
        return max(float((a[k][:, :b[k].shape[1]].float() - b[k]).abs()
                         .max()) for a, b in zip(fresh, fresh32) for k in a)

    for (toks, l_bf, ms0, kv_bf), (toks_tp, l_tp, ms1, kv_tp) in zip(
            base["adm"], tpr["adm"]):
        if not torch.equal(toks, toks_tp):
            raise AssertionError(f"{name}: the runs admitted other prompts")
        l32, kv32 = model.prefill(params32, cfg32, {"tokens": toks})
        d_bf = float((l_bf.float() - l32).abs().max())
        d_tp = float((l_tp.float() - l32).abs().max())
        dk_bf, dk_tp = kv_dist(kv_bf, kv32), kv_dist(kv_tp, kv32)
        ratios.append(d_tp / d_bf)
        kv_ratios.append(dk_tp / dk_bf)
        dists.append((d_bf, d_tp, dk_bf, dk_tp))
        lines.append(f"{toks.shape[1]} tokens: {ms0:.1f} ms one device, "
                     f"{ms1:.1f} ms TP; max_abs from fp32 logits bf16 "
                     f"{d_bf:.4f}, TP {d_tp:.4f}; KV bf16 {dk_bf:.4f}, TP "
                     f"{dk_tp:.4f}")
        del kv32
    del params32
    checked = dists if per_admission else [tuple(np.mean(dists, axis=0))]
    for d_bf, d_tp, dk_bf, dk_tp in checked:
        if not d_tp <= TP_BF16_RATIO * d_bf:
            raise AssertionError(f"{name}: TP logits {d_tp} from fp32, over "
                                 f"{TP_BF16_RATIO} x bf16's {d_bf}")
        if not dk_tp <= TP_BF16_RATIO * dk_bf:
            raise AssertionError(f"{name}: TP fresh KV {dk_tp} from fp32, "
                                 f"over {TP_BF16_RATIO} x bf16's {dk_bf}")
    mean = np.mean(dists, axis=0)
    same = sum(a == b for o, p in zip(tpr["seq"], base["seq"])
               for a, b in zip(o, p))
    total = sum(len(o) for o in base["seq"])
    print(f"{name} TP prefill admissions [{card}]: " + "; ".join(lines),
          flush=True)
    print(f"{name} TP prefill check ({cfg.num_layers} layers, 2 aliased "
          f"ranks, {len(b1.decode_devices)} decode shard(s)): ledgers == "
          f"predict_pool_counters(dense_admit=True) with "
          f"and without TP; K1 {tpr['k1']} == without TP; K4 {tpr['k4']} "
          f"(2 x {base['k4']} without TP); collectives "
          f"{nz} B == the closed form for {S} prompt tokens (counts "
          f"{ {k: v for k, v in led['counts'].items() if v} }); TP/bf16 "
          f"distance from fp32, logits {min(ratios):.3f}-{max(ratios):.3f}"
          f", fresh KV {min(kv_ratios):.3f}-{max(kv_ratios):.3f}, of the "
          f"means over the admissions {mean[1] / mean[0]:.3f} and "
          f"{mean[3] / mean[2]:.3f} (limit {TP_BF16_RATIO}, "
          f"{'each admission' if per_admission else 'the means'}); "
          f"{same} of {total} tokens agree with the run "
          f"without TP (not gated: greedy bf16 tokens part at the first "
          f"near-tie and every later token follows); mean admission "
          f"{np.mean([a[2] for a in base['adm']]):.1f} ms one device, "
          f"{np.mean([a[2] for a in tpr['adm']]):.1f} ms TP (aliased ranks "
          f"share the card) [{card}]", flush=True)
    launches = tpr["k1"], tpr["k4"]
    b1.close()
    del got, base, tpr, b0, b1
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{name} phase {phase} took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def check_tp(card):
    """Phase 11: 11a, then 11b on smollm-360m at full depth (phase 3's
    requests under phase 3d's two-shard plan) and internlm2-1.8b at half
    depth (phase 10b's requests and plan).  Returns K1's launches by
    path."""
    import torch
    from repro_torch import runtime
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime import H100_COST
    from repro_torch.runtime.plan import PlacementPlan
    from repro_torch.serve.engine import serve_trace_for
    t0 = time.perf_counter()
    reset_counts()
    check_tp_small(card)
    k1 = {}
    cfg = dataclasses.replace(get_config("smollm-360m"), use_paged_decode=True)
    params = init_params(cfg, seed=0)
    reqs = requests(cfg.vocab_size)
    trace = serve_trace_for(cfg, [(len(t), DECODE, k) for t, k in reqs],
                            slots=SLOTS, block_tokens=PAGE, layer_group=8,
                            shared_prefix_tokens=256, params=params)
    plan = runtime.plan_serving(trace, H100_COST, 0.2 * trace.peak_kv_bytes(),
                                objective="latency", decode_devices=2)
    k1["smollm-360m TP prefill, two aliased shards (phase 11b)"] = \
        tp_family("smollm-360m", cfg, params, plan, reqs, card)[0]
    del params
    cfg = _half_depth(dataclasses.replace(get_config("internlm2-1.8b"),
                                          use_paged_decode=True))
    params = init_params(cfg, seed=0)
    lengths = np.random.default_rng(26).integers(300, 513, 12)
    reqs = family_requests(cfg.vocab_size, lengths, seed=27)
    plan = PlacementPlan(hot_window=192, page_tokens=PAGE,
                         slot_hot_windows=[128 + 16 * s for s in range(SLOTS)],
                         slot_devices=[s % 2 for s in range(SLOTS)])
    k1["internlm2-1.8b TP prefill, two aliased shards (phase 11b)"] = \
        tp_family("internlm2-1.8b", cfg, params, plan, reqs, card)[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)
    return k1


# ------------------------------- the partitioned train step (phase 12) --

TP_TRAIN_SMALL = ("smollm-360m", "granite-moe-3b-a800m")
TP_TRAIN_MESH = (2, 2)                # (data, model), all on cuda:0
# 12a's full-width cases: smollm-360m at 2 layers in fp32, whose 15/5
# heads of 64 a model axis of 2 cuts (q, k and v gathered, their
# gathers' backward a reduce-scatter): (mesh, mode, FSDP)
TP_TRAIN_WIDE = (((1, 2), "full", False), ((2, 2), "full", True),
                 ((2, 2), "offload", True))
# 12b: B x S.  Phase 5c's S; B 4, not 5c's 8, from an estimate (B 8 not
# tried): four ranks' full mode rose 41.65 GB at B 4, nearly all of it
# activations, which B 8 doubles to about 83 GB
TP_TRAIN = (4, 1024)
TP_TRAIN_STEPS = 2
# 12b: the partitioned bf16 step against the one-device bf16 step, step by
# step (argued from bf16 rounding in PERF.md): the loss within 2**-10 of
# it, the gradient norm (before the clip) within 2**-6
TP_TRAIN_LOSS_RTOL = 2.0 ** -10
TP_TRAIN_GNORM_RTOL = 2.0 ** -6
# 12b: each leaf's first-step gradient, the four ranks' blocks put
# together, against one device's: |g - g1| / |g1| at most this, 2.7 times
# the worst leaf measured (PERF.md); a rank's wrong block reads about 0.5
TP_TRAIN_LEAF_RTOL = 0.1
# 12a: AdamW's first step at lr 1 with eps 1 moves each parameter by
# about its clipped gradient, so the parameters compare the gradients
TP_SMALL_OPT = dict(lr=1.0, warmup_steps=1, eps=1.0)


def _tp_train_cfg(arch):
    """The reduced config; a MoE's dispatch groups cut to 16 tokens, so
    each lies within one data rank's rows; "+e6": 6 experts, which a
    model axis of 4 does not divide (ROADMAP F4)."""
    from repro_torch.configs import get_config
    arch, _, experts = arch.partition("+e")
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=16,
            num_experts=int(experts or cfg.moe.num_experts)))
    return cfg


def _replicas_agree(step, states, what):
    """Every leaf replicated over a mesh axis holds the same value, bit
    for bit, on every rank of that axis.  Returns the pairs compared."""
    import torch
    from repro_torch import sharding as shd
    named = [dict(s["params"].named_parameters()) for s in states]
    pairs = 0
    for name, spec in states[0]["params"].shard_specs.items():
        seen = {}
        for i, pos in enumerate(step.positions):
            key = shd.block_coords(spec, pos, step.rules.mesh)
            if key in seen:
                if not torch.equal(named[i][name], named[seen[key]][name]):
                    raise AssertionError(f"{what}: {name} differs between "
                                         f"replicas {pos} and "
                                         f"{step.positions[seen[key]]}")
                pairs += 1
            else:
                seen[key] = i
    return pairs


def _tp_small_case(cfg, params, batch, shape, scfg, fsdp, what, *,
                   cpu_tol=None, rel=0.0, seq_parallel=False):
    """One step of the partitioned train step on ``shape`` of [cuda:0]
    and of [cpu] at every position, and the card's one-device step, from
    ``params`` and ``batch``: their loss, gradient norm and every
    reassembled parameter within SMALL_LOSS_TOL of one device's and within
    ``cpu_tol`` (atol and rtol; default SMALL_LOSS_TOL) of the CPU's, each
    absolute part widened to ``rel`` x the largest |value| compared where
    that is larger (XLSTM_REL for the ill-conditioned reduced xLSTM), the
    ledgers equal, every replicated leaf equal across its
    ranks; ``seq_parallel``: under Megatron-SP rules.  Returns {"one",
    "cpu": the worst distance from each, "pairs": the replica pairs
    compared, "k4": K4's launches in the card's partitioned step, counted
    from 0 before it, "launches": every kernel's}."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    ocfg = adamw.OptConfig(**TP_SMALL_OPT)
    n = shape[0] * shape[1]
    worst, pairs, got = {"one": 0.0, "cpu": 0.0}, 0, {}
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        reset_counts()
        mesh = shd.Mesh(shape, ("data", "model"), devices=[dev] * n)
        step = loop.make_train_step(cfg, scfg, ocfg,
                                    shd.tp_dp_rules(
                                        mesh, fsdp=fsdp,
                                        seq_parallel=seq_parallel))
        try:
            states = step.init_states(copy.deepcopy(params).to(dev))
            states, m = step(states, {k: v.to(dev) for k, v in batch.items()})
            pairs += _replicas_agree(step, states, f"{what} on {dev}")
            ranks = {(float(r["loss"]), float(r["grad_norm"]))
                     for r in m["ranks"]}
            if len(ranks) != 1:
                raise AssertionError(f"{what} on {dev}: the ranks disagree: "
                                     f"{ranks}")
            got[dev.type] = (m, step.gather(states, "cpu"), step.ledger,
                             _launch_counts())
        finally:
            step.close()
    one = init_params(cfg, device="cuda", requires_grad=True)
    one.load_state_dict(params.state_dict())
    st = {"params": one,
          "opt": adamw.init(one, ocfg, offload=scfg.offload_opt_state),
          "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    st, m1 = loop.make_train_step(cfg, scfg, ocfg)(
        st, {k: v.cuda() for k, v in batch.items()})
    (mg, pg, lg, launches), (mc, pc, lc, _) = got["cuda"], got["cpu"]
    if lg != lc:
        raise AssertionError(f"{what}: ledger {lg} != the CPU's {lc}")
    refs = (("cpu", "the CPU's", cpu_tol or SMALL_LOSS_TOL),
            ("one", "one device's", SMALL_LOSS_TOL))
    for (key, rname, tol), ref in zip(refs, (mc, m1)):
        for k in ("loss", "grad_norm"):
            err = abs(float(mg[k]) - float(ref[k]))
            worst[key] = max(worst[key], err)
            atol = max(tol["atol"], rel * abs(float(ref[k])))
            if not err <= atol + tol["rtol"] * abs(float(ref[k])):
                raise AssertionError(f"{what}: {k} {float(mg[k])} against "
                                     f"{rname} {float(ref[k])}")
    for (name, a), (_, b), (_, c) in zip(pg.named_parameters(),
                                         pc.named_parameters(),
                                         st["params"].named_parameters()):
        for (key, rname, tol), ref in zip(refs, (b, c.detach().cpu())):
            err = float((a - ref).abs().max())
            worst[key] = max(worst[key], err)
            atol = max(tol["atol"], rel * float(ref.abs().max()))
            if not bool(((a - ref).abs() <=
                         atol + tol["rtol"] * ref.abs()).all()):
                raise AssertionError(f"{what}: {name} {err} from {rname}")
    return dict(worst, pairs=pairs, k4=launches["ssd"], launches=launches)


def check_tp_train_small(note):
    """Phase 12a: smollm-360m and granite-moe-3b reduced in fp32, one
    step of the partitioned train step on a (2, 2) mesh of [cuda:0] * 4
    and of [cpu] * 4 and the card's one-device step, from the same
    parameters and batch (B 4 x S 16), in each mode at MI 1 (offload with
    the moments in pinned host memory), FSDP off and on; then smollm-360m
    at full width, 2 layers, fp32, in TP_TRAIN_WIDE's cases, whose cut
    heads run the gathers of q, k and v and their reduce-scatter
    backward.  Gates (``_tp_small_case``): the loss, the gradient norm
    and every reassembled parameter on the card within atol 1e-4 of the
    CPU's and of one device's; the ledgers equal type for type; every
    replicated leaf equal across its ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.offload import SentinelConfig
    from repro_torch.models.model import init_params
    worst, runs, pairs = 0.0, 0, 0

    def case(cfg, params, batch, shape, mode, fsdp, what):
        nonlocal worst, runs, pairs
        scfg = SentinelConfig(mode=mode, mi_periods=1,
                              offload_opt_state=mode == "offload")
        r = _tp_small_case(cfg, params, batch, shape, scfg, fsdp,
                           f"{what} {shape} {mode} fsdp={fsdp}")
        worst = max(worst, r["one"], r["cpu"])
        runs, pairs = runs + 1, pairs + r["pairs"]

    def batch_of(cfg):
        rng = np.random.default_rng(12)
        return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)))
                for k in ("tokens", "labels")}

    for arch in TP_TRAIN_SMALL:
        cfg = _tp_train_cfg(arch)
        params = init_params(cfg, seed=0, device="cpu")
        batch = batch_of(cfg)
        for mode in MODES:
            for fsdp in (False, True):
                case(cfg, params, batch, TP_TRAIN_MESH, mode, fsdp,
                     f"{arch} reduced")
        del params
        release_pinned()
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    for shape, mode, fsdp in TP_TRAIN_WIDE:
        case(cfg, params, batch_of(cfg), shape, mode, fsdp,
             "smollm-360m full width, 2 layers")
    del params
    release_pinned()
    note("partitioned reduced training")
    print(f"phase 12a: {runs} partitioned steps ({', '.join(TP_TRAIN_SMALL)} "
          f"reduced, fp32, (2, 2) of [cuda:0] * 4, 4 modes x FSDP off/on; "
          f"smollm-360m full width, 2 layers, fp32, heads cut, (mesh, mode,"
          f" FSDP) {TP_TRAIN_WIDE}): loss, gradient norm and every "
          f"reassembled parameter within atol {SMALL_LOSS_TOL['atol']:g} of "
          f"[cpu] * n's and of the card's one-device step (max_abs_err "
          f"{worst:.3g}); ledgers == the CPU's; {pairs} replica pairs equal "
          f"bit for bit", flush=True)


class _Leaves:
    """Gradients by leaf name, in the shape ``sharding.gather_params``
    reads a rank's module in."""

    def __init__(self, grads):
        self.grads = grads

    def named_parameters(self):
        return iter(self.grads.items())


@contextlib.contextmanager
def _first_grads(out: dict):
    """While open, every ``adamw.update`` keeps a copy of the gradients it
    is given in ``out``, under the caller's mesh position (() on one
    device)."""
    from repro_torch import sharding as shd
    from repro_torch.optim import adamw
    real, lock = adamw.update, threading.Lock()

    def update(grads, state, params, cfg):
        ctx = shd.current_rank()
        key = () if ctx is None else tuple(ctx.coords.values())
        kept = {k: g.detach().clone() for k, g in grads.items()}
        with lock:
            out[key] = kept
        return real(grads, state, params, cfg)

    adamw.update = update
    try:
        yield
    finally:
        adamw.update = real


def _leaf_distances(step, grads, one, like) -> dict:
    """Per leaf, |g - g1| / |g1| in f32: ``grads`` the ranks' blocks (by
    mesh position, ``_first_grads``) put together, ``one`` one device's
    gradients."""
    import torch
    from repro_torch import sharding as shd
    whole = shd.gather_params(
        [_Leaves(grads[tuple(pos.values())]) for pos in step.positions],
        step.positions, step.rules, like)
    out = {}
    for name, g in whole.named_parameters():
        g1 = one[name].float()
        out[name] = float((g.float() - g1).norm() /
                          torch.clamp(g1.norm(), min=1e-30))
    return out


def train_tp_full(card, note, mi):
    """Phase 12b: smollm-360m at full width and depth, bf16, TP_TRAIN
    tokens from make_batch, TP_TRAIN_STEPS steps in full and in offload at
    MI ``mi``: the card's one-device step, then the partitioned step on a
    (2, 2) mesh of [cuda:0] * 4 under tp_dp_rules(fsdp=True), each from
    seed 0's parameters.  Gates: each step's loss and gradient norm
    within TP_TRAIN_LOSS_RTOL and TP_TRAIN_GNORM_RTOL of one device's, and
    offload's within MODE_LOSS_RTOL and MODE_GNORM_RTOL of full's (both
    partitioned); each step's ledger == train_expected_ledger; offload's
    carries on each rank == estimate_offload_traffic for its rows.  Step
    ms (the median of the steps after the first) and peak memory
    printed."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.collectives import new_ledger
    from repro_torch.configs import get_config
    from repro_torch.core import offload
    from repro_torch.core.profiler import TraceProfile
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    t0 = time.perf_counter()
    cfg = get_config("smollm-360m")
    B, S = TP_TRAIN
    D, M = TP_TRAIN_MESH
    ocfg = adamw.OptConfig(total_steps=TP_TRAIN_STEPS, warmup_steps=1)
    dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=S,
                      global_batch=B)
    batches = [make_batch(dcfg, s) for s in range(TP_TRAIN_STEPS)]
    params = init_params(cfg, seed=0)
    carry = B // D * S * cfg.d_model * 2
    est = offload.estimate_offload_traffic(
        TraceProfile(num_periods=cfg.num_periods, num_steps=0), mi, carry)
    mesh = shd.Mesh(TP_TRAIN_MESH, ("data", "model"),
                    devices=[torch.device("cuda", 0)] * (D * M))
    rules = shd.tp_dp_rules(mesh, fsdp=True)
    like = init_params(cfg, device="meta")
    res = {}

    def run(mode, partitioned):
        scfg = offload.SentinelConfig(mode=mode, mi_periods=mi)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if partitioned:
            step = loop.make_train_step(cfg, scfg, ocfg, rules)
            state = step.init_states(params)
        else:
            step = loop.make_train_step(cfg, scfg, ocfg)
            p = init_params(cfg, requires_grad=True)
            p.load_state_dict(params.state_dict())
            state = {"params": p, "opt": adamw.init(p, ocfg),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device="cuda")}
        out = dict(losses=[], gnorms=[], times=[], ledgers=[], carries=[],
                   grads={})
        try:
            for s in range(TP_TRAIN_STEPS):
                offload.reset_traffic()
                before = copy.deepcopy(step.ledger) if partitioned else None
                torch.cuda.synchronize()
                ts = time.perf_counter()
                if s == 0:
                    with _first_grads(out["grads"]):
                        state, m = step(state, batches[s])
                else:
                    state, m = step(state, batches[s])
                out["losses"].append(float(m["loss"]))
                out["gnorms"].append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                out["times"].append(time.perf_counter() - ts)
                out["carries"].append(copy.deepcopy(offload.rank_traffic))
                if partitioned:
                    led = new_ledger()
                    for part in ("bytes", "counts"):
                        for k, v in step.ledger[part].items():
                            led[part][k] = v - before[part][k]
                    out["ledgers"].append(
                        {k: {t: v for t, v in led[k].items() if v}
                         for k in ("bytes", "counts")})
                    ranks = {(float(r["loss"]), float(r["grad_norm"]))
                             for r in m["ranks"]}
                    if len(ranks) != 1:
                        raise AssertionError(f"12b {mode}: the ranks "
                                             f"disagree: {ranks}")
            torch.cuda.synchronize()
            if partitioned:
                out["pairs"] = _replicas_agree(step, state, f"12b {mode}")
                out["leaf"] = _leaf_distances(
                    step, out["grads"], res[mode, False]["grads"][()], like)
        finally:
            if partitioned:
                step.close()
        out["peak"] = torch.cuda.max_memory_allocated()
        out["rise"] = out["peak"] - held
        del state
        release_pinned()
        return out

    for mode in ("full", "offload"):
        res[mode, False] = run(mode, False)
        res[mode, True] = run(mode, True)
        for k in (False, True):
            res[mode, k].pop("grads")
        note(f"smollm-360m partitioned training, {mode}")
    del params
    lines = []
    for mode in ("full", "offload"):
        one, tp = res[mode, False], res[mode, True]
        want = train_expected_ledger(cfg, B, S, D, M,
                                     blocked=mode != "full", fsdp=True)
        leaf = tp["leaf"]
        far = max(leaf, key=leaf.get)
        if not leaf[far] <= TP_TRAIN_LEAF_RTOL:
            raise AssertionError(f"12b {mode}: {far}'s first-step gradient "
                                 f"is {leaf[far]} of one device's away from"
                                 f" it (limit {TP_TRAIN_LEAF_RTOL})")
        for s in range(TP_TRAIN_STEPS):
            a, b = tp["losses"][s], one["losses"][s]
            g, h = tp["gnorms"][s], one["gnorms"][s]
            if not (np.isfinite(a) and abs(a - b) <= TP_TRAIN_LOSS_RTOL * b
                    and np.isfinite(g)
                    and abs(g - h) <= TP_TRAIN_GNORM_RTOL * h):
                raise AssertionError(f"12b {mode} step {s}: partitioned loss "
                                     f"{a}, gradient norm {g}; one device's "
                                     f"{b}, {h}")
            if tp["ledgers"][s] != want:
                raise AssertionError(f"12b {mode} step {s}: ledger "
                                     f"{tp['ledgers'][s]} != the closed form "
                                     f"{want}")
            if mode == "offload":
                per_rank = tp["carries"][s]
                if len(per_rank) != D * M or any(
                        t["d2h"] + t["h2d"] != est["bytes_offloaded"] or
                        t["out"] != t["in"] or t["in"] != est["blocks"]
                        for t in per_rank.values()):
                    raise AssertionError(f"12b offload step {s}: carries "
                                         f"{per_rank}, estimate {est} a rank")
        lines.append(
            f"{mode}: losses one device "
            f"{', '.join(f'{x:.6f}' for x in one['losses'])}, partitioned "
            f"{', '.join(f'{x:.6f}' for x in tp['losses'])}; gradient norms "
            f"{', '.join(f'{x:.6g}' for x in one['gnorms'])} / "
            f"{', '.join(f'{x:.6g}' for x in tp['gnorms'])}; step ms one "
            f"device {', '.join(f'{1e3 * t:.1f}' for t in one['times'])}, "
            f"partitioned {', '.join(f'{1e3 * t:.1f}' for t in tp['times'])}"
            f" ({tp['times'][-1] / one['times'][-1]:.2f} times); peak "
            f"{one['peak'] / 1e9:.2f} GB one device, {tp['peak'] / 1e9:.2f} "
            f"GB four ranks (rise {tp['rise'] / 1e9:.2f} GB); ledger a step "
            f"{want['bytes']} B, counts {want['counts']}; first-step "
            f"gradients |g - g1| / |g1| by leaf: median "
            f"{float(np.median(list(leaf.values()))):.4g}, worst "
            f"{leaf[far]:.4g} ({far}) of {len(leaf)}; {tp['pairs']} replica "
            f"pairs equal bit for bit")
    full, off = res["full", True], res["offload", True]
    for s in range(TP_TRAIN_STEPS):
        a, b = off["losses"][s], full["losses"][s]
        g, h = off["gnorms"][s], full["gnorms"][s]
        if not (abs(a - b) <= MODE_LOSS_RTOL * b
                and abs(g - h) <= MODE_GNORM_RTOL * h):
            raise AssertionError(f"12b step {s}: partitioned offload {a}, "
                                 f"{g}; partitioned full {b}, {h}")
    print(f"phase 12b, smollm-360m (32 layers, bf16, B {B} x S {S}) on "
          f"{TP_TRAIN_MESH} (data, model) of [cuda:0] * 4 with FSDP, MI "
          f"{mi}, against one device [{card}]: " + "; ".join(lines) +
          f"; losses within {TP_TRAIN_LOSS_RTOL:g} and gradient norms within "
          f"{TP_TRAIN_GNORM_RTOL:g} of one device's, each leaf's first-step "
          f"gradient within {TP_TRAIN_LEAF_RTOL:g} of one device's, offload "
          f"== full "
          f"(partitioned), ledgers == the closed form, offload's carries == "
          f"estimate_offload_traffic on each rank ({est['blocks']} blocks x 2"
          f" x {carry} B); 12b took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def check_tp_train(card, mi=None):
    """Phase 12: 12a, then 12b at MI ``mi`` (phase 5c's planned MI; when
    run alone, planned again as 5c plans it).  Returns each kernel's
    launches on each path (all 0)."""
    t0 = time.perf_counter()
    if mi is None:
        from repro_torch.configs import get_config
        mi = plan_step(get_config("smollm-360m"), *SMOLLM_TRAIN,
                       card)[2].mi_periods
    paths = _no_kernel_paths((
        ("smollm-360m and granite-moe-3b reduced partitioned training "
         "(phase 12a)", check_tp_train_small),
        ("smollm-360m partitioned training, full and offload (phase 12b)",
         lambda note: train_tp_full(card, note, mi))))
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s; K1-K4 launches "
          f"on its paths: {paths}", flush=True)
    return paths


# ------------------------- MLA and Mamba under a rank context (phase 13) --

TP_FAMILIES = ("zamba2-7b", "deepseek-v2-lite-16b")
# 13a: the two reduced models and granite with 6 experts (ROADMAP F4: the
# banks split on the expert hidden dim at a model axis of 4), each on
# (2, 2) in the four modes x FSDP off/on, and (1, 2) in full where the
# heads and w_in's columns split otherwise
TP_FAMILIES_SMALL = TP_FAMILIES + ("granite-moe-3b-a800m+e6",)
TP_FAMILIES_OTHER = {"deepseek-v2-lite-16b": (1, 2), "zamba2-7b": (1, 2),
                     "granite-moe-3b-a800m+e6": (2, 4)}
# 13b and 13c: full width at reduced depth, zamba2-7b on its Mamba
# prologue and one period (5 Mamba layers and the shared block, 0.71 B
# parameters) and deepseek-v2-lite on its dense first layer and 2 MoE
# layers (1.67 B), for the script's time limit
TP_FAMILIES_LAYERS = {"zamba2-7b": 6, "deepseek-v2-lite-16b": 3}
TP_FAMILIES_TRAIN = (2, 1024)         # B x S of 13b


def _tp_family_cfg(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch),
                               num_layers=TP_FAMILIES_LAYERS[arch])


def check_tp_families_small():
    """Phase 13a: each TP_FAMILIES_SMALL config reduced in fp32 (a MoE's
    groups cut to 16 tokens), one step of the partitioned train step on a
    (2, 2) mesh of [cuda:0] * 4 and of [cpu] * 4 and the card's one-device
    step from the same parameters and batch (B 4 x S 16), in each mode at
    MI 1 (offload with the moments in pinned host memory), FSDP off and
    on, and in full on TP_FAMILIES_OTHER's mesh; the gates of 12a
    (``_tp_small_case``), and K4's launches in each partitioned card step
    == ranks x the Mamba layers' forwards and recomputes
    (``_blocked_mambas``).  Returns every kernel's launches in those
    steps."""
    import torch
    from repro_torch.core.offload import SentinelConfig
    from repro_torch.models.model import init_params
    worst, runs, pairs, launches = {}, 0, 0, _counts()
    for arch in TP_FAMILIES_SMALL:
        cfg = _tp_train_cfg(arch)
        params = init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(13)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)))
                 for k in ("tokens", "labels")}
        cases = [(TP_TRAIN_MESH, mode, fsdp) for mode in MODES
                 for fsdp in (False, True)]
        cases.append((TP_FAMILIES_OTHER[arch], "full", False))
        for shape, mode, fsdp in cases:
            scfg = SentinelConfig(mode=mode, mi_periods=1,
                                  offload_opt_state=mode == "offload")
            what = f"{arch} reduced {shape} {mode} fsdp={fsdp}"
            # K4 on the card against its plain version on the CPU: 5b's
            # limits for the reduced zamba2's gradients
            r = _tp_small_case(cfg, params, batch, shape, scfg, fsdp, what,
                               cpu_tol=SMALL_GRAD_TOL if _n_mamba(cfg)
                               else SMALL_LOSS_TOL)
            want = shape[0] * shape[1] * _blocked_mambas(cfg, scfg)
            if r["k4"] != want:
                raise AssertionError(f"{what}: {r['k4']} K4 launches, {want} "
                                     f"expected")
            for k in ("one", "cpu"):
                worst[arch, k] = max(worst.get((arch, k), 0.0), r[k])
            runs, pairs = runs + 1, pairs + r["pairs"]
            for k, v in r["launches"].items():
                launches[k] += v
        del params
        release_pinned()
    print(f"phase 13a: {runs} partitioned steps ({', '.join(TP_FAMILIES_SMALL)}"
          f" reduced, fp32, (2, 2) of [cuda:0] * 4 in 4 modes x FSDP off/on,"
          f" and {TP_FAMILIES_OTHER} in full): loss, gradient norm and every "
          f"reassembled parameter within atol {SMALL_LOSS_TOL['atol']:g} of "
          f"the card's one-device step and of [cpu] * n's (zamba2: K4 on the"
          f" card, its plain version on the CPU, so phase 5b's atol "
          f"{SMALL_GRAD_TOL['atol']:g} + rtol {SMALL_GRAD_TOL['rtol']:g}); "
          f"max_abs_err from one device / the CPU: " + ", ".join(
              f"{a} {worst[a, 'one']:.3g} / {worst[a, 'cpu']:.3g}"
              for a in TP_FAMILIES_SMALL) +
          f"; ledgers == the CPU's; {pairs} replica pairs equal "
          f"bit for bit; K4 {launches['ssd']} launches on the ranks' heads =="
          f" ranks x (Mamba layers + their recomputes) a step; launches "
          f"{launches}", flush=True)
    return launches


def _rel(g, ref) -> float:
    """|g - ref| / |ref| in f32."""
    import torch
    ref = ref.float()
    return float((g.float() - ref).norm() / torch.clamp(ref.norm(),
                                                         min=1e-30))


def _dryrun_train_ledger(cfg, rules, scfg, ocfg, B, S):
    """The dry run's ledger (``launch/dryrun.rank_collectives``, mesh
    position (0, 0) on the meta device) of one step of ``cfg``'s train
    cell at B x S under ``rules``: what the partitioned step on the card
    must move, type for type."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    fn, args, in_sh = specs.build_train_cell(
        cfg, ShapeConfig("13b", S, B, "train"), rules, scfg, ocfg)
    led = dryrun.rank_collectives(fn, args, in_sh, rules)
    return {k: {t: v for t, v in led[k].items() if v}
            for k in ("bytes", "counts")}


def train_tp_families_full(arch, card):
    """Phase 13b, one model at full width on TP_FAMILIES_LAYERS, bf16 from
    seed 0, TP_FAMILIES_TRAIN tokens from make_batch (``_train_tp_full``).
    Returns every kernel's launches in the partitioned steps."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    cfg = _tp_family_cfg(arch)
    B, S = TP_FAMILIES_TRAIN
    dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=S,
                      global_batch=B)
    return _train_tp_full(arch, cfg, [make_batch(dcfg, s) for s in
                                      range(TP_TRAIN_STEPS)], card,
                          "13b")


def _train_tp_full(arch, cfg, batches, card, phase):
    """One model at full width, bf16 from seed 0, one of ``batches`` a
    step (TP_TRAIN_STEPS of them), in full and in offload at MI 1: the
    card's one-device step, then the partitioned step on (2, 2) of
    [cuda:0] * 4 under tp_dp_rules(fsdp=True).  Gates (12b's): each
    step's loss and gradient norm within TP_TRAIN_LOSS_RTOL and
    TP_TRAIN_GNORM_RTOL of one device's; each
    leaf's first-step gradient within TP_TRAIN_LEAF_RTOL of one device's,
    or, for a leaf bf16 itself moves that far (a sum with cancellation,
    as Mamba's D over B x S x P; a MoE router or bank, whose bf16
    gradient follows near-tied top-k choices), no farther from the
    one-device fp32 step's than TP_BF16_RATIO times the one-device bf16
    step's (phase 11b's argument for logits);
    offload within MODE_LOSS_RTOL and MODE_GNORM_RTOL of full (both
    partitioned); every replicated leaf equal across its ranks; each
    step's ledger == the dry run's ledger of the same step
    (``_dryrun_train_ledger``); K4's launches in the partitioned steps ==
    steps x ranks x (Mamba layers + recomputes).  Returns every kernel's
    launches in the partitioned steps."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.collectives import new_ledger
    from repro_torch.core import offload
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    t0 = time.perf_counter()
    B, S = batches[0]["tokens"].shape[:2]
    D, M = TP_TRAIN_MESH
    ocfg = adamw.OptConfig(total_steps=TP_TRAIN_STEPS, warmup_steps=1)
    batches = [{k: v.to("cuda") for k, v in b.items()} for b in batches]
    params = init_params(cfg, seed=0)
    mesh = shd.Mesh(TP_TRAIN_MESH, ("data", "model"),
                    devices=[torch.device("cuda", 0)] * (D * M))
    rules = shd.tp_dp_rules(mesh, fsdp=True)
    like = init_params(cfg, device="meta")
    res = {}
    # the one-device fp32 step's first-step gradients, the reference a
    # leaf that bf16 moves past TP_TRAIN_LEAF_RTOL is held to
    g32 = {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = init_params(cfg32, requires_grad=True)
    p32.load_state_dict({k: v.float() for k, v in params.state_dict()
                         .items()})
    st32 = {"params": p32, "opt": adamw.init(p32, ocfg),
            "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    with _first_grads(g32):
        loop.make_train_step(cfg32, offload.SentinelConfig(mode="full"),
                             ocfg)(st32, batches[0])
    g32 = g32[()]
    del p32, st32
    gc.collect()
    torch.cuda.empty_cache()

    def run(mode, partitioned):
        scfg = offload.SentinelConfig(mode=mode, mi_periods=1)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if partitioned:
            step = loop.make_train_step(cfg, scfg, ocfg, rules)
            state = step.init_states(params)
        else:
            step = loop.make_train_step(cfg, scfg, ocfg)
            p = init_params(cfg, requires_grad=True)
            p.load_state_dict(params.state_dict())
            state = {"params": p, "opt": adamw.init(p, ocfg),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device="cuda")}
        out = dict(losses=[], gnorms=[], times=[], ledgers=[], grads={},
                   want=_dryrun_train_ledger(cfg, rules, scfg, ocfg, B, S)
                   if partitioned else None)
        reset_counts()
        try:
            for s in range(TP_TRAIN_STEPS):
                before = copy.deepcopy(step.ledger) if partitioned else None
                torch.cuda.synchronize()
                ts = time.perf_counter()
                if s == 0:
                    with _first_grads(out["grads"]):
                        state, m = step(state, batches[s])
                else:
                    state, m = step(state, batches[s])
                out["losses"].append(float(m["loss"]))
                out["gnorms"].append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                out["times"].append(time.perf_counter() - ts)
                if partitioned:
                    led = new_ledger()
                    for part in ("bytes", "counts"):
                        for k, v in step.ledger[part].items():
                            led[part][k] = v - before[part][k]
                    out["ledgers"].append(
                        {k: {t: v for t, v in led[k].items() if v}
                         for k in ("bytes", "counts")})
                    ranks = {(float(r["loss"]), float(r["grad_norm"]))
                             for r in m["ranks"]}
                    if len(ranks) != 1:
                        raise AssertionError(f"{phase} {arch} {mode}: the "
                                             f"ranks "
                                             f"disagree: {ranks}")
            torch.cuda.synchronize()
            out["launches"] = _launch_counts()
            out["k4"] = out["launches"]["ssd"]
            want = TP_TRAIN_STEPS * (D * M if partitioned else 1) * \
                _blocked_mambas(cfg, scfg)
            if out["k4"] != want:
                raise AssertionError(f"{phase} {arch} {mode}: {out['k4']} K4 "
                                     f"launches, {want} expected")
            if partitioned:
                out["pairs"] = _replicas_agree(step, state,
                                               f"{phase} {arch} {mode}")
                g1 = res[mode, False]["grads"][()]
                whole = dict(shd.gather_params(
                    [_Leaves(out["grads"][tuple(pos.values())])
                     for pos in step.positions], step.positions, step.rules,
                    like).named_parameters())
                out["leaf"], out["leaf32"] = {}, {}
                for name, g in whole.items():
                    out["leaf"][name] = _rel(g, g1[name])
                    if out["leaf"][name] > TP_TRAIN_LEAF_RTOL:
                        out["leaf32"][name] = (_rel(g, g32[name]),
                                               _rel(g1[name], g32[name]))
                del whole
        finally:
            if partitioned:
                step.close()
        out["peak"] = torch.cuda.max_memory_allocated()
        del state
        release_pinned()
        return out

    for mode in ("full", "offload"):
        res[mode, False] = run(mode, False)
        res[mode, True] = run(mode, True)
        for k in (False, True):
            res[mode, k].pop("grads")
    del params
    lines = []
    for mode in ("full", "offload"):
        one, tp = res[mode, False], res[mode, True]
        leaf, leaf32 = tp["leaf"], tp["leaf32"]
        far = max(leaf, key=leaf.get)
        for name, (d_tp, d_bf) in leaf32.items():
            if not d_tp <= TP_BF16_RATIO * d_bf:
                raise AssertionError(
                    f"{phase} {arch} {mode}: {name}'s first-step gradient is "
                    f"{leaf[name]} of one device's away from it (limit "
                    f"{TP_TRAIN_LEAF_RTOL}), and {d_tp} of the fp32 step's "
                    f"against one device's bf16 {d_bf} (limit "
                    f"{TP_BF16_RATIO} times)")
        past = "; ".join(f"{k} {leaf[k]:.4g} (from fp32 {a:.4g}, bf16 one "
                         f"device {b:.4g})" for k, (a, b) in
                         sorted(leaf32.items(), key=lambda kv: -leaf[kv[0]]))
        for s in range(TP_TRAIN_STEPS):
            a, b = tp["losses"][s], one["losses"][s]
            g, h = tp["gnorms"][s], one["gnorms"][s]
            if not (np.isfinite(a) and abs(a - b) <= TP_TRAIN_LOSS_RTOL * b
                    and np.isfinite(g)
                    and abs(g - h) <= TP_TRAIN_GNORM_RTOL * h):
                raise AssertionError(f"{phase} {arch} {mode} step {s}: "
                                     f"partitioned loss {a}, gradient norm "
                                     f"{g}; one device's {b}, {h}")
            if tp["ledgers"][s] != tp["want"]:
                raise AssertionError(f"{phase} {arch} {mode} step {s}: ledger "
                                     f"{tp['ledgers'][s]} != the dry run's "
                                     f"{tp['want']}")
        lines.append(
            f"{mode}: losses one device "
            f"{', '.join(f'{x:.6f}' for x in one['losses'])}, partitioned "
            f"{', '.join(f'{x:.6f}' for x in tp['losses'])}; gradient norms "
            f"{', '.join(f'{x:.6g}' for x in one['gnorms'])} / "
            f"{', '.join(f'{x:.6g}' for x in tp['gnorms'])}; step ms one "
            f"device {', '.join(f'{1e3 * t:.1f}' for t in one['times'])}, "
            f"partitioned {', '.join(f'{1e3 * t:.1f}' for t in tp['times'])}"
            f"; peak {one['peak'] / 1e9:.2f} GB one device, "
            f"{tp['peak'] / 1e9:.2f} GB four ranks; ledger a step "
            f"{tp['want']['bytes']} B, counts {tp['want']['counts']}; "
            f"first-step gradients |g - g1| / |g1| by leaf: median "
            f"{float(np.median(list(leaf.values()))):.4g}, worst "
            f"{leaf[far]:.4g} ({far}) of {len(leaf)}; past "
            f"{TP_TRAIN_LEAF_RTOL:g}: {past or 'none'}; {tp['pairs']} replica "
            f"pairs equal bit for bit; K4 {tp['k4']} launches partitioned, "
            f"{one['k4']} on one device")
    full, off = res["full", True], res["offload", True]
    same = full["losses"] == off["losses"] and full["gnorms"] == off["gnorms"]
    for s in range(TP_TRAIN_STEPS):
        a, b = off["losses"][s], full["losses"][s]
        g, h = off["gnorms"][s], full["gnorms"][s]
        if not (abs(a - b) <= MODE_LOSS_RTOL * b
                and abs(g - h) <= MODE_GNORM_RTOL * h):
            raise AssertionError(f"{phase} {arch} step {s}: partitioned "
                                 f"offload "
                                 f"{a}, {g}; partitioned full {b}, {h}")
    dtype = "bf16" if cfg.dtype == "bfloat16" else "fp32"
    print(f"phase {phase}, {arch} at full width on {cfg.num_layers} layers "
          f"({dtype}, B {B} x S {S}) on {TP_TRAIN_MESH} (data, model) of "
          f"[cuda:0] * 4 with FSDP, MI 1, against one device [{card}]: " +
          "; ".join(lines) + f"; losses within {TP_TRAIN_LOSS_RTOL:g} and "
          f"gradient norms within {TP_TRAIN_GNORM_RTOL:g} of one device's, "
          f"each leaf's first-step gradient within {TP_TRAIN_LEAF_RTOL:g} "
          f"of one device's or within {TP_BF16_RATIO:g} times one device's "
          f"bf16 distance from the fp32 step's, "
          f"offload == full (partitioned; bit for bit: {same}), ledgers == "
          f"the dry run's; {phase} {arch} took "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)
    return {k: full["launches"][k] + off["launches"][k]
            for k in full["launches"]}


def _tp_dryrun_bytes(cfg, adm, n):
    """The dry run's ledger bytes (``rank_collectives`` of the prefill
    cell on meta, a ("data", "model") mesh of (1, n)) of each admitted
    prompt, summed: what a TP prefill over n ranks must move."""
    from repro_torch import sharding as shd
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_rules
    rules = make_rules(shd.Mesh((1, n), ("data", "model")), kind="prefill")
    total = {}
    for toks, *_ in adm:
        fn, args, in_sh = specs.build_prefill_cell(
            cfg, ShapeConfig("adm", int(toks.shape[1]), 1, "prefill"), rules)
        for k, v in dryrun.rank_collectives(fn, args, in_sh,
                                            rules)["bytes"].items():
            total[k] = total.get(k, 0.0) + v
    return {k: v for k, v in total.items() if v}


def check_tp_families(card):
    """Phase 13: 13a, 13b on both models, then 13c: each model's TP
    prefill at 13b's depth on a disaggregated engine with one decode
    shard on the card and a prefill group of two aliased ranks
    (``prefill_devices=[cuda:0] * 2``), 12 prompts of 300-512 tokens on 8
    slots of 1024 (``tp_family``, its ledger held to ``_tp_dryrun_bytes``).
    Returns (each kernel's launches by path, K4's launches by path)."""
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    t0 = time.perf_counter()
    release_pinned()
    torch.cuda.empty_cache()
    paths = {}

    paths["deepseek-v2-lite, zamba2-7b and granite (6 experts) reduced "
          "partitioned training (phase 13a)"] = check_tp_families_small()
    for arch in TP_FAMILIES:
        paths[f"{arch} partitioned training, full and offload (phase "
              f"13b)"] = train_tp_families_full(arch, card)
    lengths = np.random.default_rng(26).integers(300, 513, 12)
    plan = PlacementPlan(hot_window=192, page_tokens=PAGE,
                         slot_hot_windows=[128 + 16 * s for s in range(SLOTS)])
    for arch in TP_FAMILIES:
        cfg = dataclasses.replace(_tp_family_cfg(arch), use_paged_decode=True)
        params = init_params(cfg, seed=0)
        reqs = family_requests(cfg.vocab_size, lengths, seed=27)
        k1, k4 = tp_family(arch, cfg, params, plan, reqs, card,
                           prefill_devices=[torch.device("cuda", 0)] * 2,
                           expected=_tp_dryrun_bytes, phase="13c",
                           per_admission=False)
        paths[f"{arch} TP prefill, one decode shard (phase 13c)"] = \
            _counts(paged_decode=k1, ssd=k4)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s; launches on its "
          f"paths: {paths}", flush=True)
    return paths


TP_RECURRENT = ("xlstm-1.3b", "lstm-ptb", "musicgen-medium",
                "paligemma-3b")
# 14a: each reduced config on (2, 2) in the four modes x FSDP off/on, and
# in full on (1, 4) where the cut differs from the model axis of 2: one of
# xlstm's 4 heads a rank, its 2-head variant whole on every rank, one of
# lstm-ptb's gates a rank (musicgen's and paligemma's heads split whole at
# 2 and at 4)
TP_RECURRENT_OTHER = {"xlstm-1.3b": (1, 4), "xlstm-1.3b+h2": (1, 4),
                      "lstm-ptb": (1, 4)}
# 14a runs the reduced xlstm on one period (8 of its 16 layers) and 8
# tokens a row, its 4-head mLSTM chunkwise with chunks of 4 (its 2-head
# variant sequential): at 16 layers, 16 tokens and the sequential mLSTM
# its nine cases took 145.1 s of 14a's 176.9 s, and at 8 layers with
# chunks of 8 38.6 s of 64.2 s (H100 80GB HBM3, 700 W)
TP_RECURRENT_SMALL = {"xlstm-1.3b": (8, 8, 4), "xlstm-1.3b+h2": (8, 8, 0)}
# 14a's (mode, FSDP) cases on (2, 2): each mode once, FSDP off and on
# twice each, for the script's clock (phase 14 took 125.1-133.4 s with all
# eight on H100 80GB HBM3 hosts at 700 W); the CPU tests run all eight at
# (1, 2) and (2, 2)
TP_RECURRENT_SMALL_CASES = (("full", False), ("remat", True),
                            ("save_hbm", False), ("offload", True))
# 14b and 14c: full width at reduced depth, B x S (musicgen's S frames of
# 4 codes, paligemma's S text tokens after its 256 patches); xlstm-1.3b
# on one period (7 mLSTM and 1 sLSTM, 0.54 B parameters with the
# embedding), its mLSTM chunkwise (XLSTM_CHUNK) and S 64, since each of
# the sLSTM's tokens is an eager step of every rank under one GIL (at S
# 128 its 14b took 20.5-38.1 s on H100 80GB HBM3 hosts at 700 W)
TP_RECURRENT_FULL = {"xlstm-1.3b": (8, (2, 64)), "lstm-ptb": (2, (20, 35)),
                     "musicgen-medium": (4, (2, 256)),
                     "paligemma-3b": (3, (2, 64))}
# 14b trains xlstm-1.3b in fp32: its bf16 training step is chaotic (on an
# H100 80GB HBM3 at 700 W one device's bf16 gradient norm sits 2.7-2.9%
# from the fp32 step's, from the seed-0 start and from starts moved one
# ulp alike, and a partitioned bf16 norm sat 2.35% from one device's),
# so 12b's bf16 limits cannot tell a wrong program from rounding there;
# in fp32 they can
TP_RECURRENT_TRAIN_DTYPE = {"xlstm-1.3b": "float32"}
# ... and trains it once more in bf16, its configured dtype, held to
# rounding's own spread on the card: the partitioned bf16 step's first-step
# loss, gradient norm and every leaf's gradient no farther from the
# one-device fp32 step's than TP_BF16_RATIO times the farthest of the
# one-device bf16 steps from the seed-0 start and from TP_BF16_ULP_STARTS
# starts, each moved one ulp in a TP_BF16_ULP_SHARE of every leaf
TP_BF16_ULP_STARTS = 3
TP_BF16_ULP_SHARE = 0.1


def _tp_recurrent_cfg(name, full=False, train=False):
    """The reduced config ("<arch>" or "<arch>+h<heads>"), or with
    ``full`` the full-width one at TP_RECURRENT_FULL's depth (in
    TP_RECURRENT_TRAIN_DTYPE's dtype with ``train``)."""
    from repro_torch.configs import get_config
    arch, _, heads = name.partition("+h")
    if full:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=TP_RECURRENT_FULL[arch][0])
        if train and arch in TP_RECURRENT_TRAIN_DTYPE:
            cfg = dataclasses.replace(cfg,
                                      dtype=TP_RECURRENT_TRAIN_DTYPE[arch])
        return cfg
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, num_heads=int(heads)) if heads else cfg


def _modality_batch(cfg, B, S, seed, device="cpu"):
    """Tokens and labels from ``seed``: (B, S, K) codes for K codebooks;
    with a prefix, ``prefix_embed`` (B, P, d) and labels (B, P + S)."""
    import torch
    rng = np.random.default_rng(seed)
    tok = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, tok))}
    lab = tok
    if cfg.num_prefix_tokens:
        P = cfg.num_prefix_tokens
        out["prefix_embed"] = torch.as_tensor(
            rng.standard_normal((B, P, cfg.d_model)).astype(np.float32))
        lab = (B, P + S)
    out["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, lab))
    return {k: v.to(device) for k, v in out.items()}


def check_tp_recurrent_small():
    """Phase 14a: each TP_RECURRENT config reduced in fp32 (and xlstm's
    2-head variant; the xLSTM at TP_RECURRENT_SMALL's layers, tokens and
    mLSTM chunks), one step of the partitioned train step on (2, 2) of
    [cuda:0] * 4 and of [cpu] * 4 and the card's one-device step from the
    same parameters and batch (B 4 x S 16; the xLSTM's S
    TP_RECURRENT_SMALL's), in TP_RECURRENT_SMALL_CASES'
    modes at MI 1 (offload with the moments in pinned host memory) and
    FSDP settings, and in full on TP_RECURRENT_OTHER's mesh: 12a's gates (``_tp_small_case``), the
    xLSTM's widened to XLSTM_REL of the largest |value| compared (its
    fp32 conditioning).  Returns the kernels' launches in the card's
    partitioned steps (all 0)."""
    from repro_torch.core.offload import SentinelConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    worst, runs, pairs, secs = {}, 0, 0, {}
    launches = dict.fromkeys(KERNELS, 0)
    for name in TP_RECURRENT[:1] + ("xlstm-1.3b+h2",) + TP_RECURRENT[1:]:
        cfg = _tp_recurrent_cfg(name)
        layers, S, chunk = TP_RECURRENT_SMALL.get(
            name, (cfg.num_layers, 16, 0))
        cfg = dataclasses.replace(cfg, num_layers=layers)
        ops.mlstm_chunk_mode(chunk)
        params = init_params(cfg, seed=0, device="cpu")
        batch = _modality_batch(cfg, 4, S, 14)
        cases = [] if name.endswith("+h2") else \
            [(TP_TRAIN_MESH, mode, fsdp)
             for mode, fsdp in TP_RECURRENT_SMALL_CASES]
        if name in TP_RECURRENT_OTHER:
            cases.append((TP_RECURRENT_OTHER[name], "full", False))
        rel = XLSTM_REL if name.startswith("xlstm") else 0.0
        ts = time.perf_counter()
        for shape, mode, fsdp in cases:
            scfg = SentinelConfig(mode=mode, mi_periods=1,
                                  offload_opt_state=mode == "offload")
            what = f"{name} reduced {shape} {mode} fsdp={fsdp}"
            r = _tp_small_case(cfg, params, batch, shape, scfg, fsdp, what,
                               rel=rel)
            for k in ("one", "cpu"):
                worst[name, k] = max(worst.get((name, k), 0.0), r[k])
            runs, pairs = runs + 1, pairs + r["pairs"]
            for k, v in r["launches"].items():
                launches[k] += v
        ops.mlstm_chunk_mode(0)
        secs[name] = time.perf_counter() - ts
        del params
        release_pinned()
    if any(launches[k] for k in FOUR):
        raise AssertionError(f"phase 14a launched a kernel: {launches}")
    names = [n for n, _ in worst if _ == "one"]
    print(f"phase 14a: {runs} partitioned steps ({', '.join(names)} reduced,"
          f" the xLSTM's (layers, S, mLSTM chunk) {TP_RECURRENT_SMALL}, "
          f"fp32, (2, 2) of [cuda:0] * 4 in (mode, FSDP) "
          f"{TP_RECURRENT_SMALL_CASES}, and "
          f"{TP_RECURRENT_OTHER} in full): loss, gradient norm and every "
          f"reassembled parameter within atol {SMALL_LOSS_TOL['atol']:g} of "
          f"the card's one-device step and of [cpu] * n's (xlstm: widened "
          f"to {XLSTM_REL:g} of the largest |value|); max_abs_err from one "
          f"device / the CPU: " + ", ".join(
              f"{n} {worst[n, 'one']:.3g} / {worst[n, 'cpu']:.3g}"
              for n in names) +
          f"; ledgers == the CPU's; {pairs} replica pairs equal bit for "
          f"bit; launches {launches}; seconds " + ", ".join(
              f"{n} {t:.1f}" for n, t in secs.items()) +
          f"; 14a took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def train_tp_recurrent_full(name, card):
    """Phase 14b, one model at TP_RECURRENT_FULL's depth and B x S, full
    width, bf16 (xlstm-1.3b fp32, TP_RECURRENT_TRAIN_DTYPE) from seed 0:
    ``_train_tp_full``'s gates (12b's, the ledger == the dry run's) in
    full and offload on (2, 2) with FSDP; for xlstm-1.3b then its bf16
    step against rounding's spread (``_train_tp_bf16_spread``).  Returns
    the kernels' launches in its runs (all 0)."""
    from repro_torch.kernels import ops
    cfg = _tp_recurrent_cfg(name, full=True, train=True)
    B, S = TP_RECURRENT_FULL[name][1]
    batches = [_modality_batch(cfg, B, S, 140 + s, "cuda")
               for s in range(TP_TRAIN_STEPS)]
    if name == "xlstm-1.3b":
        ops.mlstm_chunk_mode(XLSTM_CHUNK)
    try:
        launches = _train_tp_full(name, cfg, batches, card, "14b")
        if name in TP_RECURRENT_TRAIN_DTYPE:
            more = _train_tp_bf16_spread(
                name, _tp_recurrent_cfg(name, full=True), batches[0], card)
            launches = {k: v + more[k] for k, v in launches.items()}
    finally:
        ops.mlstm_chunk_mode(0)
    if any(launches[k] for k in FOUR):
        raise AssertionError(f"phase 14b {name} launched a kernel: "
                             f"{launches}")
    return launches


def _ulp_moved(params, share, seed):
    """A copy of the bf16 ``params`` with a ``share`` of each leaf's
    elements, drawn from ``seed``, moved one ulp away from zero."""
    import torch
    params = copy.deepcopy(params)
    gen = torch.Generator(device=next(params.parameters()).device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for w in params.parameters():
            w.view(torch.int16).add_(
                (torch.rand(w.shape, generator=gen, device=w.device)
                 < share).to(torch.int16))
    return params


def _train_tp_bf16_spread(name, cfg, batch, card):
    """Phase 14b's bf16 step of ``name`` (``cfg`` bf16, at full width and
    reduced depth, from seed 0), whose bf16 training step is chaotic: the
    first step in full mode at MI 1 on one device in fp32 from the bf16
    start (the reference), on one device in bf16 from that start and from
    TP_BF16_ULP_STARTS ``_ulp_moved`` starts (rounding's spread), and the
    partitioned bf16 step on (2, 2) of [cuda:0] * 4 with FSDP.  Gates: the
    partitioned loss, gradient norm and each leaf's first-step gradient
    no farther from fp32's than TP_BF16_RATIO times the farthest of the
    one-device bf16 steps' (that leaf's farthest for a leaf); the
    ranks agree; the ledger == the dry run's.  Returns the kernels'
    launches in the partitioned step (all 0)."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.collectives import new_ledger
    from repro_torch.core import offload
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    t0 = time.perf_counter()
    B, S = batch["tokens"].shape[:2]
    D, M = TP_TRAIN_MESH
    ocfg = adamw.OptConfig(total_steps=TP_TRAIN_STEPS, warmup_steps=1)
    scfg = offload.SentinelConfig(mode="full", mi_periods=1)
    dev = batch["tokens"].device
    params = init_params(cfg, seed=0, device=dev)

    def one(start, cfg_):
        p = init_params(cfg_, device=dev, requires_grad=True)
        p.load_state_dict(start.state_dict())       # cast to cfg_'s dtype
        st = {"params": p, "opt": adamw.init(p, ocfg),
              "step": torch.zeros((), dtype=torch.int32, device=dev)}
        grads = {}
        with _first_grads(grads):
            _, m = loop.make_train_step(cfg_, scfg, ocfg)(st, batch)
        return float(m["loss"]), float(m["grad_norm"]), grads[()]

    loss32, gn32, g32 = one(params, dataclasses.replace(cfg,
                                                        dtype="float32"))
    # rounding's spread: each one-device bf16 step's distance from fp32
    spread = []
    for i in range(1 + TP_BF16_ULP_STARTS):
        start = params if i == 0 else \
            _ulp_moved(params, TP_BF16_ULP_SHARE, 140 + i)
        loss, gn, g = one(start, cfg)
        spread.append((abs(loss - loss32), abs(gn - gn32),
                       {k: _rel(v, g32[k]) for k, v in g.items()}))
        del start, g
        gc.collect()
    torch.cuda.empty_cache()
    mesh = shd.Mesh(TP_TRAIN_MESH, ("data", "model"), devices=[dev] * (D * M))
    rules = shd.tp_dp_rules(mesh, fsdp=True)
    want = _dryrun_train_ledger(cfg, rules, scfg, ocfg, B, S)
    step = loop.make_train_step(cfg, scfg, ocfg, rules)
    reset_counts()
    try:
        states = step.init_states(params)
        before = copy.deepcopy(step.ledger)
        grads = {}
        ts = time.perf_counter()
        with _first_grads(grads):
            states, m = step(states, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        ms = 1e3 * (time.perf_counter() - ts)
        led = new_ledger()
        for part in ("bytes", "counts"):
            for k, v in step.ledger[part].items():
                led[part][k] = v - before[part][k]
        led = {k: {t: v for t, v in led[k].items() if v}
               for k in ("bytes", "counts")}
        ranks = {(float(r["loss"]), float(r["grad_norm"]))
                 for r in m["ranks"]}
        whole = dict(shd.gather_params(
            [_Leaves(grads[tuple(pos.values())]) for pos in step.positions],
            step.positions, step.rules,
            init_params(cfg, device="meta")).named_parameters())
    finally:
        step.close()
    launches = _recurrent_launches(f"phase 14b {name} bf16")
    del states, params
    release_pinned()
    if len(ranks) != 1:
        raise AssertionError(f"14b {name} bf16: the ranks disagree: {ranks}")
    if led != want:
        raise AssertionError(f"14b {name} bf16: ledger {led} != the dry "
                             f"run's {want}")
    far_loss = max(d[0] for d in spread)
    far_gn = max(d[1] for d in spread)
    leaf = {k: _rel(g, g32[k]) / max(max(d[2][k] for d in spread), 1e-30)
            for k, g in whole.items()}
    mid = float(np.median(list(leaf.values())))
    worst = max(leaf, key=leaf.get)
    if not (np.isfinite(loss) and np.isfinite(gn)
            and abs(loss - loss32) <= TP_BF16_RATIO * far_loss
            and abs(gn - gn32) <= TP_BF16_RATIO * far_gn
            and leaf[worst] <= TP_BF16_RATIO):
        raise AssertionError(
            f"14b {name} bf16: partitioned loss {loss}, gradient norm {gn}, "
            f"{worst}'s gradient {leaf[worst]} times one device's farthest; "
            f"fp32 {loss32}, {gn32}; one device's "
            f"bf16 steps at most {far_loss}, {far_gn} from fp32 (limit "
            f"{TP_BF16_RATIO} times)")
    print(f"phase 14b, {name} in bf16 at full width on {cfg.num_layers} "
          f"layers (B {B} x S {S}), first step in full on {TP_TRAIN_MESH} "
          f"(data, model) of [cuda:0] * 4 with FSDP [{card}]: loss fp32 "
          f"{loss32:.6f}, one device bf16 (start, then "
          f"{TP_BF16_ULP_STARTS} starts moved one ulp in "
          f"{TP_BF16_ULP_SHARE:g} of each leaf) from it "
          f"{', '.join(f'{d[0]:.4g}' for d in spread)}, partitioned "
          f"{abs(loss - loss32):.4g}; gradient norm fp32 {gn32:.6g}, one "
          f"device bf16 from it {', '.join(f'{d[1]:.4g}' for d in spread)}, "
          f"partitioned {gn:.6g} ({abs(gn - gn32):.4g}); each leaf's "
          f"gradient distance from fp32 over one device's farthest: median "
          f"{mid:.4g}, worst {leaf[worst]:.4g} ({worst}) of {len(leaf)} "
          f"(limit {TP_BF16_RATIO} on the loss, the norm and each leaf); "
          f"ledger {led['bytes']} B == the dry run's; partitioned step "
          f"{ms:.1f} ms; {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def tp_prefill_direct(name, cfg, params, prompts, card):
    """Phase 14c for a model the disaggregated engine does not take
    (paligemma's prefix needs the dense layouts, R9; musicgen's codebooks
    the batcher refuses, R10): each of ``prompts`` (batch-1 dicts) through
    ``TensorParallelPrefill`` on [cuda:0] * 2 and through one device's
    ``model.prefill``, and an fp32 one-device prefill.  Gates: the TP
    ledger == the dry run's prefill cell of each prompt summed
    (``_tp_dryrun_bytes``); the means over the prompts of the TP logits'
    and caches' max_abs from fp32 no farther than TP_BF16_RATIO times
    bf16's (13c's).  Returns the kernels' launches (all 0)."""
    import torch
    from repro_torch.models import model
    from repro_torch.serve.disagg import TensorParallelPrefill
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = copy.deepcopy(params).float()
    reset_counts()
    tp = TensorParallelPrefill(params, cfg, [torch.device("cuda", 0)] * 2)
    dists, ms = [], []
    try:
        for batch in prompts:
            torch.cuda.synchronize()
            t = time.perf_counter()
            l1, c1 = model.prefill(params, cfg, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lt, ct = tp(batch)
            torch.cuda.synchronize()
            ms.append((1e3 * (t1 - t), 1e3 * (time.perf_counter() - t1)))
            l32, c32 = model.prefill(params32, cfg32, batch)

            def kv(c):
                return max(float((a[k].float() - b[k]).abs().max())
                           for a, b in zip(c, c32) for k in a)
            dists.append((float((l1.float() - l32).abs().max()),
                          float((lt.float() - l32).abs().max()),
                          kv(c1), kv(ct)))
            del c1, ct, c32
        led = tp.ledger
    finally:
        tp.close()
    launches = _recurrent_launches(f"phase 14c {name}")
    del params32
    adm = [(b["tokens"],) for b in prompts]
    want = _tp_dryrun_bytes(cfg, adm, 2)
    nz = {k: v for k, v in led["bytes"].items() if v}
    if nz != want:
        raise AssertionError(f"14c {name}: collectives {nz} B != the dry "
                             f"run's {want} B")
    mean = np.mean(dists, axis=0)
    if not (mean[1] <= TP_BF16_RATIO * mean[0]
            and mean[3] <= TP_BF16_RATIO * mean[2]):
        raise AssertionError(f"14c {name}: TP from fp32 {mean[1]}, "
                             f"{mean[3]} against bf16's {mean[0]}, "
                             f"{mean[2]} (limit {TP_BF16_RATIO} times)")
    after = f" after {cfg.num_prefix_tokens} patches" \
        if cfg.num_prefix_tokens else ""
    print(f"phase 14c, {name} TP prefill through TensorParallelPrefill on "
          f"[cuda:0] * 2 ({cfg.num_layers} layers, {len(prompts)} prompts "
          f"of {tuple(prompts[0]['tokens'].shape[1:])} tokens{after}) "
          f"[{card}]: collectives {nz} B == the dry run's; TP/bf16 "
          f"distance from fp32, means over the prompts: logits "
          f"{mean[1] / mean[0]:.3f}, caches {mean[3] / mean[2]:.3f} (limit "
          f"{TP_BF16_RATIO}); bf16 max_abs from fp32 logits "
          f"{mean[0]:.4f}, TP {mean[1]:.4f}; prefill ms one device / TP "
          f"(aliased ranks) " + ", ".join(f"{a:.1f} / {b:.1f}"
                                          for a, b in ms) +
          f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def check_tp_recurrent(card):
    """Phase 14: 14a, 14b on the four models, then 14c: xlstm-1.3b at
    14b's depth on a disaggregated engine with one decode shard and a
    prefill group of two aliased ranks (``tp_family``, 8 prompts of whole
    64-token chunks from 320 to 512 tokens, the mLSTM chunkwise), and
    musicgen-medium and paligemma-3b through ``tp_prefill_direct``.
    Returns each kernel's launches by path (all 0)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    t0 = time.perf_counter()
    release_pinned()
    torch.cuda.empty_cache()
    paths = {}
    paths["xlstm-1.3b, lstm-ptb, musicgen-medium and paligemma-3b reduced "
          "partitioned training (phase 14a)"] = check_tp_recurrent_small()
    for name in TP_RECURRENT:
        paths[f"{name} partitioned training, full and offload (phase "
              f"14b)"] = train_tp_recurrent_full(name, card)
    lengths = 64 * np.random.default_rng(28).integers(5, 9, 8)
    plan = PlacementPlan(hot_window=192, page_tokens=PAGE,
                         slot_hot_windows=[128 + 16 * s for s in range(SLOTS)])
    cfg = dataclasses.replace(_tp_recurrent_cfg("xlstm-1.3b", full=True),
                              use_paged_decode=True)
    params = init_params(cfg, seed=0)
    reqs = family_requests(cfg.vocab_size, lengths, seed=29)
    ops.mlstm_chunk_mode(XLSTM_CHUNK)
    try:
        # tp_family raises where K2 or K3 launch, or K1 or K4 where the
        # model has no attention or Mamba layer
        k1, k4 = tp_family("xlstm-1.3b", cfg, params, plan, reqs, card,
                           prefill_devices=[torch.device("cuda", 0)] * 2,
                           expected=_tp_dryrun_bytes, phase="14c",
                           per_admission=False)
    finally:
        ops.mlstm_chunk_mode(0)
    paths["xlstm-1.3b TP prefill, one decode shard (phase 14c)"] = \
        _counts(paged_decode=k1, ssd=k4)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for name in TP_RECURRENT[2:]:
        cfg = _tp_recurrent_cfg(name, full=True)
        params = init_params(cfg, seed=0)
        S = TP_RECURRENT_FULL[name][1][1]
        prompts = [_modality_batch(cfg, 1, S, 150 + i, "cuda")
                   for i in range(4)]
        for p in prompts:
            p.pop("labels")
        paths[f"{name} TP prefill, TensorParallelPrefill (phase 14c)"] = \
            tp_prefill_direct(name, cfg, params, prompts, card)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s; launches on its "
          f"paths: {paths}", flush=True)
    return paths


# --------------------------- long_500k and Megatron-SP (phase 15) ----

# 15a: the Megatron-SP step of each reduced config in fp32 on (2, 2) of
# [cuda:0] * 4 in TP_RECURRENT_SMALL_CASES' (mode, FSDP) cases (the
# xLSTM at TP_RECURRENT_SMALL's layers, tokens and mLSTM chunks)
SP_SMALL = ("smollm-360m", "zamba2-7b", "xlstm-1.3b")
# 15a's reduced zamba2 on its prologue and one period, for the script's
# clock
SP_SMALL_LAYERS = {"zamba2-7b": 6}
# 15a: the sequence-sharded decode of each reduced config: a prefill of
# B 2 x S LONG_SMALL_S on one device, then LONG_SMALL_STEPS decode steps
# of slot 0 from index 3 (the first data block) and slot 1 from 20 (the
# last) on (2, 2) under serve_rules(seq_shard=True) against one device
LONG_SMALL = ("gemma2-2b", "gemma3-12b", "zamba2-7b", "xlstm-1.3b")
LONG_SMALL_S = 32
LONG_SMALL_STEPS = 4
LONG_SMALL_START = (3, 20)
# 15b: Megatron-SP training at full width and reduced depth, bf16, B x S
# (smollm-360m on 4 of its 32 layers; zamba2-7b on its prologue and one
# period, whose shared attention block is K2's shape)
SP_FULL = {"smollm-360m": 4, "zamba2-7b": 6}
SP_TRAIN = (2, 1024)
# 15c: long_500k at full width, B 1 x S 524,288, bf16: gemma2-2b on its
# first two layers (one LOCAL, one ATTN) and zamba2-7b on its prologue and
# one period (one shared attention layer); the cache filled from seed 0
# below LONG_START, then LONG_STEPS decode steps on (2, 2)
LONG_FULL = {"gemma2-2b": 2, "zamba2-7b": 6}
LONG_S = 524_288
LONG_START = 524_280
LONG_STEPS = 8


def check_sp_small():
    """Phase 15a, training: each SP_SMALL config reduced in fp32, one step
    of the Megatron-SP partitioned train step (``tp_dp_rules(fsdp=...,
    seq_parallel=True)``) on (2, 2) of [cuda:0] * 4 and of [cpu] * 4 and
    the card's one-device step from the same parameters and batch (B 4 x
    S 16; the xLSTM's S TP_RECURRENT_SMALL's), in TP_RECURRENT_SMALL_CASES'
    modes at MI 1: 12a's gates (``_tp_small_case``; zamba2's card against
    the CPU at phase 5b's gradient limits, since K4 runs on the card; the
    xLSTM's widened to XLSTM_REL of the largest |value|), and K4's
    launches in each partitioned card step == ranks x (Mamba layers +
    recomputes) on zamba2, 0 elsewhere.  Returns the launches by
    config."""
    from repro_torch.core.offload import SentinelConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    out, worst, pairs, secs = {}, {}, 0, {}
    D, M = TP_TRAIN_MESH
    for name in SP_SMALL:
        ts = time.perf_counter()
        if name.startswith("xlstm"):
            cfg = _tp_recurrent_cfg(name)
            layers, S, chunk = TP_RECURRENT_SMALL[name]
            cfg = dataclasses.replace(cfg, num_layers=layers)
        else:
            cfg, S, chunk = _tp_train_cfg(name), 16, 0
            cfg = dataclasses.replace(cfg, num_layers=SP_SMALL_LAYERS.get(
                name, cfg.num_layers))
        ops.mlstm_chunk_mode(chunk)
        params = init_params(cfg, seed=0, device="cpu")
        batch = _modality_batch(cfg, 4, S, 15)
        rel = XLSTM_REL if name.startswith("xlstm") else 0.0
        launches = dict.fromkeys(KERNELS, 0)
        try:
            for mode, fsdp in TP_RECURRENT_SMALL_CASES:
                scfg = SentinelConfig(mode=mode, mi_periods=1,
                                      offload_opt_state=mode == "offload")
                what = f"15a {name} reduced SP {TP_TRAIN_MESH} {mode} " \
                       f"fsdp={fsdp}"
                r = _tp_small_case(cfg, params, batch, TP_TRAIN_MESH, scfg,
                                   fsdp, what, rel=rel, seq_parallel=True,
                                   cpu_tol=SMALL_GRAD_TOL if _n_mamba(cfg)
                                   else SMALL_LOSS_TOL)
                want = D * M * _blocked_mambas(cfg, scfg)
                if r["k4"] != want or any(
                        r["launches"][k] for k in FOUR if k != "ssd"):
                    raise AssertionError(f"{what}: launches "
                                         f"{r['launches']}, K4 {want} "
                                         f"expected")
                for k in ("one", "cpu"):
                    worst[name, k] = max(worst.get((name, k), 0.0), r[k])
                pairs += r["pairs"]
                for k, v in r["launches"].items():
                    launches[k] += v
        finally:
            ops.mlstm_chunk_mode(0)
        out[name] = launches
        del params
        release_pinned()
        secs[name] = time.perf_counter() - ts
    print(f"phase 15a: Megatron-SP steps of {', '.join(SP_SMALL)} reduced "
          f"(fp32, the xLSTM's (layers, S, mLSTM chunk) "
          f"{TP_RECURRENT_SMALL['xlstm-1.3b']}) on {TP_TRAIN_MESH} of "
          f"[cuda:0] * 4 in (mode, FSDP) {TP_RECURRENT_SMALL_CASES}: loss, "
          f"gradient norm and every reassembled parameter within 12a's "
          f"limits of the card's one-device step and of [cpu] * 4's; "
          f"max_abs_err from one device / the CPU: " + ", ".join(
              f"{n} {worst[n, 'one']:.3g} / {worst[n, 'cpu']:.3g}"
              for n in SP_SMALL) +
          f"; ledgers == the CPU's; {pairs} replica pairs equal bit for "
          f"bit; launches {out}; seconds " + ", ".join(
              f"{n} {t:.1f}" for n, t in secs.items()) +
          f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _seq_sharded_decode(cfg, params, caches, tokens, index, steps, dev):
    """``steps`` decode steps on (2, 2) of [dev] * 4 under
    ``serve_rules(seq_shard=True)``: each rank its blocks of ``params``
    and of every leaf of ``caches`` (``sharding_for`` of
    ``cache_logical_axes``: the attention caches' rows over ``data``,
    their heads over ``model``), the batch whole; step t feeds
    ``tokens[:, t:t + 1]`` at per-slot ``index + t``.  Returns (each
    step's logits, the model ranks' vocab blocks joined; each rank's cache
    blocks; the specs; the mesh; the ledger)."""
    import torch
    from repro_torch import collectives
    from repro_torch import sharding as shd
    from repro_torch.models import kvcache, model
    D, M = TP_TRAIN_MESH
    mesh = shd.Mesh(TP_TRAIN_MESH, ("data", "model"), devices=[dev] * (D * M))
    rules = shd.serve_rules(mesh, seq_shard=True)
    axes = kvcache.cache_logical_axes(cfg)
    specs = [{k: shd.sharding_for(tuple(v.shape), axes[l][k], rules).spec
              for k, v in layer.items()} for l, layer in enumerate(caches)]
    groups = collectives.MeshGroup(mesh)
    pos = groups.positions
    ranks = [shd.shard_params(params, rules, p) for p in pos]
    blocks = [[{k: shd._block_of(v, specs[l][k], p, mesh).clone()
                for k, v in layer.items()} for l, layer in enumerate(caches)]
              for p in pos]
    logits = []
    try:
        for t in range(steps):
            def rank(i, t=t):
                with shd.rank_context(shd.mesh_rank(groups, rules, pos[i])):
                    return model.decode_step(ranks[i], cfg,
                                             tokens[:, t:t + 1], blocks[i],
                                             index + t)[0]
            outs = groups.run(rank)
            logits.append(torch.cat(outs[:M], dim=-1))
        led = copy.deepcopy(groups.ledger)
    finally:
        groups.close()
    return logits, blocks, specs, mesh, led


def _join_blocks(caches, blocks, specs, mesh, positions):
    """The whole cache from the ranks' ``blocks``, laid out like
    ``caches``."""
    import torch
    from repro_torch import sharding as shd
    out = []
    for l, layer in enumerate(caches):
        out.append({})
        for k, v in layer.items():
            t = torch.empty_like(v)
            for i, p in enumerate(positions):
                shd._block_of(t, specs[l][k], p, mesh).copy_(blocks[i][l][k])
            out[-1][k] = t
    return out


def _positions(shape):
    import itertools
    return [{"data": d, "model": m} for d, m in itertools.product(
        range(shape[0]), range(shape[1]))]


def check_long_small():
    """Phase 15a, decode: each LONG_SMALL config reduced in fp32 from seed
    0 on the card: a prefill of B 2 x S LONG_SMALL_S on one device, then
    LONG_SMALL_STEPS decode steps, slot 0 from index 3 (the first data
    block) and slot 1 from 20 (the last), on (2, 2) of [cuda:0] * 4 under
    serve_rules(seq_shard=True) (``_seq_sharded_decode``) against the
    card's one device: every step's logits and the final cache (the
    ranks' blocks joined) within SMALL_LOGITS_TOL; no kernel launches (a
    rank's decode is dense; the Mamba decode steps ``ssd_decode``).
    Returns the launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model
    t0 = time.perf_counter()
    worst = {}
    launches = dict.fromkeys(KERNELS, 0)
    for arch in LONG_SMALL:
        cfg = get_config(arch).reduced()
        params = model.init_params(cfg, seed=0, device="cuda")
        rng = np.random.default_rng(16)
        prompt = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (2, LONG_SMALL_S))).cuda()
        toks = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (2, LONG_SMALL_STEPS))).cuda()
        _, caches = model.prefill(params, cfg, {"tokens": prompt},
                                  max_seq=LONG_SMALL_S)
        index = torch.tensor(LONG_SMALL_START, device="cuda")
        # the decode's launches alone (zamba2's prefill runs K4)
        torch.cuda.synchronize()
        reset_counts()
        got, blocks, specs, mesh, _ = _seq_sharded_decode(
            cfg, params, caches, toks, index, LONG_SMALL_STEPS,
            torch.device("cuda", 0))
        one = [{k: v.clone() for k, v in layer.items()} for layer in caches]
        err = 0.0
        for t in range(LONG_SMALL_STEPS):
            want, one = model.decode_step(params, cfg, toks[:, t:t + 1], one,
                                          index + t)
            torch.testing.assert_close(got[t], want, **SMALL_LOGITS_TOL)
            err = max(err, float((got[t] - want).abs().max()))
        for k, v in _recurrent_launches(f"phase 15a {arch} "
                                        f"seq-sharded decode").items():
            launches[k] += v
        whole = _join_blocks(caches, blocks, specs, mesh,
                             _positions(TP_TRAIN_MESH))
        for l, (a, b) in enumerate(zip(whole, one)):
            for k in a:
                torch.testing.assert_close(a[k], b[k], **SMALL_LOGITS_TOL,
                                           msg=f"15a {arch} layer {l} {k}")
                err = max(err, float((a[k] - b[k]).abs().max()))
        worst[arch] = err
        del params, caches, blocks, one, whole
    print(f"phase 15a: sequence-sharded decode of {', '.join(LONG_SMALL)} "
          f"reduced (fp32, B 2 x S {LONG_SMALL_S}, {LONG_SMALL_STEPS} steps "
          f"from indices {LONG_SMALL_START}) on {TP_TRAIN_MESH} of "
          f"[cuda:0] * 4 against one device: logits and caches within atol "
          f"{SMALL_LOGITS_TOL['atol']:g}; max_abs_err " + ", ".join(
              f"{a} {e:.3g}" for a, e in worst.items()) +
          f"; launches {launches}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def train_sp_full(arch, card):
    """Phase 15b, one model at SP_FULL's depth, full width, bf16 from seed
    0, SP_TRAIN tokens from make_batch, TP_TRAIN_STEPS steps in full and in
    offload at MI 1 on (2, 2) of [cuda:0] * 4 with FSDP, under Megatron-SP
    rules and under plain TP rules (the comparison).  Gates: each step's
    loss and gradient norm within TP_TRAIN_LOSS_RTOL and
    TP_TRAIN_GNORM_RTOL of plain TP's; each leaf's first-step gradient
    within TP_TRAIN_LEAF_RTOL of plain TP's, or no farther from the
    one-device fp32 step's than TP_BF16_RATIO times plain TP's (13b's
    rule); offload within MODE_LOSS_RTOL and MODE_GNORM_RTOL of full; each
    step's ledger == the dry run's ledger of the same step; every
    replicated leaf equal across its ranks; in offload each rank's carry
    bytes (``offload.rank_traffic``) half of plain TP's (the model axis
    cuts the rows); K4 == steps x ranks x (Mamba layers + recomputes).
    Returns every kernel's launches in the SP steps."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.collectives import new_ledger
    from repro_torch.configs import get_config
    from repro_torch.core import offload
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), num_layers=SP_FULL[arch])
    B, S = SP_TRAIN
    D, M = TP_TRAIN_MESH
    dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=S,
                      global_batch=B)
    batches = [{k: v.to("cuda") for k, v in make_batch(dcfg, s).items()}
               for s in range(TP_TRAIN_STEPS)]
    ocfg = adamw.OptConfig(total_steps=TP_TRAIN_STEPS, warmup_steps=1)
    params = init_params(cfg, seed=0)
    mesh = shd.Mesh(TP_TRAIN_MESH, ("data", "model"),
                    devices=[torch.device("cuda", 0)] * (D * M))
    like = init_params(cfg, device="meta")
    g32 = {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = init_params(cfg32, requires_grad=True)
    p32.load_state_dict({k: v.float() for k, v in params.state_dict()
                         .items()})
    st32 = {"params": p32, "opt": adamw.init(p32, ocfg),
            "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    with _first_grads(g32):
        loop.make_train_step(cfg32, offload.SentinelConfig(mode="full"),
                             ocfg)(st32, batches[0])
    g32 = g32[()]
    del p32, st32
    gc.collect()
    torch.cuda.empty_cache()

    def run(mode, sp):
        scfg = offload.SentinelConfig(mode=mode, mi_periods=1)
        rules = shd.tp_dp_rules(mesh, fsdp=True, seq_parallel=sp)
        gc.collect()
        torch.cuda.empty_cache()
        step = loop.make_train_step(cfg, scfg, ocfg, rules)
        state = step.init_states(params)
        out = dict(losses=[], gnorms=[], times=[], ledgers=[], carries=[],
                   grads={}, want=_dryrun_train_ledger(cfg, rules, scfg,
                                                       ocfg, B, S))
        reset_counts()
        try:
            for s in range(TP_TRAIN_STEPS):
                offload.reset_traffic()
                before = copy.deepcopy(step.ledger)
                torch.cuda.synchronize()
                ts = time.perf_counter()
                if s == 0:
                    with _first_grads(out["grads"]):
                        state, m = step(state, batches[s])
                else:
                    state, m = step(state, batches[s])
                torch.cuda.synchronize()
                out["times"].append(time.perf_counter() - ts)
                out["losses"].append(float(m["loss"]))
                out["gnorms"].append(float(m["grad_norm"]))
                out["carries"].append({p: t["d2h"] for p, t in
                                       offload.rank_traffic.items()})
                led = new_ledger()
                for part in ("bytes", "counts"):
                    for k, v in step.ledger[part].items():
                        led[part][k] = v - before[part][k]
                out["ledgers"].append({k: {t: v for t, v in led[k].items()
                                           if v} for k in ("bytes", "counts")})
                if len({(float(r["loss"]), float(r["grad_norm"]))
                        for r in m["ranks"]}) != 1:
                    raise AssertionError(f"15b {arch} {mode} sp={sp}: the "
                                         f"ranks disagree")
            torch.cuda.synchronize()
            out["launches"] = _launch_counts()
            want = TP_TRAIN_STEPS * D * M * _blocked_mambas(cfg, scfg)
            if out["launches"]["ssd"] != want or any(
                    out["launches"][k] for k in FOUR if k != "ssd"):
                raise AssertionError(f"15b {arch} {mode} sp={sp}: launches "
                                     f"{out['launches']}, K4 {want} "
                                     f"expected")
            out["pairs"] = _replicas_agree(step, state,
                                           f"15b {arch} {mode} sp={sp}")
            out["grads"] = dict(shd.gather_params(
                [_Leaves(out["grads"][tuple(pos.values())])
                 for pos in step.positions], step.positions, step.rules,
                like).named_parameters())
        finally:
            step.close()
        del state
        release_pinned()
        return out

    res = {}
    for mode in ("full", "offload"):
        res[mode, False] = run(mode, False)
        res[mode, True] = run(mode, True)
    del params
    lines = []
    for mode in ("full", "offload"):
        tp, sp = res[mode, False], res[mode, True]
        for s in range(TP_TRAIN_STEPS):
            a, b = sp["losses"][s], tp["losses"][s]
            g, h = sp["gnorms"][s], tp["gnorms"][s]
            if not (np.isfinite(a) and abs(a - b) <= TP_TRAIN_LOSS_RTOL * b
                    and np.isfinite(g)
                    and abs(g - h) <= TP_TRAIN_GNORM_RTOL * h):
                raise AssertionError(f"15b {arch} {mode} step {s}: SP loss "
                                     f"{a}, gradient norm {g}; plain TP's "
                                     f"{b}, {h}")
            for r in (tp, sp):
                if r["ledgers"][s] != r["want"]:
                    raise AssertionError(f"15b {arch} {mode} step {s}: "
                                         f"ledger {r['ledgers'][s]} != the "
                                         f"dry run's {r['want']}")
            if mode == "offload":
                for pos, n in sp["carries"][s].items():
                    if not (n > 0 and 2 * n == tp["carries"][s][pos]):
                        raise AssertionError(
                            f"15b {arch} step {s}: rank {pos}'s carries "
                            f"{n} B under SP, {tp['carries'][s][pos]} B "
                            f"under plain TP (half expected)")
        leaf = {k: _rel(g, tp["grads"][k]) for k, g in sp["grads"].items()}
        past = {}
        for k, d in leaf.items():
            if d > TP_TRAIN_LEAF_RTOL:
                past[k] = (_rel(sp["grads"][k], g32[k]),
                           _rel(tp["grads"][k], g32[k]))
                if not past[k][0] <= TP_BF16_RATIO * past[k][1]:
                    raise AssertionError(
                        f"15b {arch} {mode}: {k}'s first-step gradient is "
                        f"{d} of plain TP's away from it, and {past[k][0]} "
                        f"of the fp32 step's against plain TP's "
                        f"{past[k][1]} (limit {TP_BF16_RATIO} times)")
        far = max(leaf, key=leaf.get)
        carried = sp["carries"][0].get((0, 0), 0), \
            tp["carries"][0].get((0, 0), 0)
        lines.append(
            f"{mode}: losses plain TP "
            f"{', '.join(f'{x:.6f}' for x in tp['losses'])}, SP "
            f"{', '.join(f'{x:.6f}' for x in sp['losses'])}; gradient norms "
            f"{', '.join(f'{x:.6g}' for x in tp['gnorms'])} / "
            f"{', '.join(f'{x:.6g}' for x in sp['gnorms'])}; step ms plain "
            f"TP {', '.join(f'{1e3 * t:.1f}' for t in tp['times'])}, SP "
            f"{', '.join(f'{1e3 * t:.1f}' for t in sp['times'])}; SP ledger "
            f"a step {sp['want']['bytes']} B, counts "
            f"{sp['want']['counts']} (plain TP {tp['want']['bytes']} B); "
            f"first-step gradients |g_SP - g_TP| / |g_TP| by leaf: median "
            f"{float(np.median(list(leaf.values()))):.4g}, worst "
            f"{leaf[far]:.4g} ({far}) of {len(leaf)}; past "
            f"{TP_TRAIN_LEAF_RTOL:g}: " + (", ".join(
                f"{k} (from fp32 {a:.4g}, plain TP {b:.4g})"
                for k, (a, b) in past.items()) or "none") +
            (f"; rank (0, 0)'s carries {carried[0]} B a step, plain TP's "
             f"{carried[1]} B" if mode == "offload" else "") +
            f"; {sp['pairs']} replica pairs equal bit for bit; K4 "
            f"{sp['launches']['ssd']}")
    full, off = res["full", True], res["offload", True]
    for s in range(TP_TRAIN_STEPS):
        a, b = off["losses"][s], full["losses"][s]
        g, h = off["gnorms"][s], full["gnorms"][s]
        if not (abs(a - b) <= MODE_LOSS_RTOL * b
                and abs(g - h) <= MODE_GNORM_RTOL * h):
            raise AssertionError(f"15b {arch} step {s}: SP offload {a}, {g};"
                                 f" SP full {b}, {h}")
    print(f"phase 15b, {arch} Megatron-SP at full width on {cfg.num_layers} "
          f"layers (bf16, B {B} x S {S}) on {TP_TRAIN_MESH} (data, model) of "
          f"[cuda:0] * 4 with FSDP, MI 1, against plain TP on the same "
          f"mesh [{card}]: " + "; ".join(lines) +
          f"; SP offload == SP full; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {k: full["launches"][k] + off["launches"][k]
            for k in full["launches"]}


def _long_cache(cfg, dev, seed):
    """A B 1 x LONG_S cache of ``cfg`` on ``dev`` in its dtype: every
    attention layer's rows below LONG_START and every recurrent state
    filled N(0, 1) from ``seed``, the rest zero."""
    import torch
    from repro_torch.models import kvcache, model
    caches = kvcache.init_cache(cfg, 1, LONG_S, model.param_dtype(cfg), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for layer in caches:
        for k, v in layer.items():
            rows = v[:, :LONG_START] if k in kvcache.SEQ_KEYS else v
            rows.copy_(torch.randn(rows.shape, generator=gen, device=dev,
                                   dtype=torch.float32))
    return caches


def run_long_full(arch, card):
    """Phase 15c, ``long_500k`` at full width and LONG_FULL's depth, B 1 x
    S LONG_S, bf16 from seed 0: the cache from ``_long_cache`` (seed 0),
    LONG_STEPS decode steps from index LONG_START (the last data block) of
    tokens from seed 17: on one device in fp32 (the cache cast), then on
    (2, 2) of [cuda:0] * 4 under serve_rules(seq_shard=True), each rank its
    blocks cut from the one device's cache, then on one device in bf16.
    Gates: each step's logits no farther from fp32's than TP_BF16_RATIO
    times one device's bf16 logits (the mean over the steps); every rank's
    cache block bit-equal to the one device's rows outside the rows the
    steps wrote, and those rows no farther from fp32's than TP_BF16_RATIO
    times one device's; the ledger == LONG_STEPS x the dry run's decode
    cell on the same rules and shape; no kernel launch.  Returns the
    launches."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs as cell_specs
    from repro_torch.models import model
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(arch), num_layers=LONG_FULL[arch])
    params = model.init_params(cfg, seed=0)
    toks = torch.as_tensor(np.random.default_rng(17).integers(
        0, cfg.vocab_size, (1, LONG_STEPS))).cuda()
    index = torch.full((1,), LONG_START, device="cuda")
    caches = _long_cache(cfg, dev, 0)
    kv_bytes = sum(v.numel() * v.element_size() for layer in caches
                   for k, v in layer.items() if k in ("k", "v"))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = copy.deepcopy(params).float()
    c32 = [{k: v.float() for k, v in layer.items()} for layer in caches]
    l32, ms = [], {}
    torch.cuda.synchronize()
    ts = time.perf_counter()
    for t in range(LONG_STEPS):
        l32.append(model.decode_step(params32, cfg32, toks[:, t:t + 1], c32,
                                     index + t)[0].float())
    torch.cuda.synchronize()
    ms["fp32 one device"] = 1e3 * (time.perf_counter() - ts) / LONG_STEPS
    rows32 = [{k: v[:, LONG_START:].clone() for k, v in layer.items()
               if k in ("k", "v")} for layer in c32]
    del c32, params32
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    ts = time.perf_counter()
    got, blocks, bspecs, mesh, led = _seq_sharded_decode(
        cfg, params, caches, toks, index, LONG_STEPS, dev)
    torch.cuda.synchronize()
    ms["(2, 2) sequence-sharded"] = 1e3 * (time.perf_counter() - ts) / \
        LONG_STEPS
    launches = _recurrent_launches(f"phase 15c {arch}")
    torch.cuda.synchronize()
    ts = time.perf_counter()
    one = []
    for t in range(LONG_STEPS):
        one.append(model.decode_step(params, cfg, toks[:, t:t + 1], caches,
                                     index + t)[0].float())
    torch.cuda.synchronize()
    ms["bf16 one device"] = 1e3 * (time.perf_counter() - ts) / LONG_STEPS
    d_one = [float((a - b).abs().max()) for a, b in zip(one, l32)]
    d_tp = [float((a.float() - b).abs().max()) for a, b in zip(got, l32)]
    ratio = float(np.mean(d_tp)) / float(np.mean(d_one))
    if not (all(np.isfinite(d_tp)) and ratio <= TP_BF16_RATIO):
        raise AssertionError(f"15c {arch}: sequence-sharded logits {d_tp} "
                             f"from fp32, one device's bf16 {d_one} (limit "
                             f"{TP_BF16_RATIO} times the mean)")
    # every rank's block against the one device's rows: bit-equal outside
    # the written rows, the written rows held as the logits are
    D, M = TP_TRAIN_MESH
    half = LONG_S // D
    worst = 0.0
    for i, pos in enumerate(_positions(TP_TRAIN_MESH)):
        for l, layer in enumerate(blocks[i]):
            for k in ("k", "v"):
                if k not in layer:
                    continue
                mine = layer[k]
                rows = shd._block_of(caches[l][k], bspecs[l][k], pos, mesh)
                lo = LONG_START - pos["data"] * half
                keep = min(max(lo, 0), half)
                if not torch.equal(mine[:, :keep], rows[:, :keep]):
                    raise AssertionError(f"15c {arch}: rank {pos}'s layer {l}"
                                         f" {k} differs from one device's "
                                         f"rows below the written ones")
                if keep == half:
                    continue
                cols = mine.shape[-1]
                ref = rows32[l][k][..., pos["model"] * cols:
                                   (pos["model"] + 1) * cols]
                d_t = float((mine[:, keep:].float() - ref).abs().max())
                d_o = float((rows[:, keep:].float() - ref).abs().max())
                worst = max(worst, d_t / max(d_o, 1e-30))
                if not d_t <= TP_BF16_RATIO * d_o:
                    raise AssertionError(f"15c {arch}: rank {pos}'s written "
                                         f"{k} rows of layer {l} {d_t} from "
                                         f"fp32, one device's {d_o}")
    rules = shd.serve_rules(shd.Mesh(TP_TRAIN_MESH, ("data", "model")),
                            seq_shard=True)
    fn, args, in_sh = cell_specs.build_decode_cell(
        cfg, ShapeConfig("15c", LONG_S, 1, "decode"), rules)
    cell = dryrun.rank_collectives(fn, args, in_sh, rules)
    want = {part: {k: LONG_STEPS * v for k, v in cell[part].items() if v}
            for part in ("bytes", "counts")}
    got_led = {part: {k: v for k, v in led[part].items() if v}
               for part in ("bytes", "counts")}
    if got_led != want:
        raise AssertionError(f"15c {arch}: ledger {got_led} != {LONG_STEPS} "
                             f"x the dry run's decode cell {want}")
    peak = torch.cuda.max_memory_allocated()
    del params, caches, blocks, got, one
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15c, {arch} long_500k at full width on {cfg.num_layers} "
          f"layers (bf16, B 1 x S {LONG_S}, {kv_bytes / 2 ** 30:.2f} GiB of "
          f"KV on one device), {LONG_STEPS} decode steps from {LONG_START} "
          f"on {TP_TRAIN_MESH} (data, model) of [cuda:0] * 4 [{card}]: "
          f"logits' max_abs from fp32 one device bf16 "
          f"{', '.join(f'{x:.4g}' for x in d_one)}, sequence-sharded "
          f"{', '.join(f'{x:.4g}' for x in d_tp)} (mean ratio {ratio:.3f}, "
          f"limit {TP_BF16_RATIO}); written rows' ratio at most "
          f"{worst:.3f}; every rank's other rows == one device's; ledger "
          f"{got_led['bytes']} B == {LONG_STEPS} x the dry run's; ms a step "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()) +
          f"; peak {peak / 1e9:.2f} GB; launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def check_long_sp(card):
    """Phase 15: ``long_500k``'s sequence-sharded decode and Megatron-SP
    (ROADMAP item 11b part 2b): 15a reduced, 15b SP training at full
    width, 15c long_500k at full width.  Returns each kernel's launches by
    path (K4 on zamba2-7b's SP training, on each rank's heads over the
    gathered sequence; none elsewhere)."""
    import torch
    t0 = time.perf_counter()
    release_pinned()
    torch.cuda.empty_cache()
    paths = {}
    for name, launches in check_sp_small().items():
        paths[f"{name} reduced Megatron-SP training (phase 15a)"] = launches
    paths["gemma2-2b, gemma3-12b, zamba2-7b and xlstm-1.3b reduced "
          "sequence-sharded decode (phase 15a)"] = check_long_small()
    for arch in SP_FULL:
        paths[f"{arch} Megatron-SP training, full and offload (phase "
              f"15b)"] = train_sp_full(arch, card)
    for arch in LONG_FULL:
        paths[f"{arch} long_500k sequence-sharded decode (phase 15c)"] = \
            run_long_full(arch, card)
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s; launches on its "
          f"paths: {paths}", flush=True)
    return paths


# ---------------------------------------------------------------- timing ----

def time_ms(fn, reps=20, flush_bytes=64 << 20, spin_cycles=SPIN_CYCLES):
    """Median ms of ``fn`` over ``reps`` launches, each after writing a
    buffer larger than L2 so every launch starts from a cold cache.  A
    device-side spin of ``spin_cycles`` (about 0.5 ms by default) between
    the flush and the start event keeps the card busy while the host
    enqueues ``fn``, so the events time the device's work and not the
    host's launch overhead."""
    import torch
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def h2d_bytes_per_s(nbytes=256 << 20):
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True), reps=5,
                 flush_bytes=1)
    return nbytes / (ms * 1e-3)


def d2h_bytes_per_s(nbytes=256 << 20):
    """Device -> pinned host copy rate: the direction a demotion moves."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True), reps=5,
                 flush_bytes=1)
    return nbytes / (ms * 1e-3)


def device_copy_bytes_per_s(nbytes=1 << 30):
    """Device memory rate of a device-to-device copy: each byte is read
    once and written once, so 2 x nbytes cross the memory over the time."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=5, flush_bytes=1)
    return 2 * nbytes / (ms * 1e-3)


def demotion_seconds(cfg, rounds=5, n=48):
    """Host seconds of one ``PagedKVPools.demote_boundary`` at smollm-360m's
    width: one 16-token page of every layer's K and V copied device ->
    pinned host, enqueued back to back as the engine does, median over
    ``rounds`` of ``n`` demotions after 8 warm-up ones.  Returns (seconds,
    bytes) of one demotion."""
    import torch
    from repro_torch.models import kvcache, model
    dt = model.param_dtype(cfg)
    runs = []
    for _ in range(rounds):
        pools = kvcache.PagedKVPools(cfg, 1, MAX_SEQ, PAGE, dt, "cuda")
        for _ in range(pools.num_pages):
            pools.table.alloc(0, 0)
        for _ in range(8):
            pools.demote_boundary(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            pools.demote_boundary(0)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / n)
    page_bytes = PAGE * kvcache.kv_token_bytes(
        cfg, torch.finfo(dt).bits // 8) * cfg.num_layers
    return float(np.median(runs)), page_bytes


def measure_machine(cfg, card):
    """The rates behind H100_COST's measured constants, each printed beside
    the constant (for reading: nothing here gates the run)."""
    from repro_torch.runtime import H100_COST
    copy_bw = device_copy_bytes_per_s()
    h2d, d2h = h2d_bytes_per_s(), d2h_bytes_per_s()
    demote_s, page_bytes = demotion_seconds(cfg)
    overhead = demote_s - page_bytes / d2h
    print(f"machine: device-to-device copy {copy_bw / 1e9:.1f} GB/s "
          f"(fast_read_bw/fast_write_bw {H100_COST.fast_read_bw / 1e9:.1f}); "
          f"pinned H2D {h2d / 1e9:.2f} GB/s (slow_read_bw "
          f"{H100_COST.slow_read_bw / 1e9:.2f}, mig_read_bw "
          f"{H100_COST.mig_read_bw / 1e9:.2f}); D2H {d2h / 1e9:.2f} GB/s "
          f"(mig_write_bw {H100_COST.mig_write_bw / 1e9:.2f}); one demotion "
          f"of {page_bytes:.0f} B {1e6 * demote_s:.2f} us, less its bytes "
          f"at D2H: {1e6 * overhead:.2f} us (mig_overhead "
          f"{1e6 * H100_COST.mig_overhead:.2f} us) [{card}]", flush=True)


def device_profile(run, steps):
    """torch.profiler over ``steps`` calls of ``run``.  Returns (wall us
    under the profiler, rows of (device us, launches, kernel name), largest
    first).  Only device-side events count: a CPU op's device time is the
    time of kernels that are listed on their own too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return wall_us, sorted(rows, reverse=True)


def print_profile(what, wall_us, rows, steps, card, unit="step", top=6):
    if not rows:
        print(f"{what} profile: no device time in the trace (not measured)",
              flush=True)
        return 0.0
    busy = sum(r[0] for r in rows)
    top = "; ".join(f"{k[:60]} {us / steps / 1e3:.3f} ms x{n // steps}"
                    for us, n, k in rows[:top])
    print(f"{what} profile: {wall_us / steps / 1e3:.3f} ms per {unit} under "
          f"the profiler, device busy {100 * busy / wall_us:.1f}% "
          f"({busy / steps / 1e3:.3f} ms device time per {unit}); top device "
          f"ops per {unit}: {top} [{card}]", flush=True)
    return busy


def profile_decode(params, cfg, plan, reqs, card, steps=8, *,
                   max_seq=MAX_SEQ, what="decode", paged=True, decode=DECODE):
    """Where a decode step's time goes: torch.profiler over ``steps`` pure
    decode steps of the tiered pools engine (or, with ``paged`` False, the
    plan's concat layout) once all slots decode, each with a budget of
    ``decode`` tokens.  Prints
    the device-busy share (device time summed over all device kernels /
    wall time, profiler on) and the kernels that take the most device time.
    Returns the engine, its slots decoding, for the K3 phase."""
    import torch
    from repro_torch.serve.engine import ContinuousBatcher
    b = ContinuousBatcher(params, cfg, SLOTS, max_seq, plan=plan, paged=paged)
    for toks, key in reqs[:SLOTS]:
        b.submit(torch.as_tensor(toks), decode, prefix_key=key)
    for _ in range(1000):
        if not b._jobs and all(b.active):
            break
        b.step()
    else:
        raise AssertionError("profile window: the slots never all decoded")
    wall_us, rows = device_profile(b.step, steps)
    print_profile(what, wall_us, rows, steps, card)
    return b


def k1_time(c, what, card, window=0):
    """K1's time on case ``c`` beside its bound, its plain version's and
    one SDPA call's, at the wrapper's split count against one split in
    turns (planned, 1, 1, planned), with a sliding ``window`` where given
    (the pages wholly before it are neither input the function needs nor
    work it does).  Returns the kernels line's numbers."""
    import torch
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    B, S, H, KVH, D, page = c["shape"]
    lengths = c["lengths"].tolist()
    esize = c["q"].element_size()
    page_bytes = page * KVH * D * 2 * esize          # K and V, all heads
    # distinct physical pages this run's lengths make the kernel read, by
    # the pool it reads them from (tier 0 hot; cold and FREE entries, clipped
    # as the kernel clips them, from the pinned pool): each is input the
    # function must move once.  The unmapped slot visits clipped cold page 0
    # for every page of its length; that page counts once.  The arithmetic
    # counts every visit.
    table, tier = c["page_table"].cpu(), c["page_tier"].cpu()
    n_pool = {True: c["k_hot"].shape[0], False: c["k_cold"].shape[0]}
    first = [max(0, n - window) // page if window else 0 for n in lengths]
    read = set()
    for b, n in enumerate(lengths):
        for i in range(first[b], -(-n // page)):
            hot = int(tier[b, i]) == 0
            read.add((hot, min(max(int(table[b, i]), 0), n_pool[hot] - 1)))
    hot_pages = sum(1 for hot, _ in read if hot)
    cold_pages = len(read) - hot_pages
    tokens = sum(-(-n // page) - f for n, f in zip(lengths, first)) * page
    # q in, out back, and the int32 table, tier and lengths
    io_bytes = 2 * c["q"].numel() * esize + (2 * B * (S // page) + B) * 4
    h2d = h2d_bytes_per_s()
    bytes_s = max((hot_pages * page_bytes + io_bytes) / HBM_BYTES_PER_S,
                  cold_pages * page_bytes / h2d)
    ops_s = 4.0 * H * D * tokens / FP32_FLOP_PER_S
    bound_ms = 1e3 * max(bytes_s, ops_s)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    planned, group, tile = pd.plan(c["q"], KVH, page, S // page)
    args = k1_args(c)
    turns = [(n, time_ms(lambda: pd._launch(*args, window, 0.0, n, group,
                                            tile)))
             for n in (planned, 1, 1, planned)]
    ms = float(np.mean([t for n, t in turns if n == planned]))
    dev_args = k1_args(c, True)
    plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(
        *dev_args, window=window), reps=5)
    # yardstick only: one SDPA call over the same KV gathered densely
    library_ms = time_ms(_sdpa_decode(c["q"], *c["dense"], c["lengths"],
                                      window))
    print(f"k1 time ({what}): {ms:.4f} ms (mean of the two turns at "
          f"{planned} splits) at B{B} H{H} KVH{KVH} D{D} page{page} "
          f"window {window} "
          f"{c['q'].dtype} ({hot_pages} hot + {cold_pages} cold distinct "
          f"pages of {page_bytes} B, {tokens // page} page visits); "
          f"bound {bound_ms:.4f} ms (hot at {HBM_BYTES_PER_S / 1e12} TB/s, "
          f"cold at measured pinned H2D {h2d / 1e9:.2f} GB/s), "
          f"{100 * bound_ms / ms:.1f}% of it; plain {plain_ms:.4f} ms; sdpa "
          f"{library_ms:.4f} ms [{card}]", flush=True)
    print(f"k1 splits ({what}, in turns): " + ", ".join(
        f"{n}: {t:.4f} ms" for n, t in turns) + f" (the wrapper takes "
        f"{planned}: {B} slots, {KVH // group} KV head group(s) of {group}, "
        f"{S // page} pages, {n_sm} SMs; tile {tile}) [{card}]",
        flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library_ms, "splits": planned}


def k1_record(full, err, launches, zamba, gemma3, card):
    """The kernels line's K1 entry: the smollm serving shape's numbers
    (phase 3's launches), with zamba2-7b's shared-block shape and
    gemma3-12b's serving shape (its LOCAL layers' 1024-token window and
    its global layers) beside them and the launches of every path that
    ran it."""
    rec = {"name": "paged_decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
           "replaces": "src/repro/kernels/paged_decode.py:119",
           "launches": launches, "max_abs_err": err}
    rec.update(k1_time(full, "smollm-360m serving shape", card))
    rec["zamba2_shape"] = dict(k1_time(zamba[0], "zamba2-7b shared-block "
                                       "shape", card), max_abs_err=zamba[1])
    for window in (K1_GEMMA3_WINDOW, 0):
        rec[f"gemma3_shape_window_{window}"] = dict(
            k1_time(gemma3[0], "gemma3-12b serving shape", card,
                    window=window), max_abs_err=gemma3[1][window])
    return rec


# ------------------------------------------------------------------ K4 ----

# B, S, H, P, N, chunk: tests/test_kernels.py's SSD sweep, then one
# zamba2-7b layer at train_4k's sequence of 4096
K4_SWEEP = [(2, 64, 4, 16, 16, 16), (1, 128, 8, 32, 64, 32),
            (2, 96, 2, 8, 32, 32)]
K4_FULL = (1, 4096, 112, 64, 64, 256)
# K4 on one rank's block of zamba2-7b's SSM heads under a rank context
# (phase 13): B 2 x S 4096, 112 heads over a model axis of 2 and of 4
K4_RANK = ((2, 4096, 56, 64, 64, 256), (2, 4096, 28, 64, 64, 256))
ZAMBA_B, ZAMBA_S, ZAMBA_RUNS = 2, 4096, 3


def _k4_tol(dtype):
    """f32: the reference kernel test's own limit, atol 1e-3
    (tests/test_kernels.py:77-80).  bf16 output: both versions compute in
    f32 from the same bf16 inputs, so their roundings may differ by one bf16
    ulp, at most 2**-7 of the value: K1's limit.  The f32 state is held to
    the f32 limit whatever the inputs' dtype."""
    import torch
    return dict(atol=1e-3, rtol=0.0) if dtype == torch.float32 \
        else dict(atol=2e-3, rtol=8e-3)


def _k4_close(got, want, what):
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"k4 {what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    tol = _k4_tol(got.dtype)
    torch.testing.assert_close(
        got.float(), want.float(), **tol,
        msg=lambda m: f"k4 {what}: max_abs_err {err:.3e}, limit atol "
                      f"{tol['atol']:g} + rtol {tol['rtol']:g}: {m}")
    return err


def k4_case(shape, dtype, seed, *, with_h0=False, model_layout=False):
    """SSD inputs on the card, drawn as the reference kernel test draws
    them.  ``model_layout``: x, B and C are column slices of one
    (B, S, H*P + 2N) tensor, as MambaBlock hands them to the kernel."""
    import torch
    import torch.nn.functional as F
    B, S, H, P, N, chunk = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device="cuda")

    if model_layout:
        xbc = (randn(B, S, H * P + 2 * N) * 0.5).to(dtype)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    else:
        x = (randn(B, S, H, P) * 0.5).to(dtype)
        Bm = (randn(B, S, N) * 0.5).to(dtype)
        Cm = (randn(B, S, N) * 0.5).to(dtype)
    dt = F.softplus(randn(B, S, H)).to(dtype)
    A = -torch.exp(randn(H) * 0.3)
    h0 = randn(B, H, P, N) * 0.5 if with_h0 else None
    return (x, dt, A, Bm, Cm), dict(chunk=chunk, h0=h0)


def check_k4():
    """Phase (a): K4 against its plain version on the card over the
    reference's SSD sweep (f32 and bf16), a start state h0, S < chunk, a
    bf16 P of 12 (the SIMT kernel by the wrapper's rule) and the full-width
    shape in the model's layout, each on the kernel the wrapper picks; the
    bf16 sweep and the full-width bf16 shape again on the SIMT kernel that
    k4_record times against the tensor-core kernel, at two heads a CTA (and
    one at full width, what the wrapper takes there at B 1); then the bf16
    tensor-core kernel at given segment counts (1 up to more than the
    planner takes, with h0).  Prints which kernel each case ran on.
    Returns the full-width bf16 case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as k4
    torch.backends.cuda.matmul.allow_tf32 = False     # plain version in fp32
    f32, bf16 = torch.float32, torch.bfloat16
    simt2 = {"kernel": "simt", "block_heads": 2}
    cases = [(s, dt, opt) for s in K4_SWEEP
             for dt, opt in ((f32, {}), (bf16, {}), (bf16, simt2))]
    cases += [((2, 64, 4, 16, 16, 16), dt, {"with_h0": True})
              for dt in (f32, bf16)]
    cases += [((1, 40, 4, 16, 32, 256), f32, {}),      # S < chunk
              ((1, 40, 4, 16, 32, 256), bf16, {}),
              ((2, 192, 4, 64, 64, 64), f32,
               {"block_heads": 2, "with_h0": True}),
              ((2, 64, 4, 12, 16, 16), bf16, {})]      # P 12: SIMT
    cases += [(K4_FULL, dt, {"model_layout": True}) for dt in (f32, bf16)]
    cases += [(shape, dt, {"model_layout": True}) for shape in K4_RANK
              for dt in (f32, bf16)]
    cases += [(K4_FULL, bf16, {"model_layout": True, "kernel": "simt",
                               "block_heads": bh}) for bh in (1, 2)]
    cases += [((2, 192, 4, 64, 64, 64), bf16,
               {"with_h0": True, "segments": n}) for n in (1, 2, 3)]
    cases += [((1, 1000, 2, 32, 16, 8), bf16,         # ragged last chunk
               {"with_h0": True, "segments": n}) for n in (1, 4)]
    cases += [(K4_FULL, bf16, {"model_layout": True, "segments": n})
              for n in (1, 2, 5)]
    worst, ran = {}, {"mma": 0, "simt": 0}
    full = None
    for i, (shape, dt, opt) in enumerate(cases):
        args, kw = k4_case(shape, dt, seed=100 + i,
                           with_h0=opt.get("with_h0", False),
                           model_layout=opt.get("model_layout", False))
        kernel = opt.get("kernel") or k4.path(args[0], args[3], args[4])
        ran[kernel] += 1
        y, h = k4._launch(*args, **kw, kernel=opt.get("kernel"),
                          block_heads=opt.get("block_heads"),
                          segments=opt.get("segments"))
        y_ref, h_ref = ref.ssd_chunked_ref(*args, **kw)
        torch.cuda.synchronize()
        what = f"{shape} {dt} {opt} on {kernel}"
        ey = _k4_close(y, y_ref, what + " y")
        eh = _k4_close(h, h_ref, what + " h")
        key = (kernel, "full" if shape == K4_FULL else
               "rank" if shape in K4_RANK else "sweep")
        wy, wh = worst.get(key, (0.0, 0.0))
        worst[key] = (max(wy, ey), max(wh, eh))
        if shape == K4_FULL and dt == bf16 and opt == {"model_layout": True}:
            if kernel != "mma":
                raise AssertionError("k4: the full-width bf16 case did not "
                                     "run on the tensor-core kernel")
            full = (args, kw, ey)
    t32, t16 = _k4_tol(f32), _k4_tol(bf16)
    errs = "; ".join(f"{k} {w}: y {worst[(k, w)][0]:.3e} h "
                     f"{worst[(k, w)][1]:.3e}" for k, w in sorted(worst))
    print(f"k4 check: {len(cases)} cases match the plain version "
          f"(ssd_chunked_ref), the rank shapes {K4_RANK} among them, "
          f"{ran['mma']} on the tensor-core kernel (bf16, "
          f"segments 1-5 given and planned), {ran['simt']} on the SIMT "
          f"kernel (bf16 at two heads a CTA, and one at full width, "
          f"included); max_abs_err {errs} (f32 y and every h within atol "
          f"{t32['atol']:g}, bf16 y within atol {t16['atol']:g} + rtol "
          f"{t16['rtol']:g})", flush=True)
    return full


def check_k4_ragged():
    """K4 through ops.ssd on zamba2-7b's layer (B 1, H 112, P = N = 64) at
    prompt lengths that are not whole 256-token chunks, from a random start
    state, in the model's layout: ops.ssd pads to whole chunks with dt = 0
    and cuts y back, one K4 launch a call; held to the plain version (which
    pads the same way) at K4's limits."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as k4
    errs = []
    for S in (700, 1300):
        for dt in (torch.float32, torch.bfloat16):
            args, kw = k4_case((1, S, 112, 64, 64, 256), dt, seed=S,
                               with_h0=True, model_layout=True)
            reset_counts()
            y, h = ops.ssd(*args, **kw)
            if k4.ssd.launches != 1:
                raise AssertionError(f"k4 ragged S {S}: {k4.ssd.launches} "
                                     f"launches")
            y_ref, h_ref = ref.ssd_chunked_ref(*args, **kw)
            torch.cuda.synchronize()
            what = f"ragged S {S} {dt} with h0 on " \
                f"{k4.path(args[0], args[3], args[4])}"
            errs.append((S, str(dt)[6:], _k4_close(y, y_ref, what + " y"),
                         _k4_close(h, h_ref, what + " h")))
    print("k4 ragged check (ops.ssd pads to whole chunks, one launch a "
          "call, h0 random): " + "; ".join(
              f"S {S} {dt}: y {ey:.3e} h {eh:.3e}" for S, dt, ey, eh in errs)
          + " == plain within K4's limits", flush=True)


def _n_mamba(cfg):
    from repro_torch.configs.base import MAMBA
    return sum(cfg.layer_kind(l) == MAMBA for l in range(cfg.num_layers))


def check_zamba_small():
    """Phase (b): zamba2-7b.reduced() in fp32 on the card (K4) against the
    same parameters on the CPU (plain version): logits and loss."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd as k4
    from repro_torch.models.model import forward, init_params, loss_fn
    cfg = get_config("zamba2-7b").reduced()
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    if params_gpu.layers[cfg.period_len - 1] is not params_gpu.shared:
        raise AssertionError("the shared block was copied")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 41))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    gpu_batch = {k: v.cuda() for k, v in batch.items()}
    reset_counts()
    logits_g = forward(params_gpu, cfg, gpu_batch)
    loss_g = loss_fn(params_gpu, cfg, gpu_batch)
    torch.cuda.synchronize()
    launches = k4.ssd.launches
    if launches != 2 * _n_mamba(cfg):
        raise AssertionError(f"reduced zamba2: {launches} K4 launches for 2 "
                             f"forwards x {_n_mamba(cfg)} MAMBA layers")
    logits_c = forward(params_cpu, cfg, batch)
    loss_c = loss_fn(params_cpu, cfg, batch)
    tol = dict(atol=1e-4, rtol=0.0)
    err = float((logits_g.cpu() - logits_c).abs().max())
    torch.testing.assert_close(logits_g.cpu(), logits_c, **tol)
    torch.testing.assert_close(loss_g.cpu(), loss_c, **tol)
    print(f"small zamba2 check: reduced fp32 logits on the card (K4, "
          f"{launches} launches) == on the CPU (plain): max_abs_err "
          f"{err:.3e}, loss {float(loss_g):.6f} vs {float(loss_c):.6f}, "
          f"within atol {tol['atol']:g}", flush=True)


def run_zamba_full(card):
    """Phase (c): zamba2-7b at full width, bf16, random weights from seed 0,
    on B 2 x S 4096 tokens: the loss and the forward, K4's launches against
    65 MAMBA layers x forwards, the first Mamba layer's K4 output against
    the plain version on the same tensors, the forward's time and a
    profile.  Returns what phase (d) needs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as k4
    from repro_torch.models.model import forward, init_params, loss_fn
    cfg = get_config("zamba2-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (ZAMBA_B, ZAMBA_S + 1),
                         generator=g, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    torch.cuda.synchronize()
    print(f"zamba2-7b: {sum(p.numel() for p in params.parameters()) / 1e9:.3f}"
          f" B parameters on the card, {torch.cuda.memory_allocated() / 1e9:.1f}"
          f" GB, init {time.perf_counter() - t0:.1f} s", flush=True)

    first = params.prologue[0].mamba
    captured, shared_in = {}, {}

    def capture(module, args, out):     # the first Mamba layer, once
        if not captured:
            captured.update(x=args[1], h=out[1]["h"])

    def capture_attn(module, args, out):    # the first SHARED_ATTN layer
        if not shared_in:
            shared_in.update(x=args[1], positions=args[2])

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hooks = [first.register_forward_hook(capture),
             params.shared.attn.register_forward_hook(capture_attn)]
    try:
        loss = loss_fn(params, cfg, batch)
    finally:
        for hook in hooks:
            hook.remove()
    logits = forward(params, cfg, batch)
    times = []
    for _ in range(ZAMBA_RUNS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        forward(params, cfg, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    launches = k4.ssd.launches
    forwards = 2 + ZAMBA_RUNS
    n_mamba = _n_mamba(cfg)
    if launches != n_mamba * forwards:
        raise AssertionError(f"zamba2-7b: {launches} K4 launches for "
                             f"{forwards} forwards x {n_mamba} MAMBA layers")
    if not (torch.isfinite(loss) and bool(torch.isfinite(logits).all())):
        raise AssertionError("zamba2-7b: non-finite loss or logits")
    if tuple(logits.shape) != (ZAMBA_B, ZAMBA_S, cfg.padded_vocab):
        raise AssertionError(f"zamba2-7b: logits {tuple(logits.shape)}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del logits
    med = float(np.median(times))
    print(f"zamba2-7b forward: loss {float(loss):.4f} (finite, ln V = "
          f"{np.log(cfg.vocab_size):.4f}), logits finite; {launches} K4 "
          f"launches = {forwards} forwards x {n_mamba} MAMBA layers; forward "
          f"{med * 1e3:.1f} ms (median of {ZAMBA_RUNS} after the loss and a "
          f"warm-up: {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{ZAMBA_B * ZAMBA_S / med:.0f} tokens/s at B {ZAMBA_B} x S "
          f"{ZAMBA_S}; peak memory {peak:.1f} GB [{card}]", flush=True)

    # the first layer's scan again on its captured input (a check launch,
    # after the count was read): it must give the main path's state, and
    # agree with the plain version
    _, args, _ = first.ssd_inputs(cfg, captured["x"])
    kw = dict(chunk=cfg.ssm.chunk, h0=None)
    if k4.path(args[0], args[3], args[4]) != "mma":
        raise AssertionError("zamba2-7b: the forward's K4 calls are not on "
                             "the tensor-core kernel")
    y, h = k4.ssd(*args, **kw)
    if not torch.equal(h, captured["h"]):
        raise AssertionError("zamba2-7b: K4 gave another state on the same "
                             "first-layer input than in the forward")
    y_ref, h_ref = ref.ssd_chunked_ref(*args, **kw)
    torch.cuda.synchronize()
    ey = _k4_close(y, y_ref, "first Mamba layer y")
    eh = _k4_close(h, h_ref, "first Mamba layer h")
    del y_ref, h_ref
    t16, t32 = _k4_tol(torch.bfloat16), _k4_tol(torch.float32)
    print(f"zamba2-7b first Mamba layer: K4 on the real activations "
          f"{tuple(args[0].shape)} {args[0].dtype} == plain version: "
          f"max_abs_err y {ey:.3e} (atol {t16['atol']:g} + rtol "
          f"{t16['rtol']:g}), h {eh:.3e} (atol {t32['atol']:g}); max |y| "
          f"{float(y.float().abs().max()):.3e}, max |h| "
          f"{float(h.abs().max()):.3e}", flush=True)

    wall_us, rows = device_profile(lambda: forward(params, cfg, batch), 1)
    busy = print_profile("zamba2-7b forward", wall_us, rows, 1, card,
                         unit="forward", top=12)
    k4_us = sum(us for us, _, k in rows if "ssd_" in k)
    if busy:
        print(f"zamba2-7b forward: K4 {k4_us / 1e3:.3f} ms of "
              f"{busy / 1e3:.3f} ms device time ({100 * k4_us / busy:.1f}%), "
              f"{k4_us / 1e3 / n_mamba:.3f} ms per launch [{card}]",
              flush=True)
    # the first SHARED_ATTN layer's q, k, v, rebuilt from its input, for K2
    qkv = params.shared.attn.qkv(cfg, shared_in["x"],
                                 shared_in["positions"])
    return {"args": args, "kw": kw, "err": ey, "launches": launches,
            "forwards": forwards, "n_mamba": n_mamba, "qkv": qkv,
            "softcap": cfg.attn_softcap, "params": params, "cfg": cfg}


def zamba_requests(vocab: int, seed: int = 6):
    """12 prompts of 200-1500 tokens, none a whole number of 256-token
    chunks; four share a 256-token prefix under one key."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 256)
    reqs = []
    for i, n in enumerate(rng.integers(200, 1501, 12)):
        n = int(n) + (int(n) % 256 == 0)
        if i % 3 == 1:
            n = max(n, 301)
            reqs.append((np.concatenate([prefix,
                                         rng.integers(0, vocab, n - 256)]),
                         "sys"))
        else:
            reqs.append((rng.integers(0, vocab, n), None))
    return reqs


def check_zamba_serving_small():
    """zamba2-7b.reduced() in fp32 served on the pools layout on the card
    (K1 for the shared block, K4 for every Mamba layer's prefill) and on the
    CPU (plain path) from the same parameters: identical tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.plan import PlacementPlan
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              use_paged_decode=True)
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    rng = np.random.default_rng(8)
    sys_p = rng.integers(0, cfg.vocab_size, 9)
    reqs = [(np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, 3 + i)]),
             "sys") for i in range(3)] + \
        [(rng.integers(0, cfg.vocab_size, 21), None)]
    plan = PlacementPlan(hot_window=8, slot_hot_windows=[4, 8],
                         page_tokens=4)
    got = {dev: serve(p, cfg, plan, reqs, max_seq=48, slots=2, decode=10,
                      device=dev)
           for dev, p in (("cuda", params_gpu), ("cpu", params_cpu))}
    run = got["cuda"]
    n_mamba = _n_mamba(cfg)
    n_attn = cfg.num_layers - n_mamba
    if run["out"] != got["cpu"]["out"]:
        raise AssertionError("reduced fp32 zamba2 engine: card tokens "
                             "differ from the CPU's plain path")
    if run["k1"] != run["b"].decode_steps * n_attn or \
            run["k4"] != len(reqs) * n_mamba or not run["cold_steps"]:
        raise AssertionError(f"reduced zamba2 engine: {run['k1']} K1 and "
                             f"{run['k4']} K4 launches, {run['cold_steps']} "
                             f"decode steps with cold pages")
    print(f"small zamba2 serve check: reduced fp32 engine tokens on the card "
          f"(K1 {run['k1']}, K4 {run['k4']} launches) == on the CPU plain "
          f"path", flush=True)


def serve_zamba(params, cfg, card):
    """Phase 4b: zamba2-7b serving at full width on the pools layout (bf16,
    the forward phase's parameters): 8 slots of 2048 tokens, page 16, hand
    hot windows of 256-480 tokens so admission and decode demote pages,
    zamba_requests with 32 decode tokens each.  Admission is one dense
    prefill (K4 in each of the 65 Mamba layers, over a ragged S from the
    cache's zero state), then admit_rows and splice_other; decode runs K1
    in the 16 shared-block uses and ssd_decode in the Mamba layers.  Fails
    unless the tokens equal an all-hot run's, K4 ran admissions x 65 times
    and K1 decode steps x 16 times in each run, and the integer counters
    equal predict_pool_counters(..., dense_admit=True).  Prints prefill ms
    per admission, decode tokens/s, the pure-decode step, peak device
    memory and a profile of decode steps.  Returns the tiered run's K1 and
    K4 launches."""
    import torch
    from repro_torch.runtime.plan import PlacementPlan
    from repro_torch.serve.engine import predict_pool_counters
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, use_paged_decode=True)
    reqs = zamba_requests(cfg.vocab_size)
    windows = [256 + 32 * s for s in range(SLOTS)]          # 256..480
    tiered = PlacementPlan(hot_window=384, slot_hot_windows=windows,
                           page_tokens=PAGE)
    all_hot = dataclasses.replace(tiered, hot_window=ZAMBA_MAX_SEQ,
                                  slot_hot_windows=[ZAMBA_MAX_SEQ] * SLOTS)
    n_mamba = _n_mamba(cfg)
    n_attn = cfg.num_layers - n_mamba
    admit_ms = []

    def time_admissions(b):
        admit = b._admit_dense

        def timed(*args):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            admit(*args)
            torch.cuda.synchronize()
            admit_ms.append(1e3 * (time.perf_counter() - ts))
        b._admit_dense = timed

    runs = {}
    for name, plan in (("tiered", tiered), ("all_hot", all_hot)):
        torch.cuda.reset_peak_memory_stats()
        run = runs[name] = serve(
            params, cfg, plan, reqs, max_seq=ZAMBA_MAX_SEQ, slots=SLOTS,
            decode=DECODE, device="cuda",
            on_engine=time_admissions if name == "tiered" else None)
        run["peak"] = torch.cuda.max_memory_allocated() / 1e9
        # the engine's books, then its pools go before the next run
        b = run.pop("b")
        cnt = run["counters"] = b.counters()
        row_bytes, steps = b._row_bytes, b.decode_steps
        del b
        gc.collect()            # the timing wrapper holds the engine in a cycle
        torch.cuda.empty_cache()
        if len(run["out"]) != len(reqs) or \
                any(len(o) != DECODE for o in run["out"]):
            raise AssertionError(f"zamba2 serve {name}: malformed outputs")
        if run["k4"] != len(reqs) * n_mamba or \
                run["k1"] != steps * n_attn:
            raise AssertionError(
                f"zamba2 serve {name}: {run['k4']} K4 launches for "
                f"{len(reqs)} admissions x {n_mamba}, {run['k1']} K1 "
                f"launches for {steps} decode steps x {n_attn}")
        print(f"zamba2 serve {name}: {len(run['out'])} requests, "
              f"{steps} decode steps, K4 {run['k4']} = "
              f"{len(reqs)} admissions x {n_mamba}, K1 {run['k1']} = "
              f"{steps} decode steps x {n_attn}, page_copies "
              f"{cnt['page_copies']}, {run['cold_steps']} decode steps with "
              f"cold pages mapped, sim_migration_bytes "
              f"{cnt['sim_migration_bytes']:.0f}, peak memory "
              f"{run['peak']:.1f} GB", flush=True)
    run, out_h = runs["tiered"], runs["all_hot"]["out"]
    cnt = run["counters"]
    if run["out"] != out_h:
        raise AssertionError("zamba2 serve: tiered tokens differ from the "
                             "all-hot run")
    if not (cnt["page_copies"] > 0 and run["cold_steps"] > 0):
        raise AssertionError(f"zamba2 serve: no demotion on the card {cnt}")
    preq = [(tuple(int(x) for x in t), DECODE, None, k) for t, k in reqs]
    pred = predict_pool_counters(preq, tiered, slots=SLOTS,
                                 max_seq=ZAMBA_MAX_SEQ, page_tokens=PAGE,
                                 row_bytes=row_bytes, dense_admit=True)
    got = {k: cnt[k] for k in ("sim_migration_bytes", "step_migration_bytes",
                               "page_copies", "admit_page_writes")}
    want = {"sim_migration_bytes": pred["migration_bytes"],
            "step_migration_bytes": pred["step_migration_bytes"],
            "page_copies": pred["page_copies"],
            "admit_page_writes": pred["admit_page_writes"]}
    if got != want:
        raise AssertionError(f"zamba2 serve: engine counters {got} != "
                             f"predict_pool_counters {want}")
    decode_tokens = sum(len(o) - 1 for o in run["out"])
    lens = [len(t) for t, _ in reqs]
    print(f"zamba2 serve check: tiered tokens == all-hot tokens; K4 == "
          f"admissions x {n_mamba}, K1 == decode steps x {n_attn}; counters "
          f"== predict_pool_counters(dense_admit=True); prompts "
          f"{min(lens)}-{max(lens)} tokens, KV {row_bytes:.0f} B a token",
          flush=True)
    print(f"zamba2 serve time: prefill {float(np.mean(admit_ms)):.1f} ms per "
          f"admission (mean of {len(admit_ms)}, {min(admit_ms):.1f}-"
          f"{max(admit_ms):.1f}); {decode_tokens / run['wall']:.1f} decode "
          f"tokens/s over the whole tiered run ({run['wall']:.3f} s, prefill "
          f"included); mean pure decode step "
          f"{1e3 * float(np.mean(run['step_s'])):.3f} ms over "
          f"{len(run['step_s'])} steps of {SLOTS} slots; peak device memory "
          f"{run['peak']:.1f} GB [{card}]", flush=True)
    launches = {"k1": run["k1"], "k4": run["k4"]}
    torch.cuda.empty_cache()
    profile_decode(params, cfg, tiered, reqs, card, steps=4,
                   max_seq=ZAMBA_MAX_SEQ, what="zamba2 decode")
    print(f"phase 4b took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def k4_bound(B, S, H, P, N, esize):
    """(seconds by bytes, seconds by f32 operations, seconds by tensor-core
    operations, the chunk of the fewest operations) of one SSD call.
    Bytes: x and y, dt, B and C read or written once, the f32 state written
    once.  Operations: the fewest over the formulations the function
    allows, the chunked form at any chunk q dividing S (q = 1 is the
    token-by-token recurrence), counting per chunk the causal half, q(q+1)/2
    pairs, of C B^T (N per pair, shared by the heads) and of the masked G x
    (P per pair and head), C h^T and the state update B^T x (q N P each per
    head) and the state's decay (N P per head).  The f32 figure puts them
    all at the f32 CUDA-core rate (the reference upcasts every operand).
    The tensor-core figure puts the products at the bf16 tensor-core rate,
    each product with an f32 operand (G x, C h^T, the state update) counted
    twice, as the kernel splits that operand into two bf16 parts, and the
    decay at the f32 rate; the tensor-core kernel's bound is the larger of
    bytes and that."""
    nbytes = 2 * B * S * H * P * esize + B * S * H * esize + \
        2 * B * S * N * esize + B * H * P * N * 4

    def flops(q):
        pairs = q * (q + 1) // 2
        return (S // q) * B * (2 * pairs * N + H * (
            2 * pairs * P + 4 * q * N * P + N * P))

    def tc_seconds(q):
        pairs = q * (q + 1) // 2
        products = (S // q) * B * (2 * pairs * N + 2 * H * (
            2 * pairs * P + 4 * q * N * P))
        return products / BF16_FLOP_PER_S + \
            (S // q) * B * H * N * P / FP32_FLOP_PER_S

    divisors = [q for q in range(1, S + 1) if S % q == 0]
    q = min(divisors, key=flops)
    return nbytes / HBM_BYTES_PER_S, flops(q) / FP32_FLOP_PER_S, \
        min(tc_seconds(d) for d in divisors), q


def k4_record(main, full, card):
    """Phase (d): K4's time at the main path's shape (the captured first
    zamba2 layer, B 2) and at the full-width B 1 shape, each launch after an
    L2 flush, beside both bounds and its plain version's time: the
    tensor-core kernel the wrapper takes against the SIMT kernel in turns
    (mma, simt, simt, mma), then at other segment counts."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as k4
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, (args, kw) in (("main", (main["args"], main["kw"])),
                             ("b1", full[:2])):
        x, Bm = args[0], args[3]
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        if k4.path(x, Bm, args[4]) != "mma":
            raise AssertionError(f"k4 ({name}) is not on the tensor-core "
                                 f"kernel")
        planned = k4.plan(x)
        turns = [(kern, time_ms(lambda: k4._launch(*args, **kw,
                                                   kernel=kern)))
                 for kern in ("mma", "simt", "simt", "mma")]
        ms = float(np.mean([t for kern, t in turns if kern == "mma"]))
        simt_ms = float(np.mean([t for kern, t in turns if kern == "simt"]))
        plain_ms = time_ms(lambda: ref.ssd_chunked_ref(*args, **kw), reps=5)
        by_bytes, by_f32, by_tc, q = k4_bound(B, S, H, P, N,
                                              x.element_size())
        bound_ms = 1e3 * max(by_bytes, by_tc)
        out[name] = (ms, plain_ms, by_bytes, by_tc, by_f32, simt_ms, planned)
        print(f"k4 time ({name}): {ms:.4f} ms (tensor-core kernel, mean of "
              f"its two turns, {planned} segments) at B{B} S{S} H{H} P{P} "
              f"N{N} {x.dtype}; SIMT kernel {simt_ms:.4f} ms "
              f"({simt_ms / ms:.2f} times as long); bound {bound_ms:.4f} ms, "
              f"{100 * bound_ms / ms:.1f}% of it (bytes {1e3 * by_bytes:.4f} "
              f"ms at {HBM_BYTES_PER_S / 1e12} TB/s; tensor-core operations "
              f"{1e3 * by_tc:.4f} ms at {BF16_FLOP_PER_S / 1e12:g} TFLOP/s, "
              f"split operands counted twice); f32 bound "
              f"{1e3 * max(by_bytes, by_f32):.4f} ms (f32 operations "
              f"{1e3 * by_f32:.4f} ms at {FP32_FLOP_PER_S / 1e12} TFLOP/s, "
              f"fewest at chunk {q}); plain {plain_ms:.4f} ms; library: none "
              f"[{card}]", flush=True)
        print(f"k4 kernels ({name}, in turns): " + ", ".join(
            f"{kern} {t:.4f} ms" for kern, t in turns) + f" [{card}]",
            flush=True)
        seg_ms = [(n, time_ms(lambda: k4._launch(*args, **kw, segments=n)))
                  for n in sorted({1, 2, 3, 4, 6, planned})]
        print(f"k4 segments ({name}): " + ", ".join(
            f"{n}: {t:.4f} ms" for n, t in seg_ms) + f" (the wrapper takes "
            f"{planned}: B {B} x H {H}, {n_sm} SMs holding "
            f"{k4.ctas_per_sm(x.device)} CTAs each by the occupancy API) "
            f"[{card}]", flush=True)
    ms, plain_ms, by_bytes, by_tc, by_f32, simt_ms, planned = out["main"]
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/mamba2.py:75",
            "launches": main["launches"], "max_abs_err": main["err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(by_bytes, by_tc),
            "bound_by": "bytes" if by_bytes >= by_tc else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes the SSD scan",
            "kernel": "mma", "segments": planned, "simt_ms": simt_ms,
            "bound_f32_ms": 1e3 * max(by_bytes, by_f32),
            "b1": dict(zip(("ms", "plain_ms", "bytes_ms", "tc_ops_ms",
                            "f32_ops_ms", "simt_ms", "segments"),
                           (out["b1"][0], out["b1"][1],
                            1e3 * out["b1"][2], 1e3 * out["b1"][3],
                            1e3 * out["b1"][4], out["b1"][5],
                            out["b1"][6])))}


# ------------------------------------------------------------- K3 and K2 ----

# B, S, H, KVH, D, window: tests/test_kernels.py's decode sweep
K3_SWEEP = [(2, 256, 8, 2, 64, 0), (1, 100, 4, 4, 32, 0),
            (3, 512, 8, 1, 64, 64), (2, 64, 16, 8, 128, 16)]
# B, Sq, Skv, H, KVH, D: tests/test_kernels.py's flash sweep
K2_SWEEP = [(2, 128, 128, 4, 2, 64), (1, 64, 256, 8, 8, 32),
            (2, 100, 100, 6, 2, 64), (1, 1, 160, 4, 1, 64),
            (1, 32, 32, 2, 1, 128)]
K3_LONG = (8, 4096, 32, 32, 112)    # zamba2-7b's shared block at decode
WGMMA_D = (64, 112, 128)            # the head_dims K2's wgmma kernel takes


def _limit_text(dtype) -> str:
    import torch
    return _tol_text(dtype) + ("" if dtype == torch.float32 else
                               " + 2**-8 p.|v|")


def k3_case(shape, dtype, seed, *, lengths=None, strided=False):
    """K3 inputs on the card: q (B, H, D), caches (B, S, KVH, D) and int32
    lengths (the reference test's S // 2 + 3 b + 1 unless given).
    ``strided``: k and v are the two halves of one (B, S, KVH, 2 D)
    tensor."""
    import torch
    B, S, H, KVH, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    if strided:
        kv = torch.randn(B, S, KVH, 2 * D, generator=g,
                         device="cuda").to(dtype)
        k, v = kv[..., :D], kv[..., D:]
    else:
        k = torch.randn(B, S, KVH, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, S, KVH, D, generator=g, device="cuda").to(dtype)
    if lengths is None:
        lengths = [S // 2 + 3 * b + 1 for b in range(B)]
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def k2_case(shape, dtype, seed, *, strided=False):
    """K2 inputs on the card: q (B, Sq, H, D), k and v (B, Skv, KVH, D).
    ``strided`` (Sq == Skv): slices of one (B, S, H + 2 KVH, D) tensor, as
    a fused projection would give them."""
    import torch
    B, Sq, Skv, H, KVH, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device="cuda").to(dtype)

    if strided:
        qkv = randn(B, Sq, H + 2 * KVH, D)
        return qkv[:, :, :H], qkv[:, :, H:H + KVH], qkv[:, :, H + KVH:]
    return randn(B, Sq, H, D), randn(B, Skv, KVH, D), randn(B, Skv, KVH, D)


def _p_abs_v_k3(q, k, v, lengths, **kw):
    from repro_torch.kernels import ref
    return ref.decode_attention_ref(q.float(), k.float(), v.float().abs(),
                                    lengths, **kw)


def _p_abs_v_k2(q, k, v, **kw):
    from repro_torch.kernels import ref
    return ref.attention_ref(q.float(), k.float(), v.float().abs(), **kw)


def check_k3():
    """K3 against its plain version on the card over the reference's decode
    sweep in f32 and bf16, window/softcap cases, G 1, 3, 5 and 8 (head
    groups of at most four a CTA), D 8, 64, 112 and 256, caches read
    through strides, and length-0 slots, at the wrapper's split count;
    then at split counts 1, 2 and the wrapper's through the C argument,
    with windows and slots without a visible key (length 0, or a window
    that starts past S), each with its partials' scratch filled with NaN
    first: splits that see no key of a slot must write their empty partial,
    or the merge reads the NaN."""
    import torch
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import ref
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(tuple(c[:5]), dt, {"window": c[5]}, {}) for c in K3_SWEEP
             for dt in (f32, bf16)]
    cases += [((2, 96, 4, 2, 32), f32, {"window": w, "softcap_val": cap}, {})
              for w, cap in WINDOW_SOFTCAP]
    cases += [((4, 1024, 15, 5, 64), dt, {}, {"lengths": [0, 1, 500, 1024]})
              for dt in (f32, bf16)]                     # G 3, an empty slot
    cases += [((2, 300, 4, 4, 112), dt, {}, {}) for dt in (f32, bf16)]
    cases += [((2, 128, 4, 1, 256), dt, {}, {}) for dt in (f32, bf16)]
    cases += [((2, 200, 6, 2, 64), bf16, {"window": 40}, {"strided": True})]
    cases += [((3, 100, 4, 2, 32), dt, {"window": 16},
               {"lengths": [0, 57, 100]}) for dt in (f32, bf16)]
    cases += [((2, 200, 10, 2, 64), dt, {"window": 50},          # G 5
               {"lengths": [200, 130]}) for dt in (f32, bf16)]
    cases += [((2, 50, 4, 2, 8), dt, {}, {}) for dt in (f32, bf16)]  # D 8
    # given split counts: (shape, window, lengths); the last slot of the
    # windowed cases starts its window past S
    split_cases = [((4, 1024, 15, 5, 64), 0, [0, 1, 500, 1024]),
                   ((3, 1024, 15, 5, 64), 64, [0, 700, 1024 + 64 + 3]),
                   ((2, 4096, 4, 4, 112), 0, [1306, 3597]),
                   ((3, 512, 8, 1, 64), 100, [511, 250, 512 + 100 + 1])]
    worst = {f32: (0.0, 0.0), bf16: (0.0, 0.0)}
    runs = []
    for i, (shape, dt, kw, opt) in enumerate(cases):
        runs.append((shape, dt, kw, opt, None, 300 + i))
    for i, (shape, window, lengths) in enumerate(split_cases):
        for dt in (f32, bf16):
            for n in ("1", "2", "planned"):
                runs.append((shape, dt, {"window": window},
                             {"lengths": lengths}, n, 350 + i))
    plans = {}
    for shape, dt, kw, opt, n, seed in runs:
        args = k3_case(shape, dt, seed=seed, **opt)
        if n is None:
            out = k3.decode_attention(*args, **kw)
        else:
            planned = k3.plan(args[0], shape[3], shape[1])
            plans[shape] = planned
            splits = planned if n == "planned" else int(n)
            B, H, D = args[0].shape
            nan = torch.full((k3.scratch_size(B, H, D, splits),),
                             float("nan"), device="cuda")
            out = k3._launch(*args, kw["window"], 0.0, splits, scratch=nan)
        want = ref.decode_attention_ref(*args, **kw)
        pav = None if dt == f32 else _p_abs_v_k3(*args, **kw)
        torch.cuda.synchronize()
        e = _attn_close(out, want, f"k3 {shape} {dt} {kw} {opt} splits {n}",
                        p_abs_v=pav)
        worst[dt] = tuple(map(max, worst[dt], e))
    _refuse_host_kv()
    print(f"k3 check: {len(runs)} cases match the plain version "
          f"(decode_attention_ref), length-0 slots and windows past S "
          f"included; {len(cases)} at the wrapper's split count, "
          f"{len(runs) - len(cases)} at 1, 2 and the planned count "
          f"({', '.join(f'{s}: {n}' for s, n in plans.items())}) over "
          f"scratch filled with NaN; "
          f"max_abs_err f32 {worst[f32][0]:.3e} ({worst[f32][1]:.3f} of "
          f"{_limit_text(f32)}), bf16 {worst[bf16][0]:.3e} "
          f"({worst[bf16][1]:.3f} of {_limit_text(bf16)}); a CUDA query with host KV and a "
          f"misaligned cache are refused", flush=True)


def _refuse_host_kv():
    """A CUDA query with its KV in host memory, and a cache whose rows are
    not 16-byte aligned, are refused by both entry points before a
    launch."""
    import torch
    from repro_torch.kernels import ops
    q, k, v, n = k3_case((2, 64, 4, 2, 32), torch.float32, seed=1)
    q2, k2_, v2 = k2_case((1, 16, 16, 4, 2, 32), torch.float32, seed=1)
    wide = torch.zeros(2, 64, 2, 33, device="cuda")    # rows of 132 bytes
    bad = [lambda: ops.decode_attention(q, k.cpu(), v.cpu(), n),
           lambda: ops.flash_attention(q2, k2_.cpu(), v2.cpu()),
           lambda: ops.decode_attention(q, wide[..., 1:], v, n)]
    reset_counts()
    for call in bad:
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("an entry point took host KV or a misaligned "
                             "cache for a CUDA query")
    _assert_no_launch("refused calls")


def _assert_no_launch(what):
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ssd as k4
    if k3.decode_attention.launches or k2.flash_attention.launches or \
            pd.paged_decode_attention.launches or k4.ssd.launches:
        raise AssertionError(f"{what} launched a kernel")


def check_k2():
    """K2 against its plain version on the card over the reference's flash
    sweep in f32 and bf16, window/softcap cases, Sq < Skv (a 256-row chunk
    against 1024 keys, G 3), ragged Sq, D 112 and 256, bf16 at D 40 and 96
    (the SIMT kernel: no tensor-core instance there), strided q/k/v,
    non-causal cases, and rows with no visible key (causal, Sq > Skv); then
    each D the wgmma kernel takes through that masking sweep.  Returns the
    kernel each bf16 D ran on."""
    import torch
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ref
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(s, dt, {}, False) for s in K2_SWEEP for dt in (f32, bf16)]
    cases += [((2, 64, 64, 4, 2, 32), f32, {"window": w, "softcap_val": c},
               False) for w, c in WINDOW_SOFTCAP]
    cases += [((2, 64, 64, 4, 2, 32), bf16, {"window": 8, "softcap_val": 30.0},
               False)]
    cases += [((1, 256, 1024, 15, 5, 64), dt, {}, False) for dt in (f32, bf16)]
    cases += [((2, 300, 300, 4, 4, 112), dt, {}, False) for dt in (f32, bf16)]
    cases += [((1, 100, 130, 4, 2, 256), dt, {}, False) for dt in (f32, bf16)]
    cases += [((2, 77, 77, 4, 2, d), bf16, {}, False) for d in (40, 96)]
    cases += [((1, 48, 40, 2, 2, 32), dt, {}, False) for dt in (f32, bf16)]
    cases += [((2, 200, 70, 4, 2, 64), dt, {}, False) for dt in (f32, bf16)]
    cases += [((2, 90, 150, 6, 3, 64), f32, {"causal": False}, False),
              ((1, 120, 100, 4, 4, 32), f32, {"causal": False, "window": 20},
               False),
              ((2, 130, 130, 8, 2, 64), bf16, {"window": 50}, True)]
    for d in WGMMA_D:      # Skv never a multiple of the 128-key KV tile
        cases += [((2, 300, 300, 4, 2, d), bf16, {}, False),
                  ((1, 200, 330, 4, 4, d), bf16, {"causal": False}, False),
                  ((1, 260, 260, 4, 2, d), bf16,
                   {"window": 50, "softcap_val": 30.0}, False),
                  ((2, 300, 170, 4, 2, d), bf16, {}, False),   # no-key rows
                  ((1, 150, 700, 6, 2, d), bf16, {"window": 100}, False),
                  ((2, 257, 257, 8, 2, d), bf16, {"window": 40}, True)]
    worst = {f32: (0.0, 0.0), bf16: (0.0, 0.0)}
    ran = {}
    for i, (shape, dt, kw, strided) in enumerate(cases):
        q, k, v = k2_case(shape, dt, seed=400 + i, strided=strided)
        if dt == bf16:
            ran[shape[-1]] = k2.kernel_name(q)
        out = k2.flash_attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        pav = None if dt == f32 else _p_abs_v_k2(q, k, v, **kw)
        torch.cuda.synchronize()
        e = _attn_close(out, want, f"k2 {shape} {dt} {kw} strided={strided}",
                        p_abs_v=pav)
        worst[dt] = tuple(map(max, worst[dt], e))
    print(f"k2 check: {len(cases)} cases match the plain version "
          f"(attention_ref), rows with no visible key included; max_abs_err "
          f"f32 {worst[f32][0]:.3e} ({worst[f32][1]:.3f} of "
          f"{_limit_text(f32)}), bf16 {worst[bf16][0]:.3e} "
          f"({worst[bf16][1]:.3f} of {_limit_text(bf16)}); bf16 kernels by D: "
          + ", ".join(f"{d} {n}" for d, n in sorted(ran.items())),
          flush=True)
    if any(ran[d] != "wgmma" for d in WGMMA_D):
        raise AssertionError(f"the wgmma kernel did not take D {WGMMA_D}")
    return ran


def serving_kv(b, layer):
    """Engine ``b``'s KV of ``layer``: its pools as K1 takes them, and the
    same KV gathered densely through the page table, (B, max_seq, KVH, D)
    on the card (tier 0 from the hot pool, any other tier from the cold
    pool, each index clipped into its pool as K1 clips it)."""
    import torch
    cfg, page = b.cfg, b.page_tokens
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    b.pool.sync_cold()
    table, tier = b.pool.arrays()
    c = b.pool.tree[layer]
    pools = [c[n].view(c[n].shape[0], page, KV, hd)
             for n in ("k_hot", "v_hot", "k_cold", "v_cold")]
    idx = table.long()
    hot = (tier == 0)[:, :, None, None, None]

    def dense(pool_hot, pool_cold):
        cold = pool_cold.to("cuda")
        pg = torch.where(hot, pool_hot[idx.clamp(0, pool_hot.shape[0] - 1)],
                         cold[idx.clamp(0, cold.shape[0] - 1)])
        return pg.reshape(b.B, -1, KV, hd)

    return (dense(pools[0], pools[2]), dense(pools[1], pools[3]), pools,
            table, tier)


def k3_bound(q, k, lengths, window=0):
    """(seconds by bytes, seconds by operations) of one decode call on
    these lengths.  Bytes: q and out once, K and V of each slot's visible
    keys once (all S rows of V for a slot with none: its output is their
    mean), the lengths.  Operations: 4 H D per visible key (q.k and p.v
    for each of the G heads of each KV head), at the inputs' rate."""
    import torch
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    es = q.element_size()
    n = np.asarray(lengths.tolist())
    lo = np.maximum(0, n - window) if window else np.zeros_like(n)
    vis = np.maximum(0, np.minimum(n, S) - lo)
    rows = int(vis.sum()) * 2 + int((vis == 0).sum()) * S
    nbytes = 2 * B * H * D * es + rows * KVH * D * es + 4 * B
    rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return nbytes / HBM_BYTES_PER_S, 4.0 * H * D * int(vis.sum()) / rate


def visible_pairs(Sq, Skv, causal, window):
    """(query, key) pairs that see each other, queries right-aligned."""
    qpos = np.arange(Sq) + (Skv - Sq)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(Sq, int)
    hi = np.minimum(Skv, qpos + 1) if causal else np.full(Sq, Skv)
    return int(np.maximum(0, hi - lo).sum())


def k2_bound(q, k, *, causal=True, window=0):
    """(seconds by bytes, seconds by operations) of one flash-attention
    call.  Bytes: q, k, v and o once each.  Operations: 4 B H D per visible
    (query, key) pair.  For bf16 inputs at the tensor cores' bf16 rate:
    bf16 q.k products are exact in f32, and the oracle rounds p to bf16
    before P.V, so both products could run on the tensor cores and give the
    oracle's answer; f32 inputs at the f32 CUDA-core rate."""
    import torch
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    nbytes = (2 * B * Sq * H * D + 2 * B * Skv * KVH * D) * q.element_size()
    flops = 4.0 * B * H * D * visible_pairs(Sq, Skv, causal, window)
    rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return nbytes / HBM_BYTES_PER_S, flops / rate


def _sdpa_decode(q, k, v, lengths, window=0):
    """Yardstick only: one SDPA call computing K3's function (K1's, with
    ``window``), KV expanded to H heads and the length and window mask
    built before the timed call."""
    import torch
    import torch.nn.functional as F
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    kk = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vv = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    pos = torch.arange(S, device="cuda")[None, :]
    mask = pos < lengths[:, None]
    if window:
        mask &= pos >= lengths[:, None] - window
    mask = mask[:, None, None, :]
    qq = q[:, :, None, :].contiguous()
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)


def k3_time(q, k, v, lengths, what, card):
    """K3's time at this shape beside its bound, its plain version's and
    SDPA's, at the wrapper's split count against one split in turns
    (planned, 1, 1, planned).  Returns (ms, plain_ms, bound_ms, bound_by,
    sdpa_ms, planned splits, one-split ms)."""
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import ref
    by_bytes, by_ops = k3_bound(q, k, lengths)
    bound_ms = 1e3 * max(by_bytes, by_ops)
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    planned = k3.plan(q, KVH, S)
    turns = [(n, time_ms(lambda: k3._launch(q, k, v, lengths, 0, 0.0, n)))
             for n in (planned, 1, 1, planned)]
    ms = float(np.mean([t for n, t in turns if n == planned]))
    one_ms = float(np.mean([t for n, t in turns if n == 1]))
    plain_ms = time_ms(lambda: ref.decode_attention_ref(q, k, v, lengths),
                       reps=5)
    sdpa_ms = time_ms(_sdpa_decode(q, k, v, lengths))
    n = lengths.tolist()
    print(f"k3 time ({what}): {ms:.4f} ms (mean of the two turns at "
          f"{planned} splits) at B{B} S{S} H{H} KVH{KVH} D{D} {q.dtype}, "
          f"lengths {min(n)}-{max(n)}; bound {bound_ms:.4f} ms (bytes "
          f"{1e3 * by_bytes:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s, "
          f"operations {1e3 * by_ops:.4f} ms), {100 * bound_ms / ms:.1f}% of "
          f"it; plain {plain_ms:.4f} ms; sdpa {sdpa_ms:.4f} ms, "
          f"{sdpa_ms / ms:.2f} of its time [{card}]", flush=True)
    print(f"k3 splits ({what}, in turns): " + ", ".join(
        f"{n}: {t:.4f} ms" for n, t in turns) + f" (the wrapper takes "
        f"{planned} for {B} slots x {KVH} KV heads, S {S}, D {D}) [{card}]",
        flush=True)
    return ms, plain_ms, bound_ms, \
        "bytes" if by_bytes >= by_ops else "operations", sdpa_ms, planned, \
        one_ms


def k3_on_serving(b, card):
    """K3 through ops.decode_attention on the last layer's KV of the
    smollm-360m serving engine (its slots decoding), gathered densely from
    the pools, against K1 on the same pools and against the plain version;
    then its time at that shape."""
    import torch
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    cfg = b.cfg
    kd, vd, pools, table, tier = serving_kv(b, cfg.num_layers - 1)
    lengths = b.lengths.clone()
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(b.B, cfg.num_heads, cfg.head_dim, generator=g,
                    device="cuda").to(kd.dtype)
    reset_counts()
    out = ops.decode_attention(q, kd, vd, lengths)
    torch.cuda.synchronize()
    launches = k3.decode_attention.launches
    if launches != 1:
        raise AssertionError(f"ops.decode_attention made {launches} K3 "
                             f"launches")
    k1_out = pd.paged_decode_attention(q, *pools, table, tier, lengths)
    want = ref.decode_attention_ref(q, kd, vd, lengths)
    torch.cuda.synchronize()
    e1 = _attn_close(out, k1_out, "k3 vs k1 on the serving KV")
    err, share = _attn_close(out, want, "k3 vs plain on the serving KV",
                             p_abs_v=_p_abs_v_k3(q, kd, vd, lengths))
    n = lengths.tolist()
    print(f"k3 on the serving run's KV (last layer, {b.B} slots, lengths "
          f"{min(n)}-{max(n)}, {kd.dtype}): == K1 on the same pools, "
          f"max_abs_err {e1[0]:.3e} ({e1[1]:.3f} of "
          f"{_tol_text(kd.dtype)}); == plain, {err:.3e} ({share:.3f} of "
          f"{_limit_text(kd.dtype)}); {launches} launch", flush=True)
    timed = k3_time(q, kd, vd, lengths, "smollm-360m serving KV", card)
    return {"launches": launches, "err": err, "timed": timed}


def k2_on_zamba(main, card):
    """K2 through ops.flash_attention on the q, k, v of zamba2-7b's first
    SHARED_ATTN layer at full width, against the plain version and that
    layer's _gqa_core; K3 on the same activations against K2's last row;
    then K2's time at that shape, against the mma.sync kernel in turns.
    The plain versions' f32 scores (4.3 GB each) are freed before the next
    phase."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.models.attention import _gqa_core, attn_bias
    q, k, v = main["qkv"]
    B, S, H, D = q.shape
    KVH = k.shape[2]
    reset_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    last = ops.decode_attention(
        q[:, -1], k, v, torch.full((B,), S, dtype=torch.int32,
                                   device="cuda"))
    torch.cuda.synchronize()
    launches = k2.flash_attention.launches
    k3_launches = k3.decode_attention.launches
    if (launches, k3_launches) != (1, 1):
        raise AssertionError(f"{launches} K2 and {k3_launches} K3 launches "
                             f"for one call each")
    pav = _p_abs_v_k2(q, k, v)
    want = ref.attention_ref(q, k, v)
    err, share = _attn_close(out, want, "k2 vs plain on zamba2", p_abs_v=pav)
    del want
    pos = torch.arange(S, device="cuda")
    gqa = _gqa_core(q.reshape(B, S, KVH, H // KVH, D), k, v,
                    attn_bias(pos, pos)[None], main["softcap"])
    e_gqa = _attn_close(out, gqa.reshape(B, S, H, D),
                        "k2 vs _gqa_core on zamba2", p_abs_v=pav)
    del gqa, pav
    e_last = _attn_close(last, out[:, -1], "k3 vs k2's last row on zamba2")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"k2 on zamba2-7b's first SHARED_ATTN layer ({tuple(q.shape)} "
          f"{q.dtype}, causal): == plain, max_abs_err {err:.3e} "
          f"({share:.3f} of {_limit_text(q.dtype)}); == _gqa_core, "
          f"{e_gqa[0]:.3e} ({e_gqa[1]:.3f}); K3 on the last row == K2's, "
          f"{e_last[0]:.3e} ({e_last[1]:.3f} of {_tol_text(q.dtype)}); max "
          f"|o| {float(out.float().abs().max()):.3e}; {launches} K2 launch "
          f"on the {k2.kernel_name(q)} kernel", flush=True)
    del out, last
    by_bytes, by_ops = k2_bound(q, k)
    bound_ms = 1e3 * max(by_bytes, by_ops)
    turns = k2_turns(q, k, v)
    ms = float(np.mean([t for name, t in turns if name == "new"]))
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v), reps=5)
    torch.cuda.empty_cache()
    # yardstick only: Sq == Skv, so SDPA's top-left causal mask is the
    # right-aligned one
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = visible_pairs(S, S, True, 0)
    print(f"k2 time (zamba2-7b shared block): {ms:.4f} ms (mean of the "
          f"wgmma kernel's two turns) at B{B} S{S} H{H} "
          f"KVH{KVH} D{D} {q.dtype} causal; bound {bound_ms:.4f} ms "
          f"(operations {1e3 * by_ops:.4f} ms: {4.0 * B * H * D * pairs / 1e9:.1f}"
          f" GFLOP at {BF16_FLOP_PER_S / 1e12:g} TFLOP/s, the bf16 "
          f"tensor-core rate, since bf16 q.k is exact in f32 and the oracle "
          f"rounds p to bf16; bytes {1e3 * by_bytes:.4f} ms); plain "
          f"{plain_ms:.4f} ms; sdpa {sdpa_ms:.4f} ms [{card}]", flush=True)
    print_turns("zamba2-7b shared block", turns, D, sdpa_ms, bound_ms, card)
    k2_other_d(card)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": sdpa_ms}


def k2_turns(q, k, v):
    """The kernel flash_attention takes and the mma.sync kernel, timed in
    turns (new, old, old, new) on the same inputs, causal."""
    from repro_torch.kernels import flash_attention as k2
    fns = {"new": lambda: k2.flash_attention(q, k, v),
           "mma.sync": lambda: k2.mma_sync(q, k, v)}
    return [(name, time_ms(fns[name]))
            for name in ("new", "mma.sync", "mma.sync", "new")]


def print_turns(what, turns, D, sdpa_ms, bound_ms, card):
    new = np.mean([t for name, t in turns if name == "new"])
    old = np.mean([t for name, t in turns if name != "new"])
    print(f"k2 wgmma vs mma.sync ({what}, D {D}, in turns): " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in turns) + f"; wgmma "
        f"{old / new:.2f} times as fast, {sdpa_ms / new:.2f} of sdpa's "
        f"speed ({sdpa_ms:.4f} ms), {100 * bound_ms / new:.1f}% of its bound "
        f"{bound_ms:.4f} ms [{card}]", flush=True)


def k2_other_d(card):
    """The other head_dims the wgmma kernel takes, at B 2 x S 4096 x H 32,
    causal, random bf16 from a seed: against the mma.sync kernel in turns,
    its bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ref
    for d in WGMMA_D:
        if d == 112:                        # zamba2's, timed above
            continue
        q, k, v = k2_case((2, 4096, 4096, 32, 32, d), torch.bfloat16,
                          seed=600 + d)
        # the check at this shape is against K1's limit plus the p rounding
        # on the first 256 query rows (the plain version's scores for all
        # 4096 would be 4.3 GB)
        sub = q[:, :256]
        out = k2.flash_attention(sub, k[:, :256], v[:, :256])
        _attn_close(out, ref.attention_ref(sub, k[:, :256], v[:, :256]),
                    f"k2 D {d}", p_abs_v=_p_abs_v_k2(sub, k[:, :256],
                                                     v[:, :256]))
        by_bytes, by_ops = k2_bound(q, k)
        turns = k2_turns(q, k, v)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        print_turns("B2 S4096 H32 random", turns, d, sdpa_ms,
                    1e3 * max(by_bytes, by_ops), card)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def k3_long_cache(card):
    """K3 through ops.decode_attention at zamba2-7b's shared-block decode
    shape (B 8 x S 4096, H = KVH = 32, D 112, bf16, lengths 1024-4096),
    against the plain version; then its time there."""
    import torch
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    B, S = K3_LONG[:2]
    lengths = [int(n) for n in np.random.default_rng(2).integers(
        1024, S + 1, B)]
    q, k, v, n = k3_case(K3_LONG, torch.bfloat16, seed=500, lengths=lengths)
    if k3.plan(q, K3_LONG[3], S) <= 1:
        raise AssertionError("k3: one split at the long cache")
    reset_counts()
    out = ops.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    launches = k3.decode_attention.launches
    if launches != 1:
        raise AssertionError(f"ops.decode_attention made {launches} K3 "
                             f"launches")
    err, share = _attn_close(out, ref.decode_attention_ref(q, k, v, n),
                             "k3 vs plain at the long cache",
                             p_abs_v=_p_abs_v_k3(q, k, v, n))
    print(f"k3 at zamba2-7b's decode shape {K3_LONG}: == plain, max_abs_err "
          f"{err:.3e} ({share:.3f} of {_limit_text(q.dtype)}); {launches} "
          f"launch", flush=True)
    timed = k3_time(q, k, v, n, "zamba2-7b long cache", card)
    return launches, timed


def k3_record(serving, long_run):
    """The kernels line's K3 entry: the serving KV's numbers, with the long
    cache's beside them."""
    long_launches, long_timed = long_run
    ms, plain_ms, bound_ms, bound_by, sdpa_ms, splits, one_ms = \
        serving["timed"]
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:85",
            "launches": serving["launches"] + long_launches,
            "max_abs_err": serving["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa_ms, "splits": splits, "one_split_ms": one_ms,
            "long_cache": dict(zip(
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "splits", "one_split_ms"), long_timed))}


# ------------------------------------------------------------- training ----

SMOLLM_TRAIN = (8, 1024)             # B x S of phase 5c
ZAMBA_TRAIN = (1, 4096)              # B x S of phase 5d
# phase 5d's periods of zamba2-7b's 16 (with its prologue, 11 layers), for
# the script's clock: on 8 (41 layers) it took 82.3-94.0 s of runs of
# 1047.1-1188.8 s, on 4 (21 layers) 40.3 s of a 928.3 s run (H100 80GB
# HBM3 hosts at 700 W)
ZAMBA_TRAIN_PERIODS = 2
TRAIN_STEPS = 6                      # steps a mode in phase 5c
MODES = ("full", "remat", "save_hbm", "offload")
# phase 5b: float32 on the card (no TF32) against the CPU, as phase 4's
# reduced check holds the logits
SMALL_LOSS_TOL = dict(atol=1e-4, rtol=0.0)
SMALL_GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
# phase 5c: each mode's loss and gradient norm (before clipping) against
# the full mode's, step by step.  The modes run the same kernels on the
# same inputs (a block's recompute repeats its forward), and the card reads
# them equal to the bit; the limits leave room for a reordered reduction
# only.  A planted fault, one block's carry zeroed before its recompute,
# must move the gradient norm past its limit, or the gate could not see a
# wrong gradient.
MODE_LOSS_RTOL = 2.0 ** -16
MODE_GNORM_RTOL = 2.0 ** -10


def k4_grad_inputs(shape, dtype, seed, *, with_h0=False, model_layout=False):
    """Leaf tensors for the SSD scan under autograd (drawn as k4_case draws
    them; ``model_layout``: one (B, S, H*P + 2N) leaf that x, B and C are
    slices of, as in MambaBlock) and a function of the leaves giving the
    scan's inputs."""
    import torch
    import torch.nn.functional as F
    B, S, H, P, N, chunk = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device="cuda")

    if model_layout:
        leaves = {"xBC": (randn(B, S, H * P + 2 * N) * 0.5).to(dtype)}
    else:
        leaves = {k: (randn(*sh) * 0.5).to(dtype) for k, sh in (
            ("x", (B, S, H, P)), ("Bm", (B, S, N)), ("Cm", (B, S, N)))}
    leaves["dt"] = F.softplus(randn(B, S, H)).to(dtype)
    leaves["A"] = -torch.exp(randn(H) * 0.3)
    if with_h0:
        leaves["h0"] = randn(B, H, P, N) * 0.5

    def inputs(lv):
        if model_layout:
            xbc = lv["xBC"]
            x = xbc[..., :H * P].reshape(B, S, H, P)
            Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        else:
            x, Bm, Cm = lv["x"], lv["Bm"], lv["Cm"]
        return (x, lv["dt"], lv["A"], Bm, Cm), dict(chunk=chunk,
                                                   h0=lv.get("h0"))
    up = (randn(B, S, H, P), randn(B, H, P, N))    # dL/dy, dL/dh
    return leaves, inputs, up


def _grad_close(got, want, what):
    """A gradient against the plain version's, scaled by the larger of 1
    and the plain gradient's largest magnitude, within K4's limits for its
    dtype (gradients sum over the sequence, so their scale grows with S)."""
    scale = max(1.0, float(want.float().abs().max()))
    return scale * _k4_close(got / scale, want / scale, what)


def check_ssd_autograd(card):
    """Phase 5a: ops.ssd under autograd on the card (K4's forward, the plain
    version's backward) against ssd_chunked_ref's forward and backward on
    the same leaves and upstream gradients, over the reference's SSD sweep
    in f32 and bf16, a start state h0, and zamba2-7b's layer (S 4096, H
    112, P = N = 64, bf16, the model's layout): y, h and the gradient of
    every leaf held to K4's limits.  K4's launches must equal the forward
    calls.  Then, at zamba2's layer, K4's forward time beside the plain
    backward's (the gradient through the autograd function: the plain scan
    recomputed and differentiated).  Returns those times."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as k4
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(s, dt, {}) for s in K4_SWEEP for dt in (f32, bf16)]
    cases += [((2, 64, 4, 16, 16, 16), dt, {"with_h0": True})
              for dt in (f32, bf16)]
    cases += [(K4_FULL, bf16, {"model_layout": True})]
    reset_counts()
    forwards, worst = 0, {}
    for i, (shape, dtype, opt) in enumerate(cases):
        leaves, inputs, (wy, wh) = k4_grad_inputs(shape, dtype, 300 + i,
                                                  **opt)
        out = {}
        for name, fn in (("kernel", ops.ssd), ("plain", ref.ssd_chunked_ref)):
            lv = {k: v.detach().clone().requires_grad_() for k, v in
                  leaves.items()}
            args, kw = inputs(lv)
            y, h = fn(*args, **kw)
            loss = (y.float() * wy).sum() + (h * wh).sum()
            grads = torch.autograd.grad(loss, list(lv.values()))
            out[name] = (y.detach(), h.detach(), dict(zip(lv, grads)))
            forwards += name == "kernel"
        torch.cuda.synchronize()
        what = f"autograd {shape} {dtype} {opt}"
        errs = [_k4_close(out["kernel"][0], out["plain"][0], what + " y"),
                _k4_close(out["kernel"][1], out["plain"][1], what + " h")]
        errs += [_grad_close(out["kernel"][2][k], out["plain"][2][k],
                             f"{what} d{k}") for k in leaves]
        key = "full" if shape == K4_FULL else str(dtype).split(".")[-1]
        worst[key] = max(worst.get(key, 0.0), max(errs))
    launches = k4.ssd.launches
    if launches != forwards:
        raise AssertionError(f"ssd autograd: {launches} K4 launches for "
                             f"{forwards} forward calls")
    print(f"ssd autograd check: {len(cases)} cases (sweep f32 and bf16, h0, "
          f"zamba2's layer bf16): y, h and every leaf's gradient == the "
          f"plain version's forward and backward within K4's limits "
          f"(gradients scaled by max(1, their largest magnitude)); max_abs_"
          f"err " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) +
          f"; {launches} K4 launches = {forwards} forward calls, none in the "
          f"backward", flush=True)

    leaves, inputs, (wy, _) = k4_grad_inputs(K4_FULL, bf16, 399,
                                             model_layout=True)
    lv = {k: v.requires_grad_() for k, v in leaves.items()}
    args, kw = inputs(lv)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: ops.ssd(*args, **kw), reps=10)
    y, _ = ops.ssd(*args, **kw)
    gy = wy.to(y.dtype)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        y, list(lv.values()), gy, retain_graph=True), reps=5)
    plain_ms = time_ms(lambda: ref.ssd_chunked_ref(*args, **kw), reps=5)
    print(f"ssd autograd time at zamba2's layer (B1 S4096 H112 P64 N64 "
          f"bf16): K4 forward {fwd_ms:.4f} ms; plain backward (the scan "
          f"recomputed and differentiated) {bwd_ms:.3f} ms, "
          f"{bwd_ms / fwd_ms:.1f} times the forward; plain forward "
          f"{plain_ms:.3f} ms [{card}]", flush=True)
    return {"train_fwd_ms": fwd_ms, "train_plain_bwd_ms": bwd_ms}


def _blocked_mambas(cfg, scfg):
    """K4 launches of one train step: every Mamba layer once in the
    forward, and the period layers' once more in their block's recompute
    (the prologue runs outside the blocks, as in the reference)."""
    from repro_torch.configs.base import MAMBA
    n = _n_mamba(cfg)
    recompute = n - sum(k == MAMBA for k in cfg.prologue)
    return n + (recompute if scfg.uses_blocks else 0)


def check_train_small():
    """Phase 5b: smollm-360m and zamba2-7b reduced, fp32, parameters from
    seed 0 on the CPU and the same values on the card: the loss and every
    gradient on the card (K4 forward, plain backward) == on the CPU (plain
    version), in all four modes at MI 1 and 2; the offload counter on the
    card == estimate_offload_traffic, and K4's launches == Mamba layers
    forward + recomputed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import offload
    from repro_torch.core.profiler import TraceProfile
    from repro_torch.kernels import ssd as k4
    from repro_torch.models.model import init_params, loss_fn
    worst = 0.0
    runs = 0
    for arch in ("smollm-360m", "zamba2-7b"):
        cfg = get_config(arch).reduced()
        cpu = init_params(cfg, seed=0, device="cpu", requires_grad=True)
        gpu = copy.deepcopy(cpu).to("cuda")
        toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 17))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:])}
        prof = TraceProfile(num_periods=cfg.num_periods, num_steps=0)
        for mode in MODES:
            for mi in (1, 2):
                scfg = offload.SentinelConfig(mode=mode, mi_periods=mi)
                got = {}
                for dev, p in (("cuda", gpu), ("cpu", cpu)):
                    reset_counts()
                    offload.reset_traffic()
                    loss = loss_fn(p, cfg, {k: v.to(dev) for k, v in
                                            batch.items()},
                                   **offload.loss_kwargs(scfg))
                    grads = torch.autograd.grad(loss, list(p.parameters()))
                    got[dev] = (loss.detach().cpu(), [g.cpu() for g in grads],
                                dict(offload.traffic), k4.ssd.launches)
                what = f"{arch} reduced {mode} mi {mi}"
                torch.testing.assert_close(
                    got["cuda"][0], got["cpu"][0], **SMALL_LOSS_TOL,
                    msg=lambda m: f"{what} loss: {m}")
                for a, b in zip(got["cuda"][1], got["cpu"][1]):
                    torch.testing.assert_close(
                        a, b, **SMALL_GRAD_TOL,
                        msg=lambda m: f"{what} grad: {m}")
                    worst = max(worst, float((a - b).abs().max()))
                carry = 2 * 16 * cfg.d_model * 4
                want = offload.estimate_offload_traffic(
                    prof, mi, carry)["bytes_offloaded"] \
                    if mode == "offload" else 0
                blocks = offload.estimate_offload_traffic(
                    prof, mi, carry)["blocks"] if mode == "offload" else 0
                tr = got["cuda"][2]
                if tr["d2h"] + tr["h2d"] != want or \
                        tr["out"] != tr["in"] or tr["in"] != blocks:
                    raise AssertionError(f"{what}: offloaded {tr}, estimate "
                                         f"{want} B in {blocks} carries")
                if got["cuda"][3] != _blocked_mambas(cfg, scfg):
                    raise AssertionError(f"{what}: {got['cuda'][3]} K4 "
                                         f"launches")
                runs += 1
    print(f"small training check: {runs} runs (smollm-360m and zamba2-7b "
          f"reduced, fp32, 4 modes x MI 1 and 2): loss and every gradient "
          f"on the card == on the CPU (loss atol "
          f"{SMALL_LOSS_TOL['atol']:g}; gradients atol "
          f"{SMALL_GRAD_TOL['atol']:g} + rtol {SMALL_GRAD_TOL['rtol']:g}), "
          f"max_abs_err {worst:.3e}; offload bytes == "
          f"estimate_offload_traffic, K4 launches == Mamba layers forward "
          f"+ recomputed", flush=True)


def check_adamw_streamed():
    """Phase 5b, the optimizer: adamw.update with its moments in pinned
    host memory (streamed through the card leaf by leaf on the side
    stream) against the same eager ops with the moments on the card
    (``adamw.eager_update``: ``update`` takes the fused pass there without
    the compressor, phase 5e), three steps of the same gradients, with and
    without the int8 compressor: the same arithmetic on the same device,
    so parameters and state must be identical, bit for bit."""
    import torch
    from repro_torch.optim import adamw
    g = torch.Generator(device="cuda").manual_seed(11)
    shapes = {"w_in": (960, 2560), "ln": (960,), "table": (4096, 960),
              "w_out": (2560, 960)}
    for compress in (False, True):
        cfg = adamw.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                              compress_grads=compress)
        p0 = {k: torch.randn(sh, generator=g, device="cuda").to(
            torch.bfloat16) for k, sh in shapes.items()}
        grads = [{k: torch.randn(sh, generator=g, device="cuda").to(
            torch.bfloat16) * 4 for k, sh in shapes.items()}
            for _ in range(3)]
        out = {}
        for on_host in (False, True):
            params = {k: v.clone() for k, v in p0.items()}
            state = adamw.init(params, cfg, offload=on_host)
            if on_host != state["m"]["ln"].is_pinned():
                raise AssertionError("adamw: moments not placed as asked")
            for gr in grads:
                (adamw.update if on_host else adamw.eager_update)(
                    gr, state, params, cfg)
            out[on_host] = (params, state)
        for key in ("m", "v") + (("ef",) if compress else ()):
            for k in shapes:
                if not torch.equal(out[True][1][key][k].cuda(),
                                   out[False][1][key][k]):
                    raise AssertionError(f"adamw streamed {key}[{k}] differs")
        for k in shapes:
            if not torch.equal(out[True][0][k], out[False][0][k]):
                raise AssertionError(f"adamw streamed params[{k}] differ")
    print("adamw check: 3 steps with the moments streamed from pinned host "
          "memory == with the moments on the card, bit for bit (params, "
          "m, v, and ef with the int8 compressor)", flush=True)


# Phase 5e: the fused AdamW pass.  Its plain version's small leaves: every
# pair of float32 and bfloat16 parameter and gradient, sizes off the vector
# width, one element, a leaf of two chunks and one exactly a chunk; the
# last leaf starts off 16 bytes (the element-by-element path).
ADAMW_SMALL = [((1,), "bf16", "bf16"), ((3,), "f32", "f32"),
               ((37,), "bf16", "f32"), ((130,), "f32", "bf16"),
               ((6, 5), "bf16", "bf16"), ((70_001,), "bf16", "bf16"),
               ((65_536,), "f32", "f32"), ((1_001,), "bf16", "bf16")]
ADAMW_STEPS = 3
# the bench cells' optimizer (bench/traffic/train.*.json); clip 1e3 leaves
# the clip unengaged, and the pass then owes the eager ops every bit
ADAMW_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100_000, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1)
# With the clip engaged the fused norm sums in another order than the eager
# one, so the clip's scale may differ in its last places: the norms within
# ADAMW_NORM_REL of each other, and the moments within ADAMW_MOMENT_REL of
# a moment's largest |value|.  lr equal bit for bit, and each side's
# parameters equal bit for bit to the step its own moments give
# (``_replayed``).
ADAMW_NORM_REL = 1e-6
ADAMW_MOMENT_REL = 1e-5
ADAMW_LAUNCHES = 4           # the most device ops a fused step may issue


def _adamw_copy(x):
    """A copy of ``x`` on its device as far past a 16-byte boundary as
    ``x`` is."""
    import torch
    off = (x.data_ptr() % 16) // x.element_size()
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    return buf[off:].view(x.shape).copy_(x)


def _adamw_leaves(shapes, dtypes, seed, unaligned=False):
    """Parameters (float32 or bf16, about 0.02 an element) on the card, the
    last one element past a 16-byte boundary if ``unaligned``, and
    ADAMW_STEPS steps of gradients of about 1e-4 an element."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = {}
    for i, (sh, (pd, _)) in enumerate(zip(shapes, dtypes)):
        x = (torch.randn(sh, generator=g, device="cuda") * 0.02).to(dt[pd])
        if unaligned and i == len(shapes) - 1:
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
            x = buf[1:].view(sh).copy_(x)
        params[f"leaf{i}"] = x
    grads = [{k: (torch.randn(v.shape, generator=g, device="cuda") *
                  1e-4).to(dt[gd]) for (k, v), (_, gd) in
              zip(params.items(), dtypes)} for _ in range(ADAMW_STEPS)]
    return params, grads


def _equal_leaves(a, b) -> int:
    """How many leaves of two (params, state) pairs are equal bit for bit,
    the parameter and both moments."""
    (pa, sa), (pb, sb) = a, b
    return sum(all(bool((x == y).all()) for x, y in
                   ((pa[k], pb[k]), (sa["m"][k], sb["m"][k]),
                    (sa["v"][k], sb["v"][k]))) for k in pa)


def _bf16_step(x):
    """One bf16 step (the distance to the next bf16 value up) at each of
    ``x``'s nonzero |values| (float32); 0 where x is 0."""
    import torch
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def _replayed(p0, m, v, count, lr, cfg):
    """The parameter one AdamW step from ``p0`` gives with ``m`` and ``v``,
    the moments after that step, at the step count ``count`` and ``lr``:
    ``eager_update``'s float32 operations, rounded to p0's dtype."""
    import torch
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + \
        cfg.weight_decay * p0.float()
    return (p0.float() - lr * upd).to(p0.dtype)


def _step_gaps(a, b, before, cfg) -> dict:
    """The gaps between two results (params, state, metrics) of one step
    from the same state, whose parameters were ``before``: ``m`` and ``v``,
    the largest gap relative to a moment's largest |value|; ``replayed``,
    the leaves whose parameter equals, bit for bit on both sides, the step
    its side's own moments, count and lr give (``_replayed``); ``apart``,
    the most bf16 steps (of the larger |value|) between the two sides'
    parameters, and ``param_share``, the share of the parameters' elements
    that differ; ``equal``, the leaves equal bit for bit."""
    import torch
    (pa, sa, ma), (pb, sb, mb) = a, b
    out = {"m": 0.0, "v": 0.0, "replayed": 0, "apart": 0.0,
           "param_share": 0.0, "equal": _equal_leaves(a[:2], b[:2])}
    n = 0
    for k in pa:
        for key in ("m", "v"):
            u, w = sa[key][k], sb[key][k]
            out[key] = max(out[key], float((u - w).abs().max()) /
                           max(float(w.abs().max()), 1e-30))
        out["replayed"] += all(
            bool((_replayed(before[k], st["m"][k], st["v"][k], st["count"],
                            met["lr"], cfg) == p[k]).all())
            for p, st, met in ((pa, sa, ma), (pb, sb, mb)))
        x, y = pa[k].float(), pb[k].float()
        step = _bf16_step(torch.maximum(x.abs(), y.abs()))
        out["apart"] = max(out["apart"], float(torch.where(
            x == y, torch.zeros_like(x), (x - y).abs() / step).max()))
        out["param_share"] += float((x != y).sum())
        n += x.numel()
    out["param_share"] /= n
    return out


def check_adamw_fused(card):
    """Phase 5e, the fused AdamW pass (``kernels/adamw.py``, the kernels of
    ``csrc/adamw.cu``).  (a) ADAMW_STEPS steps of the kernels against
    their plain version (``kernels/ref.adamw_fused_ref``, run on the card:
    the same chunks, every sum in the same order) on ADAMW_SMALL's leaves:
    every leaf, the norm and lr equal bit for bit.  (b) smollm-360m's
    leaves at full width (bf16 parameters and gradients, float32 moments on
    the card): ADAMW_STEPS steps of ``eager_update``, and before each, one
    step of ``update`` (the fused pass) from a copy of the same state.
    With the clip not engaged (clip 1e3) every leaf equal bit for bit;
    with it engaged (clip 1) the norms within ADAMW_NORM_REL and the
    moments within ADAMW_MOMENT_REL; at both, lr equal and every
    parameter, on both sides, the step its side's moments give, bit for
    bit.
    (c) The device ops of one step under the profiler (at most
    ADAMW_LAUNCHES fused) and the wrapper's launches, counted from
    ``reset_counts``.  (d) The fused step's device time (CUDA events after
    a spin that covers the host's table packing) against its bound, 22 B a
    parameter at HBM's rate; the host's ms a step of both paths.  Returns
    the kernel table's record."""
    import dataclasses as dc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as fused
    from repro_torch.kernels import ref
    from repro_torch.models import model
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    cfg = adamw.OptConfig(**ADAMW_OPT, clip_norm=1e-3)
    shapes = [sh for sh, _, _ in ADAMW_SMALL]
    dtypes = [(pd, gd) for _, pd, gd in ADAMW_SMALL]
    params, grads = _adamw_leaves(shapes, dtypes, 21, unaligned=True)
    sides = {}
    for side in ("kernel", "plain"):
        p = {k: _adamw_copy(v) for k, v in params.items()}
        st = adamw.init(p, cfg)
        names, norms = list(p), []
        for gr in grads:
            args = ([p[k] for k in names], [gr[k] for k in names],
                    [st["m"][k] for k in names], [st["v"][k] for k in names],
                    st["count"], cfg)
            if side == "kernel":
                st["count"], n, lr = fused.fused_update(*args)
            else:
                st["count"], n, lr = ref.adamw_fused_ref(*args)
            norms.append((n.item(), lr.item()))
        sides[side] = (p, st, norms)
    last = f"leaf{len(shapes) - 1}"
    if sides["kernel"][0][last].data_ptr() % 16 == 0:
        raise AssertionError("adamw 5e-a: the unaligned leaf is aligned")
    equal = _equal_leaves(sides["kernel"][:2], sides["plain"][:2])
    kn, pn = sides["kernel"][2], sides["plain"][2]
    if equal != len(shapes) or kn != pn:
        raise AssertionError(f"adamw 5e-a: {equal} of {len(shapes)} leaves "
                             f"equal bit for bit; (norm, lr) each step "
                             f"kernel {kn}, plain {pn}")
    print(f"adamw check 5e-a: {ADAMW_STEPS} steps of the fused kernels "
          f"against their plain version on {len(shapes)} leaves (f32/bf16 "
          f"pairs, 1 to 70,001 elements, one off 16 bytes): every leaf "
          f"equal bit for bit, and (norm, lr) each step {kn}", flush=True)
    del sides, params, grads

    full = dc.replace(get_config("smollm-360m"), dtype="bfloat16")
    like = model.Model(full, device="meta", dtype=torch.bfloat16)
    shapes = [tuple(p.shape) for _, p in like.named_parameters()]
    del like
    n_params = sum(int(np.prod(sh)) for sh in shapes)
    params, grads = _adamw_leaves(shapes, [("bf16", "bf16")] * len(shapes),
                                  22)
    record = {"leaves": len(shapes), "parameters": n_params}
    for clip in (1.0, 1e3):
        c = adamw.OptConfig(**ADAMW_OPT, clip_norm=clip)
        p = {k: _adamw_copy(v) for k, v in params.items()}
        st = adamw.init(p, c)
        if not adamw.fused_path(grads[0], st, p, c):
            raise AssertionError("adamw 5e-b: update would not fuse")
        worst, metrics = {}, []
        for s, gr in enumerate(grads):
            before = {k: v.clone() for k, v in p.items()}
            pf = {k: _adamw_copy(v) for k, v in p.items()}
            sf = {"count": st["count"].clone(),
                  **{key: {k: _adamw_copy(v) for k, v in st[key].items()}
                     for key in ("m", "v")}}
            _, sf, mf = adamw.update(gr, sf, pf, c)
            _, st, me = adamw.eager_update(gr, st, p, c)
            gaps = _step_gaps((pf, sf, mf), (p, st, me), before, c)
            got = [(float(m["grad_norm"]), float(m["lr"])) for m in (mf, me)]
            metrics.append(got)
            what = f"adamw 5e-b clip {clip:g} step {s}: gaps {gaps}, " \
                   f"(grad_norm, lr) fused {got[0]}, eager {got[1]}"
            if got[0][1] != got[1][1] or \
                    abs(got[0][0] - got[1][0]) > ADAMW_NORM_REL * got[1][0]:
                raise AssertionError(f"{what}: lr not equal or norms apart")
            if max(got[0][0], got[1][0]) <= clip and \
                    gaps["equal"] != len(shapes):
                raise AssertionError(f"{what}: the clip is not engaged, "
                                     f"and not every leaf is equal")
            if not (gaps["replayed"] == len(shapes)
                    and gaps["m"] <= ADAMW_MOMENT_REL
                    and gaps["v"] <= ADAMW_MOMENT_REL):
                raise AssertionError(f"{what}: past the limits")
            worst = {k: min(worst.get(k, v), v) if k in ("equal", "replayed")
                     else max(worst.get(k, v), v) for k, v in gaps.items()}
            del pf, sf, before
        record[f"gaps_clip_{clip:g}"] = worst
        print(f"adamw check 5e-b: smollm-360m's {len(shapes)} leaves "
              f"({n_params:,} parameters, bf16, moments f32 on the card), "
              f"clip {clip:g}, {ADAMW_STEPS} steps, fused against eager from "
              f"the same state each step: largest gaps m {worst['m']:.3g}, v "
              f"{worst['v']:.3g} (limit {ADAMW_MOMENT_REL:g}); every step, "
              f"{worst['replayed']} of {len(shapes)} leaves' parameters the "
              f"step their own moments give, bit for bit, on both sides; "
              f"parameters at most {worst['apart']:.3g} bf16 steps apart, "
              f"{100 * worst['param_share']:.4f}% of them differing; at "
              f"least {worst['equal']} of {len(shapes)} leaves equal bit for "
              f"bit; (grad_norm, lr) fused, eager each step {metrics}",
              flush=True)
        del p, st
    torch.cuda.empty_cache()

    c = adamw.OptConfig(**ADAMW_OPT, clip_norm=1.0)
    st = adamw.init(params, c)
    adamw.update(grads[0], st, params, c)
    ops = {}
    for side, fn in (("fused", adamw.update), ("eager", adamw.eager_update)):
        torch.cuda.synchronize()
        reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(grads[1], st, params, c)
            torch.cuda.synchronize()
        ops[side] = (sum(e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA),
                     _launch_counts()["adamw"])
    if not 0 < ops["fused"][0] <= ADAMW_LAUNCHES or ops["fused"][1] != 2 \
            or ops["eager"][1]:
        raise AssertionError(f"adamw 5e-c: one step's device ops and the "
                             f"wrapper's launches: {ops}")
    print(f"adamw check 5e-c: one step's device ops (kernels and copies) "
          f"under the profiler: fused {ops['fused'][0]} (the wrapper's "
          f"launches {ops['fused'][1]}, plus the table's copy), eager "
          f"{ops['eager'][0]} (the wrapper's launches {ops['eager'][1]})",
          flush=True)

    def host_ms(fn, reps):
        ts = []
        for i in range(reps):
            torch.cuda.synchronize()
            a = time.perf_counter()
            fn(grads[i % ADAMW_STEPS], st, params, c)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - a))
        return float(np.median(ts))

    ms = time_ms(lambda: adamw.update(grads[2], st, params, c), reps=20,
                 spin_cycles=20 * SPIN_CYCLES)
    bound = n_params * fused.bytes_per_param(2, 2) / HBM_BYTES_PER_S * 1e3
    fused_host, eager_host = host_ms(adamw.update, 10), \
        host_ms(adamw.eager_update, 5)
    record.update(ms=ms, bound_ms=bound, plain_ms=eager_host,
                  fused_host_ms=fused_host, device_ops=ops["fused"][0],
                  eager_device_ops=ops["eager"][0],
                  launches_a_step=ops["fused"][1], card=card)
    print(f"adamw time: the fused step {ms:.4f} ms on the card against its "
          f"bound {bound:.4f} ms ({n_params * 22 / 1e9:.3f} GB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {100 * bound / ms:.1f}% of "
          f"it); a step on the host clock, synchronised: fused "
          f"{fused_host:.3f} ms, eager {eager_host:.3f} ms; {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    if ms > 2 * bound:
        raise AssertionError(f"adamw: {ms:.4f} ms is past twice its bound "
                             f"{bound:.4f} ms")
    del params, grads, st
    torch.cuda.empty_cache()
    return record


def plan_step(cfg, B, S, card, **kw):
    """Profile one step of ``cfg`` on the meta device, plan it on H100_COST
    at 0.3 of the profile's peak (the CLI's default) and turn the plan
    into a SentinelConfig.  Returns (profile, plan, config)."""
    from repro_torch import runtime
    from repro_torch.core.offload import from_plan
    from repro_torch.launch.train import profile_step
    t0 = time.perf_counter()
    prof = profile_step(cfg, B, S)
    t1 = time.perf_counter()
    plan = runtime.plan(prof, runtime.H100_COST, 0.3 * prof.peak_bytes())
    scfg = from_plan(prof, plan, **kw)
    print(f"{cfg.name} plan: profiled {len(prof.objects)} data objects of "
          f"one B {B} x S {S} step on the meta device in {t1 - t0:.1f} s "
          f"(peak {prof.peak_bytes() / 1e9:.3f} GB, RS "
          f"{prof.rs_bytes(1) / 1e9:.3f} GB, matmul "
          f"{prof.matmul_flops / 1e12:.3f} TFLOP); runtime.plan on H100_COST "
          f"at 0.3 of the peak in {time.perf_counter() - t1:.1f} s: MI "
          f"{plan.mi} steps -> {scfg.mi_periods} periods of "
          f"{cfg.num_periods}", flush=True)
    return prof, plan, scfg


def train_smollm(card):
    """Phase 5c: smollm-360m at full width and depth, bf16, B 8 x S 1024
    from make_batch.  The training CLI once (2 steps: profile, plan,
    loop.run); then the planned config in each of the four modes for
    TRAIN_STEPS steps from the same state: the losses and gradient norms
    step by step, the step time (median of the last 4), tokens/s, peak
    device memory (and its rise above the memory held when the mode
    starts), a profile of one more step (device-busy share, the top
    device ops), and for offload the bytes that went to pinned host
    memory and back in each step.  Then one offload step from the same
    state with one block's carry zeroed before its recompute, and one with
    it off by one bf16 rounding (planted faults).  Fails unless every
    mode's losses and gradient norms are full's within MODE_LOSS_RTOL and
    MODE_GNORM_RTOL, the zeroed carry's gradient norm is not, offload's bytes equal estimate_offload_traffic's
    to the byte in every step, offload's peak is below full's, and its
    rise is below save_hbm's (the same blocks with the carries on the
    card) by all but the two carries its backward holds at a time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import offload
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import loop
    t0 = time.perf_counter()
    cfg = get_config("smollm-360m")
    B, S = SMOLLM_TRAIN
    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train.main(["--arch", cfg.name, "--steps", "2", "--batch",
                          str(B), "--seq", str(S), "--ckpt-dir", ckpt_dir])
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"training CLI: losses {out['losses']}")
    del out
    torch.cuda.empty_cache()
    prof, plan, planned = plan_step(cfg, B, S, card)
    ocfg = OptConfig(total_steps=TRAIN_STEPS, warmup_steps=1)
    dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=S,
                      global_batch=B)
    batches = [make_batch(dcfg, s) for s in range(TRAIN_STEPS)]
    state = loop.init_state(cfg, ocfg, seed=0)
    init = [p.detach().clone() for p in state["params"].parameters()]
    carry = B * S * cfg.d_model * 2
    est = offload.estimate_offload_traffic(prof, planned.mi_periods, carry)

    def restart():
        with torch.no_grad():
            for p, p0 in zip(state["params"].parameters(), init):
                p.copy_(p0)
            for k in ("m", "v"):
                for t in state["opt"][k].values():
                    t.zero_()
            state["opt"]["count"].zero_()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    res = {}
    for mode in MODES:
        held = restart()
        scfg = dataclasses.replace(planned, mode=mode)
        step = loop.make_train_step(cfg, scfg, ocfg)
        losses, gnorms, times, moved = [], [], [], []
        for s in range(TRAIN_STEPS):
            offload.reset_traffic()
            ts = time.perf_counter()
            state, m = step(state, batches[s])
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - ts)
            moved.append(dict(offload.traffic))
        peak = torch.cuda.max_memory_allocated()
        res[mode] = dict(losses=losses, gnorms=gnorms, peak=peak,
                         rise=peak - held, moved=moved,
                         ms=1e3 * float(np.median(times[2:])))
        print(f"smollm-360m train {mode} (MI {scfg.mi_periods}): losses "
              f"{', '.join(f'{x:.5f}' for x in losses)}; gradient norms "
              f"{', '.join(f'{x:.6g}' for x in gnorms)}; step "
              f"{res[mode]['ms']:.1f} ms (median of the last "
              f"{TRAIN_STEPS - 2}: "
              f"{', '.join(f'{1e3 * t:.1f}' for t in times)}), "
              f"{B * S / (res[mode]['ms'] * 1e-3):.0f} tokens/s; peak device "
              f"memory {peak / 1e9:.2f} GB ({peak - held} B above the "
              f"{held} B held at the start)" +
              (f"; {moved[0]['d2h']} B to pinned host and {moved[0]['h2d']} "
               f"B back a step" if mode == "offload" else "") + f" [{card}]",
              flush=True)
        wall_us, rows = device_profile(lambda: step(state, batches[0]), 1)
        print_profile(f"smollm-360m train {mode}", wall_us, rows, 1, card,
                      top=8)

    # planted faults: the middle block recomputes from a zeroed carry (the
    # gate must see it), or from its carry off by one bf16 rounding, 2**-7
    # of it (the smallest wrong carry: its reading is printed)
    fault_block = est["blocks"] // 2
    ref_loss, ref_gn = res["full"]["losses"][0], res["full"]["gnorms"][0]
    get = offload.CarryStore.get
    faults = {}
    for name, wrong in (("zeroed", torch.zeros_like),
                        ("off by 2**-7", lambda x: x * (1 + 2.0 ** -7))):
        def planted(store, b, wrong=wrong):
            x = get(store, b)
            return wrong(x) if b == fault_block else x

        restart()
        offload.CarryStore.get = planted
        try:
            _, m = loop.make_train_step(cfg, planned, ocfg)(state,
                                                            batches[0])
            fault = (float(m["loss"]), float(m["grad_norm"]))
        finally:
            offload.CarryStore.get = get
        faults[name] = abs(fault[1] - ref_gn) / ref_gn
        print(f"smollm-360m train, planted fault (offload, block "
              f"{fault_block} of {est['blocks']} recomputed from its carry "
              f"{name}, step 0): loss {fault[0]:.5f} against full's "
              f"{ref_loss:.5f} (|diff| {abs(fault[0] - ref_loss):.3e}); "
              f"gradient norm {fault[1]:.6g} against {ref_gn:.6g}, "
              f"{faults[name]:.3e} of it, "
              f"{faults[name] / MODE_GNORM_RTOL:.1f} times the limit "
              f"{MODE_GNORM_RTOL:g} [{card}]", flush=True)
    if not faults["zeroed"] > MODE_GNORM_RTOL:
        raise AssertionError(f"smollm-360m train: a zeroed carry moves the "
                             f"gradient norm by {faults['zeroed']:.3e}, "
                             f"inside the limit {MODE_GNORM_RTOL:g}")

    loss_gap = gn_gap = 0.0
    for mode in MODES[1:]:
        for s in range(TRAIN_STEPS):
            a, b = res[mode]["losses"][s], res["full"]["losses"][s]
            g, h = res[mode]["gnorms"][s], res["full"]["gnorms"][s]
            if not (np.isfinite(a) and abs(a - b) <= MODE_LOSS_RTOL * abs(b)
                    and np.isfinite(g) and abs(g - h) <= MODE_GNORM_RTOL * h):
                raise AssertionError(f"smollm-360m train: {mode} at step "
                                     f"{s}: loss {a}, gradient norm {g}; "
                                     f"full's {b}, {h}")
            loss_gap = max(loss_gap, abs(a - b) / abs(b))
            gn_gap = max(gn_gap, abs(g - h) / h)
    for s, mv in enumerate(res["offload"]["moved"]):
        if mv["d2h"] + mv["h2d"] != est["bytes_offloaded"] or \
                mv["d2h"] != mv["h2d"] or \
                mv["out"] != mv["in"] or mv["in"] != est["blocks"]:
            raise AssertionError(f"smollm-360m offload step {s}: {mv}, "
                                 f"estimate {est}")
    if not res["offload"]["peak"] < res["full"]["peak"]:
        raise AssertionError("smollm-360m: offload's peak is not below "
                             "full's")
    kept = res["save_hbm"]["rise"] - res["offload"]["rise"]
    if kept < (est["blocks"] - 2) * carry:
        raise AssertionError(f"smollm-360m: offload's peak rise is "
                             f"{kept} B below save_hbm's, less than "
                             f"{est['blocks'] - 2} carries of {carry} B")
    print(f"smollm-360m train: the four modes agree step by step with full "
          f"(loss: max {loss_gap:.3e} of it, limit {MODE_LOSS_RTOL:g}; "
          f"gradient norm: max {gn_gap:.3e} of it, limit "
          f"{MODE_GNORM_RTOL:g}); offload moved {est['bytes_offloaded']} B "
          f"a step = estimate_offload_traffic ({est['blocks']} blocks x 2 x "
          f"{carry} B carries), and its peak rise is {kept} B "
          f"({kept / carry:.2f} carries) below save_hbm's; offload step / "
          f"full step {res['offload']['ms'] / res['full']['ms']:.3f} at "
          f"{res['offload']['peak'] / res['full']['peak']:.3f} of full's "
          f"peak memory (save_hbm "
          f"{res['save_hbm']['ms'] / res['full']['ms']:.3f}, remat "
          f"{res['remat']['ms'] / res['full']['ms']:.3f}: one code path on "
          f"the port, so their gap reads the step time's noise); phase 5c "
          f"took {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    del state, init, batches
    torch.cuda.empty_cache()
    res["mi"] = planned.mi_periods
    return res


def train_zamba(card):
    """Phase 5d: zamba2-7b at full width on its Mamba prologue layer and
    ZAMBA_TRAIN_PERIODS of its 16 periods (11 layers, for the script's
    clock), bf16, B 1 x S 4096, mode offload
    at the planned MI with the AdamW moments in pinned host memory, 2
    steps on one repeated batch.  Fails unless the loss is finite and
    falls, and K4 ran once a Mamba layer in each forward and once a
    period's Mamba layer in each recompute.  Prints the step time, peak device memory, the pinned
    host bytes (the carries a step, the moments), adamw.update's time and
    a profile of a third step.  Returns the K4 launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import offload
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import ssd as k4
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    t0 = time.perf_counter()
    cfg = get_config("zamba2-7b")
    cfg = dataclasses.replace(cfg, num_layers=len(cfg.prologue)
                              + ZAMBA_TRAIN_PERIODS * cfg.period_len)
    B, S = ZAMBA_TRAIN
    prof, _, scfg = plan_step(cfg, B, S, card, offload_opt_state=True)
    ocfg = adamw.OptConfig(total_steps=2, warmup_steps=1)
    torch.cuda.empty_cache()
    release_pinned()
    ti = time.perf_counter()
    state = loop.init_state(cfg, ocfg, seed=0, offload_opt_state=True)
    moments = [t for k in ("m", "v") for t in state["opt"][k].values()]
    if not all(t.is_pinned() for t in moments):
        raise AssertionError("zamba2-7b: AdamW moments are not pinned")
    moment_bytes = sum(t.numel() * t.element_size() for t in moments)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"zamba2-7b train state: {n_params / 1e9:.3f} B parameters on the "
          f"card ({torch.cuda.memory_allocated() / 1e9:.1f} GB), "
          f"{moment_bytes / 1e9:.1f} GB of f32 moments in pinned host "
          f"memory, built in {time.perf_counter() - ti:.1f} s", flush=True)
    batch = make_batch(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                  seq_len=S, global_batch=B), 0)
    step = loop.make_train_step(cfg, scfg, ocfg)
    update, upd_ms = adamw.update, []

    def timed_update(*args, **kw):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = update(*args, **kw)
        torch.cuda.synchronize()
        upd_ms.append(1e3 * (time.perf_counter() - ts))
        return out

    adamw.update = timed_update
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times, moved = [], [], []
    try:
        for _ in range(2):
            offload.reset_traffic()
            ts = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - ts))
            moved.append(dict(offload.traffic))
    finally:
        adamw.update = update
    launches = k4.ssd.launches
    peak = torch.cuda.max_memory_allocated()
    wall_us, rows = device_profile(lambda: step(state, batch), 1)
    print_profile("zamba2-7b train (a third step)", wall_us, rows, 1, card,
                  top=12)
    want = 2 * _blocked_mambas(cfg, scfg)
    if launches != want:
        raise AssertionError(f"zamba2-7b train: {launches} K4 launches, "
                             f"want {want}")
    if not (all(np.isfinite(losses)) and losses[1] < losses[0]):
        raise AssertionError(f"zamba2-7b train: losses {losses}")
    carry = B * S * cfg.d_model * 2
    est = offload.estimate_offload_traffic(prof, scfg.mi_periods, carry)
    if any(mv["d2h"] + mv["h2d"] != est["bytes_offloaded"] or
           mv["in"] != est["blocks"] for mv in moved):
        raise AssertionError(f"zamba2-7b offload: {moved}, estimate {est}")
    print(f"zamba2-7b train (offload, MI {scfg.mi_periods} of "
          f"{cfg.num_periods} periods, {cfg.num_layers} layers, moments on "
          f"the host): "
          f"losses {losses[0]:.5f} -> {losses[1]:.5f} on a repeated batch "
          f"(finite, falling); step {', '.join(f'{t:.1f}' for t in times)} "
          f"ms, {B * S / (times[-1] * 1e-3):.0f} tokens/s; adamw.update "
          f"{', '.join(f'{t:.1f}' for t in upd_ms)} ms of it; peak device "
          f"memory {peak / 1e9:.2f} GB; pinned host: {moved[-1]['d2h']} B of "
          f"carries a step ({est['blocks']} blocks, out and back = "
          f"estimate_offload_traffic) and {moment_bytes} B of moments; "
          f"{launches} K4 launches = 2 steps x ({_n_mamba(cfg)} forward + "
          f"{want // 2 - _n_mamba(cfg)} recomputed: the prologue's Mamba "
          f"layer runs outside the blocks); phase 5d took "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    del state, moments, batch
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    for name, (secs, log) in build.build_all(KERNELS).items():
        print(f"build {name}: {secs:.2f} s; {ptxas_summary(log)}",
              flush=True)

    (full, err), k1_zamba, k1_gemma3 = check_kernels()
    k4_full = check_k4()
    check_k4_ragged()
    t0 = time.perf_counter()
    check_k3()
    check_k2()
    print(f"k3 and k2 checks took {time.perf_counter() - t0:.1f} s",
          flush=True)
    (out, cnt, launches, cold_steps, wall, step_s), served = check_serving()
    decode_tokens = sum(len(o) - 1 for o in out)
    print(f"serve time: {decode_tokens / wall:.1f} decode tokens/s over the "
          f"whole tiered run ({wall:.3f} s, prefill included); mean pure "
          f"decode step {1e3 * float(np.mean(step_s)):.3f} ms over "
          f"{len(step_s)} steps of {SLOTS} slots [{card}]", flush=True)
    core_launches = check_layouts(*served, out, card)
    check_f1()
    k1 = k1_record(full, err, launches, k1_zamba, k1_gemma3, card)
    del k1_gemma3
    engine = profile_decode(*served, card)
    k3_serving = k3_on_serving(engine, card)
    del engine
    measure_machine(served[1], card)
    plan_a, trace = check_planned_serving(served[0], served[1], served[3],
                                          card)
    disagg_k1 = check_disagg(served[0], served[1], served[3], plan_a, trace,
                             card)
    del served
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_zamba_small()
    check_zamba_serving_small()
    main_k4 = run_zamba_full(card)
    k4 = k4_record(main_k4, k4_full, card)
    k2 = k2_on_zamba(main_k4, card)
    zamba_serve = serve_zamba(main_k4.pop("params"), main_k4["cfg"], card)
    del main_k4
    torch.cuda.empty_cache()
    # every path's launches, each counted from 0 just before it ran
    k1["launches_by_path"] = {
        "smollm-360m serving, pools (phase 3)": launches,
        "_paged_decode_core, one decode step (phase 3c)": core_launches,
        "zamba2-7b serving, pools (phase 4b)": zamba_serve["k1"],
        "smollm-360m disaggregated, one shard (phase 3d-1)": disagg_k1[0],
        "smollm-360m disaggregated, two aliased shards (phase 3d-2)":
            disagg_k1[1]}
    k4["launches_by_path"] = {
        "zamba2-7b forwards (phase 4)": k4["launches"],
        "zamba2-7b serving prefill (phase 4b)": zamba_serve["k4"]}
    k3 = k3_record(k3_serving, k3_long_cache(card))
    print(f"zamba2 phases took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    k4.update(check_ssd_autograd(card))
    check_train_small()
    check_adamw_streamed()
    a1 = check_adamw_fused(card)
    reset_counts()
    smollm_mi = train_smollm(card)["mi"]
    a1["launches_by_path"] = {
        "smollm-360m training, the CLI and four modes (phase 5c)":
            _launch_counts()["adamw"]}
    k4["launches_by_path"]["zamba2-7b training, offload (phase 5d)"] = \
        train_zamba(card)
    a1["launches_by_path"]["zamba2-7b training, offload (phase 5d)"] = \
        _launch_counts()["adamw"]
    print(f"training phases took {time.perf_counter() - t0:.1f} s",
          flush=True)
    release_pinned()
    torch.cuda.empty_cache()
    k1["launches_by_path"].update(check_families(card))
    # phase 7's and phase 8's paths run none of K1-K4: each path's count,
    # read after every run of it; their training steps run A1 where the
    # moments live on the card
    paths = check_recurrent(card)
    paths.update(check_modality(card))
    # phase 9's paths (MoE training) run none of K1-K4 either; phase 10's
    # run K1 alone
    paths.update(check_moe_train(card))
    for what, n in check_disagg_families(card).items():
        paths[what] = _counts(paged_decode=n)
    # phase 11's TP admissions run no kernel; decode runs K1 on each shard
    for what, n in check_tp(card).items():
        paths[what] = _counts(paged_decode=n)
    # phase 12's partitioned training runs none of K1-K4
    paths.update(check_tp_train(card, mi=smollm_mi))
    # phase 13's runs K4 on each rank's SSM heads, and K1 on zamba2's
    # shared-block decode
    paths.update(check_tp_families(card))
    # phase 14's (the recurrences and the modality stubs partitioned) run
    # none of K1-K4
    paths.update(check_tp_recurrent(card))
    # phase 15's run K4 on zamba2-7b's Megatron-SP training alone
    paths.update(check_long_sp(card))
    for what, tally in paths.items():
        for rec, name in ((k1, "paged_decode"), (k2, "flash_attention"),
                          (k3, "decode_attention"), (k4, "ssd"),
                          (a1, "adamw")):
            rec.setdefault("launches_by_path", {})[what] = tally[name]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4, a1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

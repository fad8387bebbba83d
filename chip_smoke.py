#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--reps N] [--verbose-build]

Phases, each printing its lines:

1. build    builds the CUDA kernels K1 (bsr_spmv), K2 (bsr_spmm) and K3
            (bsr_sdd) from src/repro_torch/kernels/csrc and prints the build
            time;
2. kernels  holds K1 and K2 against their plain PyTorch versions on random
            sorted tile tables (empty row tiles, n not a multiple of the
            column block, odd tiles, float32 and bfloat16), on tables
            made of runs of 1-9 row tiles sharing a column tile, as the
            MoE's dsd makes them (runs across a 64-row panel, two runs into
            one row tile, padding tiles past the last row tile, tm = 5, 8,
            16, 32, and in bfloat16 40 and 100, where a CTA takes 64 rows
            of one tile), and on the skewed tables of testing.SKEWED that
            stress K1's and K2's even split of the tile table over the
            card's workers (a row tile with 90% of the tiles, fewer tiles
            than workers, one tile, long runs of empty row tiles), where
            a second launch in float32 must give the same bits;
3. main     drives the port's first path, stage_spmv and stage_spmm
            (n = 128) through the 'cuda' backend, on the paper's
            10 000 x 10 000 matrices <50,50,500,u> and <100,100,500,nu>
            with 20% in-block zeros, in float32 and bfloat16. The launch
            counts are zeroed just before and read just after; each kernel
            must have launched. The outputs are held against the 'grouped'
            backend and a dense product, both in float32 with TF32 off, on
            the inputs the kernels saw;
4. times    medians of CUDA-event timings of each kernel, its plain version
            and torch.sparse_bsr_tensor(...) @ x (in the row's dtype, its
            error against the plain version printed beside it; "n/a" with
            the error where this install refuses it) on the main path's
            tables (with the schedules the staged path built), each timed
            call after a 134 MB write and read that flush the L2 (outside
            the events), each kernel's bound, and each staged fn(val, x),
            prepacked and not; in float32 the last timed launch must give
            the first one's bits; at u, each kernel's device time by
            launch under torch.profiler, and beforehand the launch floor
            (an empty kernel timed the same way);
5. sdd      holds K3 against its plain version on odd shapes (bm = 8 and
            others, bn not a multiple of 128, K not a multiple of 32,
            padding slots with out-of-range columns, b as a strided expert
            stack), on random slots and on runs of 1-9 slots of one column
            block (runs across a CTA's group of slots), float32 and
            bfloat16 (bm = 40 and 100 too). In float32 (3xTF32 on the
            tensor cores) also at bm = 1, 5, 8, 16, 24, 40, 100 (bn 200,
            K 44) and at the MoE's bm 8, bn 1536, K 5120, each float32
            table through both bodies: cp.async copies, and scalar copies
            on the same values in a copy of a that starts 4 bytes past a
            16-byte boundary, as ops.sdd_body picks them (the body
            printed); a second launch must give the same bits;
6. moe      drives the port's second path: DeepSeek-V2-236B's MoE layer at
            its published widths (d_model 5120, 160 routed experts of
            d_ff 1536, top-6, 2 shared experts, swiglu), dropless, through
            moe_apply at prefill (B=4, S=512) and decode (B=64, S=1), in
            two passes: params in bfloat16 (7.6 GB), then, the bfloat16
            layer freed, in float32 (15.3 GB, the JAX config's
            param_dtype), each from --seed. The launch counts are zeroed
            just before each pass and read just after; K3 and K2 must have
            launched. The output is held against the capacity path (plain
            einsums, TF32 off) with capacity_factor = E / top_k, which drops
            nothing, in the pass's dtype, and K3 on the path's own prefill
            tables against its plain version on 64 sampled slots;
7. moe times  after each pass of phase 6, in its dtype: the MoE layer's time
            (prefill, decode) and its device time by kernel; at the prefill
            and decode tables as the path builds them, K3 (its body
            printed; a second launch must give the first one's bits; at
            prefill also on the same slots ordered by expert, one run per
            expert) and K2 at the dsd tables (tm=8, tk=1536, n=5120, m_pad
            = M), each beside its bound, its plain version (K3 on 64
            sampled slots, K2 on the tiles of 16 whole 64-row panels, each
            against the timed launch's own output) and the library call in
            the kernel's dtype: torch.sparse.sampled_addmm (K3) and
            torch.sparse_csr_tensor(...) @ x (K2, cuSPARSE; float32 beside
            bfloat16), each over the element-level CSR;
8. tuning  drives the rest of the staged path on u and nu in float32, in a
            plan cache of its own (a temporary directory): cold tunes
            (stage_spmv/stage_spmm with backend='autotune', the default
            candidates, every cuda[tm x tk] tile of autotune.CUDA_TILES
            among them; the launch counts zeroed just before and read just
            after, K1 and K2 must have launched), each candidate's time and
            the winner printed, the winner held against a float64 numpy
            product and timed beside phase 4's (32, 32) call; a warm restart
            (in-memory caches cleared, a new PlanCache on the same files)
            that must make 0 benchmarks and stage the same options; the
            extended space at nu (reblocking proposals, include_reblock);
            dia_hybrid on a banded 10 000 x 10 000 matrix under splits of 4
            (benchmarks/bench_reblock.py's band, bandwidth 24); the gather
            backend and stage_block_op (a row-sum op) at nu, each checked
            and timed; then K1 and K2 at every tile of the sweep other than
            (32, 32), at u and nu, as in phase 4;
9. serve   drives the port's serving path: llama3-8b-sable (llama3-8b at its
            published widths, each FFN matrix 896 tiles of 128 x 128) through
            ServeEngine.generate, params and compute in bfloat16 from --seed,
            8 prompts of 512 tokens and 64 greedy new tokens, in plan caches
            of its own. First K2 at the FFN shapes (`in` and `out`, prefill
            T = 4096 and decode T = 8, both dtypes) against its plain
            version, timed beside its bound, the plain version,
            torch.sparse_bsr_tensor(...) @ X and the per-call tile gather and
            transpose; a 2-layer model at the same widths in float32, whose
            prefill logits through cuda must match those through grouped
            within 1e-4 of max|logits|. Then the 32-layer model: a cold
            warmup (each pattern's candidate times and winner printed) and a
            warm restart that must stage 0 plans; serve (a) with the
            warmup's pick and (b) with both patterns pinned to cuda by plans
            in the cache, where K2 must launch 96 times a forward (3 FFN
            matmuls x 32 layers; the counts zeroed just before each serve
            and read just after); for each, prefill ms, decode ms a step,
            tokens/s, peak memory and a torch.profiler breakdown of the
            prefill and one decode step by layer (attention, FFN, K2, the
            tile gather and transpose, the head); and how many of the greedy
            tokens (a) and (b) share (reported, not gated);
10. continuous  drives the port's request-level serving path: the paged KV
            cache, the continuous-batching scheduler and ServeEngine.serve,
            with both FFN patterns pinned to cuda (K2) in plan caches of its
            own. First a 2-layer llama3-8b-sable at full width in float32:
            six requests with a shared 32-token prefix through schedulers
            whose page count forces an eviction, prefix sharing and chunked
            prefill both on, then both off: each request's greedy tokens
            must equal generate's on it alone and each step's logits the
            single-sequence path's within 1e-4 of max|logits|. Then the paged
            cache of the full-width model on the card: write_prefill, gather,
            read_dense, evict and resume must give back the same bits, the
            zero page zero. Then the 32-layer bfloat16 model (from --seed):
            16 requests of 128-512 prompt tokens and 16-64 greedy new tokens
            (lengths from --seed), one arriving each step, on 8 lanes,
            page_size 16, max_len 576, and the largest page count from 200
            down whose schedule evicts (the schedule depends on lengths
            alone, so a toy model on the CPU finds it, and the card's run
            must repeat that schedule exactly). Every request must finish,
            with at least one eviction and resume, and K2 must launch at
            least 96 times a forward (decode steps and prefills; the counts
            zeroed just before and read just after); a second scheduler on
            the same plan store must stage 0 plans. Printed: wall s,
            requests/s, decode tokens/s, steps, the median pure decode step
            (host clock, synchronized) and its gather and scatter (CUDA
            events), peak memory, a torch.profiler breakdown of one decode
            step of 8 lanes (attention, FFN, K2, the tile transpose, the
            gather, the scatter, the head, the rest), how many greedy tokens
            of four requests equal generate's on each alone (bfloat16 paths
            differ; not gated), the gather alone at those 8 lanes (CUDA
            events) beside its bytes bound, and phase 9's generate
            tokens/s beside;
11. moe serve  drives the port's serving path on the MoE models, dropless
            (K3 for the first matmuls, K2 for the second): (a) K3 and K2 at
            llama4-scout's tables (16 experts of d_ff 8192, top-1, d_model
            5120: bn = tk = 8192) at prefill (B=4, S=512) and decode (B=8),
            both dtypes, each against its plain version (on sampled slots
            and panels) and timed after an L2 flush beside its bound, the
            plain version and the library call (sampled_addmm for K3,
            sparse_csr_tensor(...) @ x for K2), float32 launched twice for
            the same bits; (b) DeepSeek-V2-236B (layer 0 dense, one MoE
            layer) and llama4-scout (one layer) at full width in float32
            (TF32 off): the dropless prefill logits against the capacity
            path's with capacity_factor = E / top_k, and 4 greedy decode
            steps (the absorbed MLA for DeepSeek-V2) against a prefill over
            the longer sequence, within 1e-4 of max|logits|, the same
            tokens; (c) DeepSeek-V2 at its published widths cut to 1 dense
            and 4 MoE layers (34.55 GB of bfloat16 params from --seed)
            through ServeEngine.generate, 4 prompts of 512 tokens and 32
            greedy new tokens: K3 must launch 2 and K2 1 times a MoE layer
            a forward (the counts zeroed just before and read just after);
            prefill ms, decode ms a step, tokens/s, peak memory, a
            torch.profiler breakdown of the prefill and one decode step (MLA
            attention, router and dispatch, the expert FFN's glue, K3, K2,
            combine, shared experts, dense FFN, head, the device's busy
            share), and K3 and K2 at the first MoE layer's own tables at
            prefill and at decode; (d) the same model through
            ServeEngine.serve: 8 requests of 128-512 prompt tokens and 16-32
            greedy new tokens (lengths from --seed), one arriving a step, on
            4 lanes, page_size 16, and the largest page count whose schedule
            evicts (found on the CPU, repeated on the card exactly): every
            request finishes, at least one eviction and resume, K3 and K2
            launch 2 and 1 times a MoE layer a forward or prefill; wall s,
            requests/s, decode tokens/s, the median decode step, and how
            many greedy tokens of two requests equal generate's on each
            alone (not gated); (e) llama4-scout at full width cut to 2
            layers (12.9 GB of bfloat16 params) through generate, 4 prompts
            of 256 tokens, 8 new tokens, K3 and K2 launching as in (c).
12. mamba serve  drives the port's serving path on the Mamba-2 models: (a)
            K3 and K2 at jamba-1.5-large's tables (16 experts of d_ff
            24576, top-2, d_model 8192: bn = tk = 24576, K = 8192, the
            stacked experts 3.2 G values, past 2^31) at prefill (B=4,
            S=512) and decode (B=4), both dtypes, as in 11a (sampled slots
            and one whole panel for the plain versions); (b) in float32
            (TF32 off) mamba2-1.3b whole (48 layers) and jamba's layers 0-1
            (Mamba + dense FFN, Mamba + MoE): a 512-token prefill (4 SSD
            chunks), then 8 greedy recurrent decode steps, each step's
            logits against a chunked prefill over the longer sequence
            within 1e-4 of max|logits| and the same tokens; jamba's dropless
            prefill against its capacity path at capacity_factor 16; (c)
            mamba2-1.3b whole in bfloat16 (2.69 GB, from --seed) through
            ServeEngine.generate (8 prompts of 512 tokens, 64 greedy new
            tokens) and ServeEngine.serve (16 requests of 128-512 prompt
            and 16-64 new tokens, one a step, 8 lanes, page_size 16, the
            largest page count whose schedule evicts, found on the CPU and
            repeated on the card; every cache leaf per-sequence state,
            checked bit for bit at each resume): prefill ms, decode ms a
            step, tokens/s, requests/s, peak memory, torch.profiler
            breakdowns of the prefill, one decode step and one serve step
            of 8 lanes (in and out projections, conv, SSD, gated norm,
            head, the state gather and scatter), the state gather alone
            beside its bytes bound; the serve CLI on the card; (d) jamba at
            its published widths cut to a super-block's layers 0, 1 and 7
            (Mamba + dense FFN, Mamba + MoE, attention + MoE; 44 GB of
            bfloat16 params), dropless, through generate (4 prompts of 512
            tokens, 32 new) and serve (8 requests on 4 lanes, paged KV and
            state leaves in one cache, an eviction and resume), K3 and K2
            launching exactly 2 and 1 times a MoE layer a forward or
            prefill, the same metrics and a breakdown by layer kind
            (Mamba, attention, router and dispatch, K3, K2, dense FFN,
            head); the reduced jamba through the serve CLI.
13. train   drives the port's training path: (a) DeepSeek-V2's MoE layer at
            full width, dropless, forward and backward (bfloat16 B=4,
            float32 B=2, S=512; TF32 off): K3 2 and K2 1 launches in the
            forward, and in the backward, each launch put to its table by
            its block, K3 d/dS 1, K2 d/da 2 and K2 d/dW 3; every
            gradient (x, router, w1, w2, w3, shared experts) against the
            capacity path's (einsums, nothing dropped) and, at B=1 S=64,
            against the family's plain versions (grouped), within 3e-2
            (bfloat16) and 1e-4 (float32) of max|ref|; the backward's tables
            after an L2 flush beside bound, plain version and library call:
            K3 d/dS = sdd(g, w2^T) (w2^T made row-major), K2 d/da = dsd(G, w1^T) (w1^T made
            row-major) and K2 d/dW = dsd(G^T, a) at tm 1536, tk 8; float32
            repeats its bits; (b) llama3-8b-sable at its published widths
            cut to 8 layers (1.74 G params, float32 params and AdamW state,
            bfloat16 compute, remat "dots") trained 6 steps through
            make_train_step and TrainLoop on SyntheticDataset 8 x 512 with
            the FFN pinned to cuda: losses (falling), make_eval_step's CE
            on a held-out batch before and after (it must fall by
            EVAL_MARGIN), one adamw_update on four full-width leaves
            against a plain float32 AdamW, ms a step, tokens/s,
            peak memory, K2 launches, a checkpoint saved and restored into a
            fresh loop bit for bit, one step by phase (forward, backward,
            optimizer) and under torch.profiler (busy share, top kernels),
            K2's time in the forward; (c) a 2-layer float32 cut: one step's
            gradients with the FFN on cuda and on fixed_block (the family's
            backward on K2 and K3) against grouped, within 1e-4; (d) the
            training CLI in a subprocess, then --resume.
14. encdec  drives the port's encoder-decoder path, seamless-m4t-large-v2
            (24 encoder + 24 decoder layers, d_model 1024, 16 heads, d_ff
            8192 gelu, vocab 256 206, tied), on which no kernel lies (its
            attention and FFNs are plain matmuls, in the reference too):
            (a) the whole model in bfloat16 (2.74 GB, from --seed) through
            ServeEngine.generate, B=8, src_embeds of 512 frames, 32-token
            prompts, 64 greedy new tokens: encode ms, prefill ms, decode ms
            a step beside its bytes bound, tokens/s, peak memory, and
            torch.profiler breakdowns of encode, the prefill and one decode
            step (self-attention, cross-attention, FFN, head, busy share);
            (b) float32 (TF32 off) cut to 2 encoder + 2 decoder layers:
            generate's greedy tokens equal a manual loop of prefill and
            decode_step whose cross K/V is recomputed from encode's output
            before every step, the last prefill logits match forward_train's
            within 1e-5 of max|logits|, each step's within 1e-4; (c)
            ServeEngine.serve with 8 requests, each with its own src_embeds,
            through the explicit fallback: one warning, paged False, each
            request's tokens equal generate on it alone; (d) the whole model
            trained 6 steps (float32 params and AdamW, 16.44 GB; bfloat16
            compute, remat "dots", bfloat16 gradients, AdamW's default lr)
            on SyntheticDataset (8 x 512 target tokens over the first 4096
            ids of the vocabulary, 128 frames): ms a step,
            tokens/s, peak memory, make_eval_step's CE on a held-out batch
            that must fall by SM_EVAL_MARGIN, a checkpoint round trip bit
            for bit (save and restore s), one step by phase and under
            torch.profiler, and the same step with remat "none"; (e) the
            training CLI on the reduced config in a subprocess, then
            --resume.
15. sharded  drives the port's sharded staged path (core/sharded.py) on
            phase 3's u and nu at n = 128, float32 and bfloat16, through
            the 'cuda' backend, in a plan cache of its own: (a) the host
            loop, stage_spmv/stage_spmm(shards=8), lpt and contiguous: the
            launch counts zeroed just before and read just after (K1 and K2
            once a non-empty shard a call), y against the unsharded call and
            a dense product at the dtype's tolerance, the imbalance, each
            shard's tiles and tile shape, the Stage-0 seconds, the call's
            time beside the unsharded call's and, for lpt, K1 and K2 on each
            shard's own tables (time, plain version, library call, bound,
            as phase 4) summed over the shards; (b) backend="autotune" on nu
            at shards=4: four -s?of4 plans, a warm restart that writes no
            plan and runs no benchmark; (c) the mesh path in a one-rank NCCL
            group (file:// store under build/), make_staging_mesh(1) and
            make_staging_mesh((1, 1)), overlap_gather on and off, against
            (a)'s host loop, the group torn down after; (d)
            warm_matmul_plans(mesh=make_staging_mesh(1)) over
            llama3-8b-sable's FFN patterns: every shard key inherits the
            measured base without a benchmark, and a restart benchmarks
            nothing. A one-rank group exchanges nothing: the exchange
            between ranks is checked on the CPU (tests/test_torch_sharded.py).
16. model   drives model sharding (distributed/{sharding,ctx}.py, the
            sharded train step, DTensor checkpoints, the CLI's --devices)
            in a one-rank NCCL group (file:// store under build/), torn
            down after: (a) llama3-8b-sable at its published widths cut to
            8 layers (float32 params and AdamW, bfloat16 compute, remat
            "dots", FFN pinned to cuda), 3 steps unsharded and 3 steps of
            make_train_step(mesh=make_local_mesh(("pod", "data",
            "model"), (1, 1, 1))) with DTensor params from make_shardings,
            from the same seed and batches: once under deterministic
            algorithms (the backward's index_add_ and embedding gradient
            sum with atomics otherwise), losses and grad_norm within 1e-6
            relative (bit for bit is reported), and once as the step runs
            (ms a step and peak memory both ways); K2's launches the same
            both ways; (b) DeepSeek-V2 at full width, its dense layer 0 and
            one MoE layer in bfloat16, forward_train under
            activation_sharding on a (1, 1) ("data", "model") mesh against
            the unsharded forward, dropless and on the capacity path: the
            logits within bfloat16's tolerance, K3/K2 launches equal; (c)
            (a)'s sharded state saved from DTensors, restored unsharded and
            with shardings=, bit for bit; (d) the training CLI with
            --devices 1, then --resume. A one-rank group exchanges nothing:
            the exchange between ranks is checked on the CPU
            (tests/test_torch_model_sharding.py).
17. serve sharded  drives sharded serving and the dry-run: its
            dry-run subprocesses start first, then in a one-rank NCCL
            group (file:// store under build/), torn down after: (a)
            prefill and decode under activation_sharding on
            make_local_mesh(("pod", "data", "model"), (1, 1, 1)) with
            params and caches as DTensors (make_shardings of param_specs /
            cache_specs, on the params' own storage), against the same
            calls unsharded, both under deterministic algorithms: the
            logits (whole_logits) and every cache leaf bit for bit, K2/K3
            launched as often both ways, for llama3-8b-sable cut to 8
            layers (FFN pinned to cuda; 8 x 512 + 16 steps), DeepSeek-V2
            layer 0 + 4 MoE layers dropless (4 x 512 + 8; K3 and K2 must
            launch), mamba2-1.3b whole and seamless whole; (b) the dry-run
            CLI (python -m repro_torch.launch.dryrun --device cuda) on
            llama3-8b train_4k, DeepSeek-V2 decode_32k, mamba2 long_500k
            and seamless prefill_32k on the (16, 16) mesh and llama3-8b
            train_4k on (2, 16, 16), each in its own process on a fake
            process group: exit 0, each status ok, per-rank GB, FLOPs and
            the dominant roofline term printed; (c) dense llama3-8b's
            prefill of 8 x 512 built by the dry-run's build_cell on a (1, 1)
            mesh, traced on fake tensors and run on the card: the traced
            FLOPs must equal FlopCounterMode's over the run; the traced
            peak beside max_memory_allocated, the roofline's largest term
            beside the measured ms.

Bounds: bytes over 3.35 TB/s or operations over the dtype's peak, the
larger; float32's peak is the 3xTF32 rate (494.7 / 3 TFLOP/s), and
fma_bound_ms beside it counts float32 on the FMA pipes (67 TFLOP/s).
Tolerance: max|out - ref| / max|ref| <= 1e-5 in float32, 2e-2 in bfloat16.
A library yardstick is timed --reps times, or as often as LIB_BUDGET_MS of
calls allows where one call is slow (cuSPARSE at jamba's widths takes
~0.5-0.9 s), but at least LIB_MIN_REPS times.
Any failure raises. The last two lines are the `kernels` JSON object (K1
and K2 at u in float32 as the rows' own keys, and their other rows as
u_bf16_*, nu_f32_* and nu_bf16_* keys; K3 at the MoE prefill tables in
float32, launched by the float32 pass; moe_{prefill,decode}_{bf16,f32}_*
keys for K2 and K3; tile_{u,nu}_{tm}x{tk}_f32_* keys for K1 and K2 at the
tuner's other tiles, with the launches of phase 8's cold tunes, and
tune_winners; ffn_{prefill,decode}_{bf16,f32}_* and ffn_out_* keys for K2 at
the FFN shapes, with the pinned-cuda serve's launches; cb_* keys on K2 for
phase 10: its launches, the median decode step and its gather and scatter,
the gather alone beside its bound, and the profiled step's device busy ms;
l4_{prefill,decode}_{bf16,f32}_* keys for K2 and K3 at llama4-scout's
tables, launches from phase 11's llama4-scout generate; ds_{prefill,decode}
_bf16_* at the served DeepSeek-V2's tables, launches from its generate, and
ds_serve_launches from its serve; jb_{prefill,decode}_{bf16,f32}_* for K2
and K3 at jamba's tables, launches from phase 12's jamba generate, and
jb_serve_launches from its serve; train_bwd_{ds,da,dw}_{bf16,f32}_* keys
for the backward's tables (K3 ds and K2 da with copy_ms, K2 dw), their
launches in 13a's backward counted by table, train_moe_*
launches of 13a, train_step_* for 13b, train_ffn_{in,out}_* for K2 at 13b's
FFN shapes and train_cut_* for 13c; shard_{u,nu}_{f32,bf16}_* for K1 and K2
in 15a: the sharded call, the unsharded call, the shard tables' kernels,
plain versions, library calls and bounds summed, launches, imbalance;
shard_contiguous_*, shard_mesh_*, shard_tune_* and shard_warm_* for the
rest of phase 15; shard_train_* and shard_ckpt_* on K2 for 16a and 16c,
shard_moe_{dropless,capacity}_launches on K2 and K3 for 16b;
shard_serve_{sable,ds}_* on K2 and shard_serve_ds_launches on K3 for 17a,
dryrun_prefill_* and dryrun_<cell>_peak_gb on K2 for 17c and 17b) and
{"ok": true, "device": {...}}.
Without a CUDA device, or without the package beside this script, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
# float32: 3xTF32, three TF32 products (494.7 TFLOP/s) for each float32-accurate one
PEAK_OPS_PER_S = {"torch.float32": 494.7e12 / 3, "torch.bfloat16": 989e12}
FMA_OPS_PER_S = 67e12  # float32 on the FMA pipes: the bound before 3xTF32
TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
LIB_BUDGET_MS, LIB_MIN_REPS = 4000.0, 5  # library yardsticks: timed calls' budget, floor

KERNELS = {
    "bsr_spmv": ("src/repro_torch/kernels/csrc/bsr_spmv.cu", "src/repro/kernels/bsr_spmv.py:39"),
    "bsr_spmm": ("src/repro_torch/kernels/csrc/bsr_spmm.cu", "src/repro/kernels/bsr_spmm.py:49"),
    "bsr_sdd": ("src/repro_torch/kernels/csrc/bsr_sdd.cu", "src/repro/kernels/bsr_ops.py:94"),
}


def rel_err(out, ref) -> tuple[float, float]:
    """(max abs error, that error over max|ref|), both in float32."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def check(label: str, out, ref, dtype) -> float:
    err, rel = rel_err(out, ref)
    tol = TOL[str(dtype)]
    ok = rel <= tol
    print(f"  {label}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: relative error {rel:.3e} above {tol:g}")
    return err


def library_time(label, make, want, dtype, reps, select=lambda y: y, before=None):
    """A library call that computes a kernel's function, timed as its
    yardstick: ``make()`` builds the library's operands and returns the
    call. Its result (through ``select``) is compared with ``want``, and the
    error printed beside the time with a note where it exceeds the dtype's
    tolerance (the library's own precision, not a failure of the port).
    Returns (ms or None, text): None, with the error, where this install
    refuses the call."""
    import torch

    try:
        call = make()
        t0 = time.perf_counter()
        got = select(call())
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    except Exception as e:  # any refusal is the finding: record it
        txt = f"n/a ({type(e).__name__}: {(str(e).splitlines() or [''])[0][:200]})"
        print(f"  {label}: {txt}")
        return None, txt
    err, rel = rel_err(got, want)
    del got
    # a call of a second or so (cuSPARSE at jamba's widths) is timed fewer
    # times: LIB_BUDGET_MS of timed calls, never fewer than LIB_MIN_REPS
    reps = max(LIB_MIN_REPS, min(reps, int(LIB_BUDGET_MS / max(first_ms, 1e-3))))
    ms = median_ms(call, reps, before)
    tol = TOL[str(dtype)]
    note = "" if rel <= tol else f", less precise than the kernels' tolerance {tol:g}"
    print(f"  {label}: ms={ms:.4f} vs plain: max_abs_err={err:.3e} rel={rel:.3e}{note}")
    return ms, f"{ms:.4f}"


def median_ms(fn, reps: int, before=None) -> float:
    """Median of per-call CUDA-event times, after two warm-up calls;
    ``before()``, if given, runs ahead of each call outside the events."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def random_tables(rng, n_row_tiles, n_col_tiles, nb, tm, tk, empty_rows):
    """Sorted tile tables; the first ``empty_rows`` row tiles of a shuffled
    order get no tile. Returns numpy (tiles, row_ids, col_ids)."""
    import numpy as np

    live = rng.permutation(n_row_tiles)[empty_rows:]
    rows = np.sort(np.concatenate([live, rng.choice(live, nb - len(live))])).astype(np.int32)
    cols = rng.integers(0, n_col_tiles, nb).astype(np.int32)
    tiles = rng.standard_normal((nb, tm, tk)).astype(np.float32)
    return tiles, rows, cols


def phase_kernels(rng, torch, kops, kref):
    import numpy as np

    from repro_torch.kernels import testing

    print("phase 2: kernels vs plain versions on the card")
    cases = [  # (tables, tm, tk, n, dtype)
        ("random", 32, 32, 128, torch.float32),
        ("random", 32, 32, 100, torch.bfloat16),
        ("random", 8, 128, 70, torch.float32),
        ("random", 5, 7, 33, torch.float32),
        ("random", 16, 12, 6, torch.bfloat16),
        ("random", 40, 3, 129, torch.float32),
        ("random", 40, 32, 129, torch.bfloat16),  # one row tile to a bfloat16 CTA
        ("random", 100, 16, 72, torch.bfloat16),  # two CTAs to a row tile, one ragged
        ("random", 1, 1, 1, torch.float32),
        ("runs", 8, 1536, 200, torch.bfloat16),
        ("runs", 8, 40, 136, torch.float32),
        ("runs", 16, 24, 100, torch.bfloat16),
        ("runs", 16, 24, 100, torch.float32),
        ("runs", 32, 32, 128, torch.bfloat16),
        ("runs", 5, 16, 72, torch.bfloat16),
        ("runs", 5, 7, 33, torch.float32),
        ("runs", 40, 24, 100, torch.bfloat16),
        ("runs", 100, 16, 136, torch.bfloat16),
    ]
    # the skewed tables of K1 and K2's split over the card's workers: a row
    # tile with 90% of the tiles, fewer tiles than workers, one tile, long
    # runs of empty row tiles; float32 twice, for bit-identical results
    cases += [(kind, 32, 32, 100, dtype) for kind in testing.SKEWED
              for dtype in (torch.float32, torch.bfloat16)]
    dev = torch.device("cuda")
    for kind, tm, tk, n, dtype in cases:
        n_ct = 9
        if kind == "random":
            n_rt = 23
            tiles, rows, cols = random_tables(rng, n_rt, n_ct, 60, tm, tk, empty_rows=4)
        else:
            if kind == "runs":
                rows, cols, n_rt = testing.run_tables(rng, n_ct, pad=5)
            else:
                rows, cols, n_rt = testing.skewed_tables(rng, kind, n_ct)
            tiles = rng.standard_normal((len(rows), tm, tk)).astype(np.float32)
            tiles[rows == n_rt] = 0  # padding holds zeros, as BlockMatrix's does
        t = torch.as_tensor(tiles, device=dev).to(dtype)
        r = torch.as_tensor(rows, device=dev)
        c = torch.as_tensor(cols, device=dev)
        x = torch.as_tensor(rng.standard_normal(n_ct * tk), device=dev).to(dtype)
        xm = torch.as_tensor(rng.standard_normal((n_ct * tk, n)), device=dev).to(dtype)
        m_pad = n_rt * tm
        y = kops.bsr_spmv(t, r, c, x, m_pad=m_pad, device=dev)
        ym = kops.bsr_spmm(t, r, c, xm, m_pad=m_pad, device=dev)
        torch.cuda.synchronize()
        tag = f"{kind} tables tm={tm} tk={tk} n={n} {str(dtype)[6:]}"
        check(f"bsr_spmv {tag}", y, kref.bsr_spmv_ref(t, r, c, x, m_pad), dtype)
        check(f"bsr_spmm {tag}", ym, kref.bsr_spmm_ref(t, r, c, xm, m_pad), dtype)
        if kind in testing.SKEWED and dtype == torch.float32:
            same_bits(f"bsr_spmv {tag}", y, kops.bsr_spmv(t, r, c, x, m_pad=m_pad, device=dev))
            same_bits(f"bsr_spmm {tag}", ym,
                      kops.bsr_spmm(t, r, c, xm, m_pad=m_pad, device=dev))


def same_bits(label: str, first, again) -> None:
    """Two launches on the same inputs must give the same bits."""
    import torch

    torch.cuda.synchronize()
    ok = torch.equal(first, again)
    print(f"  {label}: second launch bit-identical {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: two launches on the same inputs differ")


def bound_fields(nbytes: int, ops: int, dtype) -> dict:
    """The least time the card could take: ``bound_ms``, bytes over HBM
    bandwidth or operations over the dtype's peak, whichever is larger, and
    ``bound_by``; in float32 also ``fma_bound_ms``, the same with float32 on
    the FMA pipes (the yardstick before 3xTF32)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = max((t_bytes, "bytes"),
                     (ops / PEAK_OPS_PER_S[str(dtype)] * 1e3, "operations"))
    fields = dict(bound_ms=b_ms, bound_by=b_by)
    if str(dtype) == "torch.float32":
        fields["fma_bound_ms"] = max(t_bytes, ops / FMA_OPS_PER_S * 1e3)
    return fields


def bound_text(f: dict, nbytes: int, ops: int) -> str:
    fma = f" fma_bound_ms={f['fma_bound_ms']:.4f}" if "fma_bound_ms" in f else ""
    return f"bound_ms={f['bound_ms']:.4f} ({f['bound_by']}: {nbytes} B, {ops} ops){fma}"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def body_label(dtype, body: str) -> str:
    """K3's body as printed: its products and its copies."""
    products = "3xTF32" if str(dtype) == "torch.float32" else "bfloat16"
    return f"{products} mma.sync, {body} copies"


def phase_sdd(rng, torch, kops, kref):
    import numpy as np

    from repro_torch.kernels import testing

    print("phase 5: K3 (bsr_sdd) vs its plain version on the card")
    cases = [  # (slots, bm, bn, K, dtype)
        ("random", 8, 200, 45, torch.float32),
        ("random", 8, 200, 45, torch.bfloat16),
        ("random", 8, 1536, 5120, torch.bfloat16),
        ("random", 8, 96, 1000, torch.float32),
        ("random", 3, 7, 1, torch.float32),
        ("random", 20, 130, 33, torch.bfloat16),
        ("random", 40, 64, 96, torch.float32),
        ("random", 40, 64, 96, torch.bfloat16),  # one slot to a bfloat16 CTA
        ("random", 100, 136, 40, torch.bfloat16),  # two CTAs to a slot, one ragged
        ("random", 1, 1, 1, torch.bfloat16),
        ("runs", 8, 1536, 512, torch.bfloat16),
        ("runs", 8, 200, 45, torch.float32),
        ("runs", 16, 136, 96, torch.bfloat16),
        ("runs", 32, 130, 64, torch.bfloat16),
        ("runs", 32, 130, 64, torch.float32),
        ("runs", 5, 72, 40, torch.bfloat16),
        ("runs", 40, 136, 96, torch.bfloat16),
        ("runs", 100, 72, 40, torch.bfloat16),
    ]
    # float32 on both bodies: groups of 64 to 2 slots, one slot of 40 rows and
    # two CTAs to a slot of 100, bn past 128 and ragged, K not 32-deep; the
    # MoE's blocks at its depth
    cases += [("runs", bm, 200, 44, torch.float32) for bm in (1, 5, 8, 16, 24, 40, 100)]
    cases += [("runs", 8, 1536, 5120, torch.float32)]
    dev = torch.device("cuda")
    for kind, bm, bn, K, dtype in cases:
        n_cb, pad = 7, 3
        if kind == "random":
            n_rb, nnz = 9, 20
            # sorted slots, then padding slots (row n_rb, col 0) as BlockMatrix pads
            rows = np.concatenate([np.sort(rng.integers(0, n_rb, nnz)), np.full(pad, n_rb)])
            cols = np.concatenate([rng.integers(0, n_cb, nnz), np.zeros(pad)])
        else:
            rows, cols, n_rb = testing.run_slots(rng, n_cb, pad)
        r = torch.as_tensor(rows.astype(np.int32), device=dev)
        c = torch.as_tensor(cols.astype(np.int32), device=dev)
        a = torch.as_tensor(rng.standard_normal((n_rb * bm, K)), device=dev).to(dtype)
        operands = [a]
        if dtype == torch.float32:  # the same values 4 bytes past a 16-byte boundary
            operands.append(torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape))
        w = torch.as_tensor(rng.standard_normal((n_cb, K, bn)), device=dev).to(dtype)
        stacked = w.permute(1, 0, 2).reshape(K, n_cb * bn)
        want = kref.bsr_sdd_ref(a, stacked, r, c, bm, bn)
        tag = f"{kind} slots bm={bm} bn={bn} K={K} {str(dtype)[6:]}"
        for layout, b in (("stacked", stacked), ("expert stack view", w.permute(1, 0, 2))):
            for a_in in operands:
                body = kops.sdd_body(a_in, b.view(K, n_cb, bn) if b.dim() == 2 else b)
                out = kops.bsr_sdd(a_in, b, r, c, bm=bm, bn=bn, device=dev)
                torch.cuda.synchronize()
                label = f"bsr_sdd {tag} ({layout}, {pad} padding slots, {body_label(dtype, body)})"
                check(label, out, want, dtype)
                if dtype == torch.float32:
                    if a_in is not a and body != "scalar":
                        raise RuntimeError(f"{label}: a shifted a must take the scalar body")
                    same_bits(label, out, kops.bsr_sdd(a_in, b, r, c, bm=bm, bn=bn, device=dev))


def moe_configs():
    from repro_torch.configs.deepseek_v2_236b import full

    cfg = full()
    mc = cfg.moe
    dropless = replace(cfg, moe=replace(mc, dropless=True))
    # capacity_factor = E / top_k gives C >= tokens per group: nothing drops
    capacity = replace(cfg, moe=replace(mc, capacity_factor=mc.num_experts / mc.top_k))
    return dropless, capacity


def sdd_tables(tmoe, p, x, cfg):
    """K3's operands on the dropless path, as moe_apply builds them: the
    (G*E*C, d) buffer, the topology, and the coordinates sdd passes (padding
    slots at row n_block_rows, which K3 writes as zero blocks)."""
    r = tmoe._route(p, x, cfg)
    buf = tmoe._dispatch(x, r, cfg)
    topo = tmoe._dropless_topology(r.counts, r.C, r.Tg, cfg, cfg.moe.d_ff)
    return buf.reshape(-1, x.shape[-1]), topo, topo.row_indices, topo.column_indices


def phase_moe(args, torch, kops, kref, dtype):
    """Phase 6 in ``dtype``: the dropless layer at full width through
    moe_apply, checked; returns what phase 7 times and the launch counts."""
    from repro_torch.models import moe as tmoe

    dname = str(dtype)[6:]
    print(f"phase 6: DeepSeek-V2-236B MoE layer at full width, dropless ({dname})")
    cfg, cfg_cap = moe_configs()
    mc = cfg.moe
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    p = tmoe.moe_init(gen, cfg, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    print(f"  params: {nbytes(*p.values()) / 1e9:.3f} GB in {dname}, drawn in "
          f"{time.perf_counter() - t0:.2f} s (d_model={cfg.d_model} experts={mc.num_experts} "
          f"top_k={mc.top_k} d_ff={mc.d_ff} shared={mc.num_shared}x{mc.shared_d_ff})")
    xs = {
        name: torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(dtype)
        for name, (B, S) in (("prefill", (4, 512)), ("decode", (64, 1)))
    }
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    outs = {name: tmoe.moe_apply(p, x, cfg) for name, x in xs.items()}
    torch.cuda.synchronize()
    launches = dict(kops.launches)
    print(f"  launches on the MoE path ({dname}): {launches}")
    for name in ("bsr_sdd", "bsr_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"MoE path ({dname}) never launched {name}")
    print(f"  peak device memory (dropless, {dname}): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    for name, x in xs.items():
        y, aux = outs[name]
        if tuple(y.shape) != tuple(x.shape) or not torch.isfinite(y.float()).all():
            raise AssertionError(f"{name}: output {tuple(y.shape)} is not finite of the "
                                 f"input's shape {tuple(x.shape)}")
        y_cap, aux_cap = tmoe.moe_apply(p, x, cfg_cap)
        check(f"moe {name} B,S={tuple(x.shape[:2])} {dname} dropless vs capacity path", y,
              y_cap, dtype)
        check(f"moe {name} aux loss dropless vs capacity path (float32)", aux, aux_cap,
              torch.float32)
        print(f"  moe {name}: aux={float(aux):.6f} |y|max={float(y.abs().max()):.4f}")
        del y_cap
    print(f"  peak device memory (with the capacity path, {dname}): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del outs

    a, topo, rows, cols = sdd_tables(tmoe, p, xs["prefill"], cfg)
    n_valid = int(topo.n_blocks)
    pick = sample_slots(torch, topo, args.seed)
    w1 = p["w1"].permute(1, 0, 2)
    bm, bn = topo.block
    out = kops.bsr_sdd(a, w1, rows[pick], cols[pick], bm=bm, bn=bn, device=dev)
    want = kref.bsr_sdd_ref(a, w1, rows[pick], cols[pick], bm, bn)
    check(f"bsr_sdd on the prefill path's tables ({len(pick)} sampled slots of "
          f"{topo.nnz_max}, {n_valid} valid, {body_label(dtype, kops.sdd_body(a, w1))})", out,
          want, dtype)
    return tmoe, p, xs, cfg, cfg_cap, launches


def phase_moe_times(args, torch, kops, kref, tmoe, p, xs, cfg, cfg_cap, dtype):
    dname = str(dtype)[6:]
    print(f"phase 7: MoE times in {dname} (median of {args.reps} calls, CUDA events)")
    for name, x in xs.items():
        ms = median_ms(lambda: tmoe.moe_apply(p, x, cfg), args.reps)
        cap_ms = median_ms(lambda: tmoe.moe_apply(p, x, cfg_cap), args.reps)
        print(f"  moe_apply {name} B,S={tuple(x.shape[:2])} {dname}: dropless ms={ms:.4f} "
              f"capacity-path ms={cap_ms:.4f}")
        device_breakdown(torch, f"moe_apply {name} {dname} dropless",
                         lambda: tmoe.moe_apply(p, x, cfg))
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    stack_ms = median_ms(lambda: p["w1"].permute(1, 0, 2).reshape(d, E * f), args.reps)
    print(f"  not on the path: stacking w1 into (d, E*f) as the reference does per call "
          f"ms={stack_ms:.4f} (x2 with w3); K3 reads the expert stack in place")
    records = {}
    for name, x in xs.items():
        a, topo, rows, cols = sdd_tables(tmoe, p, x, cfg)
        records[("bsr_sdd", name, str(dtype))] = time_sdd(args, torch, kops, kref, p, a, topo,
                                                          name)
        records[("bsr_spmm", name, str(dtype))] = time_dsd(args, torch, kops, kref, p, a, topo,
                                                           name)
        del a, topo, rows, cols
        torch.cuda.empty_cache()
    return records


def sample_slots(torch, topo, seed, n=60, n_pad=4):
    """Sorted slot indices: ``n`` random valid slots and up to ``n_pad``
    padding slots, for the plain versions (which cannot hold a float32
    gather of every slot at these widths)."""
    dev = topo.row_indices.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_valid = int(topo.n_blocks)
    pick = torch.cat([torch.randperm(n_valid, generator=gen, device=dev)[:n],
                      torch.arange(n_valid, topo.nnz_max, device=dev)[:n_pad]])
    return torch.sort(pick).values


def time_sdd(args, torch, kops, kref, p, a, topo, name, flush=None, n_sample=60):
    """K3 at the path's tables (all slots, padding included) beside its
    bound, its plain version on ``n_sample`` sampled slots and the library
    call, in the layer's dtype, each timed call after ``flush()`` if given;
    at prefill also on the same slots ordered by expert."""
    from repro_torch.kernels import _build

    ext = _build.load_kernels()
    dev, dtype = a.device, a.dtype
    bm, bn = topo.block
    K = a.shape[1]
    rows, cols = topo.row_indices, topo.column_indices
    nnz, n_valid = topo.nnz_max, int(topo.n_blocks)
    w = p["w1"].permute(1, 0, 2)
    body = kops.sdd_body(a, w)
    out = torch.empty((nnz, bm, bn), dtype=dtype, device=dev)
    launch = lambda: ext.bsr_sdd(a, w, rows, cols, out, body == "cp.async")  # noqa: E731
    launch()
    pick = sample_slots(torch, topo, args.seed + 1, n=n_sample)
    sample = (rows[pick], cols[pick])
    plain = lambda: kref.bsr_sdd_ref(a, w, *sample, bm, bn)  # noqa: E731
    tag = f"bsr_sdd {name} {str(dtype)[6:]}"
    err = check(f"{tag} tables ({len(pick)} sampled slots) kernel vs plain", out[pick],
                plain(), dtype)
    first = out.clone()
    ms = median_ms(launch, args.reps, flush)
    same_bits(f"{tag} tables, last timed launch", first, out)
    del first
    out_s = torch.empty((len(pick), bm, bn), dtype=dtype, device=dev)
    sample_ms = median_ms(lambda: ext.bsr_sdd(a, w, *sample, out_s, body == "cp.async"),
                          args.reps, flush)
    plain_ms = median_ms(plain, args.reps, flush)
    # the valid slots' a rows and each used expert's weight block read once,
    # every slot's block written once; padding slots do no work
    valid = rows < topo.n_block_rows
    n_a = int(torch.unique(rows[valid]).numel())
    n_b = int(torch.unique(cols[valid]).numel())
    need = (n_a * bm * K + n_b * K * bn + nnz * bm * bn) * a.element_size() + nbytes(rows, cols)
    ops = 2 * n_valid * bm * bn * K
    bound = bound_fields(need, ops, dtype)
    lib_ms, lib_txt = sdd_library(torch, a, w, topo, out, n_valid, args.reps, flush)
    print(f"  {tag}: slots={nnz} ({n_valid} valid) bm={bm} bn={bn} K={K} "
          f"body={body_label(dtype, body)} ms={ms:.4f} {bound_text(bound, need, ops)} "
          f"roofline_share={bound['bound_ms'] / ms:.3f}; on {len(pick)} sampled slots: "
          f"ms={sample_ms:.4f} plain_ms={plain_ms:.4f}; library_ms={lib_txt}")
    if name == "prefill":
        # the same work with one run per expert: each weight chunk read about
        # once instead of once per token group (a dispatch sorted by expert)
        order = torch.sort(torch.where(valid, cols, cols.max() + 1), stable=True).indices
        r2, c2 = rows[order].contiguous(), cols[order].contiguous()
        by_ms = median_ms(lambda: ext.bsr_sdd(a, w, r2, c2, out, body == "cp.async"),
                          args.reps, flush)
        print(f"  {tag} tables with the slots ordered by expert (one run per expert): "
              f"ms={by_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                body=body_label(dtype, body), **bound)


def time_dsd(args, torch, kops, kref, p, a, topo, name, flush=None, n_panels=16):
    """K2 at the dsd tables as bsr_ops.dsd builds them (m_pad = M, row
    offsets over the real row tiles only): the activations h against the
    stacked w2, in the layer's dtype, beside its bound, its plain version on
    ``n_panels`` whole 64-row panels (the runs a bfloat16 CTA walks) and the
    library call, each timed call after ``flush()`` if given. The timed
    launch's own output is held against the plain version on those panels;
    in float32 it must be the first launch's bits."""
    from repro_torch.kernels import _build, bsr_ops

    ext = _build.load_kernels()
    dev, dtype = a.device, a.dtype
    bm, f = topo.block
    E, d = p["w2"].shape[0], p["w2"].shape[2]
    w1, w3 = p["w1"].permute(1, 0, 2), p["w3"].permute(1, 0, 2)
    h, g = bsr_ops.sdd(a, w1, topo), bsr_ops.sdd(a, w3, topo)
    tiles = h.with_data(torch.nn.functional.silu(h.data) * g.data).data.contiguous()
    del h, g
    x2 = p["w2"].reshape(E * f, d)
    M, Rb = topo.shape[0], topo.n_block_rows
    rows, cols = topo.row_indices, topo.column_indices

    def tables(r):
        """Row offsets over r, and the float32 body's split of the table and
        its scratch (the bfloat16 body walks the row offsets alone)."""
        rp = kops.row_ptr_from_ids(r, Rb)
        if dtype != torch.float32:
            none = torch.empty(0, device=dev)
            return rp, none, none
        sched = kops.bsr_schedule("spmm", rp, bm, f, d, dtype)
        return rp, sched, torch.empty(2 * sched.shape[0] * bm * d, dtype=torch.float32,
                                      device=dev)

    rptr, sched, partial = tables(rows)
    y = torch.empty((M, d), dtype=x2.dtype, device=dev)
    launch = lambda: ext.bsr_spmm(tiles, rptr, cols, x2, y, sched, partial)  # noqa: E731
    launch()
    first = y.clone() if dtype == torch.float32 else None
    ms = median_ms(launch, args.reps, flush)
    if first is not None:
        same_bits(f"bsr_spmm dsd {name} float32 tables, last timed launch", first, y)
    del first
    # a few whole panels of 64 / bm row tiles that hold tiles, and their tiles
    n_valid = int(topo.n_blocks)
    panel = 64 // bm
    live = torch.unique(rows[:n_valid] // panel)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    pick = torch.randperm(live.numel(), generator=gen, device=dev)[:n_panels]
    panels = torch.sort(live[pick]).values
    sel = torch.isin(rows[:n_valid] // panel, panels).nonzero().squeeze(1)
    s_tiles, s_rows, s_cols = tiles[sel].contiguous(), rows[sel], cols[sel]
    out_rows = (panels[:, None] * (panel * bm) + torch.arange(panel * bm, device=dev)).reshape(-1)
    out_rows = out_rows[out_rows < M]
    plain = lambda: kref.bsr_spmm_ref(s_tiles, s_rows, s_cols, x2, M)  # noqa: E731
    tag = f"bsr_spmm dsd {name} {str(dtype)[6:]}"
    err = check(f"{tag} tables, timed launch's output on {panels.numel()} whole panels "
                f"({len(sel)} tiles) vs plain", y[out_rows], plain()[out_rows], dtype)
    s_tables = tables(s_rows)
    ys = torch.empty_like(y)
    sample_ms = median_ms(lambda: ext.bsr_spmm(s_tiles, s_tables[0], s_cols, x2, ys,
                                               *s_tables[1:]), args.reps, flush)
    plain_ms = median_ms(plain, args.reps, flush)
    del ys
    # the valid tiles and each used expert's w2 block read once, y written
    # once; padding tiles are not visited
    n_b = int(torch.unique(cols[:n_valid]).numel())
    es = x2.element_size()
    need = (n_valid * bm * f + n_b * f * d + M * d) * es + nbytes(rptr, cols[:n_valid])
    ops = 2 * n_valid * bm * f * d
    bound = bound_fields(need, ops, dtype)
    del y
    torch.cuda.empty_cache()
    lib_ms, lib_txt = dsd_library(torch, kref, tiles[:n_valid], topo, x2, dtype, args.reps,
                                  flush)
    if dtype != torch.float32:
        _, lib32_txt = dsd_library(torch, kref, tiles[:n_valid], topo, x2, torch.float32,
                                   args.reps, flush)
        lib_txt += f" (float32: {lib32_txt})"
    print(f"  {tag}: tiles={tiles.shape[0]} ({n_valid} valid) tm={bm} tk={f} n={d} "
          f"ms={ms:.4f} {bound_text(bound, need, ops)} "
          f"roofline_share={bound['bound_ms'] / ms:.3f}; on {len(sel)} tiles of "
          f"{panels.numel()} panels: ms={sample_ms:.4f} plain_ms={plain_ms:.4f}; "
          f"library_ms={lib_txt}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound)


def own_times(spans):
    """Device time by kernel from (start, end, name) spans: each stretch of
    time goes to the earliest-started kernel running then, so a kernel's own
    time is what it runs after every kernel launched before it has ended (a
    programmatic dependent's wait on its primary is not its own), and the
    own times add up to the union of the spans. Returns ({name: [own, span,
    count]}, union)."""
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    by_start = sorted(spans)
    table = {}
    for s, e, name in spans:
        row = table.setdefault(name, [0.0, 0.0, 0])
        row[1] += e - s
        row[2] += 1
    busy = 0.0
    active = []  # indices into by_start, in start order
    nxt = 0
    for t0, t1 in zip(cuts, cuts[1:]):
        while nxt < len(by_start) and by_start[nxt][0] <= t0:
            active.append(nxt)
            nxt += 1
        active = [k for k in active if by_start[k][1] > t0]
        if active:
            busy += t1 - t0
            table[by_start[active[0]][2]][0] += t1 - t0
    return table, busy


def device_breakdown(torch, label, fn, top=6):
    """One call under torch.profiler: the device time by kernel (own time,
    largest first, then any other kernel that overlapped another, with the
    kernel's whole span beside it where they differ; see ``own_times``) and the device's busy share of the call's
    wall time (the union of the kernels' spans; the profiler's overhead
    inflates the wall), or "not measured" if the profiler sees no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():  # the profiler's notice about event cycles
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start / 1e3, e.time_range.end / 1e3, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
    table, busy = own_times(spans)
    if busy == 0:
        print(f"  profile {label}: device time not measured (the profiler saw none)")
        return
    rows = sorted(((own, span, n, k) for k, (own, span, n) in table.items()), reverse=True)
    def overlapped(row):
        return row[1] > row[0] * 1.01 + 1e-3

    parts = []
    for row in rows[:top] + [row for row in rows[top:] if overlapped(row)]:
        own, span, n, k = row
        parts.append(f"{k[:60]} x{n} {own:.3f} ms" + (f" (span {span:.3f})" if overlapped(row) else ""))
    parts = "; ".join(parts)
    print(f"  profile {label}: device busy {busy:.3f} of {wall_ms:.3f} ms wall "
          f"(share {busy / wall_ms:.3f}); by kernel: {parts}")


def sdd_library(torch, a, w, topo, out, n_valid, reps, flush=None):
    """torch.sparse.sampled_addmm over the topology's element-level CSR, in
    a's dtype, held against K3's valid blocks; (ms or None, text)."""
    bm, bn = topo.block

    def make():
        dev = a.device
        r = topo.row_indices[:n_valid].long()
        c = topo.column_indices[:n_valid].long()
        if int((topo.offsets[1:] - topo.offsets[:-1]).max()) > 1:
            raise ValueError("a block row with two blocks: CSR order differs from slot order")
        m, j = torch.arange(bm, device=dev), torch.arange(bn, device=dev)
        er = (r[:, None, None] * bm + m[None, :, None]).expand(-1, bm, bn)
        ec = (c[:, None, None] * bn + j[None, None, :]).expand(-1, bm, bn)
        idx = torch.stack([er.reshape(-1), ec.reshape(-1)])
        stacked = w.reshape(w.shape[0], -1)  # (K, E*bn), a copy
        pattern = torch.sparse_coo_tensor(
            idx, torch.ones(idx.shape[1], dtype=a.dtype, device=dev),
            (a.shape[0], stacked.shape[1]),
        ).coalesce().to_sparse_csr()
        return lambda: torch.sparse.sampled_addmm(pattern, a, stacked, beta=0.0)

    return library_time(f"bsr_sdd library call sampled_addmm ({str(a.dtype)[6:]}, valid slots)",
                        make, out[:n_valid], a.dtype, reps,
                        select=lambda res: res.values().reshape(n_valid, bm, bn), before=flush)


def dsd_library(torch, kref, tiles, topo, x, dtype, reps, flush=None):
    """torch.sparse_csr_tensor(...) @ x (cuSPARSE) in ``dtype`` over the
    element-level CSR of the valid tiles, held against K2's plain version
    on the first tiles' rows; (ms or None, text)."""
    n_valid, (bm, bk) = tiles.shape[0], topo.block
    dev = tiles.device
    r = topo.row_indices[:n_valid].long()
    c = topo.column_indices[:n_valid].long()
    head = slice(0, min(n_valid, 16))
    m = torch.arange(bm, device=dev)
    rows = (r[head, None] * bm + m[None, :]).reshape(-1)
    want = kref.bsr_spmm_ref(tiles[head].float(), r[head], c[head], x.float(),
                             topo.shape[0])[rows]
    xd = x.to(dtype)

    def make():
        j = torch.arange(bk, device=dev)
        er = (r[:, None, None] * bm + m[None, :, None]).expand(-1, bm, bk)
        ec = (c[:, None, None] * bk + j[None, None, :]).expand(-1, bm, bk)
        idx = torch.stack([er.reshape(-1), ec.reshape(-1)])
        csr = torch.sparse_coo_tensor(idx, tiles.to(dtype).reshape(-1), topo.shape
                                      ).coalesce().to_sparse_csr()
        return lambda: csr @ xd

    return library_time(f"bsr_spmm dsd library call sparse_csr_tensor(...) @ x "
                        f"({str(dtype)[6:]})", make, want, dtype, reps,
                        select=lambda res: res[rows], before=flush)


def l2_flush(torch):
    """A call that writes 134 MB, well past the 50 MB L2, then reads it back,
    so that the next launch finds its inputs in device memory as a cold
    caller would: the tiles of nu (26 MB in float32) and of u in bfloat16
    (50 MB) would otherwise stay in L2 between back-to-back launches. The
    read leaves the L2 full of clean lines: after the write alone it would
    hold 50 MB of dirty ones, whose write-back the timed launch would pay."""
    scratch = torch.empty(2**25, dtype=torch.float32, device="cuda")

    def flush():
        scratch.zero_()
        scratch.sum()

    return flush


def bsr_call(torch, row_ptr, cols, tiles, size, rhs):
    """The library's product of the tile table with rhs, the tensor built
    once: the call. torch.sparse_bsr_tensor(...) @ rhs for square tiles;
    its product takes no other (an internal assert on this install), so
    tm != tk gets torch.sparse_csr_tensor(...) @ rhs over the tiles'
    elements (padding zeros included), the same function."""
    nb, tm, tk = tiles.shape
    if tm == tk:
        bsr = torch.sparse_bsr_tensor(row_ptr, cols, tiles, size=size, check_invariants=True)
        return lambda: bsr @ rhs
    dev = tiles.device
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
    er = (rows[:, None, None] * tm + torch.arange(tm, device=dev)[None, :, None]).expand(-1, tm, tk)
    ec = (cols.long()[:, None, None] * tk + torch.arange(tk, device=dev)[None, None, :]).expand(
        -1, tm, tk)
    idx = torch.stack([er.reshape(-1), ec.reshape(-1)])
    csr = torch.sparse_coo_tensor(idx, tiles.reshape(-1), size).coalesce().to_sparse_csr()
    return lambda: csr @ rhs


def band_vbr(n, bw, step, seed):
    """The banded matrix of benchmarks/bench_reblock.py's ``_band`` (row i
    holds float32 standard normals in columns i-bw..i+bw, drawn row by row),
    stored under splits every ``step`` rows and columns that ignore the band,
    as that benchmark stores it; built from its entries, not from a dense
    array (400 MB at n = 10 000). Returns (vbr, rows, cols, values)."""
    import numpy as np

    from repro_torch.core.reblock import build_vbr_from_coo

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        rows.append(np.full(hi - lo, i))
        cols.append(np.arange(lo, hi))
        vals.append(rng.standard_normal(hi - lo).astype(np.float32))
    rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
    splits = sorted({0, n, *range(0, n, step)})
    v, _ = build_vbr_from_coo(rows, cols, np.arange(len(rows)), splits, splits, (n, n),
                              val=vals)
    return v, rows, cols, vals


def check64(label, out, want):
    """A float32 result against a float64 numpy one, at float32's tolerance."""
    import numpy as np
    import torch

    return check(label, out.float(), torch.as_tensor(np.asarray(want, np.float64)).to(
        out.device).float(), torch.float32)


def phase_tuning(args, torch, kops, kref, mats, call_times, dev):
    """Phase 8: the tuning path at the paper's size, float32, on ``dev``, in
    a plan cache of its own. Returns ({(kernel, matrix, tile): record} for K1
    and K2 at each tile of the sweep other than (32, 32), {kind: {matrix:
    the cold tune's winner}})."""
    import tempfile

    import numpy as np

    from repro_torch.core import autotune as tautotune
    from repro_torch.core import cache as tcache
    from repro_torch.core import reblock as treblock
    from repro_torch.core import staging as tstaging
    from repro_torch.core.dsl import loopgen
    from repro_torch.core.inspect import detect_structure
    from repro_torch.core.vbr import structure_hash
    from repro_torch.kernels import _build

    print("phase 8: tuning path (autotune, plan cache, reblocking, dia_hybrid, gather) at "
          "10000 x 10000, float32")
    n_cols = 128
    rng = np.random.default_rng(args.seed + 8)
    inputs = {name: (torch.as_tensor(v.val, device=dev),
                     rng.standard_normal(v.shape[1]).astype(np.float32),
                     rng.standard_normal((v.shape[1], n_cols)).astype(np.float32))
              for name, v in mats.items()}
    dense = {name: v.to_dense().astype(np.float64) for name, v in mats.items()}
    tmp = tempfile.TemporaryDirectory(prefix="repro-plans-")
    tcache.set_default_cache(tcache.PlanCache(tmp.name))  # no earlier plan is read
    cases = [(name, kind) for name in mats for kind in ("spmv", "spmm")]
    opts = tstaging.StagingOptions(backend="autotune")

    def stage(name, kind):
        v = mats[name]
        return (tstaging.stage_spmv(v, opts, device=dev) if kind == "spmv"
                else tstaging.stage_spmm(v, n_cols, opts, device=dev))

    def plan_of(name, kind, **kw):
        v, n = mats[name], None if kind == "spmv" else n_cols
        return tcache.default_cache().load_plan(tcache.plan_key(
            kind, structure_hash(v), tcache.device_key(dev), n, **kw))

    def check_winner(label, kern, name, kind):
        val, x, X = inputs[name]
        rhs = x if kind == "spmv" else X
        xin = torch.as_tensor(rhs, device=dev)
        y = kern(val, xin)
        torch.cuda.synchronize()
        check64(f"{label} winner vs float64", y, dense[name] @ rhs.astype(np.float64))
        return median_ms(lambda: kern(val, xin), args.reps)

    # -- cold tunes, the default candidate space -----------------------------
    tautotune.reset_autotune_stats()
    kops.reset_launches()
    cold, winners = {}, {"spmv": {}, "spmm": {}}
    for name, kind in cases:
        t0 = time.perf_counter()
        kern = stage(name, kind)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        plan = plan_of(name, kind)
        label = min(plan.timings, key=plan.timings.get)
        cold[(name, kind)] = (kern, plan, label)
        parts = ", ".join(f"{lbl} {t * 1e3:.4f}" for lbl, t in
                          sorted(plan.timings.items(), key=lambda kv: kv[1]))
        print(f"  cold tune {name} {kind}: {secs:.2f} s; candidates ms (median of "
              f"{tautotune.DEFAULT_ITERS}, host clock): {parts}; winner {label} "
              f"({plan.options.backend}, tile {tuple(plan.options.tile)})")
        missing = [f"cuda[{tm}x{tk}]" for tm, tk in tautotune.CUDA_TILES
                   if f"cuda[{tm}x{tk}]" not in plan.timings]
        if missing:
            raise AssertionError(f"cold tune {name} {kind}: no timing for {missing}")
        winners[kind][name] = label
    launches = dict(kops.launches)
    stats = tautotune.autotune_stats()
    print(f"  cold tunes: benchmarks={stats['benchmarks']} plans_tuned={stats['plans_tuned']}; "
          f"kernel launches during the tunes: {launches}")
    for k in ("bsr_spmv", "bsr_spmm"):
        if launches[k] == 0:
            raise AssertionError(f"the tunes never launched {k}")
    for (name, kind), (kern, plan, label) in cold.items():
        ms = check_winner(f"tuned {name} {kind} ({label})", kern, name, kind)
        print(f"  tuned {name} {kind} winner {label}: fn(val, x) ms={ms:.4f} (CUDA events, "
              f"median of {args.reps}); phase 4's cuda (32, 32) ms="
              f"{call_times[(name, kind, 'torch.float32')]:.4f}")

    # -- warm restart: in-memory caches gone, a new PlanCache on the files ---
    tstaging.clear_cache()  # the reblock and DIA memos too
    tautotune.reset_autotune_stats()
    tcache.set_default_cache(tcache.PlanCache(tmp.name))
    t0 = time.perf_counter()
    warm = {case: stage(*case) for case in cases}
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats = tautotune.autotune_stats()
    print(f"  warm restart: staged {len(cases)} cases in {secs:.2f} s, "
          f"benchmarks={stats['benchmarks']} cache_hits={stats['cache_hits']}")
    if stats["benchmarks"] != 0:
        raise AssertionError(f"warm restart made {stats['benchmarks']} benchmarks")
    for case, kern in warm.items():
        if kern.opts != cold[case][0].opts:
            raise AssertionError(f"warm restart of {case} staged {kern.opts}, "
                                 f"not {cold[case][0].opts}")

    # -- the extended space at nu ----------------------------------------------
    nu = mats["nu"]
    t0 = time.perf_counter()
    specs = treblock.propose_reblockings(nu, device=dev)
    print(f"  reblock proposals for nu ({time.perf_counter() - t0:.2f} s): " + "; ".join(
        f"{sp.strategy} fill_ratio={sp.fill_ratio:.4f} cost={sp.cost:.0f} "
        f"(as given {sp.base_cost:.0f})" for sp in specs))
    for kind in ("spmv", "spmm"):
        t0 = time.perf_counter()
        kern = tautotune.autotune_stage(nu, kind, None if kind == "spmv" else n_cols,
                                        include_reblock=True, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        plan = plan_of("nu", kind, reblock=True)
        label = min(plan.timings, key=plan.timings.get)
        parts = ", ".join(f"{lbl} {t * 1e3:.4f}" for lbl, t in
                          sorted(plan.timings.items(), key=lambda kv: kv[1]))
        print(f"  extended tune nu {kind}: {secs:.2f} s; candidates ms: {parts}; winner "
              f"{label}; a reblocked candidate won: {plan.reblock is not None}")
        ms = check_winner(f"extended tune nu {kind} ({label})", kern, "nu", kind)
        print(f"  extended tune nu {kind} winner {label}: fn(val, x) ms={ms:.4f}")

    # -- dia_hybrid on a banded matrix -----------------------------------------
    t0 = time.perf_counter()
    band, rows, cols, vals = band_vbr(10_000, 24, 4, args.seed)
    info = detect_structure(band)
    print(f"  band 10000 x 10000, bandwidth 24, splits of 4: blocks={band.num_blocks} "
          f"stored={band.stored_nnz} class={info.structure_class} "
          f"diag_occupancy={info.diag_occupancy:.3f} dense diagonals="
          f"{len(info.dense_offsets)} wants_dia={info.wants_dia} "
          f"({time.perf_counter() - t0:.2f} s)")
    if not info.wants_dia:
        raise AssertionError("the banded matrix does not want dia_hybrid")
    t0 = time.perf_counter()
    kd = tstaging.stage_spmv(band, tstaging.StagingOptions(backend="dia_hybrid"), device=dev)
    secs = time.perf_counter() - t0
    xb = rng.standard_normal(band.shape[1]).astype(np.float32)
    want = np.bincount(rows, weights=vals.astype(np.float64) * xb[cols], minlength=band.shape[0])
    bval, bx = torch.as_tensor(band.val, device=dev), torch.as_tensor(xb, device=dev)
    check64(f"dia_hybrid band ({kd.num_diagonals} diagonals, remainder {kd.remainder_nnz} "
            f"stored slots on {kd._rem.backend if kd._rem else None})", kd(bval, bx), want)
    print(f"  dia_hybrid band: staged in {secs:.2f} s, fn(val, x) "
          f"ms={median_ms(lambda: kd(bval, bx), args.reps):.4f}")

    # -- gather and stage_block_op at nu ---------------------------------------
    val, x, X = inputs["nu"]
    for kind, rhs in (("spmv", x), ("spmm", X)):
        t0 = time.perf_counter()
        gopts = tstaging.StagingOptions(backend="gather")
        kg = (tstaging.stage_spmv(nu, gopts, device=dev) if kind == "spmv"
              else tstaging.stage_spmm(nu, n_cols, gopts, device=dev))
        secs = time.perf_counter() - t0
        xin = torch.as_tensor(rhs, device=dev)
        check64(f"gather nu {kind}", kg(val, xin), dense["nu"] @ rhs.astype(np.float64))
        print(f"  gather nu {kind}: staged in {secs:.2f} s, fn(val, x) "
              f"ms={median_ms(lambda: kg(val, xin), args.reps):.4f}")

    def scale_rowsum(r1, r2, blk, x, out):
        def body(i, j):
            out[i] += blk[(j - r2.start) * len(r1) + (i - r1.start)] * x[j]

        loopgen(r1, lambda i: loopgen(r2, lambda j: body(i, j)))

    t0 = time.perf_counter()
    fn = tstaging.stage_block_op(nu, scale_rowsum, extra_arrays=("x",), device=dev)
    secs = time.perf_counter() - t0
    want = np.zeros(nu.shape[0])
    for t in nu.blocks():  # a numpy loop over the blocks
        blk = nu.val[t.val_offset:t.val_offset + t.size].reshape(t.width, t.height).T
        want[t.row_start:t.row_end] += blk.astype(np.float64) @ x[t.col_start:t.col_end]
    xin, out0 = torch.as_tensor(x, device=dev), torch.zeros(nu.shape[0], device=dev)
    check64("stage_block_op scale_rowsum nu vs a numpy loop", fn(val, xin, out0), want)
    print(f"  stage_block_op scale_rowsum nu: staged in {secs:.2f} s, call "
          f"ms={median_ms(lambda: fn(val, xin, out0), args.reps):.4f}")
    del dense, warm, cold
    tcache.set_default_cache(None)
    tmp.cleanup()

    # -- K1 and K2 at the sweep's other tiles, as in phase 4 ------------------
    # (the tunes' picks among near-equal candidates vary from run to run, so
    # every tile the tuner may pick is timed)
    records = {}
    ext, flush = _build.load_kernels(), l2_flush(torch)
    for name, v in mats.items():
        val, x, X = inputs[name]
        for tile in tautotune.CUDA_TILES:
            if tile == (32, 32):
                continue
            o = tstaging.StagingOptions(backend="cuda", tile=tile)
            ks, km = tstaging.stage_spmv(v, o, device=dev), tstaging.stage_spmm(v, n_cols, o,
                                                                                 device=dev)
            tag = f"{name} float32 tile {tile[0]}x{tile[1]}"
            for kname, rec in time_kernels(args, torch, kref, ext, flush, ks, km, val,
                                           torch.as_tensor(x, device=dev),
                                           torch.as_tensor(X, device=dev), tag).items():
                records[(kname, name, tile)] = dict(rec, launches=launches[kname])
            tstaging.clear_cache()
    del flush
    torch.cuda.empty_cache()
    return records, winners


def time_kernels(args, torch, kref, ext, flush, ks, km, val, x, X, tag, profile=False):
    """K1 and K2 at the tables of the staged 'cuda' kernels ``ks`` (SpMV) and
    ``km`` (SpMM) on ``val``, with the schedules they built: each held
    against its plain version and timed beside it, its bound and the library
    call, after an L2 flush; in float32 the last timed launch must give the
    first one's bits. ``profile``: each kernel's own launches under
    torch.profiler too. Returns {kernel name: record}."""
    dev = val.device
    t = ks.tiled
    n_cols = X.shape[1]
    tiles = ks.pack(val)
    dt = tiles.dtype
    xp = torch.cat([x.new_zeros(1), x]).to(dt)[torch.as_tensor(t.x_src, device=dev)]
    Xp = torch.cat([X.new_zeros(1, n_cols), X]).to(dt)[torch.as_tensor(t.x_src, device=dev)]
    rows = torch.as_tensor(t.row_ids, device=dev)
    cols = torch.as_tensor(t.col_ids, device=dev)
    rptr = torch.as_tensor(t.row_ptr, device=dev)
    y = torch.empty(t.m_pad, dtype=dt, device=dev)
    ym = torch.empty(t.m_pad, n_cols, dtype=dt, device=dev)
    # the schedules the staged path built, and their scratch
    sv, sm = ks.schedules[dt], km.schedules[dt]
    pv = torch.empty(2 * sv.shape[0] * t.tm, dtype=torch.float32, device=dev)
    if sm is not None:
        pm = torch.empty(2 * sm.shape[0] * t.tm * n_cols, dtype=torch.float32, device=dev)
    else:  # the bfloat16 body walks row_ptr alone
        sm = pm = torch.empty(0, device=dev)
    records = {}
    for kname, launch, plain, rhs, out, xin, flops_per in (
        ("bsr_spmv", lambda: ext.bsr_spmv(tiles, rptr, cols, xp, y, sv, pv),
         lambda: kref.bsr_spmv_ref(tiles, rows, cols, xp, t.m_pad), xp.unsqueeze(1),
         y, xp, 2),
        ("bsr_spmm", lambda: ext.bsr_spmm(tiles, rptr, cols, Xp, ym, sm, pm),
         lambda: kref.bsr_spmm_ref(tiles, rows, cols, Xp, t.m_pad), Xp,
         ym, Xp, 2 * n_cols),
    ):
        launch()
        torch.cuda.synchronize()
        want = plain()
        err = check(f"{kname} {tag} kernel vs plain (main-path tables)", out, want, dt)
        first = out.clone()
        ms = median_ms(launch, args.reps, flush)
        if dt == torch.float32:  # the last timed launch against the first
            same_bits(f"{kname} {tag} main-path tables", first, out)
        del first
        if profile:  # the kernel's own launches, the cut row tiles' join beside it
            device_breakdown(torch, f"{kname} {tag} (L2 not flushed)", launch)
        plain_ms = median_ms(plain, args.reps, flush)
        # in the row's own dtype: (tm, tk) blocks, as the kernels take them
        lib_name = "sparse_bsr_tensor" if t.tm == t.tk else "sparse_csr_tensor"
        lib_ms, lib_txt = library_time(
            f"{kname} {tag} library call {lib_name}(...) @ x",
            lambda: bsr_call(torch, rptr, cols, tiles, (t.m_pad, t.k_pad), rhs),
            want, dt, args.reps, select=lambda r: r.reshape(want.shape), before=flush)
        del want
        need = sum(a.numel() * a.element_size() for a in (tiles, rptr, cols, xin, out))
        ops = flops_per * tiles.numel()
        bound = bound_fields(need, ops, dt)
        print(
            f"  {kname} {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_txt} {bound_text(bound, need, ops)} "
            f"roofline_share={bound['bound_ms'] / ms:.3f}"
        )
        records[kname] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              **bound)
    return records


# ---------------------------------------------------------------------- #
# phase 9: serving llama3-8b-sable
# ---------------------------------------------------------------------- #
SERVE_B, SERVE_P, SERVE_G = 8, 512, 64  # prompts, prompt tokens, new tokens
SERVE_TOL = 1e-4  # 2-layer float32 logits, cuda vs grouped, over max|logits|


def serve_modules():
    from repro_torch.configs import get_config
    from repro_torch.core import autotune as tautotune
    from repro_torch.core import cache as tcache
    from repro_torch.models import config as tconfig
    from repro_torch.models import layers as tlayers
    from repro_torch.models import transformer as ttr
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sparse import linear as tlin

    return dict(get_config=get_config, tautotune=tautotune, tcache=tcache, tconfig=tconfig,
                tlayers=tlayers, ttr=ttr, ServeEngine=ServeEngine, tlin=tlin)


def pin_strategy(m, patterns, backend: str, dev) -> None:
    """Store a plan naming ``backend`` for each pattern in the default plan
    cache and empty the in-process registry, so that the next engine loads
    them: the reference's own mechanism for a chosen strategy."""
    from repro_torch.core.staging import StagingOptions

    tcache, tlin = m["tcache"], m["tlin"]
    for p in patterns:
        h = tlin.pattern_hash(p)
        tcache.default_cache().store_plan(
            tcache.plan_key("linear", h, tcache.device_key(dev)),
            tcache.TuningPlan(kind="linear", structure_hash=h, device=tcache.device_key(dev),
                              options=StagingOptions(backend=backend, tile=(p.tm, p.tk)),
                              meta={"pinned": True}, source="heuristic"))
    tlin._STRATEGY_REGISTRY.clear()


def time_ffn_k2(args, torch, kops, kref, m, dev, cases=None, dtypes=None, label="phase 9a"):
    """K2 at the FFN shapes (896 tiles of 128 x 128; `in`: X (4096, T) ->
    (14336, T), `out`: X (14336, T) -> (4096, T)) at each (shape, T) of
    ``cases`` (default prefill T = 4096 and decode T = 8) in each of
    ``dtypes`` (default both), on the tables and the transposed tiles the
    cuda strategy builds: each held against its plain version, timed beside
    it, its bound and torch.sparse_bsr_tensor(...) @ X, after an L2 flush;
    and the per-call tile gather and transpose alone."""
    from repro_torch.kernels import _build

    tlin = m["tlin"]
    ext, flush = _build.load_kernels(), l2_flush(torch)
    cfg = m["get_config"]("llama3-8b-sable")
    pats = m["tlayers"].sable_patterns(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    cases = cases or (("prefill", SERVE_B * SERVE_P), ("decode", SERVE_B))
    dtypes = dtypes or (torch.bfloat16, torch.float32)
    records = {}
    print(f"{label}: K2 at llama3-8b-sable's FFN shapes (896 tiles of 128 x 128)")
    for pname, pat in pats.items():
        t = tlin._tables(pat, dev)
        for shape, T in cases:
            for dtype in dtypes:
                dname = str(dtype)[6:]
                tiles = (torch.randn((pat.n_tiles, pat.tm, pat.tk), generator=gen, device=dev)
                         / pat.d_in ** 0.5).to(dtype)
                X = torch.randn((pat.d_in, T), generator=gen, device=dev).to(dtype)
                tiles_t = tlin._transposed_tiles(tiles, t.order)
                sched = t.schedule(T, dtype)
                y = kops.bsr_spmm(tiles_t, t.row_ids, t.col_ids, X, m_pad=pat.d_out,
                                  row_ptr=t.row_ptr, schedule=sched, device=dev)
                torch.cuda.synchronize()
                plain = lambda: kref.bsr_spmm_ref(tiles_t, t.row_ids, t.col_ids, X,  # noqa: E731
                                                  pat.d_out)
                want = plain()
                tag = f"bsr_spmm ffn {pname} {shape} T={T} {dname}"
                err = check(f"{tag} kernel vs plain", y, want, dtype)
                if dtype == torch.float32:
                    partial = torch.empty(2 * sched.shape[0] * pat.tk * T, dtype=torch.float32,
                                          device=dev)
                else:
                    sched = partial = torch.empty(0, device=dev)
                launch = lambda: ext.bsr_spmm(tiles_t, t.row_ptr, t.col_ids, X, y,  # noqa: E731
                                              sched, partial)
                ms = median_ms(launch, args.reps, flush)
                plain_ms = median_ms(plain, args.reps, flush)
                lib_ms, lib_txt = library_time(
                    f"{tag} library call sparse_bsr_tensor(...) @ X",
                    lambda: bsr_call(torch, t.row_ptr, t.col_ids, tiles_t,
                                     (pat.d_out, pat.d_in), X),
                    want, dtype, args.reps, before=flush)
                tr_ms = median_ms(lambda: tlin._transposed_tiles(tiles, t.order), args.reps,
                                  flush)
                need = nbytes(tiles_t, t.row_ptr, t.col_ids, X, y)
                ops = 2 * tiles_t.numel() * T
                bound = bound_fields(need, ops, dtype)
                print(f"  {tag}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_txt} "
                      f"{bound_text(bound, need, ops)} roofline_share={bound['bound_ms'] / ms:.3f}"
                      f"; tile gather+transpose alone ms={tr_ms:.4f} "
                      f"({2 * nbytes(tiles)} B moved)")
                records[(pname, shape, dname)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                      library_ms=lib_ms, transpose_ms=tr_ms,
                                                      **bound)
                del tiles, X, tiles_t, y, want
        torch.cuda.empty_cache()
    return records


def check_two_layers(args, torch, kops, m, dev):
    """A 2-layer llama3-8b-sable at full width in float32: the prefill
    logits through cuda (K2) against those through grouped, both pinned by
    plans, at SERVE_TOL of max|logits|; K2 launches 3 times a layer."""
    tconfig = m["tconfig"]
    ttr = m["ttr"]
    cfg = replace(m["get_config"]("llama3-8b-sable"), compute_dtype="float32",
                  param_dtype="float32",
                  groups=tconfig.uniform_groups(2, tconfig.LayerSpec(mixer="gqa", ffn="dense")))
    pats = list(m["tlayers"].sable_patterns(cfg).values())
    gen = torch.Generator(device=dev).manual_seed(args.seed + 10)
    params = ttr.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_P), generator=gen, device=dev)
    logits = {}
    for strategy in ("grouped", "cuda"):
        pin_strategy(m, pats, strategy, dev)
        before = kops.launches["bsr_spmm"]
        with torch.inference_mode():
            logits[strategy], _ = ttr.prefill(params, cfg, prompts,
                                              ttr.init_cache(cfg, SERVE_B, SERVE_P, device=dev))
        torch.cuda.synchronize()
        n = kops.launches["bsr_spmm"] - before
        if n != (6 if strategy == "cuda" else 0):
            raise AssertionError(f"2-layer prefill through {strategy}: {n} K2 launches")
    err, rel = rel_err(logits["cuda"], logits["grouped"])
    ok = rel <= SERVE_TOL and bool(torch.isfinite(logits["cuda"]).all())
    print(f"  2 layers at full width, float32, prefill B={SERVE_B} P={SERVE_P}: logits through "
          f"cuda vs grouped max_abs_err={err:.3e} rel={rel:.3e} tol={SERVE_TOL:g} "
          f"{'ok' if ok else 'FAIL'} (K2 launched 6 times through cuda, 0 through grouped)")
    if not ok:
        raise AssertionError(f"2-layer float32 logits: relative error {rel:.3e}")
    del params, logits
    torch.cuda.empty_cache()


def serve_targets(m):
    """The serving path's layers, as (owner, attribute, label) ranges."""
    ttr, tlin = m["ttr"], m["tlin"]
    return [(ttr, "gqa_apply", "attention (gqa_apply)"),
            (ttr, "ffn_apply", "FFN (ffn_apply)"),
            (ttr, "_unembed", "head (final norm, lm_head)"),
            (ttr, "_embed", "embedding"),
            (tlin, "_transposed_tiles", "FFN: tile gather+transpose")]


class annotated:
    """Within the block, each (owner, attribute, label) target runs inside a
    torch.profiler.record_function range of its label (module attributes
    wrapped and restored), so that a profile attributes device time to
    them. Targets may share a label."""

    def __init__(self, torch, targets):
        self.targets = list(targets)
        self.torch = torch

    def __enter__(self):
        self.saved = []
        for mod, attr, label in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _label=label, **k):
                with self.torch.profiler.record_function(_label):
                    return _fn(*a, **k)

            setattr(mod, attr, wrapped)
        return list(dict.fromkeys(label for _, _, label in self.targets))

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def profile_ranges(torch, targets, fn, exclude=lambda name: False):
    """One call of ``fn`` (after one unprofiled) under torch.profiler inside
    ``annotated(targets)``. Returns (labels, {label: device ms of its
    operations' kernels, those whose name ``exclude`` picks left out},
    {kernel: [own, span, count]} of every kernel (see ``own_times``), busy
    ms, wall ms); None if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with annotated(torch, targets) as labels:
        fn()
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # a range's device time: the kernels of the operations inside it, each
    # operation's once. The profiler links a kernel to every event that
    # carries its operation's id, and an overhead event (a full launch
    # queue) carries it too, so device_time_total would count it twice.
    ranges = dict.fromkeys(labels, 0.0)
    seen = {label: set() for label in labels}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        ms = sum(k.duration for k in e.kernels if not exclude(k.name)) / 1e3
        p = e
        while p is not None:
            if p.name in ranges and e.id not in seen[p.name]:
                seen[p.name].add(e.id)
                ranges[p.name] += ms
            p = p.cpu_parent
    spans = [(e.time_range.start / 1e3, e.time_range.end / 1e3, e.name) for e in events
             if e.device_type == DeviceType.CUDA and e.name not in ranges
             and e.time_range.end > e.time_range.start]
    table, busy = own_times(spans)
    if busy == 0:
        return None
    return labels, ranges, table, busy, wall_ms


def serve_breakdown(torch, m, label, fn, extra=()):
    """One call of ``fn`` under torch.profiler with the serving path's
    layers as ranges (and ``extra`` (owner, attribute, label) ranges beside
    the layers, outside them): device time (each range's kernels, summed)
    by layer, K2's and the elementwise kernels' own time, and the device's
    busy share of the wall."""
    got = profile_ranges(torch, serve_targets(m) + list(extra), fn)
    if got is None:
        print(f"  profile {label}: device time not measured (the profiler saw none)")
        return None
    labels, ranges, table, busy, wall_ms = got
    # K2 is launched from its binding, which the profiler links to no range:
    # its kernels' own time goes to the FFN by name
    k2 = sum(row[0] for k, row in table.items() if "bsr_spmm" in k or "combine_kernel" in k)
    ranges[labels[1]] += k2
    elem = sum(row[0] for k, row in table.items() if "elementwise" in k.lower())
    top = sorted(((row[0], row[2], k) for k, row in table.items()), reverse=True)[:5]
    # the tile transpose's range lies inside the FFN's; the extras outside
    other = busy - sum(ranges[k] for k in labels[:4] + labels[5:])
    parts = "; ".join(f"{k} {v:.3f}" for k, v in ranges.items())
    print(f"  profile {label}: device busy {busy:.3f} of {wall_ms:.3f} ms wall (share "
          f"{busy / wall_ms:.3f}); by layer, ms: {parts}; FFN: K2 kernels {k2:.3f}; outside "
          f"those (norms, residual adds) {other:.3f}; elementwise kernels' own time "
          f"{elem:.3f}; top kernels: "
          + "; ".join(f"{k[:50]} x{n} {own:.3f}" for own, n, k in top))
    return dict(busy_ms=busy, wall_ms=wall_ms, k2_ms=k2, elementwise_ms=elem, **ranges)


def dispatch_host_time(tlin, p, dev, per_step: int, calls: int = 1000, rounds: int = 7):
    """Host clock, median of ``rounds`` rounds of ``calls``: the lookups each
    FFN matmul makes before its launch (the pattern's plan and its tables),
    and one hash of a pattern's fields, which each of those lookups paid
    before the pattern cached its hash."""
    fields = (p.d_in, p.d_out, p.tm, p.tk, p.rows, p.cols)

    def lookups():
        tlin.choose_matmul_strategy(p, device=dev)
        tlin._tables(p, dev)

    def per_call_us(fn):
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        return statistics.median(times)

    look, hashed = per_call_us(lookups), per_call_us(lambda: hash(fields))
    print(f"  FFN dispatch on the host (host clock, median of {rounds} x {calls}): plan and "
          f"tables lookup {look:.3f} us a matmul, {look * per_step / 1e3:.4f} ms a decode step "
          f"({per_step} matmuls); a hash of the pattern's fields ({p.n_tiles} tiles) "
          f"{hashed:.3f} us, {2 * hashed * per_step / 1e3:.4f} ms a step at two a matmul")


def step_bounds(cfg, params, batch, prompt, max_len):
    """Bytes and operations a decode step and the prefill need at least:
    every weight read once (the embedding's rows aside), the KV cache read
    over max_len positions (as the path attends over the whole cache), and
    the FFN tiles' per-call gather and transpose (read and write) beside."""
    kv = cfg.n_kv_heads * cfg.head_dim
    layers = cfg.n_layers
    es = 2  # bfloat16
    gp = params["groups"][0]["sub0"]
    attn = sum(v.numel() for v in gp["mixer"].values())
    ffn = sum(v.numel() for v in gp["ffn"].values())
    head = params["lm_head"].numel()
    weights = (attn + ffn + head) * es
    kv_bytes = 2 * layers * batch * max_len * kv * es
    transpose = 2 * ffn * es
    T = batch * prompt
    # projections and FFN over T tokens, scores and values over the whole
    # cache, the head at the last position
    prefill_ops = (2 * T * (attn + ffn) + layers * 4 * batch * cfg.n_heads * prompt
                   * max_len * cfg.head_dim + 2 * batch * cfg.d_model * cfg.vocab_size)
    return dict(weights=weights, kv=kv_bytes, transpose=transpose, prefill_ops=prefill_ops)


class temp_plans:
    """Within the block, the default plan cache is a new one in a temporary
    directory, and the in-process strategy registry starts empty: no plan
    from earlier runs or phases is read."""

    def __init__(self, m):
        self.m = m

    def __enter__(self):
        import tempfile

        self.tmp = tempfile.TemporaryDirectory(prefix="repro-serve-plans-")
        self.m["tcache"].set_default_cache(self.m["tcache"].PlanCache(self.tmp.name))
        self.m["tlin"]._STRATEGY_REGISTRY.clear()

    def __exit__(self, *exc):
        self.m["tcache"].set_default_cache(None)
        self.m["tlin"]._STRATEGY_REGISTRY.clear()
        self.tmp.cleanup()


def phase_serve(args, torch, kops, kref, dev):
    """Phase 9: llama3-8b-sable served at full width. Returns (K2's FFN
    records, the pinned-cuda serve's K2 launches and its tokens/s)."""
    m = serve_modules()
    records = time_ffn_k2(args, torch, kops, kref, m, dev)
    print("phase 9b: checks at full width")
    with temp_plans(m):
        check_two_layers(args, torch, kops, m, dev)
    with temp_plans(m):
        launches, tps = serve_llama(args, torch, kops, m, dev)
    return records, launches, tps


def serve_llama(args, torch, kops, m, dev):
    from repro_torch.tree import tree_leaves

    tcache, tlin, ttr, tautotune = m["tcache"], m["tlin"], m["ttr"], m["tautotune"]
    ServeEngine = m["ServeEngine"]
    cfg = replace(m["get_config"]("llama3-8b-sable"), param_dtype="bfloat16")
    pats = m["tlayers"].sable_patterns(cfg)
    B, P, G = SERVE_B, SERVE_P, SERVE_G
    max_len = P + G
    print(f"phase 9c: serve llama3-8b-sable at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; FFN matrices of {pats['in'].n_tiles} tiles of "
          f"{pats['in'].tm} x {pats['in'].tk}), params and compute in bfloat16; "
          f"B={B} prompts of {P} tokens, {G} greedy new tokens, max_len {max_len}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = ttr.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    gp = params["groups"][0]["sub0"]
    counts = {
        "attention": sum(v.numel() for v in gp["mixer"].values()),
        "FFN tiles": sum(v.numel() for v in gp["ffn"].values()),
        "embed and head": params["embed"].numel() + params["lm_head"].numel(),
    }
    total = sum(v.numel() for v in tree_leaves(params))
    print(f"  params: {total / 1e9:.4f} G ({', '.join(f'{k} {v / 1e9:.4f} G' for k, v in counts.items())}), "
          f"{total * 2 / 1e9:.3f} GB in bfloat16, drawn in {time.perf_counter() - t0:.2f} s")
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    b = step_bounds(cfg, params, B, P, max_len)
    bw = HBM_BYTES_PER_S / 1e3
    print(f"  decode-step bound: weights {b['weights'] / 1e9:.4f} GB + KV cache "
          f"{b['kv'] / 1e9:.4f} GB -> {(b['weights'] + b['kv']) / bw:.4f} ms (bytes); the "
          f"cuda strategy's per-call tile gather+transpose adds {b['transpose'] / 1e9:.4f} GB "
          f"-> {(b['weights'] + b['kv'] + b['transpose']) / bw:.4f} ms; prefill bound "
          f"{max(b['prefill_ops'] / 989e9, (b['weights'] + b['kv']) / bw):.4f} ms "
          f"({b['prefill_ops'] / 1e12:.2f} TFLOP)")

    # -- warmup: cold, then a warm restart --------------------------------------
    tautotune.reset_autotune_stats()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, params, max_len=max_len, device=dev)
    secs = time.perf_counter() - t0
    for name, p in pats.items():
        h = tlin.pattern_hash(p)
        plan = tcache.default_cache().load_plan(
            tcache.plan_key("linear", h, tcache.device_key(dev)))
        parts = ", ".join(f"{k} {v * 1e3:.4f}" for k, v in sorted(plan.timings.items()))
        print(f"  warmup, pattern {name} ({h}): candidates ms (host clock, median of 3, float32, "
              f"batch 8): {parts}; winner {plan.options.backend}")
    print(f"  warmup ({secs:.2f} s): warmup_stats={engine.warmup_stats} "
          f"benchmarks={tautotune.autotune_stats()['benchmarks']}")
    if engine.warmup_stats["warm_start"] or engine.warmup_stats["plans_staged"] != len(pats):
        raise AssertionError(f"the first warmup was not cold: {engine.warmup_stats}")
    tlin._STRATEGY_REGISTRY.clear()
    tautotune.reset_autotune_stats()
    warm = ServeEngine(cfg, params, max_len=max_len, device=dev)
    bench = tautotune.autotune_stats()["benchmarks"]
    print(f"  warm restart: warmup_stats={warm.warmup_stats} benchmarks={bench}")
    if not warm.warmup_stats["warm_start"] or warm.warmup_stats["plans_staged"] or bench:
        raise AssertionError(f"warm restart staged plans: {warm.warmup_stats}, {bench} benchmarks")
    if warm.sparse_plans != engine.sparse_plans:
        raise AssertionError(f"warm restart loaded {warm.sparse_plans}, not {engine.sparse_plans}")
    del warm

    # -- (a) the warmup's pick, (b) both patterns pinned to cuda -----------------
    outs, launches, tps = {}, {}, {}
    for tag in ("a", "b"):
        if tag == "b":
            pin_strategy(m, pats.values(), "cuda", dev)
            engine = ServeEngine(cfg, params, max_len=max_len, device=dev)
        picks = {n: tlin.choose_matmul_strategy(p, device=dev) for n, p in pats.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launches()
        out, stats = engine.generate(prompts, G)
        launches[tag] = dict(kops.launches)
        tps[tag] = stats["tokens_per_s"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        outs[tag] = out
        new = out[:, P:]
        if tuple(out.shape) != (B, P + G) or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
            raise AssertionError(f"serve ({tag}): tokens {tuple(out.shape)} out of range")
        n_k2 = launches[tag]["bsr_spmm"]
        # the in pattern carries two of a layer's three FFN matmuls (w1, w3)
        want_k2 = ((2 if picks["in"] == "cuda" else 0) + (picks["out"] == "cuda")) * (
            cfg.n_layers * G)
        print(f"  serve ({tag}) strategies {picks}: prefill ms={stats['prefill_s'] * 1e3:.3f} "
              f"decode ms/step={stats['decode_s'] * 1e3 / (G - 1):.3f} "
              f"tokens/s={stats['tokens_per_s']:.1f} (B x new tokens / decode s) "
              f"peak GB={peak:.3f}; K2 launches {n_k2} over {G} forwards "
              f"({n_k2 / G:g} a forward, expected {want_k2 // G})")
        if n_k2 != want_k2 or (tag == "b" and n_k2 == 0):
            raise AssertionError(f"serve ({tag}): {n_k2} K2 launches, expected {want_k2}")
        with torch.inference_mode():
            cache = ttr.init_cache(cfg, B, max_len, device=dev)
            serve_breakdown(torch, m, f"serve ({tag}) prefill B={B} P={P}",
                            lambda: engine._prefill(prompts, cache))
            tok = out[:, P:P + 1]
            serve_breakdown(torch, m, f"serve ({tag}) one decode step at position {P}",
                            lambda: engine._decode(tok, cache, P, 0.0, None))
            del cache
    dispatch_host_time(tlin, pats["in"], dev, 3 * cfg.n_layers)
    same = int((outs["a"][:, P:] == outs["b"][:, P:]).sum())
    first = int((outs["a"][:, P] == outs["b"][:, P]).sum())
    print(f"  serves (a) and (b): {same} of {B * G} greedy tokens agree; prefill top-1 agrees "
          f"on {first} of {B} prompts (reported, not gated: bfloat16 paths differ)")
    del params, engine, outs
    torch.cuda.empty_cache()
    return launches["b"]["bsr_spmm"], tps["b"]


# ---------------------------------------------------------------------- #
# phase 10: continuous batching of llama3-8b-sable
# ---------------------------------------------------------------------- #
CB_REQUESTS, CB_LANES, CB_PAGE, CB_MAX_LEN = 16, 8, 16, 576
CB_PROMPTS, CB_GENS = (128, 512), (16, 64)  # inclusive ranges, drawn from --seed
CB_PAGES_FROM = 200  # the page count tried first; fewer until the schedule evicts
# the 2-layer float32 check: a 32-token shared prefix and these suffixes
CB2_SUFFIXES, CB2_GENS = (40, 100, 64, 110, 20, 90), (12, 8, 16, 10, 14, 6)
CB2_LANES, CB2_MAX_LEN, CB2_CHUNK = 4, 160, 32
CB_PROFILE_P = 256  # prompt tokens of the profiled decode step's 8 lanes


def cb_drive(sched, reqs, timed=None):
    """Submit request i just before step i (each arrives one step after the
    one before, so admissions happen mid-decode) and step until every
    request finished. ``timed`` gets (event, wall ms, peak GB so far) per
    step, the step ended by a device synchronize."""
    import torch

    i = 0
    while i < len(reqs) or sched.pending():
        if i < len(reqs):
            sched.submit(**reqs[i])
            i += 1
        t0 = time.perf_counter()
        ev = sched.step()
        if timed is not None:
            torch.cuda.synchronize()
            timed.append((ev, (time.perf_counter() - t0) * 1e3,
                          torch.cuda.max_memory_allocated() / 1e9))
        if sched.stats["steps"] > 100_000:
            raise AssertionError("the scheduler did not drain")
    return sched.requests


def cb_schedule(m, torch, reqs, num_pages, **kw):
    """The scheduler's stats and transcript for ``reqs`` on a 2-layer toy
    model on the CPU (llama3.2-3b reduced, the full vocabulary): the
    schedule depends on lengths and token ids alone, never on the params, so
    it is the card's."""
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    cfg = replace(m["get_config"]("llama3.2-3b", reduced=True), compute_dtype="float32",
                  param_dtype="float32", vocab_size=128256)
    params = m["ttr"].init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sched = ContinuousBatchingScheduler(cfg, params, num_pages=num_pages, device="cpu",
                                        clock=iter(range(10**9)).__next__, **kw)
    cb_drive(sched, [{k: v for k, v in r.items() if k != "patterns"} for r in reqs])
    return sched.stats, sched.transcript


def cb_pages(m, torch, reqs, start, configs):
    """The largest page count from ``start`` down whose schedule evicts and
    resumes at least once under every one of ``configs`` (scheduler
    kwargs). Returns (pages, {config index: (stats, transcript)})."""
    for n in range(start, 0, -8):
        sims = {i: cb_schedule(m, torch, reqs, n, **kw) for i, kw in enumerate(configs)}
        if all(st["evictions"] >= 1 and st["resumes"] >= 1 for st, _ in sims.values()):
            return n, sims
    raise AssertionError("no page count makes the schedule evict")


def cb_logit_rows(torch, ttr, cfg, params, prompt, gens, max_len, dev):
    """The port's single-sequence path (prefill, then decode_step at int
    positions over a max_len-wide cache, greedy): float32 logits rows."""
    with torch.inference_mode():
        cache = ttr.init_cache(cfg, 1, max_len, device=dev)
        lg, cache = ttr.prefill(params, cfg, torch.as_tensor(prompt, device=dev)[None].long(),
                                cache)
        rows = [lg[0, -1].float()]
        for j in range(gens - 1):
            nxt = torch.argmax(rows[-1])[None, None]
            lg, cache = ttr.decode_step(params, cfg, nxt, cache, len(prompt) + j)
            rows.append(lg[0, 0].float())
    return rows


def cb_check_two_layers(args, torch, kops, m, dev):
    """Check 1: a 2-layer llama3-8b-sable at full width in float32 (TF32
    off), both patterns pinned to K2: six requests (a shared 32-token
    prefix) through schedulers whose page count forces an eviction, with
    prefix sharing and chunked prefill both on, then both off. Every
    request's greedy tokens equal generate's on it alone, and every step's
    logits agree with the single-sequence path's within SERVE_TOL of
    max|logits|."""
    import numpy as np

    tconfig, ttr = m["tconfig"], m["ttr"]
    cfg = replace(m["get_config"]("llama3-8b-sable"), compute_dtype="float32",
                  param_dtype="float32",
                  groups=tconfig.uniform_groups(2, tconfig.LayerSpec(mixer="gqa", ffn="dense")))
    pin_strategy(m, m["tlayers"].sable_patterns(cfg).values(), "cuda", dev)
    params = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed + 11),
                             device=dev)
    eng = m["ServeEngine"](cfg, params, max_len=CB2_MAX_LEN, device=dev)
    if set(eng.sparse_plans.values()) != {"cuda"}:
        raise AssertionError(f"2-layer check: strategies {eng.sparse_plans}, not cuda")
    rng = np.random.default_rng(args.seed + 11)
    shared = rng.integers(0, cfg.vocab_size, 32)
    reqs = [dict(prompt=np.concatenate([shared, rng.integers(0, cfg.vocab_size, k)]).astype(
                 np.int32), max_new_tokens=g, rid=f"c{i}")
            for i, (k, g) in enumerate(zip(CB2_SUFFIXES, CB2_GENS))]
    configs = [dict(max_len=CB2_MAX_LEN, page_size=CB_PAGE, max_batch=CB2_LANES,
                    prefix_sharing=on, chunked_prefill=on, prefill_chunk=CB2_CHUNK)
               for on in (True, False)]
    pages, _ = cb_pages(m, torch, reqs, 4 * CB2_MAX_LEN // CB_PAGE, configs)
    want = {}
    for r in reqs:
        out, _ = eng.generate(r["prompt"][None], r["max_new_tokens"])
        rows = cb_logit_rows(torch, ttr, cfg, params, r["prompt"], r["max_new_tokens"],
                             CB2_MAX_LEN, dev)
        want[r["rid"]] = (out[0, len(r["prompt"]):].tolist(), rows)
    for kw in configs:
        sched = eng.make_scheduler(num_pages=pages, record_logits=True, **kw)
        before = kops.launches["bsr_spmm"]
        cb_drive(sched, reqs)
        torch.cuda.synchronize()
        n_k2 = kops.launches["bsr_spmm"] - before
        worst, same = 0.0, True
        for rid, (tokens, rows) in want.items():
            req = sched.requests[rid]
            same &= req.tokens == tokens
            for got, ref in zip(req.logits, rows):
                worst = max(worst, rel_err(torch.as_tensor(got, device=dev), ref)[1])
        st = sched.stats
        ok = same and worst <= SERVE_TOL and st["evictions"] >= 1 and n_k2 > 0
        print(f"  2 layers, float32, {pages} pages of {CB_PAGE}, {CB2_LANES} lanes, prefix "
              f"sharing and chunked prefill {'on' if kw['prefix_sharing'] else 'off'}: "
              f"evictions {st['evictions']} resumes {st['resumes']} prefix_hits "
              f"{st['prefix_hits']} pages_shared {st['pages_shared']} cow_copies "
              f"{st['cow_copies']} prefill_chunks {st['prefill_chunks']}; K2 launches {n_k2}; "
              f"greedy tokens equal generate's: {same}; logits rel err max {worst:.3e} "
              f"tol {SERVE_TOL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("continuous batching, 2-layer float32 check failed")
    del params, eng, want
    torch.cuda.empty_cache()


def cb_check_cache(args, torch, m, dev):
    """Check 2: the paged cache of the full-width model on the card, in
    bfloat16: write_prefill of a random dense cache, then gather, read_dense,
    evict to host and resume give back the same bits, and the zero page
    stays zero."""
    from repro_torch.serve.paged_cache import PagedKVCache
    from repro_torch.tree import flatten, unflatten

    cfg = replace(m["get_config"]("llama3-8b-sable"), param_dtype="bfloat16")
    kv = PagedKVCache(cfg, num_pages=40, page_size=CB_PAGE, max_len=CB_MAX_LEN, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 12)
    n = 500
    leaves, spec = flatten(m["ttr"].init_cache(cfg, 1, n, device=dev))
    dense = [torch.randn(tuple(x.shape), generator=gen, device=dev).to(x.dtype) for x in leaves]
    kv.alloc_seq("a", n, zero=False)
    kv.write_prefill("a", unflatten(spec, dense), n)
    ok = all(torch.equal(a, b) for a, b in zip(flatten(kv.read_dense("a"))[0], dense))
    view = flatten(kv.gather(["a", None]))[0]
    ok &= all(torch.equal(v[:, :1, :n], d) and not bool(v[:, :1, n:].any())
              and not bool(v[:, 1].any()) for v, d in zip(view, dense))
    kv.evict("a")
    held = kv.allocator.num_held
    ok &= kv.resume("a") and held == 0
    ok &= all(torch.equal(a, b) for a, b in zip(flatten(kv.gather(["a", None]))[0], view))
    ok &= not any(bool(a[kv.zero_page].any()) for a in kv._arenas)
    print(f"  paged cache on the card ({cfg.n_layers} layers, {n} tokens, bfloat16, arenas "
          f"{tuple(kv._arenas[0].shape)} x {len(kv._arenas)}): write_prefill, read_dense, gather, "
          f"evict, resume give the same bits, zero page zero: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("paged cache round trip on the card failed")
    del kv, dense, view
    torch.cuda.empty_cache()


def phase_continuous(args, torch, kops, dev, serve_tps):
    """Phase 10: llama3-8b-sable served by the continuous-batching
    scheduler at full width, K2 pinned. Returns K2's cb_* JSON keys."""
    import numpy as np

    from repro_torch.serve.paged_cache import PagedKVCache

    m = serve_modules()
    ttr, tlin = m["ttr"], m["tlin"]
    print("phase 10: continuous batching of llama3-8b-sable (paged KV cache, scheduler, "
          "ServeEngine.serve)")
    with temp_plans(m):
        cb_check_two_layers(args, torch, kops, m, dev)
    cb_check_cache(args, torch, m, dev)

    cfg = replace(m["get_config"]("llama3-8b-sable"), param_dtype="bfloat16")
    pats = tuple(m["tlayers"].sable_patterns(cfg).values())
    rng = np.random.default_rng(args.seed + 13)
    lengths = rng.integers(CB_PROMPTS[0], CB_PROMPTS[1] + 1, CB_REQUESTS)
    gens = rng.integers(CB_GENS[0], CB_GENS[1] + 1, CB_REQUESTS)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, int(p)).astype(np.int32),
                 max_new_tokens=int(g), rid=f"r{i}", patterns=pats)
            for i, (p, g) in enumerate(zip(lengths, gens))]
    kw = dict(max_len=CB_MAX_LEN, page_size=CB_PAGE, max_batch=CB_LANES)
    t0 = time.perf_counter()
    pages, sims = cb_pages(m, torch, reqs, CB_PAGES_FROM, [kw])
    sim_stats, sim_transcript = sims[0]
    print(f"  traffic: {CB_REQUESTS} requests, prompts {int(lengths.min())}-{int(lengths.max())} "
          f"tokens, {int(gens.min())}-{int(gens.max())} greedy new tokens, one arriving a step; "
          f"{CB_LANES} lanes, page_size {CB_PAGE}, max_len {CB_MAX_LEN}; {pages} pages "
          f"({pages * 2 * cfg.n_layers * CB_PAGE * cfg.n_kv_heads * cfg.head_dim * 2 / 1e9:.3f} "
          f"GB of arena), the largest count from {CB_PAGES_FROM} down whose schedule evicts "
          f"(found on the CPU in {time.perf_counter() - t0:.1f} s: {sim_stats['evictions']} "
          f"evictions)")

    with temp_plans(m):
        pin_strategy(m, pats, "cuda", dev)
        params = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                                 device=dev)
        eng = m["ServeEngine"](cfg, params, max_len=CB_MAX_LEN, device=dev)
        if set(eng.sparse_plans.values()) != {"cuda"}:
            raise AssertionError(f"strategies {eng.sparse_plans}, not cuda")
        sched = eng.make_scheduler(num_pages=pages, **kw)
        spans = []

        def timed(fn):
            def run(*a, **k):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                spans.append((sched.stats["steps"], start, end))
                return out
            return run

        sched.kv.gather = timed(sched.kv.gather)
        sched.kv.append_token = timed(sched.kv.append_token)
        steps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        kops.reset_launches()
        t0 = time.perf_counter()
        cb_drive(sched, reqs, timed=steps)
        wall = time.perf_counter() - t0
        n_k2 = kops.launches["bsr_spmm"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        st = sched.stats
        forwards = sum(1 for ev, _, _ in steps if ev["running"])
        prefills = st["admissions"] - st["resumes"]
        want_k2 = 3 * cfg.n_layers * (forwards + prefills)
        pure = [i for i, (ev, _, _) in enumerate(steps) if ev["running"] and not (
            ev["admitted"] or ev["resumed"] or ev["evicted"])]
        top = next(i for i, (_, _, gb) in enumerate(steps) if gb == steps[-1][2])
        ev_top = steps[top][0]
        step_ms = statistics.median(steps[i][1] for i in pure)
        per_step = {}
        for k, a, b in spans:
            per_step[k] = per_step.get(k, 0.0) + a.elapsed_time(b)
        gs_ms = statistics.median(per_step[i] for i in pure)
        print(f"  served {st['finished']} requests in {wall:.3f} s: {st['finished'] / wall:.3f} "
              f"requests/s, {st['decode_tokens'] / wall:.1f} decode tokens/s; steps "
              f"{st['steps']} (decode forwards {forwards}, median pure decode step "
              f"{step_ms:.3f} ms over {len(pure)}), admissions {st['admissions']} (prefills "
              f"{prefills}), evictions {st['evictions']}, resumes {st['resumes']}; "
              f"gather+scatter {gs_ms:.3f} ms a decode step (CUDA events, median); peak "
              f"{peak:.3f} GB ({held:.3f} held before the run; reached at step {top}: admitted "
              f"{ev_top['admitted']}, resumed {ev_top['resumed']}, {len(ev_top['running'])} "
              f"lanes decoding); K2 launches {n_k2} (96 x (forwards + prefills) = {want_k2}); "
              f"phase 9's generate (b): {serve_tps:.1f} tokens/s")
        checks = {
            "all finished": st["finished"] == CB_REQUESTS,
            "evicted and resumed": st["evictions"] >= 1 and st["resumes"] >= 1,
            "K2 launches": n_k2 >= want_k2 > 0,
            "the CPU schedule": sched.transcript == sim_transcript,
        }
        outs = {}
        for r in reqs[:4]:
            out, _ = eng.generate(r["prompt"][None], r["max_new_tokens"])
            outs[r["rid"]] = (out[0, len(r["prompt"]):].tolist(), sched.requests[r["rid"]].tokens)
        agree = sum(sum(a == b for a, b in zip(x, y)) for x, y in outs.values())
        total = sum(len(x) for x, _ in outs.values())
        print(f"  greedy tokens of requests r0-r3 that equal generate's on each alone: {agree} "
              f"of {total} (reported, not gated: bfloat16 paths differ)")

        # check 4: a restart on the same plan store stages nothing
        staged_first = st["plans_staged"]
        tlin._STRATEGY_REGISTRY.clear()
        warm = m["ServeEngine"](cfg, params, max_len=CB_MAX_LEN, device=dev)
        sched2 = warm.make_scheduler(num_pages=pages, **kw)
        cb_drive(sched2, [dict(r, max_new_tokens=4) for r in reqs[:2]])
        checks["warm restart stages 0"] = (sched2.stats["plans_staged"] == 0
                                           and warm.warmup_stats["plans_staged"] == 0)
        print(f"  plans staged: first scheduler {staged_first}, a second one on the same plan "
              f"store {sched2.stats['plans_staged']} (engine warmup {warm.warmup_stats})")
        del warm, sched2

        # one decode step of 8 lanes under the profiler
        sched3 = eng.make_scheduler(num_pages=pages, **kw)
        for i in range(CB_LANES):
            sched3.submit(rng.integers(0, cfg.vocab_size, CB_PROFILE_P), 8, rid=f"p{i}")
        sched3.step()  # admits and prefills all eight, decodes once
        prof = serve_breakdown(
            torch, m, f"one continuous-batching decode step, {CB_LANES} lanes at position "
            f"{CB_PROFILE_P + 1}", sched3.step,
            extra=[(PagedKVCache, "gather", "paged: gather view"),
                   (PagedKVCache, "append_token", "paged: scatter (append_token)")])
        rids = [r.rid for r in sched3.lanes]
        g_ms = median_ms(lambda: sched3.kv.gather(rids), args.reps)
        g_bytes = len(rids) * sched3.kv.view_pages * sum(a[0].numel() * a.element_size()
                                                         for a in sched3.kv._arenas)
        g_bound = 2 * g_bytes / HBM_BYTES_PER_S * 1e3
        # the same copy over 8-byte words (a lever for later: the index
        # kernel's per-element cost is paid per 2-byte element above)
        tables = sched3.kv._index([sched3.kv._full_table(r) for r in rids]).reshape(
            len(rids), -1)
        wide_ms = median_ms(lambda: [a.view(torch.int64).movedim(1, 0)[:, tables]
                                     for a in sched3.kv._arenas], args.reps)
        print(f"  the paged gather alone, {len(rids)} lanes x {sched3.kv.view_pages} pages: "
              f"ms={g_ms:.4f} (CUDA events, median of {args.reps}); it reads and writes "
              f"{g_bytes / 1e9:.4f} GB: bound {g_bound:.4f} ms (bytes); the same index over "
              f"int64 views of the arenas ms={wide_ms:.4f}")
        del sched3, sched, eng, params
    torch.cuda.empty_cache()
    failed = [k for k, ok in checks.items() if not ok]
    print(f"  checks: {', '.join(f'{k} {ok}' for k, ok in checks.items())}")
    if failed:
        raise AssertionError(f"continuous batching: {failed} failed")
    return dict(cb_launches=n_k2, cb_decode_step_ms=step_ms, cb_gather_scatter_ms=gs_ms,
                cb_gather_ms=g_ms, cb_gather_bound_ms=g_bound, cb_gather_int64_ms=wide_ms,
                cb_busy_ms=None if prof is None else prof["busy_ms"])


# ---------------------------------------------------------------------- #
# phase 11: serving the MoE models (DeepSeek-V2 with MLA, llama4-scout)
# ---------------------------------------------------------------------- #
DS, L4 = "deepseek-v2-236b", "llama4-scout-17b-a16e"
DS_MOE_LAYERS = 4  # the served DeepSeek-V2: its dense layer 0 and 4 of its 59 MoE layers
DS_B, DS_P, DS_G = 4, 512, 32  # generate: prompts, prompt tokens, greedy new tokens
DS_REQUESTS, DS_LANES, DS_PAGE = 8, 4, 16  # serve
DS_PROMPTS, DS_GENS = (128, 512), (16, 32)  # inclusive ranges, drawn from --seed
L4_LAYERS, L4_B, L4_P, L4_G = 2, 4, 256, 8  # llama4-scout's generate
L4_SHAPES = {"prefill": (4, 512), "decode": (8, 1)}  # K3 and K2 at llama4-scout's tables
CHECK_B, CHECK_P, CHECK_STEPS = 2, 256, 4  # the float32 checks at full width


def moe_model(arch, moe_layers, dtype):
    """``arch`` at its published widths, dropless, params and compute in
    ``dtype``, cut in depth: DeepSeek-V2 keeps its dense layer 0 and
    ``moe_layers`` of its MoE layers, llama4-scout ``moe_layers`` layers."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import LayerSpec, uniform_groups

    cfg = get_config(arch)
    if arch == DS:
        g0, g1 = cfg.groups
        groups = (g0, replace(g1, repeat=moe_layers))
    else:
        groups = uniform_groups(moe_layers, LayerSpec(mixer="gqa", ffn="moe"))
    return replace(cfg, groups=groups, param_dtype=dtype, compute_dtype=dtype,
                   moe=replace(cfg.moe, dropless=True))


def moe_layers(cfg) -> int:
    return sum(g.repeat for g in cfg.groups for s in g.layers if s.ffn == "moe")


def param_counts(cfg, params) -> str:
    """The params by part: a layer of each kind (MoE, Mamba, dense; a group
    of several kinds by sub-layer), embed and head."""
    from repro_torch.tree import tree_leaves

    total = sum(v.numel() for v in tree_leaves(params))
    parts = {"total": total, "embed and head": params["embed"].numel()
             + (params["lm_head"].numel() if "lm_head" in params else 0)}
    for g, gp in zip(cfg.groups, params["groups"]):
        for j, s in enumerate(g.layers):
            n = sum(v.numel() for v in tree_leaves(gp[f"sub{j}"])) // g.repeat
            kind = f"a {s.mixer} + {s.ffn} layer"
            parts[kind] = n
    es = params["embed"].element_size()
    return (", ".join(f"{k} {v / 1e9:.4f} G" for k, v in parts.items())
            + f"; {total * es / 1e9:.3f} GB")


def l4_kernels(args, torch, kops, kref, dev):
    """11a: K3 and K2 at llama4-scout's dropless tables (16 experts of d_ff
    8192, top-1, d_model 5120: bn = tk = 8192), at prefill (B=4, S=512) and
    decode (B=8), in both dtypes: each held against its plain version and
    timed after an L2 flush beside its bound, the plain version and the
    library call; in float32 a second launch gives the same bits."""
    from repro_torch.models import moe as tmoe

    cfg = moe_model(L4, 1, "float32")
    flush = l2_flush(torch)
    records = {}
    print(f"phase 11a: K3 and K2 at llama4-scout's tables ({cfg.moe.num_experts} experts of "
          f"d_ff {cfg.moe.d_ff}, top-{cfg.moe.top_k}, d_model {cfg.d_model}; median of "
          f"{args.reps} calls, CUDA events, each after an L2 flush)")
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
        p = tmoe.moe_init(gen, cfg, dtype=dtype, device=dev)
        for name, (B, S) in L4_SHAPES.items():
            x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(dtype)
            a, topo, _, _ = sdd_tables(tmoe, p, x, cfg)
            records[("bsr_sdd", name, str(dtype))] = time_sdd(
                args, torch, kops, kref, p, a, topo, f"llama4-scout {name}", flush, n_sample=12)
            records[("bsr_spmm", name, str(dtype))] = time_dsd(
                args, torch, kops, kref, p, a, topo, f"llama4-scout {name}", flush, n_panels=2)
            del a, topo, x
            torch.cuda.empty_cache()
        del p
        torch.cuda.empty_cache()
    return records


def check_moe_model(args, torch, kops, m, dev, arch, n_moe):
    """11b: ``arch`` at full width in float32 (TF32 off), cut to ``n_moe``
    MoE layers (see ``check_model``)."""
    mixer = "absorbed MLA" if arch == DS else "GQA"
    check_model(args, torch, kops, m, dev, moe_model(arch, n_moe, "float32"), arch, mixer,
                CHECK_B, CHECK_P, CHECK_STEPS, seed=args.seed + 21)


def check_model(args, torch, kops, m, dev, cfg, label, mixer, B, P, n, seed, cf=None):
    """A float32 model at full width (TF32 off): with MoE layers, the prefill
    logits through the dropless path (K3 twice and K2 once a MoE layer) match
    the capacity path with capacity_factor ``cf`` (default E / top_k; either
    drops nothing) within SERVE_TOL of max|logits|; ``n`` greedy decode steps
    (``mixer``) give the logits of a prefill over the same longer sequence,
    and the same tokens."""
    ttr = m["ttr"]
    mc = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = ttr.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    want_k = moe_layers(cfg)
    with torch.inference_mode():
        before = dict(kops.launches)
        lg, cache = ttr.prefill(params, cfg, prompts, ttr.init_cache(cfg, B, P + n, device=dev))
        torch.cuda.synchronize()
        k3, k2 = (kops.launches[k] - before[k] for k in ("bsr_sdd", "bsr_spmm"))
        rel_cap, cap_text = 0.0, ""
        if want_k:
            cf = mc.num_experts / mc.top_k if cf is None else cf
            cap = replace(cfg, moe=replace(mc, dropless=False, capacity_factor=cf))
            lc, _ = ttr.prefill(params, cap, prompts, ttr.init_cache(cap, B, P, device=dev))
            _, rel_cap = rel_err(lg, lc)
            cap_text = f"prefill logits dropless vs capacity path (cf {cf:g}) rel={rel_cap:.3e}; "
            del lc
        finite = bool(torch.isfinite(lg).all())
        seq, worst, same = prompts, 0.0, True
        for i in range(n):
            nxt = torch.argmax(lg[:, -1].float(), dim=-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
            lg, cache = ttr.decode_step(params, cfg, nxt, cache, P + i)
            want, _ = ttr.prefill(params, cfg, seq, ttr.init_cache(cfg, B, P + i + 1,
                                                                   device=dev))
            worst = max(worst, rel_err(lg, want)[1])
            same &= bool(torch.equal(lg[:, -1].argmax(-1), want[:, -1].argmax(-1)))
    ok = (finite and rel_cap <= SERVE_TOL and worst <= SERVE_TOL and same
          and (k3, k2) == (2 * want_k, want_k))
    print(f"  {label}, {cfg.n_layers}-layer at full width, float32 ({param_counts(cfg, params)})"
          f", B={B} P={P}: {cap_text}{n} greedy decode steps ({mixer}) vs a prefill over the "
          f"longer sequence: rel max {worst:.3e}, tokens equal: {same}; tol {SERVE_TOL:g}; K3/K2 "
          f"launches of the dropless prefill {k3}/{k2} (expected {2 * want_k}/{want_k}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the float32 full-width check failed")
    del params, cache, lg, want
    torch.cuda.empty_cache()


def moe_targets(m):
    """DeepSeek-V2's layers, as (owner, attribute, label) ranges."""
    from repro_torch.models import moe as tmoe

    ttr = m["ttr"]
    return [(ttr, "mla_apply", "MLA attention"), (tmoe, "_route", "router and dispatch"),
            (tmoe, "_dispatch", "router and dispatch"),
            (tmoe, "_dropless_ffn", "expert FFN glue (topology, activation)"),
            (tmoe, "_combine", "combine"), (tmoe, "_shared_experts", "shared experts"),
            (ttr, "ffn_apply", "dense FFN"), (ttr, "_unembed", "head (final norm, lm_head)"),
            (ttr, "_embed", "embedding")]


def is_k3(name: str) -> bool:
    return "bsr_sdd" in name


def is_k2(name: str) -> bool:
    return "bsr_spmm" in name or "combine_kernel" in name


def moe_breakdown(torch, m, label, fn):
    """One call of ``fn`` under torch.profiler with the MoE model's layers
    as ranges: device ms by layer, K3's and K2's own time (by kernel name,
    kept out of the ranges), the rest (norms, residual adds) and the
    device's busy share of the wall."""
    got = profile_ranges(torch, moe_targets(m), fn, exclude=lambda k: is_k3(k) or is_k2(k))
    if got is None:
        print(f"  profile {label}: device time not measured (the profiler saw none)")
        return None
    _, ranges, table, busy, wall_ms = got
    k3 = sum(row[0] for k, row in table.items() if is_k3(k))
    k2 = sum(row[0] for k, row in table.items() if is_k2(k))
    rest = busy - sum(ranges.values()) - k3 - k2
    parts = "; ".join(f"{k} {v:.3f}" for k, v in ranges.items())
    top = sorted(((row[0], row[2], k) for k, row in table.items()), reverse=True)[:5]
    print(f"  profile {label}: device busy {busy:.3f} of {wall_ms:.3f} ms wall (share "
          f"{busy / wall_ms:.3f}); ms: {parts}; K3 {k3:.3f}; K2 {k2:.3f}; rest (norms, "
          f"residual adds) {rest:.3f}; top kernels: "
          + "; ".join(f"{k[:50]} x{n} {own:.3f}" for own, n, k in top))
    return dict(busy_ms=busy, wall_ms=wall_ms, k3_ms=k3, k2_ms=k2, **ranges)


def first_moe_input(ttr, fn):
    """Run ``fn`` and return (params, input) of its first moe_apply call."""
    real, got = ttr.moe_apply, []

    def spy(p, x, cfg, **kw):
        if not got:
            got.append((p, x))
        return real(p, x, cfg, **kw)

    ttr.moe_apply = spy
    try:
        fn()
    finally:
        ttr.moe_apply = real
    return got[0]


def serve_ds(args, torch, kops, kref, m, dev):
    """11c: DeepSeek-V2 in bfloat16 at its published widths, cut to its
    dense layer 0 and DS_MOE_LAYERS MoE layers, dropless, through
    ServeEngine.generate. Returns (engine, K3/K2 records at the served
    tables, generate's launches, tokens/s)."""
    from repro_torch.models import moe as tmoe

    ttr = m["ttr"]
    cfg = moe_model(DS, DS_MOE_LAYERS, "bfloat16")
    B, P, G = DS_B, DS_P, DS_G
    n_moe = moe_layers(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = ttr.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    print(f"phase 11c: serve DeepSeek-V2-236B at its published widths cut to {cfg.n_layers} "
          f"layers (layer 0 dense, {n_moe} MoE), MLA, dropless, bfloat16; params "
          f"{param_counts(cfg, params)}, drawn in {time.perf_counter() - t0:.2f} s; B={B} "
          f"prompts of {P} tokens, {G} greedy new tokens, max_len {P + G}")
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    engine = m["ServeEngine"](cfg, params, max_len=P + G, device=dev)
    if engine.patterns or engine.warmup_stats["plans_staged"]:
        raise AssertionError(f"the warmup staged plans: {engine.warmup_stats}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    out, stats = engine.generate(prompts, G)
    launches = {k: kops.launches[k] for k in ("bsr_sdd", "bsr_spmm")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    new = out[:, P:]
    want = {"bsr_sdd": 2 * n_moe * G, "bsr_spmm": n_moe * G}  # G forwards
    print(f"  generate: prefill ms={stats['prefill_s'] * 1e3:.3f} decode ms/step="
          f"{stats['decode_s'] * 1e3 / (G - 1):.3f} tokens/s={stats['tokens_per_s']:.1f} "
          f"(B x new tokens / decode s) peak GB={peak:.3f}; K3/K2 launches "
          f"{launches['bsr_sdd']}/{launches['bsr_spmm']} over {G} forwards (expected "
          f"{want['bsr_sdd']}/{want['bsr_spmm']}: 2 and 1 a MoE layer a forward)")
    if tuple(out.shape) != (B, P + G) or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
        raise AssertionError(f"generate: tokens {tuple(out.shape)} out of range")
    if launches != want:
        raise AssertionError(f"generate: launches {launches}, expected {want}")

    records = {}
    with torch.inference_mode():
        cache = ttr.init_cache(cfg, B, P + G, device=dev)
        moe_breakdown(torch, m, f"DeepSeek-V2 prefill B={B} P={P}",
                      lambda: engine._prefill(prompts, cache))
        tok = out[:, P:P + 1]
        moe_breakdown(torch, m, f"DeepSeek-V2 one decode step at position {P}",
                      lambda: engine._decode(tok, cache, P, 0.0, None))
        # K3 and K2 at the served model's own tables: the first MoE layer's
        flush = l2_flush(torch)
        for name, fn in (("prefill", lambda: engine._prefill(prompts, cache)),
                         ("decode", lambda: engine._decode(tok, cache, P, 0.0, None))):
            p, x = first_moe_input(ttr, fn)
            a, topo, _, _ = sdd_tables(tmoe, p, x, cfg)
            tag = f"DeepSeek-V2 served {name}"
            records[("bsr_sdd", name)] = time_sdd(args, torch, kops, kref, p, a, topo, tag,
                                                  flush)
            records[("bsr_spmm", name)] = time_dsd(args, torch, kops, kref, p, a, topo, tag,
                                                   flush)
            del a, topo, x
        del cache
    torch.cuda.empty_cache()
    return engine, records, launches, stats["tokens_per_s"]


def serve_ds_continuous(args, torch, kops, m, dev, engine, generate_tps):
    """11d: the same model through ServeEngine.serve: DS_REQUESTS requests
    on DS_LANES lanes, the largest page count whose schedule evicts (found
    on the CPU, as phase 10 finds it). Returns the run's K3/K2 launches."""
    import numpy as np

    cfg = engine.cfg
    n_moe = moe_layers(cfg)
    rng = np.random.default_rng(args.seed + 14)
    lengths = rng.integers(DS_PROMPTS[0], DS_PROMPTS[1] + 1, DS_REQUESTS)
    gens = rng.integers(DS_GENS[0], DS_GENS[1] + 1, DS_REQUESTS)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, int(p)).astype(np.int32),
                 max_new_tokens=int(g), rid=f"d{i}")
            for i, (p, g) in enumerate(zip(lengths, gens))]
    max_len = DS_PROMPTS[1] + DS_GENS[1]
    kw = dict(max_len=max_len, page_size=DS_PAGE, max_batch=DS_LANES)
    t0 = time.perf_counter()
    start = DS_LANES * -(-max_len // DS_PAGE)
    pages, sims = cb_pages(m, torch, reqs, start, [kw])
    sim_stats, sim_transcript = sims[0]
    print(f"phase 11d: the same model through ServeEngine.serve: {DS_REQUESTS} requests, prompts "
          f"{int(lengths.min())}-{int(lengths.max())} tokens, {int(gens.min())}-"
          f"{int(gens.max())} greedy new tokens, one arriving a step; {DS_LANES} lanes, "
          f"page_size {DS_PAGE}, max_len {max_len}; {pages} pages, the largest count from "
          f"{start} down whose schedule evicts (found on the CPU in "
          f"{time.perf_counter() - t0:.1f} s: {sim_stats['evictions']} evictions)")
    sched = engine.make_scheduler(num_pages=pages, **kw)
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    t0 = time.perf_counter()
    cb_drive(sched, reqs, timed=steps)
    wall = time.perf_counter() - t0
    launches = {k: kops.launches[k] for k in ("bsr_sdd", "bsr_spmm")}
    st = sched.stats
    forwards = sum(1 for ev, _, _ in steps if ev["running"])
    prefills = st["admissions"] - st["resumes"]
    want = {"bsr_sdd": 2 * n_moe * (forwards + prefills), "bsr_spmm": n_moe * (forwards + prefills)}
    pure = [ms for ev, ms, _ in steps if ev["running"] and not (
        ev["admitted"] or ev["resumed"] or ev["evicted"])]
    step_ms = statistics.median(pure)
    print(f"  served {st['finished']} requests in {wall:.3f} s: {st['finished'] / wall:.3f} "
          f"requests/s, {st['decode_tokens'] / wall:.1f} decode tokens/s; steps {st['steps']} "
          f"(decode forwards {forwards}, median pure decode step {step_ms:.3f} ms over "
          f"{len(pure)}), prefills {prefills}, evictions {st['evictions']}, resumes "
          f"{st['resumes']}; peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; K3/K2 "
          f"launches {launches['bsr_sdd']}/{launches['bsr_spmm']} (expected "
          f"{want['bsr_sdd']}/{want['bsr_spmm']}); generate (11c): {generate_tps:.1f} tokens/s")
    checks = {
        "all finished": st["finished"] == DS_REQUESTS,
        "evicted and resumed": st["evictions"] >= 1 and st["resumes"] >= 1,
        "K3/K2 launches": launches == want,
        "the CPU schedule": sched.transcript == sim_transcript,
    }
    agree, total = 0, 0
    for r in reqs[:2]:
        out, _ = engine.generate(r["prompt"][None], r["max_new_tokens"])
        mine = sched.requests[r["rid"]].tokens
        agree += sum(a == b for a, b in zip(out[0, len(r["prompt"]):].tolist(), mine))
        total += len(mine)
    print(f"  greedy tokens of requests d0-d1 that equal generate's on each alone: {agree} of "
          f"{total} (reported, not gated: batch composition changes bfloat16 rounding)")
    failed = [k for k, ok in checks.items() if not ok]
    print(f"  checks: {', '.join(f'{k} {ok}' for k, ok in checks.items())}")
    if failed:
        raise AssertionError(f"DeepSeek-V2 serve: {failed} failed")
    return launches


def serve_l4(args, torch, kops, m, dev):
    """11e: llama4-scout in bfloat16 at full width, cut to L4_LAYERS layers,
    through ServeEngine.generate. Returns its K3/K2 launches."""
    ttr = m["ttr"]
    cfg = moe_model(L4, L4_LAYERS, "bfloat16")
    B, P, G = L4_B, L4_P, L4_G
    gen = torch.Generator(device=dev).manual_seed(args.seed + 22)
    params = ttr.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    engine = m["ServeEngine"](cfg, params, max_len=P + G, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    out, stats = engine.generate(prompts, G)
    launches = {k: kops.launches[k] for k in ("bsr_sdd", "bsr_spmm")}
    n_moe = moe_layers(cfg)
    want = {"bsr_sdd": 2 * n_moe * G, "bsr_spmm": n_moe * G}
    new = out[:, P:]
    ok = (launches == want and tuple(out.shape) == (B, P + G)
          and bool(((new >= 0) & (new < cfg.vocab_size)).all()))
    print(f"phase 11e: serve llama4-scout at its published widths cut to {cfg.n_layers} layers, "
          f"dropless, bfloat16 ({param_counts(cfg, params)}): B={B} prompts of {P} tokens, {G} "
          f"greedy new tokens: prefill ms={stats['prefill_s'] * 1e3:.3f} decode ms/step="
          f"{stats['decode_s'] * 1e3 / (G - 1):.3f} tokens/s={stats['tokens_per_s']:.1f} peak "
          f"GB={torch.cuda.max_memory_allocated() / 1e9:.3f}; K3/K2 launches "
          f"{launches['bsr_sdd']}/{launches['bsr_spmm']} (expected {want['bsr_sdd']}/"
          f"{want['bsr_spmm']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"llama4-scout generate: launches {launches}, tokens "
                             f"{tuple(out.shape)}")
    del engine, params
    torch.cuda.empty_cache()
    return launches


def phase_moe_serve(args, torch, kops, kref, dev):
    """Phase 11: the MoE models served on the card. Returns, per kernel
    (bsr_sdd, bsr_spmm), its l4_* and ds_* JSON keys."""
    t_start = time.perf_counter()
    m = serve_modules()
    l4_records = l4_kernels(args, torch, kops, kref, dev)
    print("phase 11b: the MoE models at full width in float32 (TF32 off), cut in depth")
    check_moe_model(args, torch, kops, m, dev, DS, 1)
    check_moe_model(args, torch, kops, m, dev, L4, 1)
    engine, ds_records, ds_launches, ds_tps = serve_ds(args, torch, kops, kref, m, dev)
    serve_launches = serve_ds_continuous(args, torch, kops, m, dev, engine, ds_tps)
    del engine
    torch.cuda.empty_cache()
    l4_launches = serve_l4(args, torch, kops, m, dev)
    print(f"phase 11: {time.perf_counter() - t_start:.1f} s")
    short = {"torch.bfloat16": "bf16", "torch.float32": "f32"}
    fields = ("ms", "bound_ms", "fma_bound_ms", "plain_ms", "library_ms", "max_abs_err")
    keys = {}
    for kname in ("bsr_sdd", "bsr_spmm"):
        out = keys[kname] = {}
        for (k, shape, dt), rec in l4_records.items():
            if k == kname:
                for f in fields:
                    if f in rec:
                        out[f"l4_{shape}_{short[dt]}_{f}"] = rec[f]
                out[f"l4_{shape}_{short[dt]}_launches"] = l4_launches[kname]
        for (k, shape), rec in ds_records.items():
            if k == kname:
                for f in fields:
                    if f in rec:
                        out[f"ds_{shape}_bf16_{f}"] = rec[f]
                out[f"ds_{shape}_bf16_launches"] = ds_launches[kname]
        out["ds_serve_launches"] = serve_launches[kname]
    return keys


# ---------------------------------------------------------------------- #
# phase 12: serving the Mamba-2 models (mamba2-1.3b whole, jamba cut)
# ---------------------------------------------------------------------- #
M2, JB = "mamba2-1.3b", "jamba-1.5-large-398b"
# the served jamba: a super-block's layers 0 (Mamba, dense FFN), 1 (Mamba,
# MoE) and 7 (attention, MoE), in that order, one group of one repeat
JB_KEEP, JB_CHECK_KEEP = (0, 1, 7), (0, 1)
JB_SHAPES = {"prefill": (4, 512), "decode": (4, 1)}  # K3 and K2 at jamba's tables
SSM_CHECK_B, SSM_CHECK_P, SSM_CHECK_STEPS = 2, 512, 8  # float32: 4 SSD chunks, 8 steps
M2_B, M2_P, M2_G = 8, 512, 64  # mamba2's generate
M2_REQUESTS, M2_LANES, M2_PROMPTS, M2_GENS = 16, 8, (128, 512), (16, 64)  # its serve
JB_B, JB_P, JB_G = 4, 512, 32  # jamba's generate
JB_REQUESTS, JB_LANES, JB_PROMPTS, JB_GENS = 8, 4, (128, 512), (16, 32)  # its serve
SSM_PAGE = 16


def jamba_model(keep, dtype):
    """jamba at its published widths, dropless, params and compute in
    ``dtype``, cut to the super-block's layers ``keep`` (one group, repeat
    1)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import GroupSpec

    cfg = get_config(JB)
    layers = tuple(cfg.groups[0].layers[i] for i in keep)
    return replace(cfg, groups=(GroupSpec(repeat=1, layers=layers),), param_dtype=dtype,
                   compute_dtype=dtype, moe=replace(cfg.moe, dropless=True))


def mamba2_model(dtype):
    """mamba2-1.3b whole (48 layers at the published widths), params and
    compute in ``dtype``."""
    from repro_torch.configs import get_config

    return replace(get_config(M2), param_dtype=dtype, compute_dtype=dtype)


def jb_kernels(args, torch, kops, kref, dev):
    """12a: K3 and K2 at jamba's dropless tables (16 experts of d_ff 24576,
    top-2, d_model 8192: bn = tk = 24576, K = 8192; the stacked experts hold
    3.2 G values, past 2^31) at prefill (B=4, S=512) and decode (B=4), in
    both dtypes: each held against its plain version on sampled slots and a
    whole panel (a plain gather of every slot would not fit) and timed after
    an L2 flush beside its bound, the plain version and the library call; in
    float32 a second launch gives the same bits."""
    from repro_torch.models import moe as tmoe

    cfg = jamba_model(JB_KEEP, "float32")
    mc = cfg.moe
    flush = l2_flush(torch)
    records = {}
    print(f"phase 12a: K3 and K2 at jamba's tables ({mc.num_experts} experts of d_ff "
          f"{mc.d_ff}, top-{mc.top_k}, d_model {cfg.d_model}: each expert's w1 chunk "
          f"{cfg.d_model * mc.d_ff * 2 / 1e6:.1f} MB in bfloat16; median of {args.reps} calls, "
          f"CUDA events, each after an L2 flush)")
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(args.seed + 30)
        p = tmoe.moe_init(gen, cfg, dtype=dtype, device=dev)
        for name, (B, S) in JB_SHAPES.items():
            x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(dtype)
            a, topo, _, _ = sdd_tables(tmoe, p, x, cfg)
            records[("bsr_sdd", name, str(dtype))] = time_sdd(
                args, torch, kops, kref, p, a, topo, f"jamba {name}", flush, n_sample=4)
            records[("bsr_spmm", name, str(dtype))] = time_dsd(
                args, torch, kops, kref, p, a, topo, f"jamba {name}", flush, n_panels=1)
            del a, topo, x
            torch.cuda.empty_cache()
        del p
        torch.cuda.empty_cache()
    return records


def ssm_targets(m):
    """The Mamba-2 models' layers, as (owner, attribute, label) ranges: the
    mixer's parts for mamba2, the layer kinds for jamba (``by_kind``)."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models import ssm as tssm

    ttr = m["ttr"]
    head = [(ttr, "_unembed", "head (final norm, lm_head)"), (ttr, "_embed", "embedding")]
    return {
        "parts": [(tssm, "_in_proj", "in projections"), (tssm, "_out_proj", "out projection"),
                  (tssm, "_causal_conv", "conv"), (tssm, "_conv_step", "conv"),
                  (tssm, "ssd_chunked", "SSD"), (tssm, "_ssd_step", "SSD"),
                  (tssm, "rmsnorm", "gated norm")] + head,
        "kinds": [(ttr, "mamba_apply", "Mamba"), (ttr, "mamba_decode", "Mamba"),
                  (ttr, "gqa_apply", "attention"), (tmoe, "_route", "router and dispatch"),
                  (tmoe, "_dispatch", "router and dispatch"),
                  (tmoe, "_dropless_ffn", "expert FFN glue (topology, activation)"),
                  (tmoe, "_combine", "combine"), (ttr, "ffn_apply", "dense FFN")] + head,
    }


def ssm_breakdown(torch, m, label, fn, kind, extra=()):
    """One call of ``fn`` under torch.profiler with ranges ``ssm_targets(m)
    [kind]`` (and ``extra`` beside them): device ms by range, K3's and K2's
    own time (by kernel name, kept out of the ranges), the rest (layer norms,
    residual adds) and the device's busy share of the wall."""
    got = profile_ranges(torch, ssm_targets(m)[kind] + list(extra), fn,
                         exclude=lambda k: is_k3(k) or is_k2(k))
    if got is None:
        print(f"  profile {label}: device time not measured (the profiler saw none)")
        return None
    _, ranges, table, busy, wall_ms = got
    k3 = sum(row[0] for k, row in table.items() if is_k3(k))
    k2 = sum(row[0] for k, row in table.items() if is_k2(k))
    rest = busy - sum(ranges.values()) - k3 - k2
    parts = "; ".join(f"{k} {v:.3f}" for k, v in ranges.items())
    kernels = f"K3 {k3:.3f}; K2 {k2:.3f}; " if k3 or k2 else ""
    top = sorted(((row[0], row[2], k) for k, row in table.items()), reverse=True)[:5]
    print(f"  profile {label}: device busy {busy:.3f} of {wall_ms:.3f} ms wall (share "
          f"{busy / wall_ms:.3f}); ms: {parts}; {kernels}rest (layer norms, residual adds) "
          f"{rest:.3f}; top kernels: "
          + "; ".join(f"{k[:50]} x{n} {own:.3f}" for own, n, k in top))
    return dict(busy_ms=busy, wall_ms=wall_ms, k3_ms=k3, k2_ms=k2, **ranges)


def ssm_generate(args, torch, kops, m, dev, cfg, label, B, P, G, kind, seed):
    """``cfg`` in bfloat16 through ServeEngine.generate: B prompts of P
    tokens, G greedy new tokens; K3 and K2 must launch 2 and 1 times a MoE
    layer a forward. Prints the metrics and a profile of the prefill and of
    one decode step. Returns (engine, launches, tokens/s)."""
    ttr = m["ttr"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = ttr.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    print(f"  {label}: params {param_counts(cfg, params)}, drawn in "
          f"{time.perf_counter() - t0:.2f} s; B={B} prompts of {P} tokens, {G} greedy new "
          f"tokens, max_len {P + G}")
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    engine = m["ServeEngine"](cfg, params, max_len=P + G, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    out, stats = engine.generate(prompts, G)
    launches = {k: kops.launches[k] for k in ("bsr_sdd", "bsr_spmm")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_moe = moe_layers(cfg)
    want = {"bsr_sdd": 2 * n_moe * G, "bsr_spmm": n_moe * G}  # G forwards
    new = out[:, P:]
    print(f"  generate: prefill ms={stats['prefill_s'] * 1e3:.3f} decode ms/step="
          f"{stats['decode_s'] * 1e3 / (G - 1):.3f} tokens/s={stats['tokens_per_s']:.1f} "
          f"(B x new tokens / decode s) peak GB={peak:.3f}; K3/K2 launches "
          f"{launches['bsr_sdd']}/{launches['bsr_spmm']} over {G} forwards (expected "
          f"{want['bsr_sdd']}/{want['bsr_spmm']})")
    if tuple(out.shape) != (B, P + G) or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
        raise AssertionError(f"{label} generate: tokens {tuple(out.shape)} out of range")
    if launches != want:
        raise AssertionError(f"{label} generate: launches {launches}, expected {want}")
    with torch.inference_mode():
        cache = ttr.init_cache(cfg, B, P + G, device=dev)
        ssm_breakdown(torch, m, f"{label} prefill B={B} P={P}",
                      lambda: engine._prefill(prompts, cache), kind)
        tok = out[:, P:P + 1]
        ssm_breakdown(torch, m, f"{label} one decode step at position {P}",
                      lambda: engine._decode(tok, cache, P, 0.0, None), kind)
        del cache
    torch.cuda.empty_cache()
    return engine, launches, stats["tokens_per_s"]


def ssm_serve(args, torch, kops, m, dev, engine, label, n_req, lanes, prompts, gens, seed,
              generate_tps, kind):
    """The same engine through ServeEngine.serve: ``n_req`` requests, one
    arriving a step, on ``lanes`` lanes, the largest page count whose
    schedule evicts (found on the CPU; the card's run repeats it), the state
    leaves of each parked sequence checked bit for bit at its resume. Every
    request finishes, K3 and K2 launch 2 and 1 times a MoE layer a forward
    or prefill. Then one decode step of all lanes under the profiler, and
    the state gather alone beside its bytes bound. Returns the launches."""
    import numpy as np

    from repro_torch.serve.paged_cache import PagedKVCache
    from repro_torch.tree import flatten

    cfg = engine.cfg
    n_moe = moe_layers(cfg)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(prompts[0], prompts[1] + 1, n_req)
    news = rng.integers(gens[0], gens[1] + 1, n_req)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, int(p)).astype(np.int32),
                 max_new_tokens=int(g), rid=f"s{i}")
            for i, (p, g) in enumerate(zip(lengths, news))]
    max_len = prompts[1] + gens[1]
    kw = dict(max_len=max_len, page_size=SSM_PAGE, max_batch=lanes)
    t0 = time.perf_counter()
    start = lanes * -(-max_len // SSM_PAGE)
    pages, sims = cb_pages(m, torch, reqs, start, [kw])
    sim_stats, sim_transcript = sims[0]
    print(f"  serve: {n_req} requests, prompts {int(lengths.min())}-{int(lengths.max())} tokens, "
          f"{int(news.min())}-{int(news.max())} greedy new tokens, one arriving a step; {lanes} "
          f"lanes, page_size {SSM_PAGE}, max_len {max_len}; {pages} pages, the largest count "
          f"from {start} down whose schedule evicts (found on the CPU in "
          f"{time.perf_counter() - t0:.1f} s: {sim_stats['evictions']} evictions)")
    sched = engine.make_scheduler(num_pages=pages, **kw)
    kv, parked, restored = sched.kv, {}, []
    evict, resume = kv.evict, kv.resume

    def spy_evict(rid):  # the parked sequence's state leaves, before and after
        parked[rid] = [t for t, paged in zip(flatten(kv.read_dense(rid))[0], kv.paged)
                       if not paged]
        evict(rid)

    def spy_resume(rid):
        ok = resume(rid)
        if ok:
            back = [t for t, paged in zip(flatten(kv.read_dense(rid))[0], kv.paged) if not paged]
            restored.append(all(torch.equal(a, b) for a, b in zip(back, parked.pop(rid))))
        return ok

    kv.evict, kv.resume = spy_evict, spy_resume
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    t0 = time.perf_counter()
    cb_drive(sched, reqs, timed=steps)
    wall = time.perf_counter() - t0
    launches = {k: kops.launches[k] for k in ("bsr_sdd", "bsr_spmm")}
    st = sched.stats
    forwards = sum(1 for ev, _, _ in steps if ev["running"])
    prefills = st["admissions"] - st["resumes"]
    want = {"bsr_sdd": 2 * n_moe * (forwards + prefills),
            "bsr_spmm": n_moe * (forwards + prefills)}
    pure = [ms for ev, ms, _ in steps if ev["running"] and not (
        ev["admitted"] or ev["resumed"] or ev["evicted"])]
    step_ms = statistics.median(pure)
    n_state = sum(not p for p in kv.paged)
    print(f"  served {st['finished']} requests in {wall:.3f} s: {st['finished'] / wall:.3f} "
          f"requests/s, {st['decode_tokens'] / wall:.1f} decode tokens/s; steps {st['steps']} "
          f"(decode forwards {forwards}, median pure decode step {step_ms:.3f} ms over "
          f"{len(pure)}), prefills {prefills}, evictions {st['evictions']}, resumes "
          f"{st['resumes']}; cache leaves: {kv.num_leaves - n_state} paged, {n_state} state; "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; K3/K2 launches "
          f"{launches['bsr_sdd']}/{launches['bsr_spmm']} (expected {want['bsr_sdd']}/"
          f"{want['bsr_spmm']}); generate: {generate_tps:.1f} tokens/s")
    checks = {
        "all finished": st["finished"] == n_req,
        "evicted and resumed": st["evictions"] >= 1 and st["resumes"] >= 1,
        "state back bit for bit": bool(restored) and all(restored),
        "K3/K2 launches": launches == want,
        "the CPU schedule": sched.transcript == sim_transcript,
    }
    agree, total = 0, 0
    for r in reqs[:2]:
        out, _ = engine.generate(r["prompt"][None], r["max_new_tokens"])
        mine = sched.requests[r["rid"]].tokens
        agree += sum(a == b for a, b in zip(out[0, len(r["prompt"]):].tolist(), mine))
        total += len(mine)
    print(f"  greedy tokens of requests s0-s1 that equal generate's on each alone: {agree} of "
          f"{total} (reported, not gated: batch composition changes bfloat16 rounding)")
    failed = [k for k, ok in checks.items() if not ok]
    print(f"  checks: {', '.join(f'{k} {ok}' for k, ok in checks.items())}")
    if failed:
        raise AssertionError(f"{label} serve: {failed} failed")
    del sched

    # one decode step of every lane under the profiler, then the gather alone
    prof = engine.make_scheduler(num_pages=pages, **kw)
    for i in range(lanes):
        prof.submit(rng.integers(0, cfg.vocab_size, CB_PROFILE_P), 8, rid=f"p{i}")
    prof.step()  # admits and prefills every lane, decodes once
    ssm_breakdown(torch, m, f"{label} one continuous-batching decode step, {lanes} lanes at "
                  f"position {CB_PROFILE_P + 1}", prof.step, kind,
                  extra=[(PagedKVCache, "gather", "paged: gather view"),
                         (PagedKVCache, "append_token", "paged: scatter (append_token)")])
    rids = [r.rid for r in prof.lanes]
    g_ms = median_ms(lambda: prof.kv.gather(rids), args.reps)
    state = sum(prof.kv._state[rids[0]][i].numel() * prof.kv._state[rids[0]][i].element_size()
                for i in range(kv.num_leaves) if not prof.kv.paged[i])
    paged = prof.kv.view_pages * sum(a[0].numel() * a.element_size()
                                     for a in prof.kv._arenas if a is not None)
    g_bytes = len(rids) * (state + paged)
    print(f"  the paged gather alone, {len(rids)} lanes: ms={g_ms:.4f} (CUDA events, median of "
          f"{args.reps}); it reads and writes {g_bytes / 1e9:.4f} GB ({state / 1e6:.3f} MB of "
          f"state a lane): bound {2 * g_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    del prof
    torch.cuda.empty_cache()
    return launches


def ssm_cli(torch, argv, dev):
    """The serve CLI on ``dev``, in this process."""
    from repro_torch.launch import serve as cli

    argv = argv + ["--device", dev.type]
    print(f"  CLI: python -m repro_torch.launch.serve {' '.join(argv)}")
    out = cli.main(argv)
    del out
    torch.cuda.empty_cache()


def phase_mamba_serve(args, torch, kops, kref, dev):
    """Phase 12: the Mamba-2 models on the card. Returns, per kernel
    (bsr_sdd, bsr_spmm), its jb_* JSON keys."""
    t_start = time.perf_counter()
    m = serve_modules()
    jb_records = jb_kernels(args, torch, kops, kref, dev)
    print("phase 12b: the Mamba-2 models at full width in float32 (TF32 off)")
    check_model(args, torch, kops, m, dev, mamba2_model("float32"), M2, "recurrent SSD",
                SSM_CHECK_B, SSM_CHECK_P, SSM_CHECK_STEPS, seed=args.seed + 31)
    check_model(args, torch, kops, m, dev, jamba_model(JB_CHECK_KEEP, "float32"),
                f"{JB} layers {JB_CHECK_KEEP}", "recurrent SSD", SSM_CHECK_B, SSM_CHECK_P,
                SSM_CHECK_STEPS, seed=args.seed + 32, cf=16.0)

    print("phase 12c: serve mamba2-1.3b whole (48 layers at the published widths), bfloat16")
    engine, _, tps = ssm_generate(args, torch, kops, m, dev, mamba2_model("bfloat16"), M2,
                                  M2_B, M2_P, M2_G, "parts", seed=args.seed + 33)
    ssm_serve(args, torch, kops, m, dev, engine, M2, M2_REQUESTS, M2_LANES, M2_PROMPTS,
              M2_GENS, args.seed + 34, tps, "parts")
    del engine
    torch.cuda.empty_cache()
    ssm_cli(torch, ["--arch", M2, "--batch", "4", "--prompt-len", "64", "--gen", "16"], dev)

    cfg = jamba_model(JB_KEEP, "bfloat16")
    print(f"phase 12d: serve {JB} at its published widths cut to layers {JB_KEEP} of a "
          f"super-block (Mamba + dense FFN, Mamba + MoE, attention + MoE), dropless, bfloat16")
    engine, jb_launches, tps = ssm_generate(args, torch, kops, m, dev, cfg, "jamba", JB_B, JB_P,
                                            JB_G, "kinds", seed=args.seed + 35)
    serve_launches = ssm_serve(args, torch, kops, m, dev, engine, "jamba", JB_REQUESTS,
                               JB_LANES, JB_PROMPTS, JB_GENS, args.seed + 36, tps, "kinds")
    del engine
    torch.cuda.empty_cache()
    ssm_cli(torch, ["--arch", JB, "--reduced", "--continuous", "--requests", "6"], dev)
    print(f"phase 12: {time.perf_counter() - t_start:.1f} s")
    short = {"torch.bfloat16": "bf16", "torch.float32": "f32"}
    fields = ("ms", "bound_ms", "fma_bound_ms", "plain_ms", "library_ms", "max_abs_err")
    keys = {}
    for kname in ("bsr_sdd", "bsr_spmm"):
        out = keys[kname] = {}
        for (k, shape, dt), rec in jb_records.items():
            if k == kname:
                for f in fields:
                    if f in rec:
                        out[f"jb_{shape}_{short[dt]}_{f}"] = rec[f]
                out[f"jb_{shape}_{short[dt]}_launches"] = jb_launches[kname]
        out["jb_serve_launches"] = serve_launches[kname]
    return keys


# ---------------------------------------------------------------------- #
# phase 13: training
# ---------------------------------------------------------------------- #
# a gradient leaf, max|err| / max|ref|: float32 sums over up to 2048 tokens in
# another order; bfloat16 products rounded to 8 bits of mantissa on both sides
GRAD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 3e-2}
# 13a: DeepSeek-V2's MoE layer at prefill, by dtype. float32 at B=2 (traffic,
# not width): the capacity path that holds its gradients keeps ~37 GB of
# activations at B=4 (einsum's permuted copies of the dispatch buffer
# among them) beside 15.3 GB of params and as much of gradients
BWD_SHAPE = {"torch.bfloat16": (4, 512), "torch.float32": (2, 512)}
GROUPED_S = 64  # 13a's check against the family's plain versions: B=1
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 8, 512, 6, 1e-3  # 13b
# 13b's eval gate: the mean CE on a batch no step trains on (SyntheticDataset
# step EVAL_STEP) must fall by EVAL_MARGIN over the steps; a zero update
# leaves it where it was and a sign-flipped one raises it
EVAL_STEP, EVAL_MARGIN = 1000, 0.05
ADAMW_LEAVES = ("embed", "final_norm", "groups/0/sub0/ffn/w1", "groups/0/sub0/mixer/wq")
# max|port - plain| / max|plain| of the moments and the params' change; the
# change is read back as p_new - p in float32, so its tolerance is at least
# two float32 ulps of max|p| over max|change| (a norm's scales are ~1, its
# change ~lr)
ADAMW_TOL = 1e-5
CUT_B, CUT_S = 2, 128  # 13c


def moe_grads(torch, tmoe, p, x, cot, cfg, after_forward=None):
    """Gradients of sum(y * cot) + aux w.r.t. x and every param of the MoE
    layer, by name; ``after_forward()`` is called between the forward and
    the backward."""
    names = ["x"] + sorted(p)
    leaves = [x] + [p[k] for k in sorted(p)]
    for t in leaves:
        t.requires_grad_(True)
    y, aux = tmoe.moe_apply(p, x, cfg)
    loss = (y.float() * cot).sum() + aux
    del y
    if after_forward is not None:
        after_forward()
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return dict(zip(names, grads))


def check_grads(label, got, want, dtype) -> dict:
    """Each leaf's gradient within GRAD_TOL[dtype] of max|ref|; returns
    {leaf: relative error}."""
    tol = GRAD_TOL[str(dtype)]
    rels = {}
    for k in want:
        err, rel = rel_err(got[k], want[k])
        rels[k] = rel
        if not (rel <= tol and bool(torch_isfinite(got[k]))):
            raise AssertionError(f"{label} d/d{k}: relative error {rel:.3e} above {tol:g}")
    print(f"  {label}: max|err|/max|ref| by leaf "
          + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()) + f" tol={tol:g} ok")
    return rels


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def k2_library(torch, tiles, rows, cols, shape, x, want, reps, flush):
    """torch.sparse_csr_tensor(...) @ x (cuSPARSE) over the element-level CSR
    of the valid tiles, in x's dtype, held against the kernel's output."""
    n, tm, tk = tiles.shape
    dev = tiles.device

    def make():
        r, c = rows.long(), cols.long()
        er = (r[:, None, None] * tm + torch.arange(tm, device=dev)[None, :, None]).expand(
            -1, tm, tk)
        ec = (c[:, None, None] * tk + torch.arange(tk, device=dev)[None, None, :]).expand(
            -1, tm, tk)
        idx = torch.stack([er.reshape(-1), ec.reshape(-1)])
        csr = torch.sparse_coo_tensor(idx, tiles.reshape(-1), shape).coalesce().to_sparse_csr()
        return lambda: csr @ x

    return library_time(f"bsr_spmm library call sparse_csr_tensor(...) @ x "
                        f"({str(x.dtype)[6:]})", make, want, x.dtype, reps, before=flush)


def time_k2_table(args, torch, kops, kref, sp, x, tag, flush, n_check=3):
    """K2 at the tables of ``dsd(sp, x)`` as bsr_ops builds them (m_pad = M,
    row offsets over the real row tiles), timed after ``flush()``, beside
    its bound, its plain version on ``n_check`` whole row tiles and the
    library call; in float32 the last timed launch must give the first
    one's bits."""
    from repro_torch.kernels import _build

    ext = _build.load_kernels()
    dev, dtype = x.device, x.dtype
    tiles = sp.data.contiguous()
    rows, cols = sp.row_indices, sp.column_indices
    (M, _), (tm, tk) = sp.shape, sp.block
    n, R = x.shape[1], M // tm
    rptr = kops.row_ptr_from_ids(rows, R)
    if dtype == torch.float32:
        sched = kops.bsr_schedule("spmm", rptr, tm, tk, n, dtype)
        partial = torch.empty(2 * sched.shape[0] * tm * n, dtype=torch.float32, device=dev)
    else:
        sched = partial = torch.empty(0, device=dev)
    y = torch.empty((M, n), dtype=dtype, device=dev)
    launch = lambda: ext.bsr_spmm(tiles, rptr, cols, x, y, sched, partial)  # noqa: E731
    launch()
    first = y.clone() if dtype == torch.float32 else None
    ms = median_ms(launch, args.reps, flush)
    if first is not None:
        same_bits(f"{tag}, last timed launch", first, y)
    del first
    valid = rows < R
    n_valid = int(valid.sum())
    live = torch.unique(rows[valid])
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    pick = live[torch.randperm(live.numel(), generator=gen, device=dev)[:n_check]]
    sel = (torch.isin(rows, pick) & valid).nonzero().squeeze(1)
    out_rows = (pick[:, None] * tm + torch.arange(tm, device=dev)).reshape(-1)
    s_tiles, s_rows, s_cols = tiles[sel].contiguous(), rows[sel], cols[sel]
    plain = lambda: kref.bsr_spmm_ref(s_tiles, s_rows, s_cols, x, M)  # noqa: E731
    err = check(f"{tag}: timed launch's output on {pick.numel()} whole row tiles "
                f"({len(sel)} tiles) vs plain", y[out_rows], plain()[out_rows], dtype)
    plain_ms = median_ms(plain, args.reps, flush)
    es = x.element_size()
    n_x = int(torch.unique(cols[valid]).numel())
    need = (n_valid * tm * tk + n_x * tk * n + M * n) * es + nbytes(rptr, cols[:n_valid])
    ops = 2 * n_valid * tm * tk * n
    bound = bound_fields(need, ops, dtype)
    lib_ms, lib_txt = k2_library(torch, tiles[:n_valid], rows[:n_valid], cols[:n_valid],
                                 (M, x.shape[0]), x, y, args.reps, flush)
    print(f"  {tag}: tiles={tiles.shape[0]} ({n_valid} valid) tm={tm} tk={tk} n={n} "
          f"ms={ms:.4f} {bound_text(bound, need, ops)} "
          f"roofline_share={bound['bound_ms'] / ms:.3f}; on {len(sel)} tiles of "
          f"{pick.numel()} row tiles: plain_ms={plain_ms:.4f}; library_ms={lib_txt}")
    del y
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound)


def time_k3_table(args, torch, kops, kref, a, b, topo, tag, flush, n_sample=60):
    """K3 at the tables of ``sdd(a, b, topo)`` with ``b`` as given (its body
    ``sdd_body``'s choice), timed after ``flush()``, beside its bound, its
    plain version on sampled slots and (float32) sampled_addmm."""
    from repro_torch.kernels import _build

    ext = _build.load_kernels()
    dev, dtype = a.device, a.dtype
    (bm, bn), K = topo.block, a.shape[1]
    rows, cols = topo.row_indices, topo.column_indices
    nnz, n_valid = topo.nnz_max, int(topo.n_blocks)
    body = kops.sdd_body(a, b)
    out = torch.empty((nnz, bm, bn), dtype=dtype, device=dev)
    launch = lambda: ext.bsr_sdd(a, b, rows, cols, out, body == "cp.async")  # noqa: E731
    launch()
    first = out.clone() if dtype == torch.float32 else None
    ms = median_ms(launch, args.reps, flush)
    if first is not None:
        same_bits(f"{tag}, last timed launch", first, out)
    del first
    pick = sample_slots(torch, topo, args.seed + 4, n=n_sample)
    sample = (rows[pick], cols[pick])
    plain = lambda: kref.bsr_sdd_ref(a, b, *sample, bm, bn)  # noqa: E731
    err = check(f"{tag} ({len(pick)} sampled slots) kernel vs plain", out[pick], plain(),
                dtype)
    plain_ms = median_ms(plain, args.reps, flush)
    valid = rows < topo.n_block_rows
    n_a = int(torch.unique(rows[valid]).numel())
    n_b = int(torch.unique(cols[valid]).numel())
    need = (n_a * bm * K + n_b * K * bn + nnz * bm * bn) * a.element_size() + nbytes(rows, cols)
    ops = 2 * n_valid * bm * bn * K
    bound = bound_fields(need, ops, dtype)
    lib_ms, lib_txt = sdd_library(torch, a, b, topo, out, n_valid, args.reps, flush)
    print(f"  {tag}: slots={nnz} ({n_valid} valid) bm={bm} bn={bn} K={K} "
          f"body={body_label(dtype, body)} ms={ms:.4f} {bound_text(bound, need, ops)} "
          f"roofline_share={bound['bound_ms'] / ms:.3f}; on {len(pick)} sampled slots: "
          f"plain_ms={plain_ms:.4f}; library_ms={lib_txt}")
    del out
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                body=body_label(dtype, body), **bound)


class LaunchTables:
    """Attributes each K2/K3 launch to its table while installed: the
    wrappers ``kops.bsr_spmm`` and ``kops.bsr_sdd`` are wrapped, their own
    counts read around each call, and every launch so counted logged with
    its kernel and its block (K2: the tiles' (tm, tk); K3: the output's
    (bm, bn)). The wrappers' counts are left as they are."""

    def __init__(self, kops):
        self.kops, self.log = kops, []

    def _spy(self, name, fn, block):
        def call(*a, **k):
            before = self.kops.launches[name]
            out = fn(*a, **k)
            blk = block(a, k, out)
            self.log.extend([(name, blk)] * (self.kops.launches[name] - before))
            return out
        return call

    def __enter__(self):
        self.saved = self.kops.bsr_spmm, self.kops.bsr_sdd
        self.kops.bsr_spmm = self._spy("bsr_spmm", self.saved[0],
                                       lambda a, k, out: tuple(a[0].shape[1:]))
        self.kops.bsr_sdd = self._spy("bsr_sdd", self.saved[1],
                                      lambda a, k, out: (k["bm"], k["bn"]))
        return self

    def __exit__(self, *exc):
        self.kops.bsr_spmm, self.kops.bsr_sdd = self.saved


def bwd_table(name, block, bm, f):
    """The backward's table of a launch: K3 is d/dS = sdd(g, w2^T); K2 at
    (tm, tk) = (bm, f) is d/da = dsd(G, w^T), at (f, bm) d/dW = dsd(G^T, a)."""
    if name == "bsr_sdd" and block == (bm, f):
        return "bwd_ds"
    return {(bm, f): "bwd_da", (f, bm): "bwd_dw"}.get(block, f"{name} {block}")


def phase_train_moe(args, torch, kops, kref, dtype):
    """Phase 13a in ``dtype``: the dropless layer's gradients on K3/K2 at
    full width against the capacity path's (einsums, nothing dropped), and
    the backward's tables timed. Returns (records, launches)."""
    from repro_torch.kernels import bsr_ops
    from repro_torch.models import moe as tmoe
    from repro_torch.sparse.block_csr import BlockMatrix

    dname = str(dtype)[6:]
    cfg, cfg_cap = moe_configs()
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff
    B, S = BWD_SHAPE[str(dtype)]
    print(f"phase 13a: DeepSeek-V2-236B MoE layer at full width, dropless, forward and "
          f"backward ({dname}, B={B} S={S})")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    p = tmoe.moe_init(gen, cfg, dtype=dtype, device=dev)
    x = torch.randn((B, S, d), generator=gen, device=dev).to(dtype)
    cot = torch.randn((B, S, d), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = moe_grads(torch, tmoe, p, x, cot, cfg_cap)
    torch.cuda.synchronize()
    cap_s, cap_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    fwd = {}
    t0 = time.perf_counter()
    with LaunchTables(kops) as lt:
        # the forward's launches read and the log cleared before the backward
        got = moe_grads(torch, tmoe, p, x, cot, cfg,
                        after_forward=lambda: (fwd.update(kops.launches), lt.log.clear()))
    torch.cuda.synchronize()
    drop_s = time.perf_counter() - t0
    launches = dict(kops.launches)
    by_table = {}
    for name, block in lt.log:
        t = bwd_table(name, block, cfg.moe.dropless_block, f)
        by_table[t] = by_table.get(t, 0) + 1
    print(f"  launches of one forward and backward, dropless ({dname}): {launches}; the "
          f"forward's {fwd}; the backward's by table {by_table} (want K3 2 and K2 1 "
          f"forward; backward d/dS 1, d/da 2 (w1, w3), d/dW 3 (w1, w3, w2))")
    if (launches["bsr_sdd"] != 3 or launches["bsr_spmm"] != 6 or fwd["bsr_sdd"] != 2
            or fwd["bsr_spmm"] != 1 or by_table != {"bwd_ds": 1, "bwd_da": 2, "bwd_dw": 3}):
        raise AssertionError(f"dropless forward and backward ({dname}): launches {launches}, "
                             f"forward {fwd}, backward by table {by_table}")
    launches["by_table"] = by_table
    print(f"  peak device memory: capacity path {cap_peak:.3f} GB ({cap_s:.2f} s), dropless "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({drop_s:.2f} s, first call)")
    check_grads(f"gradients dropless (K3/K2) vs capacity path (einsums), {dname}", got, want,
                dtype)
    del got, want
    torch.cuda.empty_cache()
    # the family's plain versions (grouped) gather a weight block a slot: at
    # B=1, S=64 (208 slots, 3.3 GB of blocks in bf16) they fit beside the layer
    import functools

    xs, cots = x[:1, :GROUPED_S], cot[:1, :GROUPED_S]
    saved = tmoe.sdd, tmoe.dsd
    tmoe.sdd = functools.partial(bsr_ops.sdd, backend="grouped")
    tmoe.dsd = functools.partial(bsr_ops.dsd, backend="grouped")
    try:
        want = moe_grads(torch, tmoe, p, xs, cots, cfg)  # first: its peak is the larger
    finally:
        tmoe.sdd, tmoe.dsd = saved
    got = moe_grads(torch, tmoe, p, xs, cots, cfg)
    check_grads(f"gradients dropless, cuda (K3/K2) vs grouped (plain), B=1 S={GROUPED_S}, "
                f"{dname}", got, want, dtype)
    del got, want, xs, cots
    torch.cuda.empty_cache()

    print(f"phase 13a: the backward's tables ({dname}, median of {args.reps} calls after an "
          f"L2 flush, CUDA events)")
    flush = l2_flush(torch)
    with torch.no_grad():
        r = tmoe._route(p, x, cfg)
        a = tmoe._dispatch(x, r, cfg).reshape(-1, d)
        topo = tmoe._dropless_topology(r.counts, r.C, r.Tg, cfg, f)
        M = a.shape[0]
        g_out = torch.randn((M, d), generator=gen, device=dev).to(dtype)  # d loss / d dsd out
        g_blocks = torch.randn((topo.nnz_max, topo.block[0], f), generator=gen,
                               device=dev).to(dtype)
        G = BlockMatrix(topo.shape, topo.block, torch.where(topo.valid[:, None, None],
                                                            g_blocks, 0),
                        topo.row_indices, topo.column_indices, topo.offsets)
        del g_blocks
        recs = {}
        # d/dS of out = dsd(S, w2 (E*f, d)): sdd(g, w2^T, S), bsr_ops handing K3
        # a row-major copy of w2^T (its cp.async body)
        w2t = p["w2"].reshape(E * f, d).T.unflatten(1, (E, f))
        t_copy = median_ms(lambda: w2t.contiguous(), args.reps, flush)
        w2c = w2t.contiguous()
        recs["bwd_ds"] = time_k3_table(args, torch, kops, kref, g_out, w2c, topo,
                                       f"bsr_sdd bwd d/dS = sdd(g, w2^T) {dname}", flush)
        del w2c, w2t
        print(f"  d/dS: w2^T made row-major ({nbytes(p['w2']) / 1e9:.2f} GB) "
              f"ms={t_copy:.4f}, K3's cp.async body on it ms={recs['bwd_ds']['ms']:.4f}: "
              f"{t_copy + recs['bwd_ds']['ms']:.4f} ms")
        recs["bwd_ds"]["copy_ms"] = t_copy
        # d/da of h = sdd(a, w1 view): dsd(G, w1^T), w1^T a row-major copy
        t_w1t = median_ms(lambda: p["w1"].transpose(1, 2).reshape(E * f, d), args.reps, flush)
        w1t = p["w1"].transpose(1, 2).reshape(E * f, d)
        print(f"  d/da = dsd(G, w1^T): w1^T as the row-major (E*f, d) operand K2 takes, "
              f"a copy of {nbytes(w1t) / 1e9:.2f} GB, ms={t_w1t:.4f} (twice a backward, with w3)")
        recs["bwd_da"] = time_k2_table(args, torch, kops, kref, G, w1t,
                                       f"bsr_spmm bwd d/da = dsd(G, w1^T) {dname}", flush)
        recs["bwd_da"]["copy_ms"] = t_w1t
        del w1t
        torch.cuda.empty_cache()
        # d/dw1 of h = sdd(a, w1 view): dsd(G^T, a), K2 at tm = f, tk = 8
        GT = G.transpose()
        recs["bwd_dw"] = time_k2_table(args, torch, kops, kref, GT, a,
                                       f"bsr_spmm bwd d/dW = dsd(G^T, a) {dname}", flush)
        del GT, G, a, topo, r
    del p, x, cot, flush
    torch.cuda.empty_cache()
    return recs, launches


def step_phases(torch, tstep):
    """Within the block, the train step's forward (forward_train and the
    loss), backward (autograd.grad) and optimizer (adamw_update) each record
    CUDA events around their work on the stream; ``times()`` gives their
    device ms of the last step."""
    class Phases:
        def __enter__(self):
            self.events, self.saved = {}, []
            for mod, attr, label in ((tstep, "forward_train", "forward"),
                                     (torch.autograd, "grad", "backward"),
                                     (tstep, "adamw_update", "optimizer")):
                fn = getattr(mod, attr)
                self.saved.append((mod, attr, fn))

                def wrapped(*a, _fn=fn, _label=label, **k):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = _fn(*a, **k)
                    end.record()
                    self.events[_label] = (start, end)
                    return out

                setattr(mod, attr, wrapped)
            return self

        def times(self):
            torch.cuda.synchronize()
            return {k: s.elapsed_time(e) for k, (s, e) in self.events.items()}

        def __exit__(self, *exc):
            for mod, attr, fn in reversed(self.saved):
                setattr(mod, attr, fn)

    return Phases()


def train_model(m, layers, dtype=None):
    """llama3-8b-sable at its published widths cut to ``layers`` layers (the
    config's param and compute dtypes, or ``dtype`` for both)."""
    tconfig = m["tconfig"]
    cfg = replace(m["get_config"]("llama3-8b-sable"),
                  groups=tconfig.uniform_groups(layers, tconfig.LayerSpec(mixer="gqa",
                                                                           ffn="dense")))
    if dtype is not None:
        cfg = replace(cfg, compute_dtype=dtype, param_dtype=dtype)
    return cfg


def check_adamw(torch, params, opt, opt_cfg, seed):
    """One ``adamw_update`` at full width on copies of ADAMW_LEAVES (their
    moments and count as training left them; bfloat16 gradients, as the
    step's compression gives them, drawn from ``seed``) against a plain
    float32 AdamW written out here, leaf by leaf: the params' change, mu
    and nu within ADAMW_TOL of max|plain|. Returns the worst error."""
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.tree import tree_paths

    p0, mu0, nu0 = (dict(tree_paths(t)) for t in (params, opt["mu"], opt["nu"]))
    dev = p0[ADAMW_LEAVES[0]].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = {n: torch.randn(p0[n].shape, generator=gen, device=dev).to(torch.bfloat16)
             for n in ADAMW_LEAVES}
    # the plain AdamW first, then the port's on copies, in place
    b1, b2, eps, wd, lr = opt_cfg.b1, opt_cfg.b2, opt_cfg.eps, opt_cfg.weight_decay, opt_cfg.lr
    k = int(opt["count"]) + 1
    gn = math.sqrt(sum(float(g.float().square().sum()) for g in grads.values()))
    scale = min(1.0, opt_cfg.clip_norm / (gn + 1e-9))
    c1, c2 = 1 - b1 ** k, 1 - b2 ** k
    plain = {}
    for n in ADAMW_LEAVES:
        p, g = p0[n].detach().float(), grads[n].float() * scale
        mu = mu0[n].float() * b1 + (1 - b1) * g
        nu = nu0[n].float() * b2 + (1 - b2) * g * g
        upd = (mu / c1) / ((nu / c2).sqrt() + eps) + (wd * p if p.dim() >= 2 else 0)
        plain[n] = (-lr * upd, mu, nu)
        del p, g, upd
    sub = {n: p0[n].detach().clone() for n in ADAMW_LEAVES}
    state = {"mu": {n: mu0[n].clone() for n in ADAMW_LEAVES},
             "nu": {n: nu0[n].clone() for n in ADAMW_LEAVES}, "count": opt["count"].clone()}
    adamw_update(sub, grads, state, opt_cfg)
    worst = 0.0
    for n in ADAMW_LEAVES:
        got = ((sub[n].float() - p0[n].detach().float()), state["mu"][n], state["nu"][n])
        rels = [rel_err(a, b)[1] for a, b in zip(got, plain[n])]
        ulps = 2 * torch.finfo(torch.float32).eps * p0[n].detach().abs().max().item()
        tol = max(ADAMW_TOL, ulps / plain[n][0].abs().max().item())
        worst = max(worst, *rels)
        print(f"  adamw_update at full width, {n} {tuple(p0[n].shape)}: max|err|/max|plain| "
              f"of the change {rels[0]:.2e} (tol {tol:.2e}), mu {rels[1]:.2e}, nu "
              f"{rels[2]:.2e} (tol {ADAMW_TOL:g})")
        if not (rels[0] <= tol and max(rels[1:]) <= ADAMW_TOL):
            raise AssertionError(f"adamw_update on {n} differs from the plain AdamW: {rels}")
        del got
    if int(state["count"]) != k:
        raise AssertionError(f"adamw_update's count {int(state['count'])}, want {k}")
    print(f"  adamw_update vs plain float32 AdamW (count {k}, |g| {gn:.4e}, clip scale "
          f"{scale:.4e}): worst {worst:.2e} ok")
    del plain, sub, state, grads
    torch.cuda.empty_cache()
    return worst


def phase_train_llama(args, torch, kops, m, dev):
    """Phase 13b: llama3-8b-sable at its published widths, cut to
    TRAIN_LAYERS layers, trained through make_train_step and TrainLoop with
    the FFN pinned to cuda (K2). Returns its record."""
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import TrainLoop
    from repro_torch.tree import tree_leaves

    ttr = m["ttr"]
    cfg = train_model(m, TRAIN_LAYERS)
    pats = m["tlayers"].sable_patterns(cfg)
    pin_strategy(m, list(pats.values()), "cuda", dev)
    print(f"phase 13b: train llama3-8b-sable at its published widths cut to {TRAIN_LAYERS} of "
          f"32 layers (d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; FFN matrices of {pats['in'].n_tiles} tiles of "
          f"{pats['in'].tm} x {pats['in'].tk}, pinned to cuda), params {cfg.param_dtype}, "
          f"compute {cfg.compute_dtype}, remat {cfg.remat!r}, AdamW lr {TRAIN_LR} with the "
          f"reference's defaults (gradients cast to bfloat16); SyntheticDataset "
          f"{TRAIN_B} x {TRAIN_S}, {TRAIN_STEPS} steps")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = ttr.init_params(cfg, gen, device=dev)
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    opt = adamw_init(params, opt_cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    state_gb = sum(nbytes(t) for t in tree_leaves(params) + tree_leaves(opt)) / 1e9
    print(f"  params: {n_params / 1e9:.4f} G; params and AdamW state {state_gb:.3f} GB")
    step = tstep.make_train_step(cfg, opt_cfg, ParallelConfig())
    ds = SyntheticDataset(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=args.seed)
    loop = TrainLoop(step, ds)
    eval_fn = tstep.make_eval_step(cfg)
    held = ds._batch_at(EVAL_STEP)  # a batch no step trains on
    eval_before = float(eval_fn(params, held))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    params, opt, metrics = loop.run(params, opt, TRAIN_STEPS, log_every=1,
                                    log_fn=lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    launches = dict(kops.launches)
    eval_after = float(eval_fn(params, held))
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = loop.losses
    recompute = cfg.remat in ("full", "dots")
    print(f"  launches over {TRAIN_STEPS} steps: {launches} ({launches['bsr_spmm'] / TRAIN_STEPS:.0f} "
          f"K2 a step: 3 a layer in the forward"
          + (f", recomputed in the backward under {cfg.remat!r})" if recompute else ")"))
    if launches["bsr_spmm"] == 0:
        raise AssertionError("the train step never launched K2")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses} do not fall")
    fall = eval_before - eval_after
    print(f"  eval (make_eval_step) on the held-out batch at data step {EVAL_STEP}: "
          f"{eval_before:.4f} before, {eval_after:.4f} after {TRAIN_STEPS} steps: fell "
          f"{fall:.4f} (must fall by {EVAL_MARGIN:g}) {'ok' if fall >= EVAL_MARGIN else 'FAIL'}")
    if not fall >= EVAL_MARGIN:
        raise AssertionError(f"held-out eval fell {fall:.4f}, under {EVAL_MARGIN:g}")
    adamw_worst = check_adamw(torch, params, opt, opt_cfg, args.seed + 17)
    times = loop.monitor.times[1:]  # the first step builds the kernels' schedules
    step_ms = statistics.median(times) * 1e3
    tps = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    print(f"  losses {['%.4f' % v for v in losses]} (falling: ok); step ms (median of steps "
          f"2-{TRAIN_STEPS}, host clock to the loss on the host)={step_ms:.2f} tokens/s="
          f"{tps:.1f} peak device memory={peak:.3f} GB; grad_norm="
          f"{float(metrics['grad_norm']):.4f}")

    # checkpoint round trip into a fresh loop
    with tempfile.TemporaryDirectory(prefix="repro-train-ckpt-") as tmp:
        import shutil

        free = shutil.disk_usage(tmp).free / 1e9
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(loop.step, {"params": params, "opt": opt}, extra={"data": ds.state_dict()})
        save_s = time.perf_counter() - t0
        fresh = TrainLoop(step, SyntheticDataset(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                                 seed=args.seed), ckpt_dir=tmp)
        t0 = time.perf_counter()
        p2, o2, resumed = fresh.maybe_restore(params, opt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b.detach()) and a.dtype == b.dtype for a, b in
                   zip(tree_leaves({"p": p2, "o": o2}), tree_leaves({"p": params, "o": opt})))
        ok = resumed and same and fresh.step == loop.step and \
            fresh.dataset.state_dict() == ds.state_dict()
        print(f"  checkpoint at step {loop.step} ({state_gb:.3f} GB; {free:.0f} GB free there): "
              f"save {save_s:.2f} s, restore into a fresh loop {restore_s:.2f} s; params, "
              f"AdamW state and the data step bit for bit {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("checkpoint round trip differs")
        del p2, o2, fresh
    torch.cuda.empty_cache()

    # where a step's time goes
    k = loop.step
    batch = ds._batch_at(k)
    with step_phases(torch, tstep) as ph:
        for _ in range(2):  # the second step: nothing else queued before it
            torch.cuda.synchronize()
            step(params, opt, batch, k)
            ph_ms = ph.times()
    print("  one step by phase (CUDA events on the stream, ms): "
          + ", ".join(f"{n} {v:.2f}" for n, v in ph_ms.items()))
    device_breakdown(torch, "train step", lambda: step(params, opt, batch, k), top=8)
    tb = tstep.batch_to_device(batch, dev)
    fwd = profile_ranges(torch, [], lambda: ttr.forward_train(params, cfg, tb))
    k2_fwd = None
    if fwd is not None:
        _, _, table, busy, wall = fwd
        k2_fwd = sum(r[0] for n, r in table.items() if "bsr_spmm" in n or "combine_kernel" in n)
        n_k2 = sum(r[2] for n, r in table.items() if "bsr_spmm" in n)
        print(f"  profile forward_train (with grad): device busy {busy:.3f} of {wall:.3f} ms "
              f"wall; K2 own time {k2_fwd:.3f} ms in {n_k2} launches")
    del params, opt, tb
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, tokens_per_s=tps, peak_gb=peak, launches=launches["bsr_spmm"],
                loss_first=losses[0], loss_last=losses[-1], eval_before=eval_before,
                eval_after=eval_after, adamw_rel=adamw_worst, k2_forward_ms=k2_fwd,
                **{f"{n}_ms": v for n, v in ph_ms.items()})


def phase_train_cut(args, torch, kops, m, dev):
    """Phase 13c: a 2-layer cut at full width in float32: one step's
    gradients with the FFN on cuda (K2 forward, the reference's plain
    backward) and fixed_block (bsr_ops.dds on the card: K2 forward, the
    family's backward on K2 and K3) against grouped."""
    from repro_torch.tree import tree_leaves
    from repro_torch.train import step as tstep

    ttr = m["ttr"]
    cfg = train_model(m, 2, "float32")
    pats = list(m["tlayers"].sable_patterns(cfg).values())
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    params = ttr.init_params(cfg, gen, device=dev)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (CUT_B, CUT_S + 1), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    print(f"phase 13c: 2 layers at full width in float32 (TF32 off), B={CUT_B} S={CUT_S}: one "
          f"step's gradients by FFN strategy against grouped, max|err|/max|ref| by leaf, "
          f"tol {GRAD_TOL['torch.float32']:g}")
    grads, counts = {}, {}
    for strategy in ("grouped", "cuda", "fixed_block"):
        pin_strategy(m, pats, strategy, dev)
        before = dict(kops.launches)
        logits, aux = ttr.forward_train(params, cfg, batch)
        loss = tstep.cross_entropy(logits, batch["labels"]) + aux
        grads[strategy] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        counts[strategy] = {k: kops.launches[k] - before[k] for k in ("bsr_spmm", "bsr_sdd")}
        del logits, aux, loss
    out = {}
    for strategy in ("cuda", "fixed_block"):
        rels = [rel_err(g, w)[1] for g, w in zip(grads[strategy], grads["grouped"])]
        worst = max(rels)
        ok = worst <= GRAD_TOL["torch.float32"] and all(
            bool(torch.isfinite(g).all()) for g in grads[strategy])
        print(f"  {strategy} vs grouped: worst leaf {worst:.3e} over {len(rels)} leaves "
              f"{'ok' if ok else 'FAIL'}; launches {counts[strategy]}")
        if not ok or counts[strategy]["bsr_spmm"] == 0:
            raise AssertionError(f"2-layer float32 gradients through {strategy}: {worst:.3e}")
        out[strategy] = worst
    if counts["fixed_block"]["bsr_sdd"] == 0:
        raise AssertionError("fixed_block's backward never launched K3")
    del params, grads, leaves
    torch.cuda.empty_cache()
    return out


def phase_train(args, torch, kops, kref, dev):
    """Phase 13: training. Returns the kernels line's extra keys by kernel."""
    t_start = time.perf_counter()
    short = {"bfloat16": "bf16", "float32": "f32"}
    keys = {"bsr_spmm": {}, "bsr_sdd": {}}
    for dtype in (torch.bfloat16, torch.float32):
        recs, launches = phase_train_moe(args, torch, kops, kref, dtype)
        dn = short[str(dtype)[6:]]
        for name, rec in recs.items():
            kname = "bsr_sdd" if name == "bwd_ds" else "bsr_spmm"
            for k, v in rec.items():
                keys[kname][f"train_{name}_{dn}_{k}"] = v
            keys[kname][f"train_{name}_{dn}_launches"] = launches["by_table"][name]
        keys["bsr_spmm"][f"train_moe_{dn}_launches"] = launches["bsr_spmm"]
        keys["bsr_sdd"][f"train_moe_{dn}_launches"] = launches["bsr_sdd"]
        torch.cuda.empty_cache()
    m = serve_modules()
    with temp_plans(m):
        rec = phase_train_llama(args, torch, kops, m, dev)
    keys["bsr_spmm"].update({f"train_step_{k}": v for k, v in rec.items()})
    # K2 at 13b's FFN shapes, bfloat16 compute over its 8 x 512 tokens
    for (pname, _, _), r in time_ffn_k2(
            args, torch, kops, kref, m, dev, cases=(("train", TRAIN_B * TRAIN_S),),
            dtypes=(torch.bfloat16,), label="phase 13b").items():
        keys["bsr_spmm"].update({f"train_ffn_{pname}_{k}": v for k, v in r.items()})
    with temp_plans(m):
        worst = phase_train_cut(args, torch, kops, m, dev)
    keys["bsr_spmm"].update({f"train_cut_{k}_rel": v for k, v in worst.items()})
    print("phase 13d: the training CLI, then --resume")
    train_cli("phase 13d", ["--arch", "llama3-8b", "--sable", "--reduced"])
    print(f"phase 13: {time.perf_counter() - t_start:.1f} s")
    return keys


# ---------------------------------------------------------------------- #
# phase 14: encoder-decoder (seamless-m4t-large-v2)
# ---------------------------------------------------------------------- #
SM = "seamless-m4t-large-v2"
SM_B, SM_SRC, SM_P, SM_G = 8, 512, 32, 64  # 14a: prompts, frames, prompt tokens, new tokens
SM_CUT, SM_CHECK_B, SM_CHECK_SRC, SM_CHECK_P, SM_CHECK_G = 2, 2, 256, 32, 8  # 14b
# 14b: the last prefill logits against forward_train's, max|err| / max|logits|
SM_PREFILL_TOL = 1e-5
SM_REQUESTS, SM_PROMPTS, SM_FRAMES, SM_GENS = 8, (16, 64), (128, 512), (8, 32)  # 14c
SM_TRAIN_B, SM_TRAIN_S, SM_TRAIN_STEPS = 8, 512, 6  # 14d; AdamW at its default lr
# 14d's data: SyntheticDataset's ramps over the first SM_DATA_VOCAB token ids.
# Over the whole vocabulary the tied head starts 0.22 nats above uniform and
# 6 steps at any lr move a held-out batch's CE by noise alone (+-0.1); a
# vocabulary the model can learn to favour gives the gate a signal
SM_DATA_VOCAB = 4096
# 14d's eval gate, as 13b's: the CE on the held-out batch at data step
# EVAL_STEP must fall by SM_EVAL_MARGIN over the steps
SM_EVAL_MARGIN = 0.05


def sm_model(m, dtype=None, cut=None):
    """seamless-m4t-large-v2 at its published widths: params in ``dtype``
    (both dtypes for "float32"; default: the config's), encoder and decoder
    cut to ``cut`` layers each where given."""
    cfg = m["get_config"](SM)
    if dtype == "float32":
        cfg = replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    elif dtype is not None:
        cfg = replace(cfg, param_dtype=dtype)
    if cut is not None:
        cfg = replace(cfg, groups=(replace(cfg.groups[0], repeat=cut),),
                      enc_groups=(replace(cfg.enc_groups[0], repeat=cut),))
    return cfg


def sm_counts(params) -> str:
    """The params by part: encoder, decoder, the tied embedding and head."""
    from repro_torch.tree import tree_leaves

    parts = {"encoder": [params["enc_groups"], params["enc_final_norm"],
                         params.get("frontend_proj")],
             "decoder": [params["groups"], params["final_norm"]],
             "embedding and tied head": [params["embed"], params.get("lm_head")]}
    n = {k: sum(t.numel() for t in tree_leaves([x for x in v if x is not None]))
         for k, v in parts.items()}
    total = sum(n.values())
    es = params["embed"].element_size()
    return (f"total {total / 1e9:.4f} G (" + ", ".join(f"{k} {v / 1e9:.4f} G"
                                                      for k, v in n.items())
            + f"); {total * es / 1e9:.3f} GB")


def sm_targets(m):
    """The enc-dec model's parts, as (owner, attribute, label) ranges."""
    ttr = m["ttr"]
    return [(ttr, "gqa_apply", "self-attention"), (ttr, "cross_kv", "cross-attention"),
            (ttr, "cross_apply", "cross-attention"), (ttr, "ffn_apply", "FFN"),
            (ttr, "_unembed", "head (final norm, tied embedding)"), (ttr, "_embed", "embedding")]


def sm_breakdown(torch, m, label, fn):
    """One call of ``fn`` under torch.profiler with the parts as ranges:
    device ms by part, the rest (layer norms, residual adds), the device's
    busy share of the wall and the top kernels."""
    got = profile_ranges(torch, sm_targets(m), fn)
    if got is None:
        print(f"  profile {label}: device time not measured (the profiler saw none)")
        return None
    _, ranges, table, busy, wall_ms = got
    rest = busy - sum(ranges.values())
    top = sorted(((row[0], row[2], k) for k, row in table.items()), reverse=True)[:5]
    print(f"  profile {label}: device busy {busy:.3f} of {wall_ms:.3f} ms wall (share "
          f"{busy / wall_ms:.3f}); ms: " + "; ".join(f"{k} {v:.3f}" for k, v in ranges.items())
          + f"; rest (layer norms, residual adds) {rest:.3f}; top kernels: "
          + "; ".join(f"{k[:50]} x{n} {own:.3f}" for own, n, k in top))
    return dict(busy_ms=busy, wall_ms=wall_ms, **ranges)


def sm_decode_bytes(cfg, params, batch, enc_len, max_len) -> dict:
    """Bytes a decode step must move: every decoder weight it reads (the
    cross-attention's wk and wv are not: their keys and values are cached),
    the tied embedding as the head, the cached cross K/V, and the
    self-attention KV over max_len positions (the path attends over the
    whole cache); logits and the rest are small beside them."""
    from repro_torch.tree import tree_leaves

    es = params["embed"].element_size()
    dec = sum(t.numel() for t in tree_leaves([params["groups"], params["final_norm"]]))
    cross = params["groups"][0]["sub0"]["cross"]
    unread = cross["wk"].numel() + cross["wv"].numel()
    kv = cfg.n_kv_heads * cfg.head_dim
    layers = sum(g.repeat for g in cfg.groups)
    out = dict(weights=(dec - unread) * es, head=params["embed"].numel() * es,
               cross_kv=2 * layers * batch * enc_len * kv * es,
               self_kv=2 * layers * batch * max_len * kv * es)
    out["total"] = sum(out.values())
    return out


def sm_serve(args, torch, kops, m, dev):
    """14a: the whole model in bfloat16 through ServeEngine.generate.
    Returns (engine, the src_embeds' generator seed)."""
    ttr = m["ttr"]
    cfg = sm_model(m, "bfloat16")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 41)
    t0 = time.perf_counter()
    params = ttr.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    B, S_src, P, G = SM_B, SM_SRC, SM_P, SM_G
    print(f"phase 14a: serve {SM} whole ({cfg.enc_groups[0].repeat} "
          f"encoder + {cfg.groups[0].repeat} decoder layers at the published widths: d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff} gelu, vocab {cfg.vocab_size}, "
          f"tied), bfloat16; params {sm_counts(params)}, drawn in "
          f"{time.perf_counter() - t0:.2f} s; B={B}, src_embeds {S_src} frames x "
          f"{cfg.frontend_dim}, prompts of {P} tokens, {G} greedy new tokens")
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    src = torch.randn((B, S_src, cfg.frontend_dim), generator=gen, device=dev)
    engine = m["ServeEngine"](cfg, params, max_len=P + G, device=dev)
    engine.generate(prompts, 2, src_embeds=src)  # cuBLAS's first calls at these shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    out, stats = engine.generate(prompts, G, src_embeds=src)
    launches = dict(kops.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    new = out[:, P:]
    step_ms = stats["decode_s"] * 1e3 / (G - 1)
    nb = sm_decode_bytes(cfg, params, B, S_src, P + G)
    bound_ms = nb["total"] / HBM_BYTES_PER_S * 1e3
    print(f"  generate: encode ms={stats['encode_s'] * 1e3:.3f} prefill ms="
          f"{stats['prefill_s'] * 1e3:.3f} decode ms/step={step_ms:.3f} tokens/s="
          f"{stats['tokens_per_s']:.1f} (B x new tokens / decode s) peak GB={peak:.3f}; "
          f"launches of K1-K3 {launches} (no TPU kernel lies on this path)")
    print(f"  decode step bytes: decoder weights read {nb['weights'] / 1e9:.3f} GB (the cross "
          f"wk/wv aside), tied head {nb['head'] / 1e9:.3f}, cross K/V {nb['cross_kv'] / 1e9:.3f}, "
          f"self KV over {P + G} positions {nb['self_kv'] / 1e9:.3f}: {nb['total'] / 1e9:.3f} GB, "
          f"bound {bound_ms:.4f} ms at 3.35 TB/s against {step_ms:.3f} measured "
          f"({bound_ms / step_ms:.3f} of it)")
    if tuple(out.shape) != (B, P + G) or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
        raise AssertionError(f"{SM} generate: tokens {tuple(out.shape)} out of range")
    with torch.inference_mode():
        sm_breakdown(torch, m, f"encode B={B} x {S_src} frames",
                     lambda: ttr.encode(params, cfg, src))
        enc_out = ttr.encode(params, cfg, src)
        cache = ttr.init_cache(cfg, B, P + G, enc_len=S_src, device=dev)
        sm_breakdown(torch, m, f"prefill B={B} P={P} (cross K/V computed and cached)",
                     lambda: engine._prefill(prompts, cache, enc_out))
        tok = out[:, P:P + 1]
        sm_breakdown(torch, m, f"one decode step at position {P} (cross K/V read)",
                     lambda: engine._decode(tok, cache, P, 0.0, None))
        del cache, enc_out
    torch.cuda.empty_cache()
    return engine


def sm_rewrite_cross(ttr, cfg, params, cache, enc_out) -> float:
    """Recompute every decoder layer's cross K/V from ``enc_out`` with
    cross_kv and write it into the cache; returns the largest change,
    max|new - cached| over max|new|."""
    worst = 0.0
    for g, gp, gc in zip(cfg.groups, params["groups"], cache):
        for j, spec in enumerate(g.layers):
            if not spec.cross_attn:
                continue
            cc = gc[f"sub{j}"]["cross"]
            for i in range(g.repeat):
                layer = {k: v[i] for k, v in gp[f"sub{j}"]["cross"].items()}
                for k, v in ttr.cross_kv(layer, enc_out, cfg).items():
                    worst = max(worst, rel_err(cc[k][i], v)[1])
                    cc[k][i].copy_(v)
    return worst


def sm_check(args, torch, m, dev):
    """14b: float32 (TF32 off), SM_CUT encoder + SM_CUT decoder layers at the
    published widths: generate's greedy tokens against a manual loop of
    prefill + decode_step whose cross K/V is recomputed from encode's output
    before every step; the last prefill logits against forward_train's
    within SM_PREFILL_TOL, each decode step's against forward_train over the
    longer sequence within SERVE_TOL."""
    ttr = m["ttr"]
    cfg = sm_model(m, "float32", cut=SM_CUT)
    B, S_src, P, G = SM_CHECK_B, SM_CHECK_SRC, SM_CHECK_P, SM_CHECK_G
    gen = torch.Generator(device=dev).manual_seed(args.seed + 42)
    params = ttr.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    src = torch.randn((B, S_src, cfg.frontend_dim), generator=gen, device=dev)
    engine = m["ServeEngine"](cfg, params, max_len=P + G, device=dev)
    out, _ = engine.generate(prompts, G, src_embeds=src)
    with torch.inference_mode():
        enc_out = ttr.encode(params, cfg, src)
        cache = ttr.init_cache(cfg, B, P + G, enc_len=S_src, device=dev)
        lg, cache = ttr.prefill(params, cfg, prompts, cache, enc_out=enc_out)
        full, _ = ttr.forward_train(params, cfg, {"tokens": prompts, "src_embeds": src})
        _, rel_pre = rel_err(lg[:, 0], full[:, -1])
        seq, cached_rel, worst = prompts, 0.0, 0.0
        for i in range(G):
            nxt = torch.argmax(lg[:, -1].float(), dim=-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
            if i == G - 1:
                break
            cached_rel = max(cached_rel, sm_rewrite_cross(ttr, cfg, params, cache, enc_out))
            lg, cache = ttr.decode_step(params, cfg, nxt, cache, P + i)
            full, _ = ttr.forward_train(params, cfg, {"tokens": seq, "src_embeds": src})
            worst = max(worst, rel_err(lg[:, 0], full[:, -1])[1])
    same = bool(torch.equal(out, seq))
    ok = same and rel_pre <= SM_PREFILL_TOL and worst <= SERVE_TOL and cached_rel <= 1e-6 \
        and bool(torch.isfinite(lg).all())
    print(f"phase 14b: {SM} cut to {SM_CUT} encoder + {SM_CUT} decoder layers at the published "
          f"widths, float32 (TF32 off; {sm_counts(params)}), B={B}, {S_src} frames, P={P}, "
          f"{G} new tokens: last prefill logits vs forward_train rel={rel_pre:.3e} (tol "
          f"{SM_PREFILL_TOL:g}); cross K/V cached by the prefill vs recomputed from encode's "
          f"output rel={cached_rel:.3e}; {G - 1} decode steps vs forward_train over the longer "
          f"sequence rel max {worst:.3e} (tol {SERVE_TOL:g}); generate's greedy tokens equal "
          f"the manual loop's: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{SM}: the float32 enc-dec check failed")
    del params, engine, cache, enc_out, lg, full
    torch.cuda.empty_cache()


def sm_serve_fallback(args, torch, m, dev, engine):
    """14c: ServeEngine.serve on the 14a engine: SM_REQUESTS requests, each
    with its own src_embeds, through the reference's explicit fallback (one
    warning, paged False); each request's tokens equal generate on it
    alone."""
    import numpy as np

    from repro_torch.serve import engine as tengine

    rng = np.random.default_rng(args.seed + 43)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 43)
    cfg = engine.cfg
    reqs = []
    for i in range(SM_REQUESTS):
        n, s_src, g = (int(rng.integers(lo, hi + 1)) for lo, hi in (SM_PROMPTS, SM_FRAMES,
                                                                   SM_GENS))
        src = torch.randn((s_src, cfg.frontend_dim), generator=gen, device=dev)
        reqs.append({"prompt": rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                     "max_new_tokens": g, "src_embeds": src, "rid": f"sm{i}"})
    tengine._ENCDEC_FALLBACK_WARNED = False  # this process's first enc-dec serve()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, sched = engine.serve(reqs)
        wall = time.perf_counter() - t0
        engine.serve(reqs[:1])
    fired = [w for w in caught if issubclass(w.category, UserWarning) and "paged" in str(w.message)]
    same = 0
    for r in reqs:
        alone, _ = engine.generate(torch.as_tensor(r["prompt"][None], device=dev),
                                   r["max_new_tokens"], src_embeds=r["src_embeds"][None])
        got = results[r["rid"]]
        same += bool(np.array_equal(got["tokens"], alone[0].cpu().numpy())
                     and got["metrics"]["fallback"] == "generate" and got["state"] == "FINISHED")
    new = sum(r["max_new_tokens"] for r in reqs)
    ok = len(fired) == 1 and sched is None and engine.warmup_stats["paged"] is False \
        and same == len(reqs)
    print(f"phase 14c: serve {len(reqs)} requests ({SM_PROMPTS[0]}-{SM_PROMPTS[1]} prompt "
          f"tokens, {SM_FRAMES[0]}-{SM_FRAMES[1]} frames, {SM_GENS[0]}-{SM_GENS[1]} new tokens, "
          f"from --seed) through the enc-dec fallback: {wall:.3f} s, "
          f"{len(reqs) / wall:.3f} requests/s, {new / wall:.1f} new tokens/s; warnings "
          f"{len(fired)} over two serve() calls, paged {engine.warmup_stats['paged']}; tokens "
          f"equal to generate on each request alone: {same}/{len(reqs)} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{SM} serve fallback: {len(fired)} warnings, {same} equal")


def sm_train(args, torch, m, dev):
    """14d: the whole model trained through make_train_step and TrainLoop:
    float32 params and AdamW, bfloat16 compute, remat "dots", bfloat16
    gradients, AdamW's default lr (the reference's defaults), on
    SyntheticDataset with src_embeds at configs.shapes.src_len's length
    over SM_DATA_VOCAB token ids; the eval gate, a checkpoint round trip,
    one step by phase and under torch.profiler."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.shapes import Shape, src_len
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import TrainLoop
    from repro_torch.tree import tree_leaves

    ttr = m["ttr"]
    cfg = sm_model(m)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 44)
    params = ttr.init_params(cfg, gen, device=dev)
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    state_gb = sum(nbytes(t) for t in tree_leaves(params) + tree_leaves(opt)) / 1e9
    frames = src_len(cfg, Shape("smoke", SM_TRAIN_S, SM_TRAIN_B, "train"))

    def dataset():
        return SyntheticDataset(SM_DATA_VOCAB, SM_TRAIN_S, SM_TRAIN_B, seed=args.seed,
                                frontend_dim=cfg.frontend_dim, src_len=frames)

    ds = dataset()
    print(f"phase 14d: train {SM} whole at its published widths: params {sm_counts(params)}, "
          f"params {cfg.param_dtype} and AdamW state {state_gb:.3f} GB, compute "
          f"{cfg.compute_dtype}, remat {cfg.remat!r}, lr {opt_cfg.lr}, gradients cast to "
          f"bfloat16; SyntheticDataset {SM_TRAIN_B} x {SM_TRAIN_S} target tokens over ids "
          f"< {SM_DATA_VOCAB} with src_embeds {ds.src_len} frames x {ds.frontend_dim}, "
          f"{SM_TRAIN_STEPS} steps")
    step = tstep.make_train_step(cfg, opt_cfg, ParallelConfig())
    loop = TrainLoop(step, ds)
    eval_fn = tstep.make_eval_step(cfg)
    held = ds._batch_at(EVAL_STEP)  # a batch no step trains on
    eval_before = float(eval_fn(params, held))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt, metrics = loop.run(params, opt, SM_TRAIN_STEPS, log_every=1,
                                    log_fn=lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    eval_after = float(eval_fn(params, held))
    losses = loop.losses
    fall = eval_before - eval_after
    step_ms = statistics.median(loop.monitor.times[1:]) * 1e3
    tps = SM_TRAIN_B * SM_TRAIN_S / (step_ms / 1e3)
    print(f"  losses {['%.4f' % v for v in losses]}; step ms (median of steps 2-"
          f"{SM_TRAIN_STEPS}, host clock to the loss on the host)={step_ms:.2f} target "
          f"tokens/s={tps:.1f} (and {SM_TRAIN_B * ds.src_len / (step_ms / 1e3):.1f} frames/s) "
          f"peak device memory={peak:.3f} GB; grad_norm={float(metrics['grad_norm']):.4f}")
    print(f"  eval (make_eval_step) on the held-out batch at data step {EVAL_STEP}: "
          f"{eval_before:.4f} before, {eval_after:.4f} after {SM_TRAIN_STEPS} steps: fell "
          f"{fall:.4f} (must fall by {SM_EVAL_MARGIN:g}) "
          f"{'ok' if fall >= SM_EVAL_MARGIN else 'FAIL'}")
    if not all(math.isfinite(v) for v in losses) or not fall >= SM_EVAL_MARGIN:
        raise AssertionError(f"{SM}: held-out eval fell {fall:.4f}, under {SM_EVAL_MARGIN:g}; "
                             f"losses {losses}")

    with tempfile.TemporaryDirectory(prefix="repro-encdec-ckpt-") as tmp:
        free = shutil.disk_usage(tmp).free / 1e9
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(loop.step, {"params": params, "opt": opt}, extra={"data": ds.state_dict()})
        save_s = time.perf_counter() - t0
        fresh = TrainLoop(step, dataset(), ckpt_dir=tmp)
        t0 = time.perf_counter()
        p2, o2, resumed = fresh.maybe_restore(params, opt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b.detach()) and a.dtype == b.dtype for a, b in
                   zip(tree_leaves({"p": p2, "o": o2}), tree_leaves({"p": params, "o": opt})))
        ok = resumed and same and fresh.step == loop.step and \
            fresh.dataset.state_dict() == ds.state_dict()
        print(f"  checkpoint at step {loop.step} ({state_gb:.3f} GB, enc_groups among its "
              f"leaves; {free:.0f} GB free there): save {save_s:.2f} s, restore into a fresh "
              f"loop {restore_s:.2f} s; params, AdamW state and the data step bit for bit "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{SM}: checkpoint round trip differs")
        del p2, o2, fresh
    torch.cuda.empty_cache()

    k = loop.step
    batch = ds._batch_at(k)
    with step_phases(torch, tstep) as ph:
        for _ in range(2):  # the second step: nothing else queued before it
            torch.cuda.synchronize()
            step(params, opt, batch, k)
            ph_ms = ph.times()
    print("  one step by phase (CUDA events on the stream, ms): "
          + ", ".join(f"{n} {v:.2f}" for n, v in ph_ms.items()))
    device_breakdown(torch, f"{SM} train step", lambda: step(params, opt, batch, k), top=8)
    # the same step without remat (the same values; it fits at this size):
    # what the "dots" policy's per-op callback costs on the host
    bare = tstep.make_train_step(replace(cfg, remat="none"), opt_cfg, ParallelConfig())
    torch.cuda.reset_peak_memory_stats()
    with step_phases(torch, tstep) as ph:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bare(params, opt, batch, k)
            bare_ms = ph.times()
            wall = (time.perf_counter() - t0) * 1e3
    print(f"  the same step with remat 'none': {wall:.2f} ms (host clock, synchronized); by "
          f"phase " + ", ".join(f"{n} {v:.2f}" for n, v in bare_ms.items())
          + f"; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    device_breakdown(torch, f"{SM} train step, remat 'none'",
                     lambda: bare(params, opt, batch, k), top=4)
    del params, opt
    torch.cuda.empty_cache()


def train_cli(label, arch_args):
    """The training CLI on the card in a subprocess, 4 steps, then --resume
    for 2 more."""
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory(prefix="repro-train-cli-") as tmp:
        env["REPRO_CACHE_DIR"] = tmp  # its plans in a cache of its own
        ckpt = str(Path(tmp) / "ckpt")
        base = [sys.executable, "-m", "repro_torch.launch.train", *arch_args, "--ckpt-dir",
                ckpt, "--log-every", "2"]
        for extra in (["--steps", "4"], ["--steps", "2", "--resume"]):
            t0 = time.perf_counter()
            r = subprocess.run(base + extra, capture_output=True, text=True, timeout=300,
                               env=env, cwd=str(ROOT))
            lines = (r.stdout.strip().splitlines() or [""])
            print(f"  {label}: {' '.join(base[1:] + extra)}: rc={r.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s; {' | '.join(lines[-3:])}")
            if r.returncode != 0:
                print(r.stderr[-3000:], file=sys.stderr)
                raise AssertionError(f"the training CLI failed: rc {r.returncode}")
        if "resumed=True at step 4" not in r.stdout or "@ step 6" not in r.stdout:
            raise AssertionError("the training CLI did not resume at step 4")


def phase_encdec(args, torch, kops, dev):
    """Phase 14: seamless-m4t-large-v2 served and trained on the card."""
    t_start = time.perf_counter()
    m = serve_modules()
    engine = sm_serve(args, torch, kops, m, dev)
    sm_check(args, torch, m, dev)
    sm_serve_fallback(args, torch, m, dev, engine)
    del engine
    torch.cuda.empty_cache()
    sm_train(args, torch, m, dev)
    print("phase 14e: the training CLI on the reduced config, then --resume")
    train_cli("phase 14e", ["--arch", SM, "--reduced"])
    print(f"phase 14: {time.perf_counter() - t_start:.1f} s")

# ---------------------------------------------------------------------- #
# phase 15: sharded staged execution
# ---------------------------------------------------------------------- #
SHARDS = 8  # 15a's host loop: the paper's 8 workers
SHARD_TUNE = 4  # 15b's per-shard autotune on nu


def sum_or_none(values):
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def shard_tables(args, torch, kref, ext, flush, ks, km, val, x, X, tag):
    """K1 and K2 on each shard's own tables (phase 4's time_kernels), their
    times, plain versions, library calls and bounds summed over the shards:
    the host loop's kernel work. ``kernels_max_abs_err`` is the worst shard
    kernel against its plain version, apart from the sharded call's error
    against the unsharded one (``max_abs_err``)."""
    recs = {"bsr_spmv": [], "bsr_spmm": []}
    for s, k1, k2 in zip(ks.plan.shards, ks.kernels, km.kernels):
        if k1 is None:
            continue
        vs = val[torch.as_tensor(s.val_index, device=val.device)]
        for kname, rec in time_kernels(args, torch, kref, ext, flush, k1, k2, vs, x, X,
                                       f"{tag} shard {s.shard_id}").items():
            recs[kname].append(rec)
    out = {}
    for kname, rs in recs.items():
        out[kname] = dict(
            kernels_ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
            library_ms=sum_or_none(r["library_ms"] for r in rs),
            bound_ms=sum(r["bound_ms"] for r in rs),
            kernels_max_abs_err=max(r["max_abs_err"] for r in rs))
        print(f"  {kname} {tag} on the {len(rs)} shards' own tables, summed: "
              + " ".join(f"{k}={v:.4f}" if v is not None else f"{k}=n/a"
                         for k, v in out[kname].items()))
    return out


def phase_sharded(args, torch, kops, kref, mats, dev):
    """Phase 15: sharded staged execution on the paper's matrices, in plan
    caches of its own. Returns the kernels line's extra keys by kernel."""
    import os
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch.core import autotune as tautotune
    from repro_torch.core import staging as tstaging
    from repro_torch.core.staging import StagingOptions, stage_spmm, stage_spmv
    from repro_torch.core.vbr import structure_hash
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_staging_mesh

    t_start = time.perf_counter()
    m = serve_modules()
    n_cols = 128
    short = {"torch.float32": "f32", "torch.bfloat16": "bf16"}
    keys = {"bsr_spmv": {}, "bsr_spmm": {}}
    ext, flush = _build.load_kernels(), l2_flush(torch)
    rng = np.random.default_rng(args.seed + 15)
    inputs = {name: (torch.as_tensor(v.val, device=dev),
                     torch.as_tensor(rng.standard_normal(v.shape[1]).astype(np.float32),
                                     device=dev),
                     torch.as_tensor(rng.standard_normal((v.shape[1], n_cols))
                                     .astype(np.float32), device=dev))
              for name, v in mats.items()}
    host = {}  # (matrix, dtype) -> (kernel, its y, its Y): 15a's lpt host loop

    # -- 15a: the host loop -------------------------------------------------
    print(f"phase 15a: sharded staging, the host loop (shards={SHARDS}) at 10000 x 10000, "
          f"n = {n_cols}, 'cuda' backend")
    with temp_plans(m):
        for name, v in mats.items():
            val, x, X = inputs[name]
            dense = torch.as_tensor(v.to_dense(), device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                dn = short[str(dtype)]
                opts = StagingOptions(backend="cuda", dtype=dtype)
                ws, wm = stage_spmv(v, opts, device=dev), stage_spmm(v, n_cols, opts, device=dev)
                want_s, want_m = ws(val, x), wm(val, X)
                dd = dense.to(dtype).float()
                dense_s, dense_m = dd @ x.to(dtype).float(), dd @ X.to(dtype).float()
                del dd
                for strategy in ("lpt", "contiguous"):
                    t0 = time.perf_counter()
                    ks = stage_spmv(v, opts, device=dev, shards=SHARDS, shard_strategy=strategy)
                    km = stage_spmm(v, n_cols, opts, device=dev, shards=SHARDS,
                                    shard_strategy=strategy)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    tag = f"{name} {dn} {strategy} x{SHARDS}"
                    live = sum(k is not None for k in ks.kernels)
                    shards = "; ".join(
                        f"{s.shard_id}: nnz={s.nnz} rows={s.local_m} tiles={k.tiled.n_tiles} "
                        f"tile={k.tiled.tm}x{k.tiled.tk}"
                        for s, k in zip(ks.plan.shards, ks.kernels) if k is not None)
                    print(f"  {tag}: imbalance={ks.imbalance():.4f} staged in {secs:.2f} s "
                          f"(stage0 spmv {ks.stage0_time:.2f} s, spmm {km.stage0_time:.2f} s); "
                          f"{shards}")
                    kops.reset_launches()
                    y, ym = ks(val, x), km(val, X)
                    torch.cuda.synchronize()
                    launches = dict(kops.launches)
                    print(f"  {tag}: launches {launches} ({live} non-empty shards)")
                    if launches != {"bsr_spmv": live, "bsr_spmm": live, "bsr_sdd": 0}:
                        raise AssertionError(f"{tag}: launches {launches}, not one K1 and one "
                                             f"K2 for each of {live} shards")
                    err = max(check(f"sharded spmv {tag} vs unsharded", y, want_s, dtype),
                              check(f"sharded spmm {tag} vs unsharded", ym, want_m, dtype))
                    check(f"sharded spmv {tag} vs dense", y, dense_s, dtype)
                    check(f"sharded spmm {tag} vs dense", ym, dense_m, dtype)
                    if not (torch.isfinite(y.float()).all() and torch.isfinite(ym.float()).all()):
                        raise AssertionError(f"{tag}: non-finite output")
                    for kname, k, w, rhs in (("bsr_spmv", ks, ws, x), ("bsr_spmm", km, wm, X)):
                        ms = median_ms(lambda: k(val, rhs), args.reps, flush)
                        one_ms = median_ms(lambda: w(val, rhs), args.reps, flush)
                        print(f"  {kname} {tag}: sharded fn(val, x) ms={ms:.4f} unsharded "
                              f"fn(val, x) ms={one_ms:.4f}")
                        pre = f"shard_{name}_{dn}" if strategy == "lpt" else \
                            f"shard_contiguous_{name}_{dn}"
                        keys[kname].update({f"{pre}_ms": ms, f"{pre}_unsharded_ms": one_ms,
                                            f"{pre}_launches": launches[kname],
                                            f"{pre}_imbalance": ks.imbalance(),
                                            f"{pre}_max_abs_err": err})
                    if strategy == "lpt":
                        host[(name, dtype)] = (y, ym)
                        for kname, rec in shard_tables(args, torch, kref, ext, flush, ks, km,
                                                       val, x, X, tag).items():
                            keys[kname].update({f"shard_{name}_{dn}_{k}": v
                                                for k, v in rec.items()})
                    del ks, km
                del ws, wm, want_s, want_m, dense_s, dense_m
            del dense
            tstaging.clear_cache()
            torch.cuda.empty_cache()

    # -- 15b: per-shard autotune ----------------------------------------------
    nu = mats["nu"]
    val, x, _ = inputs["nu"]
    tp = temp_plans(m)
    with tp:
        plans_dir = os.path.join(tp.tmp.name, "plans")
        auto = StagingOptions(backend="autotune")
        tautotune.reset_autotune_stats()
        t0 = time.perf_counter()
        kt = stage_spmv(nu, auto, device=dev, shards=SHARD_TUNE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cold = tautotune.autotune_stats()
        names = sorted(os.listdir(plans_dir))
        h, dkey = structure_hash(nu), m["tcache"].device_key(dev)
        want_names = [f"spmv-{h}-{dkey}-s{i}of{SHARD_TUNE}.json" for i in range(SHARD_TUNE)]
        picks = [f"{k.backend}{tuple(k.opts.tile) if k.backend == 'cuda' else ''}"
                 for k in kt.kernels]
        print(f"phase 15b: autotune nu spmv at shards={SHARD_TUNE}: {secs:.2f} s, "
              f"benchmarks={cold['benchmarks']} plans_tuned={cold['plans_tuned']}; "
              f"the shards' picks {picks}")
        if [n for n in names if f"of{SHARD_TUNE}" in n] != want_names:
            raise AssertionError(f"per-shard plans {names}, expected {want_names}")
        y = kt(val, x)
        torch.cuda.synchronize()
        check64("autotuned shards nu spmv vs float64", y,
                nu.to_dense().astype(np.float64) @ x.cpu().numpy().astype(np.float64))
        tstaging.clear_cache()  # a restart: the plans on disk alone
        tautotune.reset_autotune_stats()
        m["tcache"].set_default_cache(m["tcache"].PlanCache(tp.tmp.name))
        t0 = time.perf_counter()
        kt2 = stage_spmv(nu, auto, device=dev, shards=SHARD_TUNE)
        secs = time.perf_counter() - t0
        warm = tautotune.autotune_stats()
        same = sorted(os.listdir(plans_dir)) == names
        print(f"  warm restart: {secs:.2f} s, benchmarks={warm['benchmarks']} "
              f"plans_tuned={warm['plans_tuned']}, no plan written: {same}")
        if warm["benchmarks"] or warm["plans_tuned"] or not same:
            raise AssertionError("the warm restart of the per-shard tune did work again")
        check("autotuned shards nu spmv, warm restart vs cold", kt2(val, x), y, torch.float32)
        keys["bsr_spmv"].update(shard_tune_plans=len(want_names), shard_tune_s=secs,
                                shard_tune_cold_benchmarks=cold["benchmarks"],
                                shard_tune_warm_benchmarks=warm["benchmarks"])
        del kt, kt2
        tstaging.clear_cache()

    # -- 15c, 15d: the mesh path in a one-rank group --------------------------
    backend = "nccl" if dev.type == "cuda" else "gloo"
    os.makedirs(ROOT / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="pg-") as pg:
        if dev.type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(backend, init_method=f"file://{pg}/store", rank=0,
                                world_size=1)
        try:
            print(f"phase 15c: the mesh path in a one-rank {backend} group (a one-rank group "
                  f"exchanges nothing: the exchange between ranks is checked on the CPU)")
            with temp_plans(m):
                worst = 0.0
                for spec in (1, (1, 1)):
                    mesh = make_staging_mesh(spec)
                    for overlap in (True, False):
                        for (name, dtype), (y, ym) in host.items():
                            val, x, X = inputs[name]
                            opts = StagingOptions(backend="cuda", dtype=dtype)
                            ks = stage_spmv(mats[name], opts, mesh=mesh, overlap_gather=overlap)
                            km = stage_spmm(mats[name], n_cols, opts, mesh=mesh,
                                            overlap_gather=overlap)
                            kops.reset_launches()
                            got, gotm = ks(val, x), km(val, X)
                            torch.cuda.synchronize()
                            launches = dict(kops.launches)
                            tag = (f"mesh {spec} overlap_gather={overlap} {name} "
                                   f"{short[str(dtype)]}")
                            if launches != {"bsr_spmv": 1, "bsr_spmm": 1, "bsr_sdd": 0}:
                                raise AssertionError(f"{tag}: launches {launches}")
                            if not (type(got) is torch.Tensor and type(gotm) is torch.Tensor):
                                raise AssertionError(f"{tag}: not a full tensor")
                            worst = max(worst,
                                        check(f"{tag} spmv vs the host loop", got, y, dtype),
                                        check(f"{tag} spmm vs the host loop", gotm, ym, dtype))
                            if name == "u" and dtype == torch.float32:
                                for kname, k, rhs in (("bsr_spmv", ks, x), ("bsr_spmm", km, X)):
                                    ms = median_ms(lambda: k(val, rhs), args.reps, flush)
                                    print(f"  {kname} {tag}: fn(val, x) ms={ms:.4f}")
                                    mk = (f"shard_mesh_{'2d' if spec != 1 else '1d'}_"
                                          f"{'ring' if overlap else 'allgather'}_u_f32_ms")
                                    keys[kname][mk] = ms
                            del ks, km, got, gotm
                keys["bsr_spmv"]["shard_mesh_max_abs_err"] = worst

            print("phase 15d: warm_matmul_plans(mesh=make_staging_mesh(1)) over "
                  "llama3-8b-sable's FFN patterns")
            tp = temp_plans(m)
            with tp:
                tlin = m["tlin"]
                pats = list(m["tlayers"].sable_patterns(
                    m["get_config"]("llama3-8b-sable")).values())
                mesh = make_staging_mesh(1)
                tautotune.reset_autotune_stats()
                out = tlin.warm_matmul_plans(pats, mesh=mesh, device=dev)
                cold = tautotune.autotune_stats()["benchmarks"]
                plans_dir = os.path.join(tp.tmp.name, "plans")
                names = sorted(os.listdir(plans_dir))
                for p in pats:
                    h = tlin.pattern_hash(p)
                    rec = m["tcache"].default_cache().load_plan(
                        m["tcache"].plan_key("linear", h, m["tcache"].device_key(dev), shard_id=0,
                                             num_shards=1))
                    ok = (rec is not None and rec.source == "inherited"
                          and rec.options.backend == out[h] == out[f"{h}@s0of1"])
                    print(f"  pattern {h}: base {out[h]}, shard 0 of 1 "
                          f"{rec.options.backend if rec else None} ({rec.source if rec else None}) "
                          f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"shard plan of {h} does not inherit the base")
                tlin._STRATEGY_REGISTRY.clear()  # a restart
                tautotune.reset_autotune_stats()
                again = tlin.warm_matmul_plans(pats, mesh=mesh, device=dev)
                warm = tautotune.autotune_stats()["benchmarks"]
                same = sorted(os.listdir(plans_dir)) == names
                print(f"  cold: benchmarks={cold} (the base patterns' candidates alone); "
                      f"restart: benchmarks={warm}, no plan written: {same}")
                # the card measures grouped against cuda; the CPU has grouped alone
                base = (2 if dev.type == "cuda" else 0) * len(pats)
                if cold != base or warm or not same or again != out:
                    raise AssertionError("plan warming over the mesh benchmarked a shard key "
                                         "or the restart did work again")
                keys["bsr_spmm"].update(shard_warm_cold_benchmarks=cold,
                                        shard_warm_restart_benchmarks=warm)
        finally:
            dist.destroy_process_group()
    del inputs, host, flush
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t_start:.1f} s")
    return keys


# ---------------------------------------------------------------------- #
# phase 16: model sharding (DP/FSDP/TP/EP) in a one-rank group
# ---------------------------------------------------------------------- #
MS_STEPS = 3  # 16a: steps each way
MS_TOL = 1e-6  # 16a: losses and grad_norm, sharded vs unsharded, relative
MS_B, MS_S = 4, 512  # 16b: DeepSeek-V2's forward, at phase 11c's prefill shape


def ms_state(torch, tree) -> float:
    from repro_torch.tree import tree_leaves

    return sum(nbytes(t.to_local() if hasattr(t, "to_local") else t)
               for t in tree_leaves(tree)) / 1e9


def ms_train(args, torch, kops, m, dev, mesh, pc):
    """16a: llama3-8b-sable at its published widths cut to TRAIN_LAYERS
    layers, MS_STEPS steps unsharded and MS_STEPS steps of
    ``make_train_step(mesh=)`` from the same seed and batches (params and
    AdamW state DTensors), once under deterministic algorithms (compared)
    and once without (timed); 16c: the timed sharded state saved and
    restored both ways. Returns the kernels line's keys."""
    import tempfile

    from repro_torch.checkpoint.manager import restore_checkpoint, save_checkpoint
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed.sharding import distribute, make_shardings, opt_state_specs
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import TrainLoop
    from repro_torch.tree import tree_leaves, tree_map

    ttr = m["ttr"]
    cfg = replace(train_model(m, TRAIN_LAYERS), remat="dots")
    pin_strategy(m, list(m["tlayers"].sable_patterns(cfg).values()), "cuda", dev)
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    print(f"phase 16a: llama3-8b-sable at its published widths cut to {TRAIN_LAYERS} layers "
          f"(params {cfg.param_dtype}, compute {cfg.compute_dtype}, remat {cfg.remat!r}, FFN "
          f"pinned to cuda), {MS_STEPS} steps of {TRAIN_B} x {TRAIN_S} unsharded, then on "
          f"make_local_mesh(('pod', 'data', 'model'), (1, 1, 1)) with DTensor params and "
          f"AdamW state (one rank: the DTensor and collective glue, not the exchange)")
    shard = {}

    def run(name, deterministic):
        """MS_STEPS steps from seed args.seed: (record, params, opt, loop)."""
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = ttr.init_params(cfg, gen, device=dev)
        if name == "sharded":
            shard["params"] = make_shardings(mesh, pc, param_specs(cfg, params), params)
            params = distribute(params, shard["params"])
        opt = adamw_init(params, opt_cfg)
        step = tstep.make_train_step(cfg, opt_cfg, pc, mesh=mesh if name == "sharded" else None)
        loop = TrainLoop(step, SyntheticDataset(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=args.seed))
        norms = []
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kops.reset_launches()
            for _ in range(MS_STEPS):
                params, opt, metrics = loop.run(params, opt, 1, log_every=0)
                norms.append(float(metrics["grad_norm"]))
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(prev)
        rec = dict(losses=list(loop.losses), norms=norms, k2=kops.launches["bsr_spmm"],
                   peak=torch.cuda.max_memory_allocated() / 1e9,
                   ms=statistics.median(loop.monitor.times[1:]) * 1e3)
        print(f"  {name}{', deterministic algorithms' if deterministic else ''}: losses "
              f"{['%.7f' % v for v in rec['losses']]} grad_norm {['%.7f' % v for v in norms]}; "
              f"K2 launches {rec['k2']} ({rec['k2'] // MS_STEPS} a step); step ms (median of "
              f"steps 2-{MS_STEPS}, host clock to the loss)={rec['ms']:.2f} peak device "
              f"memory={rec['peak']:.3f} GB")
        return rec, params, opt, loop

    # the backward's index_add_ and embedding gradient sum with atomics: two
    # unsharded runs differ in the last bits, and training grows that; so
    # the comparison runs under deterministic algorithms, the times without
    runs = {}
    for deterministic in (True, False):
        for name in ("unsharded", "sharded"):
            rec, params, opt, loop = run(name, deterministic)
            runs[(name, deterministic)] = rec
            if name == "unsharded" or deterministic:
                del params, opt, loop
                torch.cuda.empty_cache()
    (u, sh), (ut, st) = ((runs[("unsharded", d)], runs[("sharded", d)]) for d in (True, False))
    rel = max(abs(a - b) / abs(b) for a, b in zip(sh["losses"] + sh["norms"],
                                                    u["losses"] + u["norms"]))
    same = sh["losses"] == u["losses"] and sh["norms"] == u["norms"]
    ok = rel <= MS_TOL and sh["k2"] == u["k2"] == st["k2"] == ut["k2"] > 0
    print(f"  sharded vs unsharded, deterministic: losses and grad_norm max rel {rel:.3e} (tol "
          f"{MS_TOL:g}; bit for bit: {same}); K2 launches {sh['k2']} vs {u['k2']} ({st['k2']} "
          f"vs {ut['k2']} timed); step ms {st['ms']:.2f} vs {ut['ms']:.2f}, peak GB "
          f"{st['peak']:.3f} vs {ut['peak']:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 16a: the sharded step differs from the unsharded one")
    sh, u = st, ut

    # 16c: the DTensor state saved, restored unsharded and with shardings=
    tree = {"params": params, "opt": opt}
    shardings = {"params": shard["params"], "opt": make_shardings(
        mesh, pc, opt_state_specs(cfg, params, opt), opt)}
    with tempfile.TemporaryDirectory(prefix="repro-shard-ckpt-") as tmp:
        t0 = time.perf_counter()
        save_checkpoint(tmp, loop.step, tree)
        save_s = time.perf_counter() - t0
        like = tree_map(lambda t: t.to_local() if hasattr(t, "to_local") else t, tree)
        t0 = time.perf_counter()
        plain, step_no, _ = restore_checkpoint(tmp, like)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        same_plain = step_no == loop.step and all(
            type(a) is torch.Tensor and a.dtype == b.dtype
            and torch.equal(a, b.full_tensor() if hasattr(b, "full_tensor") else b)
            for a, b in zip(tree_leaves(plain), tree_leaves(tree)))
        del plain, like
        t0 = time.perf_counter()
        back, _, _ = restore_checkpoint(tmp, tree, shardings=shardings)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        same_shard = all(
            hasattr(a, "placements") and a.placements == b.placements and torch.equal(
                a.to_local(), b.to_local())
            for a, b in zip(tree_leaves(back["params"]), tree_leaves(params)))
        same_shard &= all(torch.equal(a.to_local() if hasattr(a, "to_local") else a,
                                      b.to_local() if hasattr(b, "to_local") else b)
                          for a, b in zip(tree_leaves(back["opt"]), tree_leaves(opt)))
    print(f"  16c: checkpoint of the sharded state ({ms_state(torch, tree):.3f} GB) at step "
          f"{loop.step}: save {save_s:.2f} s; restore unsharded {plain_s:.2f} s, bit for bit "
          f"{same_plain}; restore with shardings= {shard_s:.2f} s, layouts and blocks bit for "
          f"bit {same_shard} {'ok' if same_plain and same_shard else 'FAIL'}")
    if not (same_plain and same_shard):
        raise AssertionError("phase 16c: the checkpoint round trip differs")
    del tree, back, params, opt, loop
    torch.cuda.empty_cache()
    return dict(shard_train_step_ms=sh["ms"], shard_train_plain_step_ms=u["ms"],
                shard_train_peak_gb=sh["peak"], shard_train_plain_peak_gb=u["peak"],
                shard_train_launches=sh["k2"], shard_train_plain_launches=u["k2"],
                shard_train_rel=rel, shard_ckpt_save_s=save_s,
                shard_ckpt_restore_plain_s=plain_s, shard_ckpt_restore_sharded_s=shard_s)


def ms_moe(args, torch, kops, m, dev, pc):
    """16b: DeepSeek-V2 at full width, its dense layer 0 and one MoE layer,
    bfloat16: ``forward_train`` under ``activation_sharding`` on a (1, 1)
    ("data", "model") mesh against the unsharded forward, dropless and on
    the capacity path. Returns {kernel: keys}."""
    from repro_torch.distributed.ctx import activation_sharding, local_view
    from repro_torch.distributed.sharding import distribute, make_shardings, param_specs
    from repro_torch.launch.mesh import make_local_mesh

    ttr = m["ttr"]
    mesh = make_local_mesh(("data", "model"), (1, 1))
    cfg = moe_model(DS, 1, "bfloat16")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 16)
    params = ttr.init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (MS_B, MS_S), generator=gen, device=dev)
    dparams = distribute(params, make_shardings(mesh, pc, param_specs(cfg, params), params))
    view, _ = local_view(dparams)
    print(f"phase 16b: {DS} at full width, its dense layer 0 and 1 MoE layer, bfloat16 "
          f"({param_counts(cfg, params)}), forward_train of {MS_B} x {MS_S} tokens under "
          f"activation_sharding on make_local_mesh(('data', 'model'), (1, 1))")
    keys = {"bsr_sdd": {}, "bsr_spmm": {}}
    for path, dropless in (("dropless", True), ("capacity", False)):
        c = replace(cfg, moe=replace(cfg.moe, dropless=dropless))
        counts = {}
        with torch.no_grad():
            for name in ("unsharded", "sharded"):
                kops.reset_launches()
                if name == "sharded":
                    with activation_sharding(mesh, pc):
                        logits, aux = ttr.forward_train(view, c, {"tokens": tokens})
                else:
                    logits, aux = ttr.forward_train(params, c, {"tokens": tokens})
                torch.cuda.synchronize()
                counts[name] = (kops.launches["bsr_sdd"], kops.launches["bsr_spmm"], logits,
                                float(aux))
                del logits
        (k3u, k2u, lu, au), (k3s, k2s, ls, a_s) = counts["unsharded"], counts["sharded"]
        _, rel = rel_err(ls, lu)
        want = (2, 1) if dropless else (0, 0)
        ok = (rel <= TOL["torch.bfloat16"] and (k3s, k2s) == (k3u, k2u) == want
              and bool(torch.isfinite(ls.float()).all()) and a_s == au)
        print(f"  {path}: logits sharded vs unsharded max|err|/max|ref| {rel:.3e} (tol "
              f"{TOL['torch.bfloat16']:g}; bit for bit: {bool(torch.equal(ls, lu))}), aux "
              f"{a_s:.6f} vs {au:.6f}; K3/K2 launches {k3s}/{k2s} vs {k3u}/{k2u} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 16b: {path} forward under the mesh differs")
        keys["bsr_sdd"][f"shard_moe_{path}_launches"] = k3s
        keys["bsr_spmm"][f"shard_moe_{path}_launches"] = k2s
        del counts, lu, ls
    del params, dparams, view, tokens
    torch.cuda.empty_cache()
    return keys


def phase_model_sharding(args, torch, kops, dev):
    """Phase 16: model sharding in a one-rank group (NCCL on the card, a
    file store under build/): 16a the sharded train step, 16b DeepSeek-V2's
    forward under activation_sharding, 16c the checkpoint round trip, 16d
    the training CLI with --devices 1. Returns {kernel: keys}."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.launch.mesh import make_local_mesh

    t_start = time.perf_counter()
    m = serve_modules()
    pc = ParallelConfig()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    os.makedirs(ROOT / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="pg-") as pg:
        if dev.type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(backend, init_method=f"file://{pg}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_local_mesh(("pod", "data", "model"), (1, 1, 1))
            with temp_plans(m):
                train = ms_train(args, torch, kops, m, dev, mesh, pc)
            keys = ms_moe(args, torch, kops, m, dev, pc)
        finally:
            dist.destroy_process_group()
    keys["bsr_spmm"].update(train)
    print("phase 16d: the training CLI with --devices 1 (a one-rank group), then --resume")
    train_cli("phase 16d", ["--arch", "llama3-8b", "--sable", "--reduced", "--devices", "1"])
    print(f"phase 16: {time.perf_counter() - t_start:.1f} s")
    return keys


# ---------------------------------------------------------------------- #
# phase 17: sharded serving and the dry-run
# ---------------------------------------------------------------------- #
SS_SABLE = (8, 512, 16)  # 17a: llama3-8b-sable (TRAIN_LAYERS layers): B, prompt, decode steps
SS_DS = (4, 512, 8)  # DeepSeek-V2, dense layer 0 and DS_MOE_LAYERS MoE layers, dropless
SS_M2 = (8, 512, 16)  # mamba2-1.3b whole
SS_SM = (8, 512, 32, 16)  # seamless whole: B, source frames, prompt, decode steps
# 17b: the dry-run CLI's cells: (arch, shape, --multi-pod)
DRYRUN_CELLS = (("llama3-8b", "train_4k", "single"), ("deepseek-v2-236b", "decode_32k", "single"),
                ("mamba2-1.3b", "long_500k", "single"),
                ("seamless-m4t-large-v2", "prefill_32k", "single"),
                ("llama3-8b", "train_4k", "multi"))
DR_B, DR_S = 8, 512  # 17c: dense llama3-8b's prefill, traced and run


def one_rank_dtensors(torch, tree, shardings):
    """``tree``'s leaves as DTensors laid out by ``shardings`` on a one-rank
    mesh, each on its own storage (``distribute`` copies a split leaf)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves, tree_unflatten

    out = []
    for leaf, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        assert sh.mesh.size() == 1
        out.append(DTensor.from_local(leaf, sh.mesh, sh.placements, run_check=False,
                                      shape=leaf.shape, stride=leaf.stride()))
    return tree_unflatten(tree, out)


def ss_case(torch, kops, m, dev, mesh, pc, label, cfg, params, B, P, G, gen, src_len=0):
    """17a: one model's prefill of B x P tokens (after encode, for an
    enc-dec model) and G decode steps of random tokens, unsharded, then on
    ``mesh`` with params and cache as DTensors from make_shardings(
    param_specs / cache_specs) under activation_sharding, each under
    deterministic algorithms. The logits (gathered) and every cache leaf
    must be bit for bit the same both ways, and K2/K3 launch as often.
    Returns the case's keys."""
    from repro_torch.distributed.ctx import activation_sharding
    from repro_torch.distributed.sharding import cache_specs, make_shardings, param_specs
    from repro_torch.tree import tree_leaves

    ttr = m["ttr"]
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    steps = torch.randint(0, cfg.vocab_size, (G, B, 1), generator=gen, device=dev)
    src = (torch.randn(B, src_len, cfg.frontend_dim, generator=gen, device=dev)
           if cfg.is_encdec else None)

    def run(p, cache, sharded):
        kops.reset_launches()
        logits, times = [], []
        ctx = activation_sharding(mesh, pc) if sharded else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = ttr.encode(p, cfg, src) if cfg.is_encdec else None
            lg, back = ttr.prefill(p, cfg, tokens, cache, enc_out=enc)
            logits.append(ttr.whole_logits(lg, cfg, B))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for i in range(G):
                t0 = time.perf_counter()
                lg, back = ttr.decode_step(p, cfg, steps[i], cache, P + i)
                logits.append(ttr.whole_logits(lg, cfg, B))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        assert back is cache
        return logits, dict(kops.launches), times

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cache_u = ttr.init_cache(cfg, B, P + G, enc_len=src_len, device=dev)
        lu, nu_, tu = run(params, cache_u, False)
        c = ttr.init_cache(cfg, B, P + G, enc_len=src_len, device=dev)
        model = int(mesh.size(tuple(mesh.mesh_dim_names).index("model")))
        cache_s = one_rank_dtensors(torch, c, make_shardings(
            mesh, pc, cache_specs(cfg, c, pc, model), c))
        dparams = one_rank_dtensors(torch, params, make_shardings(
            mesh, pc, param_specs(cfg, params), params))
        ls, ns, ts = run(dparams, cache_s, True)
    finally:
        torch.use_deterministic_algorithms(prev)
    same_logits = all(torch.equal(a, b) for a, b in zip(ls, lu))
    same_cache = all(torch.equal(a.full_tensor(), b)
                     for a, b in zip(tree_leaves(cache_s), tree_leaves(cache_u)))
    finite = all(bool(torch.isfinite(x.float()).all()) for x in ls)
    k = ("bsr_spmm", "bsr_sdd")
    same_launches = all(ns[n] == nu_[n] for n in k)
    dec = lambda t: statistics.median(t[1:]) * 1e3  # noqa: E731
    ok = same_logits and same_cache and finite and same_launches
    print(f"  {label}: prefill {B} x {P} + {G} decode steps; logits {len(ls)} x "
          f"{tuple(ls[0].shape)} and {len(tree_leaves(cache_s))} cache leaves, sharded vs "
          f"unsharded bit for bit: {same_logits} / {same_cache}; K2/K3 launches "
          f"{ns['bsr_spmm']}/{ns['bsr_sdd']} vs {nu_['bsr_spmm']}/{nu_['bsr_sdd']}; prefill "
          f"{ts[0] * 1e3:.2f} vs {tu[0] * 1e3:.2f} ms, decode a step (median, deterministic "
          f"algorithms) {dec(ts):.2f} vs {dec(tu):.2f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 17a: {label} sharded serving differs from unsharded")
    del cache_u, cache_s, dparams, lu, ls
    return dict(k2=ns["bsr_spmm"], k3=ns["bsr_sdd"], prefill_ms=ts[0] * 1e3,
                plain_prefill_ms=tu[0] * 1e3, decode_ms=dec(ts), plain_decode_ms=dec(tu))


def ss_serve(args, torch, kops, m, dev, mesh, pc):
    """17a: the four models, one at a time. Returns {kernel: keys}."""
    ttr = m["ttr"]
    keys = {"bsr_spmm": {}, "bsr_sdd": {}}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    cases = (("sable", f"llama3-8b-sable ({TRAIN_LAYERS} layers, FFN pinned to cuda)",
              train_model(m, TRAIN_LAYERS, "bfloat16"), SS_SABLE),
             ("ds", f"{DS} (layer 0 dense, {DS_MOE_LAYERS} MoE, dropless)",
              moe_model(DS, DS_MOE_LAYERS, "bfloat16"), SS_DS),
             ("m2", f"{M2} whole", mamba2_model("bfloat16"), SS_M2),
             ("sm", f"{SM} whole", sm_model(m), SS_SM))
    for tag, label, cfg, shape in cases:
        t0 = time.perf_counter()
        params = ttr.init_params(cfg, gen, device=dev)
        if tag == "sable":
            pin_strategy(m, list(m["tlayers"].sable_patterns(cfg).values()), "cuda", dev)
        B, rest = shape[0], shape[1:]
        src_len = rest[0] if tag == "sm" else 0
        P, G = rest[-2:]
        r = ss_case(torch, kops, m, dev, mesh, pc, f"{label} [{time.perf_counter() - t0:.1f} s "
                    "to draw]", cfg, params, B, P, G, gen, src_len)
        if tag in ("sable", "ds"):
            keys["bsr_spmm"].update({f"shard_serve_{tag}_{k}": v for k, v in r.items()
                                     if k != "k3"})
            keys["bsr_spmm"][f"shard_serve_{tag}_launches"] = keys["bsr_spmm"].pop(
                f"shard_serve_{tag}_k2")
        if tag == "ds":
            keys["bsr_sdd"]["shard_serve_ds_launches"] = r["k3"]
        if (tag in ("sable", "ds")) and r["k2"] == 0:
            raise AssertionError(f"phase 17a: {label} never launched K2")
        if tag == "ds" and r["k3"] == 0:
            raise AssertionError("phase 17a: DeepSeek-V2 never launched K3")
        del params
        torch.cuda.empty_cache()
    return keys


def dryrun_start(tmp):
    """17b: the dry-run CLI's cells in subprocesses (CPU only: fake tensors
    on the trace device cuda), started together."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for i, (arch, shape, pods) in enumerate(DRYRUN_CELLS):
        out = Path(tmp) / f"cell{i}"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--multi-pod", pods, "--device", "cuda", "--out", str(out)]
        procs.append((cmd, out, time.perf_counter(), subprocess.Popen(
            cmd, env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    return procs


def dryrun_finish(procs) -> dict:
    """17b: each cell's exit code, status, per-rank GB, FLOPs and dominant
    roofline term (a model from data-sheet peaks). Returns keys."""
    keys = {}
    for cmd, out, t0, p in procs:
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            raise AssertionError(f"phase 17b: {' '.join(cmd[2:])} did not finish")
        reps = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
        ok = p.returncode == 0 and reps and all(r["status"] == "ok" for r in reps)
        for r in reps:
            mem, roof = r.get("memory", {}), r.get("roofline", {})
            print(f"  17b {r['arch']} x {r['shape']} x {r['mesh']} (--device cuda): rc "
                  f"{p.returncode}, {r['status']}; per rank args "
                  f"{mem.get('argument_size_in_bytes', 0) / 1e9:.3f} GB, peak "
                  f"{mem.get('peak_size_in_bytes', 0) / 1e9:.3f} GB, "
                  f"{r.get('hlo_flops_per_device', 0):.6g} FLOPs, roofline compute / memory / "
                  f"collective {roof.get('t_compute_s', 0) * 1e3:.3f} / "
                  f"{roof.get('t_memory_s', 0) * 1e3:.3f} / "
                  f"{roof.get('t_collective_s', 0) * 1e3:.3f} ms -> {roof.get('dominant')} "
                  f"(trace {r.get('trace_time_s')} s; the process "
                  f"{time.perf_counter() - t0:.1f} s)")
            keys[f"dryrun_{r['arch']}_{r['shape']}_{r['mesh']}_peak_gb".replace("-", "_")
                 .replace(".", "_")] = mem.get("peak_size_in_bytes", 0) / 1e9
        if not ok:
            print(stdout[-2000:], stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"phase 17b: {' '.join(cmd[2:])} failed")
    return keys


def dryrun_held(args, torch, dev, mesh, pc):
    """17c: dense llama3-8b's prefill of DR_B x DR_S built by the dry-run's
    build_cell on a one-rank (1, 1) mesh, once traced on fake tensors and
    once run on the card: the traced FLOPs must equal FlopCounterMode's over
    the run; the traced peak beside torch.cuda.max_memory_allocated, the
    roofline's largest term beside the measured ms. Returns keys."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun, trace_stats
    from repro_torch.launch.mesh import HW

    cfg = get_config("llama3-8b")
    shape = Shape("prefill_8x512", DR_S, DR_B, "prefill")
    with dryrun._traced(), torch.no_grad():
        fn, fargs = dryrun.build_cell(cfg, shape, mesh, pc, dev)
        stats = trace_stats.trace(fn, fargs, mesh, HW["node_size"])
        del fn, fargs
    stats.pop("result")
    rep = dryrun.analyze(stats, cfg, shape, mesh)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    with torch.no_grad():
        fn, fargs = dryrun.build_cell(cfg, shape, mesh, pc, dev)
        fn()  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with trace_stats.flop_counter() as fc:
            fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        ms = median_ms(fn, 5)
    del fn, fargs
    torch.cuda.empty_cache()
    real = float(fc.get_total_flops())
    roof = rep["roofline"]
    top = max(("compute", "memory", "collective"), key=lambda k: roof[f"t_{k}_s"])
    ok = real == stats["flops"] and real > 0
    print(f"  17c: llama3-8b prefill {DR_B} x {DR_S} on a (1, 1) mesh (float32 params, "
          f"bfloat16 compute): FLOPs traced {stats['flops']:.6g} vs counted over the run "
          f"{real:.6g} ({'equal' if ok else 'DIFFER'}); peak live bytes traced "
          f"{stats['memory']['peak_size_in_bytes'] / 1e9:.3f} GB (arguments "
          f"{stats['memory']['argument_size_in_bytes'] / 1e9:.3f}) vs "
          f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB over the {before / 1e9:.3f} GB "
          f"held before the cell; roofline (data-sheet peaks) "
          f"compute / memory / collective {roof['t_compute_s'] * 1e3:.3f} / "
          f"{roof['t_memory_s'] * 1e3:.3f} / {roof['t_collective_s'] * 1e3:.3f} ms, largest "
          f"{top}, vs measured {ms:.3f} ms (median of 5, CUDA events)")
    if not ok:
        raise AssertionError("phase 17c: the traced FLOPs differ from the run's")
    return dict(dryrun_prefill_flops=real, dryrun_prefill_traced_peak_gb=stats["memory"][
        "peak_size_in_bytes"] / 1e9, dryrun_prefill_peak_gb=peak / 1e9, dryrun_prefill_ms=ms,
        dryrun_prefill_roofline_ms=roof[f"t_{top}_s"] * 1e3)


def phase_sharded_serve(args, torch, kops, dev):
    """Phase 17: sharded serving in a one-rank group (NCCL on the card, a
    file store under build/): 17a four models' prefill and decode with
    DTensor params and caches against unsharded, bit for bit; 17b the
    dry-run CLI in subprocesses (started first, they run on the host's
    cores meanwhile); 17c the dry-run's build_cell traced and run. Returns
    {kernel: keys}."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.launch.mesh import make_local_mesh

    t_start = time.perf_counter()
    m = serve_modules()
    pc = ParallelConfig()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    os.makedirs(ROOT / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="dryrun-") as tmp:
        print(f"phase 17b: the dry-run CLI, {len(DRYRUN_CELLS)} cells in subprocesses, started "
              "now (fake process groups of 256 and 512 ranks, fake tensors on the trace "
              "device cuda; nothing on the card)")
        procs = dryrun_start(tmp)
        with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="pg-") as pg:
            if dev.type == "cuda":
                torch.cuda.set_device(torch.cuda.current_device())
            dist.init_process_group(backend, init_method=f"file://{pg}/store", rank=0,
                                    world_size=1)
            try:
                mesh = make_local_mesh(("pod", "data", "model"), (1, 1, 1))
                print("phase 17a: sharded prefill and decode in a one-rank group on "
                      "make_local_mesh(('pod', 'data', 'model'), (1, 1, 1)), params and "
                      "caches DTensors (make_shardings of param_specs / cache_specs), "
                      "bfloat16 compute, deterministic algorithms both ways")
                with temp_plans(m):
                    keys = ss_serve(args, torch, kops, m, dev, mesh, pc)
                print(f"phase 17c: the dry-run's cell held to a run on the card")
                held = dryrun_held(args, torch, dev, make_local_mesh(("data", "model"), (1, 1)),
                                   pc)
            finally:
                dist.destroy_process_group()
        keys["bsr_spmm"].update(held)
        keys["bsr_spmm"].update(dryrun_finish(procs))
    print(f"phase 17: {time.perf_counter() - t_start:.1f} s")
    return keys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=25, help="timed calls per median (>= 20)")
    ap.add_argument("--verbose-build", action="store_true", help="show the compiler's output")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import StagingOptions, stage_spmm, stage_spmv, synthesize_paper
    from repro_torch.kernels import _build, ops as kops, ref as kref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the library yardstick's beta-state and kernel-tuning notices
    warnings.filterwarnings("ignore", message=r"(Sparse|bsr_dense_addmm)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)  # name, power limit: as nvidia-smi prints them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # -- phase 1 ---------------------------------------------------------
    _build.load_kernels(verbose=args.verbose_build)
    print(f"phase 1: kernels built in {_build.build_seconds():.1f} s")

    # -- phase 2 ---------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    phase_kernels(rng, torch, kops, kref)

    # -- phase 3 ---------------------------------------------------------
    print("phase 3: main path at paper size (10000 x 10000, n = 128)")
    dev = torch.device("cuda")
    n_cols = 128
    mats = {
        "u": synthesize_paper(50, 50, 500, zeros_pct=20, seed=args.seed),
        "nu": synthesize_paper(100, 100, 500, zeros_pct=20, uniform=False, seed=args.seed),
    }
    dtypes = (torch.float32, torch.bfloat16)
    runs = []  # (matrix name, dtype, spmv kernel, spmm kernel, val, x, X)
    for name, v in mats.items():
        val = torch.as_tensor(v.val, device=dev)
        x = torch.as_tensor(rng.standard_normal(v.shape[1]).astype(np.float32), device=dev)
        X = torch.as_tensor(
            rng.standard_normal((v.shape[1], n_cols)).astype(np.float32), device=dev
        )
        for dtype in dtypes:
            opts = StagingOptions(backend="cuda", dtype=dtype)
            ks, km = stage_spmv(v, opts), stage_spmm(v, n_cols, opts)
            t = ks.tiled
            print(
                f"  {name} {str(dtype)[6:]}: stored={v.stored_nnz} tiles={t.n_tiles} "
                f"tile={t.tm}x{t.tk} padded_fraction={t.padded_fraction:.4f} "
                f"stage0_spmv={ks.stage0_time:.3f}s stage0_spmm={km.stage0_time:.3f}s"
            )
            runs.append((name, dtype, ks, km, val, x, X))

    kops.reset_launches()
    outs = [(ks(val, x), km(val, X)) for _, _, ks, km, val, x, X in runs]
    torch.cuda.synchronize()
    launches = dict(kops.launches)
    print(f"  launches on the main path: {launches}")
    for name in ("bsr_spmv", "bsr_spmm"):
        if launches[name] == 0:
            raise AssertionError(f"main path never launched {name}")

    for (name, dtype, ks, km, val, x, X), (y, ym) in zip(runs, outs):
        v = mats[name]
        # the inputs the kernels saw, in float32
        val_in, x_in, X_in = (a.to(dtype).float() for a in (val, x, X))
        ref_s = stage_spmv(v, StagingOptions(backend="grouped"), device=dev)(val_in, x_in)
        ref_m = stage_spmm(v, n_cols, StagingOptions(backend="grouped"), device=dev)(val_in, X_in)
        dense = torch.as_tensor(v.to_dense(), device=dev).to(dtype).float()
        tag = f"{name} {str(dtype)[6:]}"
        check(f"stage_spmv {tag} vs grouped", y, ref_s, dtype)
        check(f"stage_spmv {tag} vs dense", y, dense @ x_in, dtype)
        check(f"stage_spmm {tag} vs grouped", ym, ref_m, dtype)
        check(f"stage_spmm {tag} vs dense", ym, dense @ X_in, dtype)
        if not (torch.isfinite(y.float()).all() and torch.isfinite(ym.float()).all()):
            raise AssertionError(f"{tag}: non-finite output")
        del dense

    # -- phase 4 ---------------------------------------------------------
    print(f"phase 4: times (median of {args.reps} calls, CUDA events; K1/K2, their plain "
          f"versions and library calls each after an L2 flush)")
    ext = _build.load_kernels()
    flush = l2_flush(torch)
    tiny = torch.empty(32, device=dev)
    print(f"  launch floor: one kernel that does nothing, timed the same way "
          f"ms={median_ms(tiny.zero_, args.reps, flush):.4f}")
    records, call_times = {}, {}
    for name, dtype, ks, km, val, x, X in runs:
        tag = f"{name} {str(dtype)[6:]}"
        for kname, rec in time_kernels(args, torch, kref, ext, flush, ks, km, val, x, X,
                                       tag, profile=name == "u").items():
            records[(kname, name, str(dtype))] = rec
        for kind, k, dense_x in (("spmv", ks, x), ("spmm", km, X)):
            # the same staged call on values packed once
            kp = (stage_spmv(mats[name], replace(k.opts, prepack=True)) if kind == "spmv"
                  else stage_spmm(mats[name], n_cols, replace(k.opts, prepack=True)))
            packed = kp.pack(val)
            call_ms = median_ms(lambda: k(val, dense_x), args.reps)
            packed_ms = median_ms(lambda: kp(packed, dense_x), args.reps)
            print(f"  stage_{kind} {tag}: fn(val, x) ms={call_ms:.4f} prepacked ms={packed_ms:.4f}")
            call_times[(name, kind, str(dtype))] = call_ms
            del kp, packed

    # -- phases 5-7 --------------------------------------------------------
    del runs, outs, flush
    torch.cuda.empty_cache()
    phase_sdd(rng, torch, kops, kref)
    moe_records, moe_launches = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        # one dtype's params at a time: float32's 15.3 GB and its buffers need
        # the bfloat16 layer's memory freed
        state = phase_moe(args, torch, kops, kref, dtype)
        moe_launches[str(dtype)] = state[-1]
        moe_records.update(phase_moe_times(args, torch, kops, kref, *state[:-1], dtype))
        del state
        torch.cuda.empty_cache()

    # -- phase 8 -----------------------------------------------------------
    tile_records, winners = phase_tuning(args, torch, kops, kref, mats, call_times, dev)

    # -- phase 9 -----------------------------------------------------------
    ffn_records, serve_k2, serve_tps = phase_serve(args, torch, kops, kref, dev)

    # -- phase 10 ----------------------------------------------------------
    cb_keys = phase_continuous(args, torch, kops, dev, serve_tps)

    # -- phase 11 ----------------------------------------------------------
    moe_serve_keys = phase_moe_serve(args, torch, kops, kref, dev)

    # -- phase 12 ----------------------------------------------------------
    mamba_keys = phase_mamba_serve(args, torch, kops, kref, dev)

    # -- phase 13 ----------------------------------------------------------
    train_keys = phase_train(args, torch, kops, kref, dev)

    # -- phase 14 ----------------------------------------------------------
    phase_encdec(args, torch, kops, dev)

    # -- phase 15 ----------------------------------------------------------
    shard_keys = phase_sharded(args, torch, kops, kref, mats, dev)

    # -- phase 16 ----------------------------------------------------------
    model_shard_keys = phase_model_sharding(args, torch, kops, dev)

    # -- phase 17 ----------------------------------------------------------
    serve_shard_keys = phase_sharded_serve(args, torch, kops, dev)
    short = {"bfloat16": "bf16", "float32": "f32"}
    ffn_rows = [  # K2 at the FFN shapes: ffn_* the `in` pattern, ffn_out_* the `out` one
        (f"ffn{'' if p == 'in' else '_out'}_{shape}_{short[d]}", dict(r, launches=serve_k2))
        for (p, shape, d), r in ffn_records.items()
    ]

    # K1, K2: u float32 on the first path; K3: float32 at the MoE prefill
    # tables, launched by the float32 layer; beside them the other rows
    final = {k: (records[(k, "u", "torch.float32")], launches[k])
             for k in ("bsr_spmv", "bsr_spmm")}
    final["bsr_sdd"] = (moe_records[("bsr_sdd", "prefill", "torch.float32")],
                        moe_launches["torch.float32"]["bsr_sdd"])
    summary = []
    for kname, (source, replaces) in KERNELS.items():
        rec, n = final[kname]
        extra = {}  # the other rows: u bfloat16 and nu, the MoE tables
        for key, r in (("u_bf16", records.get((kname, "u", "torch.bfloat16"))),
                       ("nu_f32", records.get((kname, "nu", "torch.float32"))),
                       ("nu_bf16", records.get((kname, "nu", "torch.bfloat16"))),
                       *((f"moe_{shape}_{short}", moe_records.get((kname, shape, dt)))
                         for dt, short in (("torch.bfloat16", "bf16"), ("torch.float32", "f32"))
                         for shape in ("prefill", "decode")),
                       # the sweep's other tiles, float32
                       *((f"tile_{mat}_{tm}x{tk}_f32", r) for (k, mat, (tm, tk)), r
                         in tile_records.items() if k == kname),
                       # the served model's FFN shapes; launches: the pinned-cuda serve
                       *(ffn_rows if kname == "bsr_spmm" else ())):
            if r is not None:
                for k in ("ms", "bound_ms", "library_ms", "fma_bound_ms", "plain_ms",
                          "launches", "transpose_ms"):
                    if k in r:
                        extra[f"{key}_{k}"] = r[k]
        if kname in ("bsr_spmv", "bsr_spmm"):  # phase 8's cold tunes' winners
            extra["tune_winners"] = winners["spmv" if kname == "bsr_spmv" else "spmm"]
        if kname == "bsr_spmm":  # phase 10: launches and step times under continuous batching
            extra.update(cb_keys)
        extra.update(moe_serve_keys.get(kname, {}))  # phase 11: llama4-scout, DeepSeek-V2
        extra.update(mamba_keys.get(kname, {}))  # phase 12: jamba
        extra.update(train_keys.get(kname, {}))  # phase 13: the backward's tables, training
        extra.update(shard_keys.get(kname, {}))  # phase 15: sharded staging
        extra.update(model_shard_keys.get(kname, {}))  # phase 16: model sharding
        extra.update(serve_shard_keys.get(kname, {}))  # phase 17: sharded serving, dry-run
        summary.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces, launches=n, **rec,
            **extra,
        ))
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each, each ending with its seconds:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
     and the build of every kernel from ``src/repro_torch/csrc`` (nvcc runs at
     first use; ptxas register and spill lines are printed);
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     shapes of the HPCG 104^3 path: ``scs_spmv`` on the finest level's tiled
     plan, on the resident plan of 52^3 and on the resident plans of the
     tuner's power law and of the block matrix (each with its blocks,
     windows, chunks and real j-steps; the bound counts each entry's id and
     value, x, y, perm and the cached index, ``bound_staged_ms`` what the
     kernel stages, and ``bound_every_slot_ms`` the bound that reads every
     slot),
     ``dia_spmv`` through its dispatch adapter on every HPCG level (104^3,
     52^3, 26^3, 13^3) and masked, on each level, with the first color of
     the masks ``SymGS.build`` makes, against ``where(mask, A @ x, 0)``
     (exact; its bound counts the in-range values of the color's rows, the
     x words they read, the mask and y; its yardstick is cuSPARSE on the
     color's rows with the others left empty),
     ``dia_spmv_tiled`` through its plan adapter on the finest level under
     ``max_resident_cols=1<<18``,
     ``ell_spmv`` on 52^3 and 13^3 with its one-tile index built once, the
     masked ELL wrapper on every 8th row of 52^3 (exact; its bound counts
     the kept rows' id slots and real values, the x words they read, the
     mask and y; its yardstick is cuSPARSE on the kept rows),
     ``ell_spmv_tiled``
     on the finest level's ``"ell-cols"`` plan with its tile index built
     once beforehand (its build seconds, pairs and the bytes the kernel
     stages are printed; the bound counts the real ids and values, x, y and
     the index, and ``bound_every_id_slot_ms`` keeps the bound that reads
     every id slot), ``coo_spmv`` through its container adapter on 13^3 and
     ``scoo_spmv_tiled`` on the finest level's ``"coo-cols"`` plan,
     ``scoo_spmv`` on the finest level's ``build_scoo`` layout (slices and
     blocks of 512; no dispatch path calls it, so its own path here is one
     call, counted like the others), and ``bsr_spmm`` and its masked form on
     the block matrix of phase 8 at 1 and 128 columns (with the path that
     ran: tensor cores or CUDA cores; at 128 columns both paths and the
     plain version are also held against an f64 oracle, on the block matrix
     and on the conformance grid's matrix, at rtol 2e-4 with atol 2e-4).
     Each line gives the
     median kernel time (CUDA events around one call, which also catch the
     wrapper's host time), the kernel's device time alone
     (``torch.profiler``, from traces whose two timed ranges of 20 calls
     each hold 20 times the records one call makes, as a range of three
     calls counts them; a reading under the bound fails the run), the
     plain version's time, one PyTorch library
     call on the same matrix as a yardstick (never called by the port: a
     cuSPARSE CSR SpMV, or for ``bsr_spmm`` ``torch.sparse_bsr_tensor @ X``)
     by events (``library_ms``) and by its device time in every kernel it
     runs (``library_kernel_ms``),
     the bound from the run's own arrays (bytes at 3.35 TB/s against flops
     at 67 TFLOP/s, or for ``bsr_spmm`` at 165 TFLOP/s), and whether two
     launches gave equal bits;
  3. HPCG 16^3 on the card: ``valid`` and ``bitwise``; its three
     tolerance solves (reference, check, tuned) each captured as
     ``CapturedCG`` (the reference's jitted ``lax.while_loop``: a setup and
     a chunk of iterations as CUDA graphs, the chunk replayed until the
     device's flag drops) and each held to the eager ``cg``: equal ``x``
     bits and iterations (``conv_equal``), a ``[hpcg 16^3 conv graph
     <solve>]`` line each (iterations taken and computed, replays, host
     reads, capture and instantiation seconds, nodes, seconds);
  4. the main path, ``run_hpcg(104, 104, 104, iters=50, depth=4, reps=3)``
     racing coo/csr/dia/ell/sell/bsr x plain/cuda (bsr skipped by the
     block-fill guard at every level), with the launch counters and
     the health registry reset just before it and read just after. It
     requires ``bitwise``, ``rel_err < 1e-3``, no failure or non-finite
     output on any key, every cuda candidate timed in the main race, no race
     that lists an error or was not timed on CUDA graphs (every race
     captures each candidate's ``spmv`` as the reference jits it, times its
     replays, holds the last replay to the eager call's bits, and prints
     ``graph``, its capture and instantiation seconds and its replay-equal
     candidates; a ``[<path> race graphs]`` line sums a path's races; a
     captured race's launches are its warm-ups' and captures'), and
     ``scs_spmv``, ``dia_spmv``, ``ell_spmv``,
     ``ell_spmv_tiled``, ``coo_spmv`` and ``scoo_spmv_tiled`` launched. Every
     race (the main one and each level's) is printed with its skips. Both
     timed solves (csr/plain and tuned) are captured in one CUDA graph each
     and timed by 3 replays beside one eager solve (cut from 3, as phases 9
     and 11 have it, to keep the smoke inside its limit), run with
     PyTorch's sync debug mode at "error" (a host read in a warm solve fails
     the run); a line for each prints both medians, the capture and
     instantiation seconds, the graph's nodes and the kernel launches counted
     in the capture (the graph's launches a solve). Every replay must give
     the eager solve's ``x`` and ``rs`` bit for bit (``graph_equal``).
     The three tolerance solves run captured (conv graph lines as phase
     3's), and the tuned one also eagerly beside it, timed once, with
     ``conv_equal`` required;
  5. the path that takes the tiled DIA kernel, counted on its own the same
     way: a column-limited operator (``max_resident_cols=1<<18``) tuned over
     the cuda kernels and solved with CG, which must agree with csr/plain CG
     and launch ``dia_spmv_tiled``;
  6. the run-first tuner on an unstructured matrix of 10^6 rows
     (``random_uniform(10**6, 8e-6)``; cut from three, printed as ``[tuner
     cut]``), raced through
     ``as_operator(s, device="cuda").tune(...)`` over the same ten keys:
     ``coo/cuda`` must be listed ``unsupported`` (more than 8192 rows, no
     plan), the tuned ``A @ x`` must agree with csr/plain, and a cuda
     winner's kernel must launch for it;
  7. Matrix Market input: every ``tests/fixtures/corpus/*.mtx`` through
     ``repro_torch.io.iter_corpus``, the same race, and ``A @ x`` against
     scipy's ``s @ x``; ``coo_spmv`` must launch on this path;
  8. the block path: ``block_random(65536, 32, 16/2048)`` (34,699 blocks of
     32x32, 35,531,776 entries) through ``as_operator(s, "csr").tune(...)``
     over the same twelve keys (dia skipped by its guard, coo/cuda
     unsupported, bsr/cuda timed), ``A @ x`` and ``A @ X`` (128 columns) of
     the tuned operator and of a bsr operator on the cuda backend against
     csr/plain, the masked bsr SpMV exact, ``bsr_spmm`` launched, and
     ``tune(mode="predict")`` on the same matrix, which launches no kernel;
  9. ``run_hpcg(104, 104, 104, iters=50, depth=4, tune_mode="predict")``:
     phase 3 ranked by the zero-run selector's ``"cuda"`` table, no race;
     ``valid`` and ``bitwise``, its level picks and t_opt, and phase 4's
     graph lines and ``graph_equal`` with one eager solve and one timed
     replay (after a warm one), and its captured tolerance solves' conv
     graph lines;
 10. the serving path (``repro_torch.serve``) at tenants of 2^20 rows, four
     runs each counted on its own: **hot** (one banded tenant, 512 requests
     flushed every 64 through ``ServeEngine(capacity=8, max_batch=32,
     tune_mode="predict")``: one admission, 16 coalesced tiles of 32),
     **churn** (9 tenants of the four archetypes against 8 slots, cut
     from 16, and 68 requests, cut from 128: a window of 64 admits each
     tenant once and one of 4 brings an evicted tenant back, re-tuned;
     healthy tiles replay the engine's captured lanes, and a ``[serve
     graph]`` line holds hot against an eager window of 64 requests over
     the same warm pool; one admission by stage for each predicted key is
     ``examples/serve_admission.py``'s, printed as a ``[serve cut]``),
     **dynamic** (``mutable``
     on the hot tenant, 1% of its rows
     gain an entry off its band, ``ov @ x`` against the merged matrix in f64,
     ``refresh`` must re-tune, then 64 requests under the new fingerprint;
     and the same lane on an 8,192-row tenant, whose delta ``coo_spmv``
     takes) and **chaos** (``FaultSpec("kernel", key=(the hot tenant's
     format, "cuda"), times=3)`` on the hot engine: the breaker quarantines
     the key, every ticket resolves, and each request served off ``cuda``
     equals the plain lane bit for bit). Each line gives the summary
     (latency p50/p99, throughput, hit rate, hits/misses/evictions, tunes,
     fallbacks, batch sizes, coalesced fraction), each tenant's key, the
     launches per kernel, the health snapshot, the seconds and the bytes the
     warm pool holds (``pool_bytes``; ``memory_allocated`` after the last
     flush). Every served ``y`` must agree with its tenant's csr/plain at
     rtol 2e-4, every coalesced row equal ``op @ x`` bit for bit, the
     healthy runs show no retry, degraded request, fallback or failed key,
     churn's misses exceed its tenants and each miss tunes, and hot and
     churn's admissions, batches, hits, misses and evictions equal a replay
     of the same traffic on the host at 4,096 rows, untuned;
 11. the distributed path (``repro_torch.distributed_op``), HPCG 104^3 over
     ``PartMesh.on("cuda", parts=4)``, two runs each counted on its own:
     **dist** (a) ``run_hpcg_distributed`` with depth clamped to 3 by
     ``distributable_depth``, 50 iterations, tol 1e-6, every part and every
     level tuned over csr/dia/ell/coo x plain/cuda, its timed phase (captured
     as phase 4's, on the four parts of one card) cut to one eager
     repetition (printed as ``[dist cut]``), its two tolerance solves
     captured (conv graph lines); it requires ``valid``,
     ``bitwise``, ``graph_equal`` and ``rel_res <= 1e-6`` and prints
     pcg_iters, t_ref, t_opt, the graph lines,
     each tuned operator's per-part choices and race tables, and for every
     part the key the race picked beside the key dispatch runs
     (``DistributedOperator.dispatched``); after that run, every tuned
     operator (the main one and each level's) is held against serial
     csr/plain at rtol 2e-4, and one SymGS color's ``masked_matvec`` exactly
     against ``where(mask, A @ x, 0)`` (each grid's x, serial product and
     mask made once and shared with (b)); **dist_pairs** (b) the paper's pairs
     dia+coo and ell+coo, and ell+dia (DIA on the rectangular remote
     windows, where the race puts it), on their cuda keys at 104^3, 52^3
     and 26^3 (each level's split timed, with its halo and each part's local
     and remote entries): the same two checks, each block running its
     fixed key (remote coo printed as running plain above 8,192 rows a
     part), and each kernel launched once a part for every block that runs
     it, masked and not, at every level (``coo_spmv`` at 26^3);
     (c) rowblock csr/plain at 104^3 bit for bit against serial csr/plain;
     (d) ``FaultSpec(site="halo", times=1)`` makes one matvec differ and
     leaves the next one equal;
 12. the model path (``repro_torch.models``, ``launch/serve.py``'s LM loop):
     ``qwen3-moe-235b-a22b`` at its published widths cut to 4 of its 94
     layers, built on the card from a seeded generator (weights but the
     router in bf16), counted as one path: (a) ``serve_lm`` serves batch 4,
     prompt 32, gen 32 on the bsr dispatch lane under
     ``use_backend("cuda")`` (prompt ms, tok/s, ms/token p50/p99,
     ``bsr_spmm`` launches, peak memory), then one decode step runs under
     ``torch.cuda.set_sync_debug_mode("error")`` at an int position and
     one at a 0-dim tensor position, and the same params are served again
     with ``graph=True`` (``CapturedDecode``, the reference's jitted,
     donated step): a ``model graph`` line with the capture and
     instantiation seconds, the graph's nodes, ``bsr_spmm`` launches a
     step, the timings and peak memory, and ``graph_equal`` (every step's
     logits and every token equal to the eager serve's, bit for bit, or
     the run fails); phase 12 alone then traces one eager step and one
     replay with ``torch.profiler`` (device-busy ms over wall ms, the five
     longest kernels); (b) the served tokens
     fed through the same model under ``use_backend("plain")``: each
     step's logits within 8 eps(bf16) max|logit| of the served run's on
     every batch row routed alike so far (at least 3/4 of the row-steps),
     and equal greedy tokens wherever plain's top-2 margin exceeds that;
     (c) one ``moe_ffn`` a lane (sort, coo and bsr on ``cuda``, onehot) on
     the first layer's weights, 128 tokens of f32: each within rtol 1e-4,
     atol 1e-5 of sort (aux rtol 1e-5), the bsr and coo dispatch matrices
     giving ``x[t_s]`` bit for bit; sort run twice and grouped (two
     groups, at a capacity where neither lane drops a pick, held to sort
     there) run twice, each giving equal bits; then, outside the count, (d)
     ``bsr_spmm`` at the decode step's dispatch (exact) and combine shapes
     and ``coo_spmv`` on the 128-token combine's unsorted entries (exact),
     each with the line phase 2 prints, the cost of a step's two BSR
     containers and of a COO container's first call, and (e) one expert's
     ``w_down`` pruned to BSR (density 0.25, blocks of 32) through
     ``bsr_linear`` at 4 and 128 tokens against plain and the masked dense
     product, and ``block_sparse_attention`` at 64 heads of 128, batch 4,
     1,024 positions, banded blocks of 64, against a dense masked oracle;
 13. ``deepseek-v2-236b`` at its published widths (MLA, 160 experts top-6
     plus 2 shared, a leading dense layer) cut to 4 of its 60 layers (1
     dense, 3 MoE), served and checked as phase 12 (a)-(d), its path
     counted on its own (the kernel line's ``launches_model`` sums phases
     12-14); (d) is ``bsr_spmm`` at its decode dispatch (1280 x 4) and
     combine (4 x 1281) against 5120 columns; (e) the first layer's MLA
     fed the prompt token by token through the absorbed ``mla_decode``,
     against the direct ``mla_train`` at the reference's bound (0.05
     max|want|, f32);
 14. ``jamba-v0.1-52b`` at its published widths cut to one period of 8 of
     its 32 layers (7 Mamba mixers, 1 attention, 4 MoE slots of 16
     experts top-2), served and checked as phase 13 (a)-(d) (dispatch 128
     x 4, combine 4 x 129, 4096 columns);
 15. training (``repro_torch.train``): (a) ``bsr_spmm``'s backward kernels,
     ``bsr_spmm_t`` (dX = A^T dY) and ``bsr_sddmm`` (dB = dY X^T at the
     stored blocks), at the training step's shapes (the MoE dispatch's dX,
     1280 block rows x 8 slots; the combine's dH and dB, 128 x 64 against
     10,241 columns; bs 8, nf 4096, bf16 blocks), routed by a random
     router and, for the combine, as (b)'s first step routes it (its
     column of dropped picks holds thousands of blocks, so the kernels
     cut it in many chunks), and on the block matrix (bs 32, 128 columns),
     each against its plain version and against
     autograd through ``bsr_spmm_plain`` (rtol 2e-4), two launches
     bit-equal, with ``ms``, ``kernel_ms``, ``plain_ms``, the bound and one
     PyTorch call (torch's BSR product on A^T; ``torch.sparse.sampled_addmm``
     over the blocks' entries), and the forward ``bsr_spmm`` at the
     dispatch's and the combine's shapes with the line phase 12d prints
     (its bound at 165 TFLOP/s, as the backward's); (b)
     ``qwen3-moe-235b-a22b`` at its published widths cut to 1 layer (3.73
     G parameters, f32 weights and AdamW state), batch 8 x seq 128, on the bsr lane under
     ``use_backend("cuda")`` and PyTorch's deterministic mode: step 0's
     gradients of the router, one expert stack and the embedding twice
     (equal bits) and on the plain lane (within ``TRAIN_GRAD_REL_L2``),
     the router's gradient from the cross entropy non-zero, then
     ``TRAIN_STEPS`` steps of ``make_train_step``, counted as the train
     path (loss, grad_norm, lr and ms a step; p50, tokens/s, peak memory);
     (c) at smoke size, ``python -m repro_torch.launch.train --smoke
     --dispatch-impl bsr --steps 12 --ckpt-every 4`` (its step captured),
     the ``Trainer``'s captured run with a failure at step 10 (``restore``
     writes step 8's checkpoint into the graph's tensors) against the
     captured run without one (steps 8, 9, 11 equal in bits; the CLI's
     final loss the clean run's), the clean captured run against the
     clean eager one (``graph=False``; every step's loss equal in bits),
     and ``examples/train_lm_torch.py --quick --inject-failure``; (d) (b)'s
     model, batch and seed through the ``Trainer`` on the card, whose step
     is captured in one CUDA graph (``repro_torch.train.CapturedTrainStep``,
     the reference's ``jax.jit(step_fn, donate_argnums=(0, 1))``): step 0
     the warm-up and the capture, every later step a replay, each step's
     loss and grad_norm equal to (b)'s in bits, counted as the
     ``train_graph`` path; ms a step, the replays' p50 beside (b)'s,
     capture and instantiation seconds, nodes, the hand-written kernel
     launches a replay makes, peak allocated and reserved memory (the
     graph's private pool included);
 16. the roofline, the dry run and the compressed all-reduce: (a) for each
     LM cell of phases 12-15, at that phase's own depth and shape, the
     analytic bound of ``repro_torch.roofline`` (the reference's
     per-device model over the card's peaks, chips 1: t_compute, t_memory,
     the bottleneck) beside the p50 the phase measured (no new timing);
     (b) ``CompressedAllReduce`` over ``PartMesh.on("cuda", parts=4)``,
     chunk 256, 2^28 f32 a part from a seeded generator: the mean within
     rel 0.05 of the true mean, 0 < max|err| < 0.05 max|v|, two calls equal
     in bits, at 2^20 the card's mean and residual the host's bit for bit;
     ms by events, the bytes it must move against 3.35 TB/s, peak memory;
     (c) ``launch.dryrun.build_cell`` on the ``meta`` device for
     qwen3-moe-235b-a22b train_4k and deepseek-v2-236b decode_32k on the
     single-pod mesh (status, bottleneck, the terms, counted/analytic, and
     the collective term: counts and bytes by kind, traced on the 256-rank
     ``DeviceMesh`` of torch's ``"fake"`` group, priced at NVLink's 450 GB/s);
 17. the model's sharding on the card, its step captured: the ``Trainer``
     on the ``--mesh local`` ``DeviceMesh`` (NCCL, one rank a card: (1, 1)
     for this lone process), phase 15b's model (full width, 1 layer, the
     'bsr' lane under ``use_backend("cuda")``), batch and seed for
     ``SHARDED_STEPS`` steps, every parameter and AdamW moment a DTensor:
     first eagerly (``graph=False``, uncounted), then through the step
     captured in one CUDA graph (``repro_torch.train.CapturedTrainStep`` on
     DTensors, the reference's ``jax.jit(step_fn, in_shardings=...,
     out_shardings=..., donate_argnums=(0, 1))``; the default on a CUDA
     mesh of one rank): step 0 the warm-up (DTensor's first sharding
     propagation) and the capture, the later steps replays. Each run's
     loss and grad_norm equal phase 15b's first steps in bits (every mesh
     axis is 1); the captured run is counted as the ``train_sharded`` path
     (``bsr_spmm``, ``bsr_spmm_t`` and ``bsr_sddmm`` launched from the MoE's
     ``local_map`` region at the warm-up and the capture); its line gives
     the replays' p50 beside 15d's and the eager mesh steps', the warm-up's
     ms, capture and instantiation seconds, nodes, the kernel launches a
     replay, and peak allocated and reserved memory (15d's graph and state
     freed before it); then a ``save`` and ``restore`` round trip of a
     captured mesh ``Trainer`` at smoke size on the same mesh: the live
     state zeroed, the restore writes into it (every leaf's local
     ``data_ptr`` kept, the saved bits and placements).

The line before last is a JSON object with each kernel's numbers
(``launches`` is the count on the path that requires the kernel;
``launches_<path>`` gives every path's count (``train``: phase 15b's
steps; ``train_graph``: phase 15d's warm-up and capture, a replay runs
uncounted; ``train_sharded``: phase 17's captured run's warm-up and
capture, likewise), and ``dia_spmv``'s
``launches_split`` its launches on the HPCG paths by level, masked or not,
``g^3/4`` for a part of a level on the distributed paths); the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero. It needs ``torch.cuda.is_available()`` and the repository's
``src/`` and ``tests/fixtures/corpus`` beside it. Full numbers also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "tests", "fixtures", "corpus")
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet, 700 W), from the port's one roofline
#: model: HBM3 bandwidth and f32 outside the tensor cores (the roofline of a
#: CUDA-core f32 SpMV), and f32 products on the tensor cores at f32 accuracy
#: (a 3xTF32 split: three passes at the dense TF32 peak of 495 TFLOP/s; one
#: pass misses rtol 2e-4), the fastest rate at which the card meets
#: ``bsr_spmm``'s tolerance.
from repro_torch.roofline import F32_FLOPS, TF32X3_FLOPS  # noqa: E402
from repro_torch.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402

#: HPCG's default local grid (the ``hpcg.dat`` of the reference distribution).
GRID = 104
#: The grids of its multigrid levels at depth 4.
LEVELS = (GRID, GRID // 2, GRID // 4, GRID // 8)
#: The ``max_resident_cols`` that sends the 104^3 matrix to the tiled kernels.
COLUMN_LIMIT = 1 << 18

KERNEL_SOURCES = {
    "scs_spmv": ("src/repro_torch/csrc/sell_spmv.cu", "src/repro/kernels/sell_spmv.py:64"),
    "dia_spmv": ("src/repro_torch/csrc/dia_spmv.cu", "src/repro/kernels/dia_spmv.py:58"),
    "dia_spmv_tiled": ("src/repro_torch/csrc/dia_spmv.cu", "src/repro/kernels/dia_spmv.py:135"),
    "ell_spmv": ("src/repro_torch/csrc/ell_spmv.cu", "src/repro/kernels/ell_spmv.py:43"),
    "ell_spmv_tiled": ("src/repro_torch/csrc/ell_spmv.cu", "src/repro/kernels/ell_spmv.py:92"),
    "coo_spmv": ("src/repro_torch/csrc/coo_spmv.cu", "src/repro/kernels/coo_spmv.py:85"),
    "scoo_spmv_tiled": ("src/repro_torch/csrc/coo_spmv.cu",
                        "src/repro/kernels/coo_spmv.py:200"),
    "scoo_spmv": ("src/repro_torch/csrc/coo_spmv.cu", "src/repro/kernels/coo_spmv.py:141"),
    "bsr_spmm": ("src/repro_torch/csrc/bsr_spmm.cu", "src/repro/kernels/bsr_spmm.py:44"),
    "bsr_spmm_t": ("src/repro_torch/csrc/bsr_spmm_grad.cu",
                   "src/repro/kernels/bsr_spmm.py:44 (its backward: no TPU counterpart)"),
    "bsr_sddmm": ("src/repro_torch/csrc/bsr_spmm_grad.cu",
                  "src/repro/kernels/bsr_spmm.py:44 (its backward: no TPU counterpart)"),
}

#: The kernels each format's cuda entry may launch.
FORMAT_KERNELS = {"csr": ("scs_spmv",), "sell": ("scs_spmv",),
                  "dia": ("dia_spmv", "dia_spmv_tiled"),
                  "ell": ("ell_spmv", "ell_spmv_tiled"),
                  "coo": ("coo_spmv", "scoo_spmv_tiled"), "bsr": ("bsr_spmm",)}

#: The reference's DEFAULT_CANDIDATES without dense (n^2 at 104^3).
CANDIDATES = [(fmt, impl) for fmt in ("coo", "csr", "dia", "ell", "sell", "bsr")
              for impl in ("plain", "cuda")]

#: The paths on which each kernel must launch (the JSON line's ``launches``
#: is the first one's count): the HPCG run (phase 4), the column-limited CG
#: (phase 5), the one ``scoo_spmv`` call of phase 2, the block path (phase
#: 8), the serving path (phase 10), the distributed fixed pairs (phase 11)
#: the model paths (phases 12-14) or the train path (phase 15).
REQUIRED_ON = {"scs_spmv": ("hpcg", "serve"), "dia_spmv": ("hpcg", "serve", "dist_pairs"),
               "dia_spmv_tiled": ("tiled_cg",), "ell_spmv": ("hpcg", "dist_pairs"),
               "ell_spmv_tiled": ("hpcg",),
               "coo_spmv": ("hpcg", "serve", "dist_pairs", "model"),
               "scoo_spmv_tiled": ("hpcg",), "scoo_spmv": ("scoo",),
               "bsr_spmm": ("block", "model", "train", "train_graph", "train_sharded"),
               "bsr_spmm_t": ("train", "train_graph", "train_sharded"),
               "bsr_sddmm": ("train", "train_graph", "train_sharded")}

#: What a kernel's entry in the JSON line carries beyond the contract's keys:
#: its other shapes (``bsr_spmm``'s SpMM and masked forms, ``scs_spmv`` off
#: the 104^3 plan, DIA at 52^3, 26^3 and 13^3 and masked per level, ELL at
#: 13^3, ``bsr_spmm`` at the MoE decode dispatch and combine and
#: ``coo_spmv`` on the MoE combine's unsorted entries), the path
#: ``bsr_spmm`` ran, and the staged and every-slot bounds.
EXTRA_KEYS = ("path", "masked", "spmm", "coarse", "powerlaw", "block", "shape_52",
              "shape_26", "shape_13", "moe_dispatch", "moe_combine", "moe_combine_unsorted",
              "deepseek_dispatch", "deepseek_combine", "jamba_dispatch", "jamba_combine",
              "train_dispatch", "train_combine", "step_combine", "work_list_ms", "library",
              "library_error", "bound_staged_ms", "bound_every_slot_ms", "bound_every_id_slot_ms")

#: The block matrix of the block path: ``block_random(n, bs, density)``.
BLOCK_MATRIX = (65536, 32, 16 / 2048)
#: Columns of X on the block path's SpMM.
BLOCK_NF = 128

#: The unstructured matrices of the tuner phase (10^6 rows: x fits whole,
#: so every format takes its resident strategy).
#: The serving phases: tenants of 2^20 rows (the size of the tuner phase's
#: matrices), the reference's engine knobs at its serving benchmark's
#: ``bench`` scale (``benchmarks/serve_bench.py``: capacity 8, max_batch 32,
#: flush every 64, 16 churn tenants), the requests of each mix, the rows of
#: the host replay that checks the warm pool's counters, and the rows of the
#: tenant whose delta the full-window ``coo_spmv`` takes (``max_onehot_rows``).
SERVE_N = 1 << 20
SERVE_CAPACITY, SERVE_MAX_BATCH, SERVE_FLUSH_EVERY = 8, 32, 64
SERVE_CHURN_TENANTS = 9
SERVE_REQUESTS = {"hot": 512, "churn": 68}
#: Why churn sends 68 requests, not 128: a window of 64 admits each tenant
#: once, and a second window of 4 brings an evicted tenant back; 128
#: requests over 16 tenants make 32 admissions and took 261.8 s, and 72 (24
#: admissions) left the whole smoke at 1162.6 s of its 1200. Why 10
#: tenants, not 16: each 2^20-row admission takes ~10 s of host work, and
#: 16 tenants' 20 admissions took 181.8-229.9 s, the smoke 1136.2 s in its
#: slowest run; 10 tenants made 14 admissions (11 misses, one of them a
#: re-tuned readmission, and 3 hits) in ~125 s, ~11 s a miss. 9 tenants
#: make 13 (10 misses, the readmission kept, 3 hits): still one more than
#: the 8 slots, so the window evicts. NVIDIA H100 80GB HBM3, 700.00 W.
SERVE_CHURN_CUT = ("churn cut to 9 tenants (from 16) and 68 requests (from 128): a window "
                   "of 64 and one of 4, 13 admissions with a re-tuned readmission, not 32")
SERVE_STAGES_CUT = ("one admission by stage for each predicted key moved to "
                    "examples/serve_admission.py (it took 31.7 s of phase 10 on an H100 "
                    "80GB HBM3 at 700 W; churn's admissions still run every stage)")
SERVE_REPLAY_N = 4096
SMALL_TENANT = 8192
#: The summary fields a serving phase prints (``launch/serve.py``'s, and the
#: degraded-serving counters).
SERVE_SUMMARY_KEYS = ("requests", "batches", "admissions", "latency_p50_s", "latency_p99_s",
                      "throughput_rps", "hit_rate", "tunes", "dispatch_fallbacks",
                      "batch_size_mean", "batch_size_max", "coalesced_fraction", "retries",
                      "degraded_requests", "batch_splits", "errors")

#: The distributed path: HPCG 104^3 over four parts on one card, the
#: per-part race's keys (the stackable formats on both backends), the timed
#: phase's eager repetitions (cut from 3 to keep the smoke inside its limit;
#: the captured solve replays 3 times), and
#: pairs fixed on every distributed level (``distributable_depth(104, 104,
#: 104, 4)`` is 3: 13^3 does not split evenly in four): the paper's two,
#: and DIA on the rectangular remote windows, where the race puts it.
DIST_PARTS = 4
DIST_CANDIDATES = [(fmt, impl) for fmt in ("csr", "dia", "ell", "coo")
                   for impl in ("plain", "cuda")]
DIST_REPS = 1
DIST_LEVELS = (GRID, GRID // 2, GRID // 4)
DIST_PAIRS = {"dia+coo": (("dia", "cuda"), ("coo", "cuda")),
              "ell+coo": (("ell", "cuda"), ("coo", "cuda")),
              "ell+dia": (("ell", "cuda"), ("dia", "cuda"))}

#: The model path (phase 12): qwen3-moe-235b-a22b at its published widths
#: (d_model 4096, 64 heads over 4 kv heads of 128, 128 experts top-8 of
#: width 1536, vocab 151,936, qk-norm, bf16 activations), its 94 layers cut
#: to 4 (one MoE layer is 2.488 G parameters: 4 layers, the embedding and
#: the head are 11.2 G, 44.8 GB in f32, 22.4 GB in bf16), served as
#: ``launch/serve.py``'s LM loop serves it at the reference's CLI defaults
#: (batch 4, prompt 32, gen 32), on the bsr dispatch lane under
#: ``use_backend("cuda")``.
MODEL_ARCH = "qwen3-moe-235b-a22b"
MODEL_LAYERS = 4
MODEL_DEVICE = "cuda"
MODEL_SERVE = {"batch": 4, "prompt_len": 32, "gen": 32}
#: Tokens of the lane phases' single ``moe_ffn`` calls (f32 activations).
MODEL_LANE_T = 128


class ModelCell(NamedTuple):
    """One model the smoke serves: the key of its result lines (``model``
    for phase 12), the arch, its depth after the cut and how many of those
    layers route tokens through an MoE (one routing each a step)."""
    key: str
    arch: str
    layers: int
    routed: int


#: Phase 12 (above); phase 13, deepseek-v2-236b at its published widths
#: (d_model 5120, 128 heads, MLA kv_lora 512 / q_lora 1536 / rope 64 / nope
#: 128 / v 128, 160 experts top-6 of width 1536 plus 2 shared of 3072, a
#: leading dense layer of d_ff 12288, vocab 102,400) cut from 60 layers to
#: 4 (the dense one and 3 MoE: 13.3 G parameters, 26.6 GB in bf16); phase
#: 14, jamba-v0.1-52b at its published widths (d_model 4096, 32 heads over
#: 8 kv heads of 128, Mamba d_state 16 / conv 4 / expand 2, 16 experts
#: top-2 of width 14336 on every 2nd slot, d_ff 14336, vocab 65,536) cut
#: from 32 layers to one period of 8 (7 Mamba mixers, 1 attention, 4 MoE
#: slots: 13.3 G parameters, 26.6 GB in bf16), the least whole period.
#: Each is served as phase 12 serves its model.
MODEL_CELLS = {12: ModelCell("model", MODEL_ARCH, MODEL_LAYERS, MODEL_LAYERS),
               13: ModelCell("deepseek", "deepseek-v2-236b", 4, 3),
               14: ModelCell("jamba", "jamba-v0.1-52b", 8, 4)}
#: Phase 13e: the absorbed MLA decode against the direct form at the
#: reference's bound (``tests/test_models.py``: 0.05 max|want|, f32).
MLA_ATOL_OF_MAX = 0.05
#: bf16 logits of the served and the plain teacher-forced run agree within
#: ``MODEL_LOGIT_EPS * eps(bf16) * max|logit|`` a step, the tolerance of
#: ``tests/test_torch_models_lm.py``; a batch row is compared up to its
#: first step whose routing differs between the runs in any layer (a bf16
#: rounding can move a near-tie of two experts), and at least
#: ``MODEL_COMPARED`` of the row-steps must be compared.
MODEL_LOGIT_EPS = 8
MODEL_COMPARED = 0.75
#: The MoE lanes' contract (``tests/test_moe.py``): f32 y, aux.
MOE_RTOL, MOE_ATOL, MOE_AUX_RTOL = 1e-4, 1e-5, 1e-5
#: Phase 12e: one expert's ``w_down`` pruned to a quarter of its 32x32
#: blocks, applied to 4 and 128 tokens; block-sparse attention at the
#: config's 64 heads of 128, batch 4, 1,024 positions, blocks of 64, banded.
PRUNE_DENSITY, PRUNE_BS, PRUNE_TOKENS = 0.25, 32, (4, 128)
ATTN_B, ATTN_S, ATTN_BLOCK = 4, 1024, 64

#: Phase 15, training: qwen3-moe-235b-a22b at its published widths cut to
#: one layer (3.73 G parameters: embedding 622.3 M, head 622.3 M, attention
#: 71.3 M, router 0.5 M, experts 2,415.9 M; at 16 B a parameter for f32
#: weights, gradients and both AdamW moments that is 59.7 GB, and two layers
#: would be 98 GB), on the 'bsr' lane under ``use_backend("cuda")`` at the
#: reference launcher's batch 8 x seq 128 (1,024 tokens a step), a few
#: steps; f32 weights and AdamW state (``keep_master=False``, the
#: reference's default).
TRAIN_ARCH = MODEL_ARCH
TRAIN_LAYERS = 1
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_STEPS = 5
TRAIN_DEVICE = "cuda"
#: Step 0's gradients on bsr/cuda against bsr/plain, relative L2 per leaf:
#: the activations are bf16, and the plain lane's SpMM multiplies and adds
#: in bf16 through torch's einsum where the kernels add in f32, so the
#: combine's outputs (and every gradient below them) may differ by bf16
#: roundings (2^-8 each). Measured on an H100: 1.1e-3 at most, on the
#: embedding (PERF.md).
TRAIN_GRAD_REL_L2 = 1e-2
#: Phase 15c: the launcher's smoke run and the trainer's restart.
TRAIN_CLI_STEPS, TRAIN_FAIL_AT = 12, 10

#: Phase 16b: the int8 compressed all-reduce over four parts of the card,
#: each part's vector 2^28 f32 (1 GiB): a fifth of llama3.2-1b's 1.24 G
#: gradient, cut by the card's 80 GB (four parts' vectors, residuals and
#: outputs all live on one card); chunk 256, vectors from a seeded
#: generator, checked at the reference test's bounds and, at
#: ``ALLREDUCE_CHECK_N``, against the same call on host tensors.
ALLREDUCE_PARTS, ALLREDUCE_N, ALLREDUCE_CHUNK = 4, 1 << 28, 256
ALLREDUCE_CHECK_N = 1 << 20
ALLREDUCE_REL, ALLREDUCE_ERR_OF_MAX = 0.05, 0.05
#: Phase 16c: two cells of the dry run on the ``meta`` device.
DRYRUN_CELLS = (("qwen3-moe-235b-a22b", "train_4k"), ("deepseek-v2-236b", "decode_32k"))
#: Phase 17: the sharded Trainer's steps (phase 15b's first ones: a warm-up
#: and the capture, then two replays); the round trip is at smoke size: the
#: full-width state (59.7 GB) would take minutes to write and read back,
#: past the smoke's time limit.
SHARDED_STEPS = 3

TUNER_MATRICES = (("random_uniform(10**6, 8e-6)", "random_uniform", (10 ** 6, 8e-6)),)
#: Why one matrix, not three: the banded and power-law races at 10^6 rows
#: took 27.7 of phase 6's 50.2 s on an H100 80GB HBM3 at 700 W (mostly
#: host conversions) and their paths
#: are held elsewhere: a banded tenant of 2^20 rows takes dia/cuda in phase
#: 10 (hot), as the HPCG races do, and a power law of 2^20 csr/cuda in
#: churn, with ``scs_spmv`` on ``powerlaw(10**6, 8)``'s plan in phase 2.
TUNER_CUT = "tuner cut to random_uniform(10**6, 8e-6) (from banded, random_uniform, powerlaw)"
#: The tolerance solves of HPCG (the reference's jitted ``lax.while_loop``):
#: phase 3 holds each captured one to the eager ``cg``; phase 4 the tuned one.
CONV_SOLVES = ("ref", "chk", "opt")


def phase(label: str, **kv) -> dict:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)
    return kv


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of one ``fn()`` in ms, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


#: The profiler ranges ``kernel_ms`` marks: two runs of the timed calls.
KERNEL_MS_MARKS = ("kernel_ms_a", "kernel_ms_b")


def kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time of one ``fn()`` in ms spent in kernels whose name holds
    ``kernel``, from ``torch.profiler``: the kernel alone, without the
    wrapper's host time that CUDA events around a small call also catch.
    Each trace runs lead-in calls first and three last (a trace may lose
    the records of its first and last kernels) around two ranges of
    ``reps`` timed calls, each ending in a synchronize. It counts the device
    records that start inside each range and takes the trace only when the
    two ranges hold equal counts, a positive multiple of ``reps``: a trace
    that lost records, or holds one of an earlier trace, is dropped. A
    trace can lose the records of its first milliseconds: each retry
    doubles the lead-in, from 3 calls. ``None`` when eight traces in a row
    fall short."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def trace(lead):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                fn()
            torch.cuda.synchronize()
            for mark in KERNEL_MS_MARKS:
                with record_function(mark):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        spans = {e.name: e.time_range for e in events
                 if e.device_type == DeviceType.CPU and e.name in KERNEL_MS_MARKS}
        records = [e for e in events if e.device_type != DeviceType.CPU
                   and e.name not in KERNEL_MS_MARKS and kernel in e.name]
        # a record belongs to the range its kernel starts in: each range
        # ends in a synchronize, so no kernel starts in one and ends later
        return [[e for e in records if spans[m].start <= e.time_range.start <= spans[m].end]
                for m in KERNEL_MS_MARKS]

    fn()
    torch.cuda.synchronize()
    counts = []
    for attempt in range(8):  # a trace now and then comes back without some records
        a, b = trace(3 << attempt)
        if len(a) == len(b) and len(a) > 0 and len(a) % reps == 0:
            return sum(e.time_range.elapsed_us() for e in a + b) / (2 * reps) / 1e3
        counts.append((3 << attempt, len(a), len(b)))
    print(f"[kernel_ms] {kernel!r} not measured: (lead-in calls, records in each of two "
          f"ranges of {reps} calls) per trace {counts}", flush=True)
    return None  # not measured


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved: int, flops: int, flops_per_s: float = F32_FLOPS):
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def color_bytes(offsets, mask, n: int) -> int:
    """Bytes a masked resident DIA call must move (f32 values): the
    in-range stored values of the mask's rows, the distinct x words they
    read, the mask and y (written whole)."""
    import torch

    rows = mask.nonzero().flatten().long()
    seen = torch.zeros(n, dtype=torch.bool, device=mask.device)
    values = 0
    for off in offsets.tolist():
        k = rows + off
        k = k[(k >= 0) & (k < n)]
        values += k.numel()
        seen[k] = True
    return 4 * values + 4 * int(seen.sum()) + n + 4 * n


def within(what: str, y, want, rtol=2e-4) -> float:
    """Max abs error of ``y`` against ``want``, which it must meet at the
    conformance grid's f32 tolerance: rtol 2e-4 with an atol scaled to
    ||want||_inf (sums of a row's products reassociated)."""
    import torch

    y, want = y.double().cpu(), want.double().cpu()
    check(bool(torch.isfinite(y).all()), f"{what}: non-finite output")
    err = (y - want).abs()
    atol = rtol * float(want.abs().max())
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{what}: disagreement beyond rtol {rtol} (max err {float(err.max())})")
    return float(err.max())


def phase_kernels(results: dict, block) -> tuple:
    """Phase 2: every kernel against its plain version at the main path's
    shapes (``block`` is the block path's scipy matrix); returns the
    per-kernel numbers the JSON line reports and the launches of the one
    ``scoo_spmv`` call that is that kernel's path."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.core import ExecutionPolicy, as_operator, matrices as M
    from repro_torch.core.convert import to_bsr, to_coo, to_csr, to_dia, to_ell
    from repro_torch.kernels import ops
    from repro_torch.kernels._launch import segment_starts
    from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_path, bsr_spmm_plain
    from repro_torch.kernels.coo_spmv import (build_scoo, coo_spmv_from_container,
                                              coo_spmv_plain, scoo_spmv, scoo_spmv_plain,
                                              scoo_spmv_tiled, scoo_spmv_tiled_plain)
    from repro_torch.kernels.dia_spmv import (dia_spmv_from_container, dia_spmv_plain,
                                              dia_spmv_tiled_from_plan, dia_spmv_tiled_plain)
    from repro_torch.kernels.ell_spmv import (CHUNK_ROWS, ell_spmv, ell_spmv_plain,
                                              ell_spmv_tiled, ell_spmv_tiled_plain,
                                              ell_tile_index)
    from repro_torch.kernels.sell_spmv import scs_spmv_from_plan, scs_spmv_plain
    from repro_torch.solvers.symgs import SymGS

    dev = torch.device("cuda")
    out = {}

    def csr_library(s, x):
        """One cuSPARSE CSR SpMV of ``s`` and ``x``: the yardstick call."""
        A = torch.sparse_csr_tensor(torch.from_numpy(s.indptr.astype(np.int64)),
                                    torch.from_numpy(s.indices.astype(np.int64)),
                                    torch.from_numpy(s.data.astype(np.float32)),
                                    size=s.shape).to(dev)
        return lambda: A @ x

    def vec(n):
        return torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                                .astype(np.float32)).to(dev)

    def measure(name, label, s, x, fn, plain, moved, kernel, plain_reps=5, exact=False,
                flops=None, flops_per_s=F32_FLOPS, library=None, **extra):
        """Kernel against plain (exactly when ``exact``), two launches
        bit-equal, then the times; ``moved`` is the bytes the function must
        move for this input, ``flops`` its operations (default two per
        nonzero) at ``flops_per_s``, ``kernel`` the CUDA kernel's name,
        ``library`` the yardstick call (default a cuSPARSE CSR SpMV of ``s``
        and ``x``; ``False``: none), timed by events (``library_ms``) and by
        its device time in every kernel it runs (``library_kernel_ms``)."""
        y, y_plain = fn(), plain()
        err = within(f"{label} against its plain version", y, y_plain)
        same = bool(torch.equal(y, y_plain))
        if exact:
            check(same, f"{label}: kernel differs from its plain version")
        check(bool(torch.equal(y, fn())), f"{label}: two launches differ")
        b_ms, b_by = bound(moved, 2 * s.nnz if flops is None else flops, flops_per_s)
        lib = csr_library(s, x) if library is None else library
        k_ms = kernel_ms(fn, kernel)
        check(k_ms is None or k_ms >= b_ms,
              f"{label}: kernel_ms {k_ms} under its bound {b_ms}: an impossible reading")
        rec = dict(extra, exact=same, repeat_equal=True, max_abs_err=err,
                   ms=cuda_ms(fn, 50), kernel_ms=k_ms,
                   plain_ms=cuda_ms(plain, plain_reps),
                   library_ms=cuda_ms(lib, reps=20) if lib else None,
                   library_kernel_ms=kernel_ms(lib, "") if lib else None,
                   bytes=moved, flops=2 * s.nnz if flops is None else flops,
                   bound_ms=b_ms, bound_by=b_by)
        del lib
        results[name] = phase(f"kernel {label}", **rec)
        return rec

    def scs_row(name, label, s, x, **extra):
        """``scs_spmv`` on ``s``'s csr plan through the dispatch adapter
        (real j-steps and work list cached on the plan). The bound counts
        what the function needs: each entry's id and value, x, y, perm and
        the cached index. ``bound_staged_ms`` counts what the kernel stages
        (every slot of the real j-steps, their slices, each block's tile),
        ``bound_every_slot_ms`` every slot of the plan, padding included."""
        n = s.shape[0]
        A = to_csr(s, device=dev)
        plan = A.plan
        btile, bwin, lsl, idx2, dat2, perm = plan.arrays
        ct, ntiles, C, sw, jb, nwin = plan.meta
        y = scs_spmv_from_plan(plan, x, nrows=n)  # fills the plan's cache
        nreal, work = plan.cache["nreal"], plan.cache["work"]
        real = int(nreal.sum())
        runs = segment_starts(bwin, nwin)
        rest = nbytes(x, perm, nreal, *work[:4]) + n * 4
        needed = s.nnz * (idx2.element_size() + dat2.element_size()) + rest
        staged = real * (C * (idx2.element_size() + dat2.element_size()) + 4) + rest + nbytes(
            btile)
        del y
        return measure(
            name, label, s, x, lambda: scs_spmv_from_plan(plan, x, nrows=n),
            lambda: scs_spmv_plain(*plan.arrays, x, nrows=n, col_tile=ct, ntiles=ntiles,
                                   C=C, sw=sw, jb=jb, nwin=nwin),
            needed, "scs_", plain_reps=3, strategy=ops.cuda_strategy(A, ExecutionPolicy()),
            ntiles=ntiles, blocks=int(btile.shape[0]), windows=nwin,
            longest_window_blocks=int((runs[1:] - runs[:-1]).max()),
            chunks=int(work.chunk_win.shape[0]), chunk_blocks=work.chunk_blocks,
            split_windows=int(work.split_win.shape[0]), real_jsteps=real,
            jstep_slots=int(idx2.shape[0]), index_dtype=str(idx2.dtype),
            bound_staged_ms=bound(staged, 2 * s.nnz)[0],
            bound_every_slot_ms=bound(nbytes(btile, lsl, idx2, dat2, perm, runs, x) + n * 4,
                                      2 * s.nnz)[0], **extra)

    mats = {g: M.fdm27(g, g, g) for g in LEVELS}
    out["scs_spmv"] = scs_row("scs_spmv_finest", f"scs_spmv finest {GRID}^3", mats[GRID],
                              vec(mats[GRID].shape[0]), grid=GRID)
    others = {"coarse": (f"scs_spmv coarse {GRID // 2}^3", mats[GRID // 2]),
              "powerlaw": ("scs_spmv powerlaw(10**6, 8)", M.powerlaw(10 ** 6, 8)),
              "block": ("scs_spmv block_random(65536, 32, 16/2048)", block)}
    for key, (label, s) in others.items():
        rec = scs_row(f"scs_spmv_{key}", label, s, vec(s.shape[0]))
        out["scs_spmv"][key] = {k: rec[k] for k in (
            "max_abs_err", "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms",
            "bound_ms",
            "bound_staged_ms", "bound_every_slot_ms", "blocks", "windows", "chunks",
            "real_jsteps")}
        del s
    torch.cuda.empty_cache()

    # resident DIA at every HPCG level, and masked on one SymGS color of each
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False)
    zero = torch.zeros((), device=dev)
    for g in LEVELS:
        sg = mats[g]
        ng = sg.shape[0]
        xg = vec(ng)
        D = to_dia(sg, device=dev)
        rec = measure(
            f"dia_spmv_{g}", f"dia_spmv {g}^3", sg, xg,
            lambda: dia_spmv_from_container(D, xg), lambda: dia_spmv_plain(D.offsets, D.data, xg),
            nbytes(D.offsets, D.data, xg) + ng * 4, "dia_resident_kernel", exact=True,
            grid=g, strategy=ops.cuda_strategy(D, ExecutionPolicy()), ndiags=D.ndiags)
        if g == GRID:
            out["dia_spmv"] = rec
        else:
            out["dia_spmv"][f"shape_{g}"] = {k: rec[k] for k in (
                "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms", "bound_ms",
                "bound_by")}
        # the masks SymGS.build makes (the greedy coloring's classes); the first
        mask = SymGS.build(sg, operator=as_operator(D)).masks[0]
        ym = ops.dia_masked_spmv_cuda(D, xg, mask, pol)
        check(bool(torch.equal(ym, torch.where(mask, ops.dia_spmv_cuda(D, xg, pol), zero))),
              f"masked DIA {g}^3 != where(mask, A @ x, 0)")
        rows = mask.nonzero().flatten().cpu().numpy()
        # yardstick: cuSPARSE on the color's rows, the other rows left empty
        sm = sp.csr_matrix(sp.diags(mask.cpu().numpy().astype(np.float64)) @ sg)
        rec = measure(
            f"dia_masked_{g}", f"dia_spmv masked {g}^3 (one SymGS color)", sg, xg,
            lambda: ops.dia_masked_spmv_cuda(D, xg, mask, pol),
            lambda: dia_spmv_plain(D.offsets, D.data, xg, mask),
            color_bytes(D.offsets, mask, ng), "dia_resident_kernel", exact=True,
            flops=2 * int(sm.nnz), library=csr_library(sm, xg), grid=g,
            color_rows=int(rows.size), equals_where_of_unmasked=True)
        out["dia_spmv"].setdefault("masked", {})[f"{g}^3"] = {k: rec[k] for k in (
            "color_rows", "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms",
            "bound_ms", "bound_by", "bytes")}
        del D, sm
    s, n = mats[GRID], mats[GRID].shape[0]
    x = vec(n)

    tpol = ExecutionPolicy(max_resident_cols=COLUMN_LIMIT)
    DT = to_dia(s, col_tile=tpol.col_tile(n), device=dev)
    check(ops.cuda_strategy(DT, tpol) == "tiled", "dia under the column limit is not tiled")
    offs_t, dat_w = DT.plan.arrays
    ct_d = DT.plan.ct
    out["dia_spmv_tiled"] = measure(
        "dia_spmv_tiled", f"dia_spmv_tiled {GRID}^3", s, x,
        lambda: dia_spmv_tiled_from_plan(DT.plan, x, n),
        lambda: dia_spmv_tiled_plain(offs_t, dat_w, x, nrows=n, col_tile=ct_d),
        nbytes(offs_t, dat_w, x) + n * 4, "dia_tiled_kernel", plain_reps=3, exact=True,
        grid=GRID, strategy="tiled", max_resident_cols=tpol.max_resident_cols, ct=ct_d,
        ntiles=DT.plan.ntiles, max_d=int(offs_t.shape[1]))
    del DT, offs_t, dat_w

    # ELL: resident on 52^3, the masked wrapper, tiled on the finest level
    g = GRID // 2
    s52 = mats[g]
    n52 = s52.shape[0]
    x52 = vec(n52)
    E = to_ell(s52, device=dev)
    check(ops.cuda_strategy(E, ExecutionPolicy()) == "resident", "ell 52^3 is not resident")
    valid = int((E.indices >= 0).sum())
    listed52 = ell_tile_index(E.indices.unsqueeze(0))
    out["ell_spmv"] = measure(
        "ell_spmv", f"ell_spmv {g}^3", s52, x52,
        lambda: ell_spmv(E.indices, E.data, x52, tile_index=listed52),
        lambda: ell_spmv_plain(E.indices, E.data, x52),
        nbytes(E.indices, x52, *listed52[:2]) + valid * E.data.element_size() + n52 * 4,
        "ell_listed_kernel", exact=True, grid=g, strategy="resident", width=E.width)
    mask52 = torch.from_numpy((np.arange(n52) % 8) == 3).to(dev)
    ym = ops.ell_masked_spmv_cuda(E, x52, mask52, pol)
    want = torch.where(mask52, ops.ell_spmv_cuda(E, x52, pol), torch.zeros((), device=dev))
    check(bool(torch.equal(ym, want)), "masked ELL != where(mask, A @ x, 0)")
    # its bound: the kept rows' id slots and real values, the x words they
    # read, the mask and y; its yardstick cuSPARSE on the kept rows alone
    kept_ids = E.indices[mask52]
    kept_real = kept_ids[kept_ids >= 0].long()
    seen = torch.zeros(n52, dtype=torch.bool, device=dev)
    seen[kept_real] = True
    sm52 = sp.csr_matrix(sp.diags(mask52.cpu().numpy().astype(np.float64)) @ s52)
    out["ell_spmv"]["masked"] = {k: v for k, v in measure(
        "ell_masked", f"ell_spmv masked {g}^3 (every 8th row)", s52, x52,
        lambda: ops.ell_masked_spmv_cuda(E, x52, mask52, pol),
        lambda: ell_spmv_plain(E.indices, E.data, x52, mask52),
        nbytes(kept_ids, x52[seen], mask52, *listed52[:2]) + kept_real.numel()
        * E.data.element_size() + n52 * 4,
        "ell_listed_kernel", exact=True, flops=2 * int(sm52.nnz),
        library=csr_library(sm52, x52), kept_rows=int(mask52.sum()),
        equals_where_of_unmasked=True).items() if k in (
        "kept_rows", "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms",
        "bound_ms", "bound_by", "bytes")}
    del E, kept_ids, kept_real, seen, sm52

    E = to_ell(s, device=dev)
    check(ops.cuda_strategy(E, ExecutionPolicy()) == "tiled", "ell 104^3 is not tiled")
    idx_t, dat_t = E.plan.arrays
    ct_e, width = E.plan.ct, int(idx_t.shape[2])
    valid = int((idx_t >= 0).sum())
    slots = idx_t.numel()
    torch.cuda.synchronize()
    t_index = time.perf_counter()
    listed = ell_tile_index(idx_t)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t_index
    tile_ptr, tile_ids, _ = listed
    chunk_rows = torch.full((tile_ptr.shape[0] - 1,), CHUNK_ROWS, device=dev)
    chunk_rows[-1] = n - CHUNK_ROWS * (chunk_rows.shape[0] - 1)
    staged = int(((tile_ptr[1:] - tile_ptr[:-1]) * chunk_rows).sum()) * width * (
        idx_t.element_size() + dat_t.element_size())
    out["ell_spmv_tiled"] = measure(
        "ell_spmv_tiled", f"ell_spmv_tiled {GRID}^3", s, x,
        lambda: ell_spmv_tiled(idx_t, dat_t, x, col_tile=ct_e, tile_index=listed),
        lambda: ell_spmv_tiled_plain(idx_t, dat_t, x, col_tile=ct_e),
        valid * (idx_t.element_size() + dat_t.element_size())
        + nbytes(x, tile_ptr, tile_ids) + n * 4,
        "ell_listed_kernel", plain_reps=3, exact=True,
        grid=GRID, strategy="tiled", ct=ct_e, ntiles=E.plan.ntiles, width=width,
        index_dtype=str(idx_t.dtype), slots=slots, nonzeros=valid, padding=slots / valid,
        pairs=int(tile_ids.shape[0]), chunks=int(tile_ptr.shape[0] - 1),
        tile_index_build_s=t_index, staged_bytes=staged,
        bound_every_id_slot_ms=bound(nbytes(idx_t, x) + valid * dat_t.element_size() + n * 4,
                                     2 * s.nnz)[0],
        bound_all_ms=bound(nbytes(idx_t, dat_t, x) + n * 4, 2 * s.nnz)[0])
    del E, idx_t, dat_t, listed, tile_ptr, tile_ids

    # ELL at 13^3, the level where HPCG launches ell_spmv most
    g = GRID // 8
    s13 = mats[g]
    n13 = s13.shape[0]
    x13 = vec(n13)
    E = to_ell(s13, device=dev)
    listed13 = ell_tile_index(E.indices.unsqueeze(0))
    valid = int((E.indices >= 0).sum())
    rec = measure(
        "ell_spmv_13", f"ell_spmv {g}^3", s13, x13,
        lambda: ell_spmv(E.indices, E.data, x13, tile_index=listed13),
        lambda: ell_spmv_plain(E.indices, E.data, x13),
        nbytes(E.indices, x13, *listed13[:2]) + valid * E.data.element_size() + n13 * 4,
        "ell_listed_kernel", exact=True, grid=g, width=E.width)
    out["ell_spmv"]["shape_13"] = {k: rec[k] for k in (
        "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms", "bound_ms",
        "bound_by")}
    del E

    # COO: full window on 13^3, sliced on the finest level
    Co = to_coo(s13, device=dev)
    check(ops.cuda_strategy(Co, ExecutionPolicy()) == "resident", "coo 13^3 is not resident")
    coo_spmv_from_container(Co, x13)  # checks Co and keeps its segment starts
    starts = Co.cache["rows"].row_start
    out["coo_spmv"] = measure(
        "coo_spmv", f"coo_spmv {g}^3", s13, x13,
        lambda: coo_spmv_from_container(Co, x13),
        lambda: coo_spmv_plain(Co.row, Co.col, Co.val, x13, nrows=n13),
        nbytes(starts, Co.col, Co.val, x13) + n13 * 4, "coo_rows_kernel", exact=True,
        grid=g, strategy="resident")
    del Co, starts

    Co = to_coo(s, device=dev)
    check(ops.cuda_strategy(Co, ExecutionPolicy()) == "tiled", "coo 104^3 is not tiled")
    row, col, val, sid, ctile = Co.plan.arrays
    ct_c, ntiles_c, slice_rows, tile = Co.plan.meta
    runs = segment_starts(sid, -(-n // slice_rows))
    out["scoo_spmv_tiled"] = measure(
        "scoo_spmv_tiled", f"scoo_spmv_tiled {GRID}^3", s, x,
        lambda: scoo_spmv_tiled(row, col, val, sid, ctile, x, nrows=n, col_tile=ct_c,
                                slice_rows=slice_rows, tile=tile, run_start=runs),
        lambda: scoo_spmv_tiled_plain(row, col, val, sid, ctile, x, nrows=n, col_tile=ct_c,
                                      tile=tile),
        nbytes(row, col, val, ctile, runs, x) + n * 4, "scoo_tiled_kernel",
        grid=GRID, strategy="tiled", ct=ct_c, ntiles=ntiles_c, slice_rows=slice_rows,
        tile=tile, blocks=int(sid.shape[0]), entries=int(row.shape[0]),
        index_dtype=str(col.dtype))
    del Co, row, col, val, sid, ctile, runs

    # a group of two entries: the slice's first row, another row and the pad
    # run (rows = the slice's first row) share one warp step
    dense = np.zeros((512, 128))
    dense[:, :64] = np.random.default_rng(19).standard_normal((512, 64)) * (
        np.arange(512 * 64).reshape(512, 64) % 17 == 0)
    dense[0, 100], dense[1, 100] = 1.5, -2.0
    Co = to_coo(sp.csr_matrix(dense), col_tile=64, device=dev)
    xs = vec(128)
    ct_c, _, slice_rows, tile = Co.plan.meta
    ys = scoo_spmv_tiled(*Co.plan.arrays, xs, nrows=512, col_tile=ct_c,
                         slice_rows=slice_rows, tile=tile)
    within("scoo_spmv_tiled beside a pad run against its plain version", ys,
           scoo_spmv_tiled_plain(*Co.plan.arrays, xs, nrows=512, col_tile=ct_c, tile=tile))
    del Co

    # scoo_spmv on the finest level's build_scoo layout (row-sorted COO)
    coo = s.tocoo()
    srow, scol, sval, ssid = (torch.from_numpy(a).to(dev) for a in build_scoo(
        coo.row, coo.col, coo.data.astype(np.float32), n, slice_rows=512, tile=512))
    del coo
    sruns = segment_starts(ssid, -(-n // 512))
    out["scoo_spmv"] = measure(
        "scoo_spmv", f"scoo_spmv {GRID}^3", s, x,
        lambda: scoo_spmv(srow, scol, sval, ssid, x, nrows=n, run_start=sruns),
        lambda: scoo_spmv_plain(srow, scol, sval, ssid, x, nrows=n),
        nbytes(srow, scol, sval, sruns, x) + n * 4, "scoo_tiled_kernel",
        grid=GRID, slice_rows=512, tile=512, blocks=int(ssid.shape[0]),
        entries=int(srow.shape[0]))
    want = torch.from_numpy(s @ x.double().cpu().numpy())

    def scoo_path():
        y = scoo_spmv(srow, scol, sval, ssid, x, nrows=n)
        within(f"scoo_spmv {GRID}^3 against scipy", y, want)

    _, launches_scoo, _ = counted("scoo", scoo_path)
    del srow, scol, sval, ssid, sruns
    torch.cuda.empty_cache()

    def bsr_f64_errors(label, sm, B, X):
        """``bsr_spmm`` on the tensor cores (X whole), on the CUDA cores (X a
        column at a time) and its plain version, each against an f64 oracle
        (the stored f32 values and X in f64, a cuSPARSE product on the card):
        the max abs error and the largest ratio of the error to the
        conformance grid's f32 tolerance ``2e-4 + 2e-4 * |y|``."""
        c = sp.csr_matrix(sm)
        A64 = torch.sparse_csr_tensor(
            torch.from_numpy(c.indptr.astype(np.int64)),
            torch.from_numpy(c.indices.astype(np.int64)),
            torch.from_numpy(c.data.astype(np.float32).astype(np.float64)),
            size=c.shape).to(dev)
        n = c.shape[0]
        want = A64 @ X.double()
        check(bsr_spmm_path(B.bs, X.shape[1]) == "tensor-core",
              f"bsr {label}: {X.shape[1]} columns do not take the tensor cores")
        ys = {"tensor_core": bsr_spmm(B.bcols, B.blocks, X),
              "cuda_core": torch.cat([bsr_spmm(B.bcols, B.blocks, X[:, j:j + 1].contiguous())
                                      for j in range(X.shape[1])], 1),
              "plain": bsr_spmm_plain(B.bcols, B.blocks, X)}
        errs = {}
        for path, y in ys.items():
            err = (y[:n].double() - want).abs()
            errs[path] = dict(max_abs_err=float(err.max()), tol_ratio=float(
                (err / (2e-4 + 2e-4 * want.abs())).max()))
        phase(f"bsr_spmm f64 oracle, {label}, {X.shape[1]} columns", **{
            f"{p}_{k}": v for p, e in errs.items() for k, v in e.items()})
        check(errs["tensor_core"]["tol_ratio"] <= 1 and errs["cuda_core"]["tol_ratio"] <= 1,
              f"bsr {label}: a path misses rtol 2e-4 with atol 2e-4 against f64: {errs}")
        return errs

    # bsr_spmm and its masked form on the block matrix, one and 128 columns
    B = to_bsr(block, device=dev)
    nb = block.shape[0]
    bs, esz = B.bs, B.blocks.element_size()
    valid = B.bcols >= 0
    real = int(valid.sum())
    bsr_lib = torch.sparse_bsr_tensor(
        torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), valid.sum(1).cumsum(0)]),
        B.bcols[valid].long(), B.blocks[valid], size=block.shape)
    mask = torch.from_numpy((np.arange(nb) % 8) == 3).to(dev)
    kept = mask.reshape(-1, bs).sum(1)  # kept rows of each block row
    kept_entries = int((valid.sum(1) * kept).sum()) * bs  # stored entries they read

    for nf in (1, BLOCK_NF):
        X = torch.from_numpy(np.random.default_rng(3).standard_normal((nb, nf))
                             .astype(np.float32)).to(dev)
        Y = bsr_spmm(B.bcols, B.blocks, X)
        rec = measure(
            f"bsr_spmm_nf{nf}", f"bsr_spmm nf={nf}", block, X,
            lambda: bsr_spmm(B.bcols, B.blocks, X), lambda: bsr_spmm_plain(B.bcols, B.blocks, X),
            real * bs * bs * esz + nbytes(B.bcols, X) + nb * nf * 4, "bsr_spmm_",
            plain_reps=3, flops=2 * real * bs * bs * nf, flops_per_s=TF32X3_FLOPS,
            library=lambda X=X: bsr_lib @ X, nf=nf, path=bsr_spmm_path(bs, nf), bs=bs,
            bwidth=B.bwidth, real_blocks=real,
            padded_blocks=int(valid.numel()))
        Ym = bsr_spmm(B.bcols, B.blocks, X, row_mask=mask)
        check(bool(torch.equal(Ym, torch.where(mask[:, None], Y, torch.zeros((), device=dev)))),
              f"masked bsr_spmm nf={nf} != where(mask, A @ X, 0)")
        recm = measure(
            f"bsr_masked_nf{nf}", f"bsr_spmm masked nf={nf}", block, X,
            lambda: bsr_spmm(B.bcols, B.blocks, X, row_mask=mask),
            lambda: bsr_spmm_plain(B.bcols, B.blocks, X, row_mask=mask),
            kept_entries * esz + nbytes(B.bcols, X, mask) + nb * nf * 4,
            "bsr_spmm_", plain_reps=3, flops=2 * kept_entries * nf,
            flops_per_s=TF32X3_FLOPS, library=False, nf=nf, path=bsr_spmm_path(bs, nf),
            equals_where_of_unmasked=True)
        masked = {k: recm[k] for k in (
            "nf", "path", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")}
        if nf == BLOCK_NF:
            rec["f64"] = bsr_f64_errors("block", block, B, X)
            sgrid = M.banded(96, 3, seed=0) + M.random_uniform(96, 0.02, seed=1)
            Xg = torch.from_numpy(np.random.default_rng(10).standard_normal((96, nf))
                                  .astype(np.float32)).to(dev)
            rec["f64_grid"] = bsr_f64_errors("conformance grid", sgrid,
                                             to_bsr(sgrid, device=dev), Xg)
        if nf == 1:
            out["bsr_spmm"] = dict(rec, masked=masked)
        else:
            out["bsr_spmm"]["spmm"] = {k: rec[k] for k in (
                "nf", "path", "max_abs_err", "ms", "kernel_ms", "plain_ms", "library_ms",
                "library_kernel_ms", "bound_ms", "bound_by", "f64", "f64_grid")}
            out["bsr_spmm"]["spmm"]["masked"] = masked
        del X, Y, Ym
    del B, bsr_lib
    torch.cuda.empty_cache()
    return out, launches_scoo


def counters() -> dict:
    """Every kernel wrapper by name."""
    from repro_torch.kernels import wrappers

    return wrappers()


def launch_counts() -> dict:
    from repro_torch.kernels import launch_counts as counts

    return counts()


def dia_split(by_shape) -> dict:
    """``dia_spmv``'s launches by level (``g^3`` for a cube of g^3 rows,
    ``g^3/4`` for a part of one, else the row count) and by masked or not."""
    out = {}
    for (rows, masked), count in sorted(by_shape.items(), reverse=True):
        g = round(rows ** (1 / 3))
        gp = round((rows * DIST_PARTS) ** (1 / 3))
        label = (f"{g}^3" if g ** 3 == rows else f"{gp}^3/{DIST_PARTS}"
                 if gp ** 3 == rows * DIST_PARTS else str(rows))
        out.setdefault(label, {})["masked" if masked else "unmasked"] = count
    return out


@contextlib.contextmanager
def recorded_races(log: list):
    """Record every ``autotune_spmv`` race (the main one, each multigrid
    level's, each ``tune()``) with the matrix shape it raced on."""
    import repro_torch.apps.hpcg as hpcg_mod
    import repro_torch.core.autotune as tune_mod
    import repro_torch.distributed_op.tune as dtune_mod
    import repro_torch.solvers.mg as mg_mod

    orig = tune_mod.autotune_spmv

    def recording(*args, **kwargs):
        res = orig(*args, **kwargs)
        log.append(res)
        return res

    mods = (tune_mod, mg_mod, hpcg_mod, dtune_mod)
    for m in mods:
        m.autotune_spmv = recording
    try:
        yield log
    finally:
        for m in mods:
            m.autotune_spmv = orig


def print_race(label: str, res) -> None:
    """A race's line: its pick and table (µs a replay of each candidate's
    graph), its skips, whether it was captured, its capture and
    instantiation seconds and the candidates whose replay gave the eager
    bits."""
    table = {f"{f}/{i}": round(t, 1) for (f, i), t in sorted(res.table.items(),
                                                               key=lambda kv: kv[1])}
    phase(f"{label} race", shape=tuple(res.matrix.shape), chosen=f"{res.format}/{res.impl}",
          table_us=json.dumps(table), skipped=json.dumps(res.skipped), graph=res.graph,
          capture_s=round(res.capture_s, 4), instantiate_s=round(res.instantiate_s, 4),
          replay_equal=res.replay_equal)


def counted(label: str, drive):
    """Run ``drive()`` with every launch counter and the health registry
    reset just before it; read both just after. Fails on any failure or
    non-finite output of any key, on any race that lists an error, and on
    any race not timed by CUDA graphs' replays (a mismatched replay raises
    inside the race). A captured race launches its kernels at the warm-up
    and the capture only: its replays run uncounted.
    Returns (drive's value, launches, races)."""
    from repro_torch.core import health_registry

    for fn in counters().values():
        fn.launches = 0
    dia = counters()["dia_spmv"]
    dia.by_shape.clear()
    health_registry().reset()
    races = []
    with recorded_races(races):
        value = drive()
    launches = launch_counts()
    launches["dia_spmv_split"] = dia_split(dia.by_shape)
    faults = {k: v for k, v in health_registry().snapshot()["keys"].items()
              if v["failures"] or v["nonfinite"]}
    phase(f"{label} counts", launches=json.dumps(launches), faults=json.dumps(faults),
          races=len(races))
    check(not faults, f"{label}: keys failed or went non-finite: {faults}")
    errs = [(tuple(r.matrix.shape), sk) for r in races for sk in r.skipped
            if sk[2].startswith("error:")]
    check(not errs, f"{label}: races listed errors: {errs}")
    eager = [tuple(r.matrix.shape) for r in races
             if not r.graph or r.replay_equal != len(r.table)]
    check(not eager, f"{label}: races not timed on CUDA graphs, or not replay-equal: {eager}")
    captures = sum(len(r.table) for r in races)
    phase(f"{label} race graphs", races=len(races), captured=captures,
          capture_s=round(sum(r.capture_s for r in races), 3),
          instantiate_s=round(sum(r.instantiate_s for r in races), 3))
    return value, launches, races


def check_bsr_guarded(label: str, skipped) -> None:
    """bsr is in the race and skipped by the block-fill guard (an HPCG
    level's 32-edge blocks are under an eighth full)."""
    for impl in ("plain", "cuda"):
        check(any(sk[:2] == ("bsr", impl) and sk[2].startswith("block_fill=")
                  for sk in skipped), f"{label}: bsr/{impl} not skipped by the block-fill guard")


def graph_lines(res, label: str) -> dict:
    """The captured timed solves of an HPCG result: a line for the pair and
    one a graph (capture and instantiation seconds, nodes, the launches
    counted in the capture: the graph's kernel launches a solve). Fails
    unless both were captured and every replay gave the eager bits."""
    check(res.graph, f"{label}: the timed solves were not captured in a CUDA graph")
    check(res.graph_equal, f"{label}: a replay's x or rs differs from the eager solve's")
    out = phase(f"{label} graph", t_ref_s=res.ref_time_s, t_opt_s=res.opt_time_s,
                t_ref_eager_s=res.ref_eager_s, t_opt_eager_s=res.opt_eager_s,
                graph_equal=res.graph_equal)
    for name, st in res.graphs.items():
        out[name] = phase(f"{label} graph {name}", capture_s=round(st["capture_s"], 3),
                          instantiate_s=round(st["instantiate_s"], 3), nodes=st["nodes"],
                          launches=json.dumps(st["launches"]))
    return out


def conv_lines(res, label: str, equal=()) -> dict:
    """The captured tolerance solves of an HPCG result, a line each:
    iterations taken and computed, chunk replays (host reads: one more),
    capture and instantiation seconds, nodes, the captured call's seconds,
    and where the eager ``cg`` ran beside it its seconds and ``conv_equal``
    (equal ``x`` bits and iterations). Fails unless every solve in
    ``equal`` gave the eager bits."""
    check(set(res.conv_graphs) >= set(equal) and res.conv_graphs,
          f"{label}: the tolerance solves were not captured ({sorted(res.conv_graphs)})")
    out = {}
    for name, st in res.conv_graphs.items():
        extra = {}
        if "equal" in st:
            extra = dict(eager_s=round(st["eager_s"], 4), conv_equal=st["equal"])
        out[name] = phase(f"{label} conv graph {name}", iters=st["iters"],
                          computed=st["computed"], chunk=st["chunk"], replays=st["replays"],
                          host_reads=st["replays"] + 1, capture_s=round(st["capture_s"], 3),
                          instantiate_s=round(st["instantiate_s"], 3), nodes=st["nodes"],
                          setup_nodes=st["setup_nodes"], seconds=round(st["seconds"], 4),
                          **extra)
    for name in equal:
        check(res.conv_graphs[name].get("equal") is True,
              f"{label}: the captured {name} tolerance solve differs from the eager cg")
    return out


def check_hpcg(res, label: str) -> None:
    check(res.bitwise, f"{label}: bitwise tier failed")
    check(res.rel_err < 1e-3, f"{label}: rel_err {res.rel_err} >= 1e-3")
    for fmt, impl in CANDIDATES:
        if impl == "cuda" and fmt != "bsr":
            check(f"{fmt}/{impl}" in res.table, f"{label}: {fmt}/cuda missing from the tune table")
    check_bsr_guarded(label, res.skipped)
    errs = [sk for sk in res.skipped if sk[2].startswith("error:")]
    check(not errs, f"{label}: candidates raised: {errs}")


def phase_tuner(results: dict):
    """Phase 6: the run-first tuner on an unstructured matrix of 10^6 rows."""
    import numpy as np
    import torch

    from repro_torch.core import as_operator
    from repro_torch.core import matrices as M

    print(f"[tuner cut] {TUNER_CUT}", flush=True)
    out = {}
    for label, gen, args in TUNER_MATRICES:
        s = getattr(M, gen)(*args)
        n = s.shape[0]
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                             .astype(np.float32)).cuda()
        races = []
        with recorded_races(races):
            tuned = as_operator(s, device="cuda").tune(candidates=CANDIDATES)
        res = races[-1]
        print_race(f"tuner {label}", res)
        check(("coo", "cuda", "unsupported") in res.skipped and ("coo", "cuda") not in res.table,
              f"tuner {label}: coo/cuda was not listed unsupported")
        before = launch_counts()
        y = tuned @ x
        torch.cuda.synchronize()
        after = launch_counts()
        if res.impl == "cuda":
            ran = sum(after[k] - before[k] for k in FORMAT_KERNELS[res.format])
            check(ran == 1, f"tuner {label}: the winner {res.format}/cuda launched {ran} kernels")
        want = as_operator(s, "csr", device="cuda").using("plain") @ x
        err = within(f"tuner {label}: tuned A @ x against csr/plain", y, want)
        out[label] = phase(f"tuner {label}", nnz=s.nnz, chosen=f"{res.format}/{res.impl}",
                           max_abs_err=err)
        del s, tuned, x, y, want
    results["tuner"] = out


def phase_corpus(results: dict):
    """Phase 7: Matrix Market input through ``repro_torch.io``."""
    import numpy as np
    import torch

    from repro_torch.core import as_operator
    from repro_torch.io import iter_corpus

    out = {}
    names = []
    for name, s in iter_corpus(CORPUS):
        names.append(name)
        x = np.random.default_rng(2).standard_normal(s.shape[1])
        races = []
        with recorded_races(races):
            tuned = as_operator(s, device="cuda").tune(candidates=CANDIDATES)
        print_race(f"corpus {name}", races[-1])
        y = tuned @ torch.from_numpy(x.astype(np.float32)).cuda()
        err = within(f"corpus {name}: tuned A @ x against scipy", y,
                     torch.from_numpy(s @ x))
        out[name] = phase(f"corpus {name}", shape=s.shape, nnz=s.nnz,
                          chosen=f"{tuned.format}/{tuned.policy.backends[0]}",
                          max_abs_err=err)
    check(len(names) >= 5, f"corpus: only {names} read from {CORPUS}")
    results["corpus"] = out


def phase_block(results: dict, block):
    """Phase 8: the block path — a block-structured operator tuned, then
    applied to one and to BLOCK_NF right-hand sides, on the cuda backend's
    bsr entry; and the zero-run pick on the same matrix."""
    import numpy as np
    import torch

    from repro_torch.core import as_operator, health_registry

    n = block.shape[0]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    X = torch.from_numpy(rng.standard_normal((n, BLOCK_NF)).astype(np.float32)).cuda()
    mask = torch.from_numpy((np.arange(n) % 8) == 3).cuda()
    A = as_operator(block, "csr", device="cuda")
    races = []
    with recorded_races(races):
        tuned = A.tune(candidates=CANDIDATES)
    res = races[-1]
    print_race("block", res)
    check(("bsr", "cuda") in res.table, "block: bsr/cuda was not timed in the race")
    check(("coo", "cuda", "unsupported") in res.skipped, "block: coo/cuda not unsupported")
    ref = A.using("plain")
    want_y, want_Y = ref @ x, ref @ X
    B = tuned if (res.format, res.impl) == ("bsr", "cuda") else A.asformat("bsr").using("cuda")
    errs = {}
    for label, op in (("tuned", tuned), ("bsr/cuda", B)):
        before = launch_counts()["bsr_spmm"]
        y, Y = op @ x, op @ X
        torch.cuda.synchronize()
        ran = launch_counts()["bsr_spmm"] - before
        errs[label] = (within(f"block: {label} A @ x against csr/plain", y, want_y),
                       within(f"block: {label} A @ X against csr/plain", Y, want_Y))
        if label == "bsr/cuda":
            check(ran == 2, f"block: bsr/cuda launched bsr_spmm {ran} times for A @ x, A @ X")
            ym = op.masked_matvec(x, mask)
            check(bool(torch.equal(ym, torch.where(mask, y, torch.zeros((), device="cuda")))),
                  "block: masked bsr SpMV != where(mask, A @ x, 0)")
    before, faults = launch_counts(), health_registry().snapshot()["keys"]
    t0 = time.perf_counter()
    P = A.tune(candidates=CANDIDATES, mode="predict")
    predict_s = time.perf_counter() - t0
    check(launch_counts() == before and health_registry().snapshot()["keys"] == faults,
          "block: tune(mode='predict') launched a kernel")
    results["block"] = phase(
        "block", n=n, nnz=block.nnz, race=f"{res.format}/{res.impl}",
        predict=f"{P.format}/{P.policy.backends[0]}", predict_s=round(predict_s, 2),
        max_abs_err=json.dumps(errs))
    del A, tuned, B, P, ref


def own_latency(tickets) -> dict:
    """p50/p99 latency of a phase's own tickets, where the engine's summary
    covers the earlier phases too."""
    from repro_torch.serve.stats import _percentile

    lats = sorted(t.record.latency_s for t in tickets)
    return {"phase_requests": len(lats), "phase_latency_p50_s": _percentile(lats, 50),
            "phase_latency_p99_s": _percentile(lats, 99)}


def serve_line(label: str, eng, out: dict, keys: dict, launches: dict, seconds: float,
               **extra) -> dict:
    """One serving phase's line: the summary fields ``launch/serve.py``
    prints (the engine's, over every phase it served), each tenant's key,
    launches per kernel, the health snapshot, the phase's seconds and the
    device memory the warm pool holds."""
    import torch

    torch.cuda.synchronize()
    return phase(
        f"serve {label}", **{k: out[k] for k in SERVE_SUMMARY_KEYS},
        hits=out["workspace"]["hits"], misses=out["workspace"]["misses"],
        evictions=out["workspace"]["evictions"], keys=json.dumps(keys),
        launches=json.dumps({k: v for k, v in launches.items() if k != "dia_spmv_split"}),
        health=json.dumps(out["health"]), seconds=round(seconds, 1),
        pool_bytes=sum(op.nbytes for op in eng.workspace._ops.values()),
        memory_allocated=torch.cuda.memory_allocated(), **extra)


def recording_pool():
    """The serving phases' warm pool: an ``SpmvWorkspace`` of
    ``SERVE_CAPACITY`` that also keeps every operator it admitted, by
    fingerprint, so that a tenant evicted within its flush is still held to
    the operator that served it."""
    from repro_torch.core.registry import SpmvWorkspace

    class RecordingPool(SpmvWorkspace):
        def __init__(self):
            super().__init__(max_entries=SERVE_CAPACITY)
            self.admitted = {}

        def admit(self, fingerprint, build):
            op, hit = super().admit(fingerprint, build)
            self.admitted[fingerprint] = op
            return op, hit

    return RecordingPool()


def serve_traffic(eng, spec, num: int):
    """``run_traffic`` over ``spec``, flushing every ``SERVE_FLUSH_EVERY``;
    returns (summary, [(tenant, rhs, ticket)], {tenant: its key})."""
    from repro_torch.serve import run_traffic

    served = []
    summ = run_traffic(eng, spec, num, flush_every=SERVE_FLUSH_EVERY, on_flush=served.extend)
    keys = {}
    for name, _, t in served:
        op = eng.workspace.admitted[t.record.fingerprint]
        keys[name] = f"{op.format}/{op.policy.backends[0]}"
    return summ, served, keys


def check_served(label: str, served, eng) -> tuple:
    """Every ticket served; each ``y`` within rtol 2e-4 of its tenant's
    csr/plain on the card; each coalesced row equal to ``op @ x`` of the
    operator the warm pool admitted for it, bit for bit. Returns the max
    abs error and ``graph_equal``: every row, coalesced or not, the eager
    ``op @ x``'s bits (the captured lanes' rows where the engine replayed
    them)."""
    import torch

    from repro_torch.core import as_operator
    from repro_torch.core.convert import to_csr

    plain = {}
    err = 0.0
    equal = True
    for name, rhs, t in served:
        check(t.ok, f"serve {label}: request {t.rid} on {name} failed: {t.error}")
        fp = t.record.fingerprint
        if fp not in plain:
            plain[fp] = as_operator(to_csr(eng._matrices[fp], plan=False,
                                           device="cuda")).using("plain")
        x = torch.from_numpy(rhs).cuda()
        y = t.result()
        err = max(err, within(f"serve {label}: {name} request {t.rid} against csr/plain",
                              y, plain[fp] @ x))
        same = bool(torch.equal(y, eng.workspace.admitted[fp] @ x))
        if t.record.coalesced:
            check(same, f"serve {label}: coalesced row of request {t.rid} != op @ x")
        equal = equal and same
    return err, equal


def check_healthy(label: str, out: dict) -> None:
    check(out["errors"] == 0 and out["retries"] == 0 and out["degraded_requests"] == 0
          and out["dispatch_fallbacks"] == 0 and out["batch_splits"] == 0,
          f"serve {label}: a healthy phase fell off its lane: " + json.dumps(
              {k: out[k] for k in ("errors", "retries", "degraded_requests",
                                   "dispatch_fallbacks", "batch_splits")}))
    faults = {k: v for k, v in out["health"]["keys"].items() if v["failures"] or v["nonfinite"]}
    check(not faults, f"serve {label}: keys failed: {faults}")


def replay_on_host(label: str, spec, num: int, out: dict) -> dict:
    """The same tenant sequence on ``device="cpu"`` at n = 4096, untuned:
    the warm pool's counters depend on the sequence alone."""
    import dataclasses

    from repro_torch.serve import ServeEngine, run_traffic

    eng = ServeEngine(capacity=SERVE_CAPACITY, max_batch=SERVE_MAX_BATCH, tune_mode=None,
                      device="cpu")
    host = run_traffic(eng, dataclasses.replace(spec, n=SERVE_REPLAY_N), num,
                       flush_every=SERVE_FLUSH_EVERY)
    got = {k: out[k] for k in ("admissions", "batches")}
    got.update({k: out["workspace"][k] for k in ("hits", "misses", "evictions")})
    want = {k: host[k] for k in ("admissions", "batches")}
    want.update({k: host["workspace"][k] for k in ("hits", "misses", "evictions")})
    check(got == want, f"serve {label}: counters {got} != the host replay's {want}")
    return want


def clocked(eng) -> dict:
    """Seconds the engine's ``submit`` and admissions take, on its clock,
    summed from now on (wraps the two methods on the instance)."""
    spent = {"submit": 0.0, "admission": 0.0}

    def wrap(name, fn):
        def timed(*a, **kw):
            t0 = eng.clock()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += eng.clock() - t0
        return timed

    eng.submit = wrap("submit", eng.submit)
    eng._admit_guarded = wrap("admission", eng._admit_guarded)
    return spent


def tile_times(eng, first: int = 0) -> dict:
    """p50 and p99 of the engine's tile ``exec_s`` from tile ``first`` on."""
    from repro_torch.serve.stats import _percentile

    ts = sorted(b.exec_s for b in eng.stats.batches[first:])
    return {"tiles": len(ts), "p50_s": _percentile(ts, 50), "p99_s": _percentile(ts, 99)}


def tile_peak(fn) -> int:
    """Device bytes ``fn()`` allocates at its peak above what was
    allocated before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - m0


def tile_trace(fn, reps: int = 10, lead: int = 20) -> dict:
    """Device time of one ``fn()`` by kernel, from ``torch.profiler``: the
    device records that start inside a marked range of ``reps`` calls (after
    ``lead`` calls, since a trace can lose its first milliseconds, as
    :func:`kernel_ms` says), per call; and the events' median ms of a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = KERNEL_MS_MARKS[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    span = [e.time_range for e in events if e.device_type == DeviceType.CPU and e.name == mark][0]
    by_name = {}
    for e in events:
        if (e.device_type != DeviceType.CPU and e.name != mark
                and span.start <= e.time_range.start <= span.end):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / reps, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"busy_ms": sum(ms for ms, _ in by_name.values()),
            "records": sum(n for _, n in by_name.values()) / reps,
            "top5": [(name[:80], round(ms, 4), n // reps) for name, (ms, n) in top],
            "events_ms": cuda_ms(fn, 5)}


def serve_tile_probe(op, lane, xs) -> dict:
    """One hot tile two ways on the same rhs: eager (``torch.stack`` and
    ``batched_matvec``) and through the captured lane (copy-in, replay,
    clone): each one's device time by kernel (:func:`tile_trace`) and peak
    bytes, and the bytes a lane of this width holds (a fresh capture, then
    dropped)."""
    import torch

    from repro_torch.serve import CapturedLane

    def eager():
        return op.batched_matvec(torch.stack(xs))

    out = {"trace": {"eager": tile_trace(eager), "captured": tile_trace(lambda: lane(xs))},
           "peak": {"eager": tile_peak(eager), "captured": tile_peak(lambda: lane(xs))}}
    # reserved: the static buffers and the graph's private pool, with the
    # allocator's cached free blocks (the warm-up's among them) released
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    fresh = CapturedLane(op, "mm", len(xs), xs[0].dtype)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["lane_bytes"] = {"allocated": torch.cuda.memory_allocated() - a0,
                         "reserved": torch.cuda.memory_reserved() - r0}
    del fresh
    for name, tr in out["trace"].items():
        phase(f"serve tile trace {name}", busy_ms=round(tr["busy_ms"], 4),
              events_ms=round(tr["events_ms"], 4), device_records=tr["records"],
              top5=json.dumps(tr["top5"]))
    return out


def serve_graph_line(hot, eager, served, eager_served, spent: dict, peaks: dict,
                     smi: str) -> dict:
    """Hot's captured lanes against the eager window over the same
    workspace: the lanes' counters, launches a tile, tile ``exec_s``,
    ``graph_equal`` (every eager result the captured one bit for bit),
    peak memory (each run's, one tile's, and what a lane holds), one tile
    traced each way, and where the captured run's wall time went."""
    import torch

    g = hot.graph_stats()
    fp = served[0][2].record.fingerprint
    lanes = hot.workspace.lanes(fp, hot.workspace.admitted[fp])
    launches = {f"{lane}{k}": cap.launches for (lane, k, _, _), cap in lanes.items()}
    op = hot.workspace.admitted[fp]
    mm = [cap for (lane, k, _, _), cap in lanes.items() if lane == "mm" and k == SERVE_MAX_BATCH]
    check(len(mm) == 1, f"serve graph: no mm lane of {SERVE_MAX_BATCH} beside the hot tenant")
    probe = serve_tile_probe(op, mm[0], [torch.from_numpy(x).to(op.device)
                                         for _, x, _ in served[:SERVE_MAX_BATCH]])
    import numpy as np

    equal = len(served) == len(eager_served) and all(
        a == b and np.array_equal(x, y) and torch.equal(t.result(), e.result())
        for (a, x, t), (b, y, e) in zip(served, eager_served))
    execution = sum(b.exec_s for b in hot.stats.batches)
    split = dict(spent, execution=execution,
                 rest=hot.wall_s - spent["submit"] - spent["admission"] - execution)
    out = phase("serve graph", captures=g["captures"], replays=g["replays"],
                capture_s=round(g["capture_s"], 4), instantiate_s=round(g["instantiate_s"], 4),
                nodes=g["nodes"], live=g["live"], launches_a_tile=json.dumps(launches),
                exec_captured=json.dumps(tile_times(hot)),
                exec_eager=json.dumps(tile_times(eager)),
                graph_equal=equal, compared=len(eager_served),
                peak_bytes=json.dumps(peaks), tile_peak_bytes=json.dumps(probe["peak"]),
                lane_bytes=json.dumps(probe["lane_bytes"]),
                tile_busy_ms=json.dumps({k: round(v["busy_ms"], 4)
                                         for k, v in probe["trace"].items()}),
                wall_split_s=json.dumps(split), card=smi)
    check(g["replays"] > 0 and g["captures"] >= 1, f"serve graph: hot replayed nothing: {g}")
    check(equal, "serve graph: a captured result differs from the eager window's")
    return out


def phase_serve(results: dict, smi: str = "") -> dict:
    """Phase 10: the serving path at 2^20-row tenants — hot, churn, a
    dynamic tenant and an armed kernel fault, each counted on its own.
    Healthy tiles replay the engine's captured lanes; hot's first window
    runs again eagerly on a second engine over the same warm pool for the
    ``[serve graph]`` line. Returns the launches of the four runs summed
    (the ``serve`` path)."""
    import numpy as np
    import torch

    from repro_torch.core import DEFAULT_DRIFT_THRESHOLD, as_operator, matrices as M
    from repro_torch.core.convert import to_csr
    from repro_torch.core.health import HealthRegistry
    from repro_torch.core.spmv import DispatchKey, select_spmv
    from repro_torch.resilience import FaultPlan, FaultSpec
    from repro_torch.serve import ServeEngine, TrafficSpec

    n = SERVE_N
    out = {}
    total = {}

    def add(launches):
        for k, v in launches.items():
            if k != "dia_spmv_split":
                total[k] = total.get(k, 0) + v

    # hot: one tenant, every tile coalesced. Its breaker holds a quarantine
    # for the whole chaos phase (the default cooldown is 50 ms)
    hot = ServeEngine(workspace=recording_pool(), max_batch=SERVE_MAX_BATCH,
                      tune_mode="predict", health=HealthRegistry(cooldown_s=3600.0))
    check(hot.graph, "serve hot: the engine on the card does not replay captured lanes")
    spec = TrafficSpec(mix="hot", n=n, seed=0)
    spent = clocked(hot)
    peaks = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    (summ, served, keys), launches, _ = counted("serve hot", lambda: serve_traffic(
        hot, spec, SERVE_REQUESTS["hot"]))
    t_hot = time.perf_counter() - t0
    peaks[f"captured_{SERVE_REQUESTS['hot']}"] = torch.cuda.max_memory_allocated() - m0
    add(launches)
    check_healthy("hot", summ)
    check(summ["coalesced_fraction"] == 1.0 and summ["batch_size_max"] == SERVE_MAX_BATCH,
          f"serve hot: tiles did not coalesce to {SERVE_MAX_BATCH}")
    replay = replay_on_host("hot", spec, SERVE_REQUESTS["hot"], summ)
    err, equal = check_served("hot", served, hot)
    check(equal, "serve hot: a captured row differs from the eager op @ x")
    out["hot"] = serve_line("hot", hot, summ, keys, launches, t_hot, requests_sent=len(served),
                            max_abs_err=err, host_replay=json.dumps(replay), graph_equal=equal)
    # the first window again, eager, on a second engine over the same pool
    eager = ServeEngine(workspace=hot.workspace, max_batch=SERVE_MAX_BATCH,
                        tune_mode="predict", graph=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    _, eager_served, _ = serve_traffic(eager, spec, SERVE_FLUSH_EVERY)
    peaks[f"eager_{SERVE_FLUSH_EVERY}"] = torch.cuda.max_memory_allocated() - m0
    out["graph"] = serve_graph_line(hot, eager, served[:SERVE_FLUSH_EVERY], eager_served,
                                    spent, peaks, smi)
    hot_name, hot_fp = served[0][0], served[0][2].record.fingerprint
    hot_matrix = hot._matrices[hot_fp]
    del served, eager_served, eager
    torch.cuda.empty_cache()

    # churn: 9 tenants against 8 slots; a 64-request window admits each
    # once, and the second window's 4 requests bring an evicted tenant back
    print(f"[serve cut] {SERVE_CHURN_CUT}", flush=True)
    churn = ServeEngine(workspace=recording_pool(), max_batch=SERVE_MAX_BATCH,
                        tune_mode="predict")
    spec = TrafficSpec(mix="churn", n=n, n_matrices=SERVE_CHURN_TENANTS, seed=0)
    t0 = time.perf_counter()
    (summ, served, keys), launches, _ = counted("serve churn", lambda: serve_traffic(
        churn, spec, SERVE_REQUESTS["churn"]))
    t_churn = time.perf_counter() - t0
    add(launches)
    check_healthy("churn", summ)
    check(summ["workspace"]["misses"] > SERVE_CHURN_TENANTS
          and summ["tunes"] == summ["workspace"]["misses"],
          f"serve churn: no evicted tenant was re-tuned on readmission: {summ['workspace']}")
    replay = replay_on_host("churn", spec, SERVE_REQUESTS["churn"], summ)
    err, equal = check_served("churn", served, churn)
    g = churn.graph_stats()
    # every admission serves a tile, so it captures at least one lane
    check(equal and g["captures"] >= summ["workspace"]["misses"] and g["replays"] > 0,
          f"serve churn: graph_equal={equal}, lanes {g}, {summ['workspace']}")
    out["churn"] = serve_line("churn", churn, summ, keys, launches, t_churn,
                              requests_sent=len(served), max_abs_err=err,
                              host_replay=json.dumps(replay), graph_equal=equal,
                              graph=json.dumps(g))
    # an admission by stage is timed by examples/serve_admission.py, not here
    print(f"[serve cut] {SERVE_STAGES_CUT}", flush=True)
    del churn, served
    torch.cuda.empty_cache()

    # dynamic: 1% of the hot tenant's rows gain an entry a quarter of the
    # matrix off its band (one new diagonal), then a refresh and 64 requests
    def dynamic():
        rng = np.random.default_rng(5)
        ov = hot.mutable(hot_matrix)
        rows = np.sort(rng.choice(n - n // 4, n // 100, replace=False))
        ov.set_many(rows, rows + n // 4, rng.standard_normal(rows.size))
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
        merged = ov.to_scipy()
        d = ov.delta_operator()
        delta_key = select_spmv(d.container, d._effective_policy()).key
        y = ov @ x
        err_ov = within("dynamic: ov @ x against the merged matrix in f64", y,
                        torch.from_numpy(merged @ x.double().cpu().numpy()))
        drift = ov.drift()
        live = hot.graph_stats()["live"]
        res = hot.refresh(ov)
        check(res.retuned and drift.score > DEFAULT_DRIFT_THRESHOLD,
              f"dynamic: refresh did not re-tune (drift {drift})")
        released = live - hot.graph_stats()["live"]
        check(live > 0 and hot.graph_stats()["live"] == 0,
              f"dynamic: refresh kept the old fingerprint's lanes ({live} before)")
        replays = hot.graph_stats()["replays"]
        plain = as_operator(to_csr(merged, plan=False, device="cuda")).using("plain")
        tickets = []
        for _ in range(64):
            xr = rng.standard_normal(n).astype(np.float32)
            tickets.append((xr, hot.submit(res.fingerprint_after, xr)))
        hot.flush()
        err_served = 0.0
        equal = True
        for xr, t in tickets:
            check(t.ok, f"dynamic: request {t.rid} failed: {t.error}")
            x = torch.from_numpy(xr).cuda()
            err_served = max(err_served, within(
                "dynamic: a request under fingerprint_after against csr/plain",
                t.result(), plain @ x))
            equal = equal and bool(torch.equal(t.result(), res.operator @ x))
        replayed = hot.graph_stats()["replays"] - replays
        check(equal and replayed > 0,
              f"dynamic: the refreshed tenant did not serve captured ({replayed} replays, "
              f"graph_equal={equal})")
        # the same lane on the tenant whose delta the full-window coo_spmv takes
        small = M.banded(SMALL_TENANT, 3, seed=10)
        sov = as_operator(small, device="cuda").tune(mode="predict").mutable()
        srows = np.sort(rng.choice(SMALL_TENANT - SMALL_TENANT // 4, SMALL_TENANT // 100,
                                   replace=False))
        sov.set_many(srows, srows + SMALL_TENANT // 4, rng.standard_normal(srows.size))
        sd = sov.delta_operator()
        small_key = select_spmv(sd.container, sd._effective_policy()).key
        xs = torch.from_numpy(rng.standard_normal(SMALL_TENANT).astype(np.float32)).cuda()
        err_small = within("dynamic: the 8192-row overlay against f64", sov @ xs,
                           torch.from_numpy(sov.to_scipy() @ xs.double().cpu().numpy()))
        return dict(**own_latency([t for _, t in tickets]), mutations=int(rows.size),
                    delta_key=f"{delta_key.format}/{delta_key.backend}",
                    drift=repr(drift), key_before="/".join(res.key_before),
                    key_after="/".join(res.key_after), reselected=res.reselected,
                    max_abs_err_overlay=err_ov, max_abs_err_served=err_served,
                    small_delta_key=f"{small_key.format}/{small_key.backend}",
                    small_max_abs_err=err_small, lanes_released=released,
                    replays=replayed, graph_equal=equal)

    t0 = time.perf_counter()
    dyn, launches, _ = counted("serve dynamic", dynamic)
    t_dyn = time.perf_counter() - t0
    add(launches)
    summ = hot.summary()
    check_healthy("dynamic", summ)
    check(launches["coo_spmv"] > 0, "dynamic: coo_spmv did not take the 8192-row delta")
    out["dynamic"] = serve_line("dynamic", hot, summ, {hot_name: dyn["key_after"]}, launches,
                                t_dyn, **dyn)

    # chaos: the hot tenant's cuda kernel fails three times in a flush of 64
    def chaos():
        hot_op = as_operator(hot_matrix, device="cuda").tune(mode="predict")
        fmt = hot_op.format
        check(hot_op.policy.backends[0] == "cuda", f"chaos: hot tenant predicted {fmt} plain")
        plain = hot_op.with_policy(hot_op.policy.preferring("plain"))
        rng = np.random.default_rng(6)
        before = hot.summary()
        lanes_before = hot.graph_stats()
        plan = FaultPlan([FaultSpec("kernel", key=(fmt, "cuda"), times=3)])
        with plan:
            sent = []
            for _ in range(64):
                xr = rng.standard_normal(n).astype(np.float32)
                sent.append((xr, hot.submit(hot_matrix, xr)))
            hot.flush()
        after = hot.summary()
        lanes_after = hot.graph_stats()
        # armed, then quarantined: the reference's eager rule
        check(all(lanes_after[k] == lanes_before[k] for k in ("captures", "replays")),
              f"chaos: lanes ran under the plan: {lanes_before} -> {lanes_after}")
        check(hot.health.quarantined(DispatchKey(fmt, "cuda")),
              f"chaos: {fmt}/cuda was not quarantined")
        degraded = 0
        for xr, t in sent:
            check(t.ok, f"chaos: request {t.rid} did not resolve: {t.error}")
            y = t.result()
            if t.record.degraded or t.record.retries or not t.record.coalesced:
                degraded += 1
                check(bool(torch.equal(y, plain @ torch.from_numpy(xr).cuda())),
                      f"chaos: degraded request {t.rid} != the plain lane bit for bit")
        return dict(**own_latency([t for _, t in sent]), key=f"{fmt}/cuda",
                    fired=plan.fired("kernel"), served_off_cuda=degraded,
                    replays_in_phase=lanes_after["replays"] - lanes_before["replays"],
                    **{f"{k}_in_phase": after[k] - before[k] for k in (
                        "retries", "degraded_requests", "batch_splits", "errors")})

    t0 = time.perf_counter()
    cha, launches, _ = counted("serve chaos", chaos)
    t_cha = time.perf_counter() - t0
    add(launches)
    check(cha["errors_in_phase"] == 0 and cha["served_off_cuda"] == 64
          and cha["retries_in_phase"] >= 1 and cha["degraded_requests_in_phase"] > 0,
          f"chaos: {cha}")
    out["chaos"] = serve_line("chaos", hot, hot.summary(), {hot_name: cha["key"]}, launches,
                              t_cha, **cha)
    del hot
    torch.cuda.empty_cache()
    results["serve"] = out
    return total


@contextlib.contextmanager
def recorded_tunes(log: list):
    """Record every ``tune_partitions`` result (the main operator's and
    each multigrid level's) of the distributed path."""
    import repro_torch.distributed_op as dop
    import repro_torch.distributed_op.tune as dtune

    orig = dtune.tune_partitions

    def recording(*args, **kwargs):
        out = orig(*args, **kwargs)
        log.append(out)
        return out

    dop.tune_partitions = dtune.tune_partitions = recording
    try:
        yield log
    finally:
        dop.tune_partitions = dtune.tune_partitions = orig


def dist_keys(label: str, op) -> list:
    """Each part's key as raced (or fixed) beside the key dispatch runs on
    its part (``DistributedOperator.dispatched``), printed on one line."""
    rows = []
    for p, (picked, runs) in enumerate(zip(op.choices, op.dispatched())):
        for block, k, r in (("local", picked[0], runs[0]), ("remote", picked[1], runs[1])):
            if r is not None:
                rows.append({"part": p, "block": block, "picked": f"{k.format}/{k.backend}",
                             "runs": f"{r.format}/{r.backend}"})
    phase(f"{label} keys", picked_runs=json.dumps(
        [f"p{r['part']} {r['block']} {r['picked']}->{r['runs']}" for r in rows]))
    return rows


def dist_input(s, inputs: dict):
    """For ``s`` = fdm27(g, g, g): x made from the seed g, its ``A @ x`` by
    serial csr/plain on the card, and the first SymGS color's row mask (the
    greedy coloring the distributed sweep runs), made once per grid and
    kept in ``inputs``."""
    import numpy as np
    import torch

    from repro_torch.core import as_operator
    from repro_torch.solvers.symgs import greedy_coloring

    n = s.shape[0]
    g = round(n ** (1 / 3))
    if g not in inputs:
        x = torch.from_numpy(np.random.default_rng(g).standard_normal(n)
                             .astype(np.float32)).cuda()
        serial = as_operator(s, "csr", device="cuda").using("plain")
        inputs[g] = (x, serial @ x, torch.from_numpy(greedy_coloring(s) == 0).cuda())
    return inputs[g]


def check_dist_op(label: str, op, x, want, mask) -> tuple:
    """``op @ x`` against serial csr/plain at rtol 2e-4, and one color's
    masked matvec exactly against ``where(mask, op @ x, 0)``. Returns the
    max abs error and ``op @ x``."""
    full = op @ x
    err = within(f"{label}: A @ x against serial csr/plain", full, want)
    check_masked(label, op.masked_matvec(x, mask), full, mask)
    return err, full


def check_masked(label: str, y, full, mask) -> None:
    import torch

    check(torch.equal(y, torch.where(mask, full, torch.zeros((), device=full.device))),
          f"{label}: masked matvec differs from where(mask, A @ x, 0)")


def tune_label(i: int, op) -> str:
    return f"dist tune {round(op.shape[0] ** (1 / 3))}^3" + (" (main)" if i == 0 else " (level)")


def phase_dist_hpcg(results: dict):
    """Phase 11a: distributed HPCG 104^3 over four parts on the card, tuned
    per part and per level. Returns the result and every tuned operator."""
    from repro_torch.apps.hpcg import run_hpcg_distributed
    from repro_torch.core import PartMesh

    g = GRID
    print(f"[dist cut] eager timed reps 3 -> {DIST_REPS} (each rep two 50-iteration "
          f"distributed solves; the graphs replay 3 times)", flush=True)
    tunes = []
    with recorded_tunes(tunes):
        res = run_hpcg_distributed(PartMesh.on("cuda", parts=DIST_PARTS), g, g, g, iters=50,
                                   reps=3, eager_reps=DIST_REPS, candidates=DIST_CANDIDATES,
                                   tol=1e-6, tune_levels=True, device="cuda")
    check(res.bitwise, f"dist HPCG {g}^3: rowblock csr/plain differs from serial csr/plain")
    check(res.rel_res <= 1e-6, f"dist HPCG {g}^3: rel_res {res.rel_res} > 1e-6 after "
          f"{res.pcg_iters} iterations")
    check(res.valid, f"dist HPCG {g}^3: valid=False (rel_err {res.rel_err})")
    tuned = {}
    for i, (op, table) in enumerate(tunes):
        label = tune_label(i, op)
        table_us = {f"p{p}/{b}": {f"{f}/{k}": round(t, 1) for (f, k), t in
                                  sorted(tbl.items(), key=lambda kv: kv[1])}
                    for (p, b), tbl in table.items()}
        phase(label, per_part=repr(op.describe()), halo=op.halo, nbytes=op.nbytes,
              table_us=json.dumps(table_us))
        tuned[label] = {"per_part": op.describe(), "halo": op.halo, "table_us": table_us,
                        "keys": dist_keys(label, op)}
    results["dist_hpcg"] = phase(
        f"dist hpcg {g}^3", parts=DIST_PARTS, valid=res.valid, bitwise=res.bitwise,
        rel_err=res.rel_err, pcg_iters=res.pcg_iters, rel_res=res.rel_res,
        t_ref_s=res.ref_time_s, t_opt_s=res.opt_time_s, eager_reps=DIST_REPS,
        chosen=repr(res.chosen), levels=repr(res.mg_levels))
    results["dist_hpcg"]["graph"] = graph_lines(res, f"dist hpcg {g}^3")
    results["dist_hpcg"]["conv"] = conv_lines(res, f"dist hpcg {g}^3")
    results["dist_hpcg"]["tunes"] = tuned
    return res, [op for op, _ in tunes]


def check_dist_tuned(results: dict, ops: list, inputs: dict) -> None:
    """Phase 11a's check, made after its counted run: every tuned operator
    (the main one and each level's) on the card against serial csr/plain,
    so each per-part kernel the races chose (DIA on the rectangular remote
    windows too) is held to plain at the shapes the path gives it, masked
    and not."""
    for i, op in enumerate(ops):
        label = tune_label(i, op)
        x, want, mask = dist_input(op.source, inputs)
        results["dist_hpcg"]["tunes"][label]["max_abs_err"] = phase(
            f"{label} check", runs=repr(op.describe(dispatched=True)),
            max_abs_err=check_dist_op(label, op, x, want, mask)[0],
            masked_equal=True)["max_abs_err"]


def phase_dist_pairs(results: dict, inputs: dict):
    """Phase 11b-d: the fixed pairs on every distributed level, rowblock at
    104^3 bit for bit, and the halo fault."""
    import numpy as np
    import torch

    from repro_torch.core import PartMesh, split_local_remote
    from repro_torch.core import matrices as M
    from repro_torch.distributed_op import DistributedOperator
    from repro_torch.resilience import FaultPlan, FaultSpec

    kernels = {k: counters()[k] for k in ("dia_spmv", "ell_spmv", "coo_spmv")}
    dia_spmv = kernels["dia_spmv"]
    mesh = PartMesh.on("cuda", parts=DIST_PARTS)
    out = {}
    fault_op = None
    for g in DIST_LEVELS:
        s = M.fdm27(g, g, g)
        mr = s.shape[0] // DIST_PARTS
        x, want, mask = dist_input(s, inputs)
        t0 = time.perf_counter()
        locals_, remotes, halo = split_local_remote(s, DIST_PARTS)
        out[f"split {g}^3"] = phase(
            f"dist {g}^3 split", split_s=round(time.perf_counter() - t0, 3), halo=halo,
            rows_a_part=mr, local_nnz=[m.nnz for m in locals_],
            remote_nnz=[m.nnz for m in remotes], remote_cols=remotes[0].shape[1])
        del locals_, remotes
        for name, (local, remote) in DIST_PAIRS.items():
            op = DistributedOperator.build(s, mesh, local=local, remote=remote)
            label = f"dist {g}^3 {name}"
            keys = dist_keys(label, op)
            for r in keys:  # a part carries no plan: coo/cuda past 8,192 rows runs plain
                runs = ("coo/plain" if r["picked"] == "coo/cuda" and mr > 8192
                        else r["picked"])
                check(r["runs"] == runs, f"{label}: p{r['part']} {r['block']} "
                      f"{r['picked']} runs {r['runs']}, not {runs}")
            # each kernel once a part for every block that runs it
            expect = {k: sum(r["runs"] == f"{k.split('_')[0]}/cuda" for r in keys)
                      for k in kernels}
            err, full = check_dist_op(label, op, x, want, mask)
            counts = {"max_abs_err": err}
            for masked in (False, True):
                before = {k: fn.launches for k, fn in kernels.items()}
                dia_before = dia_spmv.by_shape[(mr, masked)]
                y = op.masked_matvec(x, mask) if masked else op @ x
                torch.cuda.synchronize()
                ran = {k: fn.launches - before[k] for k, fn in kernels.items()}
                if masked:
                    check_masked(label, y, full, mask)
                else:
                    check(torch.equal(y, full), f"{label}: two launches gave different bits")
                check(ran == expect, f"{label}: launched {ran} "
                      f"{'masked' if masked else 'unmasked'}, not {expect}")
                check(dia_spmv.by_shape[(mr, masked)] - dia_before == expect["dia_spmv"],
                      f"{label}: dia_spmv not launched at {mr} rows a part")
                counts["masked" if masked else "unmasked"] = ran
            remote_runs = sorted({r["runs"] for r in keys if r["block"] == "remote"})
            if remote_runs == ["coo/plain"]:
                print(f"[dist] {g}^3 {name}: remote coo/cuda runs coo/plain on parts of {mr} "
                      f"rows (no plan; above max_onehot_rows 8192)", flush=True)
            out[label] = phase(label, halo=op.halo, local_runs=sorted(
                {r["runs"] for r in keys if r["block"] == "local"}), remote_runs=remote_runs,
                launches=json.dumps(counts))
            del full, y
            if g == DIST_LEVELS[-1] and name == "dia+coo":
                fault_op = op
            else:
                del op
        if g == DIST_LEVELS[0]:
            # (c) rowblock csr/plain at 104^3, bit for bit against serial csr/plain
            chk = DistributedOperator.build(s, mesh, local="csr", mode="rowblock")
            same = bool(torch.equal(chk @ x, want))
            check(same, f"dist {g}^3 rowblock csr/plain differs from serial csr/plain")
            out["rowblock"] = phase(f"dist {g}^3 rowblock", bitwise=same, format=chk.format)
            del chk
        del s, x, want, mask
        torch.cuda.empty_cache()

    # (d) the halo fault: one dropped exchange is loud, and it passes
    g = DIST_LEVELS[-1]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(g ** 3)
                         .astype(np.float32)).cuda()
    y_ok = fault_op @ x
    with FaultPlan([FaultSpec(site="halo", times=1)]) as plan:
        y_bad = fault_op @ x
    fired = plan.fired("halo")
    check(fired == 1, f"halo fault fired {fired} times, not once")
    check(not torch.allclose(y_bad, y_ok), "a dropped halo left the matvec unchanged")
    check(torch.equal(fault_op @ x, y_ok), "the matvec after a dropped halo is not the same")
    out["halo_fault"] = phase(f"dist {g}^3 halo fault", fired=fired,
                              max_abs_change=float((y_bad - y_ok).abs().max()), after_equal=True)
    results["dist_pairs"] = out


def phase_dist(results: dict) -> tuple:
    """Phase 11, each path counted on its own: (a) the tuned distributed
    HPCG, then its operators' check; (b-d) the fixed pairs, rowblock, the
    halo fault. Returns the launches of (a) and of (b-d)."""
    (_, ops), launches_dist, _ = counted(f"dist hpcg {GRID}^3",
                                         lambda: phase_dist_hpcg(results))
    inputs = {}
    check_dist_tuned(results, ops, inputs)
    del ops
    _, launches_pairs, _ = counted("dist pairs", lambda: phase_dist_pairs(results, inputs))
    return launches_dist, launches_pairs


def close(what: str, got, want, rtol: float, atol: float) -> float:
    """Max abs error of ``got`` against ``want``, which it must meet at
    ``|got - want| <= atol + rtol * |want|`` (numpy's allclose rule)."""
    import torch

    got, want = got.double(), want.double()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs()
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{what}: disagreement beyond rtol {rtol} atol {atol} (max err {float(err.max())})")
    return float(err.max())


def bsr_forward_lib(P, X):
    """torch's BSR product on the blocks of the BSR container ``P`` (f32)
    and X, padded to whole block columns beforehand (a BSR tensor's shape
    is whole blocks): ``bsr_spmm``'s yardstick."""
    import torch

    dev = P.bcols.device
    valid = P.bcols >= 0
    ncols = -(-P.shape[1] // P.bs) * P.bs
    A = torch.sparse_bsr_tensor(
        torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), valid.sum(1).cumsum(0)]),
        P.bcols[valid].long(), P.blocks[valid].float(), size=(P.bcols.shape[0] * P.bs, ncols))
    Xp = torch.zeros((ncols, X.shape[1]), device=dev)
    Xp[: P.shape[1]] = X[: P.shape[1]]
    return lambda: A @ Xp


def measure_model_kernel(label: str, fn, plain, moved: int, flops: int, kernel: str,
                         library=None, exact=False, rtol=2e-4, rate=F32_FLOPS,
                         **extra) -> dict:
    """Phase 12d's line for one kernel call at the model path's shapes:
    against its plain version (exactly when ``exact``), two launches
    bit-equal, then ``ms`` (events), ``kernel_ms`` (device time),
    ``plain_ms``, ``library_ms`` (one PyTorch call on the same inputs, or
    ``None``) and the bound (``moved`` bytes against ``flops`` at ``rate``,
    the f32 CUDA-core rate unless given)."""
    import torch

    y, y_plain = fn(), plain()
    err = within(f"{label} against its plain version", y, y_plain, rtol=rtol)
    same = bool(torch.equal(y, y_plain))
    if exact:
        check(same, f"{label}: kernel differs from its plain version")
    check(bool(torch.equal(y, fn())), f"{label}: two launches differ")
    b_ms, b_by = bound(moved, flops, rate)
    k_ms = kernel_ms(fn, kernel)
    check(k_ms is None or k_ms >= b_ms,
          f"{label}: kernel_ms {k_ms} under its bound {b_ms}: an impossible reading")
    lib_ms = lib_kernel = None
    if library is not None:
        try:
            within(f"{label}: the library call against the kernel",
                   library().reshape(y.shape), y, rtol=rtol)
            lib_ms, lib_kernel = cuda_ms(library, 20), kernel_ms(library, "")
        except (RuntimeError, NotImplementedError) as e:  # no such product in this torch
            extra["library_error"] = repr(f"{type(e).__name__}: {str(e)[:120]}")
    return phase(f"model kernel {label}", **extra, exact=same, repeat_equal=True,
                 max_abs_err=err, ms=cuda_ms(fn, 50), kernel_ms=k_ms,
                 plain_ms=cuda_ms(plain, 5), library_ms=lib_ms, library_kernel_ms=lib_kernel,
                 bytes=moved, flops=flops, bound_ms=b_ms, bound_by=b_by)


@contextlib.contextmanager
def recorded_routes(log: list):
    """Record the top-k experts of every MoE routing (``moe._route``), in
    call order, as device tensors (no copy to the host)."""
    import repro_torch.models.moe as moe_mod

    orig = moe_mod._route

    def recording(p, x, mcfg):
        out = orig(p, x, mcfg)
        log.append(out[1])
        return out

    moe_mod._route = recording
    try:
        yield log
    finally:
        moe_mod._route = orig


def first_moe(params) -> dict:
    """The parameters of the first MoE FFN of a model (layer 0 of the first
    group that holds one; Jamba's first MoE slot)."""
    from repro_torch.models.model import layer

    def find(tree):
        if isinstance(tree, dict):
            if "router" in tree:
                return tree
            for v in tree.values():
                hit = find(v)
                if hit is not None:
                    return hit
        return None

    for gp in params["groups"]:
        hit = find(layer(gp, 0))
        if hit is not None:
            return hit
    raise SystemExit("chip_smoke: the model holds no MoE layer")


def model_serve(results: dict, smi: str, routes: list, cell: ModelCell):
    """Phase 12a (13a, 14a): the model built on the card from a seeded
    generator and served through ``serve_lm`` with the eager step (bsr
    lane, ``use_backend("cuda")``); then one more decode step under the
    sync debug mode "error" at an int and at a tensor position, so no host
    sync hides in the step; then the same params served again through the
    captured step (:func:`model_graph`). Returns the eager served run and
    its step logits."""
    import types

    import torch

    from repro_torch.core import use_backend
    from repro_torch.distributed.sharding import param_paths
    from repro_torch.launch.serve import serve_lm

    args = types.SimpleNamespace(arch=cell.arch, smoke=False, seed=0, layers=cell.layers,
                                 dispatch_impl="bsr", device=MODEL_DEVICE, graph=False,
                                 **MODEL_SERVE)
    logits = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = serve_lm(args, logits_out=logits)
    wall = time.perf_counter() - t0
    bsr_launches = counters()["bsr_spmm"].launches
    peak = torch.cuda.max_memory_allocated()
    n_routes = len(routes)
    model, params, cfg = served["model"], served["params"], served["cfg"]
    caches = model.init_caches(MODEL_SERVE["batch"], 2)
    tok = served["generated"][:, -1:].to(torch.int32).to(MODEL_DEVICE)
    torch.cuda.synchronize()
    pos = torch.ones((), dtype=torch.int64, device=MODEL_DEVICE)
    with use_backend("cuda"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.decode_step(params, tok, caches, 0)
            model.decode_step(params, tok, caches, pos)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del routes[n_routes:], caches
    results[cell.key] = phase(
        f"{cell.key} serve", smi=repr(smi), arch=cfg.name, layers=cfg.n_layers,
        routed_layers=cell.routed, d_model=cfg.d_model, experts=cfg.moe.n_experts,
        top_k=cfg.moe.top_k, vocab=cfg.vocab, dispatch_impl=cfg.moe.dispatch_impl,
        batch=MODEL_SERVE["batch"], prompt=MODEL_SERVE["prompt_len"], gen=MODEL_SERVE["gen"],
        param_gb=sum(t.numel() * t.element_size() for _, t in param_paths(params)) / 1e9,
        prompt_ms=served["prompt_s"] * 1e3, decode_ms=served["decode_s"] * 1e3,
        tok_s=served["tok_s"], ms_token_p50=served["p50_s"] * 1e3,
        ms_token_p99=served["p99_s"] * 1e3, bsr_spmm_launches=bsr_launches,
        peak_memory_gb=peak / 1e9, wall_s=wall, decode_step_without_sync=True)
    results[cell.key]["graph"] = model_graph(args, served, logits, cell)
    if cell.key == "model":
        results[cell.key]["trace"] = decode_trace(served)
    del routes[n_routes:]  # the captures' routings: phase (b) reads the eager serve's
    return served, logits


def model_graph(args, served, logits: list, cell: ModelCell) -> dict:
    """Phase 12a's (13a, 14a) captured serve: ``serve_lm`` with
    ``graph=True`` on the eager serve's params, every step a replay of one
    ``CapturedDecode``. Fails unless every step's logits and every token
    equal the eager serve's bit for bit. Routing recorders and launch
    counters see only the warm-up and the capture."""
    import types

    import torch

    from repro_torch.launch.serve import serve_lm

    graph_logits = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve_lm(types.SimpleNamespace(**{**vars(args), "graph": True}),
                   params=served["params"], logits_out=graph_logits)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = out["graph"]
    equal = (len(graph_logits) == len(logits)
             and all(torch.equal(a, b) for a, b in zip(graph_logits, logits))
             and torch.equal(out["generated"], served["generated"]))
    line = phase(
        f"{cell.key} graph", capture_s=round(st["capture_s"], 3),
        instantiate_s=round(st["instantiate_s"], 3), nodes=st["nodes"],
        bsr_spmm_launches_a_step=st["launches"].get("bsr_spmm", 0),
        launches_a_step=json.dumps(st["launches"]), prompt_ms=out["prompt_s"] * 1e3,
        decode_ms=out["decode_s"] * 1e3, tok_s=out["tok_s"],
        ms_token_p50=out["p50_s"] * 1e3, ms_token_p99=out["p99_s"] * 1e3,
        peak_memory_gb=peak / 1e9, wall_s=wall, graph_equal=equal)
    check(equal, f"{cell.key}: a replay's logits or tokens differ from the eager serve's")
    check(st["launches"].get("bsr_spmm", 0) > 0,
          f"{cell.key}: the captured step launches no bsr_spmm")
    del graph_logits, out
    torch.cuda.empty_cache()
    return line


def step_trace(fn) -> dict:
    """One call of ``fn`` (warm) under ``torch.profiler``: the device's
    busy ms (every device record: kernels, copies, memsets) over the wall
    ms of the call and its synchronize, and the five kernels of the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    busy = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            us = e.time_range.elapsed_us()
            busy += us
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + us / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"busy_ms": busy / 1e3, "wall_ms": wall, "busy_share": busy / 1e3 / wall,
            "records": sum(n for _, n in by_name.values()),
            "top5": [(name[:80], round(ms, 4), n) for name, (ms, n) in top],
            "unprofiled_ms": cuda_ms(fn, 5)}


def decode_trace(served) -> dict:
    """Phase 12a's trace: one eager decode step and one replay of the
    captured step (the same params, fresh caches, the served config's
    batch, a position past the prompt), each through :func:`step_trace`."""
    import torch

    from repro_torch.core import use_backend
    from repro_torch.serve import CapturedDecode

    model, params = served["model"], served["params"]
    B, S, G = MODEL_SERVE["batch"], MODEL_SERVE["prompt_len"], MODEL_SERVE["gen"]
    tok = served["generated"][:, :1].to(torch.int32).to(MODEL_DEVICE)
    out = {}
    with use_backend("cuda"), torch.no_grad():
        caches = model.init_caches(B, S + G)
        out["eager"] = step_trace(lambda: model.decode_step(params, tok, caches, S))
        del caches
        step = CapturedDecode(model, params, model.init_caches(B, S + G), B)
        out["replay"] = step_trace(lambda: step(tok, S))
        del step
    torch.cuda.empty_cache()
    for name, tr in out.items():
        phase(f"model decode trace {name}", busy_ms=round(tr["busy_ms"], 4),
              wall_ms=round(tr["wall_ms"], 4), busy_share=round(tr["busy_share"], 4),
              device_records=tr["records"], unprofiled_ms=round(tr["unprofiled_ms"], 4),
              top5=json.dumps(tr["top5"]))
    return out


def model_teacher_forced(results: dict, served, logits_a: list, routes: list,
                         cell: ModelCell) -> None:
    """Phase 12b (13b, 14b): the served tokens fed through the same model
    under ``use_backend("plain")``; each step's logits against the served
    run's, row by row up to a row's first routing difference, and the
    greedy tokens wherever the plain run's top-2 margin exceeds the
    tolerance."""
    import torch

    from repro_torch.core import use_backend

    model, params = served["model"], served["params"]
    B, S, G = MODEL_SERVE["batch"], MODEL_SERVE["prompt_len"], MODEL_SERVE["gen"]
    seq = torch.cat([served["prompt"], served["fed"]], 1).to(MODEL_DEVICE)
    launches = launch_counts()
    n_a = len(routes)
    L = n_a // (S + G)
    check(n_a == L * (S + G) and L == cell.routed,
          f"{cell.key}: {n_a} routings for {S + G} steps of {cell.routed} routed layers")
    t0 = time.perf_counter()
    logits_b = []
    with use_backend("plain"):
        caches = model.init_caches(B, S + G)
        for t in range(S + G):
            lg, caches = model.decode_step(params, seq[:, t:t + 1], caches, t)
            logits_b.append(lg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del caches
    check(launch_counts() == launches, f"{cell.key}: the plain run launched a kernel")
    eps = torch.finfo(torch.bfloat16).eps
    alike = torch.ones(B, dtype=torch.bool, device=MODEL_DEVICE)
    compared = tokens_checked = 0
    worst = worst_tol = 0.0
    for t in range(S + G):
        for a, b in zip(routes[L * t:L * (t + 1)], routes[n_a + L * t:n_a + L * (t + 1)]):
            alike &= (a == b).all(dim=-1)
        la, lb = logits_a[t].float(), logits_b[t].float()
        tol = MODEL_LOGIT_EPS * eps * float(lb.abs().max())
        err = (la - lb).abs().amax(dim=-1)
        rows = alike.nonzero().flatten()
        check(bool((err[rows] <= tol).all()), f"{cell.key} step {t}: logits of rows routed "
              f"alike differ by {err[rows].tolist()} > {tol}")
        compared += rows.numel()
        if rows.numel():
            worst = max(worst, float(err[rows].max()))
            worst_tol = max(worst_tol, tol)
        top2 = lb.topk(2, dim=-1).values
        clear = alike & (top2[:, 0] - top2[:, 1] > tol)
        same = la.argmax(-1) == lb.argmax(-1)
        check(bool(same[clear].all()), f"{cell.key} step {t}: greedy tokens differ where "
              "plain's top-2 margin exceeds the tolerance")
        tokens_checked += int(clear.sum())
        if t >= S:  # the served run's greedy token is its logits' argmax
            check(bool((served["generated"][:, t - S].to(MODEL_DEVICE) == la.argmax(-1)).all()),
                  f"{cell.key} step {t}: served token is not its logits' argmax")
    flips = B * (S + G) - compared
    check(compared >= MODEL_COMPARED * B * (S + G),
          f"{cell.key}: only {compared} of {B * (S + G)} row-steps routed alike")
    del routes[n_a:]
    results[f"{cell.key}_plain"] = phase(
        f"{cell.key} teacher-forced vs plain", row_steps=B * (S + G), compared=compared,
        not_compared_after_a_routing_difference=flips, max_abs_err=worst,
        tolerance=worst_tol, tolerance_rule=f"{MODEL_LOGIT_EPS} eps(bf16) max|logit|",
        tokens_checked=tokens_checked, plain_s=plain_s)


def model_lanes(results: dict, served, cell: ModelCell) -> None:
    """Phase 12c (13c, 14c): one ``moe_ffn`` per lane on the first MoE
    layer's weights at full width, f32 activations, ``MODEL_LANE_T`` tokens,
    under ``use_backend("cuda")``. 'sort' runs twice and gives equal bits;
    coo, bsr and onehot share its routing and capacity and hold to it at
    the reference's MoE contract. 'grouped' over two groups runs twice
    (equal bits) and holds to 'sort' at a capacity where neither drops a
    pick (a group's capacity differs from the whole batch's, so they drop
    different picks at the config's). The bsr and coo dispatch matrices
    give the dispatched rows ``x[t_s]`` bit for bit."""
    import dataclasses

    import torch

    from repro_torch.core import SparseOperator, use_backend
    from repro_torch.models import moe as moe_mod

    cfg = served["cfg"]
    lp = first_moe(served["params"])
    T, D = MODEL_LANE_T, cfg.d_model
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    x = torch.randn((T, D), generator=torch.Generator(device=MODEL_DEVICE).manual_seed(1),
                    device=MODEL_DEVICE)
    nodrop = E / K  # capacity T (Tg a group): no expert can be picked more often
    runs = {"sort": ("sort", cfg.moe.capacity_factor, 0), "coo": ("coo", None, 0),
            "bsr": ("bsr", None, 0), "onehot": ("onehot", None, 0),
            "sort_again": ("sort", None, 0), "sort_nodrop": ("sort", nodrop, 0),
            "grouped": ("grouped", nodrop, 2), "grouped_again": ("grouped", nodrop, 2)}
    out, secs = {}, {}
    with use_backend("cuda"):
        for name, (impl, cf, groups) in runs.items():
            mcfg = dataclasses.replace(cfg.moe, dispatch_impl=impl, n_groups=groups,
                                       capacity_factor=cf or cfg.moe.capacity_factor)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = moe_mod.moe_ffn(lp, x, cfg, mcfg)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        for a, b in (("sort", "sort_again"), ("grouped", "grouped_again")):
            check(bool(torch.equal(out[a][0], out[b][0])), f"{cell.key} moe_ffn {a}: two runs "
                  "give different bits")
        errs = {}
        for impl, base in (("coo", "sort"), ("bsr", "sort"), ("onehot", "sort"),
                           ("grouped", "sort_nodrop")):
            (y, aux), (y0, aux0) = out[impl], out[base]
            errs[impl] = close(f"{cell.key} moe_ffn {impl} against {base}", y, y0,
                               MOE_RTOL, MOE_ATOL)
            close(f"{cell.key} moe_ffn {impl} aux against {base}", aux, aux0, MOE_AUX_RTOL, 0.0)
        C = moe_mod._capacity(T, K, E, cfg.moe.capacity_factor)
        topw, tope, _ = moe_mod._route(lp, x, cfg.moe)
        slot, t_s, w_s, keep = moe_mod._dispatch_indices(tope, topw, T, E, K, C)
        xe = torch.zeros((E * C + 1, D), device=MODEL_DEVICE)
        xe[slot] = x[t_s]
        for make in (moe_mod.bsr_dispatch, moe_mod.coo_dispatch):
            P = make(slot, t_s, keep, T, E, C, x.dtype)
            check(bool(torch.equal(SparseOperator(P) @ x, xe[: E * C])),
                  f"{cell.key} moe {P.format} dispatch does not give x[t_s] bit for bit")
    results[f"{cell.key}_lanes"] = phase(
        f"{cell.key} moe_ffn lanes", tokens=T, capacity=C, slots=E * C,
        kept=int(keep.sum()), nodrop_capacity_factor=nodrop,
        seconds=json.dumps({k: round(v, 4) for k, v in secs.items()}),
        max_abs_err_vs_sort=json.dumps(errs), dispatch_bit_exact=True,
        sort_and_grouped_repeat_bits=True)


def model_kernels(results: dict, served, cell: ModelCell) -> dict:
    """Phase 12d (13d, 14d): ``bsr_spmm`` at the decode step's dispatch
    (E*C x T, bf16 blocks against T rows of X) and combine (T x E*C+1
    against ``h_pad``) shapes, each against its plain version, with the
    cost of building a step's two BSR containers; phase 12 adds
    ``coo_spmv`` on the unsorted combine of a 128-token ``moe_ffn`` (f32)
    and the cost of a COO container's first call (its order check reads
    one flag from the device)."""
    import torch

    from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_path, bsr_spmm_plain
    from repro_torch.kernels.coo_spmv import coo_spmv, coo_spmv_from_container, coo_spmv_plain
    from repro_torch.models import moe as moe_mod

    cfg = served["cfg"]
    lp = first_moe(served["params"])
    E, K, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    gen = torch.Generator(device=MODEL_DEVICE).manual_seed(2)
    out = {}
    name = "MoE" if cell.key == "model" else cell.key
    key = "moe" if cell.key == "model" else cell.key

    T = MODEL_SERVE["batch"]  # a decode step routes one token a sequence
    x = torch.randn((T, D), generator=gen, device=MODEL_DEVICE).to(cfg.activation_dtype)
    C = moe_mod._capacity(T, K, E, cfg.moe.capacity_factor)
    topw, tope, _ = moe_mod._route(lp, x, cfg.moe)
    slot, t_s, w_s, keep = moe_mod._dispatch_indices(tope, topw, T, E, K, C)
    Pd = moe_mod.bsr_dispatch(slot, t_s, keep, T, E, C, x.dtype)
    Xd = x.float()
    real = int((Pd.bcols >= 0).sum())
    moved = real * 64 * Pd.blocks.element_size() + nbytes(Pd.bcols, Xd) + E * C * D * 4
    out[f"{key}_dispatch"] = measure_model_kernel(
        f"bsr_spmm {name} decode dispatch", lambda: bsr_spmm(Pd.bcols, Pd.blocks, Xd),
        lambda: bsr_spmm_plain(Pd.bcols, Pd.blocks, Xd), moved, 2 * real * 64 * D,
        "bsr_spmm_", library=bsr_forward_lib(Pd, Xd), exact=True,
        shape=(E * C, T), nf=D, bs=Pd.bs, bwidth=Pd.bwidth, block_rows=Pd.bcols.shape[0],
        real_blocks=real, capacity=C, path=bsr_spmm_path(Pd.bs, D))
    h = torch.randn((E * C + 1, D), generator=gen, device=MODEL_DEVICE).to(cfg.activation_dtype)
    h[-1] = 0
    Pc = moe_mod.bsr_combine(slot, tope, w_s, keep, T, E, C, h.dtype)
    Xc = h.float()
    real = int((Pc.bcols >= 0).sum())
    # the combine reads only the rows of h its real blocks name
    read_rows = int(torch.unique(Pc.bcols[Pc.bcols >= 0]).numel()) * Pc.bs
    moved = real * 64 * Pc.blocks.element_size() + nbytes(Pc.bcols) + read_rows * D * 4 + (
        Pc.bcols.shape[0] * Pc.bs * D * 4)
    out[f"{key}_combine"] = measure_model_kernel(
        f"bsr_spmm {name} decode combine", lambda: bsr_spmm(Pc.bcols, Pc.blocks, Xc),
        lambda: bsr_spmm_plain(Pc.bcols, Pc.blocks, Xc), moved, 2 * real * 64 * D,
        "bsr_spmm_", library=bsr_forward_lib(Pc, Xc), shape=(T, E * C + 1), nf=D, bs=Pc.bs,
        bwidth=Pc.bwidth, block_rows=Pc.bcols.shape[0], real_blocks=real,
        path=bsr_spmm_path(Pc.bs, D))

    def build():
        return (moe_mod.bsr_dispatch(slot, t_s, keep, T, E, C, x.dtype),
                moe_mod.bsr_combine(slot, tope, w_s, keep, T, E, C, h.dtype))

    build_ms = cuda_ms(build, 20)
    out[f"{key}_dispatch"]["containers_ms_per_layer"] = build_ms
    phase(f"{cell.key} containers", bsr_dispatch_and_combine_ms_per_layer=build_ms,
          per_decode_step_ms=build_ms * cell.routed)
    results[f"{cell.key}_kernels"] = out
    if cell.key != "model":
        return out

    # coo_spmv on a 128-token f32 combine: rows are tokens in expert order
    T = MODEL_LANE_T
    x = torch.randn((T, D), generator=gen, device=MODEL_DEVICE)
    C = moe_mod._capacity(T, K, E, cfg.moe.capacity_factor)
    topw, tope, _ = moe_mod._route(lp, x, cfg.moe)
    slot, t_s, w_s, keep = moe_mod._dispatch_indices(tope, topw, T, E, K, C)
    hc = torch.randn((E * C + 1,), generator=gen, device=MODEL_DEVICE)
    hc[-1] = 0
    P = moe_mod.coo_combine(slot, t_s, w_s, keep, T, E, C, torch.float32)
    check(bool((P.row[1:] < P.row[:-1]).any()), "the MoE combine's rows came out sorted")
    checks = coo_spmv.order_checks
    first_ms = cuda_ms(lambda: coo_spmv_from_container(
        moe_mod.coo_combine(slot, t_s, w_s, keep, T, E, C, torch.float32), hc), 20)
    # the lane marks its containers UNSORTED: sorted on the device, no flag read
    check(coo_spmv.order_checks == checks, "coo_spmv: an order check on a marked container")
    coo_spmv_from_container(P, hc)
    check(P.cache["rows"].perm is not None, "coo_spmv: a marked container was not sorted")
    lib_A = torch.sparse_coo_tensor(torch.stack([P.row.long(), P.col.long()]), P.val,
                                    P.shape)
    moved = nbytes(P.row, P.col, P.val) + P.nnz * 4 + T * 4
    out["moe_combine_unsorted"] = measure_model_kernel(
        "coo_spmv MoE combine, unsorted rows", lambda: coo_spmv_from_container(P, hc),
        lambda: coo_spmv_plain(P.row, P.col, P.val, hc, T), moved, 2 * P.nnz,
        "coo_rows_kernel", library=lambda: torch.sparse.mm(lib_A, hc[:, None]), exact=True,
        shape=P.shape, entries=P.nnz, sorted_by_row=False,
        first_call_ms=first_ms)
    return out


def model_mla(results: dict, served) -> None:
    """Phase 13e: the first layer's MLA fed the prompt's normed embeddings
    (f32) token by token through the absorbed ``mla_decode``, against the
    direct ``mla_train``, at the reference's bound (0.05 max|want|)."""
    import torch

    from repro_torch.models import mla as mla_mod
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import layer

    cfg, model, params = served["cfg"], served["model"], served["params"]
    lp = layer(params["groups"][0], 0)
    prompt = served["prompt"].to(MODEL_DEVICE)
    B, S = prompt.shape
    x = rmsnorm(params["embed"][prompt.long()].float(), lp["ln1"].float(), cfg.norm_eps)
    pos = torch.arange(S, dtype=torch.int32, device=MODEL_DEVICE)[None].expand(B, S)
    want = mla_mod.mla_train(lp["mixer"], x, cfg, pos)
    cache = mla_mod.init_mla_cache(cfg, B, S, torch.float32, MODEL_DEVICE)
    got = torch.cat([mla_mod.mla_decode(lp["mixer"], x[:, t:t + 1], cfg, cache, t)[0]
                     for t in range(S)], dim=1)
    err = close("mla_decode (absorbed) against mla_train (direct)", got, want, 0.0,
                MLA_ATOL_OF_MAX * float(want.abs().max()))
    results["deepseek_mla"] = phase(
        "deepseek mla absorbed vs direct", batch=B, positions=S, heads=cfg.n_heads,
        kv_lora=cfg.mla.kv_lora_rank, max_abs_err=err,
        tolerance=MLA_ATOL_OF_MAX * float(want.abs().max()),
        cache_floats_per_token=cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)


def model_sparsify_attention(results: dict, served) -> None:
    """Phase 12e: one full-width expert ``w_down`` pruned to BSR and applied
    by ``bsr_linear`` on the card at 4 and 128 tokens, against plain and
    the masked dense product; one ``block_sparse_attention`` at the
    config's heads against a dense masked oracle."""
    import torch

    from repro_torch import sparsify
    from repro_torch.core import use_backend
    from repro_torch.kernels.bsr_spmm import bsr_spmm_path
    from repro_torch.models.attention import block_attention_bcols, block_sparse_attention

    cfg = served["cfg"]
    w = served["params"]["groups"][0]["ffn"]["experts"]["w_down"][0, 0]  # (1536, 4096)
    A = sparsify.prune_linear_to_bsr(w, density=PRUNE_DENSITY, bs=PRUNE_BS, device=MODEL_DEVICE)
    dense = A.to_dense()  # (4096, 1536): the kept blocks of w^T
    gen = torch.Generator(device=MODEL_DEVICE).manual_seed(3)
    errs = {}
    for t in PRUNE_TOKENS:
        xt = torch.randn((t, w.shape[0]), generator=gen, device=MODEL_DEVICE)
        y = sparsify.bsr_linear(A, xt, impl="cuda")
        errs[t] = within(f"bsr_linear {t} tokens against plain", y,
                         sparsify.bsr_linear(A, xt, impl="plain"))
        within(f"bsr_linear {t} tokens against the masked dense product", y, xt @ dense.T)
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = (torch.randn((ATTN_B, ATTN_S, H, hd), generator=gen, device=MODEL_DEVICE)
               for _ in range(3))
    with use_backend("cuda"):
        o = block_sparse_attention(q, k, v, block_size=ATTN_BLOCK, pattern="banded")
    bc = torch.from_numpy(block_attention_bcols(ATTN_S, ATTN_BLOCK, "banded"))
    allowed = torch.zeros((ATTN_S // ATTN_BLOCK,) * 2, dtype=torch.bool)
    for r in range(bc.shape[0]):
        allowed[r, bc[r][bc[r] >= 0]] = True
    allowed = allowed.repeat_interleave(ATTN_BLOCK, 0).repeat_interleave(ATTN_BLOCK, 1).to(MODEL_DEVICE)
    want = torch.empty_like(o)
    for h0 in range(0, H, 16):  # the oracle a slab of heads at a time
        sl = slice(h0, h0 + 16)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, :, sl], k[:, :, sl]) / hd ** 0.5
        s = torch.where(allowed, s, torch.full((), float("-inf"), device=MODEL_DEVICE))
        want[:, :, sl] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v[:, :, sl])
    attn_err = within("block_sparse_attention against a dense masked oracle", o, want)
    results["model_sparsify"] = phase(
        "model sparsify and block attention", w_down=tuple(w.shape), bs=A.bs,
        bwidth=A.bwidth, kept_blocks=int((A.bcols >= 0).sum()),
        bsr_linear_path=bsr_spmm_path(A.bs, PRUNE_TOKENS[-1]),
        bsr_linear_max_abs_err=json.dumps(errs), attention_shape=(ATTN_B, ATTN_S, H, hd),
        attention_block=ATTN_BLOCK, attention_path=bsr_spmm_path(ATTN_BLOCK, hd),
        attention_max_abs_err=attn_err)


def phase_model(results: dict, smi: str, cell: ModelCell = MODEL_CELLS[12]) -> tuple:
    """Phase 12 (13, 14), a model path: (a) serve and (b) the plain
    teacher-forced check, (c) one ``moe_ffn`` per lane, counted together as
    the path; then (d) its kernels at its shapes, and phase 12's (e)
    sparsify and block attention or phase 13's (e) MLA check. Returns the
    path's launches and (d)'s kernel lines."""
    import torch

    torch.cuda.empty_cache()
    routes = []

    def drive():
        with recorded_routes(routes):
            served, logits = model_serve(results, smi, routes, cell)
            model_teacher_forced(results, served, logits, routes, cell)
        del logits
        model_lanes(results, served, cell)
        return served

    served, launches, _ = counted(cell.key, drive)
    check(launches["bsr_spmm"] > 0, f"bsr_spmm was not launched on the {cell.key} path")
    kern = model_kernels(results, served, cell)
    if cell.key == "model":
        model_sparsify_attention(results, served)
    if served["cfg"].mla is not None:
        model_mla(results, served)
    del served
    torch.cuda.empty_cache()
    return launches, kern


def bsr_transpose_lib(bcols, blocks, ncols: int, work):
    """torch's BSR product on a BSR tensor of A^T (built once from the
    work list: block column c's blocks, transposed, are row c of A^T), for
    ``bsr_spmm_t``'s yardstick: ``At @ dY`` cut to ``ncols`` rows."""
    import torch

    order, starts = work
    bs, bwidth = blocks.shape[-1], bcols.shape[1]
    nbcols = starts.shape[0] - 1
    n = int(starts[-1])
    slots = order[:n].long()
    At = torch.sparse_bsr_tensor(starts.long(), slots // bwidth,
                                 blocks.reshape(-1, bs, bs)[slots].transpose(-1, -2).float(),
                                 size=(nbcols * bs, bcols.shape[0] * bs))
    return lambda dY: (At @ dY)[:ncols]


def bsr_sampled_lib(bcols, bs: int, X, ncols: int):
    """``torch.sparse.sampled_addmm`` over the stored blocks' entries (one
    CSR pattern, duplicate block positions merged), for ``bsr_sddmm``'s
    yardstick; returns the call and a map from its values to the kernel's
    layout (the first stored block of each position)."""
    import torch

    dev = X.device
    nbrows, bwidth = bcols.shape
    nbcols = -(-ncols // bs)
    valid = ((bcols >= 0) & (bcols < nbcols)).reshape(-1)
    slots = valid.nonzero().flatten()
    ar = torch.arange(bs, device=dev)
    r = (slots // bwidth)[:, None, None] * bs + ar[None, :, None]
    c = bcols.reshape(-1)[slots].long()[:, None, None] * bs + ar[None, None, :]
    keys = (r * (nbcols * bs) + c).reshape(-1)
    uniq, inv = torch.unique(keys, return_inverse=True)
    rows, cols = uniq // (nbcols * bs), uniq % (nbcols * bs)
    crow = torch.searchsorted(rows, torch.arange(nbrows * bs + 1, device=dev))
    S = torch.sparse_csr_tensor(crow, cols, torch.zeros(uniq.shape[0], device=dev),
                                size=(nbrows * bs, nbcols * bs))
    Xp = torch.zeros((nbcols * bs, X.shape[1]), device=dev)
    Xp[:ncols] = X

    def at_positions(dB):
        out = torch.zeros(uniq.shape[0], device=dev)
        return out.scatter_(0, inv, dB.reshape(-1, bs * bs)[slots].reshape(-1).float())

    return (lambda dY: torch.sparse.sampled_addmm(S, dY, Xp.t())), at_positions


def measure_backward(label: str, kernel: str, fn, plain, autograd, moved: int, flops: int,
                     library=None, library_name=None, library_at=None, **extra) -> dict:
    """Phase 15a's line for one backward kernel call: against its plain
    version and against autograd through ``bsr_spmm_plain`` (rtol 2e-4,
    atol 2e-4 max|want|), two launches bit-equal, then ``ms`` (events),
    ``kernel_ms`` (device time), ``plain_ms``, the bound (bytes against
    flops at ``TF32X3_FLOPS``, the rate phase 2 gives ``bsr_spmm``: the
    fastest at which the card meets the same tolerance) and the library
    call's time."""
    import torch

    y = fn()
    err = within(f"{label} against its plain version", y, plain())
    within(f"{label} against autograd through bsr_spmm_plain", y, autograd())
    check(bool(torch.equal(y, fn())), f"{label}: two launches differ")
    b_ms, b_by = bound(moved, flops, TF32X3_FLOPS)
    k_ms = kernel_ms(fn, kernel)
    check(k_ms is None or k_ms >= b_ms,
          f"{label}: kernel_ms {k_ms} under its bound {b_ms}: an impossible reading")
    lib_ms = lib_kernel = None
    if library is not None:
        try:
            lib_y, want = library(), y
            if library_at is not None:  # a sparse result: its values against the kernel's
                lib_y, want = lib_y.values(), library_at(y)
            within(f"{label}: {library_name} against the kernel", lib_y, want)
            lib_ms, lib_kernel = cuda_ms(library, 20), kernel_ms(library, "")
        except (RuntimeError, NotImplementedError) as e:  # no such product in this torch
            extra["library_error"] = repr(f"{type(e).__name__}: {str(e)[:120]}")
    return phase(f"train kernel {label}", **extra, repeat_equal=True, max_abs_err=err,
                 ms=cuda_ms(fn, 50), kernel_ms=k_ms, plain_ms=cuda_ms(plain, 5),
                 library=library_name, library_ms=lib_ms, library_kernel_ms=lib_kernel,
                 bytes=moved, flops=flops, bound_ms=b_ms, bound_by=b_by)


def backward_pair(label: str, P, X, dY, ncols: int, dX_only=False, **extra) -> dict:
    """``bsr_spmm_t`` (and, unless ``dX_only``, ``bsr_sddmm``) for the BSR
    arrays of ``P`` with the forward's f32 ``X`` and the output gradient
    ``dY``, each measured by :func:`measure_backward` (``extra`` joins both
    lines)."""
    import torch

    from repro_torch.kernels.bsr_spmm import (bsr_column_order, bsr_sddmm, bsr_sddmm_plain,
                                              bsr_spmm_plain, bsr_spmm_t, bsr_spmm_t_plain)

    bcols, blocks, bs = P.bcols, P.blocks, P.bs
    nbcols = -(-ncols // bs)
    work = bsr_column_order(bcols, nbcols)
    work_ms = cuda_ms(lambda: bsr_column_order(bcols, nbcols), 20)
    valid = (bcols >= 0) & (bcols < nbcols)
    real, nf = int(valid.sum()), dY.shape[1]
    rows_read = int(valid.any(1).sum()) * bs  # dY rows of block rows with a block
    out = {}

    def autograd(wrt):  # f32 blocks: the plain version upcasts them, and dB stays f32
        x = X.detach().clone().requires_grad_(wrt == "x")
        b = blocks.detach().float().requires_grad_(wrt == "b")
        g = torch.autograd.grad(bsr_spmm_plain(bcols, b, x), x if wrt == "x" else b, dY)[0]
        return g.float()

    out["t"] = measure_backward(
        f"bsr_spmm_t {label} dX", "bsr_spmm_t_",
        lambda: bsr_spmm_t(bcols, blocks, dY, ncols, work),
        lambda: bsr_spmm_t_plain(bcols, blocks, dY, ncols), lambda: autograd("x"),
        real * bs * bs * blocks.element_size() + nbytes(bcols) + rows_read * nf * 4
        + ncols * nf * 4, 2 * real * bs * bs * nf,
        library=(lambda f=bsr_transpose_lib(bcols, blocks, ncols, work): f(dY)),
        library_name="torch.sparse_bsr_tensor(A^T) @ dY", shape=tuple(P.shape), nf=nf, bs=bs,
        bwidth=bcols.shape[1], block_rows=bcols.shape[0], real_blocks=real,
        work_list_ms=work_ms, **extra)
    if dX_only:
        return out
    cols_read = min(int(torch.unique(bcols[valid]).numel()) * bs, ncols)
    lib, at = bsr_sampled_lib(bcols, bs, X, ncols)
    out["sddmm"] = measure_backward(
        f"bsr_sddmm {label} dB", "bsr_sddmm_",
        lambda: bsr_sddmm(bcols, dY, X, bs, work), lambda: bsr_sddmm_plain(bcols, dY, X, bs),
        lambda: autograd("b"),
        rows_read * nf * 4 + cols_read * nf * 4 + nbytes(bcols) + bcols.numel() * bs * bs * 4,
        2 * real * bs * bs * nf,
        library=lambda: lib(dY), library_name="torch.sparse.sampled_addmm (entry CSR)",
        library_at=at, shape=tuple(P.shape), nf=nf, bs=bs, bwidth=bcols.shape[1],
        block_rows=bcols.shape[0], real_blocks=real, work_list_ms=work_ms, **extra)
    return out


def train_config(smoke: bool = False):
    """Phase 15's model: ``TRAIN_ARCH`` at its published widths cut to
    ``TRAIN_LAYERS`` (or its smoke config), on the 'bsr' MoE lane."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_smoke_config(TRAIN_ARCH) if smoke else get_config(TRAIN_ARCH).replace(
        n_layers=TRAIN_LAYERS)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl="bsr"))


def train_routing(cfg, T: int, gen):
    """The containers of one training step's MoE layer at the config's
    widths: ``T`` tokens routed by a random f32 router."""
    import torch

    from repro_torch.models import moe as moe_mod

    E, K, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    router = torch.randn((D, E), generator=gen, device=TRAIN_DEVICE) / D ** 0.5
    x = torch.randn((T, D), generator=gen, device=TRAIN_DEVICE).to(cfg.activation_dtype)
    C = moe_mod._capacity(T, K, E, cfg.moe.capacity_factor)
    topw, tope, _ = moe_mod._route({"router": router}, x, cfg.moe)
    slot, t_s, w_s, keep = moe_mod._dispatch_indices(tope, topw, T, E, K, C)
    return (x, C, moe_mod.bsr_dispatch(slot, t_s, keep, T, E, C, x.dtype),
            moe_mod.bsr_combine(slot, tope, w_s, keep, T, E, C, x.dtype))


def step_combine(cfg):
    """The combine that phase 15b's first step routes: ``cfg``'s model,
    initialised from its seed, run forward on the step's first batch
    (``SyntheticTokens`` seed 0) with no graph, its MoE layer's
    ``bsr_combine`` kept. Its routing is far from a random router's: the
    overflow column (the dropped picks, block column ``E * C // 8``) holds
    thousands of blocks, where a random router leaves a few."""
    import torch

    from repro_torch.core import use_backend
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod

    model = build_model(cfg, device=TRAIN_DEVICE)
    params = model.init(0)
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=TRAIN_DEVICE)
    batch = data._put(data.batch_at(0))
    kept, combine = [], moe_mod.bsr_combine

    def keep(*args):
        kept.append(combine(*args))
        return kept[-1]

    moe_mod.bsr_combine = keep
    try:
        with torch.no_grad(), use_backend("cuda"):
            model.forward_train(params, batch["tokens"], batch)
    finally:
        moe_mod.bsr_combine = combine
    del model, params
    torch.cuda.empty_cache()
    return kept[0]


def train_kernel_cases(block):
    """Phase 15a's operands, made one case at a time in its order from its
    seeds: ``(label, P, X, dY, ncols, dX_only)`` for the MoE dispatch (dX
    only: its X is the tokens) and the MoE combine (X the experts' outputs,
    dH and dB) at the training step's shapes, routed by a random router;
    the combine of the step itself (:func:`step_combine`), its X's last row
    (the zero row the layer pads with) made non-zero so that the overflow
    column's dB is not zero; and the block matrix of phase 8 (bs 32) at
    ``BLOCK_NF`` columns."""
    import numpy as np
    import torch

    from repro_torch.core.convert import to_bsr

    cfg = train_config()
    T, E, D = TRAIN_BATCH * TRAIN_SEQ, cfg.moe.n_experts, cfg.d_model
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(5)
    x, C, Pd, Pc = train_routing(cfg, T, gen)
    yield ("MoE dispatch", Pd, x.float(),
           torch.randn((E * C, D), generator=gen, device=TRAIN_DEVICE), T, True)
    h = torch.randn((E * C + 1, D), generator=gen, device=TRAIN_DEVICE).to(x.dtype).float()
    h[-1] = 0
    yield ("MoE combine", Pc, h, torch.randn((T, D), generator=gen, device=TRAIN_DEVICE),
           E * C + 1, False)
    del x, h, Pd, Pc
    Ps = step_combine(cfg)
    hs = torch.randn((E * C + 1, D), generator=gen, device=TRAIN_DEVICE).to(Ps.blocks.dtype)
    yield ("MoE step combine", Ps, hs.float(),
           torch.randn((T, D), generator=gen, device=TRAIN_DEVICE), E * C + 1, False)
    del Ps, hs
    rng = np.random.default_rng(6)
    n = block.shape[0]
    Xb, dYb = (torch.from_numpy(rng.standard_normal((n, BLOCK_NF)).astype(np.float32))
               .to(TRAIN_DEVICE) for _ in range(2))
    yield "block bs32", to_bsr(block, device=TRAIN_DEVICE), Xb, dYb, n, False


def forward_line(label: str, P, X) -> dict:
    """Phase 15a's line for the forward ``bsr_spmm`` on a MoE case's
    operands (phase 12d's, with the bound at ``TF32X3_FLOPS`` as the
    backward's): its blocks, the rows of X its real blocks name, bcols and
    Y written whole."""
    import torch

    from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_path, bsr_spmm_plain

    bcols, blocks, bs, nf = P.bcols, P.blocks, P.bs, X.shape[1]
    valid = (bcols >= 0) & (bcols < -(-X.shape[0] // bs))
    real = int(valid.sum())
    read_rows = min(int(torch.unique(bcols[valid]).numel()) * bs, X.shape[0])
    moved = (real * bs * bs * blocks.element_size() + nbytes(bcols) + read_rows * nf * 4
             + bcols.shape[0] * bs * nf * 4)
    with torch.no_grad():
        return measure_model_kernel(
            f"bsr_spmm {label} forward", lambda: bsr_spmm(bcols, blocks, X),
            lambda: bsr_spmm_plain(bcols, blocks, X), moved, 2 * real * bs * bs * nf,
            "bsr_spmm_", library=bsr_forward_lib(P, X), rate=TF32X3_FLOPS,
            shape=tuple(P.shape), nf=nf, bs=bs, bwidth=bcols.shape[1],
            block_rows=bcols.shape[0], real_blocks=real, path=bsr_spmm_path(bs, nf))


def phase_train_kernels(results: dict, block) -> dict:
    """Phase 15a: the backward kernels at the training step's shapes (the
    dispatch's dX; the combine's dH and dB, randomly routed and as the
    step routes it) and on the block matrix of phase 8 (bs 32, 128
    columns), each by :func:`backward_pair`, and the forward at the two
    randomly routed MoE shapes by :func:`forward_line`."""
    import torch

    fwd, back = {}, {}
    for label, P, X, dY, ncols, dx_only in train_kernel_cases(block):
        if label in ("MoE dispatch", "MoE combine"):
            fwd[f"train_{label.split()[1]}"] = forward_line(f"MoE training {label.split()[1]}",
                                                            P, X)
        # the blocks of the MoE combine's last column: one for each dropped pick
        extra = ({"overflow_blocks": int((P.bcols == -(-ncols // P.bs) - 1).sum())}
                 if "combine" in label else {})
        back[label] = backward_pair(label, P, X, dY, ncols, dX_only=dx_only, **extra)
        del P, X, dY
    torch.cuda.empty_cache()
    disp, comb, blk = back["MoE dispatch"], back["MoE combine"], back["block bs32"]
    step = back["MoE step combine"]
    out = {"bsr_spmm_t": dict(disp["t"], train_combine=comb["t"], step_combine=step["t"],
                              block=blk["t"]),
           "bsr_sddmm": dict(comb["sddmm"], step_combine=step["sddmm"], block=blk["sddmm"]),
           "bsr_spmm": fwd}
    results["train_kernels"] = out
    return out


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in f64."""
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def train_grads(model, params, batch, backend: str) -> tuple:
    """The loss and the gradients of the router, one expert stack and the
    embedding (only those: the others are not asked for, which keeps the
    card under its memory) on ``backend``, and the router's gradient from
    the cross entropy alone (the combine's gates; the aux loss has its own
    path)."""
    import torch

    from repro_torch.core import use_backend
    from repro_torch.models.model import softmax_xent

    ffn = params["groups"][0]["ffn"]
    leaves = {"router": ffn["router"], "w_gate": ffn["experts"]["w_gate"],
              "embed": params["embed"]}
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        with use_backend(backend):
            logits, aux = model.forward_train(params, batch["tokens"], batch)
            ce = softmax_xent(logits, batch["targets"])
            loss = ce + 0.01 * aux
            del logits
            g = torch.autograd.grad(loss, list(leaves.values()), retain_graph=True)
            g_ce = torch.autograd.grad(ce, leaves["router"])[0]
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return loss.detach(), dict(zip(leaves, g)), g_ce


def train_full_width(results: dict, smi: str) -> dict:
    """Phase 15b: ``TRAIN_ARCH`` at full width, one layer, trained on the
    'bsr' lane under ``use_backend("cuda")`` (bsr_spmm forward, bsr_spmm_t
    and bsr_sddmm backward), f32 weights and AdamW state. Step 0's
    gradients of those leaves twice on cuda (equal bits) and once on
    plain (within ``TRAIN_GRAD_REL_L2``), the router's gradient from the
    cross entropy non-zero; then ``TRAIN_STEPS`` steps of
    ``make_train_step``, counted as the train path. Returns its launches."""
    import warnings

    import torch

    from repro_torch.core import use_backend
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed.sharding import param_paths
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from repro_torch.train.trainer import deterministic

    cfg = train_config()
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases left
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=TRAIN_DEVICE)
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in param_paths(params))
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=TRAIN_DEVICE)
    batch0 = data._put(data.batch_at(0))
    with warnings.catch_warnings(record=True) as caught, deterministic(torch.device(TRAIN_DEVICE)):
        warnings.simplefilter("always")
        loss_a, g_a, g_ce = train_grads(model, params, batch0, "cuda")
        loss_b, g_b, _ = train_grads(model, params, batch0, "cuda")
        check(bool(torch.equal(loss_a, loss_b)) and all(torch.equal(g_a[k], g_b[k]) for k in g_a),
              "train: two bsr/cuda gradient passes from one state differ in bits")
        del g_b
        check(bool(torch.isfinite(loss_a)) and all(bool(torch.isfinite(g).all())
                                                   for g in g_a.values()),
              "train: non-finite loss or gradient at step 0")
        check(float(g_ce.abs().max()) > 0, "train: the router's gradient from the cross "
              "entropy is zero (the combine's gates carry none)")
        loss_p, g_p, _ = train_grads(model, params, batch0, "plain")
        grad_err = {k: rel_l2(g_a[k], g_p[k]) for k in g_a}
        grad_max = {k: float((g_a[k] - g_p[k]).abs().max() / g_p[k].abs().max()) for k in g_a}
        check(all(v <= TRAIN_GRAD_REL_L2 for v in grad_err.values()),
              f"train: bsr/cuda gradients against bsr/plain beyond rel L2 "
              f"{TRAIN_GRAD_REL_L2}: {grad_err}")
        loss_err = abs(float(loss_a) - float(loss_p)) / abs(float(loss_p))
        del g_a, g_p, g_ce
        torch.cuda.empty_cache()

        opt = adamw.init(params)
        step_fn = make_train_step(model, adamw.AdamWConfig(total_steps=TRAIN_STEPS))
        hist = []

        def steps():
            nonlocal params, opt
            with use_backend("cuda"):
                for i in range(TRAIN_STEPS):
                    batch = data._put(data.batch_at(i))
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    params, opt, m = step_fn(params, opt, batch)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t1) * 1e3
                    m = {k: float(v) for k, v in m.items()}
                    hist.append(dict(m, step=i, ms=ms))
                    phase(f"train step {i}", loss=m["loss"], grad_norm=m["grad_norm"],
                          lr=m["lr"], step_ms=ms)

        _, launches, _ = counted("train", steps)
        split = step_split(model, params, opt, data._put(data.batch_at(TRAIN_STEPS)))
    notes = sorted({str(w.message)[:160] for w in caught})
    for note in notes:
        print(f"  [train warning] {note}", flush=True)
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist),
          "train: a non-finite loss or grad_norm")
    check(hist[0]["loss"] == float(loss_a), "train: step 0's loss is not the gradient pass's")
    peak = torch.cuda.max_memory_allocated()
    ms_sorted = sorted(h["ms"] for h in hist)
    p50 = ms_sorted[len(ms_sorted) // 2]
    for name in ("bsr_spmm", "bsr_spmm_t", "bsr_sddmm"):
        check(launches[name] > 0, f"{name} was not launched on the train path")
    del params, opt, model
    torch.cuda.empty_cache()
    results["train"] = phase(
        "train full width", smi=repr(smi), arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        vocab=cfg.vocab, dispatch_impl=cfg.moe.dispatch_impl, remat=cfg.remat,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
        params=n_params, allocated_before_gb=before_gb, init_s=init_s, steps=TRAIN_STEPS,
        losses=json.dumps([h["loss"] for h in hist]),
        grad_norms=json.dumps([h["grad_norm"] for h in hist]),
        step_ms=json.dumps([round(h["ms"], 3) for h in hist]), step_ms_p50=p50,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3), peak_memory_gb=peak / 1e9,
        launches_per_step=json.dumps({k: launches[k] / TRAIN_STEPS for k in
                                      ("bsr_spmm", "bsr_spmm_t", "bsr_sddmm")}),
        grad_rel_l2_vs_plain=json.dumps(grad_err),
        grad_max_err_of_max_vs_plain=json.dumps(grad_max),
        grad_tolerance_rel_l2=TRAIN_GRAD_REL_L2, loss_rel_err_vs_plain=loss_err,
        split_ms=json.dumps(split),
        grads_repeat_bits=True, deterministic_warnings=len(notes))
    return launches


def step_split(model, params, opt, batch) -> dict:
    """One more step cut in two, each timed on the host clock between
    synchronizes: the forward and backward (``torch.autograd.grad`` over
    every leaf, on ``use_backend("cuda")``) and ``adamw.update``."""
    import torch

    from repro_torch.core import use_backend
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves as tree_leaves
    from repro_torch.tree import rebuild

    leaves = tree_leaves(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in leaves:
        t.requires_grad_(True)
    with use_backend("cuda"):
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw.update(adamw.AdamWConfig(total_steps=TRAIN_STEPS), rebuild(params, grads), opt,
                 params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"forward_backward": round((t1 - t0) * 1e3, 3),
            "adamw_update": round((t2 - t1) * 1e3, 3)}


def train_cli(results: dict) -> None:
    """Phase 15c at smoke size on the card: the launcher's CLI (12 steps,
    checkpoints every 4, its step captured); the trainer with the CLI's
    settings, captured, run without a failure and with one at step 10
    (restored in place from step 8's checkpoint, then replayed): losses at
    steps 8, 9 and 11 equal in bits, the clean captured run's losses the
    clean eager run's (``graph=False``) in bits, and the CLI's final loss
    the clean run's; then ``examples/train_lm_torch.py --quick
    --inject-failure``."""
    import shutil
    import tempfile

    from repro_torch.core import use_backend
    from repro_torch.kernels.bsr_spmm import bsr_sddmm
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    try:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke",
             "--dispatch-impl", "bsr", "--steps", str(TRAIN_CLI_STEPS), "--ckpt-dir",
             os.path.join(tmp, "cli"), "--ckpt-every", "4", "--device", TRAIN_DEVICE],
            env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(r.returncode == 0, f"train CLI failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        cli_final = [ln for ln in r.stdout.splitlines() if ln.startswith("final loss")]
        check(len(cli_final) == 1, f"train CLI printed no final loss:\n{r.stdout[-2000:]}")
        check("graph=on" in r.stdout and "train graph:" in r.stdout,
              f"train CLI did not train through its captured step:\n{r.stdout[-2000:]}")
        print(f"  [train cli] {cli_final[0]}", flush=True)

        def run(name, fail_at=None, graph=None):
            tcfg = TrainerConfig(n_steps=TRAIN_CLI_STEPS, ckpt_dir=os.path.join(tmp, name),
                                 checkpoint_every=4, log_every=100)
            tr = Trainer(train_config(smoke=True), tcfg,
                         adamw.AdamWConfig(total_steps=TRAIN_CLI_STEPS), device=TRAIN_DEVICE,
                         graph=graph)
            with use_backend("cuda"):
                hist = tr.train(fail_at=fail_at)
            check(tr.graph is (graph is not False) and (tr.captured is not None) is tr.graph,
                  f"train restart: the {name} run's step is not captured as asked ({graph})")
            return hist

        before = bsr_sddmm.launches
        h0 = run("eager", graph=False)
        h1, h2 = run("clean"), run("failed", fail_at=TRAIN_FAIL_AT)
        check(bsr_sddmm.launches > before, "train restart: the backward kernels did not run")
        l1 = [h["loss"] for h in h1]
        check(l1 == [h["loss"] for h in h0],
              f"train restart: the captured run's losses {l1} are not the eager run's "
              f"{[h['loss'] for h in h0]}")
        l2 = {}
        for h in h2:
            l2[h["step"]] = h["loss"]
        diffs = {s: abs(l1[s] - l2[s]) for s in (8, 9, 11)}
        check(all(d == 0 for d in diffs.values()),
              f"train restart: losses after the failure differ from the clean run's: {diffs}")
        check([h["step"] for h in h2].count(8) == 2, "train restart: step 8 was not replayed")
        check(f"final loss: {l1[-1]:.4f}" in cli_final[0],
              f"train CLI's final loss is not the clean run's {l1[-1]:.4f}")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "train_lm_torch.py"),
                            "--quick", "--inject-failure", "--ckpt-dir",
                            os.path.join(tmp, "example"), "--device", TRAIN_DEVICE],
                           env=env, capture_output=True, text=True, timeout=600)
        example_s = time.perf_counter() - t0
        check(r.returncode == 0, f"train example failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        summary = r.stdout.strip().splitlines()[-1]
        print(f"  [train example] {summary}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["train_restart"] = phase(
        "train cli and restart", arch=train_config(smoke=True).name, steps=TRAIN_CLI_STEPS,
        fail_at=TRAIN_FAIL_AT, loss_diffs=json.dumps(diffs), captured_equals_eager=True,
        cli_s=cli_s,
        cli_final=repr(cli_final[0]), example_s=example_s, example=repr(summary))


def train_captured(results: dict, smi: str) -> dict:
    """Phase 15d: phase 15b's model, batch and seed through the ``Trainer``
    on the card, ``graph=None``: step 0 is the warm-up of its
    ``CapturedTrainStep`` and the capture, every later step a replay of
    the graph (the reference's ``jax.jit(step_fn, donate_argnums=(0,
    1))``). Each step's loss and grad_norm equal 15b's eager steps' in
    bits. Counted as the ``train_graph`` path: the warm-up's and the
    capture's launches (a replay runs in the graph, uncounted); the
    graph's launches a step are the capture's. 15b's state is freed
    first. Returns the path's launches."""
    import torch

    from repro_torch.core import use_backend
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    base = results["train"]
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    cfg = train_config()
    t0 = time.perf_counter()
    tr = Trainer(cfg, TrainerConfig(n_steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                                    seq_len=TRAIN_SEQ, seed=0, log_every=100),
                 adamw.AdamWConfig(total_steps=TRAIN_STEPS), device=TRAIN_DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(tr.graph, "train graph: the Trainer on one card does not capture its step")

    def steps():
        with use_backend("cuda"):
            return tr.train()

    hist, launches, _ = counted("train_graph", steps)
    peak = torch.cuda.max_memory_allocated()
    reserved, peak_reserved = torch.cuda.memory_reserved(), torch.cuda.max_memory_reserved()
    st = tr.captured.stats()
    ms = [h["time_s"] * 1e3 for h in hist]
    for h, m in zip(hist, ms):
        phase(f"train graph step {h['step']}", loss=h["loss"], grad_norm=h["grad_norm"],
              lr=h["lr"], step_ms=m,
              note="warm-up and capture" if h["step"] == 0 else "replay")
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    want_l, want_g = json.loads(base["losses"]), json.loads(base["grad_norms"])
    check(losses == want_l and gnorms == want_g,
          f"train graph: losses {losses} / grad_norms {gnorms} are not the eager step's bits "
          f"{want_l} / {want_g}")
    for name in ("bsr_spmm", "bsr_spmm_t", "bsr_sddmm"):
        check(launches[name] > 0 and st["launches"].get(name, 0) > 0,
              f"{name} was not launched on the captured train path")
    replays = sorted(ms[1:])
    del tr, hist
    torch.cuda.empty_cache()
    results["train_graph"] = phase(
        "train captured", smi=repr(smi), arch=cfg.name, layers=cfg.n_layers,
        dispatch_impl=cfg.moe.dispatch_impl, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, allocated_before_gb=before_gb, init_s=init_s,
        losses=json.dumps(losses), grad_norms=json.dumps(gnorms), bits_equal_eager=True,
        step_ms=json.dumps([round(m, 3) for m in ms]), warm_up_and_capture_ms=ms[0],
        replay_ms_p50=replays[len(replays) // 2], eager_step_ms_p50=base["step_ms_p50"],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (replays[len(replays) // 2] / 1e3),
        capture_s=round(st["capture_s"], 4), instantiate_s=round(st["instantiate_s"], 4),
        nodes=st["nodes"], launches_a_replay=json.dumps(st["launches"]),
        launches_counted=json.dumps({k: launches[k] for k in
                                     ("bsr_spmm", "bsr_spmm_t", "bsr_sddmm")}),
        peak_allocated_gb=peak / 1e9, reserved_gb=reserved / 1e9,
        peak_reserved_gb=peak_reserved / 1e9, eager_peak_memory_gb=base["peak_memory_gb"])
    return launches


def roofline_cells():
    """Phase 16a's cells: each LM cell the smoke runs, at that phase's own
    config (its cut depth) and shape, with the result key and field of its
    measured p50 (phases 12-14: a decode step of batch 4 against a cache of
    prompt + gen; phase 15: a train step of batch 8 x seq 128)."""
    from repro_torch.configs import ShapeCell, get_config

    cache = MODEL_SERVE["prompt_len"] + MODEL_SERVE["gen"]
    out = []
    for n, cell in MODEL_CELLS.items():
        cfg = get_config(cell.arch).replace(n_layers=cell.layers)
        out.append((n, cell.key, "ms_token_p50", cfg,
                    ShapeCell("decode", cache, MODEL_SERVE["batch"], "decode")))
    out.append((15, "train", "step_ms_p50", train_config(),
                ShapeCell("train", TRAIN_SEQ, TRAIN_BATCH, "train")))
    return out


def phase_roofline(results: dict, smi: str) -> None:
    """Phase 16a: the analytic bound (``repro_torch.roofline``: the
    reference's per-device model over the card's peaks, chips=1) of each LM
    cell phases 12-15 ran, against the p50 those phases measured (no new
    timing). A decode reads every parameter in bf16, as the reference's
    model counts it."""
    from repro_torch.roofline import analysis, analytic

    rows = {}
    for n, key, field, cfg, shape in roofline_cells():
        acost = analytic.cost(cfg, shape, 1)
        rl = analysis.analyze(analysis.Counts(collectives=None), analytic=acost)
        p50 = results[key][field]
        rows[key] = phase(
            f"roofline {n} {key}", smi=repr(smi), arch=cfg.name, layers=cfg.n_layers,
            kind=shape.kind, batch=shape.global_batch, seq=shape.seq_len,
            flops=acost.flops_per_device, hbm_bytes=acost.hbm_bytes_per_device,
            t_compute_ms=rl.t_compute * 1e3, t_memory_ms=rl.t_memory * 1e3,
            bottleneck=rl.bottleneck, t_bound_ms=rl.t_bound * 1e3, p50_ms=p50,
            p50_over_bound=p50 / (rl.t_bound * 1e3))
    results["roofline"] = rows


def phase_allreduce(results: dict, smi: str) -> None:
    """Phase 16b: ``CompressedAllReduce`` on ``PartMesh.on("cuda",
    parts=4)``, chunk 256, 2^28 f32 a part: the mean within rel 0.05 of
    the true mean, 0 < max|err| < 0.05 max|v|, equal bits over two calls,
    and at 2^20 the card's mean and residual the host's bit for bit; ms by
    events, the bytes it must move (four vectors and residuals read, the
    mean and four residuals written) against 3.35 TB/s, peak memory."""
    import torch

    from repro_torch.core import PartMesh
    from repro_torch.distributed.compression import CompressedAllReduce

    P, n = ALLREDUCE_PARTS, ALLREDUCE_N
    car = CompressedAllReduce(PartMesh.on("cuda", parts=P), chunk=ALLREDUCE_CHUNK)
    check(car.padded_len(n) == n, "allreduce: the vector length needs no padding")
    gen = torch.Generator(device="cuda").manual_seed(0)

    # the card against the host at a size the host checks quickly
    m = ALLREDUCE_CHECK_N
    small = torch.randn((P, m), generator=gen, device="cuda")
    host = CompressedAllReduce(PartMesh.on("cpu", parts=P), chunk=ALLREDUCE_CHUNK)
    m_h, e_h = host(small.cpu(), host.init_error(m))
    m_d, e_d = car(small, car.init_error(m))
    dm = float((m_d.cpu() - m_h).abs().max())
    de = float((e_d.cpu() - e_h).abs().max())
    check(torch.equal(m_d.cpu(), m_h) and torch.equal(e_d.cpu(), e_h),
          f"allreduce: the card's mean and residual differ from the host's by {dm}, {de}")
    del small, m_d, e_d

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vec = torch.randn((P, n), generator=gen, device="cuda")
    err0 = car.init_error(n)
    mean, err = car(vec, err0)
    torch.cuda.synchronize()
    true = vec.mean(dim=0)
    rel = float((mean - true).abs().max() / true.abs().max())
    err_max, v_max = float(err.abs().max()), float(vec.abs().max())
    mean2, err2 = car(vec, err0)
    same = bool(torch.equal(mean, mean2) and torch.equal(err, err2))
    del mean2, err2, true
    check(rel < ALLREDUCE_REL, f"allreduce: mean rel {rel} >= {ALLREDUCE_REL}")
    check(0 < err_max < ALLREDUCE_ERR_OF_MAX * v_max,
          f"allreduce: max|err| {err_max} outside (0, {ALLREDUCE_ERR_OF_MAX} max|v| = "
          f"{ALLREDUCE_ERR_OF_MAX * v_max})")
    check(same, "allreduce: two calls differ in bits")
    del mean, err
    ms = cuda_ms(lambda: car(vec, err0), reps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    moved = 4 * n * (2 * P + 1 + P)
    results["allreduce"] = phase(
        "allreduce int8", smi=repr(smi), parts=P, n_per_part=n, chunk=ALLREDUCE_CHUNK,
        reduced="2^28 f32 a part, a fifth of llama3.2-1b's gradient (the card's 80 GB)",
        mean_rel_err=rel, max_err=err_max, max_v=v_max, repeat_bits=same,
        card_vs_host_mean=dm, card_vs_host_err=de, ms=ms, bytes_moved=moved,
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, wire_bytes_per_part=2 * n,
        peak_memory_gb=peak / 1e9)
    del vec, err0
    torch.cuda.empty_cache()


def phase_dryrun(results: dict) -> None:
    """Phase 16c: ``repro_torch.launch.dryrun.build_cell`` on the ``meta``
    device for two cells on the single-pod mesh, each with a collective
    term (host work on ``meta`` over the fake group: nothing is sent)."""
    from repro_torch.launch.dryrun import build_cell

    rows = {}
    for arch, shape in DRYRUN_CELLS:
        out = build_cell(arch, shape, multi_pod=False)
        check(out["status"] == "OK", f"dryrun {arch} {shape}: {out['status']}")
        check((out["roofline"]["t_collective_s"] or 0) > 0,
              f"dryrun {arch} {shape}: no collective term")
        r = out["roofline"]
        rows[f"{arch}|{shape}"] = phase(
            f"dryrun {arch} {shape}", status=out["status"], chips=out["chips"],
            bottleneck=r["bottleneck"], t_compute_s=r["t_compute_s"],
            t_memory_s=r["t_memory_s"], t_collective_s=r["t_collective_s"],
            collective_bytes_by_kind=json.dumps(r["collective_bytes_by_kind"]),
            collective_counts=json.dumps(r["collective_counts"]),
            counted_over_analytic_flops=out["counted_over_analytic_flops"],
            argument_gb_per_device=out["memory_analysis"]["argument_size_in_bytes"] / 1e9,
            trace_s=out["lower_s"], traced=json.dumps(out["traced"]))
    results["dryrun"] = rows


def sharded_trainer(mesh, graph):
    """Phase 15b's model, batch and seed as a ``Trainer`` on ``mesh`` for
    ``SHARDED_STEPS`` steps; its state's every parameter and moment a
    DTensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    tr = Trainer(train_config(), TrainerConfig(n_steps=SHARDED_STEPS, global_batch=TRAIN_BATCH,
                                               seq_len=TRAIN_SEQ, seed=0, log_every=100),
                 adamw.AdamWConfig(total_steps=TRAIN_STEPS), mesh=mesh, graph=graph)
    params, opt = tr.state
    check(all(isinstance(t, DTensor) for t in leaves((params, opt.m, opt.v))),
          "train sharded: a parameter or moment is not a DTensor")
    return tr


def sharded_bits(label: str, hist, base) -> tuple:
    """``hist``'s losses and grad_norms, checked equal in bits to 15b's
    first steps."""
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    want_l = json.loads(base["losses"])[:SHARDED_STEPS]
    want_g = json.loads(base["grad_norms"])[:SHARDED_STEPS]
    check(losses == want_l and gnorms == want_g,
          f"{label}: losses {losses} / grad_norms {gnorms} are not the unsharded step's bits "
          f"{want_l} / {want_g}")
    return losses, gnorms


def phase_train_sharded(results: dict, smi: str) -> dict:
    """Phase 17: the ``Trainer`` on ``launch.train``'s ``--mesh local``
    ``DeviceMesh`` (NCCL; a lone process is a world of one, (1, 1) over
    ``("data", "model")``), phase 15b's model, batch and seed, on the 'bsr'
    lane under ``use_backend("cuda")``, every leaf of its state a DTensor:
    first eagerly (``graph=False``, uncounted: the comparison), then with
    its step captured in one CUDA graph (the default on a CUDA mesh of one
    rank: the reference's jitted step with its shardings): step 0 the
    warm-up (DTensor's first sharding propagation) and the capture, every
    later step a replay. Each run's losses and grad_norms equal 15b's first
    steps in bits; the captured run is counted as the ``train_sharded``
    path (``bsr_spmm``, ``bsr_spmm_t`` and ``bsr_sddmm`` launched from the
    MoE's ``local_map`` region at the warm-up and the capture). 15d's graph
    and state are gone before it. Then the smoke-size round trip
    (:func:`sharded_round_trip`). The process group is torn down at the
    end. Returns the path's launches."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.core import use_backend
    from repro_torch.launch.train import train_mesh
    from repro_torch.tree import leaves

    base, captured_base = results["train"], results["train_graph"]
    gc.collect()
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    mesh = train_mesh("local", "cuda")
    try:
        torch.cuda.reset_peak_memory_stats()
        tr = sharded_trainer(mesh, graph=False)
        with use_backend("cuda"):
            eager_hist = tr.train()
        sharded_bits("train sharded eager", eager_hist, base)
        eager_ms = [h["time_s"] * 1e3 for h in eager_hist]
        eager_peak = torch.cuda.max_memory_allocated()
        del tr
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = sharded_trainer(mesh, graph=None)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(tr.graph, "train sharded: the Trainer on a (1, 1) CUDA mesh does not capture "
                        "its step")
        placements = sorted({str(t.placements) for t in leaves(tr.state[0])})

        def steps():
            with use_backend("cuda"):
                return tr.train()

        hist, launches, _ = counted("train_sharded", steps)
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        losses, gnorms = sharded_bits("train sharded captured", hist, base)
        st = tr.captured.stats()
        for name in ("bsr_spmm", "bsr_spmm_t", "bsr_sddmm"):
            check(launches[name] > 0 and st["launches"].get(name, 0) > 0,
                  f"{name} was not launched on the captured sharded train path")
        ms = [h["time_s"] * 1e3 for h in hist]
        for h, m in zip(hist, ms):
            phase(f"train sharded step {h['step']}", loss=h["loss"], grad_norm=h["grad_norm"],
                  step_ms=m, eager_step_ms=eager_ms[h["step"]],
                  note="warm-up and capture" if h["step"] == 0 else "replay")
        del tr, hist
        gc.collect()
        torch.cuda.empty_cache()
        rt = sharded_round_trip(mesh)
    finally:
        dist.destroy_process_group()
    replays = sorted(ms[1:])
    eager_warm = sorted(eager_ms[1:])
    results["train_sharded"] = phase(
        "train sharded", smi=repr(smi), mesh=repr(mesh), arch=base["arch"],
        layers=base["layers"], dispatch_impl=base["dispatch_impl"], batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=SHARDED_STEPS, placements=json.dumps(placements),
        allocated_before_gb=before_gb, init_s=init_s, losses=json.dumps(losses),
        grad_norms=json.dumps(gnorms), bits_equal_unsharded=True, graph=True,
        step_ms=json.dumps([round(m, 3) for m in ms]), warm_up_and_capture_ms=ms[0],
        replay_ms_p50=replays[len(replays) // 2],
        one_device_replay_ms_p50=captured_base["replay_ms_p50"],
        eager_step_ms=json.dumps([round(m, 3) for m in eager_ms]),
        eager_step_ms_warm_p50=eager_warm[len(eager_warm) // 2],
        unsharded_step_ms_p50=base["step_ms_p50"],
        capture_s=round(st["capture_s"], 4), instantiate_s=round(st["instantiate_s"], 4),
        nodes=st["nodes"], launches_a_replay=json.dumps(st["launches"]),
        launches=json.dumps({k: launches[k] for k in ("bsr_spmm", "bsr_spmm_t", "bsr_sddmm")}),
        peak_allocated_gb=peak / 1e9, peak_reserved_gb=peak_reserved / 1e9,
        eager_peak_allocated_gb=eager_peak / 1e9,
        one_device_peak_reserved_gb=captured_base["peak_reserved_gb"],
        unsharded_peak_memory_gb=base["peak_memory_gb"], **rt)
    return launches


def sharded_round_trip(mesh) -> dict:
    """A ``Trainer`` at smoke size on ``mesh``, its step captured, trains
    two steps and saves (every rank gathers, rank 0 writes); the live
    state is then zeroed and ``Trainer.restore`` writes the checkpoint back
    into it: every leaf's local ``data_ptr`` kept, its bits and placements
    the saved state's."""
    import shutil
    import tempfile

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.core import use_backend
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        t0 = time.perf_counter()
        tr = Trainer(train_config(smoke=True),
                     TrainerConfig(n_steps=2, global_batch=TRAIN_BATCH, seq_len=32,
                                   ckpt_dir=tmp, checkpoint_every=100, log_every=100),
                     adamw.AdamWConfig(total_steps=2), mesh=mesh)
        with use_backend("cuda"):
            tr.train()
        check(tr.graph and tr.captured is not None,
              "train sharded: the smoke-size Trainer on the mesh did not capture its step")
        live = leaves(tr.state)
        saved = [local(t).clone() for t in live]
        ptrs = [local(t).data_ptr() for t in live]
        placed = [str(getattr(t, "placements", None)) for t in live]
        with torch.no_grad():
            for t in live:
                local(t).zero_()
        (params, opt), step = tr.restore()
        back = leaves((params, opt))
        same = (len(back) == len(saved)
                and [local(t).data_ptr() for t in back] == ptrs
                and [str(getattr(t, "placements", None)) for t in back] == placed
                and all(torch.equal(local(t), w) for t, w in zip(back, saved)))
        check(step == 2 and same, f"train sharded: restore gave other bits, placements or "
                                  f"tensors (step {step})")
        return {"round_trip_leaves": len(back), "round_trip_equal": same,
                "round_trip_in_place": True, "round_trip_captured": True,
                "round_trip_s": round(time.perf_counter() - t0, 2)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_train(results: dict, smi: str, block) -> tuple:
    """Phase 15: (a) the backward kernels at the training shapes, (b) the
    full-width training step, (c) the CLI and the trainer's restart at
    smoke size, (d) the full-width step captured. Returns the train and
    captured train paths' launches and (a)'s kernel lines."""
    kern = phase_train_kernels(results, block)
    launches = train_full_width(results, smi)
    train_cli(results)
    launches_graph = train_captured(results, smi)
    return launches, launches_graph, kern


def main() -> int:
    # phase 15 trains under PyTorch's deterministic mode, whose cuBLAS calls
    # repeat their bits with this workspace setting, read at cuBLAS's start
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs a GPU",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.apps.hpcg import run_hpcg
    from repro_torch.core import ExecutionPolicy, as_operator
    from repro_torch.core import matrices as M
    from repro_torch.kernels._build import library
    from repro_torch.solvers import cg

    t_start = time.perf_counter()
    results = {}
    seconds = {}
    t0 = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        seconds[name] = round(time.perf_counter() - t0, 1)
        phase(f"phase {name}", seconds=seconds[name])
        t0 = time.perf_counter()

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    results["device"] = phase(
        "device", smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        build_s=round(lib.seconds, 2))
    torch.backends.cuda.matmul.allow_tf32 = False  # the cuSPARSE yardstick in full f32
    lap("1 build")

    # ---------------------------------------------------------------- 2
    block = M.block_random(BLOCK_MATRIX[0], BLOCK_MATRIX[1], block_density=BLOCK_MATRIX[2],
                           seed=0)
    kern, launches_scoo = phase_kernels(results, block)
    lap("2 kernels")

    # ---------------------------------------------------------------- 3
    r16 = run_hpcg(16, 16, 16, iters=50, timed=False, candidates=CANDIDATES, device="cuda",
                   conv_eager=CONV_SOLVES)
    check(r16.valid and r16.bitwise, f"HPCG 16^3: valid={r16.valid} bitwise={r16.bitwise}")
    results["hpcg16"] = phase("hpcg 16^3", valid=r16.valid, bitwise=r16.bitwise,
                              pcg_iters=r16.pcg_iters, rel_res=r16.rel_res,
                              levels=repr(r16.mg_levels))
    results["hpcg16"]["conv"] = conv_lines(r16, "hpcg 16^3", equal=CONV_SOLVES)
    lap("3 hpcg16")

    # ---------------------------------------------------------------- 4
    g = GRID
    res, launches_hpcg, races = counted(f"hpcg {g}^3", lambda: run_hpcg(
        g, g, g, iters=50, depth=4, reps=3, eager_reps=1, candidates=CANDIDATES,
        device="cuda", conv_eager=("opt",)))
    for r in races:
        if len(r.table) > 1:  # the validation races time csr/plain alone
            print_race(f"hpcg {g}^3", r)
            check_bsr_guarded(f"HPCG {g}^3 race at {tuple(r.matrix.shape)}", r.skipped)
    check_hpcg(res, f"HPCG {g}^3")
    results["hpcg"] = phase(
        f"hpcg {g}^3", valid=res.valid, bitwise=res.bitwise, rel_err=res.rel_err,
        pcg_iters=res.pcg_iters, rel_res=res.rel_res,
        converged=res.rel_res <= 1e-6, chosen=res.chosen, levels=repr(res.mg_levels),
        t_ref_s=res.ref_time_s, t_opt_s=res.opt_time_s,
        launches=json.dumps(launches_hpcg), table=json.dumps(res.table),
        skipped=json.dumps(res.skipped))
    results["hpcg"]["graph"] = graph_lines(res, f"hpcg {g}^3")
    results["hpcg"]["conv"] = conv_lines(res, f"hpcg {g}^3", equal=("opt",))
    lap("4 hpcg104")

    # ---------------------------------------------------------------- 5
    # the column-limited operator: tiled plans, tuned over the cuda kernels
    A_sp = M.fdm27(g, g, g)
    n = A_sp.shape[0]
    b = torch.from_numpy((A_sp @ np.ones(n)).astype(np.float32)).cuda()
    tpol = ExecutionPolicy(max_resident_cols=COLUMN_LIMIT)
    A_tiled = as_operator(A_sp, "csr", policy=tpol, device="cuda")

    def tiled_cg():
        tuned = A_tiled.tune(candidates=[("dia", "cuda"), ("csr", "cuda"),
                                         ("sell", "cuda"), ("csr", "plain")])
        return tuned, cg(tuned, b, tol=1e-6, maxiter=50)

    (tuned, info), launches_tiled, _ = counted(f"cg {g}^3 column-limited", tiled_cg)
    ref = cg(as_operator(A_sp, "csr", device="cuda").using("plain"), b, tol=1e-6, maxiter=50)
    rel = float(torch.linalg.vector_norm(info.x - ref.x) / torch.linalg.vector_norm(ref.x))
    check(rel < 1e-3, f"column-limited CG disagrees with csr/plain CG: rel {rel}")
    results["tiled_cg"] = phase(
        f"cg {g}^3 column-limited", max_resident_cols=tpol.max_resident_cols,
        chosen=f"{tuned.format}/{tuned.policy.backends[0]}", iters=info.iters,
        rel_res=float(info.rel_res), rel_err=rel, launches=json.dumps(launches_tiled))
    del A_tiled, tuned, info, ref, b
    lap("5 tiled_cg")

    # ---------------------------------------------------------------- 6
    _, launches_tuner, _ = counted("tuner 10^6", lambda: phase_tuner(results))
    lap("6 tuner")

    # ---------------------------------------------------------------- 7
    _, launches_corpus, _ = counted("corpus", lambda: phase_corpus(results))
    check(launches_corpus["coo_spmv"] > 0, "coo_spmv was not launched on the corpus path")
    lap("7 corpus")

    # ---------------------------------------------------------------- 8
    _, launches_block, _ = counted("block", lambda: phase_block(results, block))
    lap("8 block")

    # ---------------------------------------------------------------- 9
    resp, launches_pred, _ = counted(f"hpcg {g}^3 predict", lambda: run_hpcg(
        g, g, g, iters=50, depth=4, tune_mode="predict", device="cuda", reps=1,
        eager_reps=1))
    check(resp.valid and resp.bitwise,
          f"HPCG {g}^3 predict: valid={resp.valid} bitwise={resp.bitwise}")
    results["hpcg_predict"] = phase(
        f"hpcg {g}^3 predict", valid=resp.valid, bitwise=resp.bitwise, rel_err=resp.rel_err,
        pcg_iters=resp.pcg_iters, rel_res=resp.rel_res, chosen=resp.chosen,
        levels=repr(resp.mg_levels), t_ref_s=resp.ref_time_s, t_opt_s=resp.opt_time_s,
        launches=json.dumps(launches_pred))
    results["hpcg_predict"]["graph"] = graph_lines(resp, f"hpcg {g}^3 predict")
    results["hpcg_predict"]["conv"] = conv_lines(resp, f"hpcg {g}^3 predict")
    lap("9 hpcg104 predict")

    # --------------------------------------------------------------- 10
    launches_serve = phase_serve(results, smi)
    lap("10 serve")

    # --------------------------------------------------------------- 11
    launches_dist, launches_pairs = phase_dist(results)
    torch.cuda.empty_cache()
    lap("11 dist")

    # ---------------------------------------------------------- 12-14
    launches_model = {}
    for n, cell in MODEL_CELLS.items():
        launches_cell, kern_model = phase_model(results, smi, cell)
        coo_line = kern_model.pop("moe_combine_unsorted", None)
        if coo_line is not None:
            kern["coo_spmv"]["moe_combine_unsorted"] = coo_line
        kern["bsr_spmm"].update(kern_model)
        for name, count in launches_cell.items():
            if name != "dia_spmv_split":
                launches_model[name] = launches_model.get(name, 0) + count
        lap(f"{n} {cell.key}")

    # --------------------------------------------------------------- 15
    launches_train, launches_train_graph, kern_train = phase_train(results, smi, block)
    del block
    kern["bsr_spmm"].update(kern_train.pop("bsr_spmm"))
    kern.update(kern_train)
    lap("15 train")

    # --------------------------------------------------------------- 16
    phase_roofline(results, smi)
    phase_allreduce(results, smi)
    phase_dryrun(results)
    lap("16 roofline")

    # --------------------------------------------------------------- 17
    launches_sharded = phase_train_sharded(results, smi)
    lap("17 train sharded")

    by_path = {"hpcg": launches_hpcg, "tiled_cg": launches_tiled,
               "tuner": launches_tuner, "corpus": launches_corpus, "scoo": launches_scoo,
               "block": launches_block, "hpcg_predict": launches_pred,
               "serve": launches_serve, "dist": launches_dist, "dist_pairs": launches_pairs,
               "model": launches_model, "train": launches_train,
               "train_graph": launches_train_graph, "train_sharded": launches_sharded}
    for name, paths in REQUIRED_ON.items():
        for path in paths:
            check(by_path[path][name] > 0, f"{name} was not launched on the {path} path")

    line = {"kernels": []}
    for name, (src, replaces) in KERNEL_SOURCES.items():
        k = kern[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": by_path[REQUIRED_ON[name][0]][name],
            **{f"launches_{p}": counts[name] for p, counts in by_path.items()},
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "kernel_ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "library_kernel_ms": k["library_kernel_ms"],
            **{key: k[key] for key in EXTRA_KEYS if key in k}})
        if name == "dia_spmv":  # by level, masked or not, on the two HPCG paths
            line["kernels"][-1]["launches_split"] = {
                p: by_path[p]["dia_spmv_split"]
                for p in ("hpcg", "hpcg_predict", "dist", "dist_pairs")}
    results["seconds"] = seconds
    results["total_s"] = round(time.perf_counter() - t_start, 1)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"results": results, "kernels": line["kernels"]}, f, indent=1, default=str)
    print(f"[done] total_s={results['total_s']} seconds={json.dumps(seconds)}")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

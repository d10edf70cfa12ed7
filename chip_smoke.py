#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. card     — ``nvidia-smi`` name and power limit (also printed raw);
  2. build    — compile every CUDA source under ``kernels/csrc`` from the
                checkout, one ``nvcc`` each, in parallel; each library's
                ``ptxas`` registers and spills, and 0 bytes of spill in
                every ``lstm_forward`` kernel and the three staged gossip
                kernels;
  3. kernel   — each kernel against its plain PyTorch twin on the card,
                on distinct seeded per-row weights (max |diff| <= 1e-5,
                TF32 off), at every path ``lstm_cell._plan`` takes
                (weights in registers, in shared memory by TMA or
                cp.async, streamed); a row's output bitwise independent
                of the batch it was launched in (row 5 of a G=64 launch,
                and rows at row-tile edges of the (1, 2034) eval launch,
                against their own R=1 launches; a middle group of the
                sweep's (15, 2034) eval launch against its own G=1
                launch);
  4. serve    — the main path at full width: the REPLACE-BG fast twin
                (N=226 patients), an H=128 population from a seeded
                ``torch.Generator``, buckets 1,4,16,64, 4096 requests
                through ``MicroBatcher`` + ``replay``; every forecast
                bitwise equal to a direct apply and within 1e-5 of the
                plain twin; the kernel's launch count read around it;
  5. narrow   — the committed H=8 checkpoint through the CLI entry point
                (``repro_torch.launch.serve``, width inferred), 256
                requests, ``--selfcheck``;
  6. timing   — at G=64, R=1, H=128, L=12 (one serving batch): the
                kernel, its plain twin and cuDNN's LSTM + Linear on the
                shared population weights (the yardstick; the port never
                calls it), CUDA events, median of >= 50 runs after
                warm-up; and the least time the card could take (bytes
                over 3.35 TB/s, operations over 67 TFLOP/s fp32); the
                same three at the training path's G=1, R=2034 (the
                eval) and R=329 (a patient's test split), each shape
                with its ``_plan``, warm and L2-flushed times, bound and
                bound share;
  7. profile  — ``torch.profiler`` over a replay of 1024 requests: the
                card's busy time and share of the wall time, and the
                largest device items;
  8. gossip   — the four gossip kernels against their plain twins at
                N in {1, 12, 37, 226}, D in {1, 513, 66,689}, active
                ratios 0, 0.3 and 1, on real mixing matrices and (N, 8)
                neighbor tables (max |diff| <= 1e-6); inactive rows
                bitwise copies, also with a NaN planted in an active row;
                two launches bitwise equal; ``gossip_mix``,
                ``gossip_mix_dp`` and ``gossip_mix_sparse_dp`` (staged)
                bitwise equal to the row-wise kernel at every case, and
                also at the largest N each stages and the next;
  9. train    — the training path at full width through the CLI entry
                point (``repro_torch.launch.train.run``): REPLACE-BG
                (N=226) with the sparse kernel, then OhioT1DM (N=12)
                with the dense kernel; H=128, 30% of nodes inactive,
                64 rounds, Adam at 1e-3 and batch 64 (TrainConfig),
                eval every 16 rounds; the data are the 6-day fast twins
                (the round's work does not depend on the series'
                length).  Each run: the gossip-repr the CLI resolved,
                one gossip launch per round, ``lstm_forward`` launches
                for the evals, the last 16 rounds' loss below the first
                16's, the last val RMSE record and every patient's test
                forecasts within 1e-5 of the plain twin on the trained
                population, and the checkpoint served through
                ``load_population`` + ``GlucoseServable`` with a bitwise
                selfcheck; then rounds/s over a 32-round chunk;
 10. dp       — the local-DP training path (``GluADFL`` with
                ``dp_noise_sigma=0.01``, kernel mixer) for 8 rounds at
                each representation, at full width: one launch of the
                fused DP kernel per round;
 11. mixers   — one state and one round's draws through the kernel
                mixer and the tree mixer, both representations, DP off
                and on: the mixed params agree within 1e-6;
 12. gtiming  — each gossip kernel at its main-path shape (sparse:
                N=226, dense: N=12, D=66,689, 30% inactive): CUDA-event
                time, its plain twin, a PyTorch yardstick (dense:
                ``torch.where(act, M @ W, W)``; sparse: ``torch.sparse.mm``
                of the table as a CSR matrix; DP: the same on W + Z
                with the self-restore), and the least time the card
                could take; the three staged kernels timed in turns with
                their row-wise parent (parent, kernel, kernel, parent),
                warm and L2-flushed, and both by ``torch.profiler``'s
                device time (every kernel's device time too); beside
                sparse DP, ``torch.add(W, Z)``, the same bytes read and
                written as one contiguous stream; the staged dense DP
                kernel at each tile of ``DP_TILES``;
 13. tprofile — ``torch.profiler`` over an 8-round chunk of the sparse
                training path: the card's busy time split by the
                trainer's spans (draws, mixing operator, gossip, local
                step, mask, eval, sync) and its share of the wall, and
                the local step's GEMM kernels' own device time;
 14. swa      — the bf16 kernel's ``ptxas`` registers, shared memory
                and spills; ``swa_attention`` against its plain twin at S
                in {128, 256, 1024, 3072} x window in {64, 100, 300, 1024,
                4096} x hd in {64, 128} x H/K in {1, 12} x B in {1, 2},
                fp32 (max |diff| <= 3e-5) and bf16 (<= 5e-2, and
                elementwise within ``ref.swa_bf16_bound`` of the fp32
                twin: the rounding of P and of the output), TF32 off;
                then hd 256 (the scalar kernel), 512 (it, in two
                chunks of 256 columns), 96 and 288 (zero-padded to 128
                and 512) at S in {1024, 3072} x window in {100, 2048},
                with 0 bytes of spill in the four scalar kernels; at
                RecurrentGemma-9B's local attention (B=1, S=8,192, H=16,
                K=1, window 2048) at its hd 256 and at hd 288 and 512
                against the fp32 ``banded_flash_attention``: fp32 within
                3e-5, bf16 elementwise within ``swa_bf16_bound``; at hd
                256 and 512 in both dtypes its time, the banded path's,
                ``scaled_dot_product_attention``'s and its bound; at
                the LM prefill's shape (B=1, S=32,768, H=96, K=8, hd=128,
                window 4096) against the plain ``banded_flash_attention``
                in fp32 on the same inputs: the kernel's fp32 build
                within 3e-5, its bf16 build elementwise within
                ``swa_bf16_bound`` (given the banded path); and against
                the banded path in bf16, as JAX runs it (<= 5e-2); two
                launches bitwise equal;
 15. lmprefill — the third slice at full width: Mistral-Large-123B
                (d=12288, 96 heads, 8 KV heads, d_ff=28672) with its
                depth cut to 4 of 88 layers and the batch to 1 of 32,
                bf16 weights from a seeded ``torch.Generator``, through
                ``repro_torch.arch.build_arch``: ``prefill_fn`` on a
                32,768-token prompt (one ``swa_attention`` launch and one
                banded branch per layer, finite logits, caches of the
                window), then 16 greedy ``decode_fn`` steps; the same
                path at the reduced width (fp32, window 1024, S=3072) on
                the card and on the CPU from the same weights (logits
                within 1e-4, caches within 1e-5, 4 decode steps); and the
                ``arch_demo`` CLI on the card;
 16. lmtiming — the kernel at the prefill's shape: CUDA-event time, the
                plain banded twin, ``scaled_dot_product_attention`` with
                a band mask per 1024-row query block (the yardstick; the
                port never calls it), and the least time the card could
                take (bf16 tensor-core peak; the fp32 one beside it),
                the kernel's TFLOP/s and its share of that bound;
                then the prefill's wall time, tokens/s and its device
                time split into the kernel, the GEMMs and the rest, and
                decode steps/s;
 17. personalize — cold-start personalization, then serving, at full
                width: the REPLACE-BG fast twin, an H=128 population
                from a seeded ``torch.Generator``, the last 32 patients
                as a cohort with 24 windows each, fine-tuned by one
                ``GlucoseServable.personalize`` call (100 Adam steps at
                5e-4, batch 24, the servable's defaults, through the
                CLI's ``personalize_cohort``): every patient's last-10
                loss below its first-10; for one patient
                ``personalize`` bitwise ``personalize_loop`` and within
                1e-6 of its batched row (bitwise or not, reported);
                4096 requests mixing personalized and population rows
                through ``MicroBatcher`` + ``replay``, bitwise the
                direct apply and within 1e-5 of the plain twin, the
                ``lstm_forward`` launch count read around it; the
                fine-tune's time (ms a step, patients/s), p50/p99,
                forecasts/s; and ``launch.serve --personalize 4
                --selfcheck`` on the committed H=8 checkpoint;
 18. masked   — ``gossip_impl="masked"`` training at full width:
                REPLACE-BG (N=226, sparse kernel) and OhioT1DM (N=12,
                dense kernel), H=128, 30% inactive, 8 rounds, DP off
                and at sigma=0.01: each masked run bitwise its unmasked
                twin from the same seed (params, optimizer rows,
                history), one gossip launch a round in both; rounds/s
                of each in turns, the ``round.secure_mask`` span's
                device time a round (``torch.profiler``) and peak
                memory; then ``simulate_wires`` at N=37, D=66,689: no
                valid slot of a row with >= 2 of them puts its raw row
                on the wire, and the books balance within 1e-5 of the
                sparse mix;
 19. sweep    — the scenario-sweep engine (``GluADFL.train_sweep``, tree
                mixer): (a) the paper's Fig-5 grid (ring, cluster,
                random x inactive 0, 0.3, 0.5, 0.7, 0.9, seed 0: G=15)
                on the REPLACE-BG fast twin (N=226, sparse) at H=128,
                Adam 1e-3, batch 64, 32 rounds in chunks of 16, eval
                every 16: one ``lstm_forward`` launch (G=15 groups) per
                eval and no gossip kernel launch, finite losses, the
                last 8 rounds' mean loss below the first 8's at every
                ratio <= 0.7, the val records within 1e-5 of the plain
                twin on the same populations, and ring@0.3, cluster@0
                and random@0.7 within 1e-5 of their serial ``train()``
                runs (losses, val records, population; bitwise or not,
                reported); (b) the CLI, ``--sweep-ratios 0,0.3,0.7
                --sweep-seeds 2`` for 16 rounds: 6 summary records
                with the JAX launcher's keys and 226 prediction
                launches (one per patient over the 6 populations); (c)
                OhioT1DM (N=12, dense) with every axis armed (3
                topologies x 0.3, 0.7 x bernoulli, markov x skews 0,
                0.5 x DP sigma 0.01, 0.05: G=48) for 16 rounds, one
                scenario engaging all three axes within 1e-5 of its
                serial twin; (d) ``gossip_impl="masked"`` sweeps
                bitwise the unmasked ones over 4 rounds (REPLACE-BG,
                ring, cluster, random x 0.3: G=3, with peak memory;
                and the OhioT1DM G=48 grid); (e) scenario-rounds/s of
                the G=15 grid over a 16-round chunk, in turns with one
                serial scenario's rounds/s on the tree and the kernel
                mixer, peak memory, the device busy share and span
                split of a profiled 4-round swept chunk, and
                ``lstm_forward`` at the sweep's eval shape (G=15,
                R=2034) timed as phase 6 times the others;
 20. baselines — the paper's baselines (``core.fedavg``, ``core.meta``,
                ``core.supervised``, ``repro_torch.paper``) on the
                REPLACE-BG fast twin (N=226, D=66,689) at H=128, batch
                64: (1) two FedAvg rounds (2 local steps, Adam 2e-3, 30%
                inactive) and two MAML and two MetaSGD meta-steps (3
                second-order inner steps at 1e-2, SGD 2e-2) on the card
                and on the CPU from one set of draws, the change of the
                params (and of MetaSGD's rates) within a relative norm
                of 1e-4, losses within 1e-4 (Adam) / 1e-5 (SGD), and a
                first-order MAML run on the card outside that limit;
                (2) the Table-4 grid
                (``run_baseline_grid``: FedAvg, MAML, MetaSGD, pooled
                LSTM, 32 rounds each) in <= 4 chunks through
                ``chunked.dispatch_chunk``, finite histories, each
                population through ``eval_population`` (226
                ``lstm_forward`` launches each, 904 in all, the counted
                main path), every test forecast within 1e-5 of the plain
                twin; (3) each method's chunk in turns (fedavg, maml,
                metasgd, lstm, then back), rounds / meta-steps / steps
                a second, the peak memory it adds, and a profiled short
                chunk's device time split by the trainers' spans and
                its busy share; (4) Table 4 with all eleven methods on
                OhioT1DM and ABC4D (H=128, 16 rounds, 64 supervised
                steps; the GBT's host fit kept off REPLACE-BG's 220,923
                windows), every seen/unseen metric finite, and Fig 3 on
                OhioT1DM; (5) ``lstm_forward`` at the pooled val set's
                (G=1, R=71,317) timed as phase 6 times the others;
 21. figures  — the paper's Figs 4 and 5 (``repro_torch.paper``) on the
                REPLACE-BG fast twin (N=226) at H=128, batch 64, B=7:
                (a) Fig 4 (ring, cluster, random: G=3) for 32 rounds,
                its mg/dL val RMSE ``eval_fn`` every 8 rounds over the
                71,317 pooled val windows: 3 ``lstm_forward`` launches
                an eval round and no gossip kernel, on the sweep path
                (the counted main path) and on ``--serial``; every
                record within 1e-4 relative of the plain twin's eval of
                the same population and of the serial curve; the swept
                chunk timed with and without the eval in turns; (b) Fig
                5 (the G=15 grid) for 16 rounds, then ``eval_population``
                per scenario: 226 launches each, 3,390 in all, three
                scenarios' forecasts within 1e-5 of the plain twin and
                their metrics those forecasts', the wall split into
                training and eval; (c) the paper driver
                (``repro_torch.paper.run``) at ``--quick``: its eight
                CSV lines and finite results; (d) the four examples
                (``repro_torch.examples``) at their own sizes, each
                with finite results and its wall time;

then one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result, as it does when CUDA is absent or when it
stands alone without the repository.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "experiments" / "checkpoints" / "gluadfl_ohiot1dm_ring.npz"
TOL = 1e-5  # fp32 summation order over 12 recurrent steps, H <= 313

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, tensor cores

# (G, R, L, I, H): serving shapes (R=1, L=12, I=1) across widths, one
# multivariate, multi-row, single-step case, and the training path's
# population forward (G=1, H=128): the streaming eval's val windows at
# REPLACE-BG (226 x 9) and OhioT1DM (12 x 170), and the longest
# per-patient test split of the REPLACE-BG fast twin; then each path of
# ``lstm_cell._plan`` at its edges: a ragged last row tile (R = 8 + 1)
# with weights in registers, the largest H a cluster of 8 holds
# (cp.async, H % 4 != 0), the first H that streams, and a cp.async
# slice with L=1, I=3; last, the sweep's eval: the Fig-5 grid's 15
# populations over the REPLACE-BG val windows
SWEEP_EVAL = (15, 2034, 12, 1, 128)
SWEEP_EVAL_GROUP = 7  # a middle group, held bitwise against its own G=1 launch
CASES = [(1, 1, 12, 1, 8), (37, 1, 12, 1, 32), (64, 1, 12, 1, 128),
         (64, 1, 12, 1, 256), (5, 3, 1, 3, 16),
         (1, 2034, 12, 1, 128), (1, 2040, 12, 1, 128), (1, 329, 12, 1, 128),
         (37, 9, 12, 1, 128), (3, 9, 12, 1, 312), (2, 3, 12, 1, 313), (4, 9, 1, 3, 30),
         SWEEP_EVAL]
# rows of the (1, 2034) eval launch held bitwise against their own R=1
# launches: both edges of the first, a middle and the last (ragged) tile
TILE_ROWS = (0, 7, 8, 9, 1015, 1016, 2031, 2032, 2033)
# the kernel's timed shapes: a serving batch, the eval, a test split
LSTM_TIMED = ((64, 1, 12, 1, 128), (1, 2034, 12, 1, 128), (1, 329, 12, 1, 128))

# gossip: fp32 sums of <= B+1 = 8 row-stochastic weights times values
# ~1, the kernel with FMAs against the twin's multiply-then-add
GOSSIP_TOL = 1e-6
COMM_BATCH = 7  # B of Algorithm 1 (FLConfig default): tables of 8 slots
GOSSIP_NODES = (1, 12, 37, 226)
GOSSIP_COLS = (1, 513, 66_689)  # 66,689 = the H=128 LSTM's parameter count
GOSSIP_RATIOS = (0.0, 0.3, 1.0)
# (tile, threads) of the staged gossip_mix_dp timed at its main-path shape
DP_TILES = ((64, 256), (128, 256), (256, 256), (256, 512), (512, 512))
TRAIN_ROUNDS = 64
EVAL_EVERY = 16
# the cold-start cohort: the last 32 REPLACE-BG patients, 24 windows each
PERSONALIZE_COHORT = 32
PERSONALIZE_WINDOWS = 24
# personalize against its row of the batched call: bitwise on the CPU; on
# the card cuBLAS may pick another bmm at batch 1 than at batch 32
PERSONALIZE_ROW_TOL = 1e-6
MASKED_ROUNDS = 8
# phase 19: the Fig-5 grid's run, its serial twins (topology, ratio; seed
# 0), the CLI's grid, the all-axes OhioT1DM grid and its serial twin
SWEEP_ROUNDS, SWEEP_CHUNK, SWEEP_EVAL_EVERY = 32, 16, 16
SWEEP_SERIAL = (("ring", 0.3), ("cluster", 0.0), ("random", 0.7))
SWEEP_TOL = 1e-5
SWEEP_CLI = ["--dataset", "replace-bg", "--fast-data", "--topology", "random",
             "--sweep-ratios", "0,0.3,0.7", "--sweep-seeds", "2", "--rounds", "16"]
SWEEP_AXES = dict(schedules=("bernoulli", "markov"), skews=(0.0, 0.5), dp_sigmas=(0.01, 0.05))
SWEEP_AXES_RATIOS = (0.3, 0.7)
SWEEP_AXES_TWIN = ("cluster", 0.7, "markov", 0.5, 0.05, 0)
SWEEP_SHORT = 16  # rounds of the CLI's and the axes' runs, and of a timed chunk
SWEEP_MASKED_ROUNDS = 4
SWEEP_PROFILED_ROUNDS = 4
DEV = "cuda"
WIRES_NODES = 37
# the wires' books: fp32 sums of <= 8 weighted rows, each a raw row plus
# <= 7 signed unit-normal masks, against the plain sparse mix
WIRES_TOL = 1e-5
# swa_attention: JAX's own tolerances for this kernel (tests/test_kernels.py):
# fp32 sums over <= 4096 keys in another order; bf16 inputs with fp32
# inside on both sides and the output rounded to bf16 (at the prefill's
# shape the plain banded path also rounds scores and probabilities to bf16)
SWA_TOL = {torch.float32: 3e-5, torch.bfloat16: 5e-2}
SWA_SEQS = (128, 256, 1024, 3072)
SWA_WINDOWS = (64, 100, 300, 1024, 4096)
# the head dims beyond the wgmma kernel's: 256 on the scalar kernel, 512
# on it in two chunks, 96 zero-padded to 128 and 288 to 512
SWA_WIDE = {"seqs": (1024, 3072), "windows": (100, 2048), "hds": (256, 512, 96, 288)}
HYBRID_ARCH = "recurrentgemma-9b"  # local attention at hd 256, one KV head
HYBRID_SEQ = 8192
HYBRID_HDS = (256, 288, 512)  # its own hd, one padded to 512, and 512 itself
HYBRID_TIMED = (256, 512)
LM_ARCH = "mistral-large-123b"
LM_LAYERS = 4           # of 88
LM_DECODE_STEPS = 16
LM_SLICE_TOL = {"logits": 1e-4, "caches": 1e-5}  # fp32, card against CPU, 2 layers
# substrings of the names of cuBLAS's GEMM kernels on Hopper
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
# the trainer's record_function spans, in the order of a round
SPANS = ("round.draws", "round.mixing_operator", "round.gossip", "round.local_step",
         "round.mask", "round.eval", "chunk.sync")
# the masked round's span, inside round.gossip
MASK_SPANS = ("round.secure_mask",)
# phase 20: the Table-4 baselines on the REPLACE-BG fast twin at H=128.
# The grid's rounds (FedAvg rounds, meta-steps, supervised steps); the
# rounds held card against CPU; each method's timed and profiled chunk
# and its spans; the pooled supervised val set's eval shape; the
# datasets of the eleven-method Table 4
BASELINE_ROUNDS = 32
BASELINE_TIMED = {"fedavg": 8, "maml": 4, "metasgd": 4, "lstm": 32}
BASELINE_PROFILED = {"fedavg": 2, "maml": 1, "metasgd": 1, "lstm": 8}
BASELINE_SPANS = {
    "fedavg": ("fedavg.draws", "fedavg.local_step", "fedavg.aggregate", "fedavg.eval",
               "chunk.sync"),
    "maml": ("meta.draws", "meta.inner", "meta.outer", "meta.eval", "chunk.sync"),
    "lstm": ("supervised.draws", "supervised.step", "supervised.eval", "chunk.sync"),
}
BASELINE_SPANS["metasgd"] = BASELINE_SPANS["maml"]
# card against CPU from one set of draws, held on what training changed
# (params - init) by relative norm: FedAvg under Adam (two rounds, each
# of two local steps from a fresh Adam, so each round's second step
# weighs the gradients' sizes, not only their signs), MAML and MetaSGD
# under SGD (the change is the meta-gradient itself, size and all; the
# grid's inner rate 1e-2 and 3 inner steps).  Autograd sums in another
# order on each side (TF32 off): losses within 1e-4 under Adam and 1e-5
# under SGD, as tests/test_torch_gpu.py; changes within a relative norm
# of 1e-4.  A first-order MAML run on the card is read against the CPU's
# second-order one and must fall outside that limit
BASELINE_VS_CPU = {"fedavg": ("adam", 2e-3, 2), "maml": ("sgd", 2e-2, 2),
                   "metasgd": ("sgd", 2e-2, 2)}
VS_CPU_LOSS_TOL = {"adam": 1e-4, "sgd": 1e-5}
VS_CPU_CHANGE_REL = 1e-4
POOLED_EVAL = (1, 71_317, 12, 1, 128)  # REPLACE-BG's pooled val windows, one population
TABLE4_DATASETS = ["ohiot1dm", "abc4d"]
TABLE4_SCALE = dict(hidden=128, rounds=16, sup_steps=64, max_patients=None)
# phase 21: Figs 4 and 5 at REPLACE-BG fast (N=226), H=128, batch 64,
# B=7, through the experiments' own ``run``; Fig 4's curves (mg/dL val
# RMSE) held against the plain twin's eval of the same populations and
# against the serial path by relative difference (the batched and serial
# rows differ by ~2.4e-7 on the card, PR 19); Fig 5's sampled scenarios'
# forecasts as phase 20 holds them; the sweep timed with and without
# the eval in turns; the driver at --quick and the four examples
FIG_SCALE = dict(hidden=128, batch_size=64, max_patients=None)
FIG4_ROUNDS, FIG4_EVAL_EVERY, FIG4_TIMED = 32, 8, 16
FIG4_REL_TOL = 1e-4
FIG5_ROUNDS = 16
FIG5_SAMPLE = (0, 7, 14)  # ring@0, cluster@0.5, random@0.9
DRIVER_LINES = ["fl.gluadfl_round.ring", "fl.gluadfl_round.random", "table2.generalization",
                "table3.supervised", "table4.baselines", "fig3.personalization",
                "fig4.topology", "fig5.async"]
EXAMPLES = {"quickstart": [], "topology_async_ablation": [], "cross_patient": [],
            "serve_arch": []}


def require(cond, what) -> None:
    """Fail the run (an ``assert`` that ``-O`` cannot remove)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def random_inputs(gen: torch.Generator, g, r, steps, isz, hsz):
    """Distinct per-row weights at the model's init scales."""
    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    return (
        normal(g, r, steps, isz),
        normal(g, isz, 4 * hsz, scale=1 / math.sqrt(isz)),
        normal(g, hsz, 4 * hsz, scale=1 / math.sqrt(hsz)),
        normal(g, 4 * hsz, scale=0.5),
        normal(g, hsz, 1, scale=1 / math.sqrt(hsz)),
        normal(g, 1, scale=0.5),
    )


def time_ms(fn, runs: int, flush: torch.Tensor | None = None, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``runs`` CUDA-event pairs,
    after ``warmup`` calls; with ``flush``, the L2 is overwritten before each.
    A spin kernel (~0.2 s) holds the card while the host queues the runs,
    so the events time the card and not the host's launch overhead, as
    long as queueing takes less than the spin (a host-bound ``fn``, such
    as the plain twin's ~9,000 small launches, still times the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(350_000_000)  # cycles of the SM clock
    pairs = []
    for _ in range(runs):
        if flush is not None:
            flush.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def device_us(fn, runs: int = 50) -> float:
    """Device time of one call of ``fn`` in microseconds, from
    ``torch.profiler``: its kernels' device time over ``runs`` calls
    after one warm-up, divided by ``runs`` -- without the few
    microseconds of launch and event overhead that ``time_ms`` counts
    for a kernel that short."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                for e in prof.key_averages())
    return total / runs


def lstm_forward_cost(x, wx, wh, b, w_out, b_out) -> tuple[float, float]:
    """Bytes (each input read once, the output written once) and
    operations of one ``lstm_forward`` call: the gate and head FMAs as 2
    each, the two adds per gate column, and 4 per unit for the c/h
    update (the 5 transcendentals per unit are not counted)."""
    g, r, steps, isz = x.shape
    hsz = wh.shape[1]
    nbytes = 4 * (sum(t.numel() for t in (x, wx, wh, b, w_out, b_out)) + g * r)
    per_step = 2 * (isz + hsz) * 4 * hsz + 2 * 4 * hsz + 4 * hsz
    ops = g * r * (steps * per_step + 2 * hsz + 1)
    return nbytes, ops


def gossip_inputs(gen: torch.Generator, n: int, d: int, ratio: float):
    """Seeded (N, D) params and DP noise, an active mask, and the round's
    mixing matrix and neighbor table from a random topology."""
    from repro_torch.core.topology import mixing_matrix, neighbor_table, random_adjacency

    w = torch.randn((n, d), generator=gen, device="cuda")
    z = 0.01 * torch.randn((n, d), generator=gen, device="cuda")
    act = (torch.rand(n, generator=gen, device="cuda") >= ratio).float()
    if n > 1:
        adj = random_adjacency(torch.rand((n, n), generator=gen, device="cuda"),
                               min(COMM_BATCH, n - 1))
    else:
        adj = torch.zeros((1, 1), device="cuda")
    idx, wgt = neighbor_table(adj, act, COMM_BATCH)
    return w, z, act, mixing_matrix(adj, act, COMM_BATCH), idx, wgt


def gossip_calls(w, z, act, mix, idx, wgt):
    """(name, kernel wrapper, plain twin, args) for the four kernels."""
    from repro_torch.kernels import gossip_mix as gk
    from repro_torch.kernels import ref

    return [
        ("gossip_mix", gk.gossip_mix, ref.gossip_mix_plain, (mix, w, act)),
        ("gossip_mix_sparse", gk.gossip_mix_sparse, ref.gossip_mix_sparse_plain,
         (idx, wgt, w, act)),
        ("gossip_mix_dp", gk.gossip_mix_dp, ref.gossip_mix_dp_plain, (mix, w, z, act)),
        ("gossip_mix_sparse_dp", gk.gossip_mix_sparse_dp, ref.gossip_mix_sparse_dp_plain,
         (idx, wgt, w, z, act)),
    ]


def rowwise_calls(w, z, act, mix, idx, wgt):
    """name -> (the row-wise parent wrapper, args) of the three kernels
    with a staged design."""
    from repro_torch.kernels import gossip_mix as gk

    return {"gossip_mix": (gk.gossip_mix_rowwise, (mix, w, act)),
            "gossip_mix_dp": (gk.gossip_mix_dp_rowwise, (mix, w, z, act)),
            "gossip_mix_sparse_dp": (gk.gossip_mix_sparse_dp_rowwise, (idx, wgt, w, z, act))}


def staged_limit(name: str, slots: int) -> int:
    """The largest N at which ``name`` runs the staged kernel (the pure
    plan; D does not enter)."""
    from repro_torch.kernels import gossip_mix as gk

    return max(n for n in range(1, 1200) if gk._plan(name, n, slots, 1).design == "staged")


def dp_tile_sweep(w, z, act, mix, want) -> dict[str, dict[str, float]]:
    """The staged ``gossip_mix_dp`` kernel at each (tile, threads) of
    DP_TILES, launched through its C entry point (not the wrapper, so
    uncounted): bitwise ``want`` at each, then its CUDA-event time and
    profiler device time -- what ``STAGED_TILE`` was chosen from."""
    from repro_torch.kernels import gossip_mix as gk

    launch = gk._fn("gossip_mix_dp_launch")
    out = torch.empty_like(w)
    n, d = w.shape
    sweep = {}
    for tile, threads in DP_TILES:
        def call():
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(mix.data_ptr(), w.data_ptr(), z.data_ptr(), act.data_ptr(),
                         out.data_ptr(), n, d, tile, threads, stream)
            require(err == 0, f"gossip_mix_dp at T={tile}, {threads} threads: cudaError {err}")

        out.fill_(float("nan"))
        call()
        require(torch.equal(out.view(torch.int32), want.view(torch.int32)),
                f"gossip_mix_dp at T={tile}, {threads} threads: not bitwise the wrapper's")
        sweep[f"T={tile}/threads={threads}"] = dict(ms=time_ms(call, 200), device_us=device_us(call))
    return sweep


def gossip_library(name, w, z, act, mix, idx, wgt):
    """The PyTorch yardstick for one gossip kernel (timed, never used by
    the port): dense ``torch.where(act, M @ W, W)``; sparse
    ``torch.sparse.mm`` of the table as a CSR matrix; the DP variants
    the same on ``W + Z`` with the clean-self restore."""
    n = w.shape[0]
    keep = act[:, None] > 0
    if name in ("gossip_mix", "gossip_mix_dp"):
        if name == "gossip_mix":
            return lambda: torch.where(keep, mix @ w, w)
        diag = torch.diagonal(mix)[:, None]
        return lambda: torch.where(keep, mix @ (w + z) - diag * z, w)
    from repro_torch.core.topology import densify_neighbor_table

    # a well-formed CSR matrix: sorted columns, the zero-weight padding
    # slots dropped
    table = densify_neighbor_table(idx, wgt).to_sparse_csr()
    if name == "gossip_mix_sparse":
        return lambda: torch.where(keep, torch.sparse.mm(table, w), w)
    self_w = wgt[:, :1]
    return lambda: torch.where(keep, torch.sparse.mm(table, w + z) - self_w * z, w)


def gossip_cost(name, w, act, idx) -> tuple[float, float]:
    """Bytes (each input read once, the output written once) and the
    operations this run's data needs: an FMA (2 operations) per weight
    and column of each ACTIVE row (inactive rows are copies), plus for
    DP one add per weight and column and the restore's multiply-add."""
    n, d = w.shape
    rows = float(act.sum())
    sparse = "sparse" in name
    dp = name.endswith("_dp")
    slots = idx.shape[1] if sparse else n
    table = n * slots * 8 if sparse else n * n * 4
    nbytes = 4 * n * d * (3 if dp else 2) + table + 4 * n
    ops = rows * d * (2 * slots + (slots + 2 if dp else 0))
    return nbytes, ops


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def swa_cost(q: torch.Tensor, k: torch.Tensor, window: int) -> tuple[float, float]:
    """Bytes (q, k, v read once, o written once) and operations of one
    ``swa_attention`` call: 4 hd per (query, key) pair in the band (the
    two products' multiply-adds; the softmax is not counted)."""
    b, s, h, hd = q.shape
    w = min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w  # per (batch, head)
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return nbytes, 4.0 * hd * pairs * b * h


def swa_inputs(gen: torch.Generator, b, s, h, kh, hd, dtype):
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))


def band_sdpa(q, k, v, window: int, block: int = 1024):
    """The PyTorch yardstick for ``swa_attention`` (timed, never used by
    the port): ``scaled_dot_product_attention`` once per ``block`` query
    rows, over that block's band of keys with a boolean band mask, the
    KV heads repeated to H beforehand.  Returns the call; its output is
    (B, H, S, hd)."""
    s, h = q.shape[1], q.shape[2]
    rep = h // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    kv_blocks = -(-window // block) + 1
    pos = torch.arange(s, device=q.device)
    calls = []
    for i in range(s // block):
        lo, hi = max(i - kv_blocks + 1, 0) * block, (i + 1) * block
        qp, kp = pos[i * block:hi, None], pos[None, lo:hi]
        calls.append((slice(i * block, hi), slice(lo, hi), (kp <= qp) & (kp > qp - window)))

    def run():
        return torch.cat([torch.nn.functional.scaled_dot_product_attention(
            qt[:, :, rows], kt[:, :, keys], vt[:, :, keys], attn_mask=mask)
            for rows, keys, mask in calls], dim=2)

    return run


def swa_timing(q, k, v, window: int, ops_per_s: float) -> dict:
    """``swa_attention`` at one shape: its CUDA-event time, the plain
    banded path's, :func:`band_sdpa`'s (and its distance from the
    kernel), and the least time the card could take at ``ops_per_s``."""
    from repro_torch.kernels import swa_attention as swa_kernel
    from repro_torch.nn import attention as attn

    call = lambda: swa_kernel.swa_attention(q, k, v, window=window)  # noqa: E731
    library = band_sdpa(q, k, v, window)
    nbytes, ops = swa_cost(q, k, window)
    row = dict(ms=time_ms(call, 20),
               plain_ms=time_ms(lambda: attn.banded_flash_attention(q, k, v, window=window), 5,
                                warmup=1),
               library_ms=time_ms(library, 10, warmup=2),
               library_max_abs_err=float((library().transpose(1, 2).float()
                                          - call().float()).abs().max()))
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, ops_per_s)
    row.update(bound_share=row["bound_ms"] / row["ms"], tflop_per_s=ops / (row["ms"] * 1e-3) / 1e12)
    return row


def ptxas_report(log: str, *needles: str) -> dict[str, list[str]]:
    """``ptxas -v`` lines (registers, shared memory, spills) of each entry
    function of a build log whose (mangled) name holds every one of
    ``needles``, and under "warnings" any line that says the compiler
    serialized ``wgmma``."""
    found: dict[str, list[str]] = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "wgmma.mma_async" in line or "Performance Loss" in line:
            found.setdefault("warnings", []).append(line.strip())
        elif name and all(n in name for n in needles) and ("registers" in line or "spill" in line):
            found.setdefault(name, []).append(line.strip())
    return found


def spill_free(report: dict[str, list[str]]) -> bool:
    """Every kernel of a :func:`ptxas_report` reports 0 bytes of spill."""
    spills = [ln for name, lines in report.items() if name != "warnings"
              for ln in lines if "spill" in ln]
    return bool(spills) and all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills)


def cudnn_lstm(wx, wh, b, w_out, b_out):
    """cuDNN's ``torch.nn.LSTM`` + ``nn.Linear`` holding one weight set
    (wx (I, 4H), wh (H, 4H), b (4H,), w_out (H, 1), b_out (1,)): the
    yardstick for ``lstm_forward`` at G=1 or on shared weights, which
    the port never calls.  Returns x (R, L, I) -> y (R,)."""
    isz, hsz = wx.shape[0], wh.shape[0]
    with torch.no_grad():
        lstm = torch.nn.LSTM(isz, hsz, batch_first=True).cuda()
        head = torch.nn.Linear(hsz, 1).cuda()
        lstm.weight_ih_l0.copy_(wx.T)
        lstm.weight_hh_l0.copy_(wh.T)
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
        head.weight.copy_(w_out.T)
        head.bias.copy_(b_out)

    def run(xs):
        with torch.no_grad():
            out, _ = lstm(xs)
            return head(out[:, -1])[:, 0]

    return run


def served_vs_plain(sv, reqs, preds: dict[int, float]) -> float:
    """The largest |served forecast - the plain twin's| over a replay,
    each store row's requests as one plain forward under that row."""
    from repro_torch.kernels.ref import lstm_forward_plain

    err = 0.0
    for row in sorted({r.patient for r in reqs}):
        mine = [r for r in reqs if r.patient == row]
        params = sv.params_rows([row])
        x = torch.tensor(np.stack([r.window for r in mine]), device="cuda")[None, :, :, None]
        ref = lstm_forward_plain(x, params["wx"], params["wh"], params["b"],
                                 params["w_out"], params["b_out"])[0].cpu()
        got = torch.tensor([preds[r.rid] for r in mine])
        err = max(err, float((got - ref).abs().max()))
    return err


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    from repro_torch.kernels import gossip_mix as gk
    from repro_torch.kernels import lstm_cell, swa_attention

    lstm_cell.LAUNCHES = 0
    swa_attention.LAUNCHES = 0
    for k in gk.LAUNCHES:
        gk.LAUNCHES[k] = 0


def launches() -> dict[str, int]:
    from repro_torch.kernels import gossip_mix as gk
    from repro_torch.kernels import lstm_cell, swa_attention

    return {"lstm_forward": lstm_cell.LAUNCHES, **gk.LAUNCHES,
            "swa_attention": swa_attention.LAUNCHES}


def span_breakdown(prof, spans=SPANS) -> tuple[dict[str, float], dict[str, float], float, int]:
    """Device busy time (ms) of one profile, split by the trainer's
    ``spans``: each device kernel or copy goes to the span whose range
    on the device timeline holds its start ("other" if none).  Also the
    same split of the GEMM kernels alone (a "gemm" in the kernel's
    name), the total, and the number of device kernels and copies.
    Spans not in ``spans`` are neither ranges nor work."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in on_device if e.name in spans]
    busy = dict.fromkeys(spans + ("other",), 0.0)
    gemm = dict.fromkeys(spans + ("other",), 0.0)
    work = [e for e in on_device if e.name not in SPANS + MASK_SPANS + tuple(spans)]
    for e in work:
        start = e.time_range.start
        owner = next((name for name, lo, hi in ranges if lo <= start < hi), "other")
        busy[owner] += (e.time_range.end - start) / 1e3
        if "gemm" in e.name.lower():
            gemm[owner] += (e.time_range.end - start) / 1e3
    return busy, gemm, sum(busy.values()), len(work)


def sweep_phase(feds, card: str, flush: torch.Tensor, errs: list) -> dict:
    """Phase 19, the scenario-sweep engine; returns the ``lstm_forward``
    row's fields for the sweep's eval (its launches on the main path,
    its times at the (15, 2034) shape)."""
    from repro_torch.config import FLConfig, SweepConfig
    from repro_torch.core import GluADFL, SweepGrid, choose_gossip_repr
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import lstm_forward_plain
    from repro_torch.launch.train import run as train_run
    from repro_torch.launch.train import val_windows
    from repro_torch.metrics import all_metrics
    from repro_torch.models import LSTMModel
    from repro_torch.optim import get_optimizer

    def trainer(n, *, topology="random", ratio=0.0, mixer="tree", impl="allgather", sigma=0.0,
                **fl):
        return GluADFL(LSTMModel(hidden=128).as_model(), get_optimizer("adam", 1e-3),
                       FLConfig(topology=topology, num_nodes=n, inactive_ratio=ratio, **fl),
                       mixer=mixer, gossip_impl=impl,
                       gossip_repr=choose_gossip_repr(n, COMM_BATCH), dp_noise_sigma=sigma,
                       device=DEV)

    def sync():
        if DEV == "cuda":
            torch.cuda.synchronize()

    start = {}

    def reset_peak():
        sync()
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
            start["bytes"] = torch.cuda.memory_allocated()

    def peak_gb():
        """The peak since :func:`reset_peak`, and how far it rose above
        what earlier phases still held then, in GB."""
        if DEV != "cuda":
            return None
        peak = torch.cuda.max_memory_allocated()
        return {"peak": peak / 1e9, "added": (peak - start["bytes"]) / 1e9}

    def against_serial(data, pops, hists, states, g, twin, rounds, **kw):
        """Scenario g of a sweep against its serial run from a generator
        seeded with its seed (0): the largest loss, val and population
        differences, and whether the params and the history are bitwise
        the scenario's (a static topology's serial run mixes over its
        candidates' shorter table, so its sums may differ in the last
        bit)."""
        pop, hist, state = twin.train(torch.Generator(device=DEV).manual_seed(0), data.x, data.y,
                                      data.counts, batch_size=64, rounds=rounds, **kw)
        loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(hist, hists[g]))
        val = max((abs(a["val_rmse"] - b["val_rmse"]) for a, b in zip(hist, hists[g])
                   if "val_rmse" in a), default=0.0)
        population = max(float((pop[k] - pops[k][g]).abs().max()) for k in pop)
        return dict(loss_max_abs_diff=loss, val_rmse_max_abs_diff=val,
                    population_max_abs_diff=population,
                    params_max_abs_diff=float((state.params - states.params[g]).abs().max()),
                    params_bitwise=torch.equal(state.params, states.params[g]),
                    history_bitwise=hist == hists[g])

    # (a) the Fig-5 grid through the API (the main path) ---------------------
    fed = feds["replace-bg"]
    n = fed.num_nodes
    fig5 = SweepConfig()
    grid = SweepGrid.build(fig5.topologies, fig5.inactive_ratios, fig5.seed_list(), num_nodes=n)
    vx, vy = val_windows(fed)
    swept = trainer(n)
    reset_peak()
    reset_launches()
    t0 = time.perf_counter()
    pops, hists, states = swept.train_sweep(fed.x, fed.y, fed.counts, grid=grid, batch_size=64,
                                            rounds=SWEEP_ROUNDS, chunk=SWEEP_CHUNK,
                                            eval_every=SWEEP_EVAL_EVERY, val_data=(vx, vy))
    sync()
    run_s = time.perf_counter() - t0
    counts = launches()
    evals = SWEEP_ROUNDS // SWEEP_EVAL_EVERY
    require(counts["lstm_forward"] == evals and sum(counts.values()) == evals,
            f"Fig-5 sweep: launches {counts}, want {evals} of lstm_forward and no gossip kernel")
    run_peak = peak_gb()
    losses = np.array([[h["loss"] for h in hist] for hist in hists])
    require(losses.shape == (grid.size, SWEEP_ROUNDS) and np.isfinite(losses).all(),
            "Fig-5 sweep: losses")
    first, last = losses[:, :8].mean(axis=1), losses[:, -8:].mean(axis=1)
    names = [f"{lab[0]}@{lab[1]}" for lab in grid.labels]
    slow = [names[g] for g in range(grid.size)
            if grid.labels[g][1] <= 0.7 and last[g] >= first[g]]
    require(not slow, f"Fig-5 sweep: the loss did not fall in {slow}")
    xs = torch.as_tensor(vx, device=DEV)[None, :, :, None].expand(grid.size, -1, -1, -1)
    plain = lstm_forward_plain(xs.contiguous(), *(pops[k].contiguous()
                                                  for k in ("wx", "wh", "b", "w_out", "b_out")))
    plain_rmse = torch.sqrt(torch.mean(torch.square(plain - torch.as_tensor(vy, device=DEV)),
                                       dim=1)).tolist()
    val_err = max(abs(plain_rmse[g] - hists[g][-1]["val_rmse"]) for g in range(grid.size))
    require(val_err <= TOL, f"Fig-5 sweep: val RMSE records vs the plain twin: {val_err}")
    errs.append(val_err)
    serial = {}
    for topo, ratio in SWEEP_SERIAL:
        g = grid.labels.index((topo, ratio, 0))
        serial[names[g]] = cmp = against_serial(
            fed, pops, hists, states, g, trainer(n, topology=topo, ratio=ratio), SWEEP_ROUNDS,
            chunk=SWEEP_CHUNK, eval_every=SWEEP_EVAL_EVERY, val_data=(vx, vy))
        require(max(cmp["loss_max_abs_diff"], cmp["val_rmse_max_abs_diff"],
                    cmp["population_max_abs_diff"]) <= SWEEP_TOL,
                f"Fig-5 sweep: {names[g]} vs its serial run: {cmp}")
    emit("sweep", dataset=fed.name, nodes=n, hidden=128, scenarios=grid.size,
         gossip_repr=swept.plan.gossip_repr, rounds=SWEEP_ROUNDS, chunk=SWEEP_CHUNK,
         launches=counts, scenario_rounds_per_s_whole_run=grid.size * SWEEP_ROUNDS / run_s,
         memory_gb=run_peak, loss_first8=dict(zip(names, first.tolist())),
         loss_last8=dict(zip(names, last.tolist())), val_rmse_vs_plain_max_abs_err=val_err,
         serial=serial, tol=SWEEP_TOL, nvidia_smi=card)

    # (b) the CLI -----------------------------------------------------------
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        run = train_run([*SWEEP_CLI, "--hidden", "128", "--device", DEV,
                         "--out", str(ROOT / "build" / "chip_smoke")])
    cli_counts = launches()
    records = json.loads(run.checkpoint.read_text())
    keys = {"topology", "inactive_ratio", "schedule", "skew", "dp_sigma", "seed", "final_loss",
            *all_metrics(np.array([100.0, 120.0]), np.array([110.0, 118.0]))}
    require(len(records) == 6 and all(set(r) == keys for r in records),
            f"sweep CLI: {len(records)} records, keys {[sorted(r) for r in records[:1]]}")
    require(all(math.isfinite(r["final_loss"]) and math.isfinite(r["rmse"]) for r in records),
            "sweep CLI: non-finite records")
    require(cli_counts["lstm_forward"] == n and sum(cli_counts.values()) == n,
            f"sweep CLI: launches {cli_counts}, want {n} lstm_forward (one per patient)")
    emit("sweep_cli", argv=SWEEP_CLI, records=len(records), launches=cli_counts,
         summary=[{k: r[k] for k in ("inactive_ratio", "seed", "final_loss", "rmse", "mard")}
                  for r in records], seconds=run.seconds)

    # (c) OhioT1DM with every axis armed -------------------------------------
    ohio = feds["ohiot1dm"]
    grid48 = SweepGrid.build(fig5.topologies, SWEEP_AXES_RATIOS, (0,),
                             num_nodes=ohio.num_nodes, **SWEEP_AXES)
    axes_trainer = trainer(ohio.num_nodes)
    t0 = time.perf_counter()
    pops48, hists48, states48 = axes_trainer.train_sweep(
        ohio.x, ohio.y, ohio.counts, grid=grid48, batch_size=64, rounds=SWEEP_SHORT)
    sync()
    axes_s = time.perf_counter() - t0
    require(grid48.size == 48 and all(math.isfinite(h["loss"]) for hist in hists48 for h in hist),
            "all-axes sweep: losses")
    topo, ratio, sched, skew, sigma, _ = SWEEP_AXES_TWIN
    twin = against_serial(ohio, pops48, hists48, states48, grid48.labels.index(SWEEP_AXES_TWIN),
                          trainer(ohio.num_nodes, topology=topo, ratio=ratio, sigma=sigma,
                                  schedule=sched, data_skew=skew), SWEEP_SHORT)
    require(max(twin["loss_max_abs_diff"], twin["population_max_abs_diff"]) <= SWEEP_TOL,
            f"all-axes sweep: {SWEEP_AXES_TWIN} vs its serial twin: {twin}")
    emit("sweep_axes", dataset=ohio.name, nodes=ohio.num_nodes, scenarios=grid48.size,
         gossip_repr=axes_trainer.plan.gossip_repr, rounds=SWEEP_SHORT,
         scenario_rounds_per_s=grid48.size * SWEEP_SHORT / axes_s, twin=SWEEP_AXES_TWIN,
         vs_serial=twin, tol=SWEEP_TOL)

    # (d) masked sweeps, bitwise the unmasked ones ---------------------------
    grid3 = SweepGrid.build(fig5.topologies, (0.3,), (0,), num_nodes=n)
    for data, masked_grid in ((fed, grid3), (ohio, grid48)):
        runs = {}
        for impl in ("allgather", "masked"):
            reset_peak()
            reset_launches()
            _, h, st = trainer(data.num_nodes, impl=impl).train_sweep(
                data.x, data.y, data.counts, grid=masked_grid, batch_size=64,
                rounds=SWEEP_MASKED_ROUNDS)
            sync()
            require(sum(launches().values()) == 0, f"masked sweep {data.name}: a kernel ran")
            runs[impl] = (h, st, peak_gb())
        (ha, a, peak_a), (hb, b, peak_b) = runs["allgather"], runs["masked"]
        require(ha == hb and torch.equal(a.params, b.params) and
                all(torch.equal(a.opt_state[k], b.opt_state[k]) for k in a.opt_state),
                f"masked sweep {data.name}: not bitwise the unmasked sweep")
        emit("sweep_masked", dataset=data.name, nodes=data.num_nodes, scenarios=masked_grid.size,
             rounds=SWEEP_MASKED_ROUNDS, bitwise_params_opt_state_history=True,
             memory_gb_unmasked=peak_a, memory_gb_masked=peak_b)

    # (e) the swept chunk in turns with one scenario's serial chunk ----------
    gens = [torch.Generator(device=DEV).manual_seed(100 + s) for s in range(grid.size)]
    serial_runs = {}
    for mixer in ("tree", "kernel"):
        tr = trainer(n, topology="random", ratio=0.3, mixer=mixer)
        gen = torch.Generator(device=DEV).manual_seed(7)
        serial_runs[mixer] = (tr, gen, tr.train(gen, fed.x, fed.y, fed.counts, batch_size=64,
                                                rounds=2)[2])

    def sweep_chunk(rounds=SWEEP_SHORT):
        nonlocal states
        _, _, states = swept.train_sweep(fed.x, fed.y, fed.counts, grid=grid, generators=gens,
                                         batch_size=64, rounds=rounds, chunk=rounds,
                                         states=states)

    def serial_chunk(mixer):
        tr, gen, state = serial_runs[mixer]
        state = tr.train(gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=SWEEP_SHORT,
                         chunk=SWEEP_SHORT, state=state)[2]
        serial_runs[mixer] = (tr, gen, state)

    walls = {"sweep": [], "tree": [], "kernel": []}
    reset_peak()
    for key in ("sweep", "tree", "kernel", "kernel", "tree", "sweep"):
        sync()
        t0 = time.perf_counter()
        sweep_chunk() if key == "sweep" else serial_chunk(key)
        sync()
        walls[key].append(time.perf_counter() - t0)
    timed_peak = peak_gb()
    profile = {}
    if DEV == "cuda":
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            sweep_chunk(SWEEP_PROFILED_ROUNDS)
            sync()
        by_span, gemm_by_span, busy_ms, items = span_breakdown(prof)
        require(by_span["round.local_step"] > 0, f"the profile saw no local-step work: {by_span}")
        per_round = {k: v / SWEEP_PROFILED_ROUNDS for k, v in by_span.items()}
        round_wall_ms = statistics.median(walls["sweep"]) * 1e3 / SWEEP_SHORT
        profile = dict(device_ms_per_round=busy_ms / SWEEP_PROFILED_ROUNDS,
                       wall_ms_per_round=round_wall_ms,
                       device_busy_share=busy_ms / SWEEP_PROFILED_ROUNDS / round_wall_ms,
                       device_ms_by_span_per_round=per_round,
                       gemm_device_ms_by_span_per_round={
                           k: v / SWEEP_PROFILED_ROUNDS for k, v in gemm_by_span.items()},
                       device_items_per_round=items / SWEEP_PROFILED_ROUNDS)
    emit("sweep_timing", scenarios=grid.size, rounds=SWEEP_SHORT,
         order="sweep, tree, kernel, kernel, tree, sweep",
         scenario_rounds_per_s=[grid.size * SWEEP_SHORT / w for w in walls["sweep"]],
         serial_rounds_per_s_tree=[SWEEP_SHORT / w for w in walls["tree"]],
         serial_rounds_per_s_kernel=[SWEEP_SHORT / w for w in walls["kernel"]],
         memory_gb=timed_peak, **profile, nvidia_smi=card)

    # the sweep's eval launch at its shape, timed as phase 6 times the others
    args = random_inputs(torch.Generator().manual_seed(19), *SWEEP_EVAL)
    library = cudnn_lstm(*(t[0] for t in args[1:]))
    windows = args[0].reshape(-1, *args[0].shape[2:])  # the 15 x 2034 windows, one weight set
    nbytes, ops = lstm_forward_cost(*args)
    bound_ms, bound_by = bound(nbytes, ops)
    ms = time_ms(lambda: lstm_cell.lstm_forward(*args), 200)
    timing = dict(ms=ms, ms_l2_flushed=time_ms(lambda: lstm_cell.lstm_forward(*args), 200, flush),
                  bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
                  plain_ms=time_ms(lambda: lstm_forward_plain(*args), 10),
                  library_ms=time_ms(lambda: library(windows), 100),
                  library="torch.nn.LSTM (cuDNN) + nn.Linear over the 15 x 2034 windows",
                  bytes=nbytes, ops=ops, plan=lstm_cell._plan(*SWEEP_EVAL)._asdict())
    emit("timing", shape=dict(zip("GRLIH", SWEEP_EVAL)), **timing)
    return dict(launches_sweep=counts["lstm_forward"], sweep_eval_ms=ms,
                sweep_eval_bound_ms=bound_ms, sweep_eval_bound_share=timing["bound_share"],
                sweep_eval_plain_ms=timing["plain_ms"],
                sweep_eval_library_ms=timing["library_ms"])


def baselines_phase(feds, card: str, flush: torch.Tensor, errs: list) -> dict:
    """Phase 20, the paper's baselines; returns the ``lstm_forward``
    row's fields for them (the grid's evaluation launches, the pooled
    val set's shape timed)."""
    import repro_torch.core.chunked as chunked
    from repro_torch.config import FLConfig
    from repro_torch.core import MAML, FedAvg, MetaSGD, train_supervised
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import lstm_forward_plain
    from repro_torch.metrics import all_metrics
    from repro_torch.models import LSTMModel
    from repro_torch.core.chunked import initial_row
    from repro_torch.core.gluadfl import FedTensors
    from repro_torch.optim import adam, get_optimizer
    from repro_torch.paper import common, fig3_personalization, table4_baselines
    from repro_torch.utils.pytree import tree_to_vector
    from repro_torch.utils.rng import draw_meta, draw_round

    fed = feds["replace-bg"]
    n = fed.num_nodes
    for data in feds.values():  # the experiments read the phases' datasets
        common.preload(data)
    model = LSTMModel(hidden=128).as_model()
    counts = torch.as_tensor(fed.counts)

    def trainer(method, dev, opt=None):
        if method == "fedavg":
            return FedAvg(model, opt or adam(2e-3), FLConfig(num_nodes=n, inactive_ratio=0.3,
                                                             local_steps=2), device=dev)
        return {"maml": MAML, "metasgd": MetaSGD}[method](model, opt or adam(1e-3), inner_lr=1e-2,
                                                          inner_steps=3, device=dev)

    # (1) card against CPU from one set of draws ------------------------------
    init = LSTMModel(hidden=128).init(torch.Generator().manual_seed(20))
    start = tree_to_vector(init)

    def first_order_change(meta, draws, lr):
        """MAML's steps under SGD ``lr`` with the inner gradients taken
        without a graph, so the meta-gradient drops the second-order
        term: the params' change, on the card."""
        data = FedTensors.of(fed.x, fed.y, fed.counts, DEV)
        row = theta = initial_row(model, meta.layout, None, init, DEV)
        for d in draws:
            th = theta.detach().requires_grad_(True)
            with torch.enable_grad():
                rows = th.expand(n, -1)
                for s in range(meta.inner_steps):
                    losses = meta._task_losses(rows, data, d.support[:, s].to(DEV))
                    (g,) = torch.autograd.grad(losses.sum(), rows)
                    rows = rows - meta.inner_lr * g
                (meta_g,) = torch.autograd.grad(
                    meta._task_losses(rows, data, d.query.to(DEV)).mean(), th)
            theta = th.detach() - lr * meta_g
        return tree_to_vector(meta.layout.row(theta - row)).cpu()

    vs_cpu = {}
    for method, (opt, lr, rounds) in BASELINE_VS_CPU.items():
        if method == "fedavg":
            draws = [draw_round(torch.Generator().manual_seed(200 + r), counts, local_steps=2,
                                batch_size=64, random_topology=False) for r in range(rounds)]
        else:
            draws = [draw_meta(torch.Generator().manual_seed(210 + r), counts, inner_steps=3,
                               batch_size=64) for r in range(rounds)]
        runs = {}
        for dev in (DEV, "cpu"):
            tr = trainer(method, dev, get_optimizer(opt, lr))
            t0 = time.perf_counter()
            if method == "fedavg":
                params, hist = tr.train(None, fed.x, fed.y, fed.counts, batch_size=64,
                                        rounds=rounds, params=init, draws=draws)
                lrs = None
            else:
                params, lrs, hist = tr.train(None, fed.x, fed.y, fed.counts, batch_size=64,
                                             steps=rounds, params=init, draws=draws)
            learn_lr = getattr(tr, "learn_inner_lr", False)
            runs[dev] = (tree_to_vector(params).cpu() - start, tree_to_vector(lrs).cpu()
                         - tr.inner_lr if learn_lr else None, [h["loss"] for h in hist],
                         time.perf_counter() - t0)
        (ca, la, ha, sa), (cb, lb, hb, sb) = runs[DEV], runs["cpu"]
        loss_diff = max(abs(a - b) for a, b in zip(ha, hb))
        rel = float((ca - cb).norm() / cb.norm())
        lrs_rel = None if la is None else float((la - lb).norm() / lb.norm())
        vs_cpu[method] = dict(optimizer=opt, lr=lr, rounds=rounds, loss_max_abs_diff=loss_diff,
                              change_rel_norm=rel, lrs_change_rel_norm=lrs_rel,
                              change_over_params_norm=float(cb.norm() / (start + cb).norm()),
                              seconds_card=sa, seconds_cpu=sb)
        if method == "maml":
            fo = first_order_change(trainer(method, DEV), draws, lr)
            vs_cpu[method]["first_order_change_rel_norm"] = float((fo - cb).norm() / cb.norm())
        require(all(math.isfinite(v) for v in ha) and loss_diff <= VS_CPU_LOSS_TOL[opt]
                and rel <= VS_CPU_CHANGE_REL
                and (lrs_rel is None or lrs_rel <= VS_CPU_CHANGE_REL),
                f"{method} on the card vs the CPU: {vs_cpu[method]}")
    require(vs_cpu["maml"]["first_order_change_rel_norm"] > VS_CPU_CHANGE_REL,
            f"a first-order MAML run passes the card-vs-CPU limit: {vs_cpu['maml']}")
    emit("baselines_vs_cpu", dataset=fed.name, nodes=n, hidden=128, batch=64, inner_lr=1e-2,
         inner_steps=3, loss_tol=VS_CPU_LOSS_TOL, change_rel_tol=VS_CPU_CHANGE_REL, **vs_cpu)

    # (2) the Table-4 grid, then every population's evaluation (the main path)
    scale = common.Scale(rounds=BASELINE_ROUNDS, sup_steps=BASELINE_ROUNDS, max_patients=None,
                         hidden=128, device=DEV)
    dispatched = []
    dispatch = chunked.dispatch_chunk

    def counting(fn, *args, **kwargs):
        dispatched.append(fn)
        return dispatch(fn, *args, **kwargs)

    chunked.dispatch_chunk = counting
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        grid = table4_baselines.run_baseline_grid("replace-bg", scale)
        metrics = {m: common.eval_population(d["model"], d["params"], fed)
                   for m, d in grid.items()}
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        grid_counts = launches()
    finally:
        chunked.dispatch_chunk = dispatch
    tested = sum(len(p.test_x) > 0 for p in fed.patients)
    require(len(dispatched) <= 4, f"the Table-4 grid took {len(dispatched)} chunks")
    require(grid_counts["lstm_forward"] == tested * len(grid)
            and sum(grid_counts.values()) == grid_counts["lstm_forward"],
            f"Table-4 grid: launches {grid_counts}, want {tested} lstm_forward per population")
    grid_rows = {}
    for method, d in grid.items():
        losses = [h["loss"] for h in d["history"]]
        require(len(losses) == BASELINE_ROUNDS and all(math.isfinite(v) for v in losses),
                f"Table-4 grid: {method}'s history")
        params = d["params"]
        preds, plain_preds, ys = [], [], []
        err = 0.0
        for p in fed.patients:
            x = torch.as_tensor(p.test_x, device=DEV)
            got = model.apply(params, x)
            want = lstm_forward_plain(x[None, :, :, None], *(params[k][None] for k in
                                                             ("wx", "wh", "b", "w_out", "b_out")))[0]
            err = max(err, float((got - want).abs().max()))
            preds.append(got.cpu().numpy() * fed.sd + fed.mean)
            plain_preds.append(want.cpu().numpy() * fed.sd + fed.mean)
            ys.append(p.test_y_raw)
        require(err <= TOL, f"Table-4 grid: {method}'s test forecasts vs the plain twin: {err}")
        errs.append(err)
        plain = all_metrics(np.concatenate(ys), np.concatenate(plain_preds))
        again = all_metrics(np.concatenate(ys), np.concatenate(preds))
        require(again == metrics[method] and all(math.isfinite(v) for v in plain.values()),
                f"Table-4 grid: {method}'s metrics")
        grid_rows[method] = dict(loss_first=losses[0], loss_last=losses[-1],
                                 metrics=metrics[method],
                                 rmse_plain_minus_kernel=plain["rmse"] - metrics[method]["rmse"],
                                 max_abs_err_vs_plain=err)
    emit("baselines_grid", dataset=fed.name, nodes=n, hidden=128, rounds=BASELINE_ROUNDS,
         dispatches=len(dispatched), launches=grid_counts, patients_evaluated=tested,
         seconds=grid_s, methods=grid_rows, tol=TOL, nvidia_smi=card)

    # (3) each method's chunk in turns, its profile and its peak memory -------
    pooled_x, pooled_y = common.pooled(fed, "train")
    state = {m: d["params"] for m, d in grid.items()}
    trainers = {m: trainer(m, DEV) for m in ("fedavg", "maml", "metasgd")}

    def chunk(method, rounds):
        """``rounds`` of ``method`` from its last params, ending in the
        chunk's one host sync (the data's upload included)."""
        gen = torch.Generator(device=DEV).manual_seed(300)
        if method == "lstm":
            state[method] = train_supervised(model, adam(2e-3), gen, pooled_x, pooled_y,
                                             steps=rounds, batch_size=64, chunk=rounds,
                                             params=state[method], device=DEV)[0]
        elif method == "fedavg":
            state[method] = trainers[method].train(gen, fed.x, fed.y, fed.counts, batch_size=64,
                                                   rounds=rounds, chunk=rounds,
                                                   params=state[method])[0]
        else:
            state[method] = trainers[method].train(gen, fed.x, fed.y, fed.counts, batch_size=64,
                                                   steps=rounds, chunk=rounds,
                                                   params=state[method])[0]

    for method in grid:  # warm: the first call of each path builds cuBLAS handles
        chunk(method, 1)
    walls = {m: [] for m in grid}
    order = list(grid) + list(reversed(grid))
    for method in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        chunk(method, BASELINE_TIMED[method])
        torch.cuda.synchronize()
        walls[method].append((time.perf_counter() - t0,
                              (torch.cuda.max_memory_allocated() - held) / 1e9))
    timing = {}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for method in grid:
        rounds = BASELINE_PROFILED[method]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            chunk(method, rounds)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        by_span, gemm_by_span, busy_ms, items = span_breakdown(prof, BASELINE_SPANS[method])
        require(busy_ms > 0, f"the profile saw no device work for {method}")
        per_round_ms = statistics.median(w for w, _ in walls[method]) * 1e3 / BASELINE_TIMED[method]
        timing[method] = dict(
            rounds=BASELINE_TIMED[method],
            per_s=[BASELINE_TIMED[method] / w for w, _ in walls[method]],
            wall_ms_per_round=per_round_ms,
            peak_gb_added=[g for _, g in walls[method]],
            device_ms_per_round=busy_ms / rounds,
            device_busy_share=busy_ms / rounds / per_round_ms,
            profiled_wall_ms_per_round=prof_wall * 1e3 / rounds,
            device_ms_by_span_per_round={k: v / rounds for k, v in by_span.items()},
            gemm_device_ms_per_round=sum(gemm_by_span.values()) / rounds,
            device_items_per_round=items / rounds)
    emit("baselines_timing", order=", ".join(order),
         unit={"fedavg": "rounds", "maml": "meta-steps", "metasgd": "meta-steps",
               "lstm": "steps"}, **timing, nvidia_smi=card)

    # (4) all eleven methods, then Fig 3 ---------------------------------------
    small = common.Scale(**TABLE4_SCALE, device=DEV)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        table4 = table4_baselines.run(small, datasets=TABLE4_DATASETS)
    table4_s = time.perf_counter() - t0
    for ds, rows in table4.items():
        require(sorted(rows) == sorted(table4_baselines.METHODS), f"Table 4 {ds}: methods")
        for method, row in rows.items():
            require(all(math.isfinite(v) for part in ("seen", "unseen") for v in row[part].values()),
                    f"Table 4 {ds}/{method}: a non-finite metric")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fig3 = fig3_personalization.run(small, datasets=["ohiot1dm"])
    fig3_s = time.perf_counter() - t0
    require(all(math.isfinite(v["rmse"]) for v in fig3["ohiot1dm"].values()), "Fig 3: rmse")
    emit("table4", datasets=TABLE4_DATASETS, scale=TABLE4_SCALE,
         seen_rmse={ds: {m: r["seen"]["rmse"] for m, r in rows.items()} for ds, rows in table4.items()},
         unseen_rmse={ds: {m: r["unseen"]["rmse"] for m, r in rows.items()}
                      for ds, rows in table4.items()},
         seconds=table4_s, fig3_rmse={k: v["rmse"] for k, v in fig3["ohiot1dm"].items()},
         fig3_seconds=fig3_s)

    # (5) lstm_forward at the pooled val set's shape, timed as phase 6 times the others
    args = random_inputs(torch.Generator().manual_seed(20), *POOLED_EVAL)
    library = cudnn_lstm(*(t[0] for t in args[1:]))
    library_err = float((library(args[0][0]) - lstm_cell.lstm_forward(*args)[0]).abs().max())
    nbytes, ops = lstm_forward_cost(*args)
    bound_ms, bound_by = bound(nbytes, ops)
    ms = time_ms(lambda: lstm_cell.lstm_forward(*args), 100)
    pooled_err = float((lstm_cell.lstm_forward(*args) - lstm_forward_plain(*args)).abs().max())
    require(pooled_err <= TOL, f"lstm_forward at {POOLED_EVAL} vs the plain twin: {pooled_err}")
    errs.append(pooled_err)
    row = dict(ms=ms, ms_l2_flushed=time_ms(lambda: lstm_cell.lstm_forward(*args), 100, flush),
               bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
               plain_ms=time_ms(lambda: lstm_forward_plain(*args), 20),
               library_ms=time_ms(lambda: library(args[0][0]), 50),
               library="torch.nn.LSTM (cuDNN) + nn.Linear", library_max_abs_err=library_err,
               max_abs_err=pooled_err, bytes=nbytes, ops=ops,
               plan=lstm_cell._plan(*POOLED_EVAL)._asdict())
    emit("timing", shape=dict(zip("GRLIH", POOLED_EVAL)), **row)
    return dict(launches_baselines=grid_counts["lstm_forward"], pooled_eval_ms=ms,
                pooled_eval_bound_ms=bound_ms, pooled_eval_bound_share=row["bound_share"],
                pooled_eval_plain_ms=row["plain_ms"], pooled_eval_library_ms=row["library_ms"])


def finite_leaves(tree) -> bool:
    """Every number in a nested result (dicts, lists, tuples) is finite,
    and there is at least one."""
    seen = []

    def walk(v):
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            seen.append(math.isfinite(v))
    walk(tree)
    return bool(seen) and all(seen)


def figures_phase(feds, card: str, errs: list) -> dict:
    """Phase 21, Figs 4 and 5, the paper driver and the examples; returns
    the ``lstm_forward`` row's launches on the two figures' paths."""
    from repro_torch.config import FLConfig
    from repro_torch.core import GluADFL, SweepGrid
    from repro_torch.examples import cross_patient, quickstart, serve_arch
    from repro_torch.examples import topology_async_ablation
    from repro_torch.kernels.ref import lstm_forward_plain
    from repro_torch.metrics import all_metrics
    from repro_torch.models import LSTMModel
    from repro_torch.optim import adam
    from repro_torch.paper import common, fig4_topology, fig5_async
    from repro_torch.paper import run as driver

    fed = feds["replace-bg"]
    common.preload(fed)
    weights = ("wx", "wh", "b", "w_out", "b_out")

    def sync():
        if DEV == "cuda":
            torch.cuda.synchronize()

    # (a) Fig 4: the sweep (the main path), each eval's population kept -----
    scale4 = common.Scale(rounds=FIG4_ROUNDS, device=DEV, **FIG_SCALE)
    make_eval = fig4_topology._val_rmse_fn
    evaluated = []

    def keeping(model, data):
        fn = make_eval(model, data)

        def val_rmse(params, vx, vy):
            evaluated.append({k: v.clone() for k, v in params.items()})
            return fn(params, vx, vy)
        return val_rmse

    fig4_topology._val_rmse_fn = keeping
    try:
        curves = {}
        for serial in (False, True):
            evaluated.clear()
            sync()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                curves[serial] = fig4_topology.run(scale4, datasets=[fed.name],
                                                   eval_every=FIG4_EVAL_EVERY,
                                                   serial=serial)[fed.name]
            sync()
            seconds = time.perf_counter() - t0
            counts = launches()
            if not serial:
                fig4_counts, fig4_s, fig4_pops = counts, seconds, list(evaluated)
            else:
                serial_counts, serial_s = counts, seconds
    finally:
        fig4_topology._val_rmse_fn = make_eval
    evals = FIG4_ROUNDS // FIG4_EVAL_EVERY
    topos = fig4_topology.TOPOLOGIES
    for name, counts in (("sweep", fig4_counts), ("serial", serial_counts)):
        require(counts["lstm_forward"] == len(topos) * evals
                and sum(counts.values()) == counts["lstm_forward"],
                f"Fig 4 {name}: launches {counts}, want {len(topos)} lstm_forward an eval round")
    vx = torch.as_tensor(np.concatenate([p.val_x for p in fed.patients]), device=DEV)
    vy = torch.as_tensor(np.concatenate([p.val_y * fed.sd + fed.mean for p in fed.patients]),
                         dtype=torch.float32, device=DEV)
    plain_rel, serial_rel = 0.0, 0.0
    for j in range(evals):
        for g, topo in enumerate(topos):
            params = fig4_pops[j * len(topos) + g]
            pred = lstm_forward_plain(vx[None, :, :, None], *(params[k][None] for k in weights))[0]
            plain = float(torch.sqrt(torch.mean(torch.square(pred * fed.sd + fed.mean - vy))))
            got = curves[False][topo][j][1]
            require(curves[False][topo][j][0] == (j + 1) * FIG4_EVAL_EVERY - 1 and
                    math.isfinite(got), f"Fig 4 {topo}: record {j}")
            plain_rel = max(plain_rel, abs(got - plain) / plain)
            other = curves[True][topo][j][1]
            serial_rel = max(serial_rel, abs(got - other) / abs(other))
    require(plain_rel <= FIG4_REL_TOL, f"Fig 4: val RMSE vs the plain twin: {plain_rel}")
    require(serial_rel <= FIG4_REL_TOL, f"Fig 4: the sweep vs the serial curves: {serial_rel}")

    # the swept chunk with and without the eval, in turns
    model = LSTMModel(hidden=FIG_SCALE["hidden"]).as_model()
    trainer = GluADFL(model, adam(2e-3), FLConfig(num_nodes=fed.num_nodes, comm_batch=7),
                      device=DEV)
    grid3 = SweepGrid.build(topos, [0.0], [0], num_nodes=fed.num_nodes)
    gens = [torch.Generator(device=DEV).manual_seed(400 + g) for g in range(grid3.size)]
    val = (vx.cpu().numpy(), vy.cpu().numpy())
    eval_fn = make_eval(model, fed)
    state = None

    def chunk(rounds, with_eval):
        nonlocal state
        kw = dict(eval_every=FIG4_EVAL_EVERY, eval_fn=eval_fn, val_data=val) if with_eval else {}
        _, _, state = trainer.train_sweep(fed.x, fed.y, fed.counts, grid=grid3, generators=gens,
                                          batch_size=FIG_SCALE["batch_size"], rounds=rounds,
                                          chunk=rounds, states=state, **kw)

    chunk(FIG4_EVAL_EVERY, True)  # warm: cuBLAS handles, the first eval
    walls = {True: [], False: []}
    for with_eval in (True, False, False, True):
        sync()
        t0 = time.perf_counter()
        chunk(FIG4_TIMED, with_eval)
        sync()
        walls[with_eval].append(time.perf_counter() - t0)
    per_eval_ms = ((statistics.mean(walls[True]) - statistics.mean(walls[False])) * 1e3
                   / (FIG4_TIMED // FIG4_EVAL_EVERY))
    emit("fig4", dataset=fed.name, nodes=fed.num_nodes, hidden=FIG_SCALE["hidden"],
         batch=FIG_SCALE["batch_size"], comm_batch=7,
         scenarios=len(topos), rounds=FIG4_ROUNDS, eval_every=FIG4_EVAL_EVERY,
         launches=fig4_counts, launches_serial=serial_counts,
         val_rows=int(vx.shape[0]), seconds=fig4_s, seconds_serial=serial_s,
         final_val_rmse={t: curves[False][t][-1][1] for t in topos},
         val_rmse_vs_plain_max_rel=plain_rel, sweep_vs_serial_max_rel=serial_rel,
         rel_tol=FIG4_REL_TOL, timed_rounds=FIG4_TIMED, order="eval, none, none, eval",
         scenario_rounds_per_s_with_eval=[grid3.size * FIG4_TIMED / w for w in walls[True]],
         scenario_rounds_per_s_without_eval=[grid3.size * FIG4_TIMED / w for w in walls[False]],
         eval_ms_per_eval_round=per_eval_ms, nvidia_smi=card)

    # (b) Fig 5: the G=15 grid, then every scenario's eval_population -------
    scale5 = common.Scale(rounds=FIG5_ROUNDS, device=DEV, **FIG_SCALE)
    eval_population = fig5_async.eval_population
    kept, eval_s = [], []

    def timed_eval(model, params, data):
        t0 = time.perf_counter()
        out = eval_population(model, params, data)
        eval_s.append(time.perf_counter() - t0)
        kept.append((model, params, out))
        return out

    fig5_async.eval_population = timed_eval
    try:
        sync()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            fig5 = fig5_async.run(scale5, datasets=[fed.name])[fed.name]
        sync()
        fig5_s = time.perf_counter() - t0
        fig5_counts = launches()
    finally:
        fig5_async.eval_population = eval_population
    tested = sum(len(p.test_x) > 0 for p in fed.patients)
    g5 = len(kept)
    require(g5 == len(topos) * len(fig5_async.RATIOS), f"Fig 5: {g5} scenarios evaluated")
    require(fig5_counts["lstm_forward"] == tested * g5
            and sum(fig5_counts.values()) == fig5_counts["lstm_forward"],
            f"Fig 5: launches {fig5_counts}, want {tested} lstm_forward a scenario")
    require(finite_leaves(fig5), f"Fig 5: a non-finite curve: {fig5}")
    fig5_err = 0.0
    for g in FIG5_SAMPLE:
        model5, params, metrics = kept[g]
        preds, ys = [], []
        for p in fed.patients:
            x = torch.as_tensor(p.test_x, device=DEV)
            with torch.no_grad():
                got = model5.apply(params, x)
            want = lstm_forward_plain(x[None, :, :, None], *(params[k][None] for k in weights))[0]
            fig5_err = max(fig5_err, float((got - want).abs().max()))
            preds.append(got.cpu().numpy() * fed.sd + fed.mean)
            ys.append(p.test_y_raw)
        require(all_metrics(np.concatenate(ys), np.concatenate(preds)) == metrics,
                f"Fig 5: scenario {g}'s metrics are not its forecasts'")
    require(fig5_err <= TOL, f"Fig 5: sampled forecasts vs the plain twin: {fig5_err}")
    errs.append(fig5_err)
    emit("fig5", dataset=fed.name, nodes=fed.num_nodes, hidden=FIG_SCALE["hidden"],
         batch=FIG_SCALE["batch_size"],
         scenarios=g5, rounds=FIG5_ROUNDS, launches=fig5_counts, patients_evaluated=tested,
         seconds=fig5_s, seconds_eval=sum(eval_s), seconds_train=fig5_s - sum(eval_s),
         eval_ms_per_launch=sum(eval_s) * 1e3 / fig5_counts["lstm_forward"],
         rmse=fig5, sampled=list(FIG5_SAMPLE), max_abs_err_vs_plain=fig5_err, tol=TOL,
         nvidia_smi=card)

    # (c) the paper driver at --quick -----------------------------------------
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = driver.drive(["--quick", "--device", DEV])
    driver_s = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    csv = [ln.split(",") for ln in lines[lines.index("name,us_per_call,derived") + 1:]
           if "," in ln and not ln.startswith(("[", " ", "-", "#"))]
    names = [c[0] for c in csv if c[0] in DRIVER_LINES]
    require(names == DRIVER_LINES, f"the driver's lines: {names}")
    require(finite_leaves(results), "the driver: a non-finite metric")
    emit("driver", argv=["--quick"], seconds=driver_s,
         lines={c[0]: c[1:] for c in csv if c[0] in DRIVER_LINES}, nvidia_smi=card)

    # (d) the four examples at their own sizes ----------------------------------
    examples = {}
    for name, mod in (("quickstart", quickstart), ("topology_async_ablation",
                                                    topology_async_ablation),
                      ("cross_patient", cross_patient)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            got = mod.run([*EXAMPLES[name], "--device", DEV])
        examples[name] = dict(seconds=time.perf_counter() - t0, result=got)
        require(finite_leaves(got), f"example {name}: a non-finite metric: {got}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = serve_arch.main([*EXAMPLES["serve_arch"], "--device", DEV])
    require(rc == 0, f"example serve_arch exited {rc}")
    examples["serve_arch"] = dict(seconds=time.perf_counter() - t0, exit=rc)
    ablation = examples["topology_async_ablation"]["result"]
    ablation["val_rmse"] = {f"{t}@{r}": v for (t, r), v in ablation["val_rmse"].items()}
    emit("examples", argv=EXAMPLES, **examples, nvidia_smi=card)
    return dict(launches_fig4=fig4_counts["lstm_forward"],
                launches_fig5=fig5_counts["lstm_forward"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import load_federated_dataset
    from repro_torch.kernels import _build, lstm_cell
    from repro_torch.kernels.ref import lstm_forward_plain
    from repro_torch.launch.serve import build_request_stream, selfcheck
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import LSTMModel
    from repro_torch.serve import GlucoseServable, MicroBatcher, replay
    from repro_torch.utils.pytree import tree_to_vector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card ------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    compiled = _build.build()
    seconds = time.perf_counter() - t0
    libraries = ("gossip_mix", "lstm_forward", "swa_attention")
    require(all(_build.library_path(name).exists() for name in libraries),
            f"a kernel library is missing after the build (compiled {compiled})")
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in libraries}
    spills = [ln for ln in ptxas["lstm_forward"] if "spill" in ln]
    require(spills and all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
            f"an lstm_forward kernel spills: {spills}")
    staged_ptxas = ptxas_report(_build.build_log("gossip_mix"), "gossip_mix_staged_kernel")
    require(sum(k != "warnings" for k in staged_ptxas) == 3 and spill_free(staged_ptxas),
            f"a staged gossip kernel spills or is missing: {staged_ptxas}")
    emit("build", seconds=seconds, compiled=compiled, ptxas=ptxas)

    # 3. kernel vs plain -------------------------------------------------
    gen = torch.Generator().manual_seed(1234)
    errs = []
    for case in CASES:
        inputs = random_inputs(gen, *case)
        y = lstm_cell.lstm_forward(*inputs)
        ref = lstm_forward_plain(*inputs)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        require(y.shape == ref.shape == case[:2] and bool(torch.isfinite(y).all()),
                f"shape or finiteness at {case}")
        require(err <= TOL, f"kernel vs plain at {case}: {err}")
        errs.append(err)
        bitwise = None
        if case[0] == 64:
            row5 = lstm_cell.lstm_forward(*(t[5:6] for t in inputs))
            bitwise = bool(torch.equal(row5[0], y[5]))
            require(bitwise, f"row 5 at G=64 differs from its G=1 launch: {case}")
        group = None
        if case == SWEEP_EVAL:
            g = SWEEP_EVAL_GROUP
            one = lstm_cell.lstm_forward(*(t[g:g + 1] for t in inputs))
            require(torch.equal(one[0], y[g]), f"group {g} of the {case} launch differs from "
                                               f"its G=1 launch")
            group = g
        tiles = None
        if case == (1, 2034, 12, 1, 128):
            for r in TILE_ROWS:
                one = lstm_cell.lstm_forward(inputs[0][:, r:r + 1].contiguous(), *inputs[1:])
                require(torch.equal(one[0, 0], y[0, r]),
                        f"row {r} of the {case} launch differs from its R=1 launch")
            tiles = list(TILE_ROWS)
        emit("kernel", case=dict(zip("GRLIH", case)), plan=lstm_cell._plan(*case)._asdict(),
             max_abs_err=err, row5_bitwise_vs_g1=bitwise, rows_bitwise_vs_r1=tiles,
             group_bitwise_vs_g1=group)

    # 4. full-width serve (the main path) --------------------------------
    fed = load_federated_dataset("replace-bg", fast=True)
    lstm = LSTMModel(hidden=128)
    sv = GlucoseServable(lstm.as_model(), lstm.init(torch.Generator().manual_seed(0)),
                         buckets=(1, 4, 16, 64))

    class CountingBatcher(MicroBatcher):
        def complete(self, batch):
            batches.append(len(batch))
            super().complete(batch)

    batches: list[int] = []
    batcher = CountingBatcher(sv.buckets)
    reqs = build_request_stream(fed, sv, 4096, seed=0)
    reset_launches()
    t0 = time.perf_counter()
    sv.warmup(history_len=fed.x.shape[-1])
    preds = replay(sv, batcher, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_serve = lstm_cell.LAUNCHES
    require(launches_serve >= len(batches) > 0,
            f"{launches_serve} launches for {len(batches)} batches")
    require(sorted(preds) == list(range(len(reqs))), "a request went unanswered")
    served = torch.tensor([preds[r.rid] for r in reqs])
    require(bool(torch.isfinite(served).all()), "non-finite forecast")
    bad = selfcheck(sv, reqs, preds)
    require(bad == 0, f"{bad} served forecasts differ from the direct apply")
    plain_err = served_vs_plain(sv, reqs, preds)
    require(plain_err <= TOL, f"served vs plain twin: {plain_err}")
    errs.append(plain_err)
    stats = batcher.stats()
    emit("serve", dataset=fed.name, patients=fed.num_nodes, hidden=128,
         requests=len(reqs), batches=len(batches), full_batches=batches.count(64),
         launches=launches_serve, selfcheck_bitwise=len(reqs) - bad,
         max_abs_err_vs_plain=plain_err, wall_s=wall,
         p50_latency_ms=stats["p50_latency_ms"], p99_latency_ms=stats["p99_latency_ms"],
         forecasts_per_sec=stats["forecasts_per_sec"])

    # 5. narrow serve through the CLI ------------------------------------
    before = lstm_cell.LAUNCHES
    rc = serve_main(["--checkpoint", str(CKPT), "--requests", "256", "--selfcheck",
                     "--device", "cuda"])
    require(rc == 0, f"launch.serve --selfcheck exited {rc}")
    emit("narrow", checkpoint=str(CKPT.relative_to(ROOT)), requests=256,
         launches=lstm_cell.LAUNCHES - before, selfcheck="bitwise")

    # 6. timings at one serving batch: G=64, H=128, L=12 -----------------
    batch = reqs[:64]
    params = sv.params_rows([r.patient for r in batch])
    x = torch.tensor(np.stack([r.window for r in batch]), device="cuda")[:, None, :, None].contiguous()
    inputs = (x, params["wx"], params["wh"], params["b"], params["w_out"], params["b_out"])
    pop = sv.population
    flush = torch.zeros(64 * 2**20 // 4, device="cuda")  # 64 MB > the 50 MB L2
    shapes = {}
    for shape in LSTM_TIMED:
        if shape == LSTM_TIMED[0]:  # the batch's rows all hold the population
            args, weights, xs = inputs, [pop[k] for k in ("wx", "wh", "b", "w_out", "b_out")], x[:, 0]
        else:
            args = random_inputs(gen, *shape)
            weights, xs = [t[0] for t in args[1:]], args[0][0]
        library = cudnn_lstm(*weights)
        library_err = float((library(xs) - lstm_cell.lstm_forward(*args).reshape(-1)).abs().max())
        nbytes, ops = lstm_forward_cost(*args)
        bound_ms, bound_by = bound(nbytes, ops)
        ms = time_ms(lambda: lstm_cell.lstm_forward(*args), 200)
        shapes[shape] = dict(
            ms=ms, ms_l2_flushed=time_ms(lambda: lstm_cell.lstm_forward(*args), 200, flush),
            bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
            plain_ms=time_ms(lambda: lstm_forward_plain(*args), 50 if shape == LSTM_TIMED[0] else 20),
            library_ms=time_ms(lambda: library(xs), 200),
            library="torch.nn.LSTM (cuDNN) + nn.Linear", library_max_abs_err=library_err,
            bytes=nbytes, ops=ops, plan=lstm_cell._plan(*shape)._asdict())
        emit("timing", shape=dict(zip("GRLIH", shape)), **shapes[shape])
    serving, evaluation, split = (shapes[shape] for shape in LSTM_TIMED)
    lstm_row = dict(ms=serving["ms"], plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
                    bound_by=serving["bound_by"], library_ms=serving["library_ms"],
                    bound_share=serving["bound_share"], eval_ms=evaluation["ms"],
                    eval_bound_ms=evaluation["bound_ms"],
                    eval_bound_share=evaluation["bound_share"],
                    eval_library_ms=evaluation["library_ms"], test_split_ms=split["ms"],
                    test_split_bound_ms=split["bound_ms"], test_split_library_ms=split["library_ms"])

    # 7. where a served batch's time goes --------------------------------
    window = reqs[:1024]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        replay(sv, MicroBatcher(sv.buckets), window)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        replay(sv, MicroBatcher(sv.buckets), window)
        torch.cuda.synchronize()
    device = {}  # device-side kernels and copies: no host time of their own
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.self_cpu_time_total == 0 and us > 0:
            device[e.key] = (e.count, us)
    kernel = [v for k, v in device.items() if "lstm_forward_cluster_kernel" in k]
    require(kernel, "the profiler saw no lstm_forward kernel in the serving loop")
    busy_ms = sum(us for _, us in device.values()) / 1e3
    wall_ms = statistics.median(walls) * 1e3
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    emit("profile", requests=len(window), wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms,
         lstm_forward_us_per_launch=kernel[0][1] / kernel[0][0], launches=kernel[0][0],
         top_device=[{"name": k[:80], "count": n, "us": us} for k, (n, us) in top])

    # 8. gossip kernels vs plain -----------------------------------------
    from repro_torch.config import FLConfig
    from repro_torch.core import GluADFL
    from repro_torch.launch.train import run as train_run
    from repro_torch.launch.train import val_windows
    from repro_torch.optim import get_optimizer
    from repro_torch.serve import load_population

    from repro_torch.kernels import gossip_mix as gk

    gen = torch.Generator(device="cuda").manual_seed(4321)
    gossip_err: dict[str, float] = {}
    n_cases = 0
    designs: dict[str, list[str]] = {}  # each staged kernel's plan at each case

    def gossip_case(n, d, active_share, only=None) -> None:
        """Each kernel (or only the one named) at one case: within
        GOSSIP_TOL of its twin, two launches and inactive rows bitwise,
        a staged kernel bitwise its row-wise parent."""
        nonlocal n_cases
        w, z, act, mix, idx, wgt = gossip_inputs(gen, n, d, 1.0 - active_share)
        inactive = act == 0
        parents = rowwise_calls(w, z, act, mix, idx, wgt)
        for name, kernel, plain, args in gossip_calls(w, z, act, mix, idx, wgt):
            if only not in (None, name):
                continue
            out, again, want = kernel(*args), kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            where = f"{name} at N={n} D={d} active={active_share}"
            require(out.shape == w.shape, f"shape of {where}")
            require(err <= GOSSIP_TOL, f"{where} vs plain: {err}")
            require(torch.equal(out, again), f"{where}: two launches differ")
            require(torch.equal(out[inactive], w[inactive]), f"{where}: inactive rows")
            if name in parents:
                rowwise, parent_args = parents[name]
                parent = rowwise(*parent_args)
                require(torch.equal(out.view(torch.int32), parent.view(torch.int32)),
                        f"{where}: not bitwise the row-wise kernel")
                plan = gk._plan(name, n, idx.shape[1] if "sparse" in name else 0, d)
                designs.setdefault(name, []).append(f"{plan.design}/{plan.tile}")
            gossip_err[name] = max(gossip_err.get(name, 0.0), err)
        n_cases += 1

    for n in GOSSIP_NODES:
        for d in GOSSIP_COLS:
            for active_share in GOSSIP_RATIOS:
                gossip_case(n, d, active_share)
    # each staged kernel at the largest N it stages and the next (row-wise)
    limits = {}
    for name in gk.STAGED:
        slots = COMM_BATCH + 1 if "sparse" in name else 0
        limits[name] = staged_limit(name, slots)
        for n, design in ((limits[name], "staged"), (limits[name] + 1, "rowwise")):
            require(gk._plan(name, n, slots, 513).design == design, f"{name} at N={n}: plan")
            gossip_case(n, 513, 0.7, only=name)
    w, z, act, mix, idx, wgt = gossip_inputs(gen, 37, 513, 0.3)
    inactive = act == 0
    require(bool(inactive.any()) and bool((~inactive).any()), "NaN case needs both kinds of rows")
    w[int(torch.nonzero(~inactive)[0]), 5] = float("nan")
    for name, kernel, _, args in gossip_calls(w, z, act, mix, idx, wgt):
        out = kernel(*args)
        require(torch.equal(out[inactive], w[inactive]), f"{name}: NaN reached an inactive row")
    emit("gossip", cases=n_cases, kernels=4, max_abs_err=gossip_err, tol=GOSSIP_TOL,
         inactive_bitwise=True, nan_inactive_bitwise=True, repeat_bitwise=True,
         staged_bitwise_rowwise=True, staged_plans=designs, staged_limits=limits)

    # 9. training at full width, sparse then dense (the main path) -------
    out_dir = ROOT / "build" / "chip_smoke"
    feds, trained = {}, {}
    for dataset, repr_, name in (("replace-bg", "sparse", "gossip_mix_sparse"),
                                 ("ohiot1dm", "dense", "gossip_mix")):
        argv = ["--dataset", dataset, "--mixer", "kernel", "--hidden", "128",
                "--inactive-ratio", "0.3", "--rounds", str(TRAIN_ROUNDS),
                "--eval-every", str(EVAL_EVERY), "--fast-data", "--out", str(out_dir)]
        log = io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(log):
            run = train_run(argv)
        counts = launches()
        text = log.getvalue()
        n_nodes = run.trainer.cfg.num_nodes
        evals = TRAIN_ROUNDS // EVAL_EVERY
        require(f"gossip-repr auto -> {repr_}" in text, f"{dataset}: gossip-repr auto did not pick {repr_}")
        require(counts[name] == TRAIN_ROUNDS, f"{dataset}: {counts[name]} {name} launches in {TRAIN_ROUNDS} rounds")
        require(all(v == 0 for k, v in counts.items() if k not in (name, "lstm_forward")),
                f"{dataset}: another gossip kernel ran: {counts}")
        require(counts["lstm_forward"] == evals + n_nodes,
                f"{dataset}: {counts['lstm_forward']} lstm_forward launches, want {evals} evals + {n_nodes} patients")
        losses = [h["loss"] for h in run.history]
        vals = [h["val_rmse"] for h in run.history if "val_rmse" in h]
        require(len(losses) == TRAIN_ROUNDS and np.isfinite(losses).all(), f"{dataset}: losses")
        require(len(vals) == evals and np.isfinite(vals).all(), f"{dataset}: val RMSE records")
        first, last = float(np.mean(losses[:16])), float(np.mean(losses[-16:]))
        require(last < first, f"{dataset}: loss did not fall ({first} -> {last})")
        require(bool(torch.isfinite(tree_to_vector(run.population)).all()), f"{dataset}: population")
        fed = feds[dataset] = load_federated_dataset(dataset, fast=True)
        # the path's population forwards against the plain twin: the last
        # eval record is the trained population's, and the test forecasts
        # are one G=1 launch per patient
        pop_rows = {k: v[None] for k, v in run.population.items()}

        def plain(x):
            xs = torch.as_tensor(x, dtype=torch.float32, device="cuda")[None, :, :, None]
            return lstm_forward_plain(xs, pop_rows["wx"], pop_rows["wh"], pop_rows["b"],
                                      pop_rows["w_out"], pop_rows["b_out"])[0]

        vx, vy = val_windows(fed)
        val_plain = float(torch.sqrt(torch.mean(torch.square(
            plain(vx) - torch.as_tensor(vy, device="cuda")))))
        val_err = abs(val_plain - vals[-1])
        require(val_err <= TOL, f"{dataset}: val RMSE {vals[-1]} vs plain twin {val_plain}")
        test_err = 0.0
        for p in fed.patients:
            with torch.no_grad():
                got = run.trainer.model.apply(
                    run.population, torch.as_tensor(p.test_x, dtype=torch.float32, device="cuda"))
            test_err = max(test_err, float((got - plain(p.test_x)).abs().max()))
        require(test_err <= TOL, f"{dataset}: test forecasts vs plain twin: {test_err}")
        errs += [val_err, test_err]
        model, pop = load_population(run.checkpoint)
        served = GlucoseServable(model, pop, buckets=(1, 4, 16, 64))
        reqs = build_request_stream(fed, served, 256, seed=1)
        preds = replay(served, MicroBatcher(served.buckets), reqs)
        bad = selfcheck(served, reqs, preds)
        require(bad == 0 and all(math.isfinite(v) for v in preds.values()),
                f"{dataset}: {bad} forecasts from the checkpoint differ from a direct apply")
        # steady state: one 32-round chunk from a fresh state
        trainer = run.trainer
        chunk_gen = torch.Generator(device="cuda").manual_seed(1)
        state = trainer.init(chunk_gen)
        trainer.train(chunk_gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=2, state=state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(chunk_gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=32, chunk=32,
                      state=state)
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
        trained[dataset] = (run, counts)
        emit("train", dataset=dataset, nodes=n_nodes, hidden=128, gossip_repr=repr_,
             rounds=TRAIN_ROUNDS, launches=counts, loss_first16=first, loss_last16=last,
             val_rmse=vals, val_windows=len(vx), val_rmse_vs_plain_abs_err=val_err,
             test_forecasts_vs_plain_max_abs_err=test_err, rounds_per_s_whole_run=TRAIN_ROUNDS / run.seconds,
             rounds_per_s_32_round_chunk=32 / chunk_s, served_from_checkpoint=len(reqs),
             selfcheck="bitwise")

    # 10. the local-DP training path ---------------------------------------
    def trainer_for(dataset, repr_, mixer, sigma):
        return GluADFL(LSTMModel(hidden=128).as_model(), get_optimizer("adam", 1e-3),
                       FLConfig(num_nodes=feds[dataset].num_nodes, inactive_ratio=0.3),
                       mixer=mixer, gossip_repr=repr_, dp_noise_sigma=sigma)

    dp_counts = {}
    for dataset, repr_, name in (("replace-bg", "sparse", "gossip_mix_sparse_dp"),
                                 ("ohiot1dm", "dense", "gossip_mix_dp")):
        fed = feds[dataset]
        trainer = trainer_for(dataset, repr_, "kernel", 0.01)
        dp_gen = torch.Generator(device="cuda").manual_seed(2)
        reset_launches()
        _, hist, state = trainer.train(dp_gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=8)
        torch.cuda.synchronize()
        counts = launches()
        require(counts[name] == 8 and sum(counts.values()) == 8,
                f"DP {dataset}: launches {counts}, want 8 of {name}")
        require(all(math.isfinite(h["loss"]) for h in hist) and bool(torch.isfinite(state.params).all()),
                f"DP {dataset}: non-finite training")
        dp_counts[name] = counts[name]
        emit("dp", dataset=dataset, gossip_repr=repr_, sigma=0.01, rounds=8, launches=counts,
             losses=[h["loss"] for h in hist])

    # 11. one state, one round's draws, two mixers -----------------------
    for dataset, repr_ in (("replace-bg", "sparse"), ("ohiot1dm", "dense")):
        fed = feds[dataset]
        for sigma in (0.0, 0.01):
            tk = trainer_for(dataset, repr_, "kernel", sigma)
            tt = trainer_for(dataset, repr_, "tree", sigma)
            mix_gen = torch.Generator(device="cuda").manual_seed(3)
            state = tk.init(mix_gen)
            data = tk.to_device(fed.x, fed.y, fed.counts)
            draws = tk.draw(mix_gen, data, 64)
            after_k, loss_k = tk.round(state, data, draws)
            after_t, loss_t = tt.round(state, data, draws)
            active, operand, _ = tk.mixing_operator(state, draws)
            noise = sigma * draws.dp_noise if sigma else None
            mixed_err = float((tk.plan.gossip(state.params, operand, active, noise)
                               - tt.plan.gossip(state.params, operand, active, noise)).abs().max())
            require(mixed_err <= GOSSIP_TOL, f"{dataset} sigma={sigma}: kernel vs tree mix {mixed_err}")
            inactive = active == 0
            require(torch.equal(after_k.params[inactive], state.params[inactive]),
                    f"{dataset} sigma={sigma}: inactive rows moved")
            emit("mixers", dataset=dataset, gossip_repr=repr_, sigma=sigma,
                 mixed_max_abs_diff=mixed_err,
                 params_after_round_max_abs_diff=float((after_k.params - after_t.params).abs().max()),
                 loss_kernel=float(loss_k), loss_tree=float(loss_t))

    # 12. gossip kernel timings at the main-path shapes -------------------
    timing_gen = torch.Generator(device="cuda").manual_seed(5)
    d_main = trained["replace-bg"][0].trainer.layout.dim
    main_inputs = {"sparse": gossip_inputs(timing_gen, 226, d_main, 0.3),
                   "dense": gossip_inputs(timing_gen, 12, d_main, 0.3)}
    gossip_rows = {}
    for name in ("gossip_mix", "gossip_mix_sparse", "gossip_mix_dp", "gossip_mix_sparse_dp"):
        w, z, act, mix, idx, wgt = main_inputs["sparse" if "sparse" in name else "dense"]
        _, kernel, plain, args = next(c for c in gossip_calls(w, z, act, mix, idx, wgt) if c[0] == name)
        library = gossip_library(name, w, z, act, mix, idx, wgt)
        library_err = float((library() - kernel(*args)).abs().max())
        nbytes, ops = gossip_cost(name, w, act, idx)
        row = dict(ms=time_ms(lambda: kernel(*args), 200),
                   plain_ms=time_ms(lambda: plain(*args), 20),
                   library_ms=time_ms(library, 100))
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        extra = dict(ms_l2_flushed=time_ms(lambda: kernel(*args), 100, flush))
        parents = rowwise_calls(w, z, act, mix, idx, wgt)
        if name in parents:  # in turns with the row-wise parent: parent, kernel, kernel, parent
            rowwise, parent_args = parents[name]
            turns, flushed = [], []
            for fn in (lambda: rowwise(*parent_args), lambda: kernel(*args),
                       lambda: kernel(*args), lambda: rowwise(*parent_args)):
                turns.append(time_ms(fn, 200))
                flushed.append(time_ms(fn, 100, flush))
            row["parent_ms"] = statistics.median([turns[0], turns[3]])
            row["parent_ms_l2_flushed"] = statistics.median([flushed[0], flushed[3]])
            extra["parent_device_us"] = device_us(lambda: rowwise(*parent_args))
            slots = idx.shape[1] if "sparse" in name else 0
            extra.update(turns_ms=turns, turns_ms_l2_flushed=flushed,
                         plan=gk._plan(name, w.shape[0], slots, w.shape[1])._asdict())
        extra["device_us"] = device_us(lambda: kernel(*args))
        if name == "gossip_mix_sparse_dp":  # the same bytes as one contiguous stream
            extra["contiguous_stream_ms"] = time_ms(lambda: torch.add(w, z), 100)
        if name == "gossip_mix_dp":
            extra["tiles"] = dp_tile_sweep(w, z, act, mix, kernel(*args))
        gossip_rows[name] = row
        emit("gtiming", kernel=name, nodes=w.shape[0], cols=w.shape[1], slots=idx.shape[1],
             active=int(act.sum()), library_max_abs_err=library_err, bytes=nbytes, ops=ops,
             **extra, **row)

    # 13. where a training round's time goes (sparse, N=226, H=128) ------
    run, _ = trained["replace-bg"]
    trainer, fed = run.trainer, feds["replace-bg"]
    prof_gen = torch.Generator(device="cuda").manual_seed(6)
    state = trainer.init(prof_gen)
    chunk_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, state = trainer.train(prof_gen, fed.x, fed.y, fed.counts, batch_size=64,
                                    rounds=8, chunk=8, state=state)
        torch.cuda.synchronize()
        chunk_walls.append(time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        trainer.train(prof_gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=8, chunk=8,
                      state=state)
        torch.cuda.synchronize()
    by_span, gemm_by_span, busy_ms, device_items = span_breakdown(prof)
    # an estimate, not a count: the local step's matmul operations a
    # round, h @ wh and x @ wx for each of L steps over N nodes x B
    # windows, once forward and taken as twice that backward (the
    # elementwise work and the head are not counted)
    hsz, steps = 128, fed.x.shape[-1]
    local_ops = 3 * 2 * fed.num_nodes * 64 * steps * (hsz + 1) * 4 * hsz
    local_gemm_ms = gemm_by_span["round.local_step"]
    require(by_span["round.gossip"] > 0 and by_span["round.local_step"] > 0,
            f"the profile saw no gossip or local-step work: {by_span}")
    wall_ms = statistics.median(chunk_walls) * 1e3
    emit("tprofile", dataset="replace-bg", nodes=fed.num_nodes, hidden=128, rounds=8,
         wall_ms=wall_ms, rounds_per_s=8e3 / wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms, host_ms=wall_ms - busy_ms, device_ms_by_span=by_span,
         device_items_per_round=device_items / 8, gemm_device_ms_by_span=gemm_by_span,
         local_step_est_matmul_ops_per_round=local_ops,
         local_step_est_tflop_per_s_over_span=local_ops * 8 / (by_span["round.local_step"] * 1e-3) / 1e12,
         local_step_est_tflop_per_s_over_gemm=(local_ops * 8 / (local_gemm_ms * 1e-3) / 1e12
                                               if local_gemm_ms else None))

    # 14. swa_attention against its twin ----------------------------------
    import dataclasses

    from repro_torch.arch import build_arch
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa_kernel
    from repro_torch.nn import attention as attn

    swa_log = _build.build_log("swa_attention")
    swa_ptxas = ptxas_report(swa_log, "wgmma")
    require(swa_ptxas, "no ptxas report of the bf16 swa_attention kernel")
    # the scalar builds: fp32 at hd 64 and 128, fp32 and bf16 at hd 256
    # (also the chunked head dims above it)
    scalar_ptxas = ptxas_report(swa_log, "swa_attention_kernelI")
    require(sum(k != "warnings" for k in scalar_ptxas) == 4 and spill_free(scalar_ptxas),
            f"a scalar swa_attention kernel spills or is missing: {scalar_ptxas}")
    for name, lines in {**swa_ptxas, **scalar_ptxas}.items():
        print(f"ptxas {name}: " + " | ".join(lines), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(77)
    swa_err = {str(dtype): 0.0 for dtype in SWA_TOL}
    bf16_over_bound = 0.0  # the sweep's largest |bf16 - fp32 twin| / swa_bf16_bound
    n_swa = 0

    def swa_case(b, s, h, kh, hd, window, dtype):
        """One case against the twin: within SWA_TOL, two launches bitwise
        equal, bf16 elementwise within swa_bf16_bound."""
        nonlocal bf16_over_bound, n_swa
        q, k, v = swa_inputs(gen, b, s, h, kh, hd, dtype)
        out = swa_kernel.swa_attention(q, k, v, window=window)
        again = swa_kernel.swa_attention(q, k, v, window=window)
        want = ref.swa_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        where = f"swa_attention B={b} S={s} H={h} K={kh} hd={hd} w={window} {dtype}"
        require(out.shape == q.shape and out.dtype == dtype, f"shape of {where}")
        require(err <= SWA_TOL[dtype], f"{where} vs plain: {err}")
        require(torch.equal(out, again), f"{where}: two launches differ")
        if dtype == torch.bfloat16:
            o32 = ref.swa_attention_plain(q.float(), k.float(), v.float(), window=window)
            ratio = float(((out.float() - o32).abs()
                           / ref.swa_bf16_bound(q, k, v, window=window)).max())
            require(ratio <= 1.0, f"{where} vs swa_bf16_bound: {ratio}")
            bf16_over_bound = max(bf16_over_bound, ratio)
        swa_err[str(dtype)] = max(swa_err[str(dtype)], err)
        n_swa += 1

    for s in SWA_SEQS:
        for window in SWA_WINDOWS:
            for hd in (64, 128):
                for h, kh in ((4, 4), (12, 1)):
                    for b in (1, 2):
                        for dtype in SWA_TOL:
                            swa_case(b, s, h, kh, hd, window, dtype)
    n_narrow = n_swa
    for s in SWA_WIDE["seqs"]:
        for window in SWA_WIDE["windows"]:
            for hd in SWA_WIDE["hds"]:
                for h, kh in ((4, 4), (12, 1)):
                    for dtype in SWA_TOL:
                        swa_case(1, s, h, kh, hd, window, dtype)
    # RecurrentGemma-9B's local attention at full width, at its hd 256 and
    # at two wider ones (288 padded to 512; 512), against the fp32 banded
    # path: the fp32 kernel within the fp32 bound, bf16 elementwise
    # within swa_bf16_bound (given the banded path); timed at HYBRID_TIMED
    rg_cfg = get_arch_config(HYBRID_ARCH)
    rg_window = rg_cfg.local_attn_window
    rg_shape = dict(B=1, S=HYBRID_SEQ, H=rg_cfg.num_heads, K=rg_cfg.num_kv_heads,
                    hd=rg_cfg.head_dim, window=rg_window)
    hybrid = {}
    for hd in HYBRID_HDS:
        q, k, v = swa_inputs(gen, 1, HYBRID_SEQ, rg_cfg.num_heads, rg_cfg.num_kv_heads, hd,
                             torch.float32)
        banded = attn.banded_flash_attention(q, k, v, window=rg_window)
        rg_out = swa_kernel.swa_attention(q, k, v, window=rg_window)
        rg_err = {"fp32_max_abs_err": float((rg_out - banded).abs().max())}
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        rg_out = swa_kernel.swa_attention(qb, kb, vb, window=rg_window)
        banded = attn.banded_flash_attention(qb.float(), kb.float(), vb.float(), window=rg_window)
        limit = ref.swa_bf16_bound(qb, kb, vb, window=rg_window,
                                   attention=attn.banded_flash_attention)
        rg_err["bf16_max_abs_err"] = float((rg_out.float() - banded).abs().max())
        rg_err["bf16_max_err_over_bound"] = float(((rg_out.float() - banded).abs() / limit).max())
        del rg_out, banded, limit
        require(rg_err["fp32_max_abs_err"] <= SWA_TOL[torch.float32],
                f"swa_attention (fp32) at {HYBRID_ARCH}'s shape, hd {hd}, vs the banded path: "
                f"{rg_err}")
        require(rg_err["bf16_max_err_over_bound"] <= 1.0,
                f"swa_attention (bf16) at {HYBRID_ARCH}'s shape, hd {hd}, vs the banded path: "
                f"{rg_err}")
        if hd in HYBRID_TIMED:
            rg_err["fp32"] = swa_timing(q, k, v, rg_window, FP32_OPS_PER_S)
            rg_err["bf16"] = swa_timing(qb, kb, vb, rg_window, BF16_OPS_PER_S)
        hybrid[str(hd)] = rg_err
        del q, k, v, qb, kb, vb
    lm_cfg = get_arch_config(LM_ARCH)
    heads, kv_heads, head_dim, window = (lm_cfg.num_heads, lm_cfg.num_kv_heads, lm_cfg.head_dim,
                                         lm_cfg.sliding_window)
    seq = 32_768  # SHAPES["prefill_32k"]
    q, k, v = swa_inputs(gen, 1, seq, heads, kv_heads, head_dim, torch.bfloat16)
    out = swa_kernel.swa_attention(q, k, v, window=window)
    again = swa_kernel.swa_attention(q, k, v, window=window)
    require(bool(torch.isfinite(out).all()), "swa_attention at the prefill's shape: non-finite")
    require(torch.equal(out, again), "swa_attention at the prefill's shape: two launches differ")
    # the plain banded path in fp32 on the same inputs: the kernel's fp32
    # build within the fp32 bound, its bf16 build elementwise within
    # swa_bf16_bound (the rounding of P and of the output); then the banded
    # path as JAX runs it in bf16 (scores and probabilities rounded to
    # bf16), at JAX's bf16 bound
    q32, k32, v32 = q.float(), k.float(), v.float()
    banded = attn.banded_flash_attention(q32, k32, v32, window=window)
    out32 = swa_kernel.swa_attention(q32, k32, v32, window=window)
    fp32_err = float((out32 - banded).abs().max())
    del out32, q32, k32, v32
    diff = (out.float() - banded).abs()
    path_err = {"fp32_max_abs_err": fp32_err, "bf16_max_abs_err": float(diff.max()),
                "ref_mean_abs": float(banded.abs().mean())}
    del banded
    limit = ref.swa_bf16_bound(q, k, v, window=window, attention=attn.banded_flash_attention)
    path_err["bf16_max_err_over_bound"] = float((diff / limit).max())
    del diff, limit
    require(fp32_err <= SWA_TOL[torch.float32],
            f"swa_attention (fp32) at the prefill's shape vs the fp32 banded path: {fp32_err}")
    require(path_err["bf16_max_err_over_bound"] <= 1.0,
            f"swa_attention (bf16) at the prefill's shape vs the fp32 banded path: {path_err}")
    banded = attn.banded_flash_attention(q, k, v, window=window)
    path_err["bf16_vs_bf16_banded_max_abs_err"] = float((out.float() - banded.float()).abs().max())
    del banded, out, again
    require(path_err["bf16_vs_bf16_banded_max_abs_err"] <= SWA_TOL[torch.bfloat16],
            f"swa_attention at the prefill's shape vs the bf16 banded path: {path_err}")
    emit("swa", ptxas=swa_ptxas, ptxas_scalar=scalar_ptxas, cases=n_swa,
         cases_wide_hd=n_swa - n_narrow, wide_hds=SWA_WIDE["hds"], max_abs_err=swa_err,
         tol={str(d): t for d, t in SWA_TOL.items()}, sweep_bf16_max_err_over_bound=bf16_over_bound,
         repeat_bitwise=True, path_shape=dict(B=1, S=seq, H=heads, K=kv_heads, hd=head_dim,
                                               window=window),
         path_vs_fp32_banded=path_err, hybrid_arch=HYBRID_ARCH, hybrid_shape=rg_shape,
         hybrid_vs_fp32_banded=hybrid,
         bf16_bound="swa_bf16_bound: 2^-8 (|o32| + (P|v|)/l) + 3e-5")

    # 15. the LM prefill and decode at full width (the main path) ----------
    cfg = dataclasses.replace(lm_cfg, num_layers=LM_LAYERS)
    arch = build_arch(cfg)
    t0 = time.perf_counter()
    params = arch.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    spec = arch.input_specs("prefill_32k", override_batch=1)["tokens"]
    tokens = torch.randint(0, cfg.vocab_size, tuple(spec.shape), dtype=spec.dtype, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    prompt = {"tokens": tokens}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    branches_before = dict(attn.BRANCHES)
    t0 = time.perf_counter()
    logits, caches = arch.prefill_fn(params, prompt)
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    lm_counts = launches()
    taken = {name: attn.BRANCHES[name] - branches_before[name] for name in attn.BRANCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(lm_counts["swa_attention"] == LM_LAYERS,
            f"{lm_counts['swa_attention']} swa_attention launches in a {LM_LAYERS}-layer prefill")
    require(sum(lm_counts.values()) == LM_LAYERS, f"another kernel ran in the prefill: {lm_counts}")
    require(taken == {"plain": 0, "flash": 0, "banded": LM_LAYERS}, f"attention branches {taken}")
    vocab_padded = params["lm_head"].shape[1]
    require(tuple(logits.shape) == (1, 1, vocab_padded) and bool(torch.isfinite(logits).all()),
            f"prefill logits {tuple(logits.shape)} or non-finite")
    cache_shape = (LM_LAYERS, 1, window, kv_heads, head_dim)
    require(tuple(caches.k.shape) == cache_shape and tuple(caches.v.shape) == cache_shape,
            f"caches {tuple(caches.k.shape)}, want {cache_shape}")
    require(bool((caches.pos == seq).all()), f"cache positions {caches.pos.tolist()}")
    decoded = []
    state = caches
    step_logits = logits
    for t in range(LM_DECODE_STEPS):
        tok = torch.argmax(step_logits[:, -1, :cfg.vocab_size], dim=-1)[:, None].to(torch.int32)
        decoded.append(int(tok))
        step_logits, state = arch.decode_fn(params, state, {"token": tok, "pos": seq + t})
        require(bool(torch.isfinite(step_logits).all()), f"decode step {t}: non-finite logits")
    torch.cuda.synchronize()
    require(launches()["swa_attention"] == LM_LAYERS, "decode launched swa_attention")

    # the slice held as a whole: card (kernel) against CPU (twin), fp32
    small = dataclasses.replace(lm_cfg.reduced(), sliding_window=1024)
    small_arch = build_arch(small)
    cpu_params = small_arch.init_params(torch.Generator().manual_seed(2))
    gpu_params = {key: ({n: t.cuda() for n, t in val.items()} if isinstance(val, dict) else val.cuda())
                  for key, val in cpu_params.items()}
    small_tokens = torch.randint(0, small.vocab_size, (1, 3072), dtype=torch.int32,
                                 generator=torch.Generator().manual_seed(3))
    before = swa_kernel.LAUNCHES
    g_logits, g_cache = small_arch.prefill_fn(gpu_params, {"tokens": small_tokens.cuda()})
    require(swa_kernel.LAUNCHES - before == small.num_layers, "the reduced prefill missed the kernel")
    c_logits, c_cache = small_arch.prefill_fn(cpu_params, {"tokens": small_tokens})
    slice_err = {"logits": float((g_logits.cpu() - c_logits).abs().max()),
                 "caches": max(float((g_cache.k.cpu() - c_cache.k).abs().max()),
                               float((g_cache.v.cpu() - c_cache.v).abs().max()))}
    for t in range(4):  # both sides fed the card's greedy tokens
        tok = torch.argmax(g_logits[:, -1, :small.vocab_size], dim=-1)[:, None].to(torch.int32)
        g_logits, g_cache = small_arch.decode_fn(gpu_params, g_cache, {"token": tok, "pos": 3072 + t})
        c_logits, c_cache = small_arch.decode_fn(cpu_params, c_cache, {"token": tok.cpu(), "pos": 3072 + t})
        slice_err["logits"] = max(slice_err["logits"], float((g_logits.cpu() - c_logits).abs().max()))
    slice_err["caches"] = max(slice_err["caches"], float((g_cache.k.cpu() - c_cache.k).abs().max()),
                              float((g_cache.v.cpu() - c_cache.v).abs().max()))
    for key, tol in LM_SLICE_TOL.items():
        require(slice_err[key] <= tol, f"reduced slice, card vs CPU {key}: {slice_err[key]}")
    demo = subprocess.run([sys.executable, "-m", "repro_torch.launch.arch_demo", "--arch", LM_ARCH,
                           "--tokens", "8"], capture_output=True, text=True, cwd=ROOT, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    require(demo.returncode == 0, f"arch_demo exited {demo.returncode}: {demo.stderr[-2000:]}")
    emit("lmprefill", arch=LM_ARCH, d_model=cfg.d_model, heads=heads, kv_heads=kv_heads,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, window=window, layers=LM_LAYERS, params=n_params,
         dtype=cfg.dtype, reduced={"num_layers": f"88->{LM_LAYERS}", "batch": "32->1"},
         prompt=seq, launches=lm_counts, branches=taken, logits_shape=list(logits.shape),
         cache_shape=list(cache_shape), init_s=init_s, first_prefill_s=prefill_first_s,
         peak_memory_gb=peak_gb, decode_steps=LM_DECODE_STEPS, decoded_tokens=decoded,
         slice_card_vs_cpu=slice_err, slice_tol=LM_SLICE_TOL,
         arch_demo=demo.stdout.strip().splitlines()[-2:])

    # 16. the kernel and the prefill timed at the path's shape --------------
    swa_call = lambda: swa_kernel.swa_attention(q, k, v, window=window)  # noqa: E731
    library = band_sdpa(q, k, v, window)
    library_err = float((library().transpose(1, 2).float() - swa_call().float()).abs().max())
    swa_ms = time_ms(swa_call, 20)
    swa_plain_ms = time_ms(lambda: attn.banded_flash_attention(q, k, v, window=window), 5, warmup=1)
    swa_library_ms = time_ms(library, 10, warmup=2)
    nbytes, ops = swa_cost(q, k, window)
    swa_bound_ms, swa_bound_by = bound(nbytes, ops, BF16_OPS_PER_S)
    swa_row = dict(ms=swa_ms, plain_ms=swa_plain_ms, bound_ms=swa_bound_ms, bound_by=swa_bound_by,
                   library_ms=swa_library_ms, tflop_per_s=ops / (swa_ms * 1e-3) / 1e12,
                   bound_share=swa_bound_ms / swa_ms)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arch.prefill_fn(params, prompt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        arch.prefill_fn(params, prompt)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    split = {"swa_attention": 0.0, "gemm": 0.0, "other": 0.0}
    top: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.self_cpu_time_total != 0 or us <= 0:
            continue
        name = e.key.lower()
        kind = ("swa_attention" if "swa_attention_kernel" in name
                else "gemm" if any(g in name for g in GEMM_NAMES) else "other")
        split[kind] += us / 1e3
        top[e.key[:80]] = us / 1e3
    require(split["swa_attention"] > 0, f"the profiler saw no swa_attention kernel: {split}")
    decode_walls = []
    state = caches
    tok = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    for t in range(LM_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = arch.decode_fn(params, state, {"token": tok, "pos": seq + t})
        torch.cuda.synchronize()
        decode_walls.append(time.perf_counter() - t0)
    prefill_s = statistics.median(walls)
    busy_ms = sum(split.values())
    emit("lmtiming", kernel="swa_attention", shape=dict(B=1, S=seq, H=heads, K=kv_heads, hd=head_dim,
                                                         window=window, dtype="bfloat16"),
         bytes=nbytes, ops=ops, bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
         bound_bf16_ops_ms=ops / BF16_OPS_PER_S * 1e3, bound_fp32_ops_ms=ops / FP32_OPS_PER_S * 1e3,
         library="scaled_dot_product_attention, band mask, per 1024-row query block, KV repeated",
         library_max_abs_err=library_err, **swa_row,
         prefill_wall_s=prefill_s, prefill_walls_s=walls, prefill_tokens_per_s=seq / prefill_s,
         prefill_device_ms=split, profiled_prefill_wall_s=profiled_s,
         prefill_device_busy_share=busy_ms / (profiled_s * 1e3),
         prefill_top_device_ms=dict(sorted(top.items(), key=lambda kv: -kv[1])[:8]),
         decode_step_ms_median=statistics.median(decode_walls) * 1e3,
         decode_steps_per_s=1 / statistics.median(decode_walls), nvidia_smi=card)

    # 17. cold-start personalization, then serving (the main path) ---------
    from repro_torch.core import personalize, personalize_loop
    from repro_torch.launch.serve import personalize_cohort
    from repro_torch.utils.rng import draw_personalize

    fed = feds["replace-bg"]
    lstm = LSTMModel(hidden=128)
    sv = GlucoseServable(lstm.as_model(), lstm.init(torch.Generator().manual_seed(0)),
                         buckets=(1, 4, 16, 64))
    steps, m = sv.personalize_steps, PERSONALIZE_WINDOWS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cohort = personalize_cohort(sv, fed, PERSONALIZE_COHORT, m, seed=0)  # ends in a sync
    tune_s = time.perf_counter() - t0
    # the same call again on a fresh store, profiled: where a step's time goes
    again = GlucoseServable(sv.model, sv.population, buckets=sv.buckets)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            personalize_cohort(again, fed, PERSONALIZE_COHORT, m, seed=0)
        tune_profiled_s = time.perf_counter() - t0
    require(torch.equal(again.personalize_losses, sv.personalize_losses),
            "two fine-tunes of one cohort from one seed differ")
    tune_busy, tune_gemm, tune_items = 0.0, 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.self_cpu_time_total == 0 and us > 0:
            tune_busy += us / 1e3
            tune_items += e.count
            if any(g in e.key.lower() for g in GEMM_NAMES):
                tune_gemm += us / 1e3
    losses = sv.personalize_losses.cpu()
    require(tuple(losses.shape) == (PERSONALIZE_COHORT, steps) and bool(torch.isfinite(losses).all()),
            f"fine-tune losses {tuple(losses.shape)} or non-finite")
    first10, last10 = losses[:, :10].mean(dim=1), losses[:, -10:].mean(dim=1)
    require(bool((last10 < first10).all()),
            f"a patient's loss did not fall: {(last10 >= first10).nonzero()[:, 0].tolist()}")
    require(sv.num_rows == 1 + PERSONALIZE_COHORT and
            [sv.row_of(pi) for pi in cohort] == list(range(1, 1 + PERSONALIZE_COHORT)),
            "the cohort's store rows")
    # the engines, for the cohort's first patient: the draws the servable's
    # call made (the same seeded generator), its batched row, personalize
    # and personalize_loop
    counts = [min(m, len(fed.patients[pi].train_x)) for pi in cohort]
    batch_idx = draw_personalize(torch.Generator(device="cuda").manual_seed(0), counts, m, steps,
                                 sv.personalize_batch_size)
    patient = fed.patients[cohort[0]]
    px = np.zeros((m, fed.x.shape[-1]), np.float32)
    py = np.zeros((m,), np.float32)
    px[:counts[0]], py[:counts[0]] = patient.train_x[:counts[0]], patient.train_y[:counts[0]]
    one = personalize(sv.model, sv.optimizer, sv.population, batch_idx[0], px, py)
    loop = personalize_loop(sv.model, sv.optimizer, sv.population, batch_idx[0], px, py)
    require(all(torch.equal(one[k], loop[k]) for k in one), "personalize != personalize_loop")
    batched = sv.params_rows([1])
    row_diff = max(float((batched[k][0] - one[k]).abs().max()) for k in one)
    row_bitwise = all(torch.equal(batched[k][0], one[k]) for k in one)
    require(row_diff <= PERSONALIZE_ROW_TOL, f"personalize vs its batched row: {row_diff}")
    batches = []
    batcher = CountingBatcher(sv.buckets)
    reqs = build_request_stream(fed, sv, 4096, seed=2)
    personalized_reqs = sum(r.patient > 0 for r in reqs)
    require(personalized_reqs > 0, "no request reached a personalized row")
    reset_launches()
    sv.warmup(history_len=fed.x.shape[-1])
    preds = replay(sv, batcher, reqs)
    torch.cuda.synchronize()
    launches_personalize = launches()
    require(launches_personalize["lstm_forward"] >= len(batches) > 0 and
            sum(launches_personalize.values()) == launches_personalize["lstm_forward"],
            f"{launches_personalize} launches for {len(batches)} batches")
    require(sorted(preds) == list(range(len(reqs))), "a request went unanswered")
    bad = selfcheck(sv, reqs, preds)
    require(bad == 0, f"{bad} served forecasts differ from the direct apply")
    plain_err = served_vs_plain(sv, reqs, preds)
    require(plain_err <= TOL, f"served (personalized) vs plain twin: {plain_err}")
    errs.append(plain_err)
    stats = batcher.stats()
    with contextlib.redirect_stdout(io.StringIO()) as cli_log:
        rc = serve_main(["--checkpoint", str(CKPT), "--personalize", "4", "--requests", "256",
                         "--selfcheck", "--device", "cuda"])
    require(rc == 0, f"launch.serve --personalize 4 --selfcheck exited {rc}")
    cli_lines = [ln for ln in cli_log.getvalue().splitlines()
                 if ln.startswith(("personalized", "selfcheck"))]
    emit("personalize", dataset=fed.name, patients=fed.num_nodes, hidden=128,
         cohort=PERSONALIZE_COHORT, history_windows=m, steps=steps,
         batch=min(sv.personalize_batch_size, m), optimizer="adam 5e-4",
         fine_tune_s=tune_s, fine_tune_ms_per_step=tune_s * 1e3 / steps,
         fine_tune_patients_per_s=PERSONALIZE_COHORT / tune_s,
         profiled_fine_tune_s=tune_profiled_s, fine_tune_device_busy_ms=tune_busy,
         fine_tune_device_busy_share=tune_busy / (tune_profiled_s * 1e3),
         fine_tune_gemm_device_ms=tune_gemm, fine_tune_device_items_per_step=tune_items / steps,
         loss_first10_mean=float(first10.mean()), loss_last10_mean=float(last10.mean()),
         loss_fell_every_patient=True, personalize_vs_loop="bitwise",
         personalize_vs_batched_row_bitwise=row_bitwise,
         personalize_vs_batched_row_max_abs_diff=row_diff, requests=len(reqs),
         personalized_requests=personalized_reqs, batches=len(batches),
         launches=launches_personalize, selfcheck_bitwise=len(reqs) - bad,
         max_abs_err_vs_plain=plain_err, p50_latency_ms=stats["p50_latency_ms"],
         p99_latency_ms=stats["p99_latency_ms"], forecasts_per_sec=stats["forecasts_per_sec"],
         cli=cli_lines, nvidia_smi=card)

    # 18. masked training at full width (the main path) -----------------
    from repro_torch.core.gossip import gossip_mix_sparse_tree
    from repro_torch.core.secure_agg import edge_mask_source, simulate_wires

    masked_counts: dict[str, int] = {}
    for dataset, repr_ in (("replace-bg", "sparse"), ("ohiot1dm", "dense")):
        fed = feds[dataset]
        for sigma in (0.0, 0.01):
            name = {("sparse", False): "gossip_mix_sparse", ("dense", False): "gossip_mix",
                    ("sparse", True): "gossip_mix_sparse_dp", ("dense", True): "gossip_mix_dp"}[
                        (repr_, sigma > 0)]
            runs = {}
            for impl in ("allgather", "masked"):
                trainer = GluADFL(LSTMModel(hidden=128).as_model(), get_optimizer("adam", 1e-3),
                                  FLConfig(num_nodes=fed.num_nodes, inactive_ratio=0.3),
                                  mixer="kernel", gossip_impl=impl, gossip_repr=repr_,
                                  dp_noise_sigma=sigma)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                _, hist, state = trainer.train(torch.Generator(device="cuda").manual_seed(8),
                                               fed.x, fed.y, fed.counts, batch_size=64,
                                               rounds=MASKED_ROUNDS, chunk=MASKED_ROUNDS)
                torch.cuda.synchronize()
                counts = launches()
                require(counts[name] == MASKED_ROUNDS and sum(counts.values()) == MASKED_ROUNDS,
                        f"{impl} {dataset} sigma={sigma}: launches {counts}, want "
                        f"{MASKED_ROUNDS} of {name}")
                require(all(math.isfinite(h["loss"]) for h in hist), f"{impl} {dataset}: losses")
                runs[impl] = (trainer, hist, state, counts,
                              torch.cuda.max_memory_allocated() / 1e9)
            (ta, ha, a, _, peak_a), (tb, hb, b, counts, peak_b) = runs["allgather"], runs["masked"]
            require(ha == hb and torch.equal(a.params, b.params) and
                    all(torch.equal(a.opt_state[k], b.opt_state[k]) for k in a.opt_state),
                    f"{dataset} sigma={sigma}: masked training is not bitwise unmasked")
            masked_counts[name] = counts[name]
            # steady state, in turns (unmasked, masked, masked, unmasked), from each
            # run's state, with the round generator carried on
            walls = {"allgather": [], "masked": []}
            for impl in ("allgather", "masked", "masked", "allgather"):
                trainer, _, state, _, _ = runs[impl]
                gen = torch.Generator(device="cuda").manual_seed(9)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train(gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=MASKED_ROUNDS,
                              chunk=MASKED_ROUNDS, state=state)
                torch.cuda.synchronize()
                walls[impl].append(time.perf_counter() - t0)
            with torch.profiler.profile(activities=activities) as prof:
                tb.train(torch.Generator(device="cuda").manual_seed(9), fed.x, fed.y, fed.counts,
                         batch_size=64, rounds=MASKED_ROUNDS, chunk=MASKED_ROUNDS, state=b)
                torch.cuda.synchronize()
            mask_busy, _, busy_ms, _ = span_breakdown(prof, MASK_SPANS)
            require(mask_busy["round.secure_mask"] > 0, "the profile saw no secure_mask work")
            emit("masked", dataset=dataset, nodes=fed.num_nodes, hidden=128, gossip_repr=repr_,
                 sigma=sigma, rounds=MASKED_ROUNDS, kernel=name, launches=counts,
                 bitwise_params_opt_state_history=True,
                 pairs=math.comb(ta.cfg.comm_batch + 1, 2),
                 rounds_per_s_unmasked=[MASKED_ROUNDS / w for w in walls["allgather"]],
                 rounds_per_s_masked=[MASKED_ROUNDS / w for w in walls["masked"]],
                 secure_mask_device_ms_per_round=mask_busy["round.secure_mask"] / MASKED_ROUNDS,
                 device_busy_ms_per_round_masked=busy_ms / MASKED_ROUNDS,
                 peak_memory_gb_unmasked=peak_a, peak_memory_gb_masked=peak_b, nvidia_smi=card)
    # the wires at N=37: no valid slot of a row with >= 2 of them sends its raw
    # row, and the books balance against the sparse mix
    wire_gen = torch.Generator(device="cuda").manual_seed(10)
    w, _, act, _, idx, wgt = gossip_inputs(wire_gen, WIRES_NODES, d_main, 0.3)
    masks = edge_mask_source(wire_gen, d_main)(idx, wgt)
    wires = simulate_wires(w, idx, wgt, masks)
    valid = wgt > 0
    raw = (wires == w[idx.long()]).all(dim=-1)
    guarded = valid & (valid.sum(dim=1, keepdim=True) >= 2)
    require(bool(guarded.any()) and not bool((raw & guarded).any()), "a wire carries a raw row")
    books = float((torch.einsum("nb,nbd->nd", wgt, wires)
                   - gossip_mix_sparse_tree(w, idx, wgt)).abs().max())
    require(books <= WIRES_TOL, f"the wires' books vs the sparse mix: {books}")
    emit("wires", nodes=WIRES_NODES, cols=d_main, active=int(act.sum()),
         masked_slots=int(guarded.sum()), raw_on_wire=0, books_max_abs_err=books, tol=WIRES_TOL)

    # 19. the scenario-sweep engine ----------------------------------------
    sweep_row = sweep_phase(feds, card, flush, errs)

    # 20. the paper's baselines ----------------------------------------------
    baselines_row = baselines_phase(feds, card, flush, errs)

    # 21. Figs 4 and 5, the paper driver and the examples ----------------------
    figures_row = figures_phase(feds, card, errs)

    sources = "src/repro_torch/kernels/csrc/"
    rows = [{
        "name": "lstm_forward", "route": "cuda",
        "source": sources + "lstm_forward.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:51",
        "launches": launches_serve, "launches_personalize": launches_personalize["lstm_forward"],
        "max_abs_err": max(errs), **lstm_row, **sweep_row, **baselines_row, **figures_row,
    }]
    path_launches = {"gossip_mix": trained["ohiot1dm"][1]["gossip_mix"],
                     "gossip_mix_sparse": trained["replace-bg"][1]["gossip_mix_sparse"],
                     **dp_counts}
    replaces = {"gossip_mix": 62, "gossip_mix_sparse": 102, "gossip_mix_dp": 201,
                "gossip_mix_sparse_dp": 150}
    for name, line in replaces.items():
        rows.append({"name": name, "route": "cuda", "source": sources + "gossip_mix.cu",
                     "replaces": f"src/repro/kernels/gossip_mix.py:{line}",
                     "launches": path_launches[name], "launches_masked": masked_counts[name],
                     "max_abs_err": gossip_err[name],
                     **gossip_rows[name]})
    rows.append({"name": "swa_attention", "route": "cuda", "source": sources + "swa_attention.cu",
                 "replaces": "src/repro/kernels/swa_attention.py:82",
                 "launches": lm_counts["swa_attention"], "max_abs_err": path_err["bf16_max_abs_err"],
                 "max_abs_err_sweep": swa_err, **swa_row,
                 "bound_fp32_ms": ops / FP32_OPS_PER_S * 1e3,
                 "hybrid_shape": rg_shape, "hybrid": hybrid})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

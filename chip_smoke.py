"""Smoke run of kge_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every CUDA kernel of the package from ``csrc/`` (one
   ``nvcc`` per source, all started together).
2. The rank kernel (ops/rank_kernel.py) against its plain PyTorch version on
   the card at n = 256, 1,024 and 242 (the last test batch), |E| = 14,541,
   D = 512, and at D = 510 (no multiple of 4: the 4-byte copy route), with
   skewed CSR labels and NaN / -inf edge rows. Label values agree within
   rtol 1e-5 (atol 1e-6); counts agree on every row except rows where a
   candidate's plain score lies within 4 ulp of a tie boundary pivot +-
   (atol + rtol |pivot|), since cuBLAS sums in another order than the
   kernel. The rows that differ there are excluded, counted, and may be at
   most 0.1% of the rows; the rows at a boundary are counted too. The
   kernel's four outputs are bit-equal across two launches and across three
   column splits (the planned one, one range, one wave of blocks), and the
   label value at the pivot column equals the pivot bit for bit.
3. The main path: a synthetic dataset of FB15k-237's sizes (14,541
   entities, 237 relations, 272,115 / 17,535 / 20,466 triples, made from
   ``--seed``), reciprocal ComplEx at d = 512 (the repo's
   examples/fb15k-237-complex-1vsall.yaml) with random weights made with
   numpy, carried across with ``load_jax_params`` and saved as a checkpoint
   in kge_tpu's schema, then ``python -m kge_tpu_torch test <folder>
   --eval.batch_size 256`` run in this process through ``cli.main``. The
   rank kernel's launch counter must have moved; every batch's filtered
   ranks must equal those of the plain version under the rule of phase 2;
   the metrics must be finite; and a small evaluation on the card must
   report the same metrics as on the CPU.
4. Where the eval's time goes (a profiled warm evaluation) and the rank
   kernel's time per call beside its plain version, one library call and
   its bound, at the evaluation's first batch, at n = 1,024 and over
   200,000 candidates, each also as one wave of blocks.
5. The scatter kernel (ops/embedding_ops.py ``sorted_scatter_add``) against
   its plain version in float64 at the shapes of a training step (8,192
   updates into 14,541 entity rows and into 237 relation rows, 129 updates
   into 14,541 rows, all at D = 512), at a mini-table shape (``arange`` ids)
   and with every id equal. A sum of float32 in another order than the
   reference's differs by rounding that grows with the summed magnitudes,
   so the check is ``|kernel - reference| <= 1e-6 + 1e-5 S`` with S the
   row's sum of ``|update|`` (for a row of one update that is rtol 1e-5,
   atol 1e-6); two launches must give the same bits. The kernel's own sort
   (launch A: sorted ids, permutation and segment numbers) must equal a
   stable ``torch.sort`` exactly at every one of these cases, at n = 1, at
   the largest n it takes and, through the wrapper's ``torch.sort`` route,
   at one above; the segment sums built on it are held to the same float64
   rule. The row-write kernel
   (``rows_set``) against its plain version: exact equality with duplicate
   ids, at 16,642 rows into a 200,000-row table and 8,192 rows into a
   237-row table, and the table keeps its storage.
6. Training, dense step (T-dense): ``python -m kge_tpu_torch start`` through
   ``cli.main`` on the synthetic FB15k-237-sized graph: ComplEx d = 512,
   128 shared negatives per corrupted slot, KL loss, Adagrad lr 0.1, batch
   8,192 (34 batches an epoch), two epochs and one validation through the
   rank kernel, then ``resume`` to epoch 3. The scatter kernel's counter
   must equal 5 launches a step (the lookups of s, p, o and one target list
   per corrupted slot), the rank kernel's two a validation batch; the loss
   must be finite and fall; the resumed job must start at epoch 3 from the
   Adagrad ``sum`` it saved. One step with the kernel against the same step
   with ``train.pallas_gather: never`` (torch's indexing backward) from the
   same state and negatives: tables within atol 1e-6 + rtol 1e-5.
7. Training, row-sparse step (T-sparse): the same triple counts over 200,000
   entities, where ``train.sparse_embedding_update: auto`` engages; one
   epoch through ``cli.main``. The row-write kernel's counter must equal 4
   a step (parameter and ``sum``, entity and relation table), the scatter
   kernel's 7 (five lookups on the mini-tables, two segment sums). One
   sparse step against the dense step from the same state and negatives:
   touched rows within atol 1e-6 + rtol 1e-5, untouched rows bit-equal.
8. Timings: the two kernels per call at the main shapes beside plain,
   library (``index_add_``, ``index_copy_``) and bound, the scatter
   kernel's two launches (the sort; the sums and the zeros) also alone, at
   d = 128 and at the row-sparse step's 16,642 ids of 200,000 too, with the
   segment sums and their sort alone; a warm epoch of
   each training configuration (wall, triples/s) and a profile of it with
   the device's busy share.
9. The fused row-update kernel (ops/optim.py ``fused_sorted_update``)
   against its plain version in float64 at [200,000, 1,024] with 10,240
   row gradients and at [237, 512] with 4,096 (over 94% duplicates): Adam,
   AdamW and Adagrad with weight decay and SGD with Nesterov momentum at
   both shapes, every other rule at the small one, from random non-zero
   states at step 3 (and step 0 for SGD's momentum), on row gradients whose
   duplicates agree in sign (no sum cancels). Parameter and states
   within ``1e-6 + 1e-5 |reference|`` on every row; Adam's moments of
   untouched rows bit-equal to ``beta * moment``; storage kept; two launches
   from the same state bit-equal.
10. The pooled distance kernels (ops/dist_pool.py ``pooled_dist_scores``
   and its backward) against the plain version in float64, for ``l1``
   (n = 8,192, K = 128, F = 8, d = 128 and d = 512) and ``cmod`` (n = 4,096,
   K = 128, F = 8, d = 512 per part), one odd shape (n = 37, K = 5, F = 3,
   d = 100, and d = 51 for the scalar path), the backward's edges (K =
   1,024; several row chunks with n no multiple of one; K = 13 with d = 300;
   F = 1, 16 and 100; sel partly outside [0, F), which stands for a zero
   candidate and no pool row; n = 0), the forward's edges (n = 257 and K =
   17, one past a block's 256 rows and 16 slots, with d = 132 in five
   32-column tiles; F = 24, whose pool rows a stage holds for l1 and not for
   cmod; F = 60, read from L2) and rows whose query equals a candidate:
   scores, dq and dpool within ``1e-6 + 1e-5 S`` with S the sum of the
   magnitudes that the element adds up; two launches bit-equal. Then cmod
   terms of +inf (a difference whose square overflows) and NaN: the forward
   must give sqrtf's scores, -inf and NaN where the plain version in float32
   has them.
11. P-transe: ``start`` through ``cli.main``, TransE-L1 d = 128, margin
   ranking 4.0, 128 negatives per corrupted slot, ``implementation: auto``
   (must resolve to ``pool``), Adagrad lr 0.1, batch 8,192, FB15k-237 sizes,
   two epochs without validation, then ``resume`` to a third. Dense step:
   per step 2 launches of the pooled forward, 2 of its backward and 12 of
   the scatter kernel (per corrupted slot the lookups of s, p, o, of the
   two kept slots again and of the pool); the loss is finite and falls.
12. P-rotate: RotatE-L1 d = 1,024, self-adversarial BCE, Adam lr 0.001,
   batch 4,096, 128 negatives per slot, pool factor 8, over the
   200,000-entity graph: one epoch through ``cli.main`` and a ``resume``
   from its checkpoint. The log must say that the row-sparse step engaged
   with the fused kernel; per step 2 launches of the fused update, none of
   the row write, 2 + 2 of the pooled kernels and 14 of the scatter kernel
   (12 lookups on the mini-tables, 2 segment sums); the loss is finite and
   falls; Adam's ``m`` and ``v`` come back from the checkpoint. One sparse
   step against one dense step from the same state, pool and ``sel``:
   tables and moments of every row within ``1e-6 + 1e-5 |dense|``, except
   that at most 1e-5 of the elements may differ by up to 2.1 lr: where a
   row's gradient nearly cancels, two summation orders give gradients of
   different sign, and Adam's ``m_hat / (sqrt(v_hat) + eps)`` turns both
   into about +-lr.
13. Timings at P-rotate's shapes: the three new kernels per call beside
   plain, a library route (``index_add_`` and ``torch.optim.Adam(fused=
   True)``; ``cdist(p=1)`` and a gather for ``l1``, none for ``cmod``) and
   the bound, the pooled backward's two launches (``dq``, ``dpool``) each
   from torch.profiler; the pooled scoring's two routes (kernel, one-hot
   select) at d = 128; a warm epoch of each new configuration with its
   profile.
14. T-transe-l2: TransE-L2 d = 128 with the settings of
   examples/fb15k-237-transe-negsamp.yaml (margin ranking 4.0, Adagrad lr
   0.05, batch 2,048, 64 + 64 negatives, ``xavier_uniform_``; ``auto``
   must resolve to ``pool``, whose pool L2 scores once through its
   factorization, every row picking its columns) on the
   FB15k-237-sized graph: ``start`` for two epochs with ``valid.every 1``,
   then ``test`` on the folder. Both validations must run,
   ``checkpoint_00002.pt`` must exist and the loss must fall; the rank
   kernel must launch twice a validation and a test batch, every launch
   with the L2 score epilogue. Every test batch's filtered ranks must equal
   the plain version's outside tie-boundary rows (phase 3's rule, with the
   boundary window widened by the augmented product's rounding). The
   epilogue kernel against its plain version on random inputs at n = 256,
   |E| = 14,541, d = 128 (132 augmented columns), close pairs included:
   counts equal outside tie-boundary rows, label values and pivots within
   rtol 1e-5 (atol 1e-6), and the epilogue applied to the identity
   kernel's pivots and label values gives the epilogue kernel's bits. Its
   time per call beside the plain version, ``matmul`` + the epilogue +
   compares and the bound (2 n |E| D' fp32 operations). Walls, and the
   profiles of a warm epoch and of a warm test evaluation. Then ``test`` on
   phase 11's P-transe folder (TransE-L1: the score-matrix route, no rank kernel
   launch) must exit with finite metrics; its warm evaluation is
   profiled.
15. O-complex: examples/fb15k-237-complex-1vsall.yaml as written
   (reciprocal ComplEx d = 512, 1vsAll, KL, Adagrad lr 0.3, batch 512, N3
   1e-9) on the FB15k-237-sized graph, cut to two epochs with ``valid.every
   1``: ``start`` through ``cli.main``, ``resume`` to epoch 3, then
   ``test``. The scatter kernel must launch 4 times a step (s and p for the
   object direction, o and p + |R| for the subject direction), the rank
   kernel twice a validation and a test batch; losses finite and falling.
   One step with the kernel against ``train.pallas_gather: never`` from the
   same state: tables within atol 1e-6 + rtol 1e-5. A warm epoch's wall,
   triples/s and profile.
16. K-complex: bench.py's stage 6 (ComplEx d = 512, KvsAll with ``sp_`` and
   ``_po``, KL, Adagrad lr 0.1, batch 512): ``start`` for two epochs and one
   validation, ``resume`` to epoch 3. The scatter kernel must launch twice a
   step (the query's two keys); one batch's dense labels must sum, row by
   row, to its queries' distinct answers; one step with the kernel against
   the ``never`` step as in phase 15. A warm epoch's wall, queries/s (the
   bench's unit) and profile.
17. DistMult, RESCAL, CP, SimplE and RelationalTucker3 at the toy widths of
   examples/toy-rt3-train.yaml (d = 16; Tucker3's core from 8) on a small
   graph: a test evaluation on the card (the rank kernel twice a batch)
   reports the CPU's metrics, and one KvsAll step on the card (2 scatter
   launches) gives the CPU's tables within atol 1e-6 + rtol 1e-5.
18. X-complex: bench.py's stage 3 (``negsamp_perrow_exact``): phase 6's
   settings with 128 per-row negatives for s and for o (``shared: false``)
   scored by ``implementation: all`` against every entity, then picked per
   row (ops/pick.py), on the FB15k-237-sized graph: ``start`` for two
   epochs with ``valid.every 1``, ``resume`` to epoch 3. The scatter kernel
   must launch 3 times a step (s, p and o embedded once; the whole
   vocabulary's scores read the table itself), the rank kernel twice a
   validation batch; losses finite and falling. One kernel step against the
   ``never`` step (tables within atol 1e-6 + rtol 1e-5); the pick at this
   shape: values equal a gather, the backward bit-equal across two launches
   on the run's samples and on samples with a column picked three times in
   every row; the same samples scored by ``all``, ``batch`` and ``triple``
   (losses rtol 1e-5, tables after one step within atol 1e-6 + rtol 1e-5;
   scatter launches 3, 12, 12); a step in 4 subbatches of 2,048 against
   the whole step (same rules). A warm epoch's wall, triples/s and profile.
19. At T-dense's shape, each ``start`` for two epochs through ``cli.main``
   with the scatter kernel's launches a step by equality and a finite
   falling loss: per-row ``batch`` (12 a step), ``pool`` with
   ``on_device: never`` (host-drawn samples scored as ``batch``, 12 a
   step), ``fused_scoring: always`` with shared negatives (7 a step: one
   into each whole table, five into the mini-tables), with one fused step
   against the unfused one (tables within atol 1e-6 + rtol 1e-5); a warm
   epoch of each; the ``batch`` route's bounded unique timed alone. Then one
   KvsAll step of phase 16 in subbatches of 128 against the whole step
   (loss rtol 1e-5, tables as above; 8 scatter launches against 2), and the
   wall of the subbatched job's next epoch (not profiled, no warm-up epoch). Each of phases 18 and 19 logs its wall.
20. C-conve: the reciprocal relations model over ConvE at the ConvE paper's
   widths (d = 200 as a 10 x 20 map stacked to 20 x 20, 32 filters of 3 x 3,
   flat size 10,368, the yaml's dropouts 0.2 / 0.2 / 0.3), KvsAll with
   ``bce`` and label smoothing 0.1, Adam lr 0.003, batch 128, on the
   FB15k-237-sized graph: ``start`` for one epoch with a validation through
   the rank kernel (D = 201), ``resume`` to epoch 2 (the warm epoch), ``test``,
   then ``valid --eval.type training_loss`` on the folder. The scatter kernel
   must launch 2 times a step (the query's two keys), the rank kernel twice a
   validation and a test batch, the forward-only training loss nothing; the
   losses are finite; the batch-norm statistics moved while their Adam
   moments stayed zero. Every test batch's ranks by the rank kernel equal
   those of the score-matrix route (``score_sp`` / ``score_po``, kge_tpu's)
   outside tie-boundary rows (phase 2's 4 ulp, widened by the difference of
   the two routes' scores; at most 1% of the rows differ), and the rank
   kernel's plain version's under phase 2's rule; the scatter kernel against
   its plain version as in phase 5 at the lookups' shapes (128 ids into the
   entity and the relation table, D = 201). One step on the card against the
   same step on the CPU from the epoch-2 checkpoint with every dropout 0
   (``card_matches_cpu``): losses within rtol 1e-5; each leaf's gradient
   norm-wise within 1e-4 of the CPU's (cuDNN, cuBLAS and the scatter sum in
   other orders, which moves single cancelling elements, not the norm); the
   CPU's optimizer rule applied to the card's own gradients and prior state
   against the card's stepped leaves and Adam's moments, and the batch-norm
   statistics, within 1e-5 + 1e-4 |CPU|; the leaves whose gradient is zero
   up to rounding (the convolution's and the projection's biases, which
   batch norm follows) within twice Adam's largest step, 2 (1 - beta1) /
   sqrt(1 - beta2) lr.
   The warm epoch's wall and queries/s, the validation's and the test's
   walls, and a profiled window of 50 steps of a warm epoch: the
   leading kernels, the device's busy share of the profiled wall and its
   device time a step against the unprofiled warm epoch's wall a step (a
   whole epoch's millions of profiler events take minutes to reduce, and
   the profiler slows the host).
21. C-hitter: the reciprocal Transformer ("no context" HittER) at the
   yaml's widths with d = 320 (8 heads, feed-forward 1,280, 3 layers, dropout
   0.1), 1vsAll with ``kl``, Adam lr 0.001, batch 512: the same verbs and
   checks as phase 20, the scatter kernel 4 times a step (s, p, o, p + |R|),
   the leaves of zero gradient the attention's key biases, the scatter
   kernel's shapes 512 ids at D = 320.
22. The dtype policy (``parallel.compute_dtype`` / ``param_dtype``:
   bfloat16). First gamma_D of the rank kernel's bfloat16 certificate: the
   kernel's own tensor-core sums (``bf16_tile_sums``) of 50 million dot
   products at D = 132, 320 and 512 (Gaussian, cancelling, wide-exponent
   and all-positive inputs) against float64; the largest |x - exact| / (N M)
   must stay within gamma_D / 8. Each kernel's bfloat16 path against its
   plain version at the
   main shapes, with its time, the plain version's, one library call's and
   the bound at bfloat16 bytes (and bf16 products over the tensor cores'
   989 TFLOP/s): the rank kernel at n = 256, |E| = 14,541, D = 512 and with
   the L2 epilogue (counts equal, vals and pivots bit for bit, two launches
   bit-equal, its count of undecided entries that of the PyTorch rule
   ``certified_categories`` on its own sums, logged as the recount share;
   library: cuBLAS's bf16 product and the compares), the scatter at 8,192 ids into
   [14,541, 512] and at 16,642 into [200,000, 512] (within an ulp of the sums;
   ``index_add_``; each launch alone, the segment sums and their sort as in
   phase 8), the row
   write at 16,642 rows into [200,000, 512] (exact; ``index_copy_``), Adam's
   fused update at 10,240 rows into [200,000, 1,024] (within an ulp), the
   pooled scores and their backward at ``cmod``, n 4,096, K 128, F 8, d 512
   and at ``l1``, n 8,192, K 128, F 8, d 128 and 512 (within an ulp; dq and
   dpool plus 2^-12 of their summed magnitudes; two launches bit-equal;
   library for ``l1``: ``torch.cdist`` + gather in float32), and the fast
   operations of their bfloat16 path against the IEEE ones, exhaustively.
   Then four runs through ``cli.main``, counts set to 0 before and read
   after each: phase 14's T-transe-l2 ``test`` with ``--parallel.compute_dtype
   bfloat16`` (every rank launch the bfloat16 path with the L2 epilogue);
   X-complex in bfloat16 compute (``start`` one epoch and a
   validation, ``test``: every rank launch the bfloat16 path; two test
   batches' ranks through the kernel equal the plain version's, and the
   warm test evaluation profiled, K1's device ms in it), its entity
   table pretrained from phase 6's folder (the initial table equals it bit
   for bit); P-rotate with both dtypes in bfloat16 (one epoch: every launch
   of K2, K4, K5a and K5b bfloat16; tables and Adam's moments bfloat16 in
   the checkpoint); T-sparse with bfloat16 tables (one epoch: K3 4 times a
   step, bfloat16). One step of each card against CPU (``card_vs_cpu_step``
   states the bound), and the warm epochs of X-complex and P-rotate,
   profiled (X-complex's GEMM milliseconds, P-rotate's K5b share).
23. Hyperparameter search and the tools that read its results, through
   ``cli.main`` in ``build/chip_smoke`` (where ``data/`` names the
   datasets): (a) a grid search over T-dense's configuration (lr 0.1 and
   0.2; one epoch and one validation a trial; ``search.num_workers: 1``) in
   this process: two trial folders with ``checkpoint_00001.pt`` and one
   validation each, the scatter kernel 2 x 34 x 5 = 340 launches, the rank
   kernel 2 x 2 x 69 = 276, ``search_completed`` naming the trial of the
   larger filtered MRR, and the second trial ending with less than an
   entity table more allocated than the first (each trial logs the
   allocator); each trial's wall split into setup, epoch, validation and
   the rest; (b) ``dump trace --search`` (two rows, each its trial's
   validation), ``package`` of the best trial, ``dump checkpoint`` of the
   package (the tables [14,541, 512] and [237, 512]), and ``test`` of the
   package equal to ``test`` of its ``checkpoint_best.pt``, metric for
   metric, 2 rank launches a test batch each; (c) an ``ax_search`` of 3
   trials (2 Sobol) on phase 17's graph at d = 16 in two spawned worker
   processes pinned to ``cuda:0``: every trial on the card in a worker, and
   the search checkpoint resumed with the same three parameter sets; (d)
   GraSH (``combined``, eta 2, 4 trials, d = 128, ``keep_pretrained``) on a
   synthetic graph of 5,000 entities and 50,000 training triples: a round
   on a k-core subset, every trial on the card, the best trial packaged.
24. One ``kernels`` JSON line: per kernel its time per call at the main
   path's shape, launches on its main path, the plain version's and one
   library call's time, and the bound (the largest of bytes over 3.35 TB/s,
   fp32 operations over 67 TFLOP/s and, for ``cmod``, square roots over
   16 a clock per SM at the card's maximum SM clock; ``bound_term`` names
   it); every time in it is
   measured by this run; the rank kernel's entry also holds the L2
   epilogue's times and its launches in phase 14, and its launches in phases
   15-18, 20, 21 and 23 (a), the scatter kernel's its launches in phases 15,
   16, 18, 19, 20, 21 and 23 (a) and its launches alone
   (``SCATTER_LAUNCH_KEYS``). Six more
   entries (``*_bf16``) hold the bfloat16 paths of phase 22, their launches
   from its runs (the scatter's also its launches alone). Then the card's name and power
   limit, then the ``ok`` JSON line last.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, fp32 outside tensor cores
SPECIAL_PER_CLOCK_PER_SM = 16  # sqrt / rsqrt results (Hopper's special-function units)
ATOL, RTOL = 1e-5, 1e-4        # entity_ranking.tie_handling defaults
SPIN_CYCLES = 90_000_000       # about 50 ms of an H100's clock

# FB15k-237: entities, relations, train / valid / test triples
FB15K237 = (14541, 237, 272115, 17535, 20466)
NUM_ENTITIES, NUM_TEST = FB15K237[0], FB15K237[4]
DIM, BATCH = 512, 256
KERNELS = ("rank_counts", "scatter_add_sorted", "rows_set", "fused_row_update",
           "dist_pool")
# training: bench.py's headline workload
TRAIN_BATCH, NUM_NEGATIVES, SPARSE_ENTITIES = 8192, 128, 200000
# pooled negatives: bench.py's transe_margin and rotate_selfadv workloads
POOL_FACTOR, TRANSE_DIM, ROTATE_DIM, ROTATE_BATCH = 8, 128, 1024, 4096
ROTATE_LR = 0.001
# the scatter kernel's launches alone (``scatter_launch_times``)
SCATTER_LAUNCH_KEYS = ("launch_a_ms", "launch_b_ms", "segment_sums_ms", "sort_alone_ms")
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")


def log(*args):
    print(*args, flush=True)


def check(condition, message="check failed") -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not condition:
        raise RuntimeError(f"chip_smoke.py: {message}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, reps: int = 30) -> float:
    """Mean device time of ``fn`` by CUDA events, after a warm-up. The
    timed launches are queued behind a spin kernel of about 50 ms, so that
    the device runs them back to back and the host's enqueue rate (which
    varies between machines) does not set the reading."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- the rank kernel against its plain version ---------------------------------


def boundary_rows(q, targets, pivot, num_valid, score_map=None,
                  dim=None) -> torch.Tensor:
    """Rows where a plain score lies within 4 ulp of pivot +- tolerance:
    there the kernel's summation order may legitimately flip a decision.
    With the L2 epilogue (``score_map``; q and targets the augmented
    operands of a ``dim``-wide embedding) a row is also near where the
    product lies within 32 float32 epsilons of (||q|| + ||c||)^2, the
    rounding of a cancelling sum, from a bound's preimage -b^2."""
    dots = q @ targets[:num_valid].T
    scores = dots if score_map is None else score_map(dots)
    p = torch.where(torch.isnan(pivot), torch.full_like(pivot, -float("inf")), pivot)
    tol = ATOL + RTOL * p.abs()
    near = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    if score_map is not None:
        qn = (-q[:, dim + 1]).clamp_min(0).sqrt()
        cn = targets[:num_valid, dim].clamp_min(0).sqrt()
        window = 32 * 1.1920929e-07 * (qn[:, None] + cn[None, :]) ** 2
    for bound in (p - tol, p + tol):
        b = bound[:, None]
        ulp = (torch.nextafter(b.abs(), torch.full_like(b, float("inf")))
               - b.abs())
        close = (scores - b).abs() <= 4 * ulp
        if score_map is not None:
            close |= (dots + b * b).abs() <= window
        near |= (close & torch.isfinite(b)).any(dim=1)
    return near


def skewed_labels(rng, n, num_entities, device, true=None):
    """CSR labels with FB15k-237-like skew: most rows hold a few labels,
    every 37th row thousands. With ``true``, row i also holds true[i], as
    an evaluation's labels hold the true answer."""
    per_row = []
    for i in range(n):
        k = 3000 if i % 37 == 1 else int(rng.zipf(1.6)) % 200
        row = rng.choice(num_entities, size=k, replace=False)
        if true is not None:
            row = np.union1d(row, true[i:i + 1])
        per_row.append(np.sort(row))
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in per_row])])
    return (torch.tensor(row_ptr, dtype=torch.int32, device=device),
            torch.tensor(np.concatenate(per_row), dtype=torch.int32, device=device))


def compare_kernel(seed: int, device):
    """Phase 2; returns (max |vals error|, rows excluded, rows)."""
    from kge_tpu_torch.ops.rank_kernel import (
        csr_row_ids,
        fused_rank_counts,
        fused_rank_counts_plain,
        rank_plan,
    )

    rng = np.random.default_rng(seed)
    E = NUM_ENTITIES
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    max_err, excluded, rows = 0.0, 0, 0
    tables = {}
    for n, D in ((256, DIM), (1024, DIM), (242, DIM), (242, DIM - 2)):
        if D not in tables:
            tables[D] = torch.tensor(
                rng.normal(0, 0.05, (E, D)).astype(np.float32), device=device)
        targets = tables[D]
        t0 = targets[:, 0].cpu().numpy()
        true_np = rng.integers(0, E, n).astype(np.int32)
        qn = rng.normal(0, 0.05, (n, D)).astype(np.float32)
        qn[2] = np.nan                          # NaN pivot, reads as -inf
        for row, sign in ((5, -1.0), (6, 1.0)):  # -inf and +inf pivots
            qn[row] = 0.0
            qn[row, 0] = sign * np.inf * np.sign(t0[true_np[row]])
        q = torch.tensor(qn, device=device)
        row_ptr, cols = skewed_labels(rng, n, E, device, true=true_np)
        true = torch.tensor(true_np, device=device)

        def run(plan=None):
            out = fused_rank_counts(q, targets, None, row_ptr, cols, E, ATOL, RTOL,
                                    pivot_cols=true, plan=plan)
            torch.cuda.synchronize()
            return out

        g, c, vals, pivot = first = run()
        check(bool(torch.isnan(pivot[2])) and float(pivot[5]) == -float("inf")
              and float(pivot[6]) == float("inf"),
              "edge rows did not give NaN, -inf and +inf pivots")

        def same_bits(a, b):
            return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(a, b))

        planned = rank_plan(n, E)
        for what, plan in (
            ("a second launch", None),
            ("one column range", rank_plan(n, E, num_ranges=1)),
            ("one wave of blocks",
             rank_plan(n, E, num_ranges=2 * sms // planned["row_tiles"])),
        ):
            check(same_bits(first, run(plan)),
                  f"rank kernel outputs differ in bits with {what} (n={n}, D={D})")
        at_pivot = cols == true[csr_row_ids(row_ptr)]
        check(int(at_pivot.sum()) == n and torch.equal(
            vals[at_pivot].view(torch.int32), pivot.view(torch.int32)),
            f"the label value at the pivot column is not the pivot's bits (n={n})")
        pg, pc, pvals, _ = fused_rank_counts_plain(
            q, targets, pivot, row_ptr, cols, E, ATOL, RTOL
        )
        both_nan = torch.isnan(vals) & torch.isnan(pvals)
        err = torch.where(both_nan, torch.zeros_like(vals), (vals - pvals).abs())
        finite_ref = torch.isfinite(pvals)
        ok_vals = bool(torch.all(
            both_nan | (vals == pvals)
            | (finite_ref & (err <= 1e-6 + 1e-5 * pvals.abs()))
        ))
        check(ok_vals, f"rank kernel vals disagree with plain (n={n}, D={D})")
        max_err = max(max_err, float(err[finite_ref].max()) if finite_ref.any() else 0.0)
        differ = (g != pg) | (c != pc)
        near = boundary_rows(q, targets, pivot, E)
        bad = differ & ~near
        check(not bool(bad.any()), (
            f"rank kernel counts disagree with plain on {int(bad.sum())} "
            f"rows away from a tie boundary (n={n}, D={D})"
        ))
        excluded += int((differ & near).sum())
        rows += n
        log(f"  n={n} D={D}: counts equal on {n - int(differ.sum())}/{n} rows; "
            f"{int(near.sum())} rows lie at a tie boundary, "
            f"{int((differ & near).sum())} of them differ and are excluded; "
            f"vals max abs err {float(err[finite_ref].max()):.3e}; outputs "
            f"bit-equal across two launches, {planned['num_ranges']} / 1 / "
            f"{2 * sms // planned['row_tiles']} column ranges; the "
            f"label value at the pivot column is the pivot bit for bit")
    check(excluded <= 0.001 * rows, f"{excluded} of {rows} rows excluded")
    return max_err, excluded, rows


# -- the main path -------------------------------------------------------------


def write_dataset(folder: str, seed: int, sizes=FB15K237):
    """Synthetic triples of the given sizes (default FB15k-237's); entities
    and relations are drawn with power-law popularity so that some queries
    hold many answers, as in the real graph."""
    num_entities, num_relations, num_train, num_valid, num_test = sizes
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)

    def popularity(k, a):
        w = 1.0 / np.arange(1, k + 1) ** a
        return rng.permutation(w / w.sum())

    pe = popularity(num_entities, 0.8)
    pr = popularity(num_relations, 1.0)
    total = num_train + num_valid + num_test
    triples = np.stack([
        rng.choice(num_entities, total, p=pe),
        rng.choice(num_relations, total, p=pr),
        rng.choice(num_entities, total, p=pe),
    ], axis=1)
    triples[:num_entities, 0] = np.arange(num_entities)
    triples[:num_relations, 1] = np.arange(num_relations)
    splits = {
        "train": triples[:num_train],
        "valid": triples[num_train:num_train + num_valid],
        "test": triples[num_train + num_valid:],
    }
    for name, arr in splits.items():
        with open(os.path.join(folder, f"{name}.del"), "w") as f:
            f.write("\n".join("\t".join(map(str, t)) for t in arr.tolist()) + "\n")
    for name, num in (("entity_ids", num_entities), ("relation_ids", num_relations)):
        with open(os.path.join(folder, f"{name}.del"), "w") as f:
            f.write("".join(f"{i}\t{name[0]}{i}\n" for i in range(num)))
    with open(os.path.join(folder, "dataset.yaml"), "w") as f:
        f.write(f"dataset:\n  name: {os.path.basename(folder)}\n"
                f"  num_entities: {num_entities}\n  num_relations: {num_relations}\n")


def write_checkpoint(folder: str, data: str, seed: int, device: str, dim: int,
                     batch_size: int):
    """A kge_tpu-schema experiment folder (config.yaml + checkpoint_best.pt)
    holding reciprocal ComplEx with random numpy weights."""
    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.models import KgeModel, load_jax_params, to_jax_params
    from kge_tpu_torch.utils.io import save_checkpoint

    config = Config()
    config.load_options({
        "model": "reciprocal_relations_model",
        "reciprocal_relations_model.base_model.type": "complex",
    })
    config.set("lookup_embedder.dim", dim)
    config.set("job.device", device)
    config.set("dataset.name", data)
    config.set("eval.batch_size", batch_size)
    config.set("random_seed.default", seed)
    config.set("console.quiet", True)
    config.folder = folder
    if os.path.exists(folder):
        import shutil

        shutil.rmtree(folder)
    config.init_folder()
    dataset = Dataset.create(config)
    rng = np.random.default_rng(seed + 1)
    E, R = dataset.num_entities(), dataset.num_relations()
    params = {
        "entity_embedder": {"embeddings": rng.normal(0, 0.1, (E, dim)).astype(np.float32)},
        "relation_embedder": {"embeddings": rng.normal(0, 0.1, (2 * R, dim)).astype(np.float32)},
    }
    model = KgeModel.create(config, dataset, init_for_load_only=True,
                            device=torch.device("cpu"))
    load_jax_params(model, params)
    checkpoint = {
        "type": "train", "epoch": 0, "valid_trace": [],
        "model": (to_jax_params(model), {}), "optimizer_state": None,
        "lr_scheduler_state_dict": {}, "job_id": str(uuid.uuid4()),
    }
    config.save_to(checkpoint)
    dataset.save_to(checkpoint)
    save_checkpoint(checkpoint, config.checkpoint_file("best"))
    return config.checkpoint_file("best")


def test_job(folder: str):
    """An evaluation job on the test split of the experiment ``folder``,
    as the ``test`` verb builds it."""
    from kge_tpu_torch import Config
    from kge_tpu_torch.job import EvaluationJob
    from kge_tpu_torch.utils.io import load_checkpoint

    config = Config()
    config.load(os.path.join(folder, "config.yaml"))
    config.folder = folder
    config.set("eval.split", "test")
    return EvaluationJob.create_from(
        load_checkpoint(Config.best_or_last_checkpoint_file(folder)),
        new_config=config,
    )


def last_test_entry(folder: str):
    import yaml

    entry = None
    with open(os.path.join(folder, "trace.yaml")) as f:
        for line in f:
            e = yaml.safe_load(line)
            if e.get("event") == "eval_completed" and e.get("split") == "test":
                entry = e
    check(entry is not None, "no eval trace entry")
    return entry


def device_us(event):
    """A profiler event's own device time, microseconds."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def kernel_ms(fn, names, reps: int = 10):
    """Mean device ms of one launch of each kernel whose name holds one of
    ``names`` (each launched once a call of ``fn``), from torch.profiler
    over ``reps`` calls after a warm-up: the device time over the launches
    the profiler recorded. None where it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for event in prof.key_averages():
        for name in names:
            if name in event.key and device_us(event) > 0:
                total[name] += device_us(event)
                count[name] += event.count
    return {name: total[name] / 1e3 / count[name] if count[name] else None
            for name in names}


def profile_run(fn, what: str):
    """``fn()`` under torch.profiler: wall time, device time by kernel
    name, and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

    # kernels only: an operator's entry repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    ranked = sorted(events, key=device_us, reverse=True)

    def rows(chosen):
        return [{"name": e.key[:60], "ms": device_us(e) / 1e3, "calls": e.count}
                for e in chosen]

    # the six longest, and the package's own kernels (all compiled into
    # anonymous namespaces) and torch's sorts wherever they rank
    top = rows(ranked[:6])
    own = rows(e for e in ranked[6:]
               if "(anonymous namespace)::" in e.key and "at::native" not in e.key)
    sorts = rows(e for e in ranked if "RadixSort" in e.key or "radix_sort" in e.key)
    out = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if events else None,
        "device_busy_share": busy_ms / wall_ms if events else None,
        "top": top, "own_kernels_below_top": own, "torch_sort_kernels": sorts,
    }
    if not events:
        log("  profiler recorded no device time: not measured")
    else:
        log(f"  profiled {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%)")
        for t in top + own:
            log(f"    {t['ms']:9.3f} ms  {t['calls']:5d} calls  {t['name']}")
        log(f"    torch radix-sort kernels: {sum(t['calls'] for t in sorts)} launches, "
            f"{sum(t['ms'] for t in sorts):.3f} ms")
    return out


def eval_ranks_agree(job, dim=None):
    """Every batch of a prepared evaluation job (its collated batches) ranked
    by the kernel and by its plain version: filtered ranks equal outside the
    tie-boundary rows, which may be at most 0.1% of the (row, ranking,
    direction) entries. ``dim``: the embedding width, for the L2
    epilogue's boundary window."""
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts_plain

    _, device_batches = job._collate_cache
    E = job.dataset.num_entities()
    differ_rows = near_rows = total_rows = 0
    for triples, labels in device_batches:
        kernel, _ = job._rank_batch(triples, labels)
        plain, _ = job._rank_batch(triples, labels,
                                   rank_counts=fused_rank_counts_plain)
        fac = job.model.factorized_queries(triples, (0, 2))
        near = {}
        for key, slot, true in (("o", 2, triples[:, 2]), ("s", 0, triples[:, 0])):
            _, q, targets, score_map = fac[slot]
            pivot = fused_rank_counts_plain(
                q, targets, None, labels[key][0], labels[key][1],
                E, ATOL, RTOL, score_map=score_map, pivot_cols=true,
            )[3]
            near[key] = boundary_rows(q, targets, pivot, E, score_map, dim)
        for r in kernel:
            d = kernel[r] != plain[r]
            d_s, d_o = d[0] | d[1], d[2] | d[3]
            bad = (d_s & ~near["s"]) | (d_o & ~near["o"])
            check(not bool(bad.any()), f"ranking {r}: kernel and plain ranks differ")
            differ_rows += int(d_s.sum() + d_o.sum())
            near_rows += int(near["s"].sum() + near["o"].sum())
            total_rows += 2 * triples.shape[0]
    check(differ_rows <= 0.001 * total_rows, (differ_rows, total_rows))
    log(f"  filtered ranks of all {len(device_batches)} batches equal the plain "
        f"version's on {total_rows - differ_rows}/{total_rows} (row, ranking, "
        f"direction) entries; {near_rows} lie at a tie boundary, the "
        f"{differ_rows} that differ are excluded")
    return {"entries": total_rows, "at_boundary": near_rows, "differ": differ_rows}


def small_eval_agrees(seed: int):
    """A small evaluation on the card and on the CPU reports the same
    metrics (the CPU runs the plain versions)."""
    data = os.path.join(WORK, "small_data")
    write_dataset(data, seed, sizes=(500, 8, 5000, 300, 300))
    entries = {}
    for device in ("cuda", "cpu"):
        folder = os.path.join(WORK, f"small_{device}")
        write_checkpoint(folder, data, seed, device, 32, 64)
        entries[device] = test_job(folder).run()
    keys = [k for k in entries["cpu"]
            if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
            and not k.endswith("_with_test")]
    differ = [k for k in keys if entries["cuda"][k] != entries["cpu"][k]]
    check(keys and not differ, f"card and CPU metrics differ: {differ}")
    log(f"  small eval (500 entities, d=32): {len(keys)} metrics equal on card and CPU")


# -- the scatter and row-write kernels against their plain versions ------------


def power_law_ids(rng, vocab: int, n: int, exponent: float) -> np.ndarray:
    """n ids with power-law popularity, as the synthetic graph's."""
    w = 1.0 / np.arange(1, vocab + 1) ** exponent
    return rng.choice(vocab, n, p=rng.permutation(w / w.sum()))


def scatter_cases(rng):
    """(name, ids, num_rows): the three scatter shapes of a dense training
    step, a mini-table shape and a hot row."""
    n, E, R = TRAIN_BATCH, NUM_ENTITIES, FB15K237[1]
    return [
        ("entity lookups", power_law_ids(rng, E, n, 0.8), E),
        ("relation lookups", power_law_ids(rng, R, n, 1.0), R),
        ("shared targets", rng.integers(0, E, NUM_NEGATIVES + 1), E),
        ("mini-table (arange ids)", np.arange(n), 2 * n + 2 * (NUM_NEGATIVES + 1)),
        ("hot row (all ids equal)", np.full(n, 7), R),
    ]


def rows_set_cases(rng):
    """(name, num_rows, ids): the two row writes of a row-sparse step, into
    the entity table (s, o and both target lists) and the relation table."""
    m_entity = 2 * TRAIN_BATCH + 2 * (NUM_NEGATIVES + 1)
    return [
        ("entity table", SPARSE_ENTITIES,
         power_law_ids(rng, SPARSE_ENTITIES, m_entity, 0.8)),
        ("relation table", FB15K237[1],
         power_law_ids(rng, FB15K237[1], TRAIN_BATCH, 1.0)),
    ]


def stable_sort_reference(ids, num_rows):
    """(sorted keys, permutation, segment numbers) of a stable torch.sort,
    ids outside the table read as ``num_rows``."""
    outside = (ids < 0) | (ids >= num_rows)
    keys, order = torch.sort(
        torch.where(outside, torch.full_like(ids, num_rows), ids), stable=True)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys, order, torch.cumsum(first, 0) - 1


def check_sort_and_segments(name, ids, upd, num_rows):
    """Launch A's sort against a stable torch.sort, exactly, and the segment
    sums built on it against float64."""
    from kge_tpu_torch.ops.embedding_ops import scatter_launch, sorted_segment_sums

    n = ids.shape[0]
    keys, order, seg = stable_sort_reference(ids, num_rows)
    _, work, _ = scatter_launch(ids, None, upd, num_rows, phases=1)
    rs, got_seg, gsum = sorted_segment_sums(ids, upd, num_rows)
    torch.cuda.synchronize()
    check(torch.equal(work[:n].long(), keys) and torch.equal(work[n:2 * n].long(), order)
          and torch.equal(work[2 * n:3 * n].long(), seg),
          f"the kernel's sort differs from a stable torch.sort ({name})")
    check(torch.equal(rs.long(), keys) and torch.equal(got_seg.long(), seg),
          f"segment numbers differ from a stable torch.sort's ({name})")
    ref = torch.zeros(n, upd.shape[1], dtype=torch.float64, device=ids.device)
    magnitude = torch.zeros_like(ref)
    ref.index_add_(0, seg, upd.double()[order])
    magnitude.index_add_(0, seg, upd.double().abs()[order])
    check(bool(((gsum.double() - ref).abs() <= 1e-6 + 1e-5 * magnitude).all()),
          f"segment sums disagree with float64 ({name})")


def compare_scatter(seed: int, device) -> float:
    """Phase 5, scatter kernel; returns the largest |error| at the three
    shapes of the dense step."""
    from kge_tpu_torch.ops.embedding_ops import SORT_LIMIT

    rng = np.random.default_rng(seed + 2)
    worst = 0.0
    cases = scatter_cases(rng) + [
        ("one update", np.array([NUM_ENTITIES - 1]), NUM_ENTITIES),
        ("the largest sort in the kernel",
         power_law_ids(rng, SPARSE_ENTITIES, SORT_LIMIT, 0.8), SPARSE_ENTITIES),
        ("one above it (torch.sort route)",
         power_law_ids(rng, SPARSE_ENTITIES, SORT_LIMIT + 1, 0.8), SPARSE_ENTITIES),
    ]
    for index, (name, ids_np, num_rows) in enumerate(cases):
        err = scatter_case(rng, device, name, ids_np, num_rows,
                           DIM if index < 5 else 64)
        if index < 3:
            worst = max(worst, err)
    return worst


def scatter_case(rng, device, name, ids_np, num_rows, D) -> float:
    """The scatter kernel on ``ids_np`` and random [n, D] updates against its
    plain version in float64 (``|kernel - reference| <= 1e-6 + 1e-5 S``),
    bit-equal across two launches, its sort against a stable torch.sort;
    returns the largest |error|."""
    from kge_tpu_torch.ops.embedding_ops import (
        SORT_LIMIT,
        sort_route,
        sorted_scatter_add,
        sorted_scatter_add_plain,
    )

    ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
    upd = torch.tensor(
        rng.normal(0, 1, (len(ids_np), D)).astype(np.float32), device=device)
    before = sorted_scatter_add.launches, sorted_scatter_add.torch_sorts
    got = sorted_scatter_add(ids, upd, num_rows)
    again = sorted_scatter_add(ids, upd, num_rows)
    torch.cuda.synchronize()
    by_torch = sort_route(len(ids_np)) == "torch"
    check(by_torch == (len(ids_np) > SORT_LIMIT))
    check(sorted_scatter_add.launches == before[0] + 2, "scatter launches not counted")
    check(sorted_scatter_add.torch_sorts == before[1] + 2 * by_torch,
          f"the sort took another route than sort_route says ({name})")
    check(got.shape == (num_rows, D) and got.dtype == torch.float32)
    check(torch.equal(got, again), f"scatter kernel not deterministic ({name})")
    ref = sorted_scatter_add_plain(ids, upd.double(), num_rows)
    magnitude = sorted_scatter_add_plain(ids, upd.double().abs(), num_rows)
    err = (got.double() - ref).abs()
    check(bool((err <= 1e-6 + 1e-5 * magnitude).all()),
          f"scatter kernel disagrees with its plain version ({name})")
    if not by_torch:
        check_sort_and_segments(name, ids, upd, num_rows)
    strict = float((err <= 1e-6 + 1e-5 * ref.abs()).double().mean())
    counts = torch.bincount(ids, minlength=num_rows)
    log(f"  {name}: n={len(ids_np)} rows={num_rows} D={D}, longest segment "
        f"{int(counts.max())}, {int((counts == 0).sum())} empty rows: bit-equal "
        f"across two launches, max abs err {float(err.max()):.3e} "
        f"({100 * strict:.4f}% of elements also within 1e-6 + 1e-5 |ref|); "
        + ("sorted by torch.sort in the wrapper" if by_torch else
           "sort, permutation and segment numbers equal a stable torch.sort's, "
           "segment sums within tolerance"))
    return float(err.max())


def compare_rows_set(seed: int, device) -> float:
    """Phase 5, row-write kernel: exact, in place, with duplicate ids."""
    from kge_tpu_torch.ops.embedding_ops import rows_set, rows_set_plain

    rng = np.random.default_rng(seed + 3)
    worst = 0.0
    for name, num_rows, ids_np in rows_set_cases(rng):
        table = torch.tensor(
            rng.normal(0, 1, (num_rows, DIM)).astype(np.float32), device=device)
        # one value per distinct row, repeated for duplicates
        values = torch.tensor(
            rng.normal(0, 1, (num_rows, DIM)).astype(np.float32), device=device)
        ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
        rows = values[ids]
        want = rows_set_plain(table.clone(), ids, rows)
        ptr, before = table.data_ptr(), rows_set.launches
        out = rows_set(table, ids, rows)
        torch.cuda.synchronize()
        check(rows_set.launches == before + 1, "row-write launches not counted")
        check(out is table and table.data_ptr() == ptr, "rows_set copied the table")
        check(torch.equal(table, want), f"rows_set differs from its plain version ({name})")
        worst = max(worst, float((table - want).abs().max()))
        duplicates = len(ids_np) - len(np.unique(ids_np))
        log(f"  rows_set {name}: m={len(ids_np)} into [{num_rows}, {DIM}], "
            f"{100 * duplicates / len(ids_np):.1f}% duplicate ids: equal to the "
            f"plain version, storage unchanged")
    return worst


# -- training through the command line ------------------------------------------


def write_train_config(path: str, data: str, seed: int, **extra):
    """bench.py's headline workload as a config file: ComplEx d = 512, 128
    shared negatives per corrupted slot, KL loss, Adagrad lr 0.1, batch
    8,192."""
    import yaml

    options = {
        "job": {"type": "train", "device": "auto"},
        "dataset": {"name": data},
        "model": "complex",
        "lookup_embedder": {"dim": DIM},
        "train": {
            "type": "negative_sampling", "batch_size": TRAIN_BATCH, "loss": "kl",
            "max_epochs": 2,
            "optimizer": {"default": {"type": "Adagrad", "args": {"lr": 0.1}}},
        },
        "negative_sampling": {
            "shared": True, "shared_type": "default", "implementation": "auto",
            "num_samples": {"s": NUM_NEGATIVES, "p": 0, "o": -1},
        },
        "valid": {"every": 2},
        "eval": {"batch_size": BATCH},
        "random_seed": {"default": seed},
        "console": {"quiet": True},
    }
    for key, value in extra.items():
        node = options
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    with open(path, "w") as f:
        yaml.safe_dump(options, f)


def trace_entries(folder: str, **match):
    import yaml

    out = []
    with open(os.path.join(folder, "trace.yaml")) as f:
        for line in f:
            entry = yaml.safe_load(line)
            if all(entry.get(k) == v for k, v in match.items()):
                out.append(entry)
    return out


def reset_counters():
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores
    from kge_tpu_torch.ops.embedding_ops import rows_set, sorted_scatter_add
    from kge_tpu_torch.ops.optim import fused_sorted_update
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    fused_rank_counts.launches = 0
    fused_rank_counts.epilogue_launches = 0
    sorted_scatter_add.launches = 0
    rows_set.launches = 0
    fused_sorted_update.launches = 0
    pooled_dist_scores.launches = 0
    pooled_dist_scores.backward_launches = 0


def read_counters():
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores
    from kge_tpu_torch.ops.embedding_ops import rows_set, sorted_scatter_add
    from kge_tpu_torch.ops.optim import fused_sorted_update
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    return {"rank_counts": fused_rank_counts.launches,
            "rank_counts_epilogue": fused_rank_counts.epilogue_launches,
            "scatter_add_sorted": sorted_scatter_add.launches,
            "rows_set": rows_set.launches,
            "fused_row_update": fused_sorted_update.launches,
            "pooled_scores": pooled_dist_scores.launches,
            "pooled_scores_bwd": pooled_dist_scores.backward_launches}


def resumed_job(folder: str, checkpoint: str, **overrides):
    """A prepared training job on ``checkpoint`` of ``folder``, as ``resume``
    builds it, with configuration overrides."""
    from kge_tpu_torch import Config
    from kge_tpu_torch.job import Job
    from kge_tpu_torch.utils.io import load_checkpoint

    config = Config()
    config.load(os.path.join(folder, "config.yaml"))
    config.folder = folder
    for key, value in overrides.items():
        config.set(key, value)
    job = Job.create_from(load_checkpoint(os.path.join(folder, checkpoint)),
                          new_config=config)
    job._prepare()
    job._is_prepared = True
    return job


def tables_of(job, state=False):
    """Copies of the job's tables, with ``state`` followed by its optimizer
    state's tensors."""
    out = [p.detach().clone() for p in job.optimizer.params]
    if state:
        out += [leaf[k].clone() for leaf in job.opt_state["leaves"]
                for k in sorted(leaf)]
    return out


def one_step_each(folder, checkpoint, key, values, state=False, costs=None,
                  launches=None):
    """The same step (same state, batch and negatives) under the values of
    one configuration key; returns (tables before, tables after per value,
    the batch, the jobs). With ``state`` the optimizer state counts as
    tables; ``costs`` and ``launches`` (lists) receive each step's cost and
    its kernel launch counts."""
    jobs = [resumed_job(folder, checkpoint, **{key: value}) for value in values]
    batch = next(iter(jobs[0]._batches()))
    variant = jobs[0]._step_variant(batch)
    device = jobs[0].device
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
             if k != "true_size" and not isinstance(v, str)}
    if hasattr(jobs[0], "_with_negatives"):
        batch = jobs[0]._with_negatives(batch)
    before = tables_of(jobs[0], state)
    after = []
    for job in jobs:
        reset_counters()
        cost, _ = job._train_step(dict(batch), job._current_lrs(), variant)
        after.append(tables_of(job, state))
        if costs is not None:
            costs.append(float(cost))
        if launches is not None:
            launches.append(read_counters())
    torch.cuda.synchronize()
    return before, after, batch, jobs


def check_tables_close(a, b, what):
    worst = 0.0
    for x, y in zip(a, b):
        err = (x - y).abs()
        check(bool((err <= 1e-6 + 1e-5 * y.abs()).all()), what)
        worst = max(worst, float(err.max()))
    return worst


def warm_epoch(job, num_train: int, what: str, unit: str = "triples",
               profiled: bool = True, warmup: bool = True):
    """A warm epoch of a prepared job: wall by the host clock around work
    that ends in a synchronize, then (``profiled``) the same under the
    profiler. ``num_train`` examples an epoch, counted in ``unit``. Without
    ``warmup`` no epoch runs before the timed one (for a job whose steps
    already ran)."""
    if warmup:
        job.epoch += 1
        job.run_epoch()  # warms allocator and caches
    torch.cuda.synchronize()
    start = time.perf_counter()
    job.epoch += 1
    entry = job.run_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    log(f"  warm epoch of {what}: wall {wall:.3f} s ({num_train / wall:.1f} "
        f"{unit}/s), {entry['batches']} batches, avg_loss {entry['avg_loss']:.4f}")

    out = {"wall_s": wall, f"{unit}_per_s": num_train / wall}
    if profiled:
        def epoch():
            job.epoch += 1
            job.run_epoch()

        out["profile"] = profile_run(epoch, f"warm epoch of {what}")
    return out


def run_dense_training(seed: int, data: str):
    """Phase 6; returns a summary dict."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.utils.io import load_checkpoint

    num_train, num_valid = FB15K237[2], FB15K237[3]
    steps = -(-num_train // TRAIN_BATCH)
    valid_batches = -(-num_valid // BATCH)
    folder = os.path.join(WORK, "train_dense")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_dense.yaml")
    write_train_config(conf, data, seed)

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    log(f"  start, 2 epochs and one validation: wall {start_wall:.2f} s; launches {counts}")
    # 5 scatter launches a step: the lookups of s, p and o and one target
    # list per corrupted slot (s and o); 2 rank launches a validation batch
    check(counts["scatter_add_sorted"] == 5 * steps * 2,
          f"scatter launches {counts['scatter_add_sorted']} != 5 x {steps} x 2")
    check(counts["rank_counts"] == 2 * valid_batches,
          f"rank launches {counts['rank_counts']} != 2 x {valid_batches}")
    check(counts["rows_set"] == 0, "the dense step wrote rows")
    log(f"  scatter kernel: 5 launches x {steps} steps x 2 epochs = "
        f"{counts['scatter_add_sorted']}; rank kernel: 2 x {valid_batches} "
        f"validation batches = {counts['rank_counts']}")
    epochs = trace_entries(folder, event="epoch_completed")
    check([e["epoch"] for e in epochs] == [1, 2], "expected epochs 1 and 2")
    losses = [e["avg_loss"] for e in epochs]
    check(all(np.isfinite(losses)) and losses[1] < losses[0],
          f"loss did not fall: {losses}")
    (valid,) = trace_entries(folder, event="eval_completed")
    check(0.0 < valid["mean_reciprocal_rank_filtered"] <= 1.0)
    log(f"  avg_loss {losses[0]:.4f} -> {losses[1]:.4f}; epoch times "
        f"{epochs[0]['epoch_time']:.3f} s, {epochs[1]['epoch_time']:.3f} s; "
        f"validation MRR filtered {valid['mean_reciprocal_rank_filtered']:.6f}")

    # resume to epoch 3 (valid.last validates the last epoch)
    saved = load_checkpoint(os.path.join(folder, "checkpoint_00002.pt"))
    check(saved["epoch"] == 2 and int(saved["optimizer_state"]["step"]) == 2 * steps)
    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    resumed_counts = read_counters()
    check(resumed_counts["scatter_add_sorted"] == 5 * steps, resumed_counts)
    check(resumed_counts["rank_counts"] == 2 * valid_batches, resumed_counts)
    epochs = trace_entries(folder, event="epoch_completed")
    check([e["epoch"] for e in epochs] == [1, 2, 3], "resume did not run epoch 3")
    check(epochs[2]["avg_loss"] < epochs[1]["avg_loss"], "loss rose after resume")
    (resumed,) = trace_entries(folder, event="job_resumed", job="train")
    check(resumed["epoch"] == 2, "resume did not start from epoch 2")
    last = load_checkpoint(os.path.join(folder, "checkpoint_00003.pt"))
    check(last["epoch"] == 3 and int(last["optimizer_state"]["step"]) == 3 * steps)
    for before, after in zip(saved["optimizer_state"]["leaves"],
                             last["optimizer_state"]["leaves"]):
        # Adagrad's sum only grows: the resumed job went on from the saved one
        check(bool((after["sum"] >= before["sum"]).all())
              and float(after["sum"].sum()) > float(before["sum"].sum()),
              "the resumed job did not start from the saved Adagrad sum")
    log(f"  resume to epoch 3: launches {resumed_counts}, avg_loss "
        f"{epochs[2]['avg_loss']:.4f}, optimizer step {3 * steps}, Adagrad sum "
        f"grew from the saved one")

    before, (kernel, never), _, jobs = one_step_each(
        folder, "checkpoint_00003.pt", "train.pallas_gather", ("always", "never"))
    worst = check_tables_close(
        kernel, never, "a step with the scatter kernel differs from the same "
        "step with torch's indexing backward")
    moved = max(float((a - b).abs().max()) for a, b in zip(kernel, before))
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  one step, scatter kernel vs train.pallas_gather=never: max abs "
        f"difference {worst:.3e} (tables moved by up to {moved:.3e}); "
        f"tolerance atol 1e-6 + rtol 1e-5")
    timing = warm_epoch(jobs[0], num_train, "T-dense")
    return {"launches": counts, "start_wall_s": start_wall, "avg_loss": losses,
            "epoch_time_s": [e["epoch_time"] for e in epochs],
            "step_max_abs_diff_vs_never": worst, "warm_epoch": timing}


def run_sparse_training(seed: int):
    """Phase 7; returns a summary dict."""
    from kge_tpu_torch import cli

    sizes = (SPARSE_ENTITIES,) + FB15K237[1:]
    num_train = sizes[2]
    steps = -(-num_train // TRAIN_BATCH)
    data = os.path.join(WORK, "sparse_synthetic")
    write_dataset(data, seed + 5, sizes=sizes)
    folder = os.path.join(WORK, "train_sparse")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_sparse.yaml")
    write_train_config(conf, data, seed, **{"train.max_epochs": 1, "valid.every": 0})

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    with open(os.path.join(folder, "kge.log")) as f:
        engaged = "Using row-sparse embedding updates" in f.read()
    check(engaged, "train.sparse_embedding_update=auto did not engage at "
          f"{SPARSE_ENTITIES} entities")
    # 4 row writes a step: parameter and Adagrad sum of both tables; 7
    # scatter launches: five lookups on the mini-tables, two segment sums
    check(counts["rows_set"] == 4 * steps,
          f"row-write launches {counts['rows_set']} != 4 x {steps}")
    check(counts["scatter_add_sorted"] == 7 * steps,
          f"scatter launches {counts['scatter_add_sorted']} != 7 x {steps}")
    (epoch,) = trace_entries(folder, event="epoch_completed")
    check(np.isfinite(epoch["avg_loss"]), "loss is not finite")
    log(f"  start, 1 epoch at {SPARSE_ENTITIES} entities: wall {start_wall:.2f} s, "
        f"epoch {epoch['epoch_time']:.3f} s, avg_loss {epoch['avg_loss']:.4f}; the "
        f"log shows the row-sparse path engaged by auto; rows_set 4 x {steps} = "
        f"{counts['rows_set']} launches, scatter 7 x {steps} = "
        f"{counts['scatter_add_sorted']}")

    before, (sparse, dense), batch, jobs = one_step_each(
        folder, "checkpoint_00001.pt", "train.sparse_embedding_update",
        ("auto", "never"))
    check(jobs[0]._sparse_update and not jobs[1]._sparse_update)
    worst = check_tables_close(
        sparse, dense, "the row-sparse step differs from the dense step")
    touched = torch.zeros(SPARSE_ENTITIES, dtype=torch.bool, device=before[0].device)
    for ids in (batch["triples"][:, 0], batch["triples"][:, 2],
                batch["neg_unique_0"], batch["neg_unique_2"]):
        touched[ids] = True
    check(torch.equal(sparse[0][~touched], before[0][~touched]),
          "the row-sparse step changed rows that the batch did not name")
    check(torch.equal(dense[0][~touched], before[0][~touched]))
    moved = float((sparse[0] - before[0]).abs().max())
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  one step, row-sparse vs dense: max abs difference {worst:.3e} "
        f"(tables moved by up to {moved:.3e}; tolerance atol 1e-6 + rtol 1e-5); "
        f"{int((~touched).sum())} untouched entity rows bit-equal")
    del jobs[1], dense
    torch.cuda.empty_cache()
    timing = warm_epoch(jobs[0], num_train, "T-sparse")
    return {"launches": counts, "start_wall_s": start_wall,
            "avg_loss": epoch["avg_loss"], "epoch_time_s": epoch["epoch_time"],
            "step_max_abs_diff_vs_dense": worst, "warm_epoch": timing}


# -- the fused row update against its plain version ------------------------------


def fused_cases(rng):
    """(name, rows, D, ids): the two tables of a P-rotate step. The entity
    table takes the lookups of s and o (power law) and of both pools
    (uniform); the relation table the lookups of p, where a few rows own
    most of the batch."""
    entity_ids = np.concatenate([
        power_law_ids(rng, SPARSE_ENTITIES, 2 * ROTATE_BATCH, 0.8),
        rng.integers(0, SPARSE_ENTITIES, 2 * NUM_NEGATIVES * POOL_FACTOR),
    ])
    return [
        ("entity table", SPARSE_ENTITIES, ROTATE_DIM, entity_ids),
        ("relation table", FB15K237[1], ROTATE_DIM // 2,
         power_law_ids(rng, FB15K237[1], ROTATE_BATCH, 1.0)),
    ]


# (rule, args, step); the first four run at both shapes, the rest at the
# relation table's only
FUSED_RULES = [
    ("adam", {}, 3),
    ("adamw", {"weight_decay": 0.01}, 3),
    ("adagrad", {"weight_decay": 0.01, "lr_decay": 0.1}, 3),
    ("sgd", {"momentum": 0.9, "nesterov": True, "weight_decay": 0.01}, 3),
    ("sgd", {"momentum": 0.9, "dampening": 0.1}, 0),
    ("sgd", {}, 3),
    ("adam", {"weight_decay": 0.01, "betas": (0.8, 0.99)}, 0),
    ("adamax", {"weight_decay": 0.01}, 3),
    ("rmsprop", {}, 3),
    ("rmsprop", {"centered": True, "momentum": 0.9, "weight_decay": 0.01}, 3),
    ("adadelta", {"weight_decay": 0.01}, 3),
]


def fused_state(opt_type, args, rows, D, generator, device):
    """A random parameter and non-zero random states of the rule, so that
    what the rule does to untouched rows shows: first moments in [-0.1,
    0.1), second moments in [0.01, 0.11) (at least the first one's
    square, as the rules keep them)."""
    from kge_tpu_torch.ops.optim import _RULES

    def rand(scale):
        return scale * torch.rand(rows, D, generator=generator, device=device)

    param = rand(0.2) - 0.1
    states = {
        key: rand(0.2) - 0.1 if key in ("m", "momentum", "avg") else 0.01 + rand(0.1)
        for key in _RULES[opt_type][0](param[:1], args)
    }
    return param, states


def signed_updates(ids, D, generator):
    """Row gradients [n, D] of magnitude in [0.1, 1.1) whose sign depends on
    (id, column) only: the duplicates of a row agree in sign, so that no
    row's sum cancels. A sum that cancels is off by rounding in proportion
    to the summed magnitudes, not to its own value (phase 5 holds the
    scatter kernel to that), and Adam's ``m_hat / (sqrt(v_hat) + eps)`` or
    Adagrad's first step would turn such a gradient's uncertain sign into
    a step of +-lr: the rule's arithmetic is checked where that cannot
    happen."""
    n = ids.shape[0]
    magnitude = 0.1 + torch.rand(n, D, generator=generator, device=ids.device)
    columns = torch.arange(D, device=ids.device)
    sign = ((ids[:, None] + columns[None, :]) % 2) * 2 - 1
    return magnitude * sign


def compare_fused_update(seed: int, device) -> float:
    """Phase 9; returns the largest |error| of Adam at the entity table."""
    from kge_tpu_torch.ops.optim import (
        fused_sorted_update,
        fused_sorted_update_plain,
    )

    rng = np.random.default_rng(seed + 7)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 7)
    main_err = None
    lr = ROTATE_LR
    for case, (name, rows, D, ids_np) in enumerate(fused_cases(rng)):
        ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
        n = len(ids_np)
        touched = torch.zeros(rows, dtype=torch.bool, device=device)
        touched[ids] = True
        duplicates = n - int(touched.sum())
        log(f"  {name} [{rows}, {D}], n={n} row gradients, "
            f"{100 * duplicates / n:.1f}% duplicate ids, "
            f"{int((~touched).sum())} untouched rows")
        for opt_type, args, step in (FUSED_RULES[:4] if case == 0 else FUSED_RULES):
            param, states = fused_state(opt_type, args, rows, D, generator, device)
            upd = signed_updates(ids, D, generator)
            ref_param = param.double()
            ref_states = {k: v.double() for k, v in states.items()}
            fused_sorted_update_plain(opt_type, args, ids, upd.double(), ref_param,
                                      ref_states, lr, step)
            runs = []
            for _ in range(2):
                p = param.clone()
                st = {k: v.clone() for k, v in states.items()}
                ptrs = [p.data_ptr()] + [st[k].data_ptr() for k in sorted(st)]
                before = fused_sorted_update.launches
                out = fused_sorted_update(opt_type, args, ids, upd, p, st, lr, step)
                torch.cuda.synchronize()
                check(fused_sorted_update.launches == before + 1,
                      "fused update launches not counted")
                check(out is st and ptrs == [p.data_ptr()]
                      + [st[k].data_ptr() for k in sorted(st)],
                      "the fused update moved the parameter or a state")
                runs.append((p, st))
            (p, st), (p2, st2) = runs
            check(torch.equal(p, p2) and all(torch.equal(st[k], st2[k]) for k in st),
                  f"fused update not deterministic ({opt_type}, {name})")
            worst, worst_ratio = 0.0, 0.0
            for what, got, ref in [("param", p, ref_param)] + [
                (k, st[k], ref_states[k]) for k in sorted(st)
            ]:
                err = (got.double() - ref).abs()
                ratio = float((err / (1e-6 + 1e-5 * ref.abs())).max())
                check(ratio <= 1.0, f"fused update {opt_type} {args} at the {name}: "
                      f"{what} off by {float(err.max()):.3e} ({ratio:.2f} x tolerance)")
                worst, worst_ratio = max(worst, float(err.max())), max(worst_ratio, ratio)
            moved = float((p - param)[~touched].abs().max()) if (~touched).any() else 0.0
            zero_gradient = opt_type == "adamw" or not args.get("weight_decay")
            if opt_type in ("adam", "adamw") and zero_gradient and (~touched).any():
                b1, b2 = args.get("betas", (0.9, 0.999))
                check(torch.equal(st["m"][~touched], (b1 * states["m"])[~touched])
                      and torch.equal(st["v"][~touched], (b2 * states["v"])[~touched]),
                      "Adam's moments of untouched rows are not beta * moment")
                check(moved > 0, "Adam left untouched rows where they were")
            log(f"    {opt_type} {args} step {step}: max abs err {worst:.3e} "
                f"({worst_ratio:.3f} x tolerance), untouched rows moved by up to "
                f"{moved:.3e}, storage kept, two launches bit-equal")
            if main_err is None:
                main_err = worst
            del param, states, upd, ref_param, ref_states, runs, p, st, p2, st2
        torch.cuda.empty_cache()
    return main_err


# -- the pooled distance kernels against their plain version ----------------------


def pooled_inputs(kind, n, K, F, d, generator, device, stride_parts=False,
                  outside=False):
    """Random queries, pool and sel; a few rows' queries equal one of their
    candidates (distance 0: sign(0) and the modulus' epsilon). With
    ``stride_parts`` the two pool parts are the column halves of one table,
    as the model passes them; with ``outside`` about a fifth of sel lies
    outside [0, F) (-1, F and F + 7)."""
    parts = 1 if kind == "l1" else 2

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    sel = torch.randint(0, F, (n, K), generator=generator, device=device,
                        dtype=torch.int32)
    if stride_parts and parts == 2:
        pools = list(torch.chunk(randn(K * F, 2 * d), 2, dim=1))
    else:
        pools = [randn(K * F, d) for _ in range(parts)]
    queries = [randn(n, d) for _ in range(parts)]
    for i in range(0, n, max(1, n // 7)):
        j = i % K
        for q, pool in zip(queries, pools):
            q[i] = pool[j * F + int(sel[i, j])]
    if outside:
        draw = torch.rand(n, K, generator=generator, device=device)
        sel[draw < 0.1] = -1
        sel[(draw >= 0.1) & (draw < 0.15)] = F
        sel[(draw >= 0.15) & (draw < 0.2)] = F + 7
    return queries, pools, sel


def pooled_reference(queries, pools, sel, F, kind, g, rows_per_chunk=512):
    """Scores, dq and dpool of the plain version in float64, a chunk of
    rows at a time, and the magnitude sums of the tolerance: |factor| <= |g|,
    so dq[i] adds up at most sum_j |g[i, j]| and dpool[j F + f] at most the
    sum of |g[i, j]| over the rows that selected it. A sel outside [0, F)
    stands for a zero candidate and no pool row, as in the kernels: the
    plain version runs on pools with a zero row appended to every group."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores_plain

    n, K = sel.shape
    d = queries[0].shape[1]
    inside = (sel >= 0) & (sel < F)
    sel_z = torch.where(inside, sel, torch.full_like(sel, F))
    zeros = torch.zeros(K, 1, d, dtype=torch.float64, device=sel.device)
    pools64 = [torch.cat([p.double().reshape(K, F, d), zeros], 1)
               .reshape(K * (F + 1), d).requires_grad_(True) for p in pools]
    scores = [torch.zeros(0, K, dtype=torch.float64, device=sel.device)]
    dqs = [[torch.zeros(0, d, dtype=torch.float64, device=sel.device)]
           for _ in queries]
    dpools = [torch.zeros_like(p) for p in pools64]
    for start in range(0, n, rows_per_chunk):
        rows = slice(start, start + rows_per_chunk)
        q64 = [q[rows].double().requires_grad_(True) for q in queries]
        out = pooled_dist_scores_plain(q64, pools64, sel_z[rows], F + 1, kind)
        grads = torch.autograd.grad(out, q64 + pools64, g[rows].double())
        scores.append(out.detach())
        for part, dq in enumerate(grads[:len(q64)]):
            dqs[part].append(dq)
        for part, dp in enumerate(grads[len(q64):]):
            dpools[part] += dp
    pool_rows = (torch.arange(K, device=sel.device)[None, :] * F + sel.long())
    mag_pool = torch.zeros(K * F, dtype=torch.float64, device=sel.device)
    mag_pool.index_add_(0, pool_rows[inside], g.double().abs()[inside])
    dpools = [dp.reshape(K, F + 1, d)[:, :F].reshape(K * F, d) for dp in dpools]
    return (torch.cat(scores), [torch.cat(d) for d in dqs], dpools,
            g.double().abs().sum(dim=1), mag_pool)


POOLED_CASES = [
    # (name, kind, n, K, F, d, pool parts as column halves of one table,
    #  sel partly outside [0, F))
    ("TransE d=128", "l1", TRAIN_BATCH, NUM_NEGATIVES, POOL_FACTOR, TRANSE_DIM, False,
     False),
    ("TransE d=512", "l1", TRAIN_BATCH, NUM_NEGATIVES, POOL_FACTOR, 512, False, False),
    ("RotatE d=1024", "cmod", ROTATE_BATCH, NUM_NEGATIVES, POOL_FACTOR,
     ROTATE_DIM // 2, True, False),
    ("odd l1", "l1", 37, 5, 3, 100, False, False),
    ("odd cmod", "cmod", 37, 5, 3, 100, True, False),
    ("scalar l1", "l1", 37, 5, 3, 51, False, False),
    ("scalar cmod", "cmod", 37, 5, 3, 51, True, False),
    # the backward's edges: K = 1,024; several row chunks with n no multiple
    # of one; K no multiple of a block's 8 slots and d of the 128-column
    # tile; F = 1, F = 16 and F = 100 (dq's pool groups too large to stage);
    # sel outside [0, F); no rows
    ("K=1024 l1", "l1", 2048, 1024, POOL_FACTOR, TRANSE_DIM, False, False),
    ("K=1024 cmod", "cmod", 1024, 1024, POOL_FACTOR, 256, True, False),
    ("chunks l1", "l1", 1000, NUM_NEGATIVES, POOL_FACTOR, TRANSE_DIM, False, False),
    ("chunks cmod", "cmod", 999, 64, POOL_FACTOR, 256, True, False),
    ("K=13 d=300 l1", "l1", 300, 13, POOL_FACTOR, 300, False, False),
    ("K=13 d=300 cmod", "cmod", 300, 13, POOL_FACTOR, 300, True, False),
    ("F=1 l1", "l1", 500, 64, 1, TRANSE_DIM, False, False),
    ("F=16 cmod", "cmod", 500, 40, 16, 192, True, False),
    ("F=100 cmod", "cmod", 200, 6, 100, 128, True, False),
    ("outside l1", "l1", 300, 24, POOL_FACTOR, TRANSE_DIM, False, True),
    ("outside cmod", "cmod", 300, 24, POOL_FACTOR, 100, True, True),
    ("n=0 l1", "l1", 0, 16, 4, 64, False, False),
    ("n=0 cmod", "cmod", 0, 16, 4, 64, True, False),
    # the forward's edges: n and K one past a block's 256 rows and 16 slots,
    # d = 132 in five 32-column tiles (the last of one vector); F = 24, whose
    # pool rows a stage holds for l1 and not for cmod; F = 60 from L2
    ("fwd edges l1", "l1", 257, 17, POOL_FACTOR, 132, False, False),
    ("fwd edges cmod", "cmod", 257, 17, POOL_FACTOR, 132, True, False),
    ("F=24 l1", "l1", 300, 20, 24, 64, False, False),
    ("F=24 cmod", "cmod", 300, 20, 24, 64, True, False),
    ("F=60 l1", "l1", 150, 9, 60, 40, False, False),
    ("F=60 cmod", "cmod", 150, 9, 60, 40, True, False),
]


def compare_pooled(seed: int, device):
    """Phase 10; returns (max |scores error|, max |gradient error|) at
    P-rotate's shape."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores

    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 8)
    main = None
    for name, kind, n, K, F, d, stride_parts, outside in POOLED_CASES:
        queries, pools, sel = pooled_inputs(kind, n, K, F, d, generator, device,
                                            stride_parts, outside)
        g = torch.randn(n, K, generator=generator, device=device)
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_(True) for t in queries + pools]
            if stride_parts and kind == "cmod":
                table = torch.cat(pools, dim=1).requires_grad_(True)
                leaves[2:] = torch.chunk(table, 2, dim=1)
            fwd, bwd = (pooled_dist_scores.launches,
                        pooled_dist_scores.backward_launches)
            out = pooled_dist_scores(leaves[:len(queries)], leaves[len(queries):],
                                     sel, F, kind)
            grads = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            check(pooled_dist_scores.launches == fwd + (n > 0)
                  and pooled_dist_scores.backward_launches == bwd + 1,
                  "pooled kernel launches not counted")
            runs.append((out.detach(), grads))
        (out, grads), (out2, grads2) = runs
        check(torch.equal(out, out2)
              and all(torch.equal(a, b) for a, b in zip(grads, grads2)),
              f"pooled kernels not deterministic ({name})")
        ref, ref_dqs, ref_dpools, mag_q, mag_pool = pooled_reference(
            queries, pools, sel, F, kind, g)
        err = (out.double() - ref).abs()
        check(bool((err <= 1e-6 + 1e-5 * ref.abs()).all()),
              f"pooled scores disagree with the plain version ({name})")
        grad_err = 0.0
        parts = len(queries)
        for what, got, want, mag in (
            [("dq", a, b, mag_q) for a, b in zip(grads[:parts], ref_dqs)]
            + [("dpool", a, b, mag_pool) for a, b in zip(grads[parts:], ref_dpools)]
        ):
            e = (got.double() - want).abs()
            e_max = float(e.max()) if e.numel() else 0.0
            check(bool((e <= 1e-6 + 1e-5 * mag[:, None]).all()),
                  f"pooled {what} disagrees with the plain version ({name}): "
                  f"max abs err {e_max:.3e}")
            grad_err = max(grad_err, e_max)
        zero_rows = int((ref == 0).sum()) if kind == "l1" else int(
            (ref.abs() <= 1.01e-15 * d).sum())
        top = float(ref.abs().max()) if n else 0.0
        log(f"  {name} ({kind}) n={n} K={K} F={F} d={d}: scores max abs err "
            f"{float(err.max()) if n else 0.0:.3e} (|score| up to {top:.1f}), "
            f"dq/dpool max abs err {grad_err:.3e}; {zero_rows} scores at distance 0; "
            f"two launches bit-equal")
        if name == "RotatE d=1024":
            main = (float(err.max()), grad_err)
        del queries, pools, sel, g, runs, out, grads, out2, grads2, ref, ref_dqs
        del ref_dpools
        torch.cuda.empty_cache()
    check_infinite_terms(generator, device)
    return main


def check_infinite_terms(generator, device):
    """``cmod`` terms of +inf (a difference whose square overflows float32)
    and NaN: the forward gives sqrtf's scores, -inf and NaN where the plain
    version in float32 has them, and the others within phase 10's rule."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores, pooled_dist_scores_plain

    F = POOL_FACTOR
    queries, pools, sel = pooled_inputs("cmod", 300, 40, F, 256, generator, device)
    queries[0][3, 5] = 3e19      # every pair of row 3
    queries[1][7, 0] = float("nan")  # every pair of row 7
    pools[0][2 * F + 1, 7] = -3e19   # the pairs (i, 2) that select it
    out = pooled_dist_scores(queries, pools, sel, F, "cmod")
    plain = pooled_dist_scores_plain(queries, pools, sel, F, "cmod")
    ref = pooled_dist_scores_plain([q.double() for q in queries],
                                   [p.double() for p in pools], sel, F, "cmod")
    finite = torch.isfinite(plain)
    check(torch.equal(torch.isnan(out), torch.isnan(plain))
          and torch.equal(torch.isinf(out), torch.isinf(plain))
          and torch.equal(out[~finite & ~torch.isnan(out)],
                          plain[~finite & ~torch.isnan(plain)])
          and bool(((out.double() - ref).abs() <= 1e-6 + 1e-5 * ref.abs())[finite].all()),
          "pooled scores with infinite or NaN terms differ from sqrtf's")
    log(f"  cmod with infinite and NaN terms: {int(torch.isinf(out).sum())} scores -inf, "
        f"{int(torch.isnan(out).sum())} NaN, as the plain version's")


# -- training with pooled negatives -------------------------------------------------


def pooled_config(which: str):
    """Overrides of ``write_train_config`` for bench.py's transe_margin and
    rotate_selfadv workloads."""
    common = {"negative_sampling.shared": False, "valid.every": 0}
    if which == "transe":
        return {**common, "model": "transe", "lookup_embedder.dim": TRANSE_DIM,
                "train.loss": "margin_ranking",
                "train.loss_arg": 4.0, "train.max_epochs": 2}
    return {**common, "model": "rotate", "lookup_embedder.dim": ROTATE_DIM,
            "train.loss": "bce_self_adversarial", "train.batch_size": ROTATE_BATCH,
            "train.max_epochs": 1,
            "train.optimizer.default": {"type": "Adam", "args": {"lr": ROTATE_LR}}}


def check_pooled_counts(counts, steps, scatter_per_step, fused_per_step, what):
    """Per step two corrupted entity slots: one pooled forward and one
    backward each."""
    expected = {"pooled_scores": 2 * steps, "pooled_scores_bwd": 2 * steps,
                "scatter_add_sorted": scatter_per_step * steps,
                "fused_row_update": fused_per_step * steps, "rows_set": 0,
                "rank_counts": 0, "rank_counts_epilogue": 0}
    check(counts == expected, f"{what}: launches {counts} != {expected}")


def run_transe_training(seed: int, data: str):
    """Phase 11; returns a summary dict."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.utils.io import load_checkpoint

    num_train = FB15K237[2]
    steps = -(-num_train // TRAIN_BATCH)
    folder = os.path.join(WORK, "train_transe")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_transe.yaml")
    write_train_config(conf, data, seed, **pooled_config("transe"))

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    # 12 scatter launches a step: per corrupted slot the lookups of s, p and
    # o (positive score), of the two kept slots, and of the pool
    check_pooled_counts(counts, 2 * steps, 12, 0, "P-transe start")
    with open(os.path.join(folder, "kge.log")) as f:
        check("Set negative_sampling.implementation=pool" in f.read(),
              "auto did not resolve to pool")
    epochs = trace_entries(folder, event="epoch_completed")
    losses = [e["avg_loss"] for e in epochs]
    check([e["epoch"] for e in epochs] == [1, 2] and all(np.isfinite(losses))
          and losses[1] < losses[0], f"P-transe loss did not fall: {losses}")
    log(f"  start, 2 epochs: wall {start_wall:.2f} s; auto resolved to pool; "
        f"launches {counts} (= 2, 2 and 12 a step x {steps} steps x 2 epochs); "
        f"avg_loss {losses[0]:.4f} -> {losses[1]:.4f}")

    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    check_pooled_counts(read_counters(), steps, 12, 0, "P-transe resume")
    epochs = trace_entries(folder, event="epoch_completed")
    check([e["epoch"] for e in epochs] == [1, 2, 3]
          and epochs[2]["avg_loss"] < epochs[1]["avg_loss"],
          "P-transe: resume did not run a better epoch 3")
    last = load_checkpoint(os.path.join(folder, "checkpoint_00003.pt"))
    check(last["epoch"] == 3 and int(last["optimizer_state"]["step"]) == 3 * steps)
    log(f"  resume to epoch 3: avg_loss {epochs[2]['avg_loss']:.4f}, optimizer "
        f"step {3 * steps}")
    job = resumed_job(folder, "checkpoint_00003.pt")
    routes = time_pooled_routes(job)
    timing = warm_epoch(job, num_train, "P-transe")
    return {"launches": counts, "start_wall_s": start_wall, "avg_loss": losses,
            "routes_d128": routes, "warm_epoch": timing, "folder": folder}


def time_pooled_routes(job):
    """The pooled scoring of one batch's subject corruption (forward and
    backward to the tables) by its two routes: the kernel and the one-hot
    select, at d = 128."""
    batch = next(iter(job._batches()))
    triples = torch.as_tensor(batch["triples"]).to(job.device)
    drawn = job._draw_negatives_on_device(triples, 0)
    params = job.optimizer.params
    job._enter_step()
    out = {}
    for mode in ("auto", "never"):
        job.model.config.set("negative_sampling.pooled_kernel", mode)

        def forward():
            return job.model.score_spo_neg_pooled(
                triples, drawn["neg_pool_0"], drawn["neg_sel_0"], POOL_FACTOR, 0)

        def both():
            return torch.autograd.grad(forward().sum(), params)

        with torch.no_grad():
            fwd_ms = time_ms(forward, reps=10)
        out[mode] = {"forward_ms": fwd_ms, "forward_backward_ms": time_ms(both, reps=10)}
    job.model.config.set("negative_sampling.pooled_kernel", "auto")
    log(f"  pooled scoring of one slot at n={triples.shape[0]} d={TRANSE_DIM} "
        f"(lookups and their scatter included): kernel route forward "
        f"{out['auto']['forward_ms']:.4f} ms, forward+backward "
        f"{out['auto']['forward_backward_ms']:.4f} ms; one-hot select route "
        f"{out['never']['forward_ms']:.4f} ms and "
        f"{out['never']['forward_backward_ms']:.4f} ms")
    return out


def run_rotate_training(seed: int):
    """Phase 12; returns a summary dict. Uses the 200,000-entity graph that
    phase 7 wrote."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.utils.io import load_checkpoint

    num_train = FB15K237[2]
    steps = -(-num_train // ROTATE_BATCH)
    data = os.path.join(WORK, "sparse_synthetic")
    folder = os.path.join(WORK, "train_rotate")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_rotate.yaml")
    write_train_config(conf, data, seed, **pooled_config("rotate"))

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    with open(os.path.join(folder, "kge.log")) as f:
        engaged = ("Using row-sparse embedding updates (fused dense-semantics "
                   "kernel)") in f.read()
    check(engaged, "train.sparse_embedding_update=auto did not engage the fused "
          "row update for RotatE with Adam")
    # 14 scatter launches a step: 12 lookups on the mini-tables and the
    # segment sums of the two fused updates
    check_pooled_counts(counts, steps, 14, 2, "P-rotate start")
    (first,) = trace_entries(folder, event="epoch_completed")
    saved = load_checkpoint(os.path.join(folder, "checkpoint_00001.pt"))
    check(int(saved["optimizer_state"]["step"]) == steps)
    for leaf in saved["optimizer_state"]["leaves"]:
        check(sorted(leaf) == ["m", "v"] and float(np.abs(leaf["m"]).max()) > 0
              and float(leaf["v"].min()) >= 0 and float(leaf["v"].max()) > 0,
              "the checkpoint holds no Adam moments")
    log(f"  start, 1 epoch at {SPARSE_ENTITIES} entities: wall {start_wall:.2f} s, "
        f"epoch {first['epoch_time']:.3f} s, avg_loss {first['avg_loss']:.4f}; the "
        f"log shows the row-sparse step with the fused kernel; launches {counts} "
        f"(= 2 fused, 2 + 2 pooled, 14 scatter a step x {steps} steps)")

    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "2"])
    torch.cuda.synchronize()
    check_pooled_counts(read_counters(), steps, 14, 2, "P-rotate resume")
    epochs = trace_entries(folder, event="epoch_completed")
    losses = [e["avg_loss"] for e in epochs]
    check([e["epoch"] for e in epochs] == [1, 2] and all(np.isfinite(losses))
          and losses[1] < losses[0], f"P-rotate loss did not fall: {losses}")
    last = load_checkpoint(os.path.join(folder, "checkpoint_00002.pt"))
    check(last["epoch"] == 2 and int(last["optimizer_state"]["step"]) == 2 * steps)
    # had the resumed job started from zero moments, v could not exceed what
    # one epoch accumulates; it went on from the saved ones
    for before, after in zip(saved["optimizer_state"]["leaves"],
                             last["optimizer_state"]["leaves"]):
        check(float(after["v"].sum()) > float(before["v"].sum()),
              "the resumed job did not go on from the saved Adam moments")
    # (the trainer keeps only the newest checkpoint of epochs off
    # train.checkpoint.every, so the first one is gone by now)
    job = resumed_job(folder, "checkpoint_00002.pt")
    for leaf, before in zip(job.opt_state["leaves"], last["optimizer_state"]["leaves"]):
        check(all(np.array_equal(leaf[k].cpu().numpy(), before[k]) for k in ("m", "v")),
              "Adam's moments did not come back from the checkpoint")
    del job
    log(f"  resume to epoch 2: avg_loss {losses[0]:.4f} -> {losses[1]:.4f}, "
        f"optimizer step {2 * steps}, Adam's m and v came back from the checkpoint")

    before, (sparse, dense), batch, jobs = one_step_each(
        folder, "checkpoint_00002.pt", "train.sparse_embedding_update",
        ("auto", "never"), state=True)
    check(jobs[0]._sparse_update and not jobs[1]._sparse_update)
    worst, loose, total = 0.0, 0, 0
    for a, b in zip(sparse, dense):
        err = (a - b).abs()
        off = err > 1e-6 + 1e-5 * b.abs()
        check(bool((err[off] <= 2.1 * ROTATE_LR).all()),
              "the sparse Adam step differs from the dense step by more than 2.1 lr")
        loose += int(off.sum())
        total += err.numel()
        worst = max(worst, float(err.max()))
    check(loose <= 1e-5 * total, f"{loose} of {total} elements of the sparse Adam "
          "step are off the dense step's by more than 1e-6 + 1e-5 |dense|")
    moved = max(float((a - b).abs().max()) for a, b in zip(sparse, before))
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  one step, row-sparse (fused Adam) vs dense, tables and moments of every "
        f"row: max abs difference {worst:.3e}; {loose} of {total} elements beyond "
        f"1e-6 + 1e-5 |dense| (all within 2.1 lr = {2.1 * ROTATE_LR:.1e}; allowed "
        f"{int(1e-5 * total)}); the step moved the tables by up to {moved:.3e}")
    del jobs[1], dense, sparse, before
    torch.cuda.empty_cache()
    timing = warm_epoch(jobs[0], num_train, "P-rotate")
    return {"launches": counts, "start_wall_s": start_wall, "avg_loss": losses,
            "epoch_time_s": [e["epoch_time"] for e in epochs],
            "step_max_abs_diff_vs_dense": worst, "step_elements_beyond_tolerance": loose,
            "warm_epoch": timing}


# -- T-transe-l2: the L2 epilogue, and evaluation of the distance models --------

L2_BATCH, L2_NEGATIVES = 2048, 64   # examples/fb15k-237-transe-negsamp.yaml


def l2_inputs(seed: int, device, n: int = BATCH, dim: int = TRANSE_DIM):
    """The augmented L2 operands of random queries and candidates at the
    evaluation's shape, with the first 8 rows' true candidates moved close
    to their queries (where the expansion cancels), skewed CSR labels and
    the pivot columns."""
    from kge_tpu_torch.models.translation import _l2_factorization

    rng = np.random.default_rng(seed + 13)
    E = NUM_ENTITIES
    q = rng.normal(0, 0.1, (n, dim)).astype(np.float32)
    c = rng.normal(0, 0.1, (E, dim)).astype(np.float32)
    true_np = rng.integers(0, E, n).astype(np.int32)
    c[true_np[:8]] = q[:8] + rng.normal(0, 1e-3, (8, dim))
    query, target_map, score_map = _l2_factorization(torch.tensor(q, device=device))
    targets = target_map(torch.tensor(c, device=device))
    row_ptr, cols = skewed_labels(rng, n, E, device, true=true_np)
    true = torch.tensor(true_np, device=device)
    return query.contiguous(), targets.contiguous(), score_map, row_ptr, cols, true


def compare_epilogue(seed: int, device):
    """The L2 epilogue kernel against its plain version and against the
    identity kernel mapped by the epilogue; returns the largest label-value
    or pivot error against the plain version."""
    from kge_tpu_torch.ops.rank_kernel import (
        fused_rank_counts,
        fused_rank_counts_plain,
    )

    q, targets, score_map, row_ptr, cols, true = l2_inputs(seed, device)
    E = NUM_ENTITIES
    g, c, vals, pivot = fused_rank_counts(q, targets, None, row_ptr, cols, E, ATOL,
                                          RTOL, score_map=score_map, pivot_cols=true)
    _, _, ivals, ipivot = fused_rank_counts(q, targets, None, row_ptr, cols, E,
                                            ATOL, RTOL, pivot_cols=true)
    torch.cuda.synchronize()
    check(torch.equal(score_map(ipivot).view(torch.int32), pivot.view(torch.int32))
          and torch.equal(score_map(ivals).view(torch.int32), vals.view(torch.int32)),
          "the epilogue kernel's pivots or label values are not the identity "
          "kernel's mapped by the epilogue")
    pg, pc, pvals, _ = fused_rank_counts_plain(q, targets, pivot, row_ptr, cols, E,
                                               ATOL, RTOL, score_map=score_map)
    ppivot = fused_rank_counts_plain(q, targets, None, row_ptr, cols, E, ATOL, RTOL,
                                     score_map=score_map, pivot_cols=true)[3]
    worst = 0.0
    for got, want, what in ((vals, pvals, "label values"), (pivot, ppivot, "pivots")):
        err = (got - want).abs()
        check(bool((err <= 1e-6 + 1e-5 * want.abs()).all()),
              f"epilogue kernel {what} disagree with plain")
        worst = max(worst, float(err.max()))
    differ = (g != pg) | (c != pc)
    near = boundary_rows(q, targets, pivot, E, score_map, TRANSE_DIM)
    check(not bool((differ & ~near).any()),
          "epilogue kernel counts disagree with plain away from a tie boundary")
    check(bool((c >= 1).all()), "a true column does not tie with itself")
    check(int(differ.sum()) <= 0.001 * q.shape[0] + 1, "too many boundary rows differ")
    log(f"  L2 epilogue n={q.shape[0]} |E|={E} D'={q.shape[1]}: counts equal on "
        f"{q.shape[0] - int(differ.sum())}/{q.shape[0]} rows ({int(near.sum())} at a "
        f"tie boundary, {int(differ.sum())} of them differ); label values and pivots "
        f"max abs err {worst:.3e} (rtol 1e-5, atol 1e-6); pivots and label values "
        f"are the identity kernel's mapped by the epilogue, bit for bit; close pairs' "
        f"pivots {float(pivot[:8].max()):.3e} at most")
    return worst


def time_epilogue(seed: int, device):
    """The L2 epilogue kernel per call at n = 256, |E| = 14,541, D' = 132,
    beside its plain version, ``matmul`` + the epilogue + compares, and the
    bound."""
    from kge_tpu_torch.ops.rank_kernel import (
        csr_row_ids,
        fused_rank_counts,
        fused_rank_counts_plain,
    )

    q, targets, score_map, row_ptr, cols, true = l2_inputs(seed + 1, device)
    (n, D), E, nnz = q.shape, targets.shape[0], cols.numel()
    rows = csr_row_ids(row_ptr)
    ms = time_ms(lambda: fused_rank_counts(q, targets, None, row_ptr, cols, E, ATOL,
                                           RTOL, score_map=score_map, pivot_cols=true))
    plain_ms = time_ms(lambda: fused_rank_counts_plain(
        q, targets, None, row_ptr, cols, E, ATOL, RTOL, score_map=score_map,
        pivot_cols=true))

    def library():
        scores = score_map(torch.matmul(q, targets.T))
        pivot = scores.gather(1, true.long()[:, None])
        close = torch.isclose(scores, pivot, rtol=RTOL, atol=ATOL)
        greater = (scores > pivot) & ~close
        return greater.sum(1), close.sum(1), scores[rows, cols.long()]

    library_ms = time_ms(library)
    flops = 2.0 * n * E * D
    bound_ms, bound_by, _ = bound(
        4.0 * (n * D + E * D + (n + 1) + nnz + n + 3 * n + nnz), flops)
    log(f"  rank_counts, L2 epilogue, n={n} |E|={E} D'={D} nnz={nnz}: {ms:.4f} ms "
        f"({100 * flops / (ms * 1e-3) / FP32_FLOPS_PER_S:.1f}% of the fp32 rate), "
        f"plain {plain_ms:.4f} ms, library matmul + epilogue + compares "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"shape": "L2 epilogue, random, skewed labels", "n": n,
            "num_candidates": E, "D": D, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def run_transe_l2(seed: int, data: str, transe_folder: str):
    """Phase 14; returns a summary dict."""
    from kge_tpu_torch import cli

    num_train, num_valid = FB15K237[2], FB15K237[3]
    steps = -(-num_train // L2_BATCH)
    valid_batches = -(-num_valid // BATCH)
    test_batches = -(-NUM_TEST // BATCH)
    folder = os.path.join(WORK, "train_transe_l2")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_transe_l2.yaml")
    write_train_config(conf, data, seed, **{
        "model": "transe", "transe.l_norm": 2.0,
        "lookup_embedder.dim": TRANSE_DIM,
        "lookup_embedder.initialize": "xavier_uniform_",
        "train.batch_size": L2_BATCH, "train.loss": "margin_ranking",
        "train.loss_arg": 4.0, "train.max_epochs": 2,
        "train.optimizer.default": {"type": "Adagrad", "args": {"lr": 0.05}},
        "negative_sampling.shared": False,
        "negative_sampling.num_samples": {"s": L2_NEGATIVES, "p": 0,
                                          "o": L2_NEGATIVES},
        "valid.every": 1})

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    with open(os.path.join(folder, "kge.log")) as f:
        check("Set negative_sampling.implementation=pool" in f.read(),
              "auto did not resolve to pool")
    valid = trace_entries(folder, event="eval_completed")
    check([e["epoch"] for e in valid] == [1, 2], "expected validations at epochs 1 and 2")
    check(os.path.exists(os.path.join(folder, "checkpoint_00002.pt")),
          "checkpoint_00002.pt is missing")
    epochs = trace_entries(folder, event="epoch_completed")
    losses = [e["avg_loss"] for e in epochs]
    check(all(np.isfinite(losses)) and losses[1] < losses[0],
          f"T-transe-l2 loss did not fall: {losses}")
    check(counts["rank_counts"] == counts["rank_counts_epilogue"] == 2 * 2 * valid_batches,
          f"rank launches {counts} != 2 x {valid_batches} x 2 validations, all with "
          "the L2 epilogue")
    check(counts["pooled_scores"] == counts["rows_set"] == 0 and
          counts["scatter_add_sorted"] > 0, counts)
    log(f"  start, 2 epochs ({steps} steps each) and 2 validations: wall "
        f"{start_wall:.2f} s; auto resolved to pool; launches "
        f"{counts}; avg_loss {losses[0]:.4f} -> {losses[1]:.4f}; epoch times "
        f"{epochs[0]['epoch_time']:.3f} s, {epochs[1]['epoch_time']:.3f} s; "
        f"validation MRR filtered {valid[0]['mean_reciprocal_rank_filtered']:.6f} -> "
        f"{valid[1]['mean_reciprocal_rank_filtered']:.6f}; validation walls "
        f"{valid[0]['epoch_time']:.3f} s, {valid[1]['epoch_time']:.3f} s")

    reset_counters()
    start = time.perf_counter()
    cli.main(["test", folder, "--eval.batch_size", str(BATCH)])
    torch.cuda.synchronize()
    test_wall = time.perf_counter() - start
    test_counts = read_counters()
    check(test_counts["rank_counts"] == test_counts["rank_counts_epilogue"]
          == 2 * test_batches, f"test launches {test_counts} != 2 x {test_batches}")
    entry = last_test_entry(folder)
    metrics = {k: v for k, v in entry.items()
               if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
               and not k.endswith("_with_test")}
    check(metrics and all(np.isfinite(v) for v in metrics.values()), metrics)
    check(0.0 < entry["mean_reciprocal_rank_filtered"] <= 1.0)
    log(f"  test: {test_counts['rank_counts']} rank launches, all with the L2 "
        f"epilogue; wall {test_wall:.3f} s ({NUM_TEST / test_wall:.1f} filtered "
        f"triples/s); MRR filtered {entry['mean_reciprocal_rank_filtered']:.6f}, "
        f"Hits@10 filtered {entry['hits_at_10_filtered']:.6f}")

    job = test_job(folder)
    with torch.inference_mode():
        job._prepare()
        job._is_prepared = True
        job._evaluate()
        torch.cuda.synchronize()
        start = time.perf_counter()
        job._evaluate()
        torch.cuda.synchronize()
        warm_test_wall = time.perf_counter() - start
        log(f"  second test eval (collated batches reused): wall {warm_test_wall:.3f} s")
        agree = eval_ranks_agree(job, dim=TRANSE_DIM)
        eval_profile = profile_run(job._evaluate, "warm test eval of T-transe-l2")
    del job
    train_job = resumed_job(folder, "checkpoint_00002.pt")
    timing = warm_epoch(train_job, num_train, "T-transe-l2")
    del train_job

    # TransE-L1 by the score-matrix route: phase 11's folder
    reset_counters()
    start = time.perf_counter()
    cli.main(["test", transe_folder, "--eval.batch_size", str(BATCH)])
    torch.cuda.synchronize()
    l1_wall = time.perf_counter() - start
    l1_counts = read_counters()
    check(l1_counts["rank_counts"] == 0, f"TransE-L1 launched the rank kernel: {l1_counts}")
    l1 = last_test_entry(transe_folder)
    l1_metrics = {k: v for k, v in l1.items()
                  if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
                  and not k.endswith("_with_test")}
    check(l1_metrics and all(np.isfinite(v) for v in l1_metrics.values()), l1_metrics)
    check(0.0 < l1["mean_reciprocal_rank_filtered"] <= 1.0)
    log(f"  test of P-transe's folder (TransE-L1, score matrix): wall {l1_wall:.3f} s "
        f"({NUM_TEST / l1_wall:.1f} filtered triples/s), MRR filtered "
        f"{l1['mean_reciprocal_rank_filtered']:.6f}, no rank kernel launch")
    job = test_job(transe_folder)
    with torch.inference_mode():
        job._prepare()
        job._is_prepared = True
        job._evaluate()
        l1_profile = profile_run(job._evaluate, "warm test eval of TransE-L1")
    del job
    return {"launches": counts, "test_launches": test_counts,
            "start_wall_s": start_wall, "avg_loss": losses,
            "epoch_time_s": [e["epoch_time"] for e in epochs],
            "valid_wall_s": [e["epoch_time"] for e in valid],
            "valid_mrr_filtered": [e["mean_reciprocal_rank_filtered"] for e in valid],
            "test_wall_s": test_wall, "test_warm_wall_s": warm_test_wall,
            "test_mrr_filtered": entry["mean_reciprocal_rank_filtered"],
            "ranks_vs_plain": agree, "eval_profile": eval_profile,
            "warm_epoch": timing, "transe_l1_test_wall_s": l1_wall,
            "transe_l1_test_mrr_filtered": l1["mean_reciprocal_rank_filtered"],
            "transe_l1_eval_profile": l1_profile, "folder": folder}


# -- 1vsAll and KvsAll training, and the factorization family ----------------------

OCOMPLEX_EXAMPLE = os.path.join(ROOT, "examples", "fb15k-237-complex-1vsall.yaml")
ALL_BATCH = 512  # O-complex (the example's) and K-complex (bench.py stage 6)
# the factorization family at the toy widths of examples/toy-rt3-train.yaml
FACTORIZATION = {
    "distmult": {"lookup_embedder.dim": 16},
    "rescal": {"lookup_embedder.dim": 16},
    "cp": {"lookup_embedder.dim": 16},
    "simple": {"lookup_embedder.dim": 16},
    "relational_tucker3": {"relational_tucker3.entity_embedder.dim": 16,
                           "relational_tucker3.relation_embedder.base_embedder.dim": 8},
}


def check_losses(folder, epochs):
    entries = trace_entries(folder, event="epoch_completed")
    check([e["epoch"] for e in entries] == epochs, f"epochs {entries}")
    losses = [e["avg_loss"] for e in entries]
    check(all(np.isfinite(losses)), f"loss is not finite: {losses}")
    return losses


def run_ocomplex(seed: int, data: str):
    """Phase 15; returns a summary dict."""
    from kge_tpu_torch import cli

    num_train, num_valid, num_test = FB15K237[2:]
    steps = -(-num_train // ALL_BATCH)
    valid_batches, test_batches = -(-num_valid // BATCH), -(-num_test // BATCH)
    folder = os.path.join(WORK, "train_ocomplex")
    shutil.rmtree(folder, ignore_errors=True)

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", OCOMPLEX_EXAMPLE, "--folder", folder, "--dataset.name", data,
              "--train.max_epochs", "2", "--valid.every", "1",
              "--random_seed.default", str(seed), "--console.quiet", "True"])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    log(f"  start, 2 epochs and 2 validations: wall {start_wall:.2f} s; launches {counts}")
    # 4 scatter launches a step: the lookups of s and p (score_sp) and of o
    # and p + |R| (score_po through the reciprocal relations); 2 rank
    # launches a validation batch
    check(counts["scatter_add_sorted"] == 4 * steps * 2,
          f"scatter launches {counts['scatter_add_sorted']} != 4 x {steps} x 2")
    check(counts["rank_counts"] == 2 * valid_batches * 2,
          f"rank launches {counts['rank_counts']} != 2 x {valid_batches} x 2")
    check(counts["rows_set"] == 0 and counts["pooled_scores"] == 0, counts)
    losses = check_losses(folder, [1, 2])
    valid = trace_entries(folder, event="eval_completed")
    check([e["epoch"] for e in valid] == [1, 2], "expected validations at 1 and 2")
    check(all(0.0 < e["mean_reciprocal_rank_filtered"] <= 1.0 for e in valid))
    log(f"  scatter kernel: 4 launches x {steps} steps x 2 epochs = "
        f"{counts['scatter_add_sorted']}; rank kernel: 2 x {valid_batches} x 2 "
        f"validations = {counts['rank_counts']}; avg_loss {losses}")

    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    resumed = read_counters()
    check(resumed["scatter_add_sorted"] == 4 * steps, resumed)
    check(resumed["rank_counts"] == 2 * valid_batches, resumed)
    losses = check_losses(folder, [1, 2, 3])
    check(losses[2] < losses[0], f"loss did not fall: {losses}")
    reset_counters()
    start = time.perf_counter()
    cli.main(["test", folder])
    torch.cuda.synchronize()
    test_wall = time.perf_counter() - start
    tested = read_counters()
    check(tested["rank_counts"] == 2 * test_batches, tested)
    entry = last_test_entry(folder)
    check(0.0 < entry["mean_reciprocal_rank_filtered"] <= 1.0, entry)
    log(f"  resume to epoch 3: launches {resumed}; test: {tested['rank_counts']} rank "
        f"launches, wall {test_wall:.3f} s, MRR filtered "
        f"{entry['mean_reciprocal_rank_filtered']:.6f}; avg_loss {losses}")

    before, (kernel, never), _, jobs = one_step_each(
        folder, "checkpoint_00003.pt", "train.pallas_gather", ("always", "never"))
    worst = check_tables_close(
        kernel, never, "a 1vsAll step with the scatter kernel differs from the same "
        "step with torch's indexing backward")
    moved = max(float((a - b).abs().max()) for a, b in zip(kernel, before))
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  one step, scatter kernel vs train.pallas_gather=never: max abs "
        f"difference {worst:.3e} (tables moved by up to {moved:.3e}); "
        f"tolerance atol 1e-6 + rtol 1e-5")
    del jobs[1]
    timing = warm_epoch(jobs[0], num_train, "O-complex")
    return {"launches": counts, "resume_launches": resumed, "test_launches": tested,
            "start_wall_s": start_wall, "test_wall_s": test_wall, "avg_loss": losses,
            "valid_mrr_filtered": [e["mean_reciprocal_rank_filtered"] for e in valid],
            "step_max_abs_diff_vs_never": worst, "warm_epoch": timing}


def check_dense_labels(job):
    """The first batch's dense label rows sum to the number of distinct
    answers of each query (the synthetic graph holds some triples twice,
    and a label is set once)."""
    batch = next(iter(job._batches()))
    qtype = job._step_variant(batch)
    index = job.query_indexes[qtype]
    n = batch["true_size"]
    device_batch = {k: torch.as_tensor(v).to(job.device) for k, v in batch.items()
                    if k != "true_size" and not isinstance(v, str)}
    labels = job._dense_labels(device_batch, qtype).cpu()
    counts = [len(np.unique(index.get(int(a), int(b)))) for a, b in batch["queries"][:n]]
    check(np.array_equal(labels.sum(1).numpy()[:n], np.array(counts, np.float32)),
          "dense labels do not sum to the CSR counts")
    check(float(labels[n:].sum()) == 0.0, "padded rows hold labels")
    log(f"  dense labels of a {qtype} batch: {n} rows sum to their queries' "
        f"{int(sum(counts))} distinct answers")


def run_kcomplex(seed: int, data: str):
    """Phase 16; returns a summary dict."""
    from kge_tpu_torch import cli

    num_valid = FB15K237[3]
    valid_batches = -(-num_valid // BATCH)
    folder = os.path.join(WORK, "train_kcomplex")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_kcomplex.yaml")
    write_train_config(conf, data, seed, **{"train.type": "KvsAll",
                                            "train.batch_size": ALL_BATCH})
    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    losses = check_losses(folder, [1, 2])
    steps = [e["batches"] for e in trace_entries(folder, event="epoch_completed")]
    (valid,) = trace_entries(folder, event="eval_completed")
    check(0.0 < valid["mean_reciprocal_rank_filtered"] <= 1.0, valid)
    # 2 scatter launches a step: the query's two keys (s and p for sp_, p
    # and o for _po); the whole vocabulary's scores read the table itself
    check(counts["scatter_add_sorted"] == 2 * sum(steps),
          f"scatter launches {counts['scatter_add_sorted']} != 2 x {sum(steps)}")
    check(counts["rank_counts"] == 2 * valid_batches, counts)
    log(f"  start, 2 epochs and one validation: wall {start_wall:.2f} s; scatter "
        f"kernel 2 x {sum(steps)} steps = {counts['scatter_add_sorted']}, rank "
        f"kernel 2 x {valid_batches} = {counts['rank_counts']}; avg_loss {losses}")

    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    resumed = read_counters()
    losses = check_losses(folder, [1, 2, 3])
    check(losses[2] < losses[0], f"loss did not fall: {losses}")
    check(resumed["scatter_add_sorted"] == 2 * steps[0], resumed)
    before, (kernel, never), _, jobs = one_step_each(
        folder, "checkpoint_00003.pt", "train.pallas_gather", ("always", "never"))
    worst = check_tables_close(
        kernel, never, "a KvsAll step with the scatter kernel differs from the same "
        "step with torch's indexing backward")
    moved = max(float((a - b).abs().max()) for a, b in zip(kernel, before))
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  resume to epoch 3: launches {resumed}, avg_loss {losses}; one step, "
        f"scatter kernel vs never: max abs difference {worst:.3e} (moved {moved:.3e})")
    check_dense_labels(jobs[0])
    del jobs[1]
    queries = jobs[0].num_examples
    timing = warm_epoch(jobs[0], queries, "K-complex", unit="queries")
    return {"launches": counts, "resume_launches": resumed, "start_wall_s": start_wall,
            "avg_loss": losses, "queries": queries, "steps": steps,
            "step_max_abs_diff_vs_never": worst, "warm_epoch": timing,
            "folder": folder}


def factorization_job(name: str, data: str, seed: int, device: str, params=None):
    """A prepared KvsAll training job of one factorization model on
    ``data`` on ``device``, with ``params`` (kge_tpu's tree) or weights from
    the seed; returns the job and its weights as such a tree."""
    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.job import TrainingJob
    from kge_tpu_torch.models import KgeModel, load_jax_params, to_jax_params

    config = Config()
    config.load_options({"model": name})
    for key, value in {
        **FACTORIZATION[name], "lookup_embedder.initialize_args.std": 0.1,
        "job.device": device, "dataset.name": data, "train.type": "KvsAll",
        "train.batch_size": 256, "train.optimizer.default.type": "Adagrad",
        "train.optimizer.default.args.lr": 0.1,
        "train.optimizer.default.args.initial_accumulator_value": 0.1,
        "valid.every": 0, "eval.split": "test", "eval.batch_size": 64,
        "random_seed.default": seed, "console.quiet": True,
    }.items():
        config.set(key, value, create=True)
    dataset = Dataset.create(config)
    model = KgeModel.create(config, dataset, init_for_load_only=True)
    if params is None:
        model.init_params(torch.Generator(device=model.device).manual_seed(seed))
        params = to_jax_params(model)
    load_jax_params(model, params)
    job = TrainingJob.create(config, dataset, model=model)
    job._prepare()
    job._is_prepared = True
    return job, params


def run_factorization_family(seed: int):
    """Phase 17; returns a summary dict."""
    from kge_tpu_torch.job import EvaluationJob

    data = os.path.join(WORK, "small_data")
    sizes = (500, 8, 5000, 300, 300)
    write_dataset(data, seed, sizes=sizes)
    test_batches = -(-sizes[4] // 64)
    out = {}
    for name in FACTORIZATION:
        card, params = factorization_job(name, data, seed, "cuda")
        host, _ = factorization_job(name, data, seed, "cpu", params)
        entries, launches = {}, {}
        for where, job in (("cuda", card), ("cpu", host)):
            evaluation = EvaluationJob.create(job.config, job.dataset, model=job.model)
            evaluation.epoch = 0
            reset_counters()
            with torch.inference_mode():
                entries[where] = evaluation._evaluate()
            torch.cuda.synchronize()
            launches[where] = read_counters()["rank_counts"]
        check(launches == {"cuda": 2 * test_batches, "cpu": 0},
              f"{name}: rank launches {launches}")
        keys = [k for k in entries["cpu"]
                if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
                and not k.endswith("_with_test")]
        differ = [k for k in keys if entries["cuda"][k] != entries["cpu"][k]]
        check(keys and not differ, f"{name}: card and CPU metrics differ: {differ}")

        batch = next(iter(card._batches()))
        variant = card._step_variant(batch)
        arrays = {k: v for k, v in batch.items()
                  if k != "true_size" and not isinstance(v, str)}
        before = tables_of(card)
        reset_counters()
        for job in (card, host):
            job._train_step({k: torch.as_tensor(v).to(job.device) for k, v in arrays.items()},
                            job._current_lrs(), variant)
        torch.cuda.synchronize()
        step = read_counters()
        check(step["scatter_add_sorted"] == 2, f"{name}: scatter launches {step}")
        after = tables_of(card)
        worst = check_tables_close(
            [t.cpu() for t in after], tables_of(host),
            f"{name}: a KvsAll step on the card differs from the step on the CPU")
        moved = max(float((a - b).abs().max()) for a, b in zip(after, before))
        check(moved > 1e-4, f"{name}: the step did not move the tables")
        widths = [tuple(p.shape) for p in card.optimizer.params]
        log(f"  {name} {widths}: {len(keys)} metrics equal on card and CPU (MRR "
            f"filtered {entries['cuda']['mean_reciprocal_rank_filtered']:.6f}, "
            f"{launches['cuda']} rank launches); one {variant} step on card vs CPU: "
            f"max abs difference {worst:.3e} (moved {moved:.3e}), 2 scatter launches")
        out[name] = {"rank_launches": launches["cuda"], "metrics_equal": len(keys),
                     "step_max_abs_diff_vs_cpu": worst, "tables": widths}
    return out


# -- per-row negatives, the fused step and subbatches ---------------------------------


def check_pick_bits(generator, device, samples):
    """``picked_scores`` at X-complex's shape ([8,192, 14,541] scores, 128
    picks a row): values equal a gather, and the backward of two launches
    is bit-equal, on the run's own samples and with a column picked three
    times in every row; the backward within 1e-6 + 1e-5 S of a float64 sum
    (S the summed magnitudes). Returns (rows of ``samples`` with a column
    three times or more, max abs error)."""
    from kge_tpu_torch.ops.pick import picked_scores

    n, K = samples.shape
    S = torch.randn((n, NUM_ENTITIES), generator=generator, device=device)
    g = torch.randn((n, K), generator=generator, device=device)
    sorted_ids = samples.sort(dim=1).values
    triples = (sorted_ids[:, 2:] == sorted_ids[:, :-2]).any(dim=1)
    forced = samples.clone()
    forced[:, 1:3] = forced[:, :1]
    worst = 0.0
    for idx in (samples, forced):
        grads = []
        for _ in range(2):
            St = S.clone().requires_grad_(True)
            out = picked_scores(St, idx)
            check(torch.equal(out, torch.gather(S, 1, idx)), "the pick's values differ")
            grads.append(torch.autograd.grad(out, St, g)[0])
        check(torch.equal(grads[0], grads[1]),
              "the pick's backward differs between two launches")
        want = torch.zeros((n, NUM_ENTITIES), dtype=torch.float64, device=device)
        rows = torch.arange(n, device=device)[:, None].expand_as(idx)
        want.index_put_((rows, idx), g.double(), accumulate=True)
        mag = torch.zeros_like(want).index_put_((rows, idx), g.double().abs(),
                                                accumulate=True)
        err = (grads[0].double() - want).abs()
        check(bool((err <= 1e-6 + 1e-5 * mag).all()), "the pick's backward is off")
        worst = max(worst, float(err.max()))
    log(f"  picked_scores [{n}, {NUM_ENTITIES}] x {K} picks: values equal a gather; "
        f"backward bit-equal across two launches ({int(triples.sum())} rows of the "
        f"run's samples pick a column three times or more, and a case with one in "
        f"every row); max abs error vs float64 {worst:.3e}")
    return int(triples.sum()), worst


def run_xcomplex(seed: int, data: str):
    """Phase 18; returns a summary dict."""
    from kge_tpu_torch import cli

    num_train, num_valid = FB15K237[2], FB15K237[3]
    steps = -(-num_train // TRAIN_BATCH)
    valid_batches = -(-num_valid // BATCH)
    folder = os.path.join(WORK, "train_xcomplex")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_xcomplex.yaml")
    write_train_config(conf, data, seed, **{
        "negative_sampling.shared": False, "negative_sampling.implementation": "all",
        "valid.every": 1})

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    # 3 scatter launches a step: s, p and o embedded once; the whole
    # vocabulary's scores read the entity table itself; 2 rank launches a
    # validation batch
    check(counts["scatter_add_sorted"] == 3 * steps * 2,
          f"scatter launches {counts['scatter_add_sorted']} != 3 x {steps} x 2")
    check(counts["rank_counts"] == 2 * valid_batches * 2,
          f"rank launches {counts['rank_counts']} != 2 x {valid_batches} x 2")
    check(counts["rows_set"] == 0 and counts["pooled_scores"] == 0, counts)
    losses = check_losses(folder, [1, 2])
    check(losses[1] < losses[0], f"loss did not fall: {losses}")
    valid = trace_entries(folder, event="eval_completed")
    check([e["epoch"] for e in valid] == [1, 2], "expected validations at 1 and 2")
    check(all(0.0 < e["mean_reciprocal_rank_filtered"] <= 1.0 for e in valid))
    with open(os.path.join(folder, "kge.log")) as f:
        check("Drawing negative samples on-device" in f.read(), "negatives not on the card")
    log(f"  start, 2 epochs and 2 validations: wall {start_wall:.2f} s; scatter kernel "
        f"3 x {steps} x 2 = {counts['scatter_add_sorted']}, rank kernel 2 x "
        f"{valid_batches} x 2 = {counts['rank_counts']}; avg_loss {losses}")

    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    resumed = read_counters()
    check(resumed["scatter_add_sorted"] == 3 * steps, resumed)
    check(resumed["rank_counts"] == 2 * valid_batches, resumed)
    losses = check_losses(folder, [1, 2, 3])
    check(losses[2] < losses[1], f"loss did not fall after resume: {losses}")
    log(f"  resume to epoch 3: launches {resumed}; avg_loss {losses}")

    before, (kernel, never), batch, jobs = one_step_each(
        folder, "checkpoint_00003.pt", "train.pallas_gather", ("always", "never"))
    worst = check_tables_close(
        kernel, never, "an all-negatives step with the scatter kernel differs from "
        "the same step with torch's indexing backward")
    moved = max(float((a - b).abs().max()) for a, b in zip(kernel, before))
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  one step, scatter kernel vs train.pallas_gather=never: max abs difference "
        f"{worst:.3e} (moved {moved:.3e}); tolerance atol 1e-6 + rtol 1e-5")
    del jobs
    samples = batch["neg_samples_0"]
    generator = torch.Generator(device=samples.device).manual_seed(seed + 18)
    triple_rows, pick_err = check_pick_bits(generator, samples.device, samples)

    # the same per-row samples through the three routes that score them
    route_costs, launches = [], []
    routes = ("all", "batch", "triple")
    _, after, _, jobs = one_step_each(
        folder, "checkpoint_00003.pt", "negative_sampling.implementation", routes,
        costs=route_costs, launches=launches)
    check([job._implementation for job in jobs] == list(routes))
    route_err = 0.0
    for route, tables, cost in zip(routes[1:], after[1:], route_costs[1:]):
        check(abs(cost - route_costs[0]) <= 1e-5 * abs(route_costs[0]),
              f"{route}'s loss {cost} differs from all's {route_costs[0]}")
        route_err = max(route_err, check_tables_close(
            tables, after[0], f"a {route} step differs from the all step"))
    check([c["scatter_add_sorted"] for c in launches] == [3, 12, 12], launches)
    log(f"  the same samples by all / batch / triple: losses {route_costs}, tables "
        f"within {route_err:.3e}; scatter launches "
        f"{[c['scatter_add_sorted'] for c in launches]}")
    del jobs, after

    # the step in 4 subbatches (of 2,048 rows)
    costs, launches = [], []
    _, (whole, parts), _, jobs = one_step_each(
        folder, "checkpoint_00003.pt", "train.subbatch_size", (-1, TRAIN_BATCH // 4),
        costs=costs, launches=launches)
    check(abs(costs[1] - costs[0]) <= 1e-5 * abs(costs[0]),
          f"subbatched loss {costs[1]} differs from {costs[0]}")
    sub_err = check_tables_close(parts, whole, "the subbatched step differs")
    check(launches[1]["scatter_add_sorted"] == 3 * 4, launches)
    log(f"  one step in 4 subbatches of {TRAIN_BATCH // 4} vs whole: losses {costs}, tables within "
        f"{sub_err:.3e}; scatter launches {launches[1]['scatter_add_sorted']}")
    timing = warm_epoch(jobs[0], num_train, "X-complex")
    return {"launches": counts, "resume_launches": resumed, "start_wall_s": start_wall,
            "avg_loss": losses,
            "valid_mrr_filtered": [e["mean_reciprocal_rank_filtered"] for e in valid],
            "step_max_abs_diff_vs_never": worst, "pick_max_abs_err": pick_err,
            "rows_with_a_triple_pick": triple_rows, "route_losses": route_costs,
            "route_max_abs_diff": route_err, "subbatch_losses": costs,
            "subbatch_max_abs_diff": sub_err,
            "warm_epoch": timing}


def time_unique(device):
    """The bounded unique of the ``batch`` route at T-dense's shape (8,192 x
    128 samples of 14,541 ids): host wall per call, which includes the wait
    for the card that ``torch.unique`` makes (its output size)."""
    from kge_tpu_torch.job.train_negative_sampling import _bounded_unique

    ids = torch.randint(0, NUM_ENTITIES, (TRAIN_BATCH * NUM_NEGATIVES,), device=device)
    _bounded_unique(ids, NUM_ENTITIES)
    torch.cuda.synchronize()
    reps = 20
    start = time.perf_counter()
    for _ in range(reps):
        _bounded_unique(ids, NUM_ENTITIES)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / reps


def run_route(seed: int, data: str, name: str, scatter_per_step: int, **extra):
    """One configuration of phase 19: ``start`` for 2 epochs through
    ``cli.main`` at T-dense's shape, K2's launches a step by equality, a
    finite falling loss; returns (summary, the folder)."""
    from kge_tpu_torch import cli

    num_train = FB15K237[2]
    steps = -(-num_train // TRAIN_BATCH)
    folder = os.path.join(WORK, f"train_{name}")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, f"train_{name}.yaml")
    write_train_config(conf, data, seed, **{"valid.every": 0, **extra})
    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    check(counts["scatter_add_sorted"] == scatter_per_step * steps * 2,
          f"{name}: scatter launches {counts['scatter_add_sorted']} != "
          f"{scatter_per_step} x {steps} x 2")
    check(counts["rank_counts"] == 0 and counts["rows_set"] == 0, counts)
    losses = check_losses(folder, [1, 2])
    check(losses[1] < losses[0], f"{name}: loss did not fall: {losses}")
    log(f"  {name}: start, 2 epochs: wall {start_wall:.2f} s; scatter kernel "
        f"{scatter_per_step} x {steps} x 2 = {counts['scatter_add_sorted']}; "
        f"avg_loss {losses}")
    return {"launches": counts, "start_wall_s": start_wall, "avg_loss": losses}, folder


def run_other_routes(seed: int, data: str, kcomplex_folder: str):
    """Phase 19; returns a summary dict."""
    num_train = FB15K237[2]
    out = {}
    # per slot: s, p and o of the positive score, then p, o and the batch's
    # distinct samples of the negatives' scores
    for name, extra in (
            ("batch_per_row", {"negative_sampling.shared": False,
                               "negative_sampling.implementation": "batch"}),
            ("pool_host", {"negative_sampling.shared": False,
                           "negative_sampling.implementation": "pool",
                           "negative_sampling.on_device": "never"})):
        out[name], folder = run_route(seed, data, name, 12, **extra)
        if name == "pool_host":
            with open(os.path.join(folder, "kge.log")) as f:
                check("Drawing negative samples on-device" not in f.read(),
                      "pool with on_device never drew on the card")
        job = resumed_job(folder, "checkpoint_00002.pt")
        out[name]["warm_epoch"] = warm_epoch(job, num_train, name)
        device = job.device
        del job
    out["unique_ms"] = time_unique(device)
    log(f"  the batch route's bounded unique of {TRAIN_BATCH * NUM_NEGATIVES} ids: "
        f"{out['unique_ms']:.3f} ms a call by the host clock (one wait for the card)")

    # fused: 2 gathers of the whole tables (one scatter into each) and 5
    # lookups on the mini-tables (s, p, o and one target list a slot)
    out["fused"], folder = run_route(seed, data, "fused", 7, **{
        "negative_sampling.fused_scoring": "always"})
    with open(os.path.join(folder, "kge.log")) as f:
        check("Using fused (localized single-gather) scoring" in f.read())
    launches = []
    before, (fused, unfused), _, jobs = one_step_each(
        folder, "checkpoint_00002.pt", "negative_sampling.fused_scoring",
        ("always", "never"), launches=launches)
    check([c["scatter_add_sorted"] for c in launches] == [7, 5], launches)
    worst = check_tables_close(fused, unfused, "the fused step differs from the unfused")
    moved = max(float((a - b).abs().max()) for a, b in zip(fused, before))
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  one fused step vs the unfused step: max abs difference {worst:.3e} (moved "
        f"{moved:.3e}); scatter launches 7 and 5")
    out["fused"]["step_max_abs_diff_vs_unfused"] = worst
    del jobs[1]
    out["fused"]["warm_epoch"] = warm_epoch(jobs[0], num_train, "fused")
    del jobs

    # one KvsAll step of phase 16 in 4 subbatches (of 128)
    costs, launches = [], []
    _, (whole, parts), _, jobs = one_step_each(
        kcomplex_folder, "checkpoint_00003.pt", "train.subbatch_size",
        (-1, ALL_BATCH // 4), costs=costs, launches=launches)
    check(abs(costs[1] - costs[0]) <= 1e-5 * abs(costs[0]), costs)
    sub_err = check_tables_close(parts, whole, "the subbatched KvsAll step differs")
    check([c["scatter_add_sorted"] for c in launches] == [2, 8], launches)
    log(f"  one KvsAll step in 4 subbatches of {ALL_BATCH // 4} vs whole: losses {costs}, tables "
        f"within {sub_err:.3e}; scatter launches 2 and 8")
    del jobs[0]
    out["kvsall_subbatch"] = {
        "losses": costs, "max_abs_diff": sub_err,
        # wall only: the profile of 2,472 launches of each kind costs more
        # than the epoch; no warm-up epoch either (the job's step ran above),
        # which keeps the whole run near half its time limit
        "warm_epoch": warm_epoch(jobs[0], jobs[0].num_examples, "subbatched KvsAll",
                                 unit="queries", profiled=False, warmup=False)}
    return out



# -- the neural models: C-conve and C-hitter --------------------------------------

# ConvE at the ConvE paper's widths (Dettmers et al. 2018): d = 200 as a
# 10 x 20 map (stacked to 20 x 20), 32 filters of 3 x 3 (flat size 10,368),
# the yaml's dropouts 0.2 / 0.2 / 0.3; KvsAll with bce and label smoothing
# 0.1, Adam lr 0.003, batch 128
CONVE = {
    "model": "reciprocal_relations_model",
    "reciprocal_relations_model.base_model.type": "conve",
    "conve.entity_embedder.dim": 200, "conve.relation_embedder.dim": 200,
    "train.type": "KvsAll", "train.loss": "bce", "train.batch_size": 128,
    "KvsAll.label_smoothing": 0.1,
    "train.optimizer.default.type": "Adam", "train.optimizer.default.args.lr": 0.003,
}
CONVE_NO_DROPOUT = {"conve.entity_embedder.dropout": 0.0,
                    "conve.relation_embedder.dropout": 0.0,
                    "conve.feature_map_dropout": 0.0,
                    "conve.projection_dropout": 0.0}
# the "no context" HittER Transformer at the yaml's widths with d = 320: 8
# heads, feed-forward 1,280, 3 layers, dropout 0.1; 1vsAll with kl, Adam lr
# 0.001, batch 512
HITTER = {
    "model": "reciprocal_relations_model",
    "reciprocal_relations_model.base_model.type": "transformer",
    "transformer.entity_embedder.dim": 320, "transformer.relation_embedder.dim": 320,
    "train.type": "1vsAll", "train.loss": "kl", "train.batch_size": 512,
    "train.optimizer.default.type": "Adam", "train.optimizer.default.args.lr": 0.001,
}
HITTER_NO_DROPOUT = {"transformer.encoder.dropout": 0.0}
PROFILED_STEPS = 50  # the profiled window of a warm epoch of C-conve, C-hitter


def write_neural_config(path: str, data: str, seed: int, options):
    """A config file of one epoch with a validation through the rank kernel
    (eval batch 256) for ``options`` (dotted keys)."""
    import yaml

    conf = {"job": {"type": "train", "device": "auto"}, "dataset": {"name": data},
            "import": [options["reciprocal_relations_model.base_model.type"]],
            "train": {"max_epochs": 1}, "valid": {"every": 1},
            "eval": {"batch_size": BATCH}, "random_seed": {"default": seed},
            "console": {"quiet": True}}
    for key, value in options.items():
        node = conf
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)


def routes_agree(job):
    """Every collated batch of a prepared evaluation job ranked by the rank
    kernel (the factorized queries) and by the score-matrix route (kge_tpu's:
    ``score_sp`` / ``score_po`` against all entities): every ranking's
    counts equal outside rows near a tie boundary. A row is near where a
    candidate's score-matrix score lies within 4 ulp (phase 2's rule) plus
    twice that candidate's difference between the two routes' scores plus
    the difference of the routes' pivots of a boundary of either pivot:
    each score is computed two ways (the bias column inside the product,
    the bias added after it), not one product in two orders. Those rows
    are counted, and the rows that differ may be at most 1% of the (row,
    ranking, direction) entries, ten times phase 2's share (a partly
    trained model's true entities sit among dense scores). The
    comparison's own kernel launches come after the main path's counts
    were read. The factorized product must equal the score matrix within
    1e-5 of the batch's largest score."""
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    model = job.model
    E = job.dataset.num_entities()
    _, device_batches = job._collate_cache
    differ_rows = near_rows = total_rows = 0
    worst_apart = 0.0
    for triples, labels in device_batches:
        kernel, _ = job._rank_batch(triples, labels)
        model.factorized_queries = lambda *args: None  # the score-matrix route
        try:
            matrix, _ = job._rank_batch(triples, labels)
        finally:
            del model.factorized_queries
        fac = model.factorized_queries(triples, (0, 2))
        s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
        near = {}
        for key, slot, scores, true in (("o", 2, model.score_sp(s, p), o),
                                        ("s", 0, model.score_po(p, o), s)):
            _, q, targets, _ = fac[slot]
            row_ptr, cols, _, _ = labels[key]
            pivot_k = fused_rank_counts(
                q.contiguous(), targets.contiguous(), None, row_ptr, cols, E,
                ATOL, RTOL, pivot_cols=true.to(torch.int32).contiguous())[3]
            pivot_m = scores.gather(1, true[:, None])[:, 0]
            # the factorization reproduces the score matrix
            apart = (q @ targets.T - scores).abs()
            check(float(apart.max()) <= 1e-5 * float(scores.abs().max()),
                  f"[1 | h] . o and the score matrix differ by {float(apart.max())}")
            worst_apart = max(worst_apart, float(apart.max()))
            slack = 2 * apart + (pivot_k - pivot_m).abs()[:, None]
            rows = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
            for pivot in (pivot_k, pivot_m):
                tol = ATOL + RTOL * pivot.abs()
                for bound in (pivot - tol, pivot + tol):
                    b = bound[:, None]
                    ulp = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) \
                        - b.abs()
                    close = (scores - b).abs() <= 4 * ulp + slack
                    rows |= (close & torch.isfinite(b)).any(dim=1)
            near[key] = rows
        for r in kernel:
            d = kernel[r] != matrix[r]
            d_s, d_o = d[0] | d[1], d[2] | d[3]
            bad = (d_s & ~near["s"]) | (d_o & ~near["o"])
            check(not bool(bad.any()),
                  f"ranking {r}: the rank kernel's and the score matrix's ranks "
                  f"differ in {int(bad.sum())} rows away from a tie boundary")
            differ_rows += int(d_s.sum() + d_o.sum())
            near_rows += int(near["s"].sum() + near["o"].sum())
            total_rows += 2 * triples.shape[0]
    check(differ_rows <= 0.01 * total_rows, (differ_rows, total_rows))
    log(f"  rank kernel vs score-matrix route, all {len(device_batches)} test "
        f"batches: ranks equal on {total_rows - differ_rows}/{total_rows} (row, "
        f"ranking, direction) entries; {near_rows} lie at a tie boundary, the "
        f"{differ_rows} that differ are excluded; the factorized product and "
        f"the score matrix differ by at most {worst_apart:.3e}")
    return {"entries": total_rows, "at_boundary": near_rows, "differ": differ_rows,
            "max_abs_score_difference": worst_apart}


def card_matches_cpu(folder, checkpoint, no_dropout, zero_grad_leaves, lr):
    """One step on the card and on the CPU from ``checkpoint`` with every
    dropout off, on the same batch, held in four parts:

    - the losses within rtol 1e-5;
    - the gradients, leaf by leaf, norm-wise: ``|g_card - g_cpu| <= 1e-4
      |g_cpu|`` (2-norms over the leaf). cuDNN, cuBLAS and the scatter
      kernel sum in other orders than the CPU. A float32 sum of K terms
      moves by up to about K u of its summed magnitudes (u = 2^-24), which
      can be the whole of an element whose terms cancel, but not of the
      leaf's norm, which the elements that do not cancel carry: rounding
      errors that add like a random walk give sqrt(K) u, about 6e-6 at the
      10^4 terms of the deepest sums here, and 1e-4 leaves room above it.
      The parts of zero gradient up to rounding (``zero_grad_leaves``: path
      -> slice) are left out: there the gradient is all rounding;
    - the optimizer's rule: the CPU's rule applied on the CPU to the card's
      own gradients and prior leaves and state, against the card's stepped
      leaves and Adam's moments, within 1e-5 + 1e-4 |CPU|. Both compute the
      same elementwise rule on the same inputs;
    - the leaves the step writes without a gradient (the batch-norm
      statistics, merged after the update), card against CPU within 1e-5 +
      1e-4 |CPU|, and the parts of zero gradient, where Adam turns each
      device's rounding into a step of its own: card against CPU within
      twice the largest step Adam takes, 2 (1 - beta1) / sqrt(1 - beta2) lr
      = 6.32 lr (Kingma and Ba 2015, section 2.1).

    An element of small |CPU| whose gradient cancels moves under Adam by up
    to its step whatever the sums' order; held element-wise card against
    CPU it would fail by chance, so the element-wise bounds hold the rule on
    one gradient, and the gradients are held norm-wise. Returns the largest
    differences and the leaves' paths."""
    jobs = {device: resumed_job(folder, checkpoint, **{"job.device": device,
                                                       **no_dropout})
            for device in ("cuda", "cpu")}
    batch = next(iter(jobs["cuda"]._batches()))
    variant = jobs["cuda"]._step_variant(batch)

    def on_cpu(states):
        return [{k: v.detach().cpu().clone() if torch.is_tensor(v) else v
                 for k, v in leaf.items()} for leaf in states]

    out = {}
    for device, job in jobs.items():
        seen = {}
        update = job.optimizer.update

        def capture(grads, opt_state, lrs, job=job, seen=seen, update=update):
            seen["grads"] = [g.detach().cpu().clone() for g in grads]
            seen["prior"] = ([p.detach().cpu().clone() for p in job.optimizer.params],
                             on_cpu(opt_state["leaves"]), int(opt_state["step"]), lrs)
            result = update(grads, opt_state, lrs)
            seen["stepped"] = ([p.detach().cpu().clone() for p in job.optimizer.params],
                               on_cpu(opt_state["leaves"]))
            return result

        job.optimizer.update = capture
        tensors = {k: torch.as_tensor(v).to(job.device) for k, v in batch.items()
                   if k != "true_size" and not isinstance(v, str)}
        cost, _ = job._train_step(tensors, job._current_lrs(), variant)
        job.optimizer.update = update
        paths = [".".join(map(str, p)) for p in job.optimizer._paths]
        leaves = [p.detach().cpu().clone() for p in job.optimizer.params]
        out[device] = (float(cost), paths, leaves, seen)
    torch.cuda.synchronize()
    (cost_c, paths, leaves_c, card), (cost_h, _, leaves_h, cpu) = out["cuda"], out["cpu"]
    check(abs(cost_c - cost_h) <= 1e-5 * abs(cost_h), (cost_c, cost_h))

    # the CPU's rule on the card's gradients, prior leaves and state
    prior_leaves, prior_states, step, lrs = card["prior"]
    rule = jobs["cpu"].optimizer
    with torch.no_grad():
        for param, x in zip(rule.params, prior_leaves):
            param.data = x.clone()
    rule_state = {"leaves": prior_states, "step": step}
    rule.update(card["grads"], rule_state, lrs)
    rule_leaves = [p.detach() for p in rule.params]

    b1, b2 = 0.9, 0.999  # Adam's default betas, which both phases use
    step_bound = 2 * (1 - b1) / math.sqrt(1 - b2) * lr
    worst = {"gradient_norm": 0.0, "rule": 0.0, "statistics": 0.0, "zero_grad": 0.0}
    stepped_c, states_c = card["stepped"]
    for i, path in enumerate(paths):
        part = zero_grad_leaves.get(path)
        g_c, g_h = card["grads"][i].clone(), cpu["grads"][i].clone()
        if part is not None:
            g_c[part] = 0.0
            g_h[part] = 0.0
        apart = float(torch.linalg.vector_norm(g_c - g_h))
        scale = float(torch.linalg.vector_norm(g_h))
        check(apart <= 1e-4 * scale,
              f"{path}: the gradients of card and CPU differ by {apart} in norm "
              f"({scale})")
        if scale > 0:
            worst["gradient_norm"] = max(worst["gradient_norm"], apart / scale)
        pairs = [(stepped_c[i], rule_leaves[i])] + [
            (states_c[i][k], rule_state["leaves"][i][k]) for k in sorted(states_c[i])
            if torch.is_tensor(states_c[i][k])]
        for a, b in pairs:
            err = (a - b).abs()
            check(bool((err <= 1e-5 + 1e-4 * b.abs()).all()),
                  f"{path}: the card's step differs from the CPU's rule on the card's "
                  f"gradient by {float(err.max())}")
            worst["rule"] = max(worst["rule"], float(err.max()))
        if not torch.equal(leaves_c[i], stepped_c[i]):  # written after the update
            err = (leaves_c[i] - leaves_h[i]).abs()
            check(bool((err <= 1e-5 + 1e-4 * leaves_h[i].abs()).all()),
                  f"{path}: card and CPU statistics differ by {float(err.max())}")
            worst["statistics"] = max(worst["statistics"], float(err.max()))
        if part is not None:
            states_h = cpu["stepped"][1][i]
            for a, b in [(leaves_c[i], leaves_h[i])] + [
                    (states_c[i][k], states_h[k]) for k in sorted(states_h)
                    if torch.is_tensor(states_h[k])]:
                err = (a - b).abs()[part]
                check(bool((err <= step_bound).all()), f"{path}: {float(err.max())}")
                worst["zero_grad"] = max(worst["zero_grad"], float(err.max()))
    log(f"  one step on the card vs the CPU (dropout 0): loss {cost_c:.6f} vs "
        f"{cost_h:.6f}; gradients within {worst['gradient_norm']:.3e} of the CPU's "
        f"norm (bound 1e-4); the CPU's rule on the card's gradients within "
        f"{worst['rule']:.3e} of the card's step, statistics within "
        f"{worst['statistics']:.3e} (tolerance 1e-5 + 1e-4 |CPU|); "
        f"{worst['zero_grad']:.3e} on the parts of zero gradient (tolerance "
        f"{step_bound:.3e}, Adam's largest two steps)")
    return {"loss_card": cost_c, "loss_cpu": cost_h, **worst}, paths


def neural_launches(summary, kernel: str):
    """A kernel's launches in each verb of phase 20 or 21."""
    return {"start": summary["launches"][kernel],
            "resume": summary["resume_launches"][kernel],
            "test": summary["test_launches"][kernel]}


def run_neural(name: str, options, no_dropout, zero_grad_leaves, scatter_per_step,
               seed: int, data: str):
    """Phase 20 or 21; returns a summary dict."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.utils.io import load_checkpoint

    num_valid, num_test = FB15K237[3:]
    valid_batches, test_batches = -(-num_valid // BATCH), -(-num_test // BATCH)
    folder = os.path.join(WORK, f"train_{name}")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, f"train_{name}.yaml")
    write_neural_config(conf, data, seed, options)
    lr = options["train.optimizer.default.args.lr"]

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    (first,) = trace_entries(folder, event="epoch_completed")
    (valid,) = trace_entries(folder, event="eval_completed")
    check(np.isfinite(first["avg_loss"]), first)
    check(0.0 < valid["mean_reciprocal_rank_filtered"] <= 1.0, valid)
    steps = first["batches"]
    check(counts["scatter_add_sorted"] == scatter_per_step * steps,
          f"scatter launches {counts['scatter_add_sorted']} != "
          f"{scatter_per_step} x {steps}")
    check(counts["rank_counts"] == 2 * valid_batches,
          f"rank launches {counts['rank_counts']} != 2 x {valid_batches}")
    check(counts["rank_counts_epilogue"] == 0 and counts["rows_set"] == 0
          and counts["pooled_scores"] == 0 and counts["fused_row_update"] == 0, counts)
    log(f"  start, one epoch and a validation: wall {start_wall:.2f} s; scatter "
        f"kernel {scatter_per_step} x {steps} steps = {counts['scatter_add_sorted']}, "
        f"rank kernel 2 x {valid_batches} = {counts['rank_counts']}; avg_loss "
        f"{first['avg_loss']:.6f}, validation wall {valid['epoch_time']:.3f} s, "
        f"MRR filtered {valid['mean_reciprocal_rank_filtered']:.6f}")

    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "2"])
    torch.cuda.synchronize()
    resumed = read_counters()
    entries = trace_entries(folder, event="epoch_completed")
    check([e["epoch"] for e in entries] == [1, 2], entries)
    warm = entries[1]
    check(np.isfinite(warm["avg_loss"]), warm)
    check(resumed["scatter_add_sorted"] == scatter_per_step * warm["batches"], resumed)
    check(resumed["rank_counts"] == 2 * valid_batches, resumed)
    num = warm["size"]
    unit = "queries" if options["train.type"] == "KvsAll" else "triples"
    log(f"  resume to epoch 2 (the warm epoch): wall {warm['epoch_time']:.3f} s "
        f"({num / warm['epoch_time']:.1f} {unit}/s), {warm['batches']} steps, "
        f"avg_loss {entries[0]['avg_loss']:.6f} -> {warm['avg_loss']:.6f}")

    step, leaves = card_matches_cpu(folder, "checkpoint_00002.pt", no_dropout,
                                    zero_grad_leaves, lr)

    # the statistics moved, their optimizer state did not (Adam, no decay)
    init = load_checkpoint(os.path.join(folder, "checkpoint_00000.pt"))
    last = load_checkpoint(os.path.join(folder, "checkpoint_00002.pt"))
    stats_moved = None
    if "bn1_mean" in last["model"][0].get("scorer", {}):
        stats_moved = {}
        for key in ("bn1_mean", "bn1_var", "bn2_mean", "bn2_var"):
            moved = float(np.abs(np.asarray(last["model"][0]["scorer"][key])
                                 - np.asarray(init["model"][0]["scorer"][key])).max())
            check(moved > 1e-3, f"{key} did not move")
            state = last["optimizer_state"]["leaves"][leaves.index(f"scorer.{key}")]
            check(all(not np.asarray(v).any() for v in state.values()),
                  f"the optimizer state of {key} moved")
            stats_moved[key] = moved
        log(f"  batch-norm statistics moved by up to {stats_moved}; their Adam "
            "moments stayed zero")

    reset_counters()
    start = time.perf_counter()
    cli.main(["test", folder])
    torch.cuda.synchronize()
    test_wall = time.perf_counter() - start
    tested = read_counters()
    check(tested["rank_counts"] == 2 * test_batches, tested)
    entry = last_test_entry(folder)
    metrics = {k: v for k, v in entry.items()
               if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
               and not k.endswith("_with_test")}
    check(metrics and all(np.isfinite(v) for v in metrics.values()), metrics)
    check(0.0 < entry["mean_reciprocal_rank_filtered"] <= 1.0, entry)
    log(f"  test: {tested['rank_counts']} rank launches, wall {test_wall:.3f} s, "
        f"MRR filtered {entry['mean_reciprocal_rank_filtered']:.6f}")

    reset_counters()
    start = time.perf_counter()
    cli.main(["valid", folder, "--eval.type", "training_loss"])
    torch.cuda.synchronize()
    loss_wall = time.perf_counter() - start
    loss_counts = read_counters()
    loss_entry = trace_entries(folder, event="eval_completed",
                               type="training_loss")[-1]
    check(np.isfinite(loss_entry["avg_loss"]) and loss_entry["avg_loss"] > 0,
          loss_entry)
    check(not any(loss_counts.values()), f"a forward-only pass launched {loss_counts}")
    log(f"  valid --eval.type training_loss: avg_loss {loss_entry['avg_loss']:.6f}, "
        f"avg_cost {loss_entry['avg_cost']:.6f}, wall {loss_wall:.3f} s (forward "
        "only: no kernel launch)")

    job = test_job(folder)
    job.model.eval()  # as the evaluation's run() sets it
    with torch.inference_mode():
        job._prepare()
        job._is_prepared = True
        job._evaluate()
        agree = routes_agree(job)
        plain = eval_ranks_agree(job)
    # the scatter kernel at the lookups' shapes: a batch of ids into the
    # entity table and into the relation table (2 |R| rows), D wide
    dim, device = job.model.get_s_embedder().dim, job.model.device
    rows = (job.dataset.num_entities(), job.model.get_p_embedder().vocab_size)
    del job
    rng = np.random.default_rng(seed + 20)
    n = options["train.batch_size"]
    scatter_err = max(
        scatter_case(rng, device, f"C-{name} {what} lookups",
                     power_law_ids(rng, num_rows, n, exponent), num_rows, dim)
        for what, num_rows, exponent in (("entity", rows[0], 0.8),
                                         ("relation", rows[1], 1.0)))

    # a whole epoch gives the profiler millions of events, whose reduction
    # takes minutes: a window of its first steps stands for it
    profiled = resumed_job(folder, "checkpoint_00002.pt")
    batches = profiled._batches
    profiled._batches = lambda: itertools.islice(batches(), PROFILED_STEPS)

    def window():
        profiled.epoch += 1
        profiled.run_epoch()

    profile = profile_run(window, f"{PROFILED_STEPS} steps of a warm epoch of "
                                  f"C-{name}")
    del profiled
    if profile["device_busy_ms"] is not None:
        device_step_ms = profile["device_busy_ms"] / PROFILED_STEPS
        warm_step_ms = 1e3 * warm["epoch_time"] / warm["batches"]
        profile["device_ms_per_step"] = device_step_ms
        profile["busy_share_of_warm_epoch"] = device_step_ms / warm_step_ms
        log(f"  device {device_step_ms:.3f} ms a step against the warm epoch's "
            f"{warm_step_ms:.3f} ms of wall a step: busy "
            f"{100 * device_step_ms / warm_step_ms:.1f}%")
    return {"launches": counts, "resume_launches": resumed, "test_launches": tested,
            "start_wall_s": start_wall, "warm_epoch_s": warm["epoch_time"],
            f"warm_{unit}_per_s": num / warm["epoch_time"], "steps": warm["batches"],
            "avg_loss": [e["avg_loss"] for e in entries],
            "valid_wall_s": valid["epoch_time"], "test_wall_s": test_wall,
            "valid_mrr_filtered": valid["mean_reciprocal_rank_filtered"],
            "test_mrr_filtered": entry["mean_reciprocal_rank_filtered"],
            "training_loss": loss_entry["avg_loss"], "training_loss_wall_s": loss_wall,
            "stats_moved": stats_moved, "routes": agree, "rank_vs_plain": plain,
            "scatter_max_abs_err": scatter_err, "card_vs_cpu": step,
            "profile": profile, "folder": folder}


# -- phase 22: the dtype policy (parallel.*_dtype: bfloat16) ---------------------

BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 on the tensor cores
BF16_ULP = 2.0 ** -7           # the spacing of bfloat16 relative to a value, at most


def reset_bf16_counters():
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores
    from kge_tpu_torch.ops.embedding_ops import rows_set, sorted_scatter_add
    from kge_tpu_torch.ops.optim import fused_sorted_update
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    for fn in (fused_rank_counts, sorted_scatter_add, rows_set, fused_sorted_update,
               pooled_dist_scores):
        fn.bf16_launches = 0
    pooled_dist_scores.bf16_backward_launches = 0


def read_bf16_counters():
    """The bfloat16 launches among each wrapper's launches."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores
    from kge_tpu_torch.ops.embedding_ops import rows_set, sorted_scatter_add
    from kge_tpu_torch.ops.optim import fused_sorted_update
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    return {"rank_counts": fused_rank_counts.bf16_launches,
            "scatter_add_sorted": sorted_scatter_add.bf16_launches,
            "rows_set": rows_set.bf16_launches,
            "fused_row_update": fused_sorted_update.bf16_launches,
            "pooled_scores": pooled_dist_scores.bf16_launches,
            "pooled_scores_bwd": pooled_dist_scores.bf16_backward_launches}


def bf16_bound(nbytes: float, tensor_flops: float = 0.0, flops: float = 0.0,
               specials: float = 0.0):
    """``bound`` with bfloat16 products on the tensor cores as a fourth term:
    bytes over the memory rate, bf16 multiply-adds over 989 TFLOP/s, other
    fp32 operations and square roots over their rates."""
    bound_ms, bound_by, term = bound(nbytes, flops, specials)
    tensor_ms = tensor_flops / BF16_FLOPS_PER_S * 1e3
    if tensor_ms > bound_ms:
        return tensor_ms, "operations", "bf16 tensor cores"
    return bound_ms, bound_by, term


def bf16_rank_case(seed: int, device, epilogue: bool):
    """K1's bfloat16 path against its plain version: the counts exactly,
    vals and the pivot bit for bit; times at n = 256, |E| = 14,541, D = 512
    (with the L2 epilogue: TransE-L2's augmented operands, d = 128, cast
    to bfloat16)."""
    from kge_tpu_torch.ops.rank_kernel import (
        NEG_SQRT_L2,
        bf16_tile_sums,
        certificate_bound,
        certified_categories,
        csr_row_ids,
        fused_rank_counts,
        fused_rank_counts_plain,
    )
    from kge_tpu_torch.utils.dtypes import weak

    rng = np.random.default_rng(seed + 22)
    E, n = NUM_ENTITIES, BATCH
    if epilogue:
        q, targets = l2_inputs(seed, device)[:2]
        q, targets = q.bfloat16().contiguous(), targets.bfloat16().contiguous()
        score_map = NEG_SQRT_L2
    else:
        q = torch.tensor(rng.normal(0, 0.05, (n, DIM)).astype(np.float32),
                         device=device).bfloat16()
        targets = torch.tensor(rng.normal(0, 0.05, (E, DIM)).astype(np.float32),
                               device=device).bfloat16()
        score_map = None
    D = q.shape[1]
    true_np = rng.integers(0, E, n).astype(np.int32)
    row_ptr, cols = skewed_labels(rng, n, E, device, true=true_np)
    true = torch.tensor(true_np, device=device)

    def kernel():
        return fused_rank_counts(q, targets, None, row_ptr, cols, E, ATOL, RTOL,
                                 score_map=score_map, pivot_cols=true)

    def plain():
        return fused_rank_counts_plain(q, targets, None, row_ptr, cols, E, ATOL,
                                       RTOL, score_map=score_map, pivot_cols=true)

    g, c, vals, pivot = kernel()
    recounted = int(fused_rank_counts.last_recounted)
    pg, pc, pvals, ppivot = plain()
    torch.cuda.synchronize()
    check(vals.dtype == torch.bfloat16 and pivot.dtype == torch.bfloat16)
    check(torch.equal(g, pg) and torch.equal(c, pc),
          f"bf16 rank counts differ from the plain version's on "
          f"{int(((g != pg) | (c != pc)).sum())} rows")
    check(torch.equal(vals.view(torch.int16), pvals.view(torch.int16))
          and torch.equal(pivot.view(torch.int16), ppivot.view(torch.int16)),
          "bf16 vals or pivots differ in bits from the plain version's")
    second = kernel()
    torch.cuda.synchronize()
    check(all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                          b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
              for a, b in zip((g, c, vals, pivot), second)),
          "two launches of the bf16 rank kernel differ")
    # the kernel leaves open exactly the entries the PyTorch rule leaves
    # open on the kernel's own tensor-core sums and norm bounds
    sums, nq, nt = bf16_tile_sums(q, targets)
    rule = certified_categories(sums, certificate_bound(nq, nt, q.shape[1]), pivot,
                                ATOL, RTOL, score_map)
    check(recounted == int((rule < 0).sum()),
          f"the kernel recounted {recounted} entries, the rule leaves "
          f"{int((rule < 0).sum())} open")
    del sums, rule
    share = recounted / (n * E)
    rows = csr_row_ids(row_ptr)
    atol, rtol = weak(ATOL, q), weak(RTOL, q)

    def library():
        # cuBLAS's bf16 product (its own order of sums), then the tie test
        scores = torch.matmul(q, targets.T)
        if score_map is not None:
            scores = score_map(scores)
        p = scores.gather(1, true.long()[:, None])
        close = (scores - p).abs() <= atol + rtol * p.abs()
        greater = (scores > p) & ~close
        return greater.sum(1), close.sum(1), scores[rows, cols.long()]

    ms = time_ms(kernel)
    plain_ms = time_ms(plain, reps=3)
    library_ms = time_ms(library)
    nnz = cols.numel()
    nbytes = 2.0 * (n * D + E * D) + 4.0 * ((n + 1) + nnz + n + 2 * n) \
        + 2.0 * (nnz + n)
    bound_ms, bound_by, term = bf16_bound(nbytes, tensor_flops=2.0 * n * E * D)
    what = "L2 epilogue" if epilogue else "identity"
    log(f"  rank_counts bf16 ({what}) n={n} |E|={E} D={D} nnz={nnz}: {ms:.4f} ms, "
        f"recount share {share:.6f} ({recounted} of {n * E} entries left open by "
        f"the certificate, as by the rule; {nnz} labels), plain {plain_ms:.4f} ms, "
        f"library bf16 matmul + compares {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}: {term}); counts equal the plain version's on all {n} "
        f"rows, vals and pivots bit for bit, two launches bit-equal")
    return {"shape": f"n={n} |E|={E} D={D} ({what})", "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_term": term, "max_abs_err": 0.0,
            "recounted": recounted, "recount_share": share, "labels": nnz}


def bf16_gamma_check(seed: int, device):
    """gamma_D of K1's bfloat16 certificate on the card: the kernel's own
    tensor-core sums (``bf16_tile_sums``) of 512 x 8,192 dot products for
    each D in {132, 320, 512} and each of four inputs (Gaussian, cancelling
    alternating products, exponents spread over 2^-40..2^40, all products
    positive: 50 million in all) against float64 sums (exact products;
    their own error under D 2^-53 S). The largest |x - exact| / (N M), N
    and M the kernel's norm bounds, must stay within gamma_D / 8."""
    from kge_tpu_torch.ops.rank_kernel import bf16_tile_sums, certificate_gamma

    generator = torch.Generator(device=device).manual_seed(seed + 2214)
    n, m = 512, 8192

    def inputs(kind, D):
        def randn(rows):
            return torch.randn(rows, D, generator=generator, device=device)

        def rand(rows):
            return torch.rand(rows, D, generator=generator, device=device)

        if kind == "gaussian":
            return randn(n), randn(m)
        if kind == "cancellation":
            sign = torch.where(torch.arange(D, device=device) % 2 == 0, 1.0, -1.0)
            q = 4.0 + 1e-2 * randn(n)
            return q, sign * (1.0 + rand(m)) + 1e-2 * randn(m)
        if kind == "wide":
            def spread(rows):
                scale = torch.randint(-40, 41, (rows, D), generator=generator,
                                      device=device).float()
                return randn(rows) * torch.exp2(scale)
            return spread(n), spread(m)
        return 0.5 + rand(n), 0.5 + rand(m)  # positive: no error cancels

    out = {}
    for D in (132, 320, 512):
        gamma = certificate_gamma(D)
        for kind in ("gaussian", "cancellation", "wide", "positive"):
            q, t = (x.bfloat16().contiguous() for x in inputs(kind, D))
            sums, nq, nt = bf16_tile_sums(q, t)
            exact = q.double() @ t.double().T
            bound = nq.double()[:, None] * nt.double()[None, :]
            ratio = float(((sums.double() - exact).abs() / bound).max())
            check(np.isfinite(ratio) and ratio <= gamma / 8,
                  f"gamma_D check: D={D} {kind}: max |x - exact| / (N M) = "
                  f"{ratio:.3e} > gamma_D / 8 = {gamma / 8:.3e}")
            out[f"D={D} {kind}"] = {"max_ratio": ratio, "gamma": gamma,
                                    "margin": gamma / ratio if ratio else None}
            log(f"  gamma_D check D={D} {kind}: max |x - exact| / (N M) "
                f"{ratio:.4e}, gamma_D {gamma:.4e} ({gamma / ratio if ratio else float('inf'):.1f}"
                f" times the largest), {n * m} dot products")
            del sums, exact, bound
    return out


def bf16_scatter_case(seed: int, device):
    """K2's bfloat16 path at 8,192 power-law ids into [14,541, 512] (the
    kernels line's shape) and at T-sparse's 16,642 ids into [200,000, 512]:
    within two bfloat16 ulps of each row's summed magnitude of the plain
    version (both sum in float32, in other orders, and round once); its
    launches alone, the segment sums and their launch A as in phase 8."""
    from kge_tpu_torch.ops.embedding_ops import sorted_scatter_add, sorted_scatter_add_plain

    rng = np.random.default_rng(seed + 23)
    cases = [("entity lookups", power_law_ids(rng, NUM_ENTITIES, TRAIN_BATCH, 0.8),
              NUM_ENTITIES),
             ("row-sparse entity ids", rows_set_cases(rng)[0][2], SPARSE_ENTITIES)]
    out = []
    for name, ids_np, rows in cases:
        n, D = len(ids_np), DIM

        def make():
            return (torch.tensor(ids_np, dtype=torch.int64, device=device),
                    torch.randn(n, D, device=device).bfloat16())

        pick = rotating(make)
        ids, upd = pick()
        got = sorted_scatter_add(ids, upd, rows)
        want = sorted_scatter_add_plain(ids, upd, rows)
        magnitude = sorted_scatter_add_plain(ids, upd.float().abs(), rows)
        err = (got.float() - want.float()).abs()
        check(bool((err <= 1e-6 + BF16_ULP * magnitude).all()),
              f"bf16 scatter differs from its plain version beyond an ulp of the sums "
              f"({name})")
        ms = time_ms(lambda: sorted_scatter_add(*pick(), rows))
        plain_ms = time_ms(lambda: sorted_scatter_add_plain(*pick(), rows))
        launches = scatter_launch_times(pick, rows)

        def library():
            ids, upd = pick()
            return torch.zeros(rows, D, dtype=torch.bfloat16,
                               device=device).index_add_(0, ids, upd)

        library_ms = time_ms(library)
        bound_ms, bound_by, term = bf16_bound(2.0 * (n * D + rows * D) + 8.0 * n,
                                              flops=float(n * D))
        log(f"  scatter_add_sorted bf16 {name} n={n} rows={rows} D={D}: {ms:.4f} ms "
            f"(launch A alone {launches['launch_a_ms']:.4f} ms, launch B alone "
            f"{launches['launch_b_ms']:.4f} ms), plain {plain_ms:.4f} ms, library "
            f"index_add_ (bf16) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); segment sums {launches['segment_sums_ms']:.4f} ms (their "
            f"launch A {launches['sort_alone_ms']:.4f} ms); max abs difference from "
            f"plain {float(err.max()):.3e}")
        out.append({"shape": f"{name}: n={n} rows={rows} D={D}", "ms": ms,
                    **launches, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err": float(err.max())})
    return out


def bf16_rows_set_case(seed: int, device):
    """K3's bfloat16 path: 16,642 rows into [200,000, 512], exact."""
    from kge_tpu_torch.ops.embedding_ops import rows_set, rows_set_plain

    rng = np.random.default_rng(seed + 24)
    _, num_rows, ids_np = rows_set_cases(rng)[0]
    m = len(ids_np)
    table = torch.zeros(num_rows, DIM, dtype=torch.bfloat16, device=device)
    values = torch.randn(num_rows, DIM, device=device).bfloat16()

    def make():
        ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
        return ids, values[ids]

    pick = rotating(make)
    ids, rows = pick()
    want = rows_set_plain(table.clone(), ids, rows)
    storage = table.data_ptr()
    rows_set(table, ids, rows)
    check(table.data_ptr() == storage and torch.equal(table, want),
          "bf16 rows_set differs from its plain version")
    ms = time_ms(lambda: rows_set(table, *pick()))
    plain_ms = time_ms(lambda: rows_set_plain(table, *pick()))
    library_ms = time_ms(lambda: table.index_copy_(0, *pick()))
    bound_ms = (2.0 * 2 * m * DIM + 8.0 * m) / HBM_BYTES_PER_S * 1e3
    log(f"  rows_set bf16 m={m} into [{num_rows}, {DIM}]: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library index_copy_ {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms (bytes); equal to the plain version")
    return {"shape": f"m={m} into [{num_rows}, {DIM}]", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "max_abs_err": 0.0}


def bf16_fused_case(seed: int, device):
    """K4's bfloat16 path: Adam, 10,240 row gradients into [200,000, 1,024]
    bfloat16 with bfloat16 moments, within one bfloat16 ulp of the plain
    version (the gradients' duplicates agree in sign)."""
    from kge_tpu_torch.ops.optim import fused_sorted_update, fused_sorted_update_plain

    rng = np.random.default_rng(seed + 25)
    generator = torch.Generator(device=device).manual_seed(seed + 25)
    name, rows, D, ids_np = fused_cases(rng)[0]
    n = len(ids_np)
    ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
    upd = signed_updates(ids, D, generator).bfloat16()
    param, states = fused_state("adam", {}, rows, D, generator, device)
    param = param.bfloat16()
    states = {k: v.bfloat16() for k, v in states.items()}
    ref_param, ref_states = param.clone(), {k: v.clone() for k, v in states.items()}
    lr, step = ROTATE_LR, 3
    fused_sorted_update("adam", {}, ids, upd, param, states, lr, step)
    fused_sorted_update_plain("adam", {}, ids, upd, ref_param, ref_states, lr, step)
    worst = 0.0
    for got, want in [(param, ref_param)] + [(states[k], ref_states[k]) for k in states]:
        check(got.dtype == torch.bfloat16)
        err = (got.float() - want.float()).abs()
        check(bool((err <= BF16_ULP * want.float().abs()).all()),
              "bf16 fused update differs from its plain version by more than an ulp")
        worst = max(worst, float(err.max()))
    del ref_param, ref_states
    ms = time_ms(lambda: fused_sorted_update("adam", {}, ids, upd, param, states,
                                             lr, step), reps=10)
    plain_ms = time_ms(lambda: fused_sorted_update_plain(
        "adam", {}, ids, upd, param, states, lr, step), reps=3)
    weight = torch.nn.Parameter(param.clone())
    adam = torch.optim.Adam([weight], lr=lr, fused=True)

    def library():
        weight.grad = torch.zeros_like(weight).index_add_(0, ids, upd)
        adam.step()

    library_ms = time_ms(library, reps=10)
    del weight, adam
    nbytes = 2.0 * (2 * 3 * rows * D + n * D) + 8.0 * n
    bound_ms, bound_by, _ = bf16_bound(nbytes, flops=12.0 * rows * D)
    log(f"  fused_row_update bf16 (Adam) {name} [{rows}, {D}] n={n}: {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library index_add_ + torch.optim.Adam(fused=True) "
        f"on bf16 {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); max abs "
        f"difference from plain {worst:.3e} (within one bf16 ulp)")
    del param, states, upd
    torch.cuda.empty_cache()
    return {"shape": f"Adam [{rows}, {D}] n={n}", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": worst}


def bf16_pooled_case(seed: int, device):
    """K5a and K5b's bfloat16 paths against the plain version at P-rotate's
    shape (cmod, n = 4,096, K = 128, F = 8, d = 512 a part) and P-transe's
    two (l1, n = 8,192, K = 128, F = 8, d = 128 and 512): scores within
    one bfloat16 ulp, dq and dpool within one ulp plus 2^-12 of the summed
    factor magnitudes (2 |g| each); two launches bit-equal. Times of the
    kernels, the plain version and, for l1, one library call: torch.cdist
    (p = 1) + gather in float32 on the same inputs (no one call computes
    cmod). Returns (forward cases, backward cases), P-rotate's first."""
    forward, backward = [], []
    generator = torch.Generator(device=device).manual_seed(seed + 26)
    for case in (POOLED_CASES[2], POOLED_CASES[0], POOLED_CASES[1]):
        fwd, bwd = bf16_pooled_shape(case, generator, device)
        forward.append(fwd)
        backward.append(bwd)
    return forward, backward


def bf16_pooled_shape(case, generator, device):
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores, pooled_dist_scores_plain

    name, kind, n, K, F, d, _, _ = case
    queries, pools, sel = pooled_inputs(kind, n, K, F, d, generator, device)
    leaves = [x.bfloat16().requires_grad_(True) for x in queries + pools]
    g = torch.randn(n, K, generator=generator, device=device).bfloat16()
    parts = len(queries)
    del queries, pools

    def run(fn, tensors=leaves):
        return fn(tensors[:parts], tensors[parts:], sel, F, kind)

    runs = []
    for _ in range(2):
        out = run(pooled_dist_scores)
        runs.append((out.detach(), torch.autograd.grad(out, leaves, g)))
    (out, grads), (out2, grads2) = runs
    check(all(torch.equal(a.view(torch.int16), b.view(torch.int16))
              for a, b in zip((out, *grads), (out2, *grads2))),
          f"bf16 pooled kernels not bit-equal across launches ({name})")
    ref = run(pooled_dist_scores_plain)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    err = (out.float() - ref.detach().float()).abs()
    check(out.dtype == torch.bfloat16 and bool(
        (err <= 1e-6 + BF16_ULP * ref.float().abs()).all()),
        f"bf16 pooled scores differ from the plain version by more than an ulp ({name})")
    fwd_err = float(err.max())
    rows = (torch.arange(K, device=device)[None, :] * F + sel.long()).reshape(-1)
    dq_mag = 2 * g.float().abs().sum(1, keepdim=True)
    dpool_mag = torch.zeros(K * F, 1, device=device).index_add_(
        0, rows, 2 * g.float().abs().reshape(-1, 1))
    bwd_err = 0.0
    for i, (got, want) in enumerate(zip(grads, ref_grads)):
        mag = dq_mag if i < parts else dpool_mag
        e = (got.float() - want.float()).abs()
        check(got.dtype == torch.bfloat16 and bool(
            (e <= 1e-6 + BF16_ULP * want.float().abs() + 2.0 ** -12 * mag).all()),
            f"bf16 pooled gradient {i} differs from the plain version ({name})")
        bwd_err = max(bwd_err, float(e.max()))
    del out, grads, out2, grads2, runs, ref, ref_grads, dq_mag, dpool_mag
    # the library call in float32 on the same (bfloat16) inputs
    leaves32 = [x.detach().float().requires_grad_(True) for x in leaves]
    gather = rows.reshape(n, K)

    def library(tensors=leaves32):
        return -torch.cdist(tensors[0], tensors[parts], p=1).gather(1, gather)

    times = {}
    for what, fn in (("kernel", lambda: run(pooled_dist_scores)),
                     ("plain", lambda: run(pooled_dist_scores_plain)),
                     ("library", library if kind == "l1" else None)):
        if fn is None:
            times[what] = (None, None)
            continue
        with torch.no_grad():
            fwd_ms = time_ms(fn, reps=10)
        scores = fn()
        tensors = leaves32 if what == "library" else leaves
        gs = g.float() if what == "library" else g

        def backward_of(scores=scores, tensors=tensors, gs=gs):
            return torch.autograd.grad(scores, tensors, gs, retain_graph=True)

        times[what] = (fwd_ms, time_ms(backward_of, reps=5))
        del scores
    elements = float(n) * K * d
    ops = 4.0 if kind == "l1" else 8.0
    specials = elements if kind == "cmod" else 0.0
    read = 2.0 * (parts * (n * d + K * F * d)) + 4.0 * n * K
    fwd_bound = bf16_bound(read + 2.0 * n * K, flops=ops * elements, specials=specials)
    bwd_bound = bf16_bound(read + 2.0 * n * K + 2.0 * parts * (n * d + K * F * d),
                           flops=2 * ops * elements, specials=specials)
    library_name = ("torch.cdist(p=1) + gather in float32" if kind == "l1"
                    else "none (no one call computes cmod)")
    out = []
    for label, index, (bound_ms, bound_by, term), max_err in (
            ("pooled_scores", 0, fwd_bound, fwd_err),
            ("pooled_scores_bwd", 1, bwd_bound, bwd_err)):
        lib_ms = times["library"][index]
        log(f"  {label} bf16 {name} ({kind}) n={n} K={K} F={F} d={d}: "
            f"{times['kernel'][index]:.4f} ms, plain {times['plain'][index]:.4f} ms, "
            f"library ({library_name}) "
            f"{'null' if lib_ms is None else format(lib_ms, '.4f') + ' ms'}, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {term}); max abs difference from plain "
            f"{max_err:.3e}; two launches bit-equal")
        out.append({"shape": f"{name} ({kind}) n={n} K={K} F={F} d={d}",
                    "ms": times["kernel"][index], "plain_ms": times["plain"][index], "library_ms": lib_ms,
                    "library": library_name, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bound_term": term, "max_abs_err": max_err})
    del leaves, leaves32, sel, g, rows, gather
    torch.cuda.empty_cache()
    return out


def bf16_fast_ops_exact(device):
    """The bfloat16 path's fast operations against the IEEE ones,
    exhaustively (ops/dist_pool.py ``bf16_fast_ops_check``): no result may
    differ where the kernels use them."""
    from kge_tpu_torch.ops.dist_pool import bf16_fast_ops_check

    start = time.perf_counter()
    counts = bf16_fast_ops_check(device)
    torch.cuda.synchronize()
    differ = {k: v for k, v in counts.items()
              if k.endswith("_differ") and v}
    check(not differ and counts["sqrt_inputs"] == 29151
          and counts["quotient_pairs"] == 515635208,
          f"bf16 fast operations differ from the IEEE ones: {counts}")
    log(f"  bf16 fast operations exact: sub/add/mul on all 2^32 pairs, "
        f"{counts['sqrt_inputs']} square roots, {counts['quotient_pairs']} quotients "
        f"({time.perf_counter() - start:.2f} s)")
    return counts


def card_vs_cpu_step(folder, checkpoint, lr, what):
    """One step of a bfloat16 job on the card and on the CPU from
    ``checkpoint``, the same batch and negatives (drawn on the card). The
    bound: an element of a table or state within 1e-6 + 1e-5 |CPU| (float32)
    or one bfloat16 ulp of |CPU| (bfloat16), plus 2^-5 of the step's own
    size |CPU - before| (the step's inputs are bfloat16 scores or gradients,
    summed in other orders on the two devices). Two things move an element
    further, and the rule turns either into a step of its own of up to lr
    (Adagrad's step is at most lr, Adam's about lr, ROADMAP C.3): a gradient
    that cancels to about its terms' rounding, and a score that rounds to
    the neighbouring bfloat16 value on the other device, which at X-complex's
    magnitudes (scores of tens, an ulp of 0.125 to 0.25) moves the softmax
    weights of its row by a fraction of themselves. At most 1% of the
    elements may lie beyond that bound (up to 0.1% were, in the runs that
    chose it), and all within it plus 2.1 lr. The step must move the tables.
    Losses within rtol 1e-2."""
    jobs = {device: resumed_job(folder, checkpoint, **{"job.device": device})
            for device in ("cuda", "cpu")}
    batch = next(iter(jobs["cuda"]._batches()))
    variant = jobs["cuda"]._step_variant(batch)
    tensors = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()
               if k != "true_size" and not isinstance(v, str)}
    if hasattr(jobs["cuda"], "_with_negatives"):
        tensors = jobs["cuda"]._with_negatives(tensors)
    before = [t.detach().float().cpu() for t in tables_of(jobs["cpu"], state=True)]
    out = {}
    for device, job in jobs.items():
        here = {k: v.to(job.device) for k, v in tensors.items()}
        cost, _ = job._train_step(here, job._current_lrs(), variant)
        out[device] = (float(cost), [t.detach().cpu() for t in tables_of(job, state=True)])
    torch.cuda.synchronize()
    (cost_c, card), (cost_h, cpu) = out["cuda"], out["cpu"]
    check(abs(cost_c - cost_h) <= 1e-2 * abs(cost_h), (what, cost_c, cost_h))
    worst, beyond, total, moved = 0.0, 0, 0, 0.0
    cpu_seen = []
    for a, b, b0 in zip(card, cpu, before):
        cpu_seen.append(b)
        moved = max(moved, float((b.float() - b0).abs().max()))
        check(a.dtype == b.dtype, f"{what}: dtypes {a.dtype} and {b.dtype}")
        a, bf = a.float(), b.float()
        rel = BF16_ULP if b.dtype == torch.bfloat16 else 1e-5
        strict = 1e-6 + rel * bf.abs() + 2.0 ** -5 * (bf - b0).abs()
        err = (a - bf).abs()
        off = err > strict
        excess = err - strict - 2.1 * lr
        if bool((excess > 0).any()):
            at = int(excess.argmax())
            log(f"  {what}: leaf {len(cpu_seen)} {tuple(b.shape)} element {at}: "
                f"before {float(b0.flatten()[at])!r}, card {float(a.flatten()[at])!r}, "
                f"CPU {float(bf.flatten()[at])!r}; {int((excess > 0).sum())} elements")
        check(bool((excess <= 0).all()),
              f"{what}: card and CPU differ by more than 2.1 lr: {float(err.max())}")
        beyond += int(off.sum())
        total += err.numel()
        worst = max(worst, float(err.max()))
    check(beyond <= 1e-2 * total, f"{what}: {beyond} of {total} elements beyond the bound")
    check(moved > 0.0, f"{what}: the step did not move the tables")
    log(f"  one step of {what}, card vs CPU: loss {cost_c:.6f} vs {cost_h:.6f}; "
        f"tables and states max abs difference {worst:.3e} (the step moved them by "
        f"up to {moved:.3e}); {beyond} of {total} elements beyond 1e-6 + ulp |CPU| "
        f"+ 2^-5 |step| (all within it + 2.1 lr = {2.1 * lr:.2e})")
    del jobs
    torch.cuda.empty_cache()
    return {"loss_card": cost_c, "loss_cpu": cost_h, "max_abs_diff": worst,
            "moved": moved, "elements_beyond": beyond, "elements": total}


def bf16_ranks_agree(folder: str, batches: int = 2):
    """The first ``batches`` batches of the folder's test evaluation ranked
    through the kernel and through its plain version: every per-triple rank
    equal (the bfloat16 path's counts are exact). Then the warm test
    evaluation, profiled; returns the profile and K1's device ms in it."""
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts_plain

    job = test_job(folder)
    with torch.inference_mode():
        job._prepare()
        job._is_prepared = True
        job._evaluate()
        _, device_batches = job._collate_cache
        for triples, labels in device_batches[:batches]:
            kernel, _ = job._rank_batch(triples, labels)
            plain, _ = job._rank_batch(triples, labels,
                                       rank_counts=fused_rank_counts_plain)
            for r in kernel:
                check(torch.equal(kernel[r], plain[r]),
                      f"bf16 ranking {r}: kernel and plain ranks differ")
        log(f"  {batches} test batches of {os.path.basename(folder)} in bf16: "
            f"ranks through K1 equal the plain version's on every triple")
        profile = profile_run(job._evaluate, "warm test eval in bf16 compute")
    k1_ms = sum(t["ms"] for t in profile["top"] + profile["own_kernels_below_top"]
                if "rank_" in t["name"] and "_kernel" in t["name"])
    if profile["device_busy_ms"]:
        log(f"  K1's launches (prologue, tiles, recount): {k1_ms:.3f} ms of the warm "
            f"test eval's {profile['device_busy_ms']:.3f} ms of device time")
    del job
    torch.cuda.empty_cache()
    return {"eval_profile": profile, "k1_ms": k1_ms}


def run_dtype_policy(seed: int, data: str, dense_folder: str, transe_l2_folder: str):
    """Phase 22; returns a summary dict."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.models.convert import leaf_tensor
    from kge_tpu_torch.utils.io import load_checkpoint, save_checkpoint

    device = torch.device("cuda")
    gamma = bf16_gamma_check(seed, device)
    kernels = {
        "rank_counts": [bf16_rank_case(seed, device, False),
                        bf16_rank_case(seed, device, True)],
        "scatter_add_sorted": bf16_scatter_case(seed, device),
        "rows_set": [bf16_rows_set_case(seed, device)],
        "fused_row_update": [bf16_fused_case(seed, device)],
    }
    kernels["pooled_scores"], kernels["pooled_scores_bwd"] = bf16_pooled_case(seed, device)
    log(f"  {card_line()}")
    out = {"kernels": kernels, "bf16_fast_ops": bf16_fast_ops_exact(device),
           "gamma_check": gamma}
    num_train = FB15K237[2]

    # T-transe-l2's test in bfloat16 compute: K1's bf16 path with the L2
    # epilogue on a main path
    test_batches = -(-NUM_TEST // BATCH)
    reset_counters()
    reset_bf16_counters()
    start = time.perf_counter()
    cli.main(["test", transe_l2_folder, "--eval.batch_size", str(BATCH),
              "--parallel.compute_dtype", "bfloat16"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts, bf16 = read_counters(), read_bf16_counters()
    check(bf16["rank_counts"] == counts["rank_counts"]
          == counts["rank_counts_epilogue"] == 2 * test_batches, (counts, bf16))
    entry = last_test_entry(transe_l2_folder)
    check(0.0 < entry["mean_reciprocal_rank_filtered"] <= 1.0)
    log(f"  T-transe-l2 test in bf16 compute: {bf16['rank_counts']} K1 launches, all "
        f"bf16 with the L2 epilogue; wall {wall:.3f} s; MRR filtered "
        f"{entry['mean_reciprocal_rank_filtered']:.6f}")
    out["transe_l2_test"] = {"launches": counts, "bf16_launches": bf16, "wall_s": wall,
                             "mrr_filtered": entry["mean_reciprocal_rank_filtered"]}

    # X-complex in bfloat16 compute, its entity table from T-dense's folder
    folder = os.path.join(WORK, "train_xcomplex_bf16")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_xcomplex_bf16.yaml")
    # T-dense's best checkpoint, its dataset named by path: the dataset's
    # own yaml named it by its folder's name, which resolves under data/
    source = os.path.join(WORK, "pretrained_source.pt")
    checkpoint = load_checkpoint(os.path.join(dense_folder, "checkpoint_best.pt"))
    checkpoint["config"].set("dataset.name", data)
    save_checkpoint(checkpoint, source)
    write_train_config(conf, data, seed, **{
        "negative_sampling.shared": False, "negative_sampling.implementation": "all",
        "valid.every": 1, "train.max_epochs": 1,
        "parallel.compute_dtype": "bfloat16",
        "complex.entity_embedder.pretrain.model_filename": source})
    reset_counters()
    reset_bf16_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    cli.main(["test", folder])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, bf16 = read_counters(), read_bf16_counters()
    valid_batches = -(-FB15K237[3] // BATCH)
    test_batches = -(-NUM_TEST // BATCH)
    check(bf16["rank_counts"] == launches["rank_counts"]
          == 2 * (valid_batches + test_batches), (launches, bf16))
    losses = check_losses(folder, [1])
    initial = load_checkpoint(os.path.join(folder, "checkpoint_00000.pt"))["model"][0]
    pretrained = load_checkpoint(source)["model"][0]
    for key in ("entity_embedder", "relation_embedder"):
        got = leaf_tensor(initial[key]["embeddings"])
        want = leaf_tensor(pretrained[key]["embeddings"])
        same = torch.equal(got, want.to(got.dtype))
        check(same == (key == "entity_embedder"),
              f"pretrained start: {key} equal to T-dense's: {same}")
    (entry,) = trace_entries(folder, event="eval_completed", split="test")
    check(0.0 < entry["mean_reciprocal_rank_filtered"] <= 1.0)
    test_eval = bf16_ranks_agree(folder)
    log(f"  X-complex bf16 compute: start 1 epoch + validation and test, wall "
        f"{wall:.2f} s; avg_loss {losses}; K1 bf16 launches {bf16['rank_counts']} "
        f"(2 x ({valid_batches} + {test_batches})); test MRR filtered "
        f"{entry['mean_reciprocal_rank_filtered']:.6f}; the initial entity table is "
        f"T-dense's bit for bit, the relation table its own")
    step = card_vs_cpu_step(folder, "checkpoint_00001.pt", 0.1, "X-complex bf16")
    job = resumed_job(folder, "checkpoint_00001.pt")
    timing = warm_epoch(job, num_train, "X-complex bf16 compute", warmup=False)
    gemm = sum(t["ms"] for t in timing["profile"]["top"]
               if "gemm" in t["name"].lower() or "cutlass" in t["name"].lower())
    log(f"  X-complex bf16: GEMM kernels {gemm:.1f} ms of the profiled epoch's "
        f"{timing['profile']['device_busy_ms']:.1f} ms of device time")
    del job
    torch.cuda.empty_cache()
    out["xcomplex"] = {"launches": launches, "bf16_launches": bf16, "wall_s": wall,
                       "test_eval": test_eval,
                       "avg_loss": losses, "step_card_vs_cpu": step,
                       "warm_epoch": timing, "gemm_ms": gemm,
                       "test_mrr_filtered": entry["mean_reciprocal_rank_filtered"]}

    # P-rotate with both dtypes in bfloat16
    rotate_data = os.path.join(WORK, "sparse_synthetic")
    steps = -(-num_train // ROTATE_BATCH)
    folder = os.path.join(WORK, "train_rotate_bf16")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_rotate_bf16.yaml")
    write_train_config(conf, rotate_data, seed, **pooled_config("rotate"), **{
        "parallel.compute_dtype": "bfloat16", "parallel.param_dtype": "bfloat16"})
    reset_counters()
    reset_bf16_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, bf16 = read_counters(), read_bf16_counters()
    check_pooled_counts(launches, steps, 14, 2, "P-rotate bf16 start")
    for name in ("fused_row_update", "pooled_scores", "pooled_scores_bwd",
                 "scatter_add_sorted"):
        check(bf16[name] == launches[name], f"P-rotate bf16: {name} {bf16} {launches}")
    saved = load_checkpoint(os.path.join(folder, "checkpoint_00001.pt"))
    for leaf in saved["model"][0].values():
        check(leaf_tensor(leaf["embeddings"]).dtype == torch.bfloat16,
              "P-rotate bf16: a table is not bfloat16")
    for leaf in saved["optimizer_state"]["leaves"]:
        check(all(leaf_tensor(v).dtype == torch.bfloat16 for v in leaf.values()),
              "P-rotate bf16: Adam's moments are not bfloat16")
    losses = check_losses(folder, [1])
    log(f"  P-rotate bf16: start 1 epoch, wall {wall:.2f} s, avg_loss {losses}; "
        f"launches {launches}, all of K2, K4, K5a, K5b bf16; tables and moments "
        f"bfloat16 in the checkpoint")
    step = card_vs_cpu_step(folder, "checkpoint_00001.pt", ROTATE_LR, "P-rotate bf16")
    job = resumed_job(folder, "checkpoint_00001.pt")
    timing = warm_epoch(job, num_train, "P-rotate bf16", warmup=False)
    profile = timing["profile"]
    kernels = profile["top"] + profile["own_kernels_below_top"]
    k5b = {name: [(t["ms"], t["calls"]) for t in kernels
                  if f"pooled_{name}_kernel" in t["name"]] for name in ("dq", "dpool")}
    k5b_ms = sum(ms for rows in k5b.values() for ms, _ in rows)
    if profile["device_busy_ms"]:
        log(f"  P-rotate bf16: K5b {k5b_ms:.1f} ms (" + ", ".join(
            f"{name} {ms:.1f} ms in {calls} launches" for name, rows in k5b.items()
            for ms, calls in rows) + f") of the profiled epoch's "
            f"{profile['device_busy_ms']:.1f} ms of device time "
            f"({100 * k5b_ms / profile['device_busy_ms']:.1f}%)")
    del job
    torch.cuda.empty_cache()
    out["rotate"] = {"launches": launches, "bf16_launches": bf16, "wall_s": wall,
                     "avg_loss": losses, "step_card_vs_cpu": step, "warm_epoch": timing,
                     "k5b_ms": k5b_ms}

    # T-sparse with bfloat16 tables
    steps = -(-num_train // TRAIN_BATCH)
    folder = os.path.join(WORK, "train_sparse_bf16")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_sparse_bf16.yaml")
    write_train_config(conf, rotate_data, seed, **{
        "train.max_epochs": 1, "valid.every": 0, "parallel.param_dtype": "bfloat16"})
    reset_counters()
    reset_bf16_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, bf16 = read_counters(), read_bf16_counters()
    check(launches["rows_set"] == bf16["rows_set"] == 4 * steps, (launches, bf16))
    check(bf16["scatter_add_sorted"] > 0, bf16)
    saved = load_checkpoint(os.path.join(folder, "checkpoint_00001.pt"))
    for leaf in saved["model"][0].values():
        check(leaf_tensor(leaf["embeddings"]).dtype == torch.bfloat16,
              "T-sparse bf16: a table is not bfloat16")
    losses = check_losses(folder, [1])
    log(f"  T-sparse bf16 tables: start 1 epoch, wall {wall:.2f} s, avg_loss {losses}; "
        f"launches {launches}; bf16 {bf16}")
    step = card_vs_cpu_step(folder, "checkpoint_00001.pt", 0.1, "T-sparse bf16 tables")
    out["sparse"] = {"launches": launches, "bf16_launches": bf16, "wall_s": wall,
                     "avg_loss": losses, "step_card_vs_cpu": step}
    return out


# -- hyperparameter search, and the tools that read its results ------------------


def search_trials(folder: str):
    """The search folder's per-trial ``search_completed`` entries."""
    return trace_entries(folder, event="search_completed", scope="train")


def trial_log_lines(folder: str, marker: str):
    with open(os.path.join(folder, "kge.log")) as f:
        return [line.rstrip("\n") for line in f if marker in line]


def allocated_mib(folder: str):
    """(allocated, peak) MiB the trial logged when it was done."""
    import re

    (line,) = trial_log_lines(folder, " done: CUDA memory allocated ")
    allocated, peak = re.search(r"allocated ([0-9.]+) MiB, peak ([0-9.]+) MiB",
                                line).groups()
    return float(allocated), float(peak)


def dump_output(argv):
    """What ``python -m kge_tpu_torch dump ...`` prints, run in process."""
    import contextlib
    import io

    from kge_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["dump"] + argv)
    return out.getvalue()


def test_metrics(folder: str, checkpoint: str):
    """``test <folder> --checkpoint <file>`` on the card: (metrics, K1
    launches)."""
    from kge_tpu_torch import cli

    reset_counters()
    cli.main(["test", folder, "--checkpoint", checkpoint, "--eval.batch_size",
              str(BATCH)])
    torch.cuda.synchronize()
    entry = last_test_entry(folder)
    metrics = {k: v for k, v in entry.items()
               if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
               and not k.endswith("_with_test")}
    check(metrics and all(np.isfinite(v) for v in metrics.values()), metrics)
    return metrics, read_counters()["rank_counts"]


def trial_split(search_folder: str, trial: dict, start: float):
    """A trial's wall from the search's previous entry (``start``) to its
    ``search_completed`` entry, split into setup (job, model and optimizer
    up to the first step), the training epoch, the validation and the rest
    (checkpoints, teardown), by the trace's timestamps."""
    (epoch,) = trace_entries(trial["folder"], event="epoch_completed")
    (valid,) = trace_entries(trial["folder"], event="eval_completed")
    wall = trial["timestamp"] - start
    setup = epoch["timestamp"] - epoch["epoch_time"] - start
    rest = wall - setup - epoch["epoch_time"] - valid["epoch_time"]
    return {"wall_s": wall, "setup_s": setup, "epoch_s": epoch["epoch_time"],
            "validation_s": valid["epoch_time"], "rest_s": rest}


def run_search_full_width(seed: int, data: str):
    """Phase 23 (a) and (b), with ``data`` named as under ``data/`` of the
    working directory; returns a summary dict."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.utils.io import load_checkpoint

    num_train, num_valid = FB15K237[2], FB15K237[3]
    steps = -(-num_train // TRAIN_BATCH)
    valid_batches = -(-num_valid // BATCH)
    folder = os.path.join(WORK, "search_grid")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "search_grid.yaml")
    lrs = [0.1, 0.2]
    write_train_config(conf, data, seed, **{
        "job.type": "search", "search.type": "grid_search",
        "grid_search.parameters": {"train.optimizer.default.args.lr": lrs},
        "search.num_workers": 1, "search.on_error": "abort",
        "train.max_epochs": 1, "valid.every": 1,
        "valid.metric": "mean_reciprocal_rank_filtered"})

    # (a) the grid search in this process
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - start
    counts = read_counters()
    check(counts["scatter_add_sorted"] == 2 * steps * 5,
          f"scatter launches {counts['scatter_add_sorted']} != 2 x {steps} x 5")
    check(counts["rank_counts"] == 2 * 2 * valid_batches,
          f"rank launches {counts['rank_counts']} != 2 x 2 x {valid_batches}")
    trials = search_trials(folder)
    check(sorted(t["train.optimizer.default.args.lr"] for t in trials) == lrs, trials)
    start_ts = trace_entries(folder, event="job_created")[-1]["timestamp"]
    splits, memory = [], []
    for trial in trials:
        check(os.path.isfile(os.path.join(trial["folder"], "checkpoint_00001.pt")))
        valid = trace_entries(trial["folder"], job="eval", split="valid")
        check(len(valid) == 1, f"{trial['folder']}: {len(valid)} validations")
        check(trial["metric_value"] == valid[0][trial["metric_name"]])
        (line,) = trial_log_lines(trial["folder"], " runs on ")
        check(" runs on cuda" in line and line.endswith(f"process {os.getpid()}"), line)
        splits.append(trial_split(folder, trial, start_ts))
        start_ts = trial["timestamp"]
        memory.append(allocated_mib(trial["folder"]))
    (done,) = trace_entries(folder, event="search_completed", scope="search")
    mrr = [t["mean_reciprocal_rank_filtered"] for t in
           (trace_entries(t["folder"], job="eval")[0] for t in trials)]
    best = int(np.argmax(mrr))
    check(done["best_trial"] == best and done["metric_value"] == trials[best]["metric_value"],
          f"search_completed {done} against filtered MRRs {mrr}")
    table_mib = NUM_ENTITIES * DIM * 4 / 2 ** 20
    check(memory[1][0] - memory[0][0] < table_mib,
          f"the second trial ends holding {memory[1][0] - memory[0][0]:.1f} MiB more "
          f"than the first (an entity table is {table_mib:.1f} MiB)")
    log(f"  (a) grid search over lr {lrs} (2 trials, 1 epoch + 1 validation each) in "
        f"this process: wall {wall_a:.2f} s; launches {counts}; K2 2 x {steps} x 5 = "
        f"{counts['scatter_add_sorted']}, K1 2 x 2 x {valid_batches} = "
        f"{counts['rank_counts']}")
    for trial, split, (allocated, peak), value in zip(trials, splits, memory, mrr):
        log(f"  trial {os.path.basename(trial['folder'])}: MRR filtered {value:.6f}; "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"; allocator after the trial {allocated:.1f} MiB, peak {peak:.1f} MiB")
    log(f"  best trial {best} (search_completed names trial {done['best_trial']})")

    # (b) the tools on that folder
    start = time.perf_counter()
    rows = [r for r in dump_output(["trace", folder, "--search", "-k", "folder",
                                    "metric_value"]).splitlines()[1:] if r]
    check(len(rows) == 2, rows)
    for row in rows:
        path, value = row.split(",")[-2:]
        (trial,) = [t for t in trials if t["folder"] == path]
        check(float(value) == trial["metric_value"], (row, trial))
    best_folder = trials[best]["folder"]
    cli.main(["package", best_folder])
    package = os.path.join(best_folder, "model_best.pt")
    check(load_checkpoint(package)["type"] == "package")
    overview = yaml_load(dump_output(["checkpoint", package]))
    shapes = overview["parameter_shapes"]
    check(shapes == {"_entity_embedder._embeddings.weight": [NUM_ENTITIES, DIM],
                     "_relation_embedder._embeddings.weight": [FB15K237[1], DIM]}
          and overview["num_parameters"] == (NUM_ENTITIES + FB15K237[1]) * DIM,
          overview)
    test_batches = -(-NUM_TEST // BATCH)
    packaged, launches_package = test_metrics(best_folder, package)
    source, launches_source = test_metrics(
        best_folder, os.path.join(best_folder, "checkpoint_best.pt"))
    check(packaged == source, f"package {packaged} != checkpoint {source}")
    check(launches_package == launches_source == 2 * test_batches,
          (launches_package, launches_source))
    wall_b = time.perf_counter() - start
    log(f"  (b) dump trace --search: 2 rows, each the trial's validation; package "
        f"-> {os.path.relpath(package, WORK)} ({shapes}); test of the package and of "
        f"checkpoint_best.pt: {len(packaged)} metrics equal (MRR filtered "
        f"{packaged['mean_reciprocal_rank_filtered']:.6f}), K1 {launches_package} "
        f"launches each; wall {wall_b:.2f} s")
    return {"wall_s": wall_a, "tools_wall_s": wall_b, "launches": counts,
            "trials": splits, "allocated_mib": memory, "best_trial": best,
            "test_launches": launches_package, "metrics_equal": len(packaged)}


def yaml_load(text):
    import yaml

    return yaml.safe_load(text)


def run_search_workers(seed: int):
    """Phase 23 (c): an ax_search of 3 trials in two worker processes that
    share the card; returns a summary dict."""
    import yaml

    from kge_tpu_torch.job import Job
    from kge_tpu_torch.utils.io import load_checkpoint

    data = "small_data"  # phase 17's graph
    folder = os.path.join(WORK, "search_ax")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "search_ax.yaml")
    options = {
        "job": {"type": "search", "device": "cuda"},
        "dataset": {"name": data}, "model": "complex",
        "lookup_embedder": {"dim": 16},
        "train": {"type": "KvsAll", "batch_size": 256, "max_epochs": 2,
                  "optimizer": {"default": {"type": "Adagrad"}}},
        "valid": {"every": 2}, "eval": {"batch_size": 64},
        "random_seed": {"default": seed}, "console": {"quiet": True},
        "search": {"type": "ax_search", "num_workers": 2, "on_error": "abort"},
        "ax_search": {"num_trials": 3, "num_sobol_trials": 2, "parameters": [
            {"name": "train.optimizer.default.args.lr", "type": "range",
             "bounds": [0.01, 1.0], "log_scale": True},
            {"name": "lookup_embedder.dropout", "type": "choice",
             "values": [0.0, 0.2]}]},
    }
    with open(conf, "w") as f:
        yaml.safe_dump(options, f)
    from kge_tpu_torch import cli

    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder, "--search.device_pool",
              "cuda:0,cuda:0"])
    wall = time.perf_counter() - start
    locks = sorted(os.listdir(os.path.join(folder, ".device_locks")))
    claimed = []
    for name in locks:
        with open(os.path.join(folder, ".device_locks", name)) as f:
            claimed.append(f.read().split())
    workers = {pid for pid, _ in claimed}
    check([device for _, device in claimed] == ["cuda:0", "cuda:0"]
          and len(workers) == 2 and str(os.getpid()) not in workers, claimed)
    trials = search_trials(folder)
    check(len(trials) == 3, trials)
    ran = []
    for trial in trials:
        (line,) = trial_log_lines(trial["folder"], " runs on ")
        pid = line.split()[-1]
        check(" runs on cuda:0 in process " in line and pid in workers, line)
        check(0.0 < trial["metric_value"] <= 1.0, trial)
        ran.append(pid)
    check(set(ran) == workers, f"trials ran in {ran}, workers {workers}")
    checkpoint = load_checkpoint(os.path.join(folder, "checkpoint_00001.pt"))
    job = Job.create_from(checkpoint)
    before = [dict(p) for p in job.parameters]
    recorded = [{k: t[k] for k in p} for t, p in
                zip(sorted(trials, key=lambda t: t["folder"]), before)]
    check(len(before) == 3 and before == recorded, (before, recorded))
    result = job.run()
    check(job.parameters == before and len(search_trials(folder)) == 3,
          "the resumed search proposed or ran trials again")
    log(f"  (c) ax_search, 3 trials (2 Sobol, 1 model-based) in 2 worker processes "
        f"{sorted(workers)} on cuda:0 (this process {os.getpid()}): wall {wall:.2f} s; "
        f"trials ran in {ran}; resumed with the same 3 parameter sets, best "
        f"{result['metric_value']:.6f}")
    return {"wall_s": wall, "workers": len(workers), "parameters": before,
            "best": result["metric_value"]}


def run_search_grash(seed: int):
    """Phase 23 (d): GraSH over k-core subsets of a synthetic graph of 5,000
    entities and 50,000 training triples; returns a summary dict."""
    import tempfile

    import yaml

    from kge_tpu_torch import cli

    data = tempfile.mkdtemp(prefix="grash_", dir=os.path.join(WORK, "data"))
    write_dataset(data, seed, sizes=(5000, 50, 50000, 2000, 2000))
    folder = os.path.join(WORK, "search_grash")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "search_grash.yaml")
    write_train_config(conf, os.path.basename(data), seed, **{
        "job.type": "search", "search.type": "grash_search", "lookup_embedder.dim": 128,
        "train.batch_size": 4096, "train.max_epochs": 2,
        "grash_search": {"variant": "combined", "eta": 2, "num_trials": 4,
                         "seed": seed, "keep_pretrained": True, "parameters": [
                             {"name": "train.optimizer.default.args.lr",
                              "type": "range", "bounds": [0.01, 1.0],
                              "log_scale": True}]}})
    with open(conf) as f:
        check(yaml.safe_load(f)["job"]["device"] == "auto")
    start = time.perf_counter()
    reset_counters()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = read_counters()
    rounds = trial_log_lines(folder, "GraSH round ")
    check(len(rounds) == 2, rounds)
    subsets = [line.split("subset=")[-1] for line in rounds]
    check(any(s.endswith("-core") for s in subsets), subsets)
    trial_folders = sorted(f for f in os.listdir(folder) if f.startswith("round"))
    check(len(trial_folders) == 4 + 2, trial_folders)
    for name in trial_folders:
        (line,) = trial_log_lines(os.path.join(folder, name), " runs on ")
        check(" runs on cuda" in line, line)
    (done,) = trace_entries(folder, event="search_completed", scope="search")
    best = [t for t in trace_entries(folder, event="search_completed",
                                     scope="train", grash_round=1)
            if t["metric_value"] == done["metric_value"]]
    check(best, done)
    best = best[0]
    best_folder = os.path.join(folder, f"round1-trial{best['trial']:05d}")
    check(os.path.isfile(os.path.join(best_folder, "model_best.pt")), best_folder)
    check(counts["scatter_add_sorted"] > 0 and counts["rank_counts"] > 0, counts)
    log(f"  (d) GraSH (combined, eta 2, 4 trials, d=128) on 5,000 entities / 50,000 "
        f"triples: rounds on {[os.path.basename(s) for s in subsets]}; "
        f"{len(trial_folders)} trials on the card; best trial {best['trial']} "
        f"packaged ({done['metric_name']} {done['metric_value']:.6f}); launches "
        f"{counts}; wall {wall:.2f} s")
    shutil.rmtree(data)
    return {"wall_s": wall, "subsets": [os.path.basename(s) for s in subsets],
            "launches": counts, "best_trial": best["trial"]}


def run_search(seed: int, data: str):
    """Phase 23, run in ``WORK`` where ``data/`` names the datasets, as a
    user's working directory does: trial folders, checkpoints and packages
    name their dataset by the name its ``dataset.yaml`` gives it, and
    ``test`` and ``package`` find it by that name. Returns a summary
    dict."""
    names = os.path.join(WORK, "data")
    os.makedirs(names, exist_ok=True)
    for folder in (data, os.path.join(WORK, "small_data")):
        link = os.path.join(names, os.path.basename(folder))
        if not os.path.lexists(link):
            os.symlink(folder, link)
    cwd = os.getcwd()
    os.chdir(WORK)
    try:
        out = run_search_full_width(seed, os.path.basename(data))
        out["workers"] = run_search_workers(seed)
        out["grash"] = run_search_grash(seed)
    finally:
        os.chdir(cwd)
    return out


# -- kernel timings ---------------------------------------------------------------


def rotating(make, copies: int = 4):
    """A callable that runs ``fn`` on ``copies`` input sets in turn, so that
    consecutive calls do not find their inputs in the 50 MB L2 cache."""
    sets = [make() for _ in range(copies)]
    state = {"i": 0}

    def pick():
        state["i"] = (state["i"] + 1) % copies
        return sets[state["i"]]

    return pick


def time_rank(seed: int, device, first_batch):
    """Rank kernel per call: at the evaluation's first batch (q, targets,
    row_ptr, cols, true: the kernels line's shape), and on random inputs
    with one label a row at n = 1,024 and over 200,000 candidates. Beside
    the planned grid (one tile a block) the same call with one wave of
    blocks, which is what the plan was chosen against."""
    from kge_tpu_torch.ops.rank_kernel import (
        csr_row_ids,
        fused_rank_counts,
        fused_rank_counts_plain,
        rank_plan,
    )

    generator = torch.Generator(device=device).manual_seed(seed + 11)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cases = [("first test batch", first_batch)]
    for n, E in ((1024, NUM_ENTITIES), (BATCH, SPARSE_ENTITIES)):
        true = torch.randint(0, E, (n,), generator=generator, device=device,
                             dtype=torch.int32)
        cases.append(("random, one label a row", (
            torch.randn(n, DIM, generator=generator, device=device) * 0.05,
            torch.randn(E, DIM, generator=generator, device=device) * 0.05,
            torch.arange(n + 1, dtype=torch.int32, device=device), true, true)))
    out = []
    for name, (q, targets, row_ptr, cols, true) in cases:
        (n, D), E, nnz = q.shape, targets.shape[0], cols.numel()
        planned = rank_plan(n, E)
        one_wave = rank_plan(n, E, num_ranges=2 * sms // planned["row_tiles"])

        def kernel(plan=None):
            return fused_rank_counts(q, targets, None, row_ptr, cols, E, ATOL, RTOL,
                                     pivot_cols=true, plan=plan)

        before = fused_rank_counts.launches
        ms = time_ms(kernel)
        check(fused_rank_counts.launches > before)
        one_wave_ms = time_ms(lambda: kernel(one_wave))
        plain_ms = time_ms(lambda: fused_rank_counts_plain(
            q, targets, None, row_ptr, cols, E, ATOL, RTOL, pivot_cols=true))
        rows = csr_row_ids(row_ptr)

        def library():
            scores = torch.matmul(q, targets.T)
            pivot = scores.gather(1, true.long()[:, None])
            close = torch.isclose(scores, pivot, rtol=RTOL, atol=ATOL)
            greater = (scores > pivot) & ~close
            return greater.sum(1), close.sum(1), scores[rows, cols.long()]

        library_ms = time_ms(library)
        flops = 2.0 * n * E * D + 2.0 * n * D
        bound_ms, bound_by, _ = bound(
            4.0 * (n * D + E * D + (n + 1) + nnz + n + 3 * n + nnz), flops)
        rate = flops / (ms * 1e-3) / FP32_FLOPS_PER_S
        log(f"  rank_counts {name} n={n} |E|={E} D={D} nnz={nnz}: {ms:.4f} ms "
            f"({planned['row_tiles']} x {planned['num_ranges']} blocks of one tile, "
            f"{100 * rate:.1f}% of the fp32 rate; as one wave of "
            f"{one_wave['row_tiles']} x {one_wave['num_ranges']} blocks of "
            f"{one_wave['tiles_per_range']} tiles {one_wave_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library matmul + compares {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        out.append({"shape": name, "n": n, "num_candidates": E, "ms": ms,
                    "one_wave_ms": one_wave_ms, "share_of_fp32_rate": rate,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by})
    return out


def scatter_launch_times(pick, num_rows):
    """The scatter kernel's launches alone by CUDA events, on the rotating
    inputs ``pick`` gives: launch A (the sort, the segment marks and the
    bitmap of rows present) and launch B (the sums and the zeros) of the
    scatter-add, the segment sums whole, and their launch A."""
    from kge_tpu_torch.ops.embedding_ops import scatter_launch, sorted_segment_sums

    ids, upd = pick()
    buffers = scatter_launch(ids, None, upd, num_rows)
    by_segment = scatter_launch(ids, None, upd, num_rows, by_segment=True)
    return {
        "launch_a_ms": time_ms(lambda: scatter_launch(
            pick()[0], None, upd, num_rows, phases=1, buffers=buffers)),
        "launch_b_ms": time_ms(lambda: scatter_launch(
            ids, None, pick()[1], num_rows, phases=2, buffers=buffers)),
        "segment_sums_ms": time_ms(lambda: sorted_segment_sums(*pick(), num_rows)),
        "sort_alone_ms": time_ms(lambda: scatter_launch(
            pick()[0], None, upd, num_rows, by_segment=True, phases=1,
            buffers=by_segment)),
    }


def time_scatter(seed: int, device):
    """Scatter kernel per call at the three shapes of the dense step (the
    first is the kernels line's), at P-transe's d = 128 and at T-sparse's
    entity segment sum: the wrapper and its two launches alone, and the
    segment sums with their launch A alone."""
    from kge_tpu_torch.ops.embedding_ops import sorted_scatter_add, sorted_scatter_add_plain

    rng = np.random.default_rng(seed + 4)
    cases = [case + (DIM,) for case in scatter_cases(rng)[:3]] + [
        ("entity lookups, d = 128",
         power_law_ids(rng, NUM_ENTITIES, TRAIN_BATCH, 0.8), NUM_ENTITIES, TRANSE_DIM),
        ("row-sparse entity ids", rows_set_cases(rng)[0][2], SPARSE_ENTITIES, DIM),
    ]
    out = []
    for name, ids_np, num_rows, D in cases:
        n = len(ids_np)

        def make():
            return (torch.tensor(ids_np, dtype=torch.int64, device=device),
                    torch.randn(n, D, device=device))

        pick = rotating(make)
        ms = time_ms(lambda: sorted_scatter_add(*pick(), num_rows))
        plain_ms = time_ms(lambda: sorted_scatter_add_plain(*pick(), num_rows))
        launches = scatter_launch_times(pick, num_rows)

        def library():
            ids, upd = pick()
            return torch.zeros(num_rows, D, device=device).index_add_(0, ids, upd)

        library_ms = time_ms(library)
        # the unsorted int64 ids and the updates read once, the table written
        # once: the same work whatever sorts
        bound_ms, bound_by, _ = bound(4.0 * (n * D + num_rows * D) + 8.0 * n,
                                   float(n * D))
        log(f"  scatter_add_sorted {name} n={n} rows={num_rows} D={D}: {ms:.4f} ms "
            f"(launch A alone, the sort, {launches['launch_a_ms']:.4f} ms; launch B "
            f"alone, the sums and zeros, {launches['launch_b_ms']:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library index_add_ {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); segment sums "
            f"{launches['segment_sums_ms']:.4f} ms (their launch A "
            f"{launches['sort_alone_ms']:.4f} ms)")
        out.append({"shape": name, "n": n, "num_rows": num_rows, "dim": D, "ms": ms,
                    **launches, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by})
    return out


def time_rows_set(seed: int, device):
    """Row-write kernel per call at the two shapes of the row-sparse step."""
    from kge_tpu_torch.ops.embedding_ops import rows_set, rows_set_plain

    rng = np.random.default_rng(seed + 6)
    out = []
    for name, num_rows, ids_np in rows_set_cases(rng):
        m = len(ids_np)
        table = torch.zeros(num_rows, DIM, device=device)
        values = torch.randn(num_rows, DIM, device=device)

        def make():
            ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
            return ids, values[ids]

        pick = rotating(make)
        ms = time_ms(lambda: rows_set(table, *pick()))
        plain_ms = time_ms(lambda: rows_set_plain(table, *pick()))
        library_ms = time_ms(lambda: table.index_copy_(0, *pick()))
        nbytes = 4.0 * 2 * m * DIM + 8.0 * m
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  rows_set {name} m={m} into [{num_rows}, {DIM}]: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library index_copy_ {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms (bytes)")
        out.append({"shape": name, "m": m, "num_rows": num_rows, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes"})
    return out


@functools.lru_cache(maxsize=None)
def special_rate() -> float:
    """Square roots (sqrt, rsqrt) a second: 16 a clock on each of the
    card's SMs, at its maximum SM clock as nvidia-smi reports it."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = SPECIAL_PER_CLOCK_PER_SM * sms * mhz * 1e6
    log(f"  special-function rate {rate:.6g} square roots/s "
        f"({SPECIAL_PER_CLOCK_PER_SM} a clock x {sms} SMs x {mhz:g} MHz)")
    return rate


def bound(nbytes: float, flops: float, specials: float = 0.0):
    """(bound_ms, bound_by, term): the largest of bytes over the card's
    memory rate, fp32 operations over its fp32 rate and square roots over
    its special-function rate (``special_rate``); ``bound_by`` is "bytes"
    or "operations", ``term`` names which of the three binds."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "fp32": flops / FP32_FLOPS_PER_S,
             "special functions": specials / special_rate() if specials else 0.0}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def time_fused_update(seed: int, device):
    """Fused row update (Adam) per call at the two tables of a P-rotate
    step; the first is the kernels line's."""
    from kge_tpu_torch.ops.optim import (
        fused_sorted_update,
        fused_sorted_update_plain,
        fused_update_presummed,
        segment_sums,
    )

    rng = np.random.default_rng(seed + 9)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 9)
    out = []
    lr, step = ROTATE_LR, 3
    for name, rows, D, ids_np in fused_cases(rng):
        n = len(ids_np)
        ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
        upd = signed_updates(ids, D, generator)
        param, states = fused_state("adam", {}, rows, D, generator, device)
        ms = time_ms(lambda: fused_sorted_update(
            "adam", {}, ids, upd, param, states, lr, step), reps=10)
        segments_ms = time_ms(lambda: segment_sums(ids, upd, rows), reps=10)
        segments = segment_sums(ids, upd, rows)
        kernel_only_ms = time_ms(lambda: fused_update_presummed(
            "adam", {}, *segments, param, states, lr, step), reps=10)
        plain_ms = time_ms(lambda: fused_sorted_update_plain(
            "adam", {}, ids, upd, param, states, lr, step), reps=5)

        # library route: a dense gradient by index_add_, then torch's fused Adam
        weight = torch.nn.Parameter(param.clone())
        adam = torch.optim.Adam([weight], lr=lr, fused=True)

        def library():
            weight.grad = torch.zeros_like(weight).index_add_(0, ids, upd)
            adam.step()

        library_ms = time_ms(library, reps=10)
        del weight, adam
        # param and both moments read and written once, the row gradients
        # and their ids read once; a dozen operations per element
        nbytes = 4.0 * (2 * 3 * rows * D + n * D) + 8.0 * n
        bound_ms, bound_by, _ = bound(nbytes, 12.0 * rows * D)
        log(f"  fused_row_update (Adam) {name} [{rows}, {D}] n={n}: {ms:.4f} ms (the "
            f"wrapper: segment_sums, which is the scatter kernel's sort and sums, "
            f"{segments_ms:.4f} ms, and the kernel, alone {kernel_only_ms:.4f} ms), "
            f"plain {plain_ms:.4f} "
            f"ms, library index_add_ + torch.optim.Adam(fused=True) {library_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by})")
        out.append({"shape": name, "rows": rows, "D": D, "n": n, "ms": ms,
                    "segment_sums_ms": segments_ms,
                    "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by})
        del param, states, upd, segments
        torch.cuda.empty_cache()
    return out


def time_pooled(seed: int, device):
    """Pooled distance kernels per call, forward and backward, at P-rotate's
    shape (first: the kernels line's) and P-transe's two."""
    from kge_tpu_torch.ops.dist_pool import (
        pooled_dist_scores,
        pooled_dist_scores_plain,
    )

    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 10)
    forward, backward = [], []
    order = [POOLED_CASES[2], POOLED_CASES[0], POOLED_CASES[1]]
    for name, kind, n, K, F, d, _, _ in order:
        queries, pools, sel = pooled_inputs(kind, n, K, F, d, generator, device)
        g = torch.randn(n, K, generator=generator, device=device)
        leaves = [t.requires_grad_(True) for t in queries + pools]
        parts = len(queries)
        rows = torch.arange(K, device=device)[None, :] * F + sel.long()

        def run(fn):
            return fn(leaves[:parts], leaves[parts:], sel, F, kind)

        def library():
            # one library call that covers the function: all n x K F L1
            # distances, of which each row keeps its K
            return -torch.cdist(leaves[0], leaves[parts], p=1).gather(1, rows)

        elements = float(n) * K * d
        ops = 4.0 if kind == "l1" else 8.0
        # cmod: one sqrt per element forward, one rsqrt per element backward
        specials = elements if kind == "cmod" else 0.0
        read = 4.0 * (parts * (n * d + K * F * d) + n * K)
        times, split = {}, {}
        for what, fn in (("kernel", lambda: run(pooled_dist_scores)),
                         ("plain", lambda: run(pooled_dist_scores_plain)),
                         ("library", library if kind == "l1" else None)):
            if fn is None:
                times[what] = (None, None)
                continue
            with torch.no_grad():
                fwd_ms = time_ms(fn, reps=10)
            out = fn()

            def backward_of(out=out):
                return torch.autograd.grad(out, leaves, g, retain_graph=True)

            times[what] = (fwd_ms, time_ms(backward_of, reps=10))
            if what == "kernel":
                split = kernel_ms(backward_of, ("pooled_dq_kernel", "pooled_dpool_kernel"))
            del out
        fwd_bound = bound(read + 4.0 * n * K, ops * elements, specials)
        bwd_bound = bound(read + 4.0 * n * K + 4.0 * parts * (n * d + K * F * d),
                          2 * ops * elements, specials)
        library_name = "cdist(p=1) + gather" if kind == "l1" else "none for cmod"
        for label, index, (bound_ms, bound_by, term), sink, more in (
            ("pooled_scores", 0, fwd_bound, forward, {}),
            ("pooled_scores_bwd", 1, bwd_bound, backward,
             {"dq_ms": split["pooled_dq_kernel"],
              "dpool_ms": split["pooled_dpool_kernel"]}),
        ):
            lib_ms = times["library"][index]
            log(f"  {label} {name} ({kind}) n={n} K={K} F={F} d={d}: "
                f"{times['kernel'][index]:.4f} ms"
                + "".join(f", {k[:-3]} {v:.4f} ms (profiler)" if v else
                          f", {k[:-3]} not measured" for k, v in more.items())
                + f", plain {times['plain'][index]:.4f} ms, library ({library_name}) "
                f"{'null' if lib_ms is None else format(lib_ms, '.4f') + ' ms'}, "
                f"bound {bound_ms:.4f} ms ({bound_by}: {term})")
            sink.append({"shape": name, "kind": kind, "n": n, "K": K, "F": F, "d": d,
                         "ms": times["kernel"][index], **more,
                         "plain_ms": times["plain"][index], "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bound_term": term})
        del queries, pools, sel, g, leaves, rows
        torch.cuda.empty_cache()
    return forward, backward


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA card available")

    from kge_tpu_torch import cli
    from kge_tpu_torch.ops import kernel_utils
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()

    log("== phase 1: card and build")
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    start = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(kernel_utils.build, KERNELS))
    log(f"  built {len(KERNELS)} kernels side by side in "
        f"{time.perf_counter() - start:.2f} s")
    for name in KERNELS:
        kernel_utils.load_library(name)
        log(f"  csrc/{name}.cu: nvcc {kernel_utils.build_seconds[name]:.2f} s")
        for line in kernel_utils.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log("   " + line.strip())

    log("== phase 2: rank kernel vs plain version")
    max_err, excluded, rows = compare_kernel(args.seed, device)
    log(f"  {excluded} of {rows} rows excluded at tie boundaries")

    log("== phase 3: main path (reciprocal ComplEx d=512, FB15k-237 sizes)")
    data = os.path.join(WORK, "fb15k237_synthetic")
    write_dataset(data, args.seed)
    folder = os.path.join(WORK, "experiment")
    write_checkpoint(folder, data, args.seed, "auto", DIM, BATCH)
    fused_rank_counts.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    cli.main(["test", folder, "--eval.batch_size", str(BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = fused_rank_counts.launches
    entry = last_test_entry(folder)
    num_batches = -(-NUM_TEST // BATCH)
    check(launches == 2 * num_batches, (launches, num_batches))
    # the validation metric (filtered_with_test) is not computed on test
    metrics = {k: v for k, v in entry.items()
               if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
               and not k.endswith("_with_test")}
    check(metrics and all(np.isfinite(v) for v in metrics.values()), metrics)
    check(0.0 < entry["mean_reciprocal_rank_filtered"] <= 1.0)
    log(f"  test eval: {launches} kernel launches, wall {wall:.3f} s "
        f"({NUM_TEST / wall:.1f} filtered triples/s), "
        f"MRR filtered {entry['mean_reciprocal_rank_filtered']:.6f}, "
        f"Hits@10 filtered {entry['hits_at_10_filtered']:.6f}")

    # the same batches through the plain version
    job = test_job(folder)
    with torch.inference_mode():
        job._prepare()
        job._is_prepared = True
        start = time.perf_counter()
        job._evaluate()
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - start
        _, device_batches = job._collate_cache
        eval_ranks_agree(job)
        log(f"  second test eval (collated batches reused): wall {warm_wall:.3f} s "
            f"({NUM_TEST / warm_wall:.1f} filtered triples/s)")
        small_eval_agrees(args.seed)

        log("== phase 4: where the time goes, and kernel timings")
        profile = profile_run(job._evaluate, "warm eval")

        triples, labels = device_batches[0]
        _, q, targets, _ = job.model.factorized_queries(triples, (2,))[2]
        row_ptr, cols, _, _ = labels["o"]
        true = triples[:, 2].to(torch.int32).contiguous()
        rank_times = time_rank(args.seed, device, (
            q.contiguous(), targets.contiguous(), row_ptr, cols, true))
        log(f"  {card}")

    log("== phase 5: scatter and row-write kernels vs plain versions")
    scatter_err = compare_scatter(args.seed, device)
    rows_set_err = compare_rows_set(args.seed, device)

    log("== phase 6: T-dense (ComplEx d=512, shared negatives, FB15k-237 sizes)")
    dense = run_dense_training(args.seed, data)

    log(f"== phase 7: T-sparse (the same over {SPARSE_ENTITIES} entities)")
    sparse = run_sparse_training(args.seed)

    log("== phase 8: kernel timings at the training shapes")
    scatter_times = time_scatter(args.seed, device)
    rows_set_times = time_rows_set(args.seed, device)
    log(f"  {card}")

    log("== phase 9: fused row-update kernel vs plain version")
    fused_err = compare_fused_update(args.seed, device)

    log("== phase 10: pooled distance kernels vs plain version")
    pooled_err, pooled_grad_err = compare_pooled(args.seed, device)

    log("== phase 11: P-transe (TransE-L1 d=128, pooled negatives, FB15k-237 sizes)")
    transe = run_transe_training(args.seed, data)

    log(f"== phase 12: P-rotate (RotatE-L1 d={ROTATE_DIM}, Adam, {SPARSE_ENTITIES} "
        f"entities)")
    rotate = run_rotate_training(args.seed)

    log("== phase 13: kernel timings at P-rotate's shapes")
    fused_times = time_fused_update(args.seed, device)
    pooled_fwd_times, pooled_bwd_times = time_pooled(args.seed, device)
    log(f"  {card}")

    log("== phase 14: T-transe-l2 (TransE-L2 d=128, FB15k-237 sizes; validation "
        "and test through the L2 epilogue) and the test of a TransE-L1 folder")
    epilogue_err = compare_epilogue(args.seed, device)
    transe_l2 = run_transe_l2(args.seed, data, transe["folder"])
    epilogue_times = time_epilogue(args.seed, device)
    log(f"  {card}")

    log("== phase 15: O-complex (examples/fb15k-237-complex-1vsall.yaml: reciprocal "
        "ComplEx d=512, 1vsAll, FB15k-237 sizes)")
    ocomplex = run_ocomplex(args.seed, data)
    log(f"  {card}")

    log("== phase 16: K-complex (bench.py stage 6: ComplEx d=512, KvsAll sp_ and _po, "
        "FB15k-237 sizes)")
    kcomplex = run_kcomplex(args.seed, data)
    log(f"  {card}")

    log("== phase 17: DistMult, RESCAL, CP, SimplE, RelationalTucker3 (d=16): "
        "evaluation and a KvsAll step, card against CPU")
    family = run_factorization_family(args.seed)

    log("== phase 18: X-complex (bench.py stage 3: ComplEx d=512, 128 + 128 per-row "
        "negatives scored against all entities, FB15k-237 sizes)")
    start = time.perf_counter()
    xcomplex = run_xcomplex(args.seed, data)
    log(f"  phase 18 took {time.perf_counter() - start:.1f} s; {card}")

    log("== phase 19: per-row batch, host-drawn pool, fused step (T-dense's shape) "
        "and a subbatched KvsAll step")
    start = time.perf_counter()
    routes = run_other_routes(args.seed, data, kcomplex["folder"])
    log(f"  phase 19 took {time.perf_counter() - start:.1f} s; {card}")

    log("== phase 20: C-conve (reciprocal ConvE d=200, 32 filters of 3x3, KvsAll "
        "bce with label smoothing, Adam, FB15k-237 sizes)")
    start = time.perf_counter()
    conve = run_neural("conve", CONVE, CONVE_NO_DROPOUT,
                       {"scorer.conv_b": slice(None), "scorer.proj_b": slice(None)},
                       2, args.seed, data)
    log(f"  phase 20 took {time.perf_counter() - start:.1f} s; {card}")

    log("== phase 21: C-hitter (reciprocal Transformer d=320, 8 heads, 3 layers, "
        "1vsAll kl, Adam, FB15k-237 sizes)")
    start = time.perf_counter()
    hitter = run_neural("hitter", HITTER, HITTER_NO_DROPOUT,
                        {f"scorer.layers.{i}.in_proj_b": slice(320, 640)
                         for i in range(3)},
                        4, args.seed, data)
    log(f"  phase 21 took {time.perf_counter() - start:.1f} s; {card}")

    log("== phase 22: the dtype policy: the six kernels' bfloat16 paths; X-complex "
        "in bfloat16 compute from T-dense's entity table, P-rotate with both dtypes "
        "in bfloat16, T-sparse with bfloat16 tables")
    start = time.perf_counter()
    dtype = run_dtype_policy(args.seed, data, os.path.join(WORK, "train_dense"),
                             transe_l2["folder"])
    log(f"  phase 22 took {time.perf_counter() - start:.1f} s; {card}")
    bf16_cases = dtype["kernels"]

    log("== phase 23: hyperparameter search: a grid search at T-dense's width, dump, "
        "package and test of its best trial; ax_search in two worker processes; "
        "GraSH on k-core subsets")
    start = time.perf_counter()
    search = run_search(args.seed, data)
    log(f"  phase 23 took {time.perf_counter() - start:.1f} s; {card}")

    def entry(name, replaces, count, max_abs_err, times, source=None, **more):
        main_shape = times[0]
        return dict(
            name=name, route="cuda",
            source=f"kge_tpu_torch/csrc/{source or name}.cu",
            replaces=replaces, launches=count, max_abs_err=max_abs_err,
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"], **more)

    kernels = {"kernels": [
        entry("rank_counts", "kge_tpu/ops/rank_kernel.py:108", launches, max_err,
              rank_times, shapes=rank_times,
              epilogue={**epilogue_times, "name": "neg_sqrt_l2",
                        "max_abs_err": epilogue_err},
              launches_transe_l2=transe_l2["launches"]["rank_counts_epilogue"]
              + transe_l2["test_launches"]["rank_counts_epilogue"],
              launches_ocomplex=ocomplex["launches"]["rank_counts"]
              + ocomplex["resume_launches"]["rank_counts"]
              + ocomplex["test_launches"]["rank_counts"],
              launches_kcomplex=kcomplex["launches"]["rank_counts"]
              + kcomplex["resume_launches"]["rank_counts"],
              launches_xcomplex=xcomplex["launches"]["rank_counts"]
              + xcomplex["resume_launches"]["rank_counts"],
              launches_factorization={k: v["rank_launches"] for k, v in family.items()},
              launches_conve=neural_launches(conve, "rank_counts"),
              launches_hitter=neural_launches(hitter, "rank_counts"),
              launches_search=search["launches"]["rank_counts"]),
        entry("scatter_add_sorted", "kge_tpu/ops/pallas_ops.py:120",
              dense["launches"]["scatter_add_sorted"], scatter_err, scatter_times,
              shapes=scatter_times,
              **{k: scatter_times[0][k] for k in SCATTER_LAUNCH_KEYS},
              launches_sparse_epoch=sparse["launches"]["scatter_add_sorted"],
              launches_ocomplex_start=ocomplex["launches"]["scatter_add_sorted"],
              launches_kcomplex_start=kcomplex["launches"]["scatter_add_sorted"],
              launches_xcomplex_start=xcomplex["launches"]["scatter_add_sorted"],
              launches_phase19_start={
                  k: routes[k]["launches"]["scatter_add_sorted"]
                  for k in ("batch_per_row", "pool_host", "fused")},
              launches_conve=neural_launches(conve, "scatter_add_sorted"),
              launches_hitter=neural_launches(hitter, "scatter_add_sorted"),
              launches_search=search["launches"]["scatter_add_sorted"]),
        entry("rows_set", "kge_tpu/ops/pallas_ops.py:258",
              sparse["launches"]["rows_set"], rows_set_err, rows_set_times,
              shapes=rows_set_times),
        entry("fused_row_update", "kge_tpu/ops/pallas_ops.py:402",
              rotate["launches"]["fused_row_update"], fused_err, fused_times,
              shapes=fused_times),
        entry("pooled_scores", "kge_tpu/ops/dist_pool.py:279",
              rotate["launches"]["pooled_scores"], pooled_err, pooled_fwd_times,
              source="dist_pool", shapes=pooled_fwd_times,
              launches_transe_start=transe["launches"]["pooled_scores"]),
        entry("pooled_scores_bwd", "kge_tpu/ops/dist_pool.py:248",
              rotate["launches"]["pooled_scores_bwd"], pooled_grad_err,
              pooled_bwd_times, source="dist_pool", shapes=pooled_bwd_times,
              launches_transe_start=transe["launches"]["pooled_scores_bwd"]),
    ] + [
        # the bfloat16 paths: launches in phase 22's runs
        entry(f"{name}_bf16", replaces, launches_bf16,
              bf16_cases[name][0]["max_abs_err"], bf16_cases[name],
              source=source, shapes=bf16_cases[name], **more)
        for name, replaces, source, launches_bf16, more in (
            ("rank_counts", "kge_tpu/ops/rank_kernel.py:108", None,
             dtype["xcomplex"]["bf16_launches"]["rank_counts"],
             {"epilogue": {**bf16_cases["rank_counts"][1], "launches":
                           dtype["transe_l2_test"]["bf16_launches"]["rank_counts"]},
              "recount_share": bf16_cases["rank_counts"][0]["recount_share"],
              "gamma_check": dtype["gamma_check"]}),
            ("scatter_add_sorted", "kge_tpu/ops/pallas_ops.py:120", None,
             dtype["rotate"]["bf16_launches"]["scatter_add_sorted"],
             {"launches_sparse": dtype["sparse"]["bf16_launches"][
                 "scatter_add_sorted"],
              **{k: bf16_cases["scatter_add_sorted"][0][k]
                 for k in SCATTER_LAUNCH_KEYS}}),
            ("rows_set", "kge_tpu/ops/pallas_ops.py:258", None,
             dtype["sparse"]["bf16_launches"]["rows_set"], {}),
            ("fused_row_update", "kge_tpu/ops/pallas_ops.py:402", None,
             dtype["rotate"]["bf16_launches"]["fused_row_update"], {}),
            ("pooled_scores", "kge_tpu/ops/dist_pool.py:279", "dist_pool",
             dtype["rotate"]["bf16_launches"]["pooled_scores"], {}),
            ("pooled_scores_bwd", "kge_tpu/ops/dist_pool.py:248", "dist_pool",
             dtype["rotate"]["bf16_launches"]["pooled_scores_bwd"], {}),
        )
    ], "eval_wall_s": wall, "eval_warm_wall_s": warm_wall, "profile": profile,
        "filtered_triples_per_s": NUM_TEST / wall,
        "filtered_triples_per_s_warm": NUM_TEST / warm_wall,
        "train_dense": dense, "train_sparse": sparse,
        "train_transe": transe, "train_rotate": rotate,
        "train_transe_l2": transe_l2, "train_ocomplex": ocomplex,
        "train_kcomplex": kcomplex, "factorization": family,
        "train_xcomplex": xcomplex, "other_routes": routes,
        "train_conve": conve, "train_hitter": hitter,
        "dtype_policy": {k: v for k, v in dtype.items() if k != "kernels"},
        "search": search,
        "card": card}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

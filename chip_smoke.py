#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`avenir_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line per check; any failed check exits non-zero:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions, and
   the nvcc build of every kernel from `avenir_tpu_torch/ops/csrc/`.
   Fails on any spill: ptxas's spill bytes of every partial instance and
   the local bytes cudaFuncGetAttributes reports for each of the 32
   CUDA-core and 16 tensor-core (euclidean bfloat16) instances; prints
   the registers and blocks per SM of the K=8 CUDA-core instances and of
   every tensor-core one, and holds each instance's stage plan to the
   wrapper's. The diagnostic instance (clock64 sections) is only listed.
   The matmul ceiling's kernels: ptxas's spill bytes of each, and the
   registers, local bytes, shared bytes, threads and blocks per SM of its
   two wgmma instances (D <= 64 and D <= 128); fails on any spill or a
   tile that differs from the wrapper's plan. The eight merge instances
   (two kernels x four carry widths): ptxas's spill bytes, and the
   registers, local bytes and blocks per SM cudaFuncGetAttributes gives;
   fails on any spill. The merges' layout as the C side picks it
   (knn_merge_layout) against the design's rule and the CPU model's
   MERGE_OWN.
2. Kernels against their plain PyTorch versions on the card, at the
   e-learning workload's size (8192 queries x 131072 train rows, k=5),
   D in {6, 128}, both metrics, and for the vote C=2 with the kernels
   none and gaussian(30). Tolerances: manhattan exact rtol 1e-6;
   euclidean exact rtol 1e-4, atol 1e-5; lane-packed keys within one
   quantum 2^-(23-pack_bits) with neighbour-set recall >= 0.99; vote
   scores equal for the kernel none (neighbour counts) and within 2.0
   for gaussian, with arg-max agreement >= 0.99. Index mismatches
   are allowed only between tied distances. The euclidean pre-pass
   (`knn_prepass`, norms alone and with bfloat16 copies) bit-equal to its
   plain version, there and at ragged shapes up to MAX_D. The merge
   kernels (knn_topk.cu, knn_classify.cu on knn_merge.cuh) timed apart
   from the partial kernel on the job's split lists, bit-equal to the
   plain merge and vote, beside the launch floor (an empty kernel on the
   merges' grid). Times are
   CUDA-event medians; each row prints its share of its bound, its
   blocks per SM, grid and waves, and its launches. The pre-pass and the
   merges also get device-alone times: one CUDA-event pair around 200
   back-to-back launches through their C entries, over 200, and
   torch.profiler's mean device time of their kernel over 200 launches.
3. The main path: the `nearestNeighbor` job through `runner.run_job` on
   seeded e-learning CSVs (131072 train, 8192 test rows, 6 features), in
   its four modes (default exact top-k, nen.device.packed.kernel,
   nen.device.fused.vote, and nen.class.condtion.weighted, which weights
   each neighbour by its Naive Bayes feature posterior and runs the
   exact top-k with `_vote`); each must launch its kernel and score
   accuracy above 60, the packed and fused modes agree with the default
   on >= 99% of predictions, and the default and class-conditional runs'
   first 1024 lines must equal the job's on the CPU. Each mode's seconds
   are printed beside the card's name and power limit. First the ingest
   check of the train file (below); the jobs ask for the native CSV
   parser (`csv.engine=native`), so a failed build fails the run. Each
   run prints its host-clock split; the default mode runs again with the
   Python parser (its output byte-identical) and under torch.profiler
   (device busy share).

   The ingest check (phases 3 and 6, on their train files at full size):
   the file parsed by Dataset.from_csv with engine="python" and
   engine="native", every column byte-identical, rows/s of each and the
   native parser's threads. The host-clock split (phases 3, 6 and 8): for
   each job or pipeline stage, the seconds under each span it recorded
   (`stream.read`, `stream.parse`, `stream.fold`, `job.finish`), `other`
   (the seconds of `job.run` no span covers) and `job.run`, one JSON
   object a line, with the parsers that ran.
4. The kernel-check path: `avenir_tpu_torch.tools.kernel_check` on the
   card, every case against its float64 oracle; any failed case fails.
5. The packed kernel and every bfloat16 variant against their plain
   versions at 8192 x 131072, D in {6, 128}: packed manhattan bit-equal;
   packed euclidean within the exact tolerance plus one 2^-11 quantum;
   bfloat16 euclidean, which takes the tensor-core form of the partial
   kernel (one launch on `knn_partial_mma` per call), within each
   kernel's float32 tolerance plus the dot form's cancellation floor
   against the bfloat16 plain version (index mismatches only between
   ties): its products are exact and only its fp32 accumulation order
   differs; bfloat16 manhattan bit-equal to float32. The tensor-core
   form's clock64 section shares at D=128 and D=6, its merge kernels on
   the bench's lists (with device-alone times and the launch floor, as
   in phase 2), and every carry width and mode at ragged shapes, D
   1..MAX_D. The merge kernels alone on ragged split lists (splits 1 to
   65, every carry width, empty queries, ties, sign bits, keys at
   SENTINEL and INF_BITS; votes scoring NaN: gaussian at kernel_param 0
   on zero distances, sign-bit NaN keys under every kernel function and
   both metrics), bit-equal to merge_splits_plain and _vote (NaN where it
   has NaN) and on a rerun; NaN under every kernel function but none on
   the NaN keys. The partial kernel and its merge on NaN and sign-bit
   NaN features, every mode, metric and form at D 6 and 128, against the
   plain version: NaN distances first in column order in exact mode
   (NAN_KEY, finished NaN with the index kept), an empty slot in the
   others, the vote all zeros on NaN queries, as the JAX kernels give.
   Then
   `avenir_tpu_torch.tools.knn_sweep` at its full width (8192 x 131072,
   D=128).

6. The Naive Bayes path: the ingest check of the churn train file, then
   `bayesianDistr` through `runner.run_job` on that seeded CSV of
   1,000,000 rows streamed in 4 MB blocks, with the native parser and
   with the Python parser; the model file and its stamp must be
   byte-identical to the same job's run with device="cpu". Then `bayesianPredictor` on a 100,000-row churn test
   CSV with validation and cost arbitration: accuracy above 70, the
   predicted class equal to the CPU run's on every row, the appended
   percent within 1 of it (float sums run in another order on the card).
   NB has no TPU kernel: this path launches none.
7. The bench path: `matmul_ceiling` (a cast pass, then wgmma fed by TMA)
   against its plain version at 8192 x 131072 x 128, each row within
   2^-16 sum_j |q̂_i . t̂_j| of the plain row (fp32 accumulation in another
   order), and bit-equal across two runs; its time, bound, plain and
   library (cuBLAS bf16 GEMM) times. The same at every legal D (16..128)
   at 384 x 4736, where the last 256-query tile is half filled. Then
   `avenir_tpu_torch.tools.bench` at full size, its JSON line printed on a
   line of its own; the ceiling kernel and the two lane kernels must launch
   there, and every KNN launch of it (all euclidean bfloat16) on the
   tensor-core form.

8. The pipeline path: `pipelines.knn_pipeline` (recordSimilarity,
   bayesianDistr, bayesianPredictor's feature posteriors,
   featureCondProbJoiner, class-conditional nearestNeighbor) on seeded
   e-learning CSVs at 8192 train x 512 test rows (the distance file has a
   line per pair: 4,194,304), each stage timed through
   `Pipeline.run(only=)` with the native parser where auto takes it,
   again with the Python parser, then on the CPU: 4,194,304 pairs and
   joins, accuracy above 60, `knn_topk` launched, and all five files of
   both card runs byte-identical to the CPU run's; each run's host-clock
   split by stage.
9. The profile path (after phase 8): `pipelines.profile_pipeline`
   (bayesianDistr, mutualInformation with all five score algorithms,
   fisherDiscriminant) on phase 6's churn train file (1,000,000 rows, the
   same generator and seed, 4 MB blocks), on the card plain and with
   `run(fuse=True)` (one `run_shared` scan), and its CPU twin fused: every
   file and stamp byte-identical across the three runs, the fused runs
   reading each block once and the plain run three times (counted at the
   stream layer's `_produce_hook`). Each run's seconds (ended by
   torch.cuda.synchronize()) and its split by span: `stream.read`,
   `stream.parse`, `stream.fold` per sink, `job.finish`, `other`; the
   fused card run again under torch.profiler (device busy share). Then
   `cramerCorrelation` and `heterogeneityReduction` on the same churn
   file and `numericalCorrelation` on phase 3's e-learning train file,
   each byte-identical to its CPU twin; and `bayesianDistr` on a seeded
   5-class corpus of 1,000,000 rows with one categorical field and 1,
   then 2, continuous fields uniform in [0, 120): model and stamp
   byte-identical to the CPU twin's (the moments sum in a fixed order of
   elementwise adds, not in atomics' order); the same with 20 classes
   and one continuous field (its moments in 1638-row blocks, each summed
   in row order). The path launches no kernel of the port's own.
10. The tree and text path (after phase 9): the root bench's call-hangup
   corpus (100,000 rows of seed 5) written ten times over, 1,000,000
   rows. `pipelines.decision_tree_pipeline` with decTree (entropy, depth
   4) and with the forest (5 trees, withReplace, depth 4), then
   `dataPartitioner` and `classPartitionGenerator`, each on the card and
   on the CPU: decPathOut.txt, every tree-NNN.json and every
   segment=j/data byte-identical to the CPU twin's, the split stats
   within 1e-6 of the twin's with the same best split, and the forest's
   level histogram called once a level for all its trees (counted at
   `tree._level_histogram_forest`). `RandomForestBuilder.predict` with
   device=True equal to device=False on all 1,000,000 rows. The forest
   job and its device predict again under torch.profiler: the device
   busy share and the level histogram's and path match's device time.
   Then `wordCounter` and text-mode `bayesianDistr` on a seeded corpus
   of 200,000 lines (8-20 tokens from 5,000 words and stop words, 4
   classes), byte-identical to the CPU twin's. Each run's seconds and
   its split by span. The path launches no kernel of the port's own:
   its device work is torch ops.
11. The association path (after phase 10): the bench's market baskets
   (100 items with Zipf popularity, 8 picks a row, seed 4) at 1,000,000
   transactions written as `T<id>,i<j>,...`, support 0.02, length 3.
   `pipelines.association_pipeline` (frequentItemsApriori in RAM, then
   associationRuleMiner at confidence 0.5) on the card and on the CPU;
   frequentItemsApriori streamed in 4 MB blocks on the card, and on the
   first 100,000 rows on the card and the CPU; on those rows
   infrequentItemMarker with their k=1 file, then Apriori with the
   marker (streamed, on the card), and `run_shared([frequentItemsApriori])`
   on the card; `fia.emit.trans.id` on the first 50,000 rows in both
   routes on the card and the CPU.
   Every itemsets-k.txt byte-identical across routes and devices (the
   marked run's to the unmarked one's), rules.txt to the twin's. The
   card's in-RAM and streamed runs under torch.profiler: seconds by
   span, device busy share, each round's support count
   (`association::support_count`) in device seconds beside its
   candidates and their padded count c_pad; the two forms of the
   bit-packed overlap (unpacked bits through one matmul, and the
   word-by-word popcount) equal and timed on a block of 8192 rows
   against round 2's candidates; the bench's Apriori section at its
   500,000 transactions. The path launches no kernel of the port's own.
12. The sequence path (after phase 11): 1,000,000 sequences written as
   `s<i>,e<j>,...` (Poisson(10) tokens, clipped to [2, 40], from 100
   tokens with Zipf popularity, seed 21), support 0.02, length 3.
   `candidateGenerationWithSelfJoin` in RAM and streamed in 4 MB blocks on
   the card, under torch.profiler (seconds by span, device busy share,
   each round's kernel seconds, the `subseq_support` kernels that start
   inside its `sequence::support_count` range, beside its candidates and
   c_pad): sequences-k.txt byte-identical, the
   kernel `subseq_support` launched (the registers of its four kernels,
   no local bytes in any). The first 20,000 sequences on the card and the
   CPU: byte-identical. The kernel against its plain version on the
   first streamed block (65,536 rows) with round 2's and round 3's
   candidates, the real ones as the streamed round folds them (not the
   pad rows up to c_pad), on both routes: the mask route at the round's
   code range, and the walk route (the kernel before the mask route, as
   it was) forced by a code range past the tables' room; equal counts,
   CUDA-event times in turns (walk, mask, mask, walk), the mask route's
   bound from the lookups its test makes (`lookup_steps`) and the walk
   route's from the compares its walks make (`walk_steps`: a walk stops
   at k), each share. Both routes against the plain version on seeded
   edge cases (SUBSEQ_EDGE_WIDTHS: both mask forms and the walk by
   width; repeated codes and tokens, the top code of the range, lengths
   past the code width, 0 and -1). Then `sequencePositionalCluster` and
   `sequenceGenerator` on 100,000 seeded event rows against their CPU
   twins.
13. The bandits (after phase 12): 100,000 groups x 10 arms of seeded
   stats, the four jobs (greedyRandomBandit logLinear, auerDeterministic,
   randomFirstGreedyBandit, softMaxBandit; batch 3) through
   `pipelines.bandit_round` at rounds 1, 2 and 10 on the card and the
   CPU: every group's selection identical but where a decision within 2
   float32 ULP hangs on a float32 log
   (`tools.bandit_check.near_tie_groups`), the differing and near-tie
   counts printed; then the bench's bandit section
   at 1,000,000 groups. The bandits launch no kernel of the port's own.
14. The Markov path (after phase 13): 1,000,000 rows of the churn
   tutorial's two 5-state chains (`cust<i>,<C|L>,state,...`, 6-13 states,
   ids of 10,000 customers, seed 21). `markovStateTransitionModel` per
   class streamed in 4 MB blocks on the native parser under
   torch.profiler (split, busy share, the `markov::bigram_count` calls and
   device seconds, their bound: the int64 keys read once at 3.35 TB/s),
   and on the CPU; fused with `candidateGenerationWithSelfJoin` (length
   2) through `run_shared` (the blocks read against the solo runs'); per
   entity (10,000 keys) on both devices; `markovModelClassifier` in
   validation mode (accuracy above 85) and on the first 20,000 rows on
   both devices; `hiddenMarkovModelBuilder` on 1,000,000 `obs:state` rows
   of the loyalty HMM on both devices, then `viterbiStatePredictor` on
   1,000,000 observation rows (Poisson(10) lengths clipped to [1, 40])
   under torch.profiler (`markov::viterbi` calls, device seconds and
   bound: an add and a compare a step and state pair at the fp32 rate,
   or the bytes), the share of hidden states recovered (above the
   tutorial's 0.45), and on the first 20,000 rows on both devices; a
   uniform-transition HMM's paths on both devices; then
   `probabilisticSuffixTree`, `stateTransitionRate`,
   `eventTimeDistribution` and `contTimeStateTransitionStats` (on the
   card run's per-entity rates) on 100,000 rows against their CPU twins.
   Every file byte-identical to its twin's. The path's two device
   programs are torch ops, not kernels: they print on a line of their
   own, not in the kernels line.
15. The stream path (after phase 14), the bench's stream legs on the
   card (`tools/bench.py`), with the host's torch threads and the native
   parser's threads printed first. The running merge of the KNN leg
   over its first STREAM_CHECK_BLOCKS = 8 rotated blocks against
   `knn_topk_plain` (bfloat16, exact keys) over those blocks
   concatenated (the lane plain version takes at most 524,288 rows), by
   `knn_tolerance.lanes_agree` (bf16_agrees' lane rule: distances within
   rtol 1e-4 plus the lane quantum, indices apart only at ties, recall
   >= 0.99). The NB generated leg at 1,000,000,000 rows (the class counts
   exactly). Then the KNN legs, their launches counted from zero: the
   generated leg at 1,000,341,504 train rows (1908 blocks, each one
   `knn_topk_lanes` launch on the tensor-core form, every final index in
   range) and the CSV leg at STREAM_KNN_CSV_ROWS = 500,000 rows (about
   480 MB; cut from the root bench's 2,000,000), its top-k within the
   same rule of `blocked_topk_neighbors` in float32 over the whole
   parsed corpus, the floor raised by the bfloat16 operands' rounding.
   The NB CSV leg at STREAM_NB_CSV_ROWS = 20,000,000 rows (about 760 MB
   in 4 MB blocks; cut from the root bench's 100,000,000): its model
   and stamp byte-identical to `bayesianDistr` through `run_job` on the
   same file at stream.prefetch.depth=1, its peak RSS over its start
   under 1 GB. Each leg's rows/s, overlap efficiency and stall seconds.
   The depth bar: the streamed jobs of phases 6, 9, 11, 12 and 14
   (bayesianDistr, the fused profile run, the per-class Markov model,
   streamed Apriori and streamed GSP) on their corpora, written again
   as those phases write them, at stream.prefetch.depth 2, 1 and 8, every
   file of depths 1 and 8 byte-identical to depth 2's. Then the measured
   anchor and vs_baseline (the bench's NB and d=8 KNN sections again).
16. The last ten jobs (after phase 15), each on the card and against its
   CPU twin, every file byte-identical but LR's coeff.txt (every printed
   cell within LR_CARD_ATOL of the twin's): ruleEvaluator,
   categoricalClassAffinity and categoricalContinuousEncoding
   (supervisedRatio, weightOfEvidence) on 1,000,000 churn rows streamed
   in 4 MB blocks; underSamplingBalancer and baggingSampler on 200,000;
   reliefFeatureRelevance on 1,000,000 e-learning rows with sample.size
   20,000; topMatchesByClass on 200,000 e-learning rows on the card (its
   EXACT top-k launches counted from zero, and the kernel against
   `knn_topk_plain` on one of its query blocks) and on their first
   20,000 on both devices; logisticRegression on 1,000,000 rows
   (iteration.limit 10, and allBelowThreshold) under torch.profiler
   (`regress::lr_grad`); clusterTrain k-means (k=3, 100 iterations) on
   1,000,000 rows under torch.profiler (`cluster::kmeans_step`, its
   `centre_sums` launches counted from zero) and DBSCAN on 5,000;
   agglomerativeGraphical on the recordSimilarity file of 200 e-learning
   rows. Each job's seconds, and the two device ranges' device seconds
   beside their bounds and share of their job (k-means' also its range's
   host seconds and its fold's host share); then `centre_sums` against
   its plain version and `index_add_` at the k-means job's shape (in
   turns: index_add_, kernel, kernel, index_add_), beside the chain floor
   (the largest cluster's rows times a dependent FADD's latency, timed
   on the card), and against its plain version bit for bit at the edge
   shapes CENTRE_EDGE_SHAPES (two column planes, one cluster, empty
   clusters, rows off the partition's tiles, one row, labels outside
   [0, k), -0 rows).
17. The score plane (after phase 16): the models of phases 6, 9, 14 and
   13 retrained at their sizes on the card (NB and Fisher on 1,000,000
   churn rows, the per-class Markov model on 1,000,000 chain rows; the
   stats of 100,000 groups x 10 arms), and an NB model with three
   continuous fields (5 classes, 100,000 rows), each family served by a
   `ScorePlane` on the card at the default window (2 ms) and batch (64)
   to SCORE_THREADS = 64 client threads: 4,096 of phase 6's test rows to
   NB (cost arbitration 2,1) and to Fisher, 1,024 rows to the NB model
   with continuous fields, 4,096 fresh chain rows to the Markov
   classifier, 128 groups to the bandit (phase 13's logLinear
   greedyRandomBandit at round 10, batch 3). Every answer equal to that
   row's line in the card's batch job output (bayesianPredictor,
   markovModelClassifier, the Fisher side, the bandit job's select at
   the same round); 64 rows of each family but the bandit scored solo
   through `score_once` on the card equal to their coalesced answers;
   the bandit's pulls and all its groups against the CPU twin's select
   by `bandit_check`'s rule; a burst of 48 reward appends over 32 nonces
   from 8 threads applying each nonce once, the next window of 64 pulls
   reloading the model once, some of them moved, its first equal to a
   cold `score_once` (the bandit's solo check: each cold load parses its
   1,000,000 stats rows for seconds); each plane, closed, joining its
   thread; no kernel of the port's own launched. Printed a family:
   requests, windows, mean rows a window, p50 and p99 of queue, predict
   and total ms, model loads, cache hits, seconds, and a slice served
   again under torch.profiler (every thread's ranges) with the device
   ms of its `score::<kind>` ranges; then the host-clock ms of a warm
   window split into the artifact digest of the cache key, the host
   parse, the model call (the device predict with its read-back; the
   bandit's select) and the output lines (the bandit's of every group,
   its window the plane's predict p50).

18. The library modules no job calls (after phase 17), on the card: an
   rbf `SVMClassifier` (gamma 2, C 10, 200 epochs) on make_moons(32768)
   (a [32768, 32768] float32 Gram matrix, 4 GiB), `kfold_validate` with
   5 folds and a `BaggedSVM` of 10 estimators with use_oob at the same
   rows; `BasicNeuralNetwork` (hidden 16, 1,000 iterations) in batch mode
   on 100,000 moons rows and in minibatch mode (batch 32); and
   `MetropolisSampler` (a 200-bin two-Gaussian target) drawing 1,000,000
   samples at skip 2, plain and with the mixture proposal: one
   `metropolis_walk` launch a sample call and no other kernel. Then the
   SVM trainer alone on the fit's Gram matrix beside its bytes bound (417
   reads of the matrix at 3.35 TB/s); fit, kfold and bagging at 4,096
   rows against their CPU twins (dual coefficients within 1e-5 of the
   largest, predictions equal but where the twin's |decision| is under
   1e-4); both net modes at 10,000 rows from one initial net against
   their twins (parameters within 1e-5; the card's initial normals
   within 4 ULP of the CPU's); for each sampler mode its sample call
   again (bit-equal), the whole walk's CUDA-event ms, ns a step and chain
   floor (the steps times one step's dependent chain, timed with
   clock64()), the kernel against its plain version bit for bit on the
   first 200,000 steps of the card's draws, the sampler against its CPU
   twin over those steps by `tools.sampling_check.walk_divergence`, and
   Geweke and Raftery-Lewis on the card's samples.

19. A HOCON job file (after phase 18): the supplier-fulfillment
   tutorial's `sup.conf`, one block a job, drives `stateTransitionRate` on
   1,000,000 event rows (1,000 products x 1,000 weeks, the tutorial's
   two reliability profiles) and `contTimeStateTransitionStats` on the
   1,000 products through `runner.run_job` with device="cuda"; both files
   byte-identical to the CPU twin's (the same conf text, its rates path
   its own). Both jobs are host float64: no kernel launches.
20. `parallel/` on the card: a NCCL process group of world size 1 in this
   process (`multihost.initialize` at a free localhost port), its data
   mesh, and the eight families on cuda tensors (1,000,000 rows; KNN at
   1024 x 131072 x 6, k=5; bandits at 100,000 groups x 10 arms), each
   equal to the port's single-device core (LR's step within 1e-7), with
   its CUDA-event ms and its all_reduce's ms alone; then
   `DecisionTreeBuilder.fit(mesh=)` (the e-learning features split every
   10, depth 3) and `LogisticRegression.fit(mesh=)` (10 iterations) on
   1,000,000 e-learning rows against fit() on the card: the same decision
   paths, coefficients within 1e-7. NCCL puts no two ranks on one GPU,
   so the multi-rank equality lives in the CPU tests' gloo world
   (`tests/test_torch_parallel.py`). A failed NCCL start fails the run:
   nothing falls back to gloo or the CPU.

Phases 4 and 5's sweep are the second path, phase 7's bench the third and
phase 8's pipeline the fourth, phase 12's GSP runs the fifth, phase 15's
KNN stream legs the sixth, phase 16's topMatchesByClass the seventh and
its k-means the eighth, phase 18's library modules the ninth, phase
19's conf jobs the tenth and phase 20's mesh the eleventh (no kernel on
either): each kernel's launches are counted from zero on each path. Then one JSON
line of per-kernel numbers (the pre-pass beside the five kernels, at the
sweep's D=128 float32; the tensor-core form at the bench's D=128
bfloat16; the two merge kernels at the job's shape; the walk at the
first 200,000 steps of phase 18's plain chain), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
before them the script's total seconds.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NQ, NT, K = 8192, 131072, 5
CHECK_ROWS = 1024
DEVICE = "cuda"

#: fp32 CUDA-core peak (FLOP/s, an FMA counted as 2), memory rate
#: (bytes/s) and dense bf16 tensor-core peak (FLOP/s) at the full power
#: limit, from NVIDIA's H100 data sheet
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12, 756e12),
         ("H100 NVL", 60.0e12, 3.9e12, 835e12),
         ("H100", 66.9e12, 3.35e12, 989e12))
CHECK_PATH = "kernel_check+knn_sweep"
BENCH_PATH = "bench"
#: phase 6: churn rows trained on and scored
NB_TRAIN_ROWS, NB_TEST_ROWS = 1_000_000, 100_000
#: phase 7: the bench's ceiling shape (bench.py:792-795)
CEIL_NQ, CEIL_NT, CEIL_D = 8192, 131072, 128
#: phase 8: the knn pipeline's train and test rows at the e-learning
#: width; its distance file has a line per pair
PIPE_NT, PIPE_NQ = 8192, 512
PIPE_PATH = "knn_pipeline"
PIPE_FILES = ("simi.txt", "distr.csv", "condProb.txt", "join.txt",
              "knn_out.txt")
#: phase 9: the profile pipeline's files, and the multi-class NB corpus
PROFILE_FILES = ("distr.csv", "distr.csv.stamp.json", "mi.txt",
                 "fisher.txt", "fisher.txt.stamp.json")
MI_ALGOS = ("mutual.info.maximization,mutual.info.selection,"
            "joint.mutual.info,double.input.symmetric.relevance,"
            "min.redundancy.max.relevance")
#: (classes, continuous fields) of the multi-class NB twins: 5 classes
#: take the 4096-row device lanes, 2 classes and one field the rows in
#: order on the host, 20 classes the 1638-row device blocks summed in
#: row order
MOMENT_ROWS = 1_000_000
MOMENT_SHAPES = ((5, 1), (5, 2), (2, 1), (20, 1))
#: phase 10: the call-hangup corpus of the root bench's forest
#: (bench.py:630, 100,000 rows of seed 5) written ten times over, the
#: forest's shape (bench.py:132-134), and the text corpus
TREE_BASE_ROWS, TREE_COPIES = 100_000, 10
RF_TREES, RF_DEPTH = 5, 4
TEXT_LINES, TEXT_VOCAB, TEXT_CLASSES = 200_000, 5_000, 4
#: phase 11: the market baskets, the prefixes the CPU twin streams and the
#: transaction-id runs read, and the miner's settings
ASSOC_TX, ASSOC_TWIN_TX, ASSOC_TIDS_TX = 1_000_000, 100_000, 50_000
ASSOC_PROPS = {"fia.support.threshold": "0.02", "fia.item.set.length": "3",
               "arm.conf.threshold": "0.5"}
ASSOC_BLOCK = {"fia.stream.block.size.mb": "4"}
#: phase 12: the GSP corpus (Poisson(10) tokens a sequence, clipped to
#: [2, 40], from GSP_VOCAB tokens of Zipf popularity), the prefix the CPU
#: twin mines, the miner's settings, the event rows of the other two jobs
GSP_ROWS, GSP_TWIN_ROWS, GSP_VOCAB, GSP_SEED = 1_000_000, 20_000, 100, 21
GSP_PROPS = {"cgs.support.threshold": "0.02", "cgs.item.set.length": "3"}
GSP_BLOCK = {"cgs.stream.block.size.mb": "4"}
SEQ_EVENTS = 100_000
#: the row widths of the subsequence count's edge cases: uint32 masks
#: (16, 32), uint64 masks (48, 64), the walk (80); and a code range no
#: table takes, which forces the walk route
SUBSEQ_EDGE_WIDTHS = (16, 32, 48, 64, 80)
SUBSEQ_WALK_CODES = 1 << 20
SEQ_PATH = "candidateGenerationWithSelfJoin"
#: phase 13: the bandit stats, the rounds, each job's keys (batch 3)
BANDIT_GROUPS, BANDIT_ARMS, BANDIT_SEED = 100_000, 10, 31
BANDIT_ROUNDS = (1, 2, 10)
BANDIT_JOBS = {
    "greedyRandomBandit": {"random.selection.prob": "0.5",
                           "prob.reduction.algorithm": "logLinear",
                           "prob.reduction.constant": "2.0"},
    "auerDeterministic": {},
    "randomFirstGreedyBandit": {},
    "softMaxBandit": {"temp.constant": "20.0"}}
#: phase 14: the churn tutorial's chains (MARKOV_ROWS rows of
#: MARKOV_ENTITIES customers), the loyalty HMM's rows, the prefixes the
#: CPU twins take, the host jobs' rows and entity keys
MARKOV_ROWS, MARKOV_ENTITIES, MARKOV_SEED, HMM_SEED = 1_000_000, 10_000, 21, 31
MARKOV_TWIN_ROWS, MARKOV_HOST_ROWS, MARKOV_HOST_KEYS = 20_000, 100_000, 1_000
MARKOV_PATH = "markovStateTransitionModel"
#: phase 15: the KNN stream legs' path, the CSV legs' rows (cut from the
#: root bench's 100,000,000 and 2,000,000), the blocks of the merge check
STREAM_PATH = "knn_stream"
STREAM_NB_CSV_ROWS, STREAM_KNN_CSV_ROWS = 20_000_000, 500_000
STREAM_CHECK_BLOCKS = 8
#: phase 16: the paths of the EXACT top-k and centre-sum launches, the
#: rows of its jobs, and how far a printed LR coefficient of the card may
#: lie from its CPU twin's (one unit of the sixth decimal)
TMC_PATH, KMEANS_PATH = "topMatchesByClass", "clusterTrain"
LAST_ROWS, LAST_SAMPLER_ROWS, LAST_TMC_ROWS, LAST_TWIN_ROWS = (
    1_000_000, 200_000, 200_000, 20_000)
LAST_DBSCAN_ROWS, LAST_AGG_ROWS, LAST_SEED = 5_000, 200, 41
LR_CARD_ATOL = 1e-6
#: centre_sums' edge shapes (n, d, k, labels): "mixed" in [-1, k] with a
#: -0 first row, "one" every row in cluster 0, "sparse" every fifth
#: cluster holds rows
CENTRE_EDGE_SHAPES = ((0, 4, 2, "mixed"), (1, 1, 1, "one"),
                      (1, 6, 3, "one"), (1, 6, 3, "mixed"),
                      (1500, 33, 3, "mixed"), (900, 64, 5, "mixed"),
                      (6000, 6, 1, "one"), (3000, 5, 64, "sparse"),
                      (4097, 6, 3, "mixed"), (8193, 6, 3, "one"),
                      (200_000, 6, 1, "one"), (50_000, 40, 7, "mixed"),
                      (3000, 3, 1000, "mixed"))
#: phase 17: the score plane's client threads, the rows each family is
#: sent (fewer for the bandit, whose every window selects over and formats
#: all BANDIT_GROUPS groups), the solo sample of NB, Fisher and Markov
#: (the bandit's is the pull after the reward burst: each cold load of its
#: 1,000,000 stats rows takes seconds), the slice served again under
#: torch.profiler, and the reward burst: appends from 8 threads over fewer
#: distinct nonces
SCORE_THREADS, SCORE_ROWS, SCORE_BANDIT_ROWS = 64, 4096, 128
SCORE_SOLO, SCORE_PROFILED, SCORE_BANDIT_PROFILED = 64, 1024, 32
SCORE_BURST, SCORE_BURST_NONCES, SCORE_SEED = 48, 32, 61
#: and an NB model with three continuous fields (phase 9's multi-class
#: corpus shape, 5 classes), whose log densities sum over the fields: its
#: train rows and the rows it is sent
SCORE_CONT_TRAIN, SCORE_CONT_ROWS = 100_000, 1024
#: the bandit served: phase 13's greedyRandomBandit at round 10, batch 3
SCORE_BANDIT_CONF = {"algorithm": "greedyRandomBandit", "batch.size": "3",
                     "round": "10", "random.selection.prob": "0.5",
                     "prob.reduction.algorithm": "logLinear",
                     "prob.reduction.constant": "2.0"}
#: phase 18: the SVM's moons rows on the card and those its CPU twin
#: checks, its epochs, folds and estimators; the net's rows on the card
#: and those its twin checks, its iterations; the sampler's samples and
#: skip, the walk's prefix held against its plain version and the twin;
#: the tolerances of tests/test_torch_svm_neural.py
LIB_SVM_ROWS, LIB_SVM_TWIN_ROWS, LIB_SVM_EPOCHS = 32_768, 4_096, 200
LIB_FOLDS, LIB_ESTIMATORS = 5, 10
LIB_NN_ROWS, LIB_NN_TWIN_ROWS, LIB_NN_ITERS = 100_000, 10_000, 1_000
LIB_SAMPLES, LIB_SKIP, LIB_WALK_CHECK = 1_000_000, 2, 200_000
SVM_COEF_RTOL, SVM_MARGIN, NN_ATOL = 1e-5, 1e-4, 1e-5
LIB_PATH = "MetropolisSampler"
#: nvidia-smi's name and power limit of the card (phase 1)
CARD = ""


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


def peaks(name: str):
    for key, *rates in PEAKS:
        if key in name:
            return rates
    fail(f"no peak rates known for {name!r}")


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _timed_once(fn):
    """(fn(), CUDA-event ms of that one call): the plain versions take
    0.1-1.7 s at full size, so each is timed on the call compared."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_alone(launch, kernel: str, n: int = 200):
    """(ms, profiler ms) of one launch through a kernel's C entry, on the
    device alone: one CUDA-event pair around n back-to-back launches, over
    n; and torch.profiler's mean device time of the kernels whose name
    holds `kernel` over n launches (knn_ab.profiled_ms; None if it records
    none)."""
    import torch

    from avenir_tpu_torch.tools.knn_ab import profiled_ms

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, profiled_ms(launch, kernel, n)


def _device_text(ms: float, prof_ms) -> str:
    return (f"device alone {ms:.4f} ms (200 launches a CUDA-event pair), "
            + ("profiler not measured" if prof_ms is None
               else f"profiler {prof_ms:.4f} ms"))


# ------------------------------------------------------------------ phase 1
def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    global CARD
    CARD = card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    from avenir_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    total = time.perf_counter() - t0
    print(f"build {total:.1f}s {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"into {_build.build_dir().relative_to(ROOT)}", flush=True)
    merges = {}
    for name in _build.LIBRARIES:
        log = _build.build_dir() / f"{name}.log"
        if log.exists():
            text = log.read_text()
            merges.update({fn: int(st) + int(ld) for fn, st, ld in re.findall(
                r"Function properties for (\S*merge_(?:topk|vote)_kernel\S*)"
                r"\s+\d+ bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", text)})
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", text))
            print(f"ptxas {name}: {len(regs)} kernels, registers "
                  f"{min(regs)}..{max(regs)}, spill stores {spills} bytes",
                  flush=True)
            partial = {fn: int(st) + int(ld) for fn, st, ld in re.findall(
                r"Function properties for (\S*partial_topk(?:_mma)?_kernel\S*)"
                r"\s+\d+ bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", text)}
            # the diagnostic instance (PROFILE, "Lb1E") runs on no path
            diag = {fn: n for fn, n in partial.items() if "ELb1E" in fn}
            partial = {fn: n for fn, n in partial.items() if fn not in diag}
            if partial:
                spilled = sorted(fn for fn, n in partial.items() if n)
                check(not spilled, f"ptxas {name}: {len(partial)} partial "
                      f"instances ({sum('_mma_' in fn for fn in partial)} "
                      f"tensor-core), {len(spilled)} spill" +
                      (f": {spilled}" if spilled else ""))
            for fn, n in diag.items():
                print(f"ptxas {name}: diagnostic instance (clock64 sections) "
                      f"spills {n} bytes", flush=True)
        _build.load(name)
    spilled = sorted(fn for fn, n in merges.items() if n)
    check(len(merges) == 8 and not spilled, f"ptxas: {len(merges)} merge "
          f"instances (2 kernels x 4 carry widths), {len(spilled)} spill"
          + (f": {spilled}" if spilled else ""))
    partial_instances()
    merge_instances()
    ceiling_instances()


def ceiling_instances() -> None:
    """The matmul ceiling's kernels: no spill in ptxas's log, and each
    wgmma instance's resources from cudaFuncGetAttributes, with its tile
    held to the wrapper's plan."""
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import matmul_ceiling as mc
    from avenir_tpu_torch.tools.ceiling_ab import ptxas_spills

    log = _build.build_dir() / "matmul_ceiling.log"
    spills = ptxas_spills(log.read_text()) if log.exists() else {}
    bad = []
    for d in (64, 128):
        info = mc.ceiling_info(d)
        print(f"matmul_ceiling wgmma instance D<={d}: {info['registers']} "
              f"registers at launch, {info['local_bytes']} local bytes, "
              f"{info['smem_bytes']} shared bytes, {info['threads']} "
              f"threads, {info['blocks_per_sm']} block/SM, {info['bm']} "
              f"queries x {info['bn']} train rows, {info['stages']} stages",
              flush=True)
        if info["local_bytes"] or (info["bm"], info["bn"]) != (mc.BM, mc.BN):
            bad.append(d)
    check(not bad and not any(spills.values()),
          f"matmul_ceiling: {len(spills)} kernels in ptxas's log, spill "
          f"bytes {sum(spills.values())}; the wgmma instances' local bytes "
          f"0 and tiles equal to the plan" + (f"; not at D<={bad}" if bad
                                               else ""))


def partial_instances() -> None:
    """Every partial instance's registers and local (spilled) bytes from
    cudaFuncGetAttributes, and its blocks per SM at D=6 and D=128; fails
    on any local bytes. Prints the K=8 instances, which the job runs."""
    from avenir_tpu_torch.ops import knn_kernels as kk

    spilled, plans = [], []
    n = 0
    # the CUDA-core instances (both metrics), then the tensor-core ones
    # (euclidean bfloat16)
    forms = [(metric, False, kk._stage_plan) for metric in
             ("manhattan", "euclidean")] + [("euclidean", True,
                                            kk._mma_stage_plan)]
    for mode in kk.MODES:
        for metric, mma, stage_plan in forms:
            what = f"{mode} {metric}" + (" bfloat16 tensor-core" if mma
                                         else "")
            for k in (8, 16, 32, 64):
                per_sm = {}
                for d in (6, 128, kk.MAX_D):
                    per_sm[d], regs, local, *plan = kk.partial_info(
                        k, metric == "euclidean", mode, d, bf16=mma)
                    if tuple(plan) != stage_plan(d, k):
                        plans.append(f"{what}/K={k}/D={d}")
                n += 1
                if local:
                    spilled.append(f"{what}/K={k}")
                if k == 8 or mma:
                    print(f"partial K={k} {what}: {regs} registers, "
                          f"{local} local bytes, blocks/SM {per_sm[6]} at "
                          f"D=6, {per_sm[128]} at D=128, {per_sm[kk.MAX_D]} "
                          f"at D={kk.MAX_D}", flush=True)
    check(not spilled, f"{n} partial instances, {len(spilled)} with local "
          f"(spilled) bytes" + (f": {spilled}" if spilled else ""))
    check(not plans, "the kernels' stage plans (rows, stages, bytes) equal "
          "knn_kernels._stage_plan and _mma_stage_plan"
          + (f"; not {plans}" if plans else ""))


def merge_instances() -> None:
    """Every merge instance's registers, local (spilled) bytes and blocks
    per SM from cudaFuncGetAttributes; fails on any local bytes. The
    merges' layout (knn_merge_layout) at 1 to 65 splits: G the fewest of
    8, 16 and 32 lanes that cover min(splits, 32), blocks of whole groups,
    and MERGE_OWN lists a lane at G=32, the count the CPU model of the
    merge (merge_splits_group_plain) takes."""
    from avenir_tpu_torch.ops import knn_kernels as kk

    spilled = []
    threads = kk.merge_layout(NQ, 1)["threads"]
    for vote in (False, True):
        name = "merge_vote" if vote else "merge_topk"
        for k in (8, 16, 32, 64):
            per_sm, regs, local = kk.merge_info(k, vote)
            print(f"{name} K={k}: {regs} registers, {local} local bytes, "
                  f"{per_sm} blocks/SM of {threads} threads", flush=True)
            if local:
                spilled.append(f"{name}/K={k}")
    check(not spilled, "8 merge instances, "
          f"{len(spilled)} with local (spilled) bytes"
          + (f": {spilled}" if spilled else ""))
    bad = []
    for splits in range(1, 66):
        lay = kk.merge_layout(NQ, splits)
        g = min(c for c in (8, 16, 32) if c >= min(splits, 32))
        if (lay["group"], lay["blocks"], lay["own"]) != (
                g, -(-NQ // (threads // g)),
                kk.MERGE_OWN if g == 32 else 1) or threads % g:
            bad.append(f"{splits}: {lay}")
    check(not bad, f"merge layout at 1..65 splits of {NQ} queries: G the "
          f"fewest of 8/16/32 lanes covering min(splits, 32), "
          f"{threads}-thread blocks of whole groups, {kk.MERGE_OWN} lists a "
          "lane at G=32 as the CPU model takes"
          + (f"; not {bad[:5]}" if bad else ""))


# ------------------------------------------------------------------ phase 2
def bound_ms(metric: str, d: int, k: int, flops: float, rate: float,
             extra_bytes: int = 0, bf16_flops: float = 0.0):
    """(ms, "operations" or "bytes"): the least time for the work, the
    larger of operations over the fp32 peak (euclidean 2*D per pair,
    manhattan 3*D, plus one selection compare per pair) and bytes over the
    memory rate (inputs read once, outputs once), and which one it was.
    With bf16_flops (a euclidean bfloat16 cross term) the 2*D products and
    sums per pair count at that tensor-core peak and the compare at the
    fp32 one, and the larger of the two is the operations' time."""
    pairs = NQ * NT
    if bf16_flops:
        ops_ms = max(pairs * 2 * d / bf16_flops, pairs / flops) * 1e3
    else:
        ops_ms = pairs * ((2 if metric == "euclidean" else 3) * d + 1) / flops * 1e3
    nbytes = (NQ + NT) * d * 4 + NQ * k * 8 + extra_bytes
    bytes_ms = nbytes / rate * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _warm_plain() -> None:
    """Run every plain version once at a tiny size: CUDA loads a library
    kernel at its first use, which no once-timed plain call should pay."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    q = torch.rand((8, 4), device=DEVICE)
    t = torch.rand((64, 4), device=DEVICE)
    labels = torch.zeros(64, dtype=torch.int32, device=DEVICE)
    for metric in ("manhattan", "euclidean"):
        for dtype in kk.COMPUTE_DTYPES:
            for plain in (kk.knn_topk_plain, kk.knn_topk_packed_plain,
                          kk.knn_topk_lanes_plain):
                plain(q, t, K, metric, compute_dtype=dtype)
            kk.knn_classify_lanes_plain(q, t, labels, K, 2, 4, "gaussian",
                                        30.0, metric, compute_dtype=dtype)
    torch.cuda.synchronize()


def phase_kernels(flops: float, rate: float):
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools import knn_tolerance as tol

    _warm_plain()
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    results = []
    for d in (6, 128):
        q = torch.rand((NQ, d), generator=gen, device=DEVICE)
        t = torch.rand((NT, d), generator=gen, device=DEVICE)
        labels = torch.randint(0, 2, (NT,), generator=gen, device=DEVICE,
                               dtype=torch.int32)
        for metric in ("manhattan", "euclidean"):
            p = 1.0 if metric == "manhattan" else 2.0
            lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(q, t, p=p), K,
                                                dim=1, largest=False), 2)
            bound, bound_by = bound_ms(metric, d, K, flops, rate)
            for name in ("knn_topk", "knn_topk_lanes"):
                wrap = getattr(kk, name)
                plain = getattr(kk, name + "_plain")
                gd, gi = wrap(q, t, K, metric)
                torch.cuda.synchronize()
                (pd, pi), plain_ms = _timed_once(lambda: plain(q, t, K, metric))
                err = (gd - pd).abs().max().item()
                mism = gi != pi
                rtol, atol = (1e-6, 0.0) if metric == "manhattan" else (1e-4, 1e-5)
                if name == "knn_topk_lanes":
                    # one quantum, on top of the exact kernel's tolerance
                    quantum = 2.0 ** -(23 - kk.lane_pack_bits(NT))
                    close = bool(((gd - pd).abs()
                                  <= atol + (rtol + quantum) * pd.abs()).all())
                    recall = tol.recall(gi, pi)
                    ok = close and recall >= 0.99
                    how = f"quantum {quantum:.2e} recall {recall:.5f}"
                else:
                    close = bool(((gd - pd).abs() <= atol + rtol * pd.abs()).all())
                    tied = tol.tied(q, t, gi, pd, mism, metric, rtol, atol)
                    ok = close and tied
                    how = f"rtol {rtol} atol {atol} ties-only {tied}"
                n0 = wrap.launches
                ms = cuda_ms(lambda: wrap(q, t, K, metric), 5)
                plan = _plan(q, t, metric, name)
                row = dict(name=name, metric=metric, d=d, max_abs_err=err,
                           index_mismatch=int(mism.sum()), ms=ms,
                           plain_ms=plain_ms, bound_ms=bound,
                           bound_by=bound_by, library_ms=lib_ms, **plan)
                results.append(row)
                check(ok, f"{name} {metric} D={d}: max|err| {err:.3g} "
                      f"index mismatches {int(mism.sum())} ({how}); "
                      f"{ms:.3f} ms, plain {plain_ms:.1f} ms, "
                      f"bound {bound:.3f} ms ({bound / ms:.1%} of it), "
                      f"cdist+topk {lib_ms:.1f} ms; {_plan_text(plan)}, "
                      f"{wrap.launches - n0} launches timed")
            for fn in ("none", "gaussian"):
                def run(impl=kk.knn_classify_lanes):
                    return impl(q, t, labels, K, 2, d, fn, 30.0, metric)
                got = run()
                torch.cuda.synchronize()
                ref, plain_ms = _timed_once(
                    lambda: run(kk.knn_classify_lanes_plain))
                err = (got - ref).abs().max().item()
                agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
                n0 = kk.knn_classify_lanes.launches
                ms = cuda_ms(run, 5)
                cbound, cbound_by = bound_ms(metric, d, 0, flops, rate,
                                             extra_bytes=NT * 4 + NQ * 2 * 4)
                plan = _plan(q, t, metric, "knn_classify_lanes")
                # no PyTorch call computes the vote: library_ms is null
                results.append(dict(name="knn_classify_lanes", metric=metric,
                                    d=d, kernel_fn=fn, max_abs_err=err,
                                    argmax_agreement=agree, ms=ms,
                                    plain_ms=plain_ms, bound_ms=cbound,
                                    bound_by=cbound_by, library_ms=None,
                                    **plan))
                # "none" counts neighbours: no floored score may round apart
                limit = 0.0 if fn == "none" else 2.0
                check(err <= limit and agree >= 0.99,
                      f"knn_classify_lanes {metric} D={d} {fn}: max|err| "
                      f"{err:.3g} argmax agreement {agree:.5f}; {ms:.3f} ms, "
                      f"plain {plain_ms:.1f} ms, bound {cbound:.3f} ms "
                      f"({cbound / ms:.1%} of it); {_plan_text(plan)}, "
                      f"{kk.knn_classify_lanes.launches - n0} launches timed")
        results += _check_prepass(q, t, d, flops, rate)
        if d == 6:     # the job's shape
            results += _merge_rows(q, t, labels, "manhattan", "float32",
                                   rate, "job")
        # padded corpus: rows at and past n_valid never enter
        nv = NT - 777
        gd, gi = kk.knn_topk(q, t, K, "manhattan", n_valid=nv)
        pd, pi = kk.knn_topk_plain(q, t, K, "manhattan", n_valid=nv)
        check(bool((gi < nv).all()) and torch.equal(gd, pd),
              f"knn_topk manhattan D={d} n_valid={nv}: padding masked")
    _check_prepass_shapes()
    return results


#: wrapper -> the knn_kernels mode of its partial instance
PLAN_MODES = {"knn_topk": "exact", "knn_topk_lanes": "lanes",
              "knn_topk_packed": "packed", "knn_classify_lanes": "labels"}


def _plan(q, t, metric, name, dtype="float32") -> dict:
    """The launch's blocks per SM, grid and waves (knn_kernels.launch_plan):
    euclidean bfloat16 takes the tensor-core instance's grid."""
    from avenir_tpu_torch.ops import knn_kernels as kk

    plan = kk.launch_plan(q, t, K, metric, PLAN_MODES[name],
                          compute_dtype=dtype)
    return {key: plan[key] for key in ("blocks_per_sm", "grid", "waves")}


def _plan_text(plan) -> str:
    return (f"{plan['blocks_per_sm']} blocks/SM, grid {plan['grid']}, "
            f"{plan['waves']:.2f} waves")


def _merge_reads(part_k, nq, splits, empty):
    """(keys, indices) a serial merge must read from these split lists,
    the bound's bytes (cb9153e's merge_splits, one thread a query): each
    split's keys in order up to and including the first that is not
    below the carry's worst, and the index of each key it inserts. A
    carry of the lists' width is replayed on the card, a slot at a time."""
    import torch

    pk = part_k.view(splits, nq, -1)
    best = torch.full((nq, pk.shape[2]), empty, dtype=torch.int32,
                      device=part_k.device)
    keys = idx = 0
    for s in range(splits):
        live = torch.ones(nq, dtype=torch.bool, device=part_k.device)
        for j in range(pk.shape[2]):
            key = pk[s, :, j]
            ins = live & (key < best[:, -1])
            keys += int(live.sum())
            idx += int(ins.sum())
            merged = torch.sort(torch.cat([best[:, :-1], key[:, None]], 1),
                                dim=1).values
            best = torch.where(ins[:, None], merged, best)
            live = ins
    return keys, idx


def _merge_rows(q, t, labels, metric, dtype, rate, shape):
    """The two merge kernels timed apart from the partial kernel: one
    launch of the wrapper's route leaves the split lists, then
    knn_topk_merge_launch / knn_classify_merge_launch alone on them,
    bit-equal to merge_splits_plain (and _vote) and to the full launch's
    output. Bound: the bytes the merge must move on these lists
    (_merge_reads, and its output). Library: torch.topk over each query's
    splits x K keys (laid out [nq, splits * K] once, outside the timing).
    Beside them the launch floor: an empty kernel on the merges' grid
    (knn_merge_floor_launch), timed as they are on the device alone."""
    import torch

    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn_kernels as kk

    from avenir_tpu_torch.tools.knn_ab import merge_call

    euclid = metric == "euclidean"
    bf16 = kk._bf16(dtype, metric)
    mma = kk._mma(euclid, bf16)
    (nq, d), stream = q.shape, kk._stream(q.device)
    ops = [None if x is None else x.data_ptr()
           for x in kk._operands(q, t, euclid, bf16, NT)]
    rows = []
    floors = {}
    for name, mode in (("merge_topk", "lanes" if shape == "bench"
                        else "exact"), ("merge_vote", "labels")):
        _, _, splits, per_split = kk._grid(q, K, euclid, mode, NT, bf16=bf16)
        part_k, part_i = kk._partial_buffers(q, K, splits)
        ptrs = (part_k.data_ptr(), part_i.data_ptr())
        if mode == "labels":
            lib = _build.load("knn_classify")
            full = torch.empty((nq, 2), dtype=torch.float32, device=q.device)
            kk._launch(lib, "knn_classify", mma, "knn_classify_lanes", *ops,
                       labels.data_ptr(), nq, d, NT, K, int(euclid), 1, 2,
                       1.0 / d, kk.KERNEL_FNS.index("gaussian"), 30.0, splits,
                       per_split, *ptrs, full.data_ptr(), stream)
            empty, fn = kk.SENTINEL, "gaussian"

            def plain():
                keys = kk.merge_splits_plain(part_k, part_i, nq, splits, K)[0]
                return kk._vote(keys, 1, 2, d, metric, "gaussian", 30.0)
            out_bytes = nq * 2 * 4
        else:
            lib = _build.load("knn_topk")
            full = torch.empty((2, nq, K), dtype=torch.int32, device=q.device)
            bits, _, empty = kk._key_spec(mode, t)
            kk._launch(lib, "knn_topk", mma, f"knn_topk ({mode})", *ops, nq,
                       d, NT, K, int(euclid), kk.MODES[mode], bits, splits,
                       per_split, *ptrs, full[0].data_ptr(),
                       full[1].data_ptr(), stream)
            fn = None

            def plain():
                return torch.stack(kk.merge_splits_plain(part_k, part_i, nq,
                                                         splits, K))
            out_bytes = nq * K * 8
        merge = merge_call(lib, (part_k, part_i, splits), nq, K, mode, metric,
                           d, fn, launches=1)
        out = torch.stack(merge())
        out = out[0] if fn else out
        torch.cuda.synchronize()
        ref, plain_ms = _timed_once(plain)
        if mode == "labels":
            err = (out - ref).abs().max().item()
        else:
            err = (out.long() - ref.long()).abs().max().item()
        ok = torch.equal(out, full) and torch.equal(out, ref)
        ms = cuda_ms(merge, 20)
        dev_ms, prof_ms = device_alone(merge, f"{name}_kernel")
        if splits not in floors:
            floors[splits] = _merge_floor(nq, splits, shape, stream)
        floor_ms, floor_prof = floors[splits]
        keys, idx = _merge_reads(part_k, nq, splits, empty)
        bound = (4 * (keys + idx) + out_bytes) / rate * 1e3
        lib_ms = None
        if mode != "labels":
            cand = part_k.view(splits, nq, -1).permute(1, 0, 2).reshape(nq, -1)
            lib_ms = cuda_ms(lambda: torch.topk(cand, K, dim=1, largest=False),
                             20)
        lay = kk.merge_layout(nq, splits)
        group, blocks = lay["group"], lay["blocks"]
        rows.append(dict(name=name, metric=metric, d=d, dtype=dtype,
                         shape=shape, splits=splits, group=group,
                         blocks=blocks, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                         library_ms=lib_ms, keys_read=keys,
                         device_ms=dev_ms, profiler_ms=prof_ms,
                         floor_ms=floor_ms, floor_profiler_ms=floor_prof))
        share = bound / prof_ms if prof_ms else None
        check(ok, f"{name} ({mode} lists of the {shape} shape, {metric} "
              f"{dtype} D={d}, {splits} splits, G={group}, {blocks} blocks): "
              f"bit-equal to the full launch's and the plain merge's, "
              f"max|err| {err:.3g}; {ms:.4f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound:.5f} ms (bytes: {keys} keys and {idx} indices "
              f"read of {part_k.numel()}, {bound / ms:.1%} of a call"
              + ("" if share is None else f", {share:.1%} of the device "
                 "time") + ")"
              + ("" if lib_ms is None else f", torch.topk {lib_ms:.4f} ms")
              + f"; {_device_text(dev_ms, prof_ms)}")
    return rows


def _merge_floor(nq, splits, shape, stream):
    """(ms, profiler ms) of an empty kernel on the merges' grid for nq
    queries' splits lists, on the device alone (device_alone), printed."""
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn_kernels as kk

    lib = _build.load("knn_topk")

    def launch():
        kk._raise_on(lib.knn_merge_floor_launch(nq, splits, stream),
                     "knn_merge_floor")
    ms, prof_ms = device_alone(launch, "merge_floor_kernel")
    lay = kk.merge_layout(nq, splits)
    print(f"merge launch floor (an empty kernel on the merges' grid at the "
          f"{shape} shape: {nq} queries, {splits} splits, G={lay['group']}, "
          f"{lay['blocks']} blocks): {_device_text(ms, prof_ms)}",
          flush=True)
    return ms, prof_ms


def _check_prepass(q, t, d, flops, rate):
    """knn_prepass against its plain version, bit for bit, in both forms:
    norms alone (float32) and norms with bfloat16 copies."""
    import torch

    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn_kernels as kk

    rows = []
    qt = torch.cat([q, t])
    lib = _build.load("knn_prepass")
    for dtype in kk.COMPUTE_DTYPES:
        bf16 = dtype == "bfloat16"
        got = kk.knn_prepass(q, t, bf16)
        torch.cuda.synchronize()
        ref, plain_ms = _timed_once(lambda: kk.knn_prepass_plain(q, t, bf16))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        n0 = kk.knn_prepass.launches
        ms = cuda_ms(lambda: kk.knn_prepass(q, t, bf16), 20)
        n = NQ + NT
        nbytes = n * d * 4 + n * 4 + (n * d * 4 if bf16 else 0)
        ops_ms, bytes_ms = 2 * n * d / flops * 1e3, nbytes / rate * 1e3
        bound, bound_by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                           else (bytes_ms, "bytes"))
        # the norms alone are one PyTorch call; nothing computes the pair
        lib_ms = None if bf16 else cuda_ms(
            lambda: torch.einsum("ij,ij->i", qt, qt), 20)
        out = [torch.empty(n, dtype=torch.float32, device=q.device) for n
               in (NQ, NT)] + ([torch.empty_like(q), torch.empty_like(t)]
                               if bf16 else [None, None])
        ptrs = [None if x is None else x.data_ptr() for x in out]

        def launch():
            kk._raise_on(lib.knn_prepass_launch(
                q.data_ptr(), NQ, t.data_ptr(), NT, d, int(bf16), *ptrs,
                kk._stream(q.device)), "knn_prepass")
        dev_ms, prof_ms = device_alone(launch, "prepass_kernel")
        rows.append(dict(name="knn_prepass", metric="euclidean", d=d,
                         dtype=dtype, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                         library_ms=lib_ms, device_ms=dev_ms,
                         profiler_ms=prof_ms))
        check(same, f"knn_prepass {dtype} D={d}: bit-equal to the plain "
              f"version {same} (max|err| {err:.3g}); {ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms, bound {bound:.4f} ms ({bound_by}, "
              f"{bound / ms:.1%} of it)"
              + ("" if lib_ms is None else f", einsum {lib_ms:.4f} ms")
              + f"; {kk.knn_prepass.launches - n0} launches timed; "
              + _device_text(dev_ms, prof_ms))
    return rows


def _check_prepass_shapes():
    """knn_prepass bit-equal to its plain version where its blocks are
    ragged, its rows span several shared-memory chunks, and t starts one
    row into its storage (off a 16-byte boundary unless 4 divides D)."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    gen = torch.Generator(device=DEVICE).manual_seed(1235)
    bad = []
    for d in (1, 3, 7, 128, 129, 300, kk.MAX_D):
        q = torch.randn((37, d), generator=gen, device=DEVICE)
        t = torch.randn((1002, d), generator=gen, device=DEVICE)[1:]
        for bf16 in (False, True):
            got = kk.knn_prepass(q, t, bf16)
            ref = kk.knn_prepass_plain(q, t, bf16)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                bad.append((d, bf16))
    check(not bad, "knn_prepass at 37 x 1001 rows, D 1..MAX_D, t one row "
          "into its storage: bit-equal to the plain version"
          + (f"; not at (D, bf16) {bad}" if bad else ""))


def _wrappers():
    from avenir_tpu_torch.ops import cluster_kernels as ck
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.ops import matmul_ceiling as mc
    from avenir_tpu_torch.ops import sampling_kernels as smk
    from avenir_tpu_torch.ops import sequence_kernels as sk

    return (kk.COUNTED_WRAPPERS + mc.KERNEL_WRAPPERS + sk.KERNEL_WRAPPERS
            + ck.KERNEL_WRAPPERS + smk.KERNEL_WRAPPERS)


def _reset_launches() -> None:
    for fn in _wrappers():
        fn.launches = 0


def _launch_counts():
    return {fn.__name__: fn.launches for fn in _wrappers()}


# --------------------------------------------------- host-clock split
def _job_split(rec) -> dict:
    """{job: {span name: seconds}} of a captured run: for each `job.run`
    span, the seconds of the spans inside it by name, `other` (the
    seconds of job.run that no span inside it covers: the spans of a job
    do not overlap) and job.run itself. A pipeline's stages are jobs of
    their own."""
    spans = rec.spans()
    out = {}
    for run in (sp for sp in spans if sp.name == "job.run"):
        end = run.t0 + run.dur
        split = {}
        for sp in spans:
            if sp.name != "job.run" and run.t0 <= sp.t0 \
                    and sp.t0 + sp.dur <= end:
                split[sp.name] = split.get(sp.name, 0.0) + sp.dur
        split["other"] = run.dur - sum(split.values())
        split["job.run"] = run.dur
        out[run.attrs["job"]] = split
    return out


def _print_split(what: str, rec, engines=None) -> dict:
    """Print a captured run's host-clock split (one line) and return it;
    fails if the run recorded no job.run or a parse took an engine not in
    `engines`."""
    split = _job_split(rec)
    ran = sorted({sp.attrs["engine"] for sp in rec.spans()
                  if sp.name == "stream.parse"})
    check(bool(split) and (engines is None or set(ran) <= set(engines)),
          f"host-clock split, {what} ({CARD}): seconds by span "
          f"{json.dumps(split)}; parsers {ran}; "
          f"{rec.dropped} spans dropped")
    return split


def _device_busy(run) -> dict:
    """torch.profiler's device time over one call of run() (a job, or a
    shared scan), and its share of the `job.run` seconds (of the call's
    wall seconds where it records no job.run): kernels, and kernels with
    copies and sets."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avenir_tpu_torch import obs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            obs.capture() as rec:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    secs = sum(sp.dur for sp in rec.spans() if sp.name == "job.run") or wall
    kern = other = 0.0
    for ev in prof.key_averages():
        us = (ev.device_time_total if hasattr(ev, "device_time_total")
              else ev.cuda_time_total)
        if ev.key.startswith(("Memcpy", "Memset")):
            other += us
        else:
            kern += us
    return {"job_run_s": secs, "kernel_s": kern / 1e6,
            "device_s": (kern + other) / 1e6,
            "kernel_share": kern / 1e6 / secs,
            "device_busy_share": (kern + other) / 1e6 / secs}


def check_ingest(path: Path, schema, what: str) -> None:
    """Parse a whole CSV file with engine="python" and engine="native":
    every column byte-identical (float32 bits, int32 codes, id strings);
    rows/s of each and the native parser's threads."""
    from avenir_tpu_torch.core.dataset import Dataset
    from avenir_tpu_torch.native import ingest

    data = path.read_bytes()
    check(ingest.native_available(), "the native CSV parser builds and loads")
    got, rate = {}, {}
    for engine in ("python", "native"):
        t0 = time.perf_counter()
        ds = Dataset.from_csv(data, schema, engine=engine)
        for fld in schema.fields:    # the native parser's ids are lazy
            ds.column(fld.ordinal)
        secs = time.perf_counter() - t0
        got[engine], rate[engine] = ds, len(ds) / secs
    py, nat = got["python"], got["native"]
    same = [f.name for f in schema.fields
            if (list(py.column(f.ordinal)) == list(nat.column(f.ordinal))
                if py.column(f.ordinal).dtype == object else
                py.column(f.ordinal).tobytes()
                == nat.column(f.ordinal).tobytes())]
    check(len(py) == len(nat) and len(same) == len(schema.fields),
          f"ingest {what} ({len(data)} bytes, {len(py)} rows, {CARD}): "
          f"python {rate['python']:.0f} rows/s, native {rate['native']:.0f} "
          f"rows/s on {ingest.parse_threads(len(data))} threads "
          f"(x{rate['native'] / rate['python']:.2f}); columns byte-identical "
          f"{same} of {[f.name for f in schema.fields]}")


# ------------------------------------------------------------------ phase 3
def phase_main_path():
    import torch

    from avenir_tpu_torch import obs
    from avenir_tpu_torch.data import elearn_schema, generate_elearn
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.runner import run_job

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    schema = str(work / "elearn.json")
    elearn_schema().save(schema)
    train, test = str(work / "train.csv"), str(work / "test.csv")
    Path(train).write_text(generate_elearn(NT, seed=101, as_csv=True))
    test_csv = generate_elearn(NQ, seed=102, as_csv=True)
    Path(test).write_text(test_csv)
    small = str(work / "test_small.csv")
    Path(small).write_text("".join(test_csv.splitlines(True)[:CHECK_ROWS]))
    check_ingest(Path(train), elearn_schema(), "e-learning train file")
    # the native parser wherever auto would take it: a failed build fails
    base = {"nen.feature.schema.file.path": schema,
            "nen.top.match.count": str(K),
            "nen.kernel.function": "gaussian", "nen.kernel.param": "30",
            "nen.validation.mode": "true", "csv.engine": "native"}
    modes = (("default", {}, kk.knn_topk),
             ("packed", {"nen.device.packed.kernel": "true"}, kk.knn_topk_lanes),
             ("fused", {"nen.device.fused.vote": "true"}, kk.knn_classify_lanes),
             ("class_cond", {"nen.class.condtion.weighted": "true"},
              kk.knn_topk))
    launches, preds, secs_by_mode = {}, {}, {}   # launches: summed over runs
    for mode, extra, wrapper in modes:
        out = str(work / f"out_{mode}.txt")
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs.capture() as rec:
            res = run_job("nearestNeighbor", {**base, **extra}, [train, test],
                          out, device=DEVICE)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _launch_counts()
        _print_split(f"nearestNeighbor {mode}", rec, ["native"])
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        acc = res.counters["Validation:Accuracy"]
        lines = Path(out).read_text().splitlines()
        preds[mode] = [ln.split(",")[1] for ln in lines]
        secs_by_mode[mode] = round(secs, 3)
        check(wrapper.launches >= 1 and acc > 60 and len(lines) == NQ,
              f"nearestNeighbor {mode}: {secs:.2f}s, {wrapper.__name__} "
              f"launched {wrapper.launches}x, launches {counts}, "
              f"Validation:Accuracy {acc}, {len(lines)} rows")
    for mode in ("packed", "fused"):
        agree = sum(a == b for a, b in zip(preds["default"], preds[mode])) / NQ
        check(agree >= 0.99, f"default vs {mode}: predictions agree {agree:.5f}")
    print(f"nearestNeighbor seconds by mode ({NT} x {NQ}, {CARD}): "
          f"{json.dumps(secs_by_mode)}", flush=True)
    # the same job with the Python row parser, then under the profiler
    py_out = str(work / "out_python.txt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.capture() as rec:
        run_job("nearestNeighbor", {**base, "csv.engine": "python"},
                [train, test], py_out, device=DEVICE)
        torch.cuda.synchronize()
    py_secs = time.perf_counter() - t0
    _print_split("nearestNeighbor default, engine=python", rec, ["python"])
    check(Path(py_out).read_bytes() == Path(work / "out_default.txt")
          .read_bytes(), f"nearestNeighbor default: {py_secs:.3f}s with "
          f"engine=python against {secs_by_mode['default']:.3f}s native; "
          f"output byte-identical")
    busy = _device_busy(lambda: run_job(
        "nearestNeighbor", base, [train, test], str(work / "out_prof.txt"),
        device=DEVICE))
    check(busy["kernel_s"] > 0, f"nearestNeighbor default under "
          f"torch.profiler ({CARD}): {json.dumps(busy)}")
    for mode, extra in (("default", {}),
                        ("class_cond", {"nen.class.condtion.weighted": "true"})):
        cpu_out = str(work / f"out_cpu_{mode}.txt")
        run_job("nearestNeighbor", {**base, **extra}, [train, small], cpu_out,
                device="cpu")
        gpu_head = Path(work / f"out_{mode}.txt").read_text().splitlines()[
            :CHECK_ROWS]
        cpu_lines = Path(cpu_out).read_text().splitlines()
        check(gpu_head == cpu_lines,
              f"{mode} run's first {CHECK_ROWS} lines equal the CPU run's")
    shutil.rmtree(work)
    return launches


# ------------------------------------------------------------------ phase 4
def phase_kernel_check():
    """Every kernel_check case on the card; its launch counts."""
    import torch

    from avenir_tpu_torch.tools import kernel_check

    _reset_launches()
    t0 = time.perf_counter()
    results = kernel_check.run(DEVICE)
    torch.cuda.synchronize()
    counts = _launch_counts()
    failed = [name for name, faults in results.items() if faults]
    check(not failed, f"kernel_check: {len(results) - len(failed)} of "
          f"{len(results)} cases pass in {time.perf_counter() - t0:.1f}s, "
          f"launches {counts}" + (f"; failed {failed}" if failed else ""))
    check(counts["knn_partial_mma"] >= 1, "kernel_check: its bfloat16 "
          "euclidean cases took the tensor-core form "
          f"({counts['knn_partial_mma']} launches)")
    return counts


# ------------------------------------------------------------------ phase 5
def phase_packed_bf16(flops: float, rate: float, bf16_flops: float,
                      phase2_rows):
    """The packed kernel and every bfloat16 variant against their plain
    versions; plain versions are timed once, on the compared call."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools import knn_tolerance as tol

    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    topk = (("knn_topk", 0.0), ("knn_topk_packed", tol.PACKED_QUANTUM),
            ("knn_topk_lanes", 2.0 ** -(23 - kk.lane_pack_bits(NT))))
    results = []
    for d in (6, 128):
        q = torch.rand((NQ, d), generator=gen, device=DEVICE)
        t = torch.rand((NT, d), generator=gen, device=DEVICE)
        labels = torch.randint(0, 2, (NT,), generator=gen, device=DEVICE,
                               dtype=torch.int32)
        # manhattan ignores the dtype: bfloat16 is float32, bit for bit
        for name, _ in topk:
            wrap = getattr(kk, name)
            same = all(torch.equal(x, y) for x, y in zip(
                wrap(q, t, K, "manhattan", compute_dtype="bfloat16"),
                wrap(q, t, K, "manhattan")))
            check(same, f"{name} manhattan D={d}: bfloat16 equals float32")
        vote = [kk.knn_classify_lanes(q, t, labels, K, 2, d, "gaussian", 30.0,
                                      "manhattan", compute_dtype=dt)
                for dt in kk.COMPUTE_DTYPES]
        check(torch.equal(*vote), f"knn_classify_lanes manhattan D={d}: "
              f"bfloat16 equals float32")
        cases = [("knn_topk_packed", "manhattan", "float32"),
                 ("knn_topk_packed", "euclidean", "float32")]
        cases += [(name, "euclidean", "bfloat16") for name, _ in topk]
        for name, metric, dtype in cases:
            bf16 = dtype == "bfloat16"
            wrap = getattr(kk, name)
            plain = getattr(kk, name + "_plain")
            n_mma = kk.knn_partial_mma.launches
            gd, gi = wrap(q, t, K, metric, compute_dtype=dtype)
            torch.cuda.synchronize()
            # euclidean bfloat16 takes the tensor-core form, nothing else
            mma = kk.knn_partial_mma.launches - n_mma
            form = int(bf16 and metric == "euclidean")
            (pd, pi), plain_ms = _timed_once(
                lambda: plain(q, t, K, metric, compute_dtype=dtype))
            err = (gd - pd).abs().max().item()
            mism = gi != pi
            rtol = 1e-4 + dict(topk)[name]
            floor = tol.cancellation_floor(q, t) if bf16 else 0.0
            close = bool(tol.within(gd, pd, d, rtol, 1e-5, floor).all())
            if metric == "manhattan":
                ok = torch.equal(gd, pd) and torch.equal(gi, pi)
                how = "bit-equal"
            elif name == "knn_topk_lanes":
                recall = tol.recall(gi, pi)
                ok = close and recall >= 0.99
                how = f"rtol {rtol:.3g} floor {floor:.2g} recall {recall:.5f}"
            else:
                tied = tol.tied(q, t, gi, pd, mism, metric, rtol, 1e-5, bf16,
                                floor)
                ok = close and tied
                how = (f"rtol {rtol:.3g} atol 1e-05 floor {floor:.2g} "
                       f"ties-only {tied}")
            ok = ok and mma == form
            ms = cuda_ms(lambda: wrap(q, t, K, metric, compute_dtype=dtype), 5)
            bound, bound_by = bound_ms(metric, d, K, flops, rate,
                                       bf16_flops=bf16_flops if bf16 else 0.0)
            lib = next(r["library_ms"] for r in phase2_rows
                       if r["name"] == "knn_topk" and r["metric"] == metric
                       and r["d"] == d)
            plan = _plan(q, t, metric, name, dtype)
            results.append(dict(name=name, metric=metric, d=d, dtype=dtype,
                                max_abs_err=err,
                                index_mismatch=int(mism.sum()), ms=ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=bound_by, library_ms=lib,
                                mma_launches=mma, **plan))
            check(ok, f"{name} {metric} {dtype} D={d}: max|err| {err:.3g} "
                  f"index mismatches {int(mism.sum())} ({how}); "
                  f"{mma} tensor-core launch{'es' if mma != 1 else ''}; "
                  f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.3f} ms "
                  f"({bound_by}, {bound / ms:.1%} of it), cdist+topk "
                  f"{lib:.1f} ms; {_plan_text(plan)}")

        def run(impl=kk.knn_classify_lanes):
            return impl(q, t, labels, K, 2, d, "gaussian", 30.0, "euclidean",
                        compute_dtype="bfloat16")
        n_mma = kk.knn_partial_mma.launches
        got = run()
        torch.cuda.synchronize()
        mma = kk.knn_partial_mma.launches - n_mma
        ref, plain_ms = _timed_once(lambda: run(kk.knn_classify_lanes_plain))
        err = (got - ref).abs().max().item()
        agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
        # beyond a floored-score step (2.0), only a tie at the k-th
        # neighbour may change a vote
        swapped = torch.nonzero(((got - ref).abs() > 2.0).any(1)).flatten()
        tied = tol.boundary_tied(q, t, swapped, K, "euclidean", "bfloat16",
                                 1e-4, tol.cancellation_floor(q, t))
        ms = cuda_ms(run, 5)
        bound, bound_by = bound_ms("euclidean", d, 0, flops, rate,
                                   extra_bytes=NT * 4 + NQ * 2 * 4,
                                   bf16_flops=bf16_flops)
        plan = _plan(q, t, "euclidean", "knn_classify_lanes", "bfloat16")
        results.append(dict(name="knn_classify_lanes", metric="euclidean",
                            d=d, dtype="bfloat16", kernel_fn="gaussian",
                            max_abs_err=err, argmax_agreement=agree, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound,
                            bound_by=bound_by, library_ms=None,
                            mma_launches=mma, **plan))
        check(tied and agree >= 0.99 and mma == 1,
              f"knn_classify_lanes euclidean bfloat16 D={d} gaussian: "
              f"max|err| {err:.3g}, {swapped.numel()} queries past 2.0 "
              f"(k-th neighbour tied: {tied}), argmax agreement "
              f"{agree:.5f}; {mma} tensor-core launch; {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms, bound {bound:.3f} ms ({bound_by}, "
              f"{bound / ms:.1%} of it); {_plan_text(plan)}")
        shares = kk.mma_sections(q, t)
        torch.cuda.synchronize()
        print(f"tensor-core sections D={d} (K=8 lane keys, share of warp "
              f"cycles): " + ", ".join(f"{name} {v:.1%}"
                                       for name, v in shares.items()),
              flush=True)
        results.append(dict(name="mma_sections", d=d, shares=shares))
        if d == 128:   # the bench's shape
            results += _merge_rows(q, t, labels, "euclidean", "bfloat16",
                                   rate, "bench")
    _check_mma_shapes()
    _check_merge_ragged()
    _check_partial_nan()
    return results


#: keys on the empty slots' edges, and an exact key with the sign bit set
EDGE_KEYS = (0, 1, 0x7F6FFFFF, 0x7F700000, 0x7F700001, 0x7F7FFFFF,
             0x7F800000, 0x7F800001, -2 ** 31)


def _ragged_lists(rng, splits, nq, kw, mode):
    """Split lists [splits][nq][kw] as the partial kernel leaves them, on
    the card: each sorted by (key, column), columns rising by split, a key
    >= the mode's empty key only as (empty, -1) at its end, queries 0 and
    nq // 2 all empty. Keys: exact, a mix of a few small values (equal
    keys across splits, within a lane's and across lanes), EDGE_KEYS and
    random int32 (half with the sign bit set); lanes and labels, bits(d)
    with the low bits masked and a chunk id or label (C=2) in them, d from
    a few values (ties, exact zeros), some of which reach SENTINEL; mode
    "nan": label keys with, among those d, a NaN with the sign bit set
    (what a manhattan sum over a NaN row may give), which sorts first."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    shape = (splits, nq, kw)
    if mode == "exact":
        pick = rng.integers(0, 3, shape)
        key = np.where(pick == 0, rng.integers(0, 6, shape),
                       np.where(pick == 1, rng.choice(EDGE_KEYS, shape),
                                rng.integers(-2 ** 31, 2 ** 31, shape)))
        empty = kk.INF_BITS
    else:
        below = np.int32(0x7F6FF000).view(np.float32)   # just under it
        nan = np.uint32(0xFFC00000).view(np.float32)
        dist = rng.choice(np.float32([0.0, 0.004, 0.25, 1.0, 3.0, below,
                                      3.2e38, float("inf")]
                                     + ([nan] if mode == "nan" else [])),
                          shape)
        mask = 0xFFF if mode == "lanes" else 1
        low = rng.integers(0, mask + 1, shape)
        key = (dist.view(np.int32).astype(np.int64) & ~mask) | low
        empty = kk.SENTINEL
    col = rng.integers(0, 1000, shape) + 1000 * np.arange(splits)[:, None,
                                                                    None]
    order = np.lexsort((col, key), axis=-1)
    key = np.take_along_axis(key, order, -1)
    col = np.take_along_axis(col, order, -1)
    gone = key >= empty
    gone[:, [0, nq // 2]] = True
    key[gone], col[gone] = empty, -1
    return (torch.from_numpy(key.astype(np.int32).ravel()).to(DEVICE),
            torch.from_numpy(col.astype(np.int32).ravel()).to(DEVICE))


def _same(a, b, nan_bits: bool = True) -> bool:
    """a and b bit for bit; without nan_bits a NaN only where the other
    has one (the card's NaN and the plain version's may differ in sign and
    payload)."""
    import torch

    if a.is_floating_point():
        if not nan_bits:
            if not torch.equal(a.isnan(), b.isnan()):
                return False
            a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _check_merge_ragged() -> None:
    """Both merge kernels alone (their C entries) on ragged lists
    (_ragged_lists): splits 1, 7, 33, 40 and 65 (one lane owning one,
    two and three splits, and the batches past 64), every carry width
    with k at and below it; the top-k merge on exact and lane lists
    against merge_splits_plain, the vote on label lists (C=2, both
    metrics, every kernel function, gaussian at 30 and at 0, which
    scores NaN on a zero distance) and on label lists with sign-bit NaN
    keys (both metrics, every kernel function: a NaN distance scores NaN
    but under none, on the card as in _vote) against _vote of those, each
    bit for bit (a NaN where the plain version has one) and bit-equal on
    a rerun."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools.knn_ab import merge_call

    rng = np.random.default_rng(8)
    nq, n, bad = 300, 0, []
    topk, vote = _build.load("knn_topk"), _build.load("knn_classify")
    scorings = [(metric, fn, param) for metric in ("manhattan", "euclidean")
                for fn, param in [(fn, 30.0) for fn in kk.KERNEL_FNS]
                + [("gaussian", 0.0)]]
    votes = {"labels": scorings, "nan": scorings}
    nan_votes = set()    # the NaN-key scorings whose vote had a NaN
    for splits in (1, 7, 33, 40, 65):
        for k in (5, 8, 13, 16, 32, 50, 64):
            kw = kk._carry_width(k)
            for mode in ("exact", "lanes", "labels", "nan"):
                lists = (*_ragged_lists(rng, splits, nq, kw, mode), splits)
                ref_k, ref_i = kk.merge_splits_plain(lists[0], lists[1], nq,
                                                     splits, k)
                cases = []       # (what, two runs, the plain version's)
                if mode not in votes:
                    cases.append((mode, [merge_call(
                        topk, lists, nq, k, mode, "-", 6, launches=1)()
                        for _ in range(2)], [ref_k, ref_i]))
                for metric, fn, param in votes.get(mode, ()):
                    cases.append((f"{mode} {metric} {fn}({param:g})", [
                        merge_call(vote, lists, nq, k, "labels", metric, 6,
                                   fn, launches=1, kernel_param=param)()
                        for _ in range(2)], [kk._vote(
                            ref_k, 1, 2, 6, metric, fn, param)]))
                torch.cuda.synchronize()
                for what, runs, ref in cases:
                    n += 1
                    if not all(_same(a, b) and _same(a, c, nan_bits=False)
                               for a, b, c in zip(runs[0], runs[1], ref)):
                        bad.append(f"splits={splits}/k={k}/{what}")
                    if mode == "nan" and bool(runs[0][0].isnan().any()):
                        nan_votes.add(what)
    check(not bad, f"merge kernels on ragged lists ({nq} queries, two all "
          f"empty; splits 1/7/33/40/65, k 5..64, exact, lane and label "
          f"keys with ties, sign bits and keys at SENTINEL and INF_BITS; "
          f"votes with gaussian(0) and sign-bit NaN keys under every "
          f"kernel function and both metrics): {n - len(bad)} "
          f"of {n} bit-equal to merge_splits_plain / _vote and on a rerun"
          + (f"; not {bad[:10]}" if bad else ""))
    # a NaN key scores NaN under every kernel function but none
    want = {f"nan {metric} {fn}({param:g})" for metric, fn, param in scorings
            if fn != "none"}
    check(want <= nan_votes, f"votes on sign-bit NaN keys: NaN under "
          f"{len(nan_votes)} scorings, every one but none's of "
          f"{sorted(want)}" + ("" if want <= nan_votes else
                               f"; missing {sorted(want - nan_votes)}"))


def _check_partial_nan() -> None:
    """Features that hold NaN (a missing value parses to NaN) through the
    partial kernel and its merge, each form against the plain version on
    the same card inputs: queries and train rows with NaN and sign-bit
    NaN features, D=6 and D=128, every mode and metric, float32 on the
    CUDA-core form and euclidean bfloat16 on both forms. On the queries
    with a NaN feature the keys, indices and finished distances must be
    the plain version's (NaN counted as NaN: the exact key NAN_KEY, NaN
    finished, index kept; an empty slot in the other modes); on every
    query the slots holding NAN_KEY and their indices must be the plain
    version's, no NaN train row may be taken outside exact mode, and the
    vote's scores must be bit-equal on the NaN queries (all zeros). Under
    manhattan (the same fp32 adds in the same order) every key, index and
    score must be the plain version's."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk

    rng = np.random.default_rng(9)
    nan, neg_nan = (np.uint32(b).view(np.float32)
                    for b in (0x7FC00000, 0xFFC00000))
    found, bad, n = {}, [], 0
    for d in (6, 128):
        q = rng.random((256, d), dtype=np.float32)
        t = rng.random((4096, d), dtype=np.float32)
        # half the queries hold a NaN; 3 train rows, fewer than k, so the
        # other queries' lists hold NaN distances and numbers
        q[::4, 0], q[1::4, d - 1] = neg_nan, nan
        t[[7, 2000], 1], t[3001, d - 2] = neg_nan, nan
        nan_q = torch.from_numpy(np.isnan(q).any(1)).to(DEVICE)
        nan_t = torch.from_numpy(np.flatnonzero(np.isnan(t).any(1))).to(DEVICE)
        qd, td = torch.from_numpy(q).to(DEVICE), torch.from_numpy(t).to(DEVICE)
        labels = torch.from_numpy((np.arange(4096) % 2).astype(np.int32)).to(
            DEVICE)
        nt = td.shape[0]
        for mode in ("exact", "packed", "lanes", "labels"):
            for metric in ("manhattan", "euclidean"):
                euclid = metric == "euclidean"
                forms = ((("float32", False), ("bfloat16", False),
                          ("bfloat16", True)) if euclid
                         else (("float32", False),))
                for dtype, mma in forms:
                    bf16 = dtype == "bfloat16"
                    name = (f"D={d}/{mode}/{metric}/{dtype}/"
                            f"{'tensor-core' if mma else 'CUDA-core'}")
                    n += 1
                    why = _nan_case(kk, mode, qd, td, labels, metric, euclid,
                                    bf16, mma, nt, nan_q, nan_t, found, name)
                    if why:
                        bad.append(f"{name}: {why}")
    check(not bad, f"partial kernel on NaN and sign-bit NaN features (256 x "
          f"4096, D 6 and 128, k={K}): {n - len(bad)} of {n} cases hold the "
          f"plain version's NaN answer; NaN keys and empty slots by case "
          f"{json.dumps(found)}" + (f"; not {bad}" if bad else ""))


def _nan_case(kk, mode, q, t, labels, metric, euclid, bf16, mma, nt, nan_q,
              nan_t, found, name):
    """One case of _check_partial_nan: why it fails, or None."""
    import torch

    if mode == "labels":
        mask, empty = (1 << kk.label_bits(2)) - 1, kk.SENTINEL
        key, _ = kk._select_plain(q, t, K, metric, nt, mode, mask, empty, bf16,
                                  labels)
        want = kk._vote(key, mask, 2, q.shape[1], metric, "gaussian", 30.0)
        got = kk._classify_scores(q, t, labels, K, euclid, bf16, 2,
                                  q.shape[1], "gaussian", 30.0, nt, mma=mma)
        torch.cuda.synchronize()
        found[name] = int((key >= empty).sum())
        if not _same(got[nan_q], want[nan_q]) or got[nan_q].any():
            return "scores of the NaN queries"
        if not euclid and not _same(got, want):
            return "scores"
        return None
    _, mask, empty = kk._key_spec(mode, t)
    pk, pi = kk._select_plain(q, t, K, metric, nt, mode, mask, empty, bf16)
    gk, gi = kk._topk_keys(mode, q, t, K, euclid, bf16, nt, mma=mma)
    torch.cuda.synchronize()
    found[name] = (int((gk == kk.NAN_KEY).sum()), int((gk >= empty).sum()))
    na = q.shape[1]
    gd, gdi = kk._finish(gk, gi, metric, na, mask, empty)
    pd, pdi = kk._finish(pk, pi, metric, na, mask, empty)
    if not (_same(gk[nan_q], pk[nan_q]) and _same(gi[nan_q], pi[nan_q])
            and _same(gd[nan_q], pd[nan_q], nan_bits=False)
            and _same(gdi[nan_q], pdi[nan_q])):
        return "keys, indices or distances of the NaN queries"
    nk = pk == kk.NAN_KEY
    if not (torch.equal(gk == kk.NAN_KEY, nk) and torch.equal(gi[nk], pi[nk])):
        return "NaN slots"
    if mode == "exact" and not nk.any():
        return "no NaN distance taken first"
    if mode != "exact" and torch.isin(gi, nan_t).any():
        return "a NaN train row taken"
    if not euclid and not (_same(gk, pk) and _same(gi, pi)):
        return "keys"
    return None


def _check_mma_shapes() -> None:
    """The tensor-core form at every carry width and mode where its
    blocks, tiles and k-steps are ragged: D from 1 to MAX_D, 300 queries,
    3000 train rows of which 2900 valid; each launch counted on
    knn_partial_mma and within bf16_agrees of the plain version."""
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools import knn_tolerance as tol

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    nv, bad, n = 2900, [], 0
    for d in (1, 6, 37, 128, 129, 300, kk.MAX_D):
        q = torch.randn((300, d), generator=gen, device=DEVICE)
        t = torch.randn((3000, d), generator=gen, device=DEVICE)
        labels = torch.randint(0, 3, (3000,), generator=gen, device=DEVICE,
                               dtype=torch.int32)
        for k in (5, 16, 32, 64):
            for mode in ("exact", "lanes", "packed", "labels"):
                n0 = kk.knn_partial_mma.launches
                if mode == "labels":
                    args = (q, t, labels, k, 3, None, "gaussian", 30.0,
                            "euclidean", nv)
                    new = [kk.knn_classify_lanes(*args,
                                                 compute_dtype="bfloat16")]
                    old = [kk.knn_classify_lanes_plain(
                        *args, compute_dtype="bfloat16")]
                else:
                    new = list(kk._topk_keys(mode, q, t, k, True, True, nv))
                    _, mask, empty = kk._key_spec(mode, t)
                    old = list(kk._select_plain(q, t, k, "euclidean", nv,
                                                mode, mask, empty, True))
                torch.cuda.synchronize()
                why = tol.bf16_agrees(mode, q, t, k, old, new, nv)
                launched = kk.knn_partial_mma.launches - n0
                n += 1
                if why or launched != 1:
                    bad.append(f"D={d}/k={k}/{mode}: {why or launched}")
    check(not bad, f"tensor-core form at 300 x 3000 rows (2900 valid), D "
          f"1..{kk.MAX_D}, k 5/16/32/64, 4 modes: {n - len(bad)} of {n} "
          f"within bf16_agrees of the plain version, one launch each"
          + (f"; not {bad}" if bad else ""))


def phase_sweep():
    """The KNN sweep at its full width; its launch counts."""
    import torch

    from avenir_tpu_torch.tools import knn_sweep

    _reset_launches()
    t0 = time.perf_counter()
    knn_sweep.run(device=DEVICE)
    torch.cuda.synchronize()
    counts = _launch_counts()
    check(counts["knn_partial_mma"] >= 1,
          f"knn_sweep: {time.perf_counter() - t0:.1f}s, launches {counts}; "
          f"its bfloat16 calls took the tensor-core form")
    return counts


# ------------------------------------------------------------------ phase 6
def phase_naive_bayes():
    """bayesianDistr and bayesianPredictor on the card, each against the
    same job with device="cpu"."""
    import torch

    from avenir_tpu_torch import obs
    from avenir_tpu_torch.data import churn_schema, generate_churn
    from avenir_tpu_torch.runner import run_job

    work = ROOT / "build" / "chip_smoke_nb"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    schema = str(work / "churn.json")
    churn_schema().save(schema)
    train, test = work / "train.csv", work / "test.csv"
    t0 = time.perf_counter()
    train.write_text(generate_churn(NB_TRAIN_ROWS, seed=201, as_csv=True))
    test.write_text(generate_churn(NB_TEST_ROWS, seed=202, as_csv=True))
    blocks = -(-train.stat().st_size // (4 << 20))
    print(f"churn CSVs: {NB_TRAIN_ROWS} train rows ({blocks} blocks of 4 MB), "
          f"{NB_TEST_ROWS} test rows, written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    check_ingest(train, churn_schema(), "churn train file")

    def timed(name, props, inputs, out, device, engines):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs.capture() as rec:
            res = run_job(name, props, inputs, str(out), device=device)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _print_split(f"{name} {device}, engine={props['csv.engine']}", rec,
                     engines)
        return res, secs

    # the native parser wherever auto would take it: a failed build fails
    distr = {"bad.feature.schema.file.path": schema,
             "bad.stream.block.size.mb": "4", "csv.engine": "native"}
    models, secs = {}, {}
    for dev, engine in ((DEVICE, "native"), (DEVICE, "python"),
                        ("cpu", "native")):
        key = dev if engine == "native" else f"{dev}_python"
        models[key] = work / f"model_{key}.csv"
        res, secs[key] = timed("bayesianDistr", {**distr, "csv.engine": engine},
                               [str(train)], models[key], dev, [engine])
        check(res.counters["Distribution Data:Records"] == NB_TRAIN_ROWS,
              f"bayesianDistr {dev}, engine={engine}: {secs[key]:.2f}s, "
              f"{res.counters}")
    same = all((work / f"model_{key}.csv{ext}").read_bytes()
               == (work / f"model_cpu.csv{ext}").read_bytes()
               for ext in ("", ".stamp.json")
               for key in (DEVICE, f"{DEVICE}_python"))
    check(same, "bayesianDistr: model file and stamp byte-identical to the "
          "CPU run's under both parsers")
    # the predictor echoes each row: the Python parser, under auto too
    predict = {"bap.feature.schema.file.path": schema, "csv.engine": "python",
               "bap.bayesian.model.file.path": str(models[DEVICE]),
               "bap.validation.mode": "true",
               "bap.positive.class.value": "closed",
               "bap.predict.class.cost": "2,1",
               "bap.predict.class": "open,closed"}
    rows, psecs = {}, {}
    for dev in (DEVICE, "cpu"):
        out = work / f"pred_{dev}.txt"
        res, psecs[dev] = timed("bayesianPredictor", predict, [str(test)],
                                out, dev, ["python"])
        rows[dev] = [ln.rsplit(",", 2)[1:] for ln in
                     out.read_text().splitlines()]
        acc = res.counters["Validation:Accuracy"]
        check(acc > 70 and len(rows[dev]) == NB_TEST_ROWS,
              f"bayesianPredictor {dev}: {psecs[dev]:.2f}s, "
              f"Validation:Accuracy {acc}, {len(rows[dev])} rows, "
              f"{res.counters}")
    classes = sum(a[0] == b[0] for a, b in zip(rows[DEVICE], rows["cpu"]))
    pct = max(abs(int(a[1]) - int(b[1]))
              for a, b in zip(rows[DEVICE], rows["cpu"]))
    check(classes == NB_TEST_ROWS and pct <= 1,
          f"bayesianPredictor: class equal to the CPU run's on {classes} of "
          f"{NB_TEST_ROWS} rows, percent within {pct}")
    shutil.rmtree(work)
    return {"distr_s": secs[DEVICE], "distr_python_s": secs[f"{DEVICE}_python"],
            "distr_cpu_s": secs["cpu"], "predict_s": psecs[DEVICE],
            "predict_cpu_s": psecs["cpu"]}


# ------------------------------------------------------------------ phase 8
def phase_pipeline():
    """`knn_pipeline` (the five stages of resource/knn.sh) on the card,
    stage by stage through `Pipeline.run(only=)`, with the native parser
    where auto would take it and then with the Python parser, and its CPU
    twin on the same CSVs: every file of both card runs byte-identical to
    the twin's. Prints each stage's host-clock split. Returns the first
    card run's launch counts."""
    import torch

    from avenir_tpu_torch import obs
    from avenir_tpu_torch.data import elearn_schema, generate_elearn
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.pipelines import knn_pipeline

    work = ROOT / "build" / "chip_smoke_pipe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    schema = str(work / "elearn.json")
    elearn_schema().save(schema)
    train, test = str(work / "train.csv"), str(work / "test.csv")
    Path(train).write_text(generate_elearn(PIPE_NT, seed=301, as_csv=True))
    Path(test).write_text(generate_elearn(PIPE_NQ, seed=302, as_csv=True))
    # the native parser wherever auto would take it (the feature
    # posteriors echo rows: Python's); the joiner parses its own lines
    props = {"nen.top.match.count": str(K), "nen.validation.mode": "true",
             "nen.class.condtion.weighted": "true", "csv.engine": "native",
             "bap.csv.engine": "python"}
    pairs = PIPE_NT * PIPE_NQ
    counts = None
    runs = ((DEVICE, "native"), (DEVICE, "python"), ("cpu", "native"))
    for dev, engine in runs:
        name = dev if engine == "native" else f"{dev}_python"
        pipe = knn_pipeline({**props, "csv.engine": engine}, train, test,
                            str(work / name), schema_path=schema, device=dev)
        secs = {}
        if name == DEVICE:
            _reset_launches()
        with obs.capture() as rec:
            for st in pipe.stages:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.run(only=st.name)
                torch.cuda.synchronize()
                secs[st.name] = round(time.perf_counter() - t0, 3)
        if name == DEVICE:
            counts = _launch_counts()
        _print_split(f"knn_pipeline {dev}, engine={engine} ({PIPE_NT} x "
                     f"{PIPE_NQ})", rec, [engine, "python"])
        res = pipe.results
        sim = res["similarity"].counters["Similarity:Pairs"]
        join = res["join"].counters["Join:Pairs"]
        acc = res["nearestNeighbor"].counters["Validation:Accuracy"]
        check(sim == join == pairs and acc > 60
              and (name != DEVICE or kk.knn_topk.launches >= 1),
              f"knn_pipeline {dev}, engine={engine} ({PIPE_NT} x {PIPE_NQ}, "
              f"{CARD}): {sum(secs.values()):.2f}s, stage seconds "
              f"{json.dumps(secs)}, Similarity:Pairs {sim}, Join:Pairs {join}, "
              f"Validation:Accuracy {acc}"
              + (f", launches {counts}" if name == DEVICE else ""))
    for name in (DEVICE, f"{DEVICE}_python"):
        same = [f for f in PIPE_FILES if (work / name / f).read_bytes()
                == (work / "cpu" / f).read_bytes()]
        check(len(same) == len(PIPE_FILES), f"knn_pipeline {name}: {same} "
              f"byte-identical to the CPU run's, of {list(PIPE_FILES)}")
    shutil.rmtree(work)
    return counts


# ------------------------------------------------------------------ phase 9
def _span_split(rec, secs: float) -> dict:
    """{span: seconds} of a captured run: `stream.read`, `stream.parse`,
    `stream.fold` by sink, `job.finish`, and `other`, the run's seconds
    none of them covers (these spans do not nest)."""
    out = {}
    for sp in rec.spans():
        if sp.name == "stream.fold":
            key = f"stream.fold:{sp.attrs['sink']}"
        elif sp.name in ("stream.read", "stream.parse", "job.finish"):
            key = sp.name
        else:
            continue
        out[key] = out.get(key, 0.0) + sp.dur
    out["other"] = secs - sum(out.values())
    return {k: round(v, 4) for k, v in out.items()}


def _twin(name, props, inputs, work, what):
    """`name` on the card and on the CPU: (card seconds, CPU seconds), and
    a check that every output file is byte-identical."""
    import torch

    from avenir_tpu_torch.runner import run_job

    outs, secs = {}, {}
    for dev in (DEVICE, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_job(name, props, inputs, str(work / f"{name}_{dev}.txt"),
                      device=dev)
        torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
        outs[dev] = _files_of(res)
    check(outs[DEVICE] == outs["cpu"] and len(outs[DEVICE]) >= 1,
          f"{name} {what} ({CARD}): {secs[DEVICE]:.3f}s on the card, "
          f"{secs['cpu']:.3f}s on the CPU, {res.counters}; outputs "
          f"byte-identical to the CPU twin's")
    return secs


def phase_profile():
    """`profile_pipeline` at 1,000,000 churn rows on the card (plain and
    fused) and on the CPU (fused); the correlation jobs and the
    multi-class NB moments against their CPU twins. Returns the seconds
    of each run."""
    import torch

    from avenir_tpu_torch import obs
    from avenir_tpu_torch.core import stream
    from avenir_tpu_torch.data import (churn_schema, elearn_schema,
                                       generate_churn, generate_elearn,
                                       generate_multiclass, multiclass_schema)
    from avenir_tpu_torch.pipelines import profile_pipeline

    work = ROOT / "build" / "chip_smoke_profile"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    schema = str(work / "churn.json")
    churn_schema().save(schema)
    train = work / "train.csv"
    train.write_text(generate_churn(NB_TRAIN_ROWS, seed=201, as_csv=True))
    n_blocks = -(-train.stat().st_size // (4 << 20))
    props = {f"{p}.stream.block.size.mb": "4" for p in ("bad", "mut", "fid")}
    props.update({"csv.engine": "native",
                  "mut.mutual.info.score.algorithms": MI_ALGOS})
    secs, blocks = {}, {}
    for name, dev, fuse in (("cuda_plain", DEVICE, False),
                            ("cuda_fused", DEVICE, True),
                            ("cpu_fused", "cpu", True)):
        pipe = profile_pipeline(props, str(train), str(work / name),
                                schema_path=schema, device=dev)
        count = [0]
        stream._produce_hook = lambda: count.__setitem__(0, count[0] + 1)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with obs.capture() as rec:
                res = pipe.run(fuse=fuse)
                torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        finally:
            stream._produce_hook = None
        blocks[name] = count[0]
        dispatch = [sp.attrs["jobs"] for sp in rec.spans()
                    if sp.name == "job.dispatch"]
        check(len(res) == 3 and dispatch == (
                  ["bayesianDistr,mutualInformation,fisherDiscriminant"]
                  if fuse else []),
              f"profile_pipeline {name} ({NB_TRAIN_ROWS} churn rows, "
              f"{CARD}): {secs[name]:.3f}s, {blocks[name]} blocks read, "
              f"split by span {json.dumps(_span_split(rec, secs[name]))}, "
              f"counters {json.dumps({k: v.counters for k, v in res.items()})}")
    check(blocks["cuda_plain"] == 3 * n_blocks
          and blocks["cuda_fused"] == blocks["cpu_fused"] == n_blocks,
          f"profile_pipeline: the fused runs read each of the {n_blocks} "
          f"blocks once ({blocks['cuda_fused']}, {blocks['cpu_fused']}), "
          f"the plain run three times ({blocks['cuda_plain']})")
    same = [f for f in PROFILE_FILES
            if (work / "cuda_plain" / f).read_bytes()
            == (work / "cuda_fused" / f).read_bytes()
            == (work / "cpu_fused" / f).read_bytes()]
    check(same == list(PROFILE_FILES),
          f"profile_pipeline: {same} byte-identical across the plain and "
          f"fused card runs and the CPU twin, of {list(PROFILE_FILES)}")
    busy = _device_busy(lambda: profile_pipeline(
        props, str(train), str(work / "profiled"), schema_path=schema,
        device=DEVICE).run(fuse=True))
    check(busy["device_s"] > 0, f"profile_pipeline fused under "
          f"torch.profiler ({CARD}): {json.dumps(busy)}")
    corr = {"crc.feature.schema.file.path": schema,
            "hrc.feature.schema.file.path": schema,
            "crc.stream.block.size.mb": "4", "hrc.stream.block.size.mb": "4",
            "csv.engine": "native"}
    secs["cramerCorrelation"] = _twin("cramerCorrelation", corr, [str(train)],
                                      work, f"({NB_TRAIN_ROWS} churn rows)")
    secs["heterogeneityReduction"] = _twin(
        "heterogeneityReduction", corr, [str(train)], work,
        f"({NB_TRAIN_ROWS} churn rows)")
    elearn = work / "elearn.csv"
    elearn.write_text(generate_elearn(NT, seed=101, as_csv=True))
    eschema = str(work / "elearn.json")
    elearn_schema().save(eschema)
    secs["numericalCorrelation"] = _twin(
        "numericalCorrelation", {"nuc.feature.schema.file.path": eschema,
                                 "csv.engine": "native"},
        [str(elearn)], work, f"({NT} e-learning rows)")
    for k, fc in MOMENT_SHAPES:
        mschema = str(work / f"multi{k}x{fc}.json")
        multiclass_schema(k, fc).save(mschema)
        data = work / f"multi{k}x{fc}.csv"
        data.write_text(generate_multiclass(MOMENT_ROWS, k, fc,
                                            seed=400 + fc, as_csv=True))
        secs[f"bayesianDistr_{k}cls_{fc}cont"] = _twin(
            "bayesianDistr", {"bad.feature.schema.file.path": mschema,
                              "csv.engine": "native"},
            [str(data)], work, f"({MOMENT_ROWS} rows, {k} classes, {fc} "
            f"continuous field{'s' if fc > 1 else ''}, "
            f"{data.stat().st_size} bytes)")
    shutil.rmtree(work)
    return {k: (round(v, 3) if isinstance(v, float)
                else {d: round(t, 3) for d, t in v.items()})
            for k, v in secs.items()}


# ----------------------------------------------------------------- phase 10
def _text_corpus(lines: int, seed: int) -> str:
    """`text,classVal` lines: 8-20 tokens each from a TEXT_VOCAB-word
    vocabulary, about one in six a stop word, each class leaning on its
    own quarter of the vocabulary."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(TEXT_VOCAB)]
                     + ["the", "and", "a", "of", "is", "to", "in", "it"])
    cls = rng.integers(0, TEXT_CLASSES, lines)
    length = rng.integers(8, 21, lines)
    lean = rng.random((lines, 20)) < 0.4
    quarter = TEXT_VOCAB // TEXT_CLASSES
    idx = np.where(lean, cls[:, None] * quarter
                   + rng.integers(0, quarter, (lines, 20)),
                   rng.integers(0, TEXT_VOCAB, (lines, 20)))
    idx = np.where(rng.random((lines, 20)) < 1 / 6,
                   TEXT_VOCAB + rng.integers(0, 8, (lines, 20)), idx)
    toks = words[idx]
    return "".join(" ".join(toks[i, :length[i]]) + f",c{cls[i]}\n"
                   for i in range(lines))


#: the profiler ranges the tree module marks
RANGES = ("tree::level_histogram", "tree::path_match")


def _us(ev, *names) -> float:
    """The first of a profiler event's time attributes that it has (their
    names moved from cuda_* to device_* across torch versions)."""
    for name in names:
        if hasattr(ev, name):
            return getattr(ev, name)
    return 0.0


def _annotated_device_s(prof, label: str) -> dict:
    """Device seconds under a record_function range: the kernels its ops
    launched (`kernels_s`), and the range's span on the device timeline
    (`span_s`); None where the profiler gives none."""
    kern = span = 0.0
    for ev in prof.events():
        if ev.name != label:
            continue
        if str(ev.device_type).endswith("CPU"):
            kern += _us(ev, "device_time_total", "cuda_time_total")
        else:
            span += _us(ev, "device_time_total", "cuda_time_total") \
                or ev.time_range.elapsed_us()
    return {"kernels_s": kern / 1e6 if kern else None,
            "span_s": span / 1e6 if span else None}


def phase_tree_text():
    """decision_tree_pipeline (decTree and the forest), dataPartitioner
    and classPartitionGenerator on 1,000,000 call-hangup rows, the
    forest's device and host predict, and the text jobs, each on the
    card against its CPU twin. Returns the seconds of each run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avenir_tpu_torch import obs
    from avenir_tpu_torch.core.dataset import Dataset
    from avenir_tpu_torch.data import call_hangup_schema, generate_call_hangup
    from avenir_tpu_torch.models import tree
    from avenir_tpu_torch.pipelines import decision_tree_pipeline
    from avenir_tpu_torch.runner import run_job

    work = ROOT / "build" / "chip_smoke_tree"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    schema = str(work / "call_hangup.json")
    call_hangup_schema().save(schema)
    train = work / "train.csv"
    t0 = time.perf_counter()
    base = generate_call_hangup(TREE_BASE_ROWS, seed=5, as_csv=True)
    train.write_text(base * TREE_COPIES)
    rows = TREE_BASE_ROWS * TREE_COPIES
    print(f"call-hangup CSV: {rows} rows ({train.stat().st_size} bytes), "
          f"written in {time.perf_counter() - t0:.1f}s", flush=True)
    secs = {}

    def timed(what, dev, run, n=rows, unit="rows"):
        """run(dev), its seconds ended by a synchronise, and its split by
        span."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs.capture() as rec:
            out = run(dev)
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        secs.setdefault(what, {})[dev] = round(sec, 3)
        print(f"{what} {dev} ({n} {unit}, {CARD}): {sec:.3f}s, split by "
              f"span {json.dumps(_span_split(rec, sec))}", flush=True)
        return out

    props = {"dtb.max.depth.limit": str(RF_DEPTH),
             "dtb.split.algorithm": "entropy", "csv.engine": "native",
             "dtb.num.trees": str(RF_TREES),
             "dtb.sub.sampling.strategy": "withReplace"}
    for forest in (False, True):
        what = "randomForest" if forest else "decTree"
        calls = {}
        for dev in (DEVICE, "cpu"):
            before = tree._level_histogram_forest.calls
            res = timed(what, dev, lambda d: decision_tree_pipeline(
                props, str(train), str(work / f"{what}_{d}"),
                schema_path=schema, forest=forest, device=d).run())
            calls[dev] = tree._level_histogram_forest.calls - before
        outs = [Path(p) for p in res["decTree"].outputs]
        same = [p.name for p in outs
                if p.read_bytes() == (work / f"{what}_{DEVICE}" / p.relative_to(
                    work / f"{what}_cpu")).read_bytes()]
        depth = max(len(path["predicates"] or [])
                    for p in outs for path in
                    json.loads(p.read_text())["decisionPaths"])
        # a level's histogram, and the final one: one call for the whole
        # forest (a call a tree would make RF_TREES times as many)
        check(len(same) == len(outs) == (RF_TREES if forest else 1)
              and calls[DEVICE] == calls["cpu"] <= RF_DEPTH + 1,
              f"decision_tree_pipeline {what}: {same} byte-identical to the "
              f"CPU twin's; trees {depth} levels deep; {calls[DEVICE]} "
              f"histogram calls for the {RF_TREES if forest else 1} "
              f"tree{'s' if forest else ''}, one a level and the final "
              f"distributions")

    dap = {"dap.feature.schema.file.path": schema}
    for dev in (DEVICE, "cpu"):
        res = timed("dataPartitioner", dev, lambda d: run_job(
            "dataPartitioner", dap, [str(train)], str(work / f"dap_{d}"),
            device=d))
    segs = [Path(p) for p in res.outputs]
    same = [str(p.relative_to(work / "dap_cpu")) for p in segs
            if p.read_bytes() == (work / f"dap_{DEVICE}" / p.relative_to(
                work / "dap_cpu")).read_bytes()]
    check(len(same) == len(segs) >= 2, f"dataPartitioner: {same} "
          f"byte-identical to the CPU twin's")

    cpg = {"cpg.feature.schema.file.path": schema, "csv.engine": "native",
           "cpg.split.algorithm": "entropy"}
    stats = {}
    for dev in (DEVICE, "cpu"):
        res = timed("classPartitionGenerator", dev, lambda d: run_job(
            "classPartitionGenerator", cpg, [str(train)],
            str(work / f"cpg_{d}.txt"), device=d))
        stats[dev] = [ln.split(",") for ln in
                      Path(res.outputs[0]).read_text().splitlines()]
    worst = max(abs(float(a[2]) - float(b[2]))
                for a, b in zip(stats[DEVICE], stats["cpu"]))
    best = {d: min(v, key=lambda r: float(r[2]))[:2] for d, v in stats.items()}
    check([r[:2] for r in stats[DEVICE]] == [r[:2] for r in stats["cpu"]]
          and worst <= 1e-6 and best[DEVICE] == best["cpu"],
          f"classPartitionGenerator: {len(stats[DEVICE])} split stats within "
          f"1e-6 of the CPU twin's (at most {worst:.1e}), best split "
          f"{best[DEVICE]} on both")

    # the forest's device and host predict on every row
    ds = Dataset.from_csv(str(train), call_hangup_schema(), engine="native")
    rf = tree.RandomForestBuilder(ds.schema, num_trees=RF_TREES,
                                  max_depth=RF_DEPTH, sampling="withReplace",
                                  seed=2, device=DEVICE).fit(ds)
    dev_pred = timed("forest predict", "device=True",
                     lambda d: rf.predict(ds, device=True))
    host_pred = timed("forest predict", "device=False",
                      lambda d: rf.predict(ds, device=False))
    check(dev_pred.shape == host_pred.shape == (rows,)
          and bool((dev_pred == host_pred).all()),
          f"RandomForestBuilder.predict: device=True equals device=False on "
          f"all {rows} rows")

    # the forest again under the profiler, with its predict; the tree
    # module marks its level histogram and path match as ranges
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            obs.capture() as rec:
        t0 = time.perf_counter()
        run_job("randomForest",
                {**props, "dtb.feature.schema.file.path": schema},
                [str(train)], str(work / "profiled"), device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        rf.predict(ds, device=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = copy = 0.0
    by_kernel = []
    for ev in prof.key_averages():
        # the ranges' own device-side spans are not kernels: leave them
        # out, or their kernels would count twice
        if not str(ev.device_type).endswith("CUDA") or ev.key in RANGES:
            continue
        us = _us(ev, "self_device_time_total", "self_cuda_time_total")
        by_kernel.append((round(us / 1e3, 3), ev.count, ev.key[:72]))
        if ev.key.startswith(("Memcpy", "Memset")):
            copy += us
        else:
            kern += us
    busy = {"fit_and_predict_s": round(wall, 4), "fit_s": round(fit_s, 4),
            "kernel_s": kern / 1e6, "device_s": (kern + copy) / 1e6,
            "device_busy_share": (kern + copy) / 1e6 / wall,
            **{f"{label.split('::')[1]}_device_s":
               _annotated_device_s(prof, label) for label in RANGES},
            "split": _span_split(rec, wall),
            "top_device_ms_count_name": sorted(by_kernel, reverse=True)[:6]}
    check(busy["device_s"] > 0, f"randomForest fit and device predict under "
          f"torch.profiler ({CARD}): {json.dumps(busy)}")
    secs["forest_profiled"] = busy

    # the text jobs
    text = work / "text.txt"
    t0 = time.perf_counter()
    text.write_text(_text_corpus(TEXT_LINES, seed=31))
    print(f"text corpus: {TEXT_LINES} lines ({text.stat().st_size} bytes), "
          f"written in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, jprops in (("wordCounter", {"wco.text.field.ordinal": "0"}),
                         ("bayesianDistr", {"bad.tabular.input": "false"})):
        outs = {}
        for dev in (DEVICE, "cpu"):
            res = timed(f"{name} text", dev, lambda d: run_job(
                name, jprops, [str(text)], str(work / f"{name}_{d}.txt"),
                device=d), TEXT_LINES, "lines")
            outs[dev] = Path(res.outputs[0]).read_bytes()
        check(outs[DEVICE] == outs["cpu"] and len(outs[DEVICE]) > 0,
              f"{name} on the text corpus: {res.counters}, output "
              f"byte-identical to the CPU twin's")
    shutil.rmtree(work)
    return secs


# ----------------------------------------------------------------- phase 11
def _range_calls_s(prof, label: str) -> list:
    """The device seconds of the kernels and copies under each call of a
    record_function range, in call order."""
    return [_us(ev, "device_time_total", "cuda_time_total") / 1e6
            for ev in prof.events()
            if ev.name == label and str(ev.device_type).endswith("CPU")]


def _kernel_s_by_range(prof, label: str, kernel: str) -> list:
    """The device seconds of the kernels whose name holds `kernel` that
    start inside each call of the range `label`, in call order: a kernel
    launched through a C entry is no torch op's, so the range's own
    device time leaves it out (each range here ends in a read of its
    counts, so its kernels finish inside it)."""
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.name == label and str(ev.device_type).endswith("CPU")]
    kern = [(ev.time_range.start, ev.time_range.elapsed_us())
            for ev in prof.events() if kernel in ev.name
            and str(ev.device_type).endswith("CUDA")]
    return [sum(d for t, d in kern if a <= t <= b) / 1e6 for a, b in spans]


def _profiled(what: str, run, label: str, kernel: str = None) -> tuple:
    """run() on the card under torch.profiler and the span recorder: its
    result, and a dict of its seconds, split by span, device busy share
    and the device seconds of each call of the range `label` (and of
    the kernels named `kernel` in each call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avenir_tpu_torch import obs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            obs.capture() as rec:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    kern = copy = 0.0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA") or ev.key == label:
            continue
        us = _us(ev, "self_device_time_total", "self_cuda_time_total")
        if ev.key.startswith(("Memcpy", "Memset")):
            copy += us
        else:
            kern += us
    rounds = _range_calls_s(prof, label)
    info = {"seconds": round(secs, 4), "kernel_s": kern / 1e6,
            "device_s": (kern + copy) / 1e6,
            "device_busy_share": (kern + copy) / 1e6 / secs,
            "round_device_s": rounds, "round_wall_s": [
                ev.time_range.elapsed_us() / 1e6 for ev in prof.events()
                if ev.name == label and str(ev.device_type).endswith("CPU")],
            "split": _span_split(rec, secs)}
    if kernel is not None:
        info["round_kernel_s"] = _kernel_s_by_range(prof, label, kernel)
        info["all_kernel_s"] = sum(
            _us(ev, "self_device_time_total", "self_cuda_time_total")
            for ev in prof.key_averages() if kernel in ev.key
            and str(ev.device_type).endswith("CUDA")) / 1e6
    _print_split(what, rec)
    return out, info


def _itemsets(outputs) -> dict:
    return {Path(p).name: Path(p).read_bytes() for p in outputs}


def phase_association():
    """The association path on 1,000,000 market baskets: in RAM and
    streamed on the card against the CPU twin, the marker, rules,
    transaction ids and the shared scan, every file byte-identical.
    Returns the seconds and measurements of the runs."""
    import numpy as np
    import torch

    from avenir_tpu_torch.models import association
    from avenir_tpu_torch.ops import bitset
    from avenir_tpu_torch.pipelines import association_pipeline
    from avenir_tpu_torch.runner import run_job, run_shared
    from avenir_tpu_torch.tools import bench

    work = ROOT / "build" / "chip_smoke_assoc"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    picks = bench.apriori_picks(ASSOC_TX, seed=4)
    lines = [",".join([f"T{r}", *(f"i{j}" for j in row)]) + "\n"
             for r, row in enumerate(picks.tolist())]
    corpus = {}
    for name, rows in (("baskets", ASSOC_TX), ("twin", ASSOC_TWIN_TX),
                       ("tids", ASSOC_TIDS_TX)):
        corpus[name] = work / f"{name}.csv"
        corpus[name].write_text("".join(lines[:rows]))
    del lines
    print(f"basket CSV: {ASSOC_TX} transactions "
          f"({corpus['baskets'].stat().st_size} bytes), written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    csv = str(corpus["baskets"])
    stream = {**ASSOC_PROPS, **ASSOC_BLOCK}
    secs, files = {}, {}

    def timed(what, dev, run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs[what] = {**secs.get(what, {}),
                      dev: round(time.perf_counter() - t0, 3)}
        return out

    # in RAM: the pipeline (apriori, then rules) on the card and the CPU
    pipe, secs["ram_card"] = _profiled(
        "association_pipeline on the card", lambda: association_pipeline(
            ASSOC_PROPS, csv, str(work / "pipe_card"), device=DEVICE).run(),
        association.SUPPORT_RANGE)
    twin = timed("association_pipeline", "cpu", lambda: association_pipeline(
        ASSOC_PROPS, csv, str(work / "pipe_cpu"), device="cpu").run())
    files["ram"] = _itemsets(pipe["apriori"].outputs)
    levels = [association.ItemSetList.load(p, k) for k, p in
              enumerate(pipe["apriori"].outputs, start=1)]
    cands = []
    for k in range(2, int(ASSOC_PROPS["fia.item.set.length"]) + 1):
        if k - 2 >= len(levels):
            break
        n = len(association._generate_candidates(
            [s.items for s in levels[k - 2].item_sets], k))
        if not n:
            break
        cands.append({"k": k, "candidates": n,
                      "c_pad": association._c_pad(n)})
    check(files["ram"] == _itemsets(twin["apriori"].outputs)
          and len(files["ram"]) == 3
          and _itemsets(pipe["rules"].outputs)
          == _itemsets(twin["rules"].outputs)
          and pipe["rules"].counters["Rules:Count"] > 0
          and len(secs["ram_card"]["round_device_s"]) == len(cands),
          f"association_pipeline ({ASSOC_TX} transactions, {CARD}): "
          f"{pipe['apriori'].counters}, {pipe['rules'].counters}; itemsets "
          f"and rules.txt byte-identical to the CPU twin's (CPU "
          f"{secs['association_pipeline']['cpu']}s); rounds {cands}; "
          f"{json.dumps(secs['ram_card'])}")

    # streamed in 4 MB blocks on the card; the twin streams the prefix
    res, secs["stream_card"] = _profiled(
        "frequentItemsApriori streamed on the card", lambda: run_job(
            "frequentItemsApriori", stream, [csv],
            str(work / "stream_card"), device=DEVICE),
        association.SUPPORT_RANGE)
    check(_itemsets(res.outputs) == files["ram"]
          and len(secs["stream_card"]["round_device_s"]) == len(cands),
          f"frequentItemsApriori streamed ({CARD}): {res.counters}; "
          f"itemsets byte-identical to the in-RAM run's; "
          f"{json.dumps(secs['stream_card'])}")
    prefix = {}
    for dev in (DEVICE, "cpu"):
        res = timed("streamed 100,000 rows", dev, lambda: run_job(
            "frequentItemsApriori", stream, [str(corpus["twin"])],
            str(work / f"twin_{dev}"), device=dev))
        prefix[dev] = _itemsets(res.outputs)
    check(prefix[DEVICE] == prefix["cpu"] and len(prefix["cpu"]) == 3,
          f"frequentItemsApriori streamed on {ASSOC_TWIN_TX} rows: "
          f"byte-identical to the CPU twin's ({secs['streamed 100,000 rows']}"
          f" s)")

    # the marker on the prefix, then Apriori over the marked rows
    marked = timed("infrequentItemMarker", DEVICE, lambda: run_job(
        "infrequentItemMarker",
        {"iim.item.set.file.path": str(work / "twin_cpu" / "itemsets-1.txt"),
         "iim.contains.trans.id": "false"}, [str(corpus["twin"])],
        str(work / "marked.csv"), device=DEVICE))
    res = timed("apriori marked", DEVICE, lambda: run_job(
        "frequentItemsApriori", {**stream, "fia.infreq.item.marker": "*"},
        marked.outputs, str(work / "marked"), device=DEVICE))
    check(_itemsets(res.outputs) == prefix["cpu"]
          and marked.counters["Marker:Replaced"] > 0,
          f"infrequentItemMarker on {ASSOC_TWIN_TX} rows {marked.counters}, "
          f"then Apriori with the marker: itemsets byte-identical to the "
          f"unmarked run's ({secs['infrequentItemMarker']}, "
          f"{secs['apriori marked']} s)")

    # transaction ids, both routes on both devices
    tids = {}
    for route, extra in (("ram", {}), ("streamed", ASSOC_BLOCK)):
        for dev in (DEVICE, "cpu"):
            res = timed(f"trans ids {route}", dev, lambda: run_job(
                "frequentItemsApriori",
                {**ASSOC_PROPS, **extra, "fia.emit.trans.id": "true"},
                [str(corpus["tids"])], str(work / f"tids_{route}_{dev}"),
                device=dev))
            tids[(route, dev)] = _itemsets(res.outputs)
    longest = max(len(ln) for ln in
                  tids[("ram", "cpu")]["itemsets-1.txt"].splitlines())
    check(len({json.dumps({k: v.decode() for k, v in t.items()},
                          sort_keys=True) for t in tids.values()}) == 1,
          f"fia.emit.trans.id on {ASSOC_TIDS_TX} rows: in RAM and streamed, "
          f"card and CPU, byte-identical (longest line {longest} bytes; "
          f"{ {k: v for k, v in secs.items() if k.startswith('trans')} })")

    # one shared scan of the prefix
    shared = timed("run_shared", DEVICE, lambda: run_shared(
        [("frequentItemsApriori", stream, str(work / "shared"))],
        [str(corpus["twin"])], device=DEVICE))
    check(_itemsets(shared["frequentItemsApriori"].outputs) == prefix["cpu"],
          f"run_shared([frequentItemsApriori]) on {ASSOC_TWIN_TX} rows: "
          f"byte-identical to run_job ({secs['run_shared']} s)")

    # the two forms of the bit-packed overlap on a block of the corpus
    freq = sorted(int(s.items[0][1:]) for s in levels[0].item_sets)
    mh = np.zeros((8192, 100), np.uint8)
    mh[np.arange(8192)[:, None], picks[:8192]] = 1
    trans = bitset.as_words(bitset.pack_rows_u32(mh[:, freq]), DEVICE)
    remap = {c: m for m, c in enumerate(freq)}
    pairs = [(remap[int(a[1:])], remap[int(b[1:])]) for a, b in
             association._generate_candidates(
                 [s.items for s in levels[0].item_sets], 2)]
    cand = bitset.as_words(bitset.pack_index_rows_u32(
        pairs, len(freq), association._c_pad(len(pairs))), DEVICE)
    b = bitset.bitset_contain_counts(trans, cand)
    a = bitset.bitset_contain_counts(trans, cand, words=True)
    want = [int(mh[:, [freq[i] for i in pr]].all(axis=1).sum())
            for pr in pairs]
    forms = {"block": list(trans.shape), "candidates": list(cand.shape),
             "unpacked_matmul_ms": cuda_ms(
                 lambda: bitset.bitset_contain_counts(trans, cand), 20),
             "word_popcount_ms": cuda_ms(
                 lambda: bitset.bitset_contain_counts(trans, cand,
                                                      words=True), 20)}
    check(torch.equal(a, b) and b[:len(pairs)].tolist() == want
          and not b[len(pairs):].any(),
          f"bit-packed overlap on the card ({CARD}): unpacked bits through "
          f"one matmul equal to the word-by-word popcount and to the "
          f"multi-hot oracle; {json.dumps(forms)}")
    secs["overlap_forms"] = forms

    # the bench's Apriori section
    t0 = time.perf_counter()
    row = bench.bench_apriori(torch.device(DEVICE), bench.APRIORI_TX)
    check(row["apriori_rounds"] == 3 and row["apriori_frequent_sets"] > 0,
          f"bench Apriori section ({bench.APRIORI_TX} transactions, {CARD}): "
          f"{json.dumps(row)} in {time.perf_counter() - t0:.1f}s")
    secs["bench"] = row
    shutil.rmtree(work)
    return secs


# ----------------------------------------------------------------- phase 12
def _sequence_corpus(work: Path) -> tuple:
    """The GSP corpus as `s<i>,e<j>,...` lines, and its first
    GSP_TWIN_ROWS lines, written under `work`."""
    from avenir_tpu_torch.data import generate_token_sequences

    t0 = time.perf_counter()
    lines = generate_token_sequences(GSP_ROWS, vocab=GSP_VOCAB,
                                     seed=GSP_SEED)
    csv, twin = work / "seq.csv", work / "twin.csv"
    csv.write_text("\n".join(lines) + "\n")
    twin.write_text("\n".join(lines[:GSP_TWIN_ROWS]) + "\n")
    print(f"sequence CSV: {GSP_ROWS} sequences ({csv.stat().st_size} "
          f"bytes), written in {time.perf_counter() - t0:.1f}s", flush=True)
    return str(csv), str(twin)


def _gsp_levels(outputs) -> list:
    """The frequent sequences of each length, from sequences-<k>.txt."""
    return [[tuple(ln.split(",")[:-1]) for ln in
             Path(p).read_text().splitlines()] for p in sorted(outputs)]


def _gsp_kernel_row(src, block, levels, k, flops, rate) -> dict:
    """The kernel against its plain version on one streamed block and
    round k's candidates, as the streamed round folds them (the real
    candidates, not the pad rows up to c_pad), on the mask route and on
    the walk route: equal counts, their CUDA-event times in turns, the
    mask route's bound from the lookups it makes and the walk route's
    from the compares its walks make."""
    import torch

    from avenir_tpu_torch.models import sequence
    from avenir_tpu_torch.ops import sequence_kernels as sk

    cands = sequence.generate_sequence_candidates(levels[k - 2])
    n, c_pad = len(cands), sequence._c_pad(len(cands))
    cand, kv, n_codes = sequence.GSPMiner._cand_arrays(
        cands, src.token_code, c_pad, DEVICE)
    cand, kv = cand[:n], kv[:n]
    t, kmax = block.shape[1], cand.shape[1]
    routes = {"mask": n_codes, "walk": SUBSEQ_WALK_CODES}
    found = {r: sk.route(t, kmax, codes) for r, codes in routes.items()}
    accs = {r: torch.zeros(n, dtype=torch.int32, device=DEVICE)
            for r in routes}
    for r, codes in routes.items():
        sk.subseq_support_fold(accs[r], block, cand, kv, codes)
    plain, plain_ms = _timed_once(
        lambda: sk.subseq_support_plain(block, cand, kv))
    times = {r: [] for r in routes}
    for r in ("walk", "mask", "mask", "walk"):
        times[r].append(cuda_ms(lambda: sk.subseq_support_fold(
            accs[r], block, cand, kv, routes[r]), 10))
    for r, codes in routes.items():
        accs[r].zero_()
        sk.subseq_support_fold(accs[r], block, cand, kv, codes)
    torch.cuda.synchronize()
    lookups = sk.lookup_steps(block, cand, kv)
    steps = sk.walk_steps(block, cand, kv)
    nbytes = 4 * (block.numel() + cand.numel() + kv.numel() + 2 * n)
    # 64 INT32 lanes an SM against 128 FP32 lanes, an FMA counted twice:
    # a lookup (or a compare) at the int32 rate
    t_lookup, t_walk = lookups / (flops / 4), steps / (flops / 4)
    t_bytes = nbytes / rate
    ms = sum(times["mask"]) / 2
    walk_ms = sum(times["walk"]) / 2
    row = {"k": k, "block": list(block.shape), "candidates": n,
           "c_pad": c_pad, "n_codes": n_codes, "routes": found,
           "lookup_steps": lookups, "walk_steps": steps,
           "max_abs_err": int((accs["mask"] - plain).abs().max()), "ms": ms,
           "mask_ms": times["mask"], "walk_route_ms": walk_ms,
           "walk_ms": times["walk"], "plain_ms": plain_ms,
           "bound_ms": max(t_lookup, t_bytes) * 1e3,
           "bound_by": "operations" if t_lookup >= t_bytes else "bytes",
           "lookup_bound_ms": t_lookup * 1e3,
           "walk_bound_ms": max(t_walk, t_bytes) * 1e3,
           "library_ms": None}
    row["bound_share"] = row["bound_ms"] / ms
    row["walk_bound_share"] = row["walk_bound_ms"] / walk_ms
    row["walk_bound_share_of_mask"] = row["walk_bound_ms"] / ms
    check(all(torch.equal(a, plain) for a in accs.values())
          and int(plain.sum()) > 0 and found["mask"] != "walk"
          and found["walk"] == "walk" and ms < walk_ms,
          f"subseq_support at round {k} on a streamed block ({CARD}): "
          f"counts equal to the plain version's on the {found['mask']} "
          f"route ({ms:.4f} ms; the lookup bound {row['lookup_bound_ms']:.4f} "
          f"ms, {row['bound_share']:.1%} of it) and on the walk route "
          f"({walk_ms:.4f} ms; the compare bound {row['walk_bound_ms']:.4f} "
          f"ms, {row['walk_bound_share']:.1%}); the mask route bound by "
          f"{row['bound_by']}; {json.dumps(row)}")
    return row


def _check_subseq_edges() -> None:
    """Both routes against the plain version on seeded edge cases at each
    width of SUBSEQ_EDGE_WIDTHS: rows with pads inside and at the end, a
    row of one token repeated, a row of pads, tokens above the code
    range; candidates with a repeated code, the top code of the range,
    lengths past the code width, 0 and -1, negative codes."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import sequence_kernels as sk

    cases, routes, apart = 0, set(), []
    for t in SUBSEQ_EDGE_WIDTHS:
        for seed, (n, c, kmax, v) in enumerate(((3000, 700, 4, 20),
                                                (5000, 300, 8, 40),
                                                (997, 257, 2, 9))):
            rng = np.random.default_rng(1000 * t + seed)
            lens = rng.integers(0, t + 1, n)
            rows = rng.integers(0, v + 3, (n, t)).astype(np.int32)
            rows[np.arange(t)[None, :] >= lens[:, None]] = -1
            rows[rng.random((n, t)) < 0.05] = -1
            rows[0], rows[1] = -1, 2
            cands = rng.integers(0, v, (c, kmax)).astype(np.int32)
            cands[rng.random((c, kmax)) < 0.05] = -2
            cands[0, :2] = (3, 3)
            cands[1, 0] = v - 1
            kv = rng.integers(-1, kmax + 2, c).astype(np.int32)
            kv[:2] = (2, 1)
            r, cd, k = (torch.from_numpy(a).to(DEVICE)
                        for a in (rows, cands, kv))
            want = sk.subseq_support_plain(r, cd, k)
            for codes in (v, SUBSEQ_WALK_CODES):
                acc = torch.zeros(c, dtype=torch.int32, device=DEVICE)
                sk.subseq_support_fold(acc, r, cd, k, codes)
                torch.cuda.synchronize()
                routes.add(sk.route(t, kmax, codes))
                if not torch.equal(acc, want) or int(want.sum()) == 0:
                    apart.append((t, n, c, kmax, codes))
                cases += 1
    check(not apart and routes == {"mask32", "mask64", "walk"},
          f"subseq_support ({CARD}): {cases - len(apart)} of {cases} edge "
          f"cases equal to the plain version's on the routes "
          f"{sorted(routes)}" + (f"; apart (t, n, c, kmax, n_codes): "
                                 f"{apart}" if apart else ""))


def phase_sequence(flops: float, rate: float):
    """The sequence path: GSP in RAM and streamed on the card, the CPU twin
    on a prefix, the kernel against its plain version on a round-2 and a
    round-3 block, then the positional-cluster and sequence-generator
    jobs against their twins. Returns (seconds and measurements, the
    path's launch counts, the kernel's round-2 row)."""
    import numpy as np
    import torch

    from avenir_tpu_torch.models import sequence
    from avenir_tpu_torch.ops import sequence_kernels as sk
    from avenir_tpu_torch.runner import run_job

    work = ROOT / "build" / "chip_smoke_gsp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    csv, twin = _sequence_corpus(work)
    secs = {}
    info = sk.subseq_support_info()
    check(all(local == 0 for _, local in info.values()),
          f"subseq_support: (registers, local bytes) a thread of each "
          f"kernel {json.dumps(info)}")
    _check_subseq_edges()

    # the path: in RAM, then streamed in 4 MB blocks, on the card
    _reset_launches()
    ram, secs["ram_card"] = _profiled(
        "candidateGenerationWithSelfJoin in RAM on the card",
        lambda: run_job("candidateGenerationWithSelfJoin", GSP_PROPS, [csv],
                        str(work / "ram"), device=DEVICE),
        sequence.SUPPORT_RANGE, "subseq_support")
    stream, secs["stream_card"] = _profiled(
        "candidateGenerationWithSelfJoin streamed on the card",
        lambda: run_job("candidateGenerationWithSelfJoin",
                        {**GSP_PROPS, **GSP_BLOCK}, [csv],
                        str(work / "stream"), device=DEVICE),
        sequence.SUPPORT_RANGE, "subseq_support")
    counts = _launch_counts()
    files = _itemsets(ram.outputs)
    levels = _gsp_levels(ram.outputs)
    rounds = [{"k": 1, "candidates": GSP_VOCAB}]
    for k in range(2, len(levels) + 1):
        n = len(sequence.generate_sequence_candidates(levels[k - 2]))
        rounds.append({"k": k, "candidates": n,
                       "c_pad_streamed": sequence._c_pad(n)})
    for r, s in zip(rounds, secs["ram_card"]["round_kernel_s"]):
        r["ram_kernel_s"] = s
    for r, s in zip(rounds[1:], secs["stream_card"]["round_kernel_s"]):
        r["stream_kernel_s"] = s
    check(files == _itemsets(stream.outputs) and len(files) == 3
          and counts["subseq_support_fold"] >= 1
          and len(secs["ram_card"]["round_kernel_s"]) == 3
          and len(secs["stream_card"]["round_kernel_s"]) == 2,
          f"candidateGenerationWithSelfJoin on {GSP_ROWS} sequences "
          f"({CARD}): in RAM {ram.counters}, streamed {stream.counters}; "
          f"sequences-k.txt byte-identical; subseq_support launched "
          f"{counts['subseq_support_fold']}x; rounds {json.dumps(rounds)}; "
          f"{json.dumps(secs)}")

    # the CPU twin on the prefix
    twin_files = {}
    for dev in (DEVICE, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_job("candidateGenerationWithSelfJoin", GSP_PROPS, [twin],
                      str(work / f"twin_{dev}"), device=dev)
        torch.cuda.synchronize()
        secs[f"twin_{dev}"] = round(time.perf_counter() - t0, 3)
        twin_files[dev] = _itemsets(res.outputs)
    check(twin_files[DEVICE] == twin_files["cpu"]
          and len(twin_files["cpu"]) == 3,
          f"candidateGenerationWithSelfJoin on {GSP_TWIN_ROWS} sequences: "
          f"byte-identical to the CPU twin's ({secs['twin_' + DEVICE]}s on "
          f"the card, {secs['twin_cpu']}s on the CPU)")

    # the kernel against its plain version on the first streamed block
    src = sequence.StreamingSequenceSource([csv], block_bytes=4 << 20)
    src.scan()
    src.mask_tokens([src.index[t] for (t,) in levels[0]])
    block = torch.from_numpy(next(iter(src.chunks(65536)))).to(DEVICE)
    rows = [_gsp_kernel_row(src, block, levels, k, flops, rate)
            for k in (2, 3)]
    secs["kernel"] = rows

    # the positional-cluster and sequence-generator jobs on event rows
    rng = np.random.default_rng(GSP_SEED)
    n = SEQ_EVENTS
    ts = np.cumsum(rng.exponential(1.0, n))
    ev = work / "events.csv"
    ev.write_text("".join(
        f"u{u},{t:.3f},{q}\n" for u, t, q in zip(
            rng.integers(0, 1000, n).tolist(), ts.tolist(),
            rng.integers(0, 100, n).tolist())))
    secs["positional_cluster"] = _twin(
        "sequencePositionalCluster",
        {"spc.window.time.span": "400", "spc.window.time.step": "200",
         "spc.score.threshold": "0.2", "spc.quant.threshold": "50"},
        [str(ev)], work, f"on {n} events")
    secs["sequence_generator"] = _twin(
        "sequenceGenerator",
        {"seg.id.field.ordinals": "0", "seg.val.field.ordinals": "1,2",
         "seg.seq.field": "0"}, [str(ev)], work, f"on {n} events")
    shutil.rmtree(work)
    return secs, counts, rows[0]


# ----------------------------------------------------------------- phase 13
def _bandit_stats(path: Path) -> None:
    """BANDIT_GROUPS groups x BANDIT_ARMS arms of seeded stats rows, a
    tenth of the arms untried."""
    import numpy as np

    rng = np.random.default_rng(BANDIT_SEED)
    g, a = BANDIT_GROUPS, BANDIT_ARMS
    counts = rng.integers(1, 50, (g, a))
    counts[rng.random((g, a)) < 0.1] = 0
    rewards = rng.integers(0, 100000, (g, a)) / 1000
    path.write_text("".join(
        f"g{i // a},p{i % a},{c},{r}\n" for i, (c, r) in enumerate(
            zip(counts.ravel().tolist(), rewards.ravel().tolist()))))


def phase_bandits():
    """The four bandit jobs through `bandit_round` at rounds 1, 2 and 10 on
    the card and on the CPU: files identical but in groups where a
    decision within 2 float32 ULP hangs on a float32 log; then the
    bench's bandit section. Returns the seconds."""
    import numpy as np
    import torch

    from avenir_tpu_torch.models import bandits
    from avenir_tpu_torch.pipelines import bandit_round
    from avenir_tpu_torch.runner import build_bandit_job, job_prefix
    from avenir_tpu_torch.tools import bandit_check, bench

    work = ROOT / "build" / "chip_smoke_bandit"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    stats = work / "stats.csv"
    _bandit_stats(stats)
    data = bandits.GroupBanditData.from_lines(
        stats.read_text().splitlines())
    secs, ties = {}, {}
    for job, kw in BANDIT_JOBS.items():
        prefix = job_prefix(job)
        props = {f"{prefix}.global.batch.size": "3",
                 **{f"{prefix}.{k}": v for k, v in kw.items()}}
        for rnd in BANDIT_ROUNDS:
            rows = {}
            for dev in (DEVICE, "cpu"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = bandit_round(props, str(stats),
                                   str(work / f"{job}_{rnd}_{dev}.txt"), rnd,
                                   job=job, device=dev)
                torch.cuda.synchronize()
                secs[f"{job}:{rnd}:{dev}"] = round(
                    time.perf_counter() - t0, 3)
                rows[dev] = Path(res.outputs[0]).read_text().splitlines()
            sel = np.array([int(ln.rsplit(",", 1)[1][1:])
                            for ln in rows["cpu"]]).reshape(-1, 3)
            fresh = build_bandit_job(job, props, "cpu")
            near = bandit_check.near_tie_groups(fresh, data, rnd, sel)
            a = np.array(rows[DEVICE]).reshape(-1, 3)
            b = np.array(rows["cpu"]).reshape(-1, 3)
            differ = (a != b).any(axis=1) if a.shape == b.shape else \
                np.ones(len(data.group_ids), bool)
            ties[f"{job}:{rnd}"] = {"differ": int(differ.sum()),
                                    "near_ties": int(near.sum())}
            check(not (differ & ~near).any()
                  and res.counters["Bandit:Groups"] == BANDIT_GROUPS,
                  f"{job} round {rnd} ({BANDIT_GROUPS} groups x "
                  f"{BANDIT_ARMS} arms, {CARD}): {secs[f'{job}:{rnd}:' + DEVICE]}s "
                  f"on the card, {secs[f'{job}:{rnd}:cpu']}s on the CPU; "
                  f"{int(differ.sum())} groups differ from the CPU twin's, "
                  f"near-tie groups (2 float32 ULP) {int(near.sum())}")
    print(f"bandit near ties ({CARD}): {json.dumps(ties)}", flush=True)
    t0 = time.perf_counter()
    row = bench.bench_bandit(torch.device(DEVICE), bench.BANDIT_GROUPS)
    check(row["bandit_group_decisions_per_sec"] > 0,
          f"bench bandit section ({bench.BANDIT_GROUPS} groups x "
          f"{bench.BANDIT_ARMS} arms, {bench.BANDIT_ROUNDS} rounds, {CARD}): "
          f"{json.dumps(row)} in {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(work)
    return {"seconds": secs, "near_ties": ties, "bench": row}


# ----------------------------------------------------------------- phase 14
def _files_of(res) -> list:
    """The bytes of a job's outputs and of their stamps, in output
    order."""
    return [p.read_bytes() for o in res.outputs
            for p in (Path(o), Path(o + ".stamp.json")) if p.exists()]


def _blocks_read(run) -> tuple:
    """(run(), the blocks the stream layer read during it)."""
    from avenir_tpu_torch.core import stream

    count = [0]
    stream._produce_hook = lambda: count.__setitem__(0, count[0] + 1)
    try:
        out = run()
    finally:
        stream._produce_hook = None
    return out, count[0]


def _markov_corpora(work: Path) -> dict:
    """The phase's files under `work`: the churn tutorial's chains
    (MARKOV_ROWS rows of MARKOV_ENTITIES customers, its first
    MARKOV_TWIN_ROWS and MARKOV_HOST_ROWS rows), the loyalty HMM's tagged
    rows and observation rows (with the hidden states and lengths of the
    latter, and its first MARKOV_TWIN_ROWS rows), and the host jobs'
    timestamped state rows and CTMC query rows."""
    import numpy as np

    from avenir_tpu_torch.data import (generate_loyalty_sequences,
                                       generate_markov_chains)
    from avenir_tpu_torch.data.generators import MARKOV_STATES

    t0 = time.perf_counter()
    files = {}

    def write(name, lines):
        files[name] = work / f"{name}.csv"
        files[name].write_text("\n".join(lines) + "\n")

    lines = generate_markov_chains(MARKOV_ROWS, seed=MARKOV_SEED,
                                   n_entities=MARKOV_ENTITIES)
    write("chains", lines)
    write("chains_twin", lines[:MARKOV_TWIN_ROWS])
    write("chains_host", lines[:MARKOV_HOST_ROWS])
    del lines
    tagged, _, _ = generate_loyalty_sequences(MARKOV_ROWS, seed=HMM_SEED,
                                              min_len=6, max_len=13,
                                              tagged=True)
    write("tagged", tagged)
    del tagged
    rows, hidden, lens = generate_loyalty_sequences(MARKOV_ROWS,
                                                    seed=HMM_SEED + 1)
    write("obs", rows)
    write("obs_twin", rows[:MARKOV_TWIN_ROWS])
    del rows
    rng = np.random.default_rng(MARKOV_SEED)
    n = MARKOV_HOST_ROWS
    keys = rng.integers(0, MARKOV_HOST_KEYS, n)
    ms = np.cumsum(rng.exponential(3.6e4, n)).astype(np.int64)
    state = rng.integers(0, len(MARKOV_STATES), n)
    write("events", [f"k{k},{t},{MARKOV_STATES[s]}" for k, t, s in zip(
        keys.tolist(), ms.tolist(), state.tolist())])
    ends = rng.integers(-1, len(MARKOV_STATES), n)
    write("queries", [f"k{k},{MARKOV_STATES[a]}"
                      + (f",{MARKOV_STATES[b]}" if b >= 0 else "")
                      for k, a, b in zip(
                          rng.integers(0, MARKOV_HOST_KEYS, n).tolist(),
                          rng.integers(0, len(MARKOV_STATES), n).tolist(),
                          ends.tolist())])
    print(f"markov corpora: {MARKOV_ROWS} chain rows "
          f"({files['chains'].stat().st_size} bytes, "
          f"{MARKOV_ENTITIES} customers), {MARKOV_ROWS} tagged and "
          f"{MARKOV_ROWS} observation rows of the loyalty HMM "
          f"({files['obs'].stat().st_size} bytes, {int(lens.sum())} "
          f"observations), {n} host rows; written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {**{k: str(v) for k, v in files.items()}, "hidden": hidden,
            "lens": lens}


def _device_row(name, calls, t_ops, t_bytes, job_s, kernel_s=0.0) -> dict:
    """One device program's row: its device seconds and launches (the
    calls of its profiler range, plus `kernel_s` of the C-entry kernels it
    launches, which are in no range), its bound and the share of its
    job's seconds."""
    dev_s = sum(calls) + kernel_s
    bound = max(t_ops, t_bytes)
    return {"name": name, "device_s": dev_s, "launches": len(calls),
            "bound_ms": bound * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": bound / dev_s if dev_s else None,
            "job_s": job_s, "share_of_job": dev_s / job_s}


def phase_markov(flops: float, rate: float):
    """The Markov path: per-class transition models streamed on the card
    under torch.profiler, fused with GSP through run_shared and per
    entity, each against its CPU twin; the classifier in validation mode;
    the HMM builder and Viterbi; ties on the card; the four host jobs.
    Returns (seconds by job, the two device programs' rows)."""
    import numpy as np
    import torch

    from avenir_tpu_torch.data.generators import (LOYALTY_OBS,
                                                  LOYALTY_STATES,
                                                  MARKOV_STATES)
    from avenir_tpu_torch.models import markov
    from avenir_tpu_torch.runner import run_job, run_shared

    work = ROOT / "build" / "chip_smoke_markov"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data = _markov_corpora(work)
    chains, states = data["chains"], ",".join(MARKOV_STATES)
    mst = {"mst.model.states": states, "mst.skip.field.count": "2",
           "mst.class.label.field.ord": "1", "mst.class.labels": "C,L",
           "mst.stream.block.size.mb": "4"}
    secs, rows = {}, []

    def timed(what, dev, run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs.setdefault(what, {})[dev] = round(time.perf_counter() - t0, 3)
        return out

    # per class, streamed in 4 MB blocks on the native parser, profiled
    card, info = _profiled(
        "markovStateTransitionModel per class on the card",
        lambda: run_job(MARKOV_PATH, mst, [chains], str(work / "mst_card.txt"),
                        device=DEVICE), markov.BIGRAM_RANGE)
    secs["mst"] = {DEVICE: info["seconds"]}
    cpu = timed("mst", "cpu", lambda: run_job(
        MARKOV_PATH, mst, [chains], str(work / "mst_cpu.txt"), device="cpu"))
    calls = info["round_device_s"]
    files = _files_of(card)
    s, k = len(MARKOV_STATES), 2
    # the count's least time: its int64 keys (one a transition: a row of
    # n states has n - 1, and n + 1 commas) read once and its k x S x S
    # counts written once
    n_keys = Path(chains).read_bytes().count(b",") - 2 * MARKOV_ROWS
    rows.append(_device_row(
        markov.BIGRAM_RANGE, calls, 0.0,
        (8 * n_keys + 8 * k * s * s) / rate, info["seconds"]))
    rows[-1]["keys"] = n_keys
    check(files == _files_of(cpu) and len(files) == 2
          and card.counters["Basic:Records"] == MARKOV_ROWS
          and len(calls) >= 1 and sum(calls) > 0
          and "stream.parse" in info["split"],
          f"markovStateTransitionModel per class on {MARKOV_ROWS} rows in "
          f"4 MB blocks ({CARD}): {info['seconds']}s on the card, "
          f"{secs['mst']['cpu']}s on the CPU; model and stamp byte-identical "
          f"to the CPU twin's; {markov.BIGRAM_RANGE} {len(calls)} calls, "
          f"{sum(calls):.6f} s of device time; {json.dumps(rows[-1])}; "
          f"busy {info['device_busy_share']:.2%}; split "
          f"{json.dumps(info['split'])}")

    # fused with GSP through run_shared: one scan
    cgs = {"cgs.support.threshold": "0.02", "cgs.item.set.length": "2",
           "cgs.skip.field.count": "2", "cgs.stream.block.size.mb": "4"}
    fused, fused_blocks = _blocks_read(lambda: timed(
        "run_shared", DEVICE, lambda: run_shared(
            [(MARKOV_PATH, mst, str(work / "fused_mst.txt")),
             ("candidateGenerationWithSelfJoin", cgs,
              str(work / "fused_gsp"))], [chains], device=DEVICE)))
    _, mst_blocks = _blocks_read(lambda: run_job(
        MARKOV_PATH, mst, [chains], str(work / "solo_mst.txt"),
        device=DEVICE))
    gsp, gsp_blocks = _blocks_read(lambda: timed(
        "gsp_solo", DEVICE, lambda: run_job(
            "candidateGenerationWithSelfJoin", cgs, [chains],
            str(work / "solo_gsp"), device=DEVICE)))
    check(_files_of(fused[MARKOV_PATH]) == files
          and _files_of(fused["candidateGenerationWithSelfJoin"])
          == _files_of(gsp) and fused_blocks == gsp_blocks
          and fused_blocks < mst_blocks + gsp_blocks,
          f"run_shared markovStateTransitionModel + "
          f"candidateGenerationWithSelfJoin (length 2) ({CARD}): "
          f"{secs['run_shared'][DEVICE]}s, {fused_blocks} blocks read "
          f"against {mst_blocks} + {gsp_blocks} solo (GSP "
          f"{secs['gsp_solo'][DEVICE]}s alone); files equal to the solo "
          f"runs'")

    # per entity: 10,000 customers
    ent = {"mst.state.list": states, "mst.id.field.ordinals": "0",
           "mst.seq.start.ordinal": "2", "mst.stream.block.size.mb": "4"}
    ents = {dev: timed("mst_entities", dev, lambda: run_job(
        MARKOV_PATH, ent, [chains], str(work / f"ent_{dev}.txt"),
        device=dev)) for dev in (DEVICE, "cpu")}
    check(_files_of(ents[DEVICE]) == _files_of(ents["cpu"])
          and ents[DEVICE].counters["Entities:Count"] == MARKOV_ENTITIES,
          f"markovStateTransitionModel per entity ({CARD}): "
          f"{ents[DEVICE].counters}, {secs['mst_entities'][DEVICE]}s on the "
          f"card, {secs['mst_entities']['cpu']}s on the CPU; model and "
          f"stamp byte-identical")

    # the classifier in validation mode on the card, then the twins
    mmc = {"mmc.mm.model.path": card.outputs[0], "mmc.class.labels": "C,L",
           "mmc.skip.field.count": "2", "mmc.class.label.field.ord": "1",
           "mmc.validation.mode": "true", "mmc.stream.block.size.mb": "4"}
    clf, cinfo = _profiled(
        "markovModelClassifier on the card",
        lambda: run_job("markovModelClassifier", mmc, [chains],
                        str(work / "mmc_card.txt"), device=DEVICE),
        markov.BIGRAM_RANGE)
    secs["mmc"] = {DEVICE: cinfo["seconds"]}
    twins = {dev: timed("mmc_twin", dev, lambda: run_job(
        "markovModelClassifier", mmc, [data["chains_twin"]],
        str(work / f"mmc_{dev}.txt"), device=dev)) for dev in (DEVICE, "cpu")}
    check(clf.counters["Validation:Accuracy"] > 85
          and cinfo["kernel_s"] > 0
          and _files_of(twins[DEVICE]) == _files_of(twins["cpu"])
          and twins[DEVICE].counters == twins["cpu"].counters,
          f"markovModelClassifier on {MARKOV_ROWS} rows ({CARD}): "
          f"{clf.counters}, {cinfo['seconds']}s, busy "
          f"{cinfo['device_busy_share']:.2%}, split "
          f"{json.dumps(cinfo['split'])}; on {MARKOV_TWIN_ROWS} rows "
          f"{secs['mmc_twin'][DEVICE]}s on the card, "
          f"{secs['mmc_twin']['cpu']}s on the CPU, byte-identical")

    # the HMM builder on the loyalty HMM's tagged rows
    hmmb = {"hmmb.model.states": ",".join(LOYALTY_STATES),
            "hmmb.model.observations": ",".join(LOYALTY_OBS),
            "hmmb.stream.block.size.mb": "4"}
    built, binfo = _profiled(
        "hiddenMarkovModelBuilder on the card",
        lambda: run_job("hiddenMarkovModelBuilder", hmmb, [data["tagged"]],
                        str(work / "hmm_card.txt"), device=DEVICE),
        markov.BIGRAM_RANGE)
    secs["hmmb"] = {DEVICE: binfo["seconds"]}
    bcpu = timed("hmmb", "cpu", lambda: run_job(
        "hiddenMarkovModelBuilder", hmmb, [data["tagged"]],
        str(work / "hmm_cpu.txt"), device="cpu"))
    check(_files_of(built) == _files_of(bcpu)
          and len(binfo["round_device_s"]) >= 1
          and sum(binfo["round_device_s"]) > 0,
          f"hiddenMarkovModelBuilder on {MARKOV_ROWS} tagged rows "
          f"({CARD}): {binfo['seconds']}s on the card "
          f"({len(binfo['round_device_s'])} counts, "
          f"{sum(binfo['round_device_s']):.6f} s of device time), "
          f"{secs['hmmb']['cpu']}s on the CPU; model byte-identical")

    # Viterbi on the observation rows under the built model
    vsp = {"vsp.hmm.model.path": built.outputs[0]}
    dec, vinfo = _profiled(
        "viterbiStatePredictor on the card",
        lambda: run_job("viterbiStatePredictor", vsp, [data["obs"]],
                        str(work / "vsp_card.txt"), device=DEVICE),
        markov.VITERBI_RANGE)
    secs["vsp"] = {DEVICE: vinfo["seconds"]}
    lens, hidden = data["lens"], data["hidden"]
    text = Path(dec.outputs[0]).read_text()
    flat = np.array(text.replace("\n", ",").split(",")[:-1])
    is_id = np.zeros(flat.shape[0], bool)
    is_id[np.cumsum(lens + 1) - (lens + 1)] = True
    code = {v: i for i, v in enumerate(LOYALTY_STATES)}
    got = np.array([code[v] for v in flat[~is_id].tolist()])
    truth = hidden[np.arange(hidden.shape[1])[None, :] < lens[:, None]]
    recovered = float((got == truth).mean()) if got.shape == truth.shape \
        else 0.0
    steps = int((lens - 1).sum())
    s = len(LOYALTY_STATES)
    # the scan's least time: an add and a compare a (step, previous, next)
    # state at the fp32 rate (half the FMA-counted peak); or its bytes:
    # the observations read, the back pointers (int8) and path written
    t_ops = 2 * s * s * steps / (flops / 2)
    t_bytes = (4 * int(lens.sum()) + s * steps + 8 * int(lens.sum())) / rate
    vcalls = vinfo["round_device_s"]
    rows.append(_device_row(markov.VITERBI_RANGE, vcalls, t_ops, t_bytes,
                            vinfo["seconds"]))
    vtw = {dev: timed("vsp_twin", dev, lambda: run_job(
        "viterbiStatePredictor", vsp, [data["obs_twin"]],
        str(work / f"vsp_{dev}.txt"), device=dev)) for dev in (DEVICE, "cpu")}
    check(recovered > 0.45 and len(vcalls) >= 1 and sum(vcalls) > 0
          and _files_of(vtw[DEVICE]) == _files_of(vtw["cpu"]),
          f"viterbiStatePredictor on {MARKOV_ROWS} sequences ({CARD}): "
          f"{vinfo['seconds']}s, {recovered:.4f} of the hidden states "
          f"recovered; {json.dumps(rows[-1])}; busy "
          f"{vinfo['device_busy_share']:.2%}, split "
          f"{json.dumps(vinfo['split'])}; on {MARKOV_TWIN_ROWS} rows "
          f"{secs['vsp_twin'][DEVICE]}s on the card, "
          f"{secs['vsp_twin']['cpu']}s on the CPU, byte-identical")

    # ties on the card: uniform transitions, two-valued emissions
    rng = np.random.default_rng(HMM_SEED)
    emis = np.where(rng.random((4, 3)) < 0.5, 1.0, 2.0)
    tie = markov.HiddenMarkovModel(
        ["a", "b", "c", "d"], ["x", "y", "z"], np.full(4, 0.25),
        np.full((4, 4), 0.25), emis / emis.sum(axis=1, keepdims=True))
    seqs = [list(rng.choice(["x", "y", "z"], int(n)))
            for n in rng.integers(1, 21, 50_000)]
    paths = {dev: markov.ViterbiDecoder(tie, device=dev).decode_codes(seqs)[0]
             for dev in (DEVICE, "cpu")}
    check(np.array_equal(paths[DEVICE], paths["cpu"]),
          f"Viterbi ties ({CARD}): a uniform-transition HMM decodes "
          f"{len(seqs)} sequences to the same paths on the card and the CPU")

    # the host jobs against their twins
    host = {
        "probabilisticSuffixTree": ({"pstg.skip.field.count": "2",
                                     "pstg.max.seq.length": "3"},
                                    [data["chains_host"]]),
        "stateTransitionRate": ({"str.time.field.ordinal": "1",
                                 "str.state.field.ordinal": "2",
                                 "str.state.values": states,
                                 "str.rate.time.unit": "day"},
                                [data["events"]]),
        "eventTimeDistribution": ({"etd.bucket.width": "3600000",
                                   "etd.num.buckets": "48"},
                                  [data["events"]])}
    for name, (props, inputs) in host.items():
        secs[name] = _twin(name, props, inputs, work,
                           f"on {MARKOV_HOST_ROWS} rows")
    cts = {"cts.state.values": states, "cts.time.horizon": "2.0",
           "cts.state.trans.file.path": str(
               work / f"stateTransitionRate_{DEVICE}.txt"),
           "cts.target.states": "cart"}
    secs["contTimeStateTransitionStats"] = _twin(
        "contTimeStateTransitionStats", cts, [data["queries"]], work,
        f"on {MARKOV_HOST_ROWS} rows, per-entity rates")
    shutil.rmtree(work)
    return secs, rows


# ----------------------------------------------------------------- phase 16
def _last_corpora(work: Path) -> dict:
    """The phase's files under `work`: churn and e-learning rows (their
    first LAST_SAMPLER_ROWS, LAST_TMC_ROWS, LAST_TWIN_ROWS,
    LAST_DBSCAN_ROWS and LAST_AGG_ROWS rows as files of their own), and
    the schemas."""
    from avenir_tpu_torch.data import (churn_schema, elearn_schema,
                                       generate_churn, generate_elearn)

    t0 = time.perf_counter()
    files = {}
    for name, gen, schema in (("churn", generate_churn, churn_schema),
                              ("elearn", generate_elearn, elearn_schema)):
        files[f"{name}_schema"] = work / f"{name}.json"
        files[f"{name}_schema"].write_text(json.dumps(schema().to_json()))
        text = gen(LAST_ROWS, seed=LAST_SEED, as_csv=True)
        files[name] = work / f"{name}.csv"
        files[name].write_text(text)
        lines = text.splitlines()
        for rows in (LAST_SAMPLER_ROWS, LAST_TWIN_ROWS, LAST_DBSCAN_ROWS,
                     LAST_AGG_ROWS):
            files[f"{name}_{rows}"] = work / f"{name}_{rows}.csv"
            files[f"{name}_{rows}"].write_text("\n".join(lines[:rows]) + "\n")
        del text, lines
    print(f"last-jobs corpora: {LAST_ROWS} churn rows "
          f"({files['churn'].stat().st_size} bytes) and {LAST_ROWS} "
          f"e-learning rows ({files['elearn'].stat().st_size} bytes); "
          f"written in {time.perf_counter() - t0:.1f}s", flush=True)
    return {k: str(v) for k, v in files.items()}


def phase_last(flops: float, rate: float):
    """The last ten jobs, each on the card and against its CPU twin.
    Returns (seconds by job, the two device programs' rows, the EXACT
    top-k launches of topMatchesByClass's card run)."""
    import numpy as np
    import torch

    from avenir_tpu_torch.core.dataset import Dataset
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models import cluster, regress
    from avenir_tpu_torch.models.knn import NeighborIndex
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.runner import run_job

    work = ROOT / "build" / "chip_smoke_last"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    f = _last_corpora(work)
    secs, rows = {}, []

    def props(prefix, data, extra=None):
        return {f"{prefix}.feature.schema.file.path": f[f"{data}_schema"],
                f"{prefix}.stream.block.size.mb": "4", **(extra or {})}

    def twin(case, job, pr, inputs, what):
        secs[case] = {k: round(v, 3) for k, v in _twin(
            job, pr, inputs, work, what).items()}

    # the streamed contingency and rule jobs on 1,000,000 churn rows
    rue = props("rue", "churn", {
        "rue.rule.names": "r1,r2,r3", "rue.rule.r1": "1 eq low => 6 eq closed",
        "rue.rule.r2": "5 gt 30 & 3 in high:med => 6 eq open",
        "rue.rule.r3": "1 ne low & 5 le 24 => 6 ne closed"})
    streamed = f"on {LAST_ROWS} churn rows in 4 MB blocks"
    twin("ruleEvaluator", "ruleEvaluator", rue, [f["churn"]], streamed)
    twin("categoricalClassAffinity", "categoricalClassAffinity",
         props("cca", "churn"), [f["churn"]], streamed)
    twin("categoricalContinuousEncoding:supervisedRatio",
         "categoricalContinuousEncoding", props("coe", "churn"),
         [f["churn"]], streamed)
    twin("categoricalContinuousEncoding:weightOfEvidence",
         "categoricalContinuousEncoding",
         props("coe", "churn", {"coe.encoding.strategy": "weightOfEvidence",
                                "coe.pos.class.attr.value": "open"}),
         [f["churn"]], streamed)
    sampled = f"on {LAST_SAMPLER_ROWS} churn rows"
    twin("underSamplingBalancer", "underSamplingBalancer",
         props("usb", "churn", {"usb.seed": "3"}),
         [f[f"churn_{LAST_SAMPLER_ROWS}"]], sampled)
    twin("baggingSampler", "baggingSampler",
         props("bas", "churn", {"bas.sample.rate": "0.7", "bas.seed": "3"}),
         [f[f"churn_{LAST_SAMPLER_ROWS}"]], sampled)
    twin("reliefFeatureRelevance", "reliefFeatureRelevance",
         props("ffr", "elearn", {"ffr.sample.size": "20000"}), [f["elearn"]],
         f"on {LAST_ROWS} e-learning rows, sample.size 20000")

    # top matches: 200,000 rows on the card, launches counted from zero;
    # the first 20,000 on both devices
    tmc = props("tmc", "elearn", {"tmc.top.match.count": "3"})
    tmc_rows = work / "elearn_tmc.csv"
    tmc_rows.write_text("\n".join(
        Path(f["elearn"]).read_text().splitlines()[:LAST_TMC_ROWS]) + "\n")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run_job(TMC_PATH, tmc, [str(tmc_rows)], str(work / "tmc_card.txt"),
                   device=DEVICE)
    torch.cuda.synchronize()
    tmc_s = time.perf_counter() - t0
    tmc_counts = _launch_counts()
    lines = Path(card.outputs[0]).read_text().splitlines()
    check(tmc_counts["knn_topk"] >= 2 and len(lines) == LAST_TMC_ROWS
          and card.counters["Basic:Records"] == LAST_TMC_ROWS,
          f"topMatchesByClass on {LAST_TMC_ROWS} e-learning rows ({CARD}): "
          f"{tmc_s:.3f}s, {len(lines)} lines; launches {tmc_counts}")
    twin("topMatchesByClass", TMC_PATH, tmc,
         [f[f"elearn_{LAST_TWIN_ROWS}"]], f"on {LAST_TWIN_ROWS} rows")
    secs["topMatchesByClass"][DEVICE + f"_{LAST_TMC_ROWS}"] = round(tmc_s, 3)
    # the kernel at the job's shape: one query block of the first class
    # against the class, k + 1 = 4, against its plain version
    schema = FeatureSchema.from_file(f["elearn_schema"])
    ds = Dataset.from_csv(tmc_rows.read_bytes(), schema)
    cls = ds.take(np.flatnonzero(ds.labels() == 0))
    index = NeighborIndex(cls, k=4, block=4096, device=DEVICE)
    q = index._query(*_mixed(cls.take(np.arange(min(16384, len(cls))))))
    args = dict(k=4, metric="manhattan", n_valid=index.n_valid,
                n_attrs=index.n_attrs)
    (kd, ki), ms = _timed_once(lambda: kk.knn_topk(q, index.t_num, **args))
    (pd, pi), plain_ms = _timed_once(
        lambda: kk.knn_topk_plain(q, index.t_num, **args))
    err = float((kd - pd).abs().max())
    ties = int(((ki != pi) & (kd != pd)).sum())
    check(err <= 1e-6 * float(pd.abs().max()) and ties == 0,
          f"knn_topk EXACT at topMatchesByClass's shape ({CARD}): {q.shape[0]} "
          f"queries x {index.n_valid} class rows (padded "
          f"{index.t_num.shape[0]}), D={index.t_num.shape[1]}, k=4: "
          f"{ms:.3f} ms against {plain_ms:.3f} ms plain, max abs err "
          f"{err:.3e}, indices apart only at tied distances")

    # logistic regression on 1,000,000 rows, profiled on the card
    n_lr = LAST_ROWS
    for case, extra in (("logisticRegression", {"lrj.iteration.limit": "10"}),
                        ("logisticRegression:allBelowThreshold", {
                            "lrj.iteration.limit": "50",
                            "lrj.convergence.criteria": "allBelowThreshold",
                            "lrj.convergence.threshold": "1.0"})):
        pr = props("lrj", "elearn", extra)
        res, info = _profiled(f"{case} on the card", lambda: run_job(
            "logisticRegression", pr, [f["elearn"]],
            str(work / f"{case}_card") + "/", device=DEVICE),
            regress.GRAD_RANGE)
        cpu_t0 = time.perf_counter()
        cpu = run_job("logisticRegression", pr, [f["elearn"]],
                      str(work / f"{case}_cpu") + "/", device="cpu")
        secs[case] = {DEVICE: info["seconds"],
                      "cpu": round(time.perf_counter() - cpu_t0, 3)}
        calls = info["round_device_s"]
        d = 7
        # per gradient: x and y read once; a multiply-add a cell each way
        # (x @ c and x.T @ r) and about 20 operations a row for the
        # sigmoid, at the fp32 rate (the port's float64 is slower; the
        # bytes bound is the larger either way)
        t_ops = len(calls) * n_lr * (4 * d + 20) / flops
        t_bytes = len(calls) * 4 * n_lr * (d + 1) / rate
        if case == "logisticRegression":
            rows.append(_device_row(regress.GRAD_RANGE, calls, t_ops, t_bytes,
                                    info["seconds"]))
        # the card's float64 gradient equals the CPU's but on a rounding
        # tie: every printed cell within one unit of its sixth decimal
        g, c = (Path(r.outputs[0]).read_text().splitlines()
                for r in (res, cpu))
        cells = [(float(u), float(v)) for gl, cl in zip(g, c)
                 for u, v in zip(gl.split(","), cl.split(","))]
        apart = sum(u != v for u, v in cells)
        check(len(g) == len(c) and res.counters == cpu.counters
              and all(abs(u - v) <= LR_CARD_ATOL for u, v in cells)
              and len(calls) >= 1 and sum(calls) > 0,
              f"{case} on {n_lr} e-learning rows ({CARD}): {res.counters}, "
              f"{info['seconds']}s on the card ({len(calls)} gradients, "
              f"{sum(calls):.6f} s of device time, busy "
              f"{info['device_busy_share']:.2%}), {secs[case]['cpu']}s on "
              f"the CPU; coeff.txt {len(g)} rows, {apart} of {len(cells)} "
              f"printed cells apart from the CPU twin's (at most "
              f"{LR_CARD_ATOL}); split {json.dumps(info['split'])}")

    # k-means on 1,000,000 rows, profiled on the card, launches from zero
    km = props("train", "elearn", {"train.num.clusters": "3",
                                    "train.num.iters": "100"})
    _reset_launches()
    res, info = _profiled("clusterTrain k-means on the card", lambda: run_job(
        "clusterTrain", km, [f["elearn"]], str(work / "km_card.txt"),
        device=DEVICE), cluster.STEP_RANGE, "centre_sums")
    km_counts = _launch_counts()
    cpu_t0 = time.perf_counter()
    cpu = run_job("clusterTrain", km, [f["elearn"]], str(work / "km_cpu.txt"),
                  device="cpu")
    secs["clusterTrain:kmeans"] = {
        DEVICE: info["seconds"], "cpu": round(time.perf_counter() - cpu_t0, 3)}
    # the steps' device time: their torch ops' (the range's) and the
    # kernel's, all of whose launches are the steps'
    calls = info["round_device_s"]
    d, k = 6, 3
    # per step: x read once, the assignment written; a multiply-add a
    # (row, centre, column), the norms and compares
    t_ops = len(calls) * LAST_ROWS * (2 * k * d + 2 * d + 4 * k) / flops
    t_bytes = len(calls) * LAST_ROWS * (4 * d + 8) / rate
    km_row = _device_row(cluster.STEP_RANGE, calls, t_ops, t_bytes,
                         info["seconds"], info["all_kernel_s"])
    fold = info["split"].get("stream.fold:clusterTrain")
    km_row.update({"kernel_s": info["all_kernel_s"],
                   "range_wall_s": sum(info["round_wall_s"]),
                   "fold_s": fold,
                   "fold_host_share": (1 - km_row["device_s"] / fold
                                       if fold else None)})
    rows.append(km_row)
    check(_files_of(res) == _files_of(cpu) and res.counters == cpu.counters
          and len(calls) >= 1 and sum(calls) > 0
          and km_counts["centre_sums"] == len(calls),
          f"clusterTrain k-means (k=3) on {LAST_ROWS} e-learning rows "
          f"({CARD}): {res.counters}, {info['seconds']}s on the card "
          f"({len(calls)} steps, {km_row['device_s']:.6f} s of device time "
          f"of which {km_row['kernel_s']:.6f} s centre_sums, "
          f"{km_row['range_wall_s']:.6f} s in the range on the host, the "
          f"fold {fold}s; busy {info['device_busy_share']:.2%}), "
          f"{secs['clusterTrain:kmeans']['cpu']}s on the CPU; labels "
          f"byte-identical; centre_sums launched {km_counts['centre_sums']}x;"
          f" split {json.dumps(info['split'])}")
    centre_row = _centre_sums_row(f, flops, rate)

    twin("clusterTrain:dbscan", "clusterTrain",
         props("train", "elearn", {"train.algo": "dbscan", "train.eps": "0.08",
                                   "train.min.samples": "4"}),
         [f[f"elearn_{LAST_DBSCAN_ROWS}"]],
         f"DBSCAN on {LAST_DBSCAN_ROWS} e-learning rows")

    # agglomerative over the card's recordSimilarity file of 200 rows
    dist = work / "dist.txt"
    run_job("recordSimilarity", props("sts", "elearn"),
            [f[f"elearn_{LAST_AGG_ROWS}"]], str(dist), device=DEVICE)
    twin("agglomerativeGraphical", "agglomerativeGraphical",
         {"agg.num.clusters": "3"}, [str(dist)],
         f"on the distance file of {LAST_AGG_ROWS} rows")
    shutil.rmtree(work)
    return secs, rows, tmc_counts, km_counts, centre_row


def _centre_edge_case(n, d, k, labels):
    """x with large and small values mixed and a -0 first row, and the
    labels of CENTRE_EDGE_SHAPES, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(n + d + k)
    x = (rng.normal(0, 1, (n, d))
         * 10.0 ** rng.integers(-4, 5, (n, d))).astype(np.float32)
    if n:
        x[0] = -0.0
    if labels == "one":
        a = np.zeros(n, np.int32)
    elif labels == "sparse":
        a = (5 * rng.integers(0, (k + 4) // 5, n)).astype(np.int32)
    else:
        a = rng.integers(-1, k + 1, n).astype(np.int32)
    return torch.from_numpy(x).to(DEVICE), torch.from_numpy(a).to(DEVICE)


def _centre_sums_row(f: dict, flops: float, rate: float) -> dict:
    """centre_sums against its plain version and `index_add_` at the
    k-means job's shape: the 1,000,000 x 6 e-learning features and the
    labels of a first Lloyd step from the job's seeded centres; beside the
    chain floor on those labels; then bit for bit at CENTRE_EDGE_SHAPES."""
    import numpy as np
    import torch

    from avenir_tpu_torch.core.dataset import Dataset
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models import cluster
    from avenir_tpu_torch.ops import cluster_kernels as ck
    from avenir_tpu_torch.tools import centre_sums_probe as probe

    schema = FeatureSchema.from_file(f["elearn_schema"])
    xh = Dataset.from_csv(Path(f["elearn"]).read_bytes(),
                          schema).feature_matrix().astype(np.float32)
    n, d, k = xh.shape[0], xh.shape[1], 3
    x = torch.from_numpy(xh).to(DEVICE)
    init = xh[np.random.default_rng(0).choice(n, k, replace=False)]
    _, assign, _ = cluster._kmeans_step(
        x, torch.from_numpy(init).to(DEVICE), k)
    assign = assign.to(torch.int32)
    got = ck.centre_sums(x, assign, k)
    ref, plain_ms = _timed_once(lambda: ck.centre_sums_plain(x, assign, k))
    times = {"kernel": [], "index_add_": []}
    calls = {"kernel": lambda: ck.centre_sums(x, assign, k),
             "index_add_": lambda: torch.zeros(
                 (k, d), device=DEVICE).index_add_(0, assign, x)}
    for name in ("index_add_", "kernel", "kernel", "index_add_"):
        times[name].append(cuda_ms(calls[name], 10))
    ms, library_ms = (sum(times[c]) / 2 for c in ("kernel", "index_add_"))
    fadd_ns, fadd_cycles = probe.fadd_latency()
    floor = probe.chain_floor_ms(assign, k, fadd_ns)
    sizes = torch.bincount(assign.long(), minlength=k).tolist()
    # x and the labels read once, the sums written; one add a (row,
    # column) into its cluster
    err = float((got - ref).abs().max())
    t_bytes = (n * d * 4 + n * 4 + k * d * 4) / rate
    t_ops = n * d / flops
    bound = max(t_bytes, t_ops) * 1e3
    check(torch.equal(got, ref),
          f"centre_sums at the k-means job's shape ({CARD}): {n} x {d}, "
          f"k={k}, clusters of {sizes} rows: {ms:.4f} ms (calls "
          f"{times['kernel']}) against {plain_ms:.3f} ms plain and "
          f"{library_ms:.4f} ms index_add_ (calls {times['index_add_']}); "
          f"the chain floor {floor:.4f} ms (the largest cluster's rows at "
          f"{fadd_ns:.4f} ns, {fadd_cycles:.3f} cycles a dependent FADD; the "
          f"kernel at {ms / floor:.2f}x it); the bytes bound {bound:.4f} ms; "
          f"bit-equal to the plain version")
    for shape in CENTRE_EDGE_SHAPES:
        xe, ae = _centre_edge_case(*shape)
        ke = shape[2]
        out = ck.centre_sums(xe, ae, ke)
        want = ck.centre_sums_plain(xe, ae, ke)
        torch.cuda.synchronize()
        check(out.cpu().numpy().tobytes() == want.cpu().numpy().tobytes(),
              f"centre_sums at n={shape[0]}, d={shape[1]}, k={ke}, labels "
              f"{shape[3]}: bit-equal to the plain version")
    return {"name": "centre_sums", "route": "cuda",
            "source": "avenir_tpu_torch/ops/csrc/centre_sums.cu",
            "replaces": "avenir_tpu/models/cluster.py:43 (XLA segment_sum, "
                        "not Pallas)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "chain_floor_ms": floor,
            "fadd_ns": fadd_ns, "fadd_cycles": fadd_cycles,
            "cluster_rows": sizes}


def _mixed(ds):
    """(x_num, x_cat) of a Dataset, the query arrays of NeighborIndex."""
    from avenir_tpu_torch.core.dataset import extract_mixed_features

    x_num, _, x_cat, _ = extract_mixed_features(ds)
    return x_num, x_cat


# ------------------------------------------------------------------ phase 7
# ----------------------------------------------------------------- phase 15
def _stream_corpora(work: Path) -> dict:
    """The corpora of the streamed jobs of phases 6, 9, 11, 12 and 14, as
    those phases write them (each removes its own): the churn train file,
    the market baskets, the GSP sequences and the churn tutorial's
    chains."""
    from avenir_tpu_torch.data import (churn_schema, generate_churn,
                                       generate_markov_chains)
    from avenir_tpu_torch.tools import bench

    t0 = time.perf_counter()
    files = {"schema": work / "churn.json", "churn": work / "train.csv",
             "baskets": work / "baskets.csv", "chains": work / "chains.csv"}
    churn_schema().save(str(files["schema"]))
    files["churn"].write_text(generate_churn(NB_TRAIN_ROWS, seed=201,
                                             as_csv=True))
    picks = bench.apriori_picks(ASSOC_TX, seed=4)
    files["baskets"].write_text("".join(
        ",".join([f"T{r}", *(f"i{j}" for j in row)]) + "\n"
        for r, row in enumerate(picks.tolist())))
    del picks
    files["chains"].write_text("\n".join(generate_markov_chains(
        MARKOV_ROWS, seed=MARKOV_SEED, n_entities=MARKOV_ENTITIES)) + "\n")
    files["seq"] = Path(_sequence_corpus(work)[0])
    print(f"stream corpora (phases 6, 9, 11, 12, 14) written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {k: str(v) for k, v in files.items()}


def _depth_bar(work: Path) -> dict:
    """The streamed jobs of phases 6, 9, 11, 12 and 14 on the card at
    stream.prefetch.depth 2, 1 and 8: every file of depths 1 and 8
    byte-identical to depth 2's. Returns {run: {depth: seconds}}."""
    import torch

    from avenir_tpu_torch.data.generators import MARKOV_STATES
    from avenir_tpu_torch.pipelines import profile_pipeline
    from avenir_tpu_torch.runner import run_job

    c = _stream_corpora(work)
    distr = {"bad.feature.schema.file.path": c["schema"],
             "bad.stream.block.size.mb": "4", "csv.engine": "native"}
    profile = {f"{p}.stream.block.size.mb": "4" for p in ("bad", "mut", "fid")}
    profile.update({"csv.engine": "native",
                    "mut.mutual.info.score.algorithms": MI_ALGOS})
    mst = {"mst.model.states": ",".join(MARKOV_STATES),
           "mst.skip.field.count": "2", "mst.class.label.field.ord": "1",
           "mst.class.labels": "C,L", "mst.stream.block.size.mb": "4"}
    jobs = {
        "bayesianDistr": ("bad", distr, lambda p, out: [run_job(
            "bayesianDistr", p, [c["churn"]], out + ".csv", device=DEVICE)]),
        "profile_pipeline_fused": (None, profile, lambda p, out: list(
            profile_pipeline(p, c["churn"], out, schema_path=c["schema"],
                             device=DEVICE).run(fuse=True).values())),
        MARKOV_PATH: ("mst", mst, lambda p, out: [run_job(
            MARKOV_PATH, p, [c["chains"]], out + ".txt", device=DEVICE)]),
        "frequentItemsApriori": ("fia", {**ASSOC_PROPS, **ASSOC_BLOCK},
                                 lambda p, out: [run_job(
                                     "frequentItemsApriori", p,
                                     [c["baskets"]], out, device=DEVICE)]),
        "candidateGenerationWithSelfJoin": (
            "cgs", {**GSP_PROPS, **GSP_BLOCK}, lambda p, out: [run_job(
                "candidateGenerationWithSelfJoin", p, [c["seq"]], out,
                device=DEVICE)]),
    }
    secs = {}
    for name, (prefix, props, run) in jobs.items():
        files, secs[name] = {}, {}
        for depth in (2, 1, 8):
            keys = ([f"{prefix}.stream.prefetch.depth"] if prefix else
                    [f"{p}.stream.prefetch.depth" for p in ("bad", "mut",
                                                            "fid")])
            p = {**props, **{k: str(depth) for k in keys}}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = run(p, str(work / f"{name}_d{depth}"))
            torch.cuda.synchronize()
            secs[name][depth] = round(time.perf_counter() - t0, 3)
            files[depth] = [f for r in results for f in _files_of(r)]
        check(files[1] == files[2] == files[8] and files[2],
              f"{name} at stream.prefetch.depth 1 and 8 ({CARD}): "
              f"{len(files[2])} files byte-identical to depth 2's; "
              f"seconds {json.dumps(secs[name])}")
    return secs


def phase_stream(rate: float, bf16_flops: float):
    """The stream path: the bench's stream legs on the card (generated NB
    at 1e9 rows, generated KNN at 1,000,341,504 train rows, the NB and KNN
    CSV legs at STREAM_NB_CSV_ROWS and STREAM_KNN_CSV_ROWS), the depth
    bar, the anchor and vs_baseline. Returns (seconds, the launch counts
    of the KNN legs, the figures)."""
    import os

    import torch

    from avenir_tpu_torch.core.dataset import Dataset
    from avenir_tpu_torch.data import churn_schema
    from avenir_tpu_torch.native import ingest
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.ops.distance import blocked_topk_neighbors
    from avenir_tpu_torch.runner import run_job
    from avenir_tpu_torch.tools import bench
    from avenir_tpu_torch.tools import knn_tolerance as tol

    work = ROOT / "build" / "chip_smoke_stream"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = torch.device(DEVICE)
    secs, figs = {}, {}
    print(f"stream host: torch.get_num_threads() {torch.get_num_threads()}, "
          f"native parse threads a 4 MB block "
          f"{ingest.parse_threads(4 << 20)} (a 64 MB block "
          f"{ingest.parse_threads(64 << 20)}), {os.cpu_count()} CPUs",
          flush=True)

    # the running merge over the first blocks against the plain exact
    # top-k of those blocks concatenated (a comparison: not counted)
    q, t0 = bench.knn_stream_inputs(dev, bench.KNN_STREAM_BLOCK)
    got = bench.knn_stream_fold(q, bench.rotated_blocks(t0, STREAM_CHECK_BLOCKS))
    t_cat = torch.cat([torch.roll(t0, i, dims=1)
                       for i in range(STREAM_CHECK_BLOCKS)])
    ref_d, ref_i = kk.knn_topk_plain(q, t_cat, K, "euclidean",
                                     compute_dtype="bfloat16")
    ref = (ref_d, ref_i.long())
    why = tol.lanes_agree(q, t_cat, got, ref, kk.lane_pack_bits(t0.shape[0]))
    ties = int((got[1] != ref[1]).sum())
    check(not why and bool((got[1] >= 0).all())
          and bool((got[1] < t_cat.shape[0]).all()),
          f"knn stream merge over {STREAM_CHECK_BLOCKS} rotated blocks of "
          f"{t0.shape[0]} rows: within the bfloat16 lane tolerance of "
          f"knn_topk_plain (bfloat16) over the {t_cat.shape[0]} rows "
          f"concatenated, {ties} of {ref[1].numel()} indices apart, each a "
          f"tie" + (f"; {why}" if why else ""))
    del t_cat, got, ref, ref_d, ref_i

    # the NB generated leg
    t_leg = time.perf_counter()
    figs["nb_stream"] = bench.nb_stream_generated(dev, bench.STREAM_ROWS)
    secs["nb_generated"] = time.perf_counter() - t_leg
    check(figs["nb_stream"]["class_count_sum"] == bench.STREAM_ROWS,
          f"NB generated leg ({CARD}): {json.dumps(figs['nb_stream'])}; "
          f"the class counts sum to {bench.STREAM_ROWS} exactly")

    # the main path of the KNN legs: their launches counted from zero
    _reset_launches()
    t_leg = time.perf_counter()
    knn, best_d, best_i = bench.knn_stream_generated(dev,
                                                     bench.KNN_STREAM_TRAIN)
    secs["knn_generated"] = time.perf_counter() - t_leg
    figs["knn_stream"] = knn
    n_blocks = bench.KNN_STREAM_TRAIN // bench.KNN_STREAM_BLOCK
    ops = 2.0 * q.shape[0] * bench.KNN_STREAM_TRAIN * q.shape[1]
    check(knn["lanes_launches"] == knn["tensor_core_launches"] == n_blocks
          and bool(torch.isfinite(best_d).all())
          and bool((best_i >= 0).all())
          and bool((best_i < bench.KNN_STREAM_TRAIN).all()),
          f"KNN generated leg ({CARD}): {json.dumps(knn)}; "
          f"{ops / knn['secs'] / 1e12:.1f} TF/s of the bf16 cross term "
          f"({ops / knn['secs'] / bf16_flops:.1%} of the peak); every final "
          f"index in [0, {bench.KNN_STREAM_TRAIN})")
    del best_d, best_i

    t_leg = time.perf_counter()
    csv, q_csv, best_d, best_i, path = bench.knn_stream_csv(
        dev, STREAM_KNN_CSV_ROWS, stream_dir=work)
    secs["knn_csv"] = time.perf_counter() - t_leg
    counts = _launch_counts()
    figs["knn_stream_csv"] = csv
    full = Dataset.from_csv(str(path), bench.knn_csv_schema(),
                            engine="native").feature_matrix()
    rows = full.shape[0]
    pad = -rows % bench.KNN_CSV_STEP
    t_all = torch.from_numpy(full).to(dev)
    del full
    t_all = torch.cat([t_all, torch.zeros((pad, t_all.shape[1]),
                                          device=dev)])
    ref = blocked_topk_neighbors(q_csv, t_all, k=K, block=bench.KNN_CSV_STEP,
                                 metric="euclidean", n_valid=rows)
    ref = (ref[0], ref[1].long())
    why = tol.lanes_agree(q_csv, t_all[:rows], (best_d, best_i), ref,
                          kk.lane_pack_bits(bench.KNN_CSV_STEP),
                          fp32_ref=True)
    check(not why and csv["csv_rows"] == rows,
          f"KNN CSV leg, {rows} rows ({csv['csv_bytes']} bytes) ({CARD}): "
          f"{json.dumps(csv)}; the top-{K} within the bfloat16 tolerance of "
          f"blocked_topk_neighbors in float32 over the whole parsed corpus, "
          f"{int((best_i != ref[1]).sum())} of {ref[1].numel()} indices "
          f"apart, each a tie" + (f"; {why}" if why else ""))
    del t_all, ref, best_d, best_i
    check(counts["knn_topk_lanes"] >= n_blocks
          and counts["knn_partial_mma"] == counts["knn_topk_lanes"],
          f"{STREAM_PATH} launches: {counts}")

    # the NB CSV leg, held to bayesianDistr on the same file
    t_leg = time.perf_counter()
    nb_csv, model, path = bench.nb_stream_csv(
        dev, STREAM_NB_CSV_ROWS, block_bytes=4 << 20, stream_dir=work)
    secs["nb_csv"] = time.perf_counter() - t_leg
    figs["nb_stream_csv"] = nb_csv
    leg_model = work / "nb_leg.csv"
    model.save(str(leg_model))
    schema = work / "churn_declared.json"
    churn_schema().save(str(schema))
    t_job = time.perf_counter()
    res = run_job("bayesianDistr",
                  {"bad.feature.schema.file.path": str(schema),
                   "bad.stream.block.size.mb": "4",
                   "bad.stream.prefetch.depth": "1", "csv.engine": "native"},
                  [str(path)], str(work / "nb_job.csv"), device=DEVICE)
    secs["nb_csv_job_depth1"] = time.perf_counter() - t_job
    same = all((work / f"nb_leg.csv{e}").read_bytes()
               == (work / f"nb_job.csv{e}").read_bytes()
               for e in ("", ".stamp.json"))
    check(same and nb_csv["csv_peak_rss_mb"] < 1024
          and res.counters["Distribution Data:Records"] == STREAM_NB_CSV_ROWS,
          f"NB CSV leg, {STREAM_NB_CSV_ROWS} rows ({nb_csv['csv_bytes']} "
          f"bytes, 4 MB blocks) ({CARD}): {json.dumps(nb_csv)}; model and "
          f"stamp byte-identical to bayesianDistr at stream.prefetch.depth=1 "
          f"({secs['nb_csv_job_depth1']:.2f}s); peak RSS "
          f"{nb_csv['csv_peak_rss_mb']:.0f} MB over the leg's start, under "
          f"1024")
    path.unlink()

    t_leg = time.perf_counter()
    secs["depth_bar"] = _depth_bar(work)
    secs["depth_bar_s"] = time.perf_counter() - t_leg

    anchor = bench.measure_baseline_anchor()
    nb = bench.bench_naive_bayes(dev, bench.NB_ROWS, 5)
    knn_d8, _ = bench.bench_knn(dev, 8, bench.KNN_QUERIES, bench.KNN_TRAIN, 5)
    ratio = bench.vs_baseline(nb["nb_rps"], knn_d8["qps"], bench.KNN_TRAIN,
                              anchor)
    figs.update(anchor=anchor, **ratio)
    check(all(v > 0 for v in (*anchor.values(), *ratio.values())),
          f"anchor {json.dumps(anchor)}, nb_rps {nb['nb_rps']:.4g}, knn_d8 "
          f"{knn_d8['qps']:.4g} q/s: {json.dumps(ratio)} ({CARD})")
    shutil.rmtree(work)
    return secs, counts, figs


def phase_ceiling(rate: float, bf16_flops: float):
    """matmul_ceiling against its plain version at the bench's shape."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import matmul_ceiling as mc

    rng = np.random.default_rng(3)
    q, t = (torch.from_numpy(rng.normal(size=(n, CEIL_D)).astype(np.float32))
            .to(DEVICE) for n in (CEIL_NQ, CEIL_NT))
    mc.matmul_ceiling_plain(q[:128], t[:128])       # warm the library
    got = mc.matmul_ceiling(q, t)
    again = mc.matmul_ceiling(q, t)
    torch.cuda.synchronize()
    ref, plain_ms = _timed_once(lambda: mc.matmul_ceiling_plain(q, t))
    tol = 2.0 ** -16 * mc.row_abs_sums_plain(q, t)
    err = (got - ref).abs()
    ms = cuda_ms(lambda: mc.matmul_ceiling(q, t), 20)
    qb, tb = q.to(torch.bfloat16), t.to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: torch.matmul(qb, tb.T).float().sum(1, keepdim=True),
                     5)
    flops = 2.0 * CEIL_NQ * CEIL_NT * CEIL_D
    ops_ms = flops / bf16_flops * 1e3
    bytes_ms = ((CEIL_NQ + CEIL_NT) * CEIL_D * 4 + CEIL_NQ * 4) / rate * 1e3
    bound, bound_by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                       else (bytes_ms, "bytes"))
    row = dict(name="matmul_ceiling", max_abs_err=err.max().item(),
               max_err_over_tol=(err / tol).max().item(), ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
               library_ms=lib_ms)
    check(bool((err <= tol).all()) and torch.equal(got, again),
          f"matmul_ceiling {CEIL_NQ}x{CEIL_NT}x{CEIL_D}: max|err| "
          f"{row['max_abs_err']:.4g}, at most {row['max_err_over_tol']:.3g} "
          f"of 2^-16 sum|q.t|, bit-equal rerun; {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TF/s, {bound / ms:.1%} of the bound "
          f"{bound:.3f} ms, {bound_by}), plain {plain_ms:.1f} ms, "
          f"cuBLAS bf16 matmul + sum {lib_ms:.3f} ms")
    _check_ceiling_widths()
    return row


def _check_ceiling_widths() -> None:
    """matmul_ceiling at every legal D, 384 queries (the second 256-query
    tile half filled) x 4736 train rows: each within 2^-16 sum|q.t| of
    its plain version, and a rerun bit-equal."""
    import torch

    from avenir_tpu_torch.ops import matmul_ceiling as mc

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    nq, nt = 384, 128 * 37
    bad, worst = [], 0.0
    widths = range(16, mc.MAX_D + 1, 16)
    for d in widths:
        q = torch.randn((nq, d), generator=gen, device=DEVICE)
        t = torch.randn((nt, d), generator=gen, device=DEVICE)
        got = mc.matmul_ceiling(q, t)
        again = mc.matmul_ceiling(q, t)
        torch.cuda.synchronize()
        err = (got - mc.matmul_ceiling_plain(q, t)).abs()
        tol = 2.0 ** -16 * mc.row_abs_sums_plain(q, t)
        worst = max(worst, (err / tol).max().item())
        if not (bool((err <= tol).all()) and torch.equal(got, again)):
            bad.append(d)
    check(not bad, f"matmul_ceiling at {nq} x {nt}, D 16..{mc.MAX_D}: "
          f"{len(widths) - len(bad)} of {len(widths)} within 2^-16 "
          f"sum|q.t| (at most {worst:.3g} of it) with bit-equal reruns"
          + (f"; not at D={bad}" if bad else ""))


def phase_bench():
    """The port-side bench at full size; its launch counts."""
    import torch

    from avenir_tpu_torch.tools import bench

    _reset_launches()
    t0 = time.perf_counter()
    line = []
    bench.run(device=DEVICE, out=line.append)
    torch.cuda.synchronize()
    counts = _launch_counts()
    print(line[0], flush=True)
    need = ("knn_topk_lanes", "knn_classify_lanes", "matmul_ceiling",
            "knn_partial_mma")
    # every KNN launch of the bench is euclidean bfloat16: each one takes
    # the tensor-core form
    bf16 = counts["knn_topk_lanes"] + counts["knn_classify_lanes"]
    check(all(counts[n] >= 1 for n in need)
          and counts["knn_partial_mma"] == bf16,
          f"bench: {time.perf_counter() - t0:.1f}s, launches {counts}; "
          f"{counts['knn_partial_mma']} of {bf16} bfloat16 KNN launches on "
          f"the tensor-core form")
    return counts


#: this slice's kernels: (name, source, what it replaces, the row of
#: `checks` it reports: name, metric, D, dtype, the path whose launches
#: count, and the wrappers whose launches launch it)
# ----------------------------------------------------------------- phase 17
def _score_corpora(work: Path) -> dict:
    """The served models' training files and the rows sent, written as
    the earlier phases write them: phase 6's churn train file (trains NB,
    and Fisher as phase 9 does) and the first SCORE_ROWS of its test
    rows, phase 14's chain rows and SCORE_ROWS fresh ones, phase 13's
    bandit stats; and SCORE_CONT_TRAIN and SCORE_CONT_ROWS rows of phase
    9's multi-class shape with three continuous fields."""
    from avenir_tpu_torch.data import (churn_schema, generate_churn,
                                       generate_markov_chains,
                                       generate_multiclass, multiclass_schema)

    t0 = time.perf_counter()
    f = {k: work / name for k, name in (
        ("schema", "churn.json"), ("train", "train.csv"),
        ("test", "test.csv"), ("chains", "chains.csv"),
        ("chain_rows", "chain_rows.csv"), ("stats", "stats.csv"),
        ("cont_schema", "multi.json"), ("cont_train", "multi_train.csv"),
        ("cont_test", "multi_test.csv"))}
    churn_schema().save(str(f["schema"]))
    multiclass_schema(5, 3).save(str(f["cont_schema"]))
    f["cont_train"].write_text(generate_multiclass(
        SCORE_CONT_TRAIN, 5, 3, seed=211, as_csv=True))
    f["cont_test"].write_text(generate_multiclass(
        SCORE_CONT_ROWS, 5, 3, seed=212, as_csv=True))
    f["train"].write_text(generate_churn(NB_TRAIN_ROWS, seed=201,
                                         as_csv=True))
    test = generate_churn(NB_TEST_ROWS, seed=202, as_csv=True).splitlines()
    f["test"].write_text("\n".join(test[:SCORE_ROWS]) + "\n")
    f["chains"].write_text("\n".join(generate_markov_chains(
        MARKOV_ROWS, seed=MARKOV_SEED, n_entities=MARKOV_ENTITIES)) + "\n")
    f["chain_rows"].write_text("\n".join(generate_markov_chains(
        SCORE_ROWS, seed=MARKOV_SEED + 2)) + "\n")
    _bandit_stats(f["stats"])
    print(f"score corpora: {NB_TRAIN_ROWS} churn rows, {MARKOV_ROWS} chain "
          f"rows, {BANDIT_GROUPS} groups x {BANDIT_ARMS} arms of stats, "
          f"{SCORE_CONT_TRAIN} rows of 5 classes and 3 continuous fields; "
          f"{SCORE_ROWS} rows to score a family ({SCORE_CONT_ROWS} of the "
          f"last); written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {k: str(v) for k, v in f.items()}


def _score_traffic(plane, reqs) -> tuple:
    """Every request through `plane.score` from SCORE_THREADS client
    threads, each taking the next request once its last is answered:
    (the answers in request order, wall seconds). Fails on any error or
    a client not joined within its bounded wait."""
    import threading

    out, errs = [None] * len(reqs), []
    todo, lock = iter(range(len(reqs))), threading.Lock()

    def client():
        while not errs:
            with lock:
                i = next(todo, None)
            if i is None:
                return
            try:
                out[i] = plane.score(reqs[i], timeout=120.0).row
            except Exception as exc:
                errs.append(exc)

    threads = [threading.Thread(target=client)
               for _ in range(SCORE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300.0)
    secs = time.perf_counter() - t0
    alive = sum(t.is_alive() for t in threads)
    if errs or alive:
        fail(f"score plane: {len(reqs)} {reqs[0].kind} requests: "
             f"{len(errs)} errors ({errs[:1]!r}), {alive} clients not "
             f"joined")
    return out, secs


def _all_threads_profiler():
    """torch.profiler's config recording every thread's ranges (the plane
    predicts on its dispatcher thread), or None where this torch has
    none."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _median_ms(fn, reps: int) -> tuple:
    """(fn()'s last result, the median of its host-clock ms over reps
    calls, each ended by torch.cuda.synchronize())."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return out, times[len(times) // 2]


def _window_split(kind, model, conf, rows) -> dict:
    """Where a warm window of `rows` of NB, Fisher or Markov spends its
    host-clock ms: the cache key's artifact digest, then the scorer's
    predict split as it runs it: the host parse, the model call (the
    device predict with its read-back), and the rest, the output lines.
    Medians over 21 windows, on a scorer loaded as the plane loads it."""
    from avenir_tpu_torch.core.dataset import Dataset
    from avenir_tpu_torch.server.score import load_scorer, model_cache_key

    reps = 21
    sc = load_scorer(kind, model, conf, device=DEVICE)
    _, digest = _median_ms(lambda: model_cache_key(kind, model, conf), reps)
    args = (conf,) if kind == "discriminant" else ()
    _, window = _median_ms(lambda: sc.predict_rows(rows, *args), reps)
    parse = call = 0.0
    if kind == "bayes":
        ds, parse = _median_ms(lambda: Dataset.from_csv(
            "\n".join(rows) + "\n", sc.schema, delim=sc.delim,
            keep_raw=True), reps)
        _, call = _median_ms(lambda: sc.pred.predict(ds), reps)
    elif kind == "markov":
        seqs, parse = _median_ms(lambda: [
            [t.strip(" \t\r") for t in ln.split(sc.delim)][sc.skip:]
            for ln in rows], reps)
        _, call = _median_ms(lambda: sc.clf.predict(seqs), reps)
    return {"rows": len(rows), "digest_ms": round(digest, 4),
            "window_ms": round(window, 4), "parse_ms": round(parse, 4),
            "model_call_ms": round(call, 4),
            "lines_ms": round(window - parse - call, 4)}


def _serve(kind, model, conf, rows, want, solo, profiled, after=None,
           label=None):
    """One family through a ScorePlane on the card at the default window
    and batch: every answer against `want` (the batch job's line of that
    row), the answers at the indices `solo` against cold `score_once` on
    the card, the first `profiled` requests again under torch.profiler (the
    `score::<kind>` ranges' device ms); `after(plane, got)` runs on the
    warm plane before it closes, which must join its thread. Returns the
    family's numbers; `label` names the family in the check's line."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from avenir_tpu_torch.server.score import (ScorePlane, ScoreRequest,
                                               score_once)

    t0 = time.perf_counter()
    reqs = [ScoreRequest(kind, model, r, dict(conf)) for r in rows]
    plane = ScorePlane(device=DEVICE)
    try:
        got, secs = _score_traffic(plane, reqs)
        snap, hists = plane.snapshot(), plane.hist_summaries()
        same = sum(a == b for a, b in zip(got, want))
        t1 = time.perf_counter()
        solo_same = sum(score_once(kind, model, rows[i], dict(conf),
                                   device=DEVICE) == got[i] for i in solo)
        solo_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        cfg = _all_threads_profiler()
        dev_ms = None
        if cfg is not None:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         experimental_config=cfg) as prof:
                again, psecs = _score_traffic(plane, reqs[:profiled])
                torch.cuda.synchronize()
            calls = _range_calls_s(prof, f"score::{kind}")
            dev_ms = {"requests": profiled, "seconds": round(psecs, 4),
                      "ranges": len(calls),
                      "device_ms": round(sum(calls) * 1e3, 4),
                      "device_ms_per_range": round(
                          sum(calls) * 1e3 / max(len(calls), 1), 4),
                      "answers_equal": again == got[:profiled],
                      "with_profiler_s": round(time.perf_counter() - t1, 3)}
        extra = after(plane, got) if after is not None else {}
    finally:
        plane.close()
    joined = not any(t.name == "score-dispatch" and t.is_alive()
                     for t in threading.enumerate())
    name = plane._model_name(model)
    st = snap["stats"]
    row = {"requests": len(reqs), "seconds": round(secs, 4),
           "windows": st["predict_calls"],
           "rows_per_window": round(st["window_rows"]
                                    / max(st["predict_calls"], 1), 2),
           **{f"{h}_ms": {q: hists[f"score_{name}_{h}_ms"][q]
                          for q in ("p50", "p99")}
              for h in ("queue", "predict", "total")},
           "model_loads": st["model_loads"],
           "cache_hits": snap["cache"]["hits"],
           "solo_s": round(solo_s, 3),
           "profiled": dev_ms if dev_ms is not None else "not measured "
           "(this torch's profiler records no other thread)", **extra}
    check(same == len(rows) and solo_same == len(solo) and joined
          and st["errors"] == 0 and (dev_ms is None
                                     or dev_ms["answers_equal"]),
          f"score plane {label or kind} ({CARD}): {same} of {len(rows)} "
          f"answers equal the card's batch job line, " + (
              f"{solo_same} of {len(solo)} solo score_once rows equal "
              f"their coalesced answers" if solo else "the solo check "
              f"the pull after the reward burst") +
          f", the closed plane joined its thread; {json.dumps(row)}; phase "
          f"{time.perf_counter() - t0:.1f}s")
    return row


def phase_score():
    """The score plane on the card: the models of phases 6, 9, 13 and 14
    retrained at their sizes, each family served to SCORE_THREADS client
    threads at the default window and batch and held against the card's
    batch job, solo scores, the bandit's CPU twin (bandit_check's rule)
    and a reward burst. Returns the phase's numbers."""
    import numpy as np

    from avenir_tpu_torch.data.generators import MARKOV_STATES
    from avenir_tpu_torch.models.bandits import GroupBanditData
    from avenir_tpu_torch.models.discriminant import FisherDiscriminant
    from avenir_tpu_torch.runner import build_bandit_job, run_job
    from avenir_tpu_torch.server.score import (ScoreRequest,
                                               load_reward_journal,
                                               model_cache_key, score_once)
    from avenir_tpu_torch.tools import bandit_check

    t_phase = time.perf_counter()
    _reset_launches()
    work = ROOT / "build" / "chip_smoke_score"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    f = _score_corpora(work)
    rng = np.random.default_rng(SCORE_SEED)
    t0 = time.perf_counter()
    nb = run_job("bayesianDistr", {
        "bad.feature.schema.file.path": f["schema"],
        "bad.stream.block.size.mb": "4", "csv.engine": "native"},
        [f["train"]], str(work / "nb_model.csv"), device=DEVICE).outputs[0]
    nb_cont = run_job("bayesianDistr", {
        "bad.feature.schema.file.path": f["cont_schema"],
        "csv.engine": "native"}, [f["cont_train"]],
        str(work / "nb_cont_model.csv"), device=DEVICE).outputs[0]
    fisher = run_job("fisherDiscriminant", {
        "fid.feature.schema.file.path": f["schema"],
        "fid.stream.block.size.mb": "4", "csv.engine": "native"},
        [f["train"]], str(work / "fisher.txt"), device=DEVICE).outputs[0]
    mst = run_job(MARKOV_PATH, {
        "mst.model.states": ",".join(MARKOV_STATES),
        "mst.skip.field.count": "2", "mst.class.label.field.ord": "1",
        "mst.class.labels": "C,L", "mst.stream.block.size.mb": "4"},
        [f["chains"]], str(work / "mst.txt"), device=DEVICE).outputs[0]
    # the batch jobs whose lines the plane must answer
    nb_conf = {"field.delim": ",", "schema.path": f["schema"],
               "predict.class.cost": "2,1", "predict.class": "open,closed"}
    run_job("bayesianPredictor", {
        "bap.feature.schema.file.path": f["schema"],
        "bap.bayesian.model.file.path": nb, "csv.engine": "python",
        "bap.predict.class.cost": "2,1", "bap.predict.class": "open,closed"},
        [f["test"]], str(work / "nb_pred.txt"), device=DEVICE)
    cont_conf = {"field.delim": ",", "schema.path": f["cont_schema"]}
    run_job("bayesianPredictor", {
        "bap.feature.schema.file.path": f["cont_schema"],
        "bap.bayesian.model.file.path": nb_cont, "csv.engine": "python"},
        [f["cont_test"]], str(work / "nb_cont_pred.txt"), device=DEVICE)
    mk_conf = {"field.delim": ",", "class.labels": "C,L",
               "log.odds.threshold": "0", "skip.field.count": "2"}
    run_job("markovModelClassifier", {
        "mmc.mm.model.path": mst, "mmc.class.labels": "C,L",
        "mmc.skip.field.count": "2"}, [f["chain_rows"]],
        str(work / "mmc.txt"), device=DEVICE)
    ordinal = sorted(FisherDiscriminant.load(fisher).boundaries)[0]
    fd_conf = {"field.delim": ",", "ordinal": str(ordinal)}
    bandit_props = _score_bandit_props()
    run_job("greedyRandomBandit", bandit_props, [f["stats"]],
            str(work / "select.txt"), device=DEVICE)
    bd_conf = {"field.delim": ",", **SCORE_BANDIT_CONF}
    print(f"score models and batch jobs on the card ({CARD}): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    tests = Path(f["test"]).read_text().splitlines()
    chain_rows = Path(f["chain_rows"]).read_text().splitlines()
    fd = FisherDiscriminant.load(fisher)
    sides = fd.predict_values(ordinal, np.asarray(
        [float(r.split(",")[ordinal]) for r in tests], np.float64))
    by_group = {}
    for ln in (work / "select.txt").read_text().splitlines():
        by_group.setdefault(ln.split(",")[0], []).append(ln)
    groups = [f"g{i}" for i in rng.choice(BANDIT_GROUPS, SCORE_BANDIT_ROWS,
                                          replace=False).tolist()]
    solo = sorted(rng.choice(SCORE_ROWS, SCORE_SOLO, replace=False).tolist())
    solo_cont = sorted(rng.choice(SCORE_CONT_ROWS, SCORE_SOLO,
                                  replace=False).tolist())
    rows = {}
    rows["bayes"] = _serve(
        "bayes", nb, nb_conf, tests,
        (work / "nb_pred.txt").read_text().splitlines(), solo,
        SCORE_PROFILED)
    rows["bayes_continuous"] = _serve(
        "bayes", nb_cont, cont_conf,
        Path(f["cont_test"]).read_text().splitlines(),
        (work / "nb_cont_pred.txt").read_text().splitlines(), solo_cont,
        SCORE_PROFILED // 4, label="bayes (3 continuous fields)")
    rows["discriminant"] = _serve(
        "discriminant", fisher, fd_conf, tests,
        [f"{r},{int(s)}" for r, s in zip(tests, sides)], solo,
        SCORE_PROFILED)
    rows["markov"] = _serve(
        "markov", mst, mk_conf, chain_rows,
        (work / "mmc.txt").read_text().splitlines(), solo, SCORE_PROFILED)

    def burst(plane, got):
        """The bandit's CPU twin by bandit_check's rule and its warm
        window's split, then the reward burst and the window after it:
        the model reloaded once, the first burst arm's group equal to a
        cold score_once."""
        import threading

        t0 = time.perf_counter()
        data = GroupBanditData.from_lines(
            Path(f["stats"]).read_text().splitlines())
        rnd = int(SCORE_BANDIT_CONF["round"])
        sel = build_bandit_job("greedyRandomBandit", bandit_props,
                               "cpu").select(data, rnd)
        near = bandit_check.near_tie_groups(build_bandit_job(
            "greedyRandomBandit", bandit_props, "cpu"), data, rnd, sel)
        cpu = {}
        for parts in data.selections_to_rows(sel):
            cpu.setdefault(parts[0], []).append(",".join(parts))
        gi = {g: i for i, g in enumerate(data.group_ids)}
        differ = [g for g in data.group_ids if by_group[g] != cpu[g]]
        pulled = [g for g, a in zip(groups, got) if a != "\n".join(cpu[g])]
        twin = {"groups_differ": len(differ),
                "near_tie_groups": int(near.sum()),
                "pulls_differ": len(pulled),
                "seconds": round(time.perf_counter() - t0, 3)}
        check(all(near[gi[g]] for g in differ + pulled),
              f"score plane bandit against the CPU twin ({CARD}): "
              f"{len(pulled)} of {len(groups)} pulls and {len(differ)} of "
              f"{BANDIT_GROUPS} groups differ, every one a near-tie group "
              f"(2 float32 ULP; {int(near.sum())} in all)")
        # a warm window's split: the digest, the select on the device
        # stats, and the rest of the plane's predict p50, the lines of
        # every group
        name = plane._model_name(f["stats"])
        window = plane.hist_summaries()[f"score_{name}_predict_ms"]["p50"]
        stats_dev = data.to_device(DEVICE)
        _, digest = _median_ms(
            lambda: model_cache_key("bandit", f["stats"], bd_conf), 3)
        _, select = _median_ms(lambda: build_bandit_job(
            "greedyRandomBandit", bandit_props, DEVICE).select(stats_dev,
                                                               rnd), 3)
        split = {"digest_ms": round(digest, 4),
                 "window_ms": round(window, 4), "parse_ms": 0.0,
                 "model_call_ms": round(select, 4),
                 "lines_ms": round(window - select, 4),
                 "window_ms_is": "the plane's predict p50"}
        # the burst: SCORE_BURST appends from 8 threads over
        # SCORE_BURST_NONCES nonces, each nonce with one payload, a reward
        # that makes its arm the group's best
        arms = [(f"g{int(g)}", f"p{int(a)}") for g, a in zip(
            rng.choice(BANDIT_GROUPS, SCORE_BURST_NONCES, replace=False),
            rng.integers(0, BANDIT_ARMS, SCORE_BURST_NONCES))]
        acks, lock = [], threading.Lock()

        def send(idx):
            for i in idx:
                n = i % SCORE_BURST_NONCES
                g, a = arms[n]
                ack = plane.reward(ScoreRequest(
                    "bandit", f["stats"], f"{g},{a},{50000.0 + n},3",
                    dict(bd_conf), action="reward", req_id=f"burst{n}"))
                with lock:
                    acks.append(ack)

        senders = [threading.Thread(target=send,
                                    args=(range(k, SCORE_BURST, 8),))
                   for k in range(8)]
        for t in senders:
            t.start()
        for t in senders:
            t.join(120.0)
        entries = load_reward_journal(f["stats"])
        loads = plane.snapshot()["stats"]["model_loads"]
        # the next window: the burst's groups and the first of the
        # traffic's, from the client threads at once
        after_groups = [g for g, _ in arms] + groups[:64 - len(arms)]
        after, pull_s = _score_traffic(plane, [
            ScoreRequest("bandit", f["stats"], g, dict(bd_conf))
            for g in after_groups])
        reloaded = plane.snapshot()["stats"]["model_loads"] - loads
        cold = score_once("bandit", f["stats"], arms[0][0], dict(bd_conf),
                          device=DEVICE)
        moved = sum(a != "\n".join(by_group[g])
                    for g, a in zip(after_groups, after))
        applied = sum(a["applied"] for a in acks)
        check(not any(t.is_alive() for t in senders)
              and len(acks) == SCORE_BURST
              and applied == len(entries) == SCORE_BURST_NONCES
              and len({e["nonce"] for e in entries}) == SCORE_BURST_NONCES
              and reloaded == 1 and after[0] == cold and moved > 0,
              f"score plane reward burst ({CARD}): {len(acks)} appends "
              f"over {SCORE_BURST_NONCES} nonces, {applied} applied, "
              f"{len(entries)} journal entries; the next {len(after)} "
              f"pulls loaded the model {reloaded} time(s) in {pull_s:.3f}s, "
              f"{moved} of them moved by the rewards, and the first "
              f"equals a cold score_once")
        return {"cpu_twin": twin, "window_split": split, "burst": {
            "appends": len(acks), "applied": applied,
            "pulls_after": len(after), "moved": moved,
            "reload_window_s": round(pull_s, 3)}}

    rows["bandit"] = _serve(
        "bandit", f["stats"], bd_conf, groups,
        ["\n".join(by_group[g]) for g in groups], [],
        SCORE_BANDIT_PROFILED, after=burst)
    split = {
        "bayes": _window_split("bayes", nb, nb_conf, tests[:64]),
        "discriminant": _window_split("discriminant", fisher, fd_conf,
                                      tests[:64]),
        "markov": _window_split("markov", mst, mk_conf, chain_rows[:64]),
        "bandit": rows["bandit"].pop("window_split")}
    print(f"score window split, host-clock ms of a warm window ({CARD}; "
          f"64 rows, the bandit's the plane's predict p50): "
          f"{json.dumps(split)}", flush=True)
    counts = _launch_counts()
    check(not any(counts.values()),
          f"score plane: no kernel of the port's own launched {counts}")
    shutil.rmtree(work)
    return {"families": rows, "window_split": split,
            "seconds": round(time.perf_counter() - t_phase, 1)}


def _score_bandit_props() -> dict:
    """The greedyRandomBandit job's keys for SCORE_BANDIT_CONF."""
    return {"grb.global.batch.size": SCORE_BANDIT_CONF["batch.size"],
            "grb.current.round.num": SCORE_BANDIT_CONF["round"],
            **{f"grb.{k}": v for k, v in SCORE_BANDIT_CONF.items()
               if k not in ("algorithm", "batch.size", "round")}}


NEW_KERNELS = (
    ("knn_partial_mma", "knn_tile_mma.cuh", "avenir_tpu/ops/pallas_knn.py:64",
     ("knn_topk_lanes", "euclidean", 128, "bfloat16"), BENCH_PATH,
     ("knn_partial_mma",)),
    ("merge_topk", "knn_topk.cu", "avenir_tpu/ops/pallas_knn.py:78",
     ("merge_topk", "manhattan", 6, "float32"), "nearestNeighbor",
     ("knn_topk", "knn_topk_packed", "knn_topk_lanes")),
    ("merge_vote", "knn_classify.cu", "avenir_tpu/ops/pallas_knn.py:501",
     ("merge_vote", "manhattan", 6, "float32"), "nearestNeighbor",
     ("knn_classify_lanes",)))


# ----------------------------------------------------------------- phase 18
#: the Metropolis target: LIB_BINS bins of width LIB_BW from LIB_XMIN, a
#: two-Gaussian mixture; the proposal std, the mixture's global std and
#: threshold, the seed
LIB_XMIN, LIB_BW, LIB_BINS = -5.0, 0.05, 200
LIB_PSTD, LIB_MIXTURE, LIB_SEED = 0.5, (3.0, 0.7), 7
#: a walk step's float operations: the multiply-add (2), the clamp (2),
#: the bin index (sub, fmod, sub, divide, round, convert, clip: 8), the
#: ratio's floor and divide (2), the compare (1)
WALK_STEP_OPS = 15
#: the SVM's and the net's settings (tests/test_svm_neural.py's)
LIB_SVM = {"kernel": "rbf", "gamma": 2.0, "c": 10.0,
           "epochs": LIB_SVM_EPOCHS}
LIB_NN_MODES = (("batch", 0.5), ("minibatch", 0.2))


def _lib_sampler(mixture: bool, device: str):
    import numpy as np

    from avenir_tpu_torch.utils.sampling import MetropolisSampler

    centres = LIB_XMIN + LIB_BW * np.arange(LIB_BINS)
    values = (np.exp(-0.5 * ((centres + 2.0) / 0.8) ** 2)
              + 0.6 * np.exp(-0.5 * ((centres - 3.0) / 0.5) ** 2))
    m = MetropolisSampler(LIB_PSTD, LIB_XMIN, LIB_BW, values, seed=LIB_SEED,
                          device=device)
    if mixture:
        m.set_mixture_proposal(*LIB_MIXTURE)
    return m


def _svm_twins(x, y) -> dict:
    """fit, kfold and bagging on the card against the CPU twin: dual
    coefficients within SVM_COEF_RTOL of the largest, predictions equal
    but where the twin's |decision| is under SVM_MARGIN."""
    import numpy as np
    import torch

    from avenir_tpu_torch.models import svm

    out = {}
    card = svm.SVMClassifier(**LIB_SVM, device=DEVICE).fit(x, y)
    twin = svm.SVMClassifier(**LIB_SVM, device="cpu").fit(x, y)
    scale = np.abs(twin.dual_coef).max()
    err = float(np.abs(card.dual_coef - twin.dual_coef).max() / scale)
    f = twin.decision_function(x)
    near = np.abs(f) < SVM_MARGIN
    same = np.array_equal(card.predict(x)[~near], twin.predict(x)[~near])
    out["fit"] = {"coef_rel_err": err, "near_margin": int(near.sum()),
                  "intercept_err": abs(card.intercept - twin.intercept)}
    check(err <= SVM_COEF_RTOL and same,
          f"SVM fit at {len(x)} rows, card against its CPU twin: dual "
          f"coefficients {err:.3g} of the largest apart (tolerance "
          f"{SVM_COEF_RTOL}), predictions equal off the margin "
          f"({int(near.sum())} rows within {SVM_MARGIN})")
    vm = svm.kfold_masks(len(x), LIB_FOLDS)
    fc = svm.fold_decisions(svm.SVMClassifier(**LIB_SVM, device=DEVICE), x,
                            y, vm)
    ft = svm.fold_decisions(svm.SVMClassifier(**LIB_SVM, device="cpu"), x,
                            y, vm)
    near = np.abs(ft) < SVM_MARGIN
    same = bool(((fc > 0) == (ft > 0))[~near].all())
    err = float(np.abs(fc - ft).max())
    out["kfold"] = {"decision_abs_err": err, "near_margin": int(near.sum())}
    check(same, f"SVM kfold ({LIB_FOLDS} folds) at {len(x)} rows, card "
          f"against its CPU twin: decisions {err:.3g} apart, every fold's "
          f"predictions equal off the margin ({int(near.sum())} within)")
    bc = svm.BaggedSVM(svm.SVMClassifier(**LIB_SVM, device=DEVICE),
                       LIB_ESTIMATORS, use_oob=True).fit(x, y, seed=0)
    bt = svm.BaggedSVM(svm.SVMClassifier(**LIB_SVM, device="cpu"),
                       LIB_ESTIMATORS, use_oob=True).fit(x, y, seed=0)
    scales = np.abs(bt.dual_coefs).max(axis=1, keepdims=True)
    err = float((np.abs(bc.dual_coefs - bt.dual_coefs) / scales).max())
    xt = torch.from_numpy(np.array(x, np.float32))
    ft = (bt.base.gram(xt, xt).numpy() @ bt.dual_coefs.T + bt.intercepts)
    near = (np.abs(ft) < SVM_MARGIN).any(axis=1)
    same = np.array_equal(bc.predict(x)[~near], bt.predict(x)[~near])
    oob_same = bc.oob_score_ == bt.oob_score_ or near.any()
    out["bagging"] = {"coef_rel_err": err, "near_margin": int(near.sum()),
                      "oob_card": bc.oob_score_, "oob_twin": bt.oob_score_}
    check(err <= SVM_COEF_RTOL and same and oob_same,
          f"BaggedSVM ({LIB_ESTIMATORS} estimators, use_oob) at {len(x)} "
          f"rows, card against its CPU twin: dual coefficients {err:.3g} of "
          f"each estimator's largest apart, votes equal off the margin "
          f"({int(near.sum())} rows within), oob {bc.oob_score_} / "
          f"{bt.oob_score_}")
    return out


def _nn_twins(x, y) -> dict:
    """Both training modes on the card against the CPU twin from one
    initial net: parameters within NN_ATOL, predictions equal off a 1e-4
    probability margin; and the card's own initial draws against the
    CPU's within 4 ULP."""
    import numpy as np
    import torch

    from avenir_tpu_torch.models import neural as nnm
    from avenir_tpu_torch.ops import prng

    init = nnm._init_params(prng.PRNGKey(0), 2, 16, 2,
                            torch.device("cpu")).arrays()
    card_init = nnm._init_params(prng.PRNGKey(0), 2, 16, 2,
                                 torch.device(DEVICE)).arrays()
    ulps = max(int(np.abs(card_init[k].view(np.int32).astype(np.int64)
                          - init[k].view(np.int32).astype(np.int64)).max())
               for k in ("w1", "w2"))
    check(ulps <= 4, f"the net's initial normals on the card within {ulps} "
          "ULP of the CPU's (budget 4)")
    out = {"init_ulps": ulps}
    for mode, lr in LIB_NN_MODES:
        nets = {}
        for dev in (DEVICE, "cpu"):
            start = nnm.TwoLayerNet(*(torch.from_numpy(init[k].copy()).to(dev)
                                      for k in ("w1", "b1", "w2", "b2")))
            nets[dev] = nnm.BasicNeuralNetwork(
                n_hidden=16, learning_rate=lr, iterations=LIB_NN_ITERS,
                training_mode=mode, batch_size=32, device=dev).fit(
                    x, y, init=start)
        card, twin = nets[DEVICE].params.arrays(), nets["cpu"].params.arrays()
        err = max(float(np.abs(card[k] - twin[k]).max()) for k in card)
        p = nets["cpu"].predict_proba(x)
        keep = np.abs(p[:, 1] - 0.5) >= 1e-4
        same = np.array_equal(nets[DEVICE].predict(x)[keep],
                              nets["cpu"].predict(x)[keep])
        out[mode] = {"param_abs_err": err, "near_margin": int((~keep).sum())}
        check(err <= NN_ATOL and same,
              f"BasicNeuralNetwork {mode} ({LIB_NN_ITERS} iterations) at "
              f"{len(x)} rows from one initial net, card against its CPU "
              f"twin: parameters {err:.3g} apart (tolerance {NN_ATOL}), "
              f"predictions equal off the margin")
    return out


def _walk_checks(mode: str, sampled, sample_ms: float, flops: float,
                 rate: float) -> dict:
    """The walk of one mode: the sample call again for its chain and draws
    (bit-equal to the main path's), the full walk's CUDA-event ms beside
    its bound, the kernel against its plain version on the first
    LIB_WALK_CHECK steps of the card's draws, the sampler against its CPU
    twin over those steps by the divergence rule, the diagnostics."""
    import numpy as np

    from avenir_tpu_torch.ops import sampling_kernels as smk
    from avenir_tpu_torch.tools.sampling_check import walk_divergence
    from avenir_tpu_torch.utils import mcmc
    from avenir_tpu_torch.utils.sampling import StepDraws

    first, out = sampled
    mixture = mode == "mixture"
    steps = LIB_SAMPLES * LIB_SKIP
    m = _lib_sampler(mixture, DEVICE)
    x0 = m.cur
    chain, draws = m.walk(steps)
    again = chain[LIB_SKIP - 1::LIB_SKIP][:LIB_SAMPLES].cpu().numpy()
    check(again.tobytes() == out.tobytes() and m.cur == first.cur
          and m.trans_count == first.trans_count
          and m.key.tolist() == first.key.tolist(),
          f"Metropolis {mode}: the sample call's chain again, bit-equal")
    walk = m.walk_target()
    full = (draws.z, draws.uniforms, draws.mix)
    full_ms = cuda_ms(lambda: smk.metropolis_walk(*full, walk, x0), 3)
    ns, cycles = smk.chain_latency_ns(walk, x0)
    k = LIB_WALK_CHECK
    pre = tuple(None if t is None else t[:k].contiguous() for t in full)
    got, taken = smk.metropolis_walk(*pre, walk, x0)
    ms = cuda_ms(lambda: smk.metropolis_walk(*pre, walk, x0), 5)
    host = tuple(None if t is None else t.cpu() for t in pre)
    walk_h = smk.WalkTarget(walk.bins.cpu(), walk.xmin, walk.xmax,
                            walk.bin_width, walk.pstd, walk.gstd, walk.thr)
    t0 = time.perf_counter()
    want, want_taken = smk.metropolis_walk_plain(*host, walk_h, x0)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_h = got.cpu()
    err = float((got_h - want).abs().max())
    # the bound: each draw read once and each x written once (4 bytes
    # each), or WALK_STEP_OPS float operations a step at the fp32 rate;
    # the floor: a step's dependent chain, timed, times the steps
    t_bytes = k * 4 * (3 + mixture) / rate
    t_ops = k * WALK_STEP_OPS / flops
    bound = max(t_bytes, t_ops) * 1e3
    floor = k * ns * 1e-6
    check(got_h.numpy().tobytes() == want.numpy().tobytes()
          and int(taken) == int(want_taken),
          f"metropolis_walk {mode} ({CARD}): bit-equal to its plain version "
          f"over the first {k} steps of the card's draws ({int(taken)} "
          f"taken); {ms:.4f} ms against {plain_ms:.1f} ms plain (host); "
          f"bound {bound:.5f} ms; the chain floor {floor:.4f} ms "
          f"({ns:.3f} ns, {cycles:.1f} cycles a step; the kernel at "
          f"{ms / floor:.2f}x it)")
    twin = _lib_sampler(mixture, "cpu")
    tchain, tdraws = twin.walk(k)
    res = walk_divergence(walk, x0, chain[:k], StepDraws(*pre), tchain,
                          tdraws)
    check(res["allowed"],
          f"Metropolis {mode}: the card's sampler against its CPU twin over "
          f"{k} steps by the divergence rule: first parting "
          f"{res['first']} ({res['why'] or 'none'}), largest gap before it "
          f"{res['max_gap']:.3g} (tolerance {res['gap_tol']:.3g}), "
          f"{res['z_differ']} steps with z apart")
    sample = out.astype(np.float64)
    z = mcmc.GewekeConvergence(burn_in_sizes=[0, LIB_SAMPLES // 10,
                                              LIB_SAMPLES // 2])
    zs = z.calculate_zscores(sample)
    burn, size = mcmc.RafteryLewisConvergence().find_sample_size(sample)
    check(len(zs) == 3 and all(np.isfinite(v) for *_, v in zs)
          and size > 0 and np.isfinite(sample).all(),
          f"Metropolis {mode}: {LIB_SAMPLES} samples at skip {LIB_SKIP} in "
          f"[{sample.min():.4f}, {sample.max():.4f}], "
          f"{first.trans_count} of {steps} taken; Geweke z "
          f"{[round(v, 3) for *_, v in zs]}, Raftery-Lewis burn-in {burn}, "
          f"sample size {size}")
    print(f"metropolis_walk {mode} ({CARD}): the sample call {sample_ms:.1f} "
          f"ms (draws and walk); the walk of {steps} steps {full_ms:.3f} ms, "
          f"{full_ms * 1e6 / steps:.2f} ns a step, the chain floor "
          f"{steps * ns * 1e-6:.3f} ms ({ns:.3f} ns a step's chain)",
          flush=True)
    return {"steps": k, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "chain_floor_ms": floor, "max_abs_err": err,
            "full_steps": steps, "full_ms": full_ms,
            "ns_per_step": full_ms * 1e6 / steps, "chain_ns": ns,
            "chain_cycles": cycles, "sample_ms": sample_ms,
            "taken": first.trans_count, "divergence": res["first"],
            "z_differ": res["z_differ"], "geweke": [v for *_, v in zs],
            "raftery_lewis": [burn, size]}


def phase_library(flops: float, rate: float):
    """The library modules no job calls, on the card: the SVM (fit, kfold,
    bagging with oob) on make_moons(LIB_SVM_ROWS), the net in batch and
    minibatch mode on LIB_NN_ROWS moons rows, the Metropolis sampler plain
    and mixture; then each against its CPU twin and the walk against its
    plain version. Returns (seconds, the walk's kernels-line row, the main
    path's launch counts, the device rows)."""
    import numpy as np
    import torch

    from avenir_tpu_torch.models import neural as nnm
    from avenir_tpu_torch.models import svm

    t_phase = time.perf_counter()
    x, y = nnm.make_moons(LIB_SVM_ROWS)
    xn, yn = nnm.make_moons(LIB_NN_ROWS, noise=0.15, seed=5)
    secs = {}
    # the main path, its launches counted from zero
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, fit_ms = _timed_once(
        lambda: svm.SVMClassifier(**LIB_SVM, device=DEVICE).fit(x, y))
    acc = model.score(x[:LIB_SVM_TWIN_ROWS], y[:LIB_SVM_TWIN_ROWS])
    rep, kfold_ms = _timed_once(lambda: svm.kfold_validate(
        svm.SVMClassifier(**LIB_SVM, device=DEVICE), x, y, LIB_FOLDS))
    ens, bag_ms = _timed_once(lambda: svm.BaggedSVM(
        svm.SVMClassifier(**LIB_SVM, device=DEVICE), LIB_ESTIMATORS,
        use_oob=True).fit(x, y, seed=0))
    bag_acc = ens.score(x[:LIB_SVM_TWIN_ROWS], y[:LIB_SVM_TWIN_ROWS])
    nets = {}
    for mode, lr in LIB_NN_MODES:
        net, ms = _timed_once(lambda: nnm.BasicNeuralNetwork(
            n_hidden=16, learning_rate=lr, iterations=LIB_NN_ITERS,
            training_mode=mode, batch_size=32, device=DEVICE).fit(xn, yn))
        nets[mode] = (net.score(xn, yn), ms)
    sampled = {}
    for mode in ("plain", "mixture"):
        m = _lib_sampler(mode == "mixture", DEVICE)
        out, ms = _timed_once(lambda: m.sample(LIB_SAMPLES, LIB_SKIP))
        sampled[mode] = ((m, out), ms)
    torch.cuda.synchronize()
    secs["main_path"] = round(time.perf_counter() - t0, 3)
    counts = _launch_counts()
    check(counts["metropolis_walk"] == 2
          and not any(v for n, v in counts.items() if n != "metropolis_walk"),
          f"{LIB_PATH} path: one metropolis_walk launch a sample call, no "
          f"other kernel of the port's own: {counts}")
    check(acc > 0.9 and rep.avg_error < 0.1 and bag_acc > 0.9
          and ens.oob_score_ > 0.9
          and min(a for a, _ in nets.values()) > 0.9,
          f"SVM rbf on {LIB_SVM_ROWS} moons rows ({CARD}): fit "
          f"{fit_ms:.1f} ms, accuracy {acc:.4f} on the first "
          f"{LIB_SVM_TWIN_ROWS}; kfold ({LIB_FOLDS}) {kfold_ms:.1f} ms, "
          f"error {rep.avg_error:.4f}; bagging ({LIB_ESTIMATORS}, use_oob) "
          f"{bag_ms:.1f} ms, accuracy {bag_acc:.4f}, oob {ens.oob_score_:.4f};"
          f" the net on {LIB_NN_ROWS} rows: " + ", ".join(
              f"{mode} {ms:.1f} ms, accuracy {a:.4f}"
              for mode, (a, ms) in nets.items()))
    # the trainer alone on the fit's Gram matrix: 417 reads of it
    xt = torch.from_numpy(x).to(DEVICE)
    m1 = svm.SVMClassifier(**LIB_SVM, device=DEVICE)
    gram = m1.gram(xt, xt)
    ypm = torch.from_numpy(np.where(y > 0, 1.0, -1.0).astype(np.float32)
                           ).to(DEVICE)
    ones = torch.ones((1, LIB_SVM_ROWS), device=DEVICE)
    _, train_ms = _timed_once(lambda: m1.train(gram, ypm, ones))
    reads = 16 + 1 + 2 * LIB_SVM_EPOCHS
    svm_bound = reads * gram.numel() * 4 / rate * 1e3
    del gram
    torch.cuda.empty_cache()
    print(f"SVM trainer ({CARD}): {train_ms:.1f} ms for {reads} reads of "
          f"the [{LIB_SVM_ROWS}, {LIB_SVM_ROWS}] float32 Gram matrix; bytes "
          f"bound {svm_bound:.1f} ms ({svm_bound / train_ms:.1%})",
          flush=True)
    # a net step: x (float32) and y (int64) read once; the forward's two
    # products 2 * rows * (2 * 16 + 16 * 2) operations, the backward's
    # twice that
    nn_rows = {}
    for mode, (_, ms) in nets.items():
        n = LIB_NN_ROWS if mode == "batch" else 32
        t_b = n * (2 * 4 + 8) / rate
        t_o = 6 * n * (2 * 16 + 16 * 2) / flops
        nn_rows[mode] = {"ms": ms, "bound_ms": LIB_NN_ITERS * max(
            t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o
            else "operations"}
    print(f"the net's training ({CARD}): " + ", ".join(
        f"{mode} {r['ms']:.1f} ms for {LIB_NN_ITERS} steps against its "
        f"{r['bound_by']} bound of {r['bound_ms']:.4f} ms"
        for mode, r in nn_rows.items()), flush=True)
    rows = {"svm": {"fit_ms": fit_ms, "train_ms": train_ms,
                    "bound_ms": svm_bound, "kfold_ms": kfold_ms,
                    "bagging_ms": bag_ms, "reads": reads},
            "nn": nn_rows}
    t0 = time.perf_counter()
    twins = {"svm": _svm_twins(x[:LIB_SVM_TWIN_ROWS], y[:LIB_SVM_TWIN_ROWS]),
             "nn": _nn_twins(xn[:LIB_NN_TWIN_ROWS], yn[:LIB_NN_TWIN_ROWS])}
    secs["twins"] = round(time.perf_counter() - t0, 3)
    print(f"SVM and net twins: {json.dumps(twins)}", flush=True)
    t0 = time.perf_counter()
    walks = {mode: _walk_checks(mode, s_, ms, flops, rate)
             for mode, (s_, ms) in sampled.items()}
    secs["walks"] = round(time.perf_counter() - t0, 3)
    rows["metropolis"] = walks
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    w = walks["plain"]
    row = {"name": "metropolis_walk", "route": "cuda",
           "source": "avenir_tpu_torch/ops/csrc/metropolis_walk.cu",
           "replaces": "avenir_tpu/utils/sampling.py:184 (XLA scan, not "
                       "Pallas)",
           "max_abs_err": w["max_abs_err"], "ms": w["ms"],
           "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
           "bound_by": w["bound_by"], "library_ms": None,
           "chain_floor_ms": w["chain_floor_ms"],
           "steps": w["steps"], "chain_ns": w["chain_ns"],
           "chain_cycles": w["chain_cycles"], "full_steps": w["full_steps"],
           "full_ms": w["full_ms"], "mixture_ms": walks["mixture"]["ms"],
           "mixture_full_ms": walks["mixture"]["full_ms"]}
    return secs, row, counts, rows


# ------------------------------------------------------------ phase 19
#: the supplier-fulfillment tutorial's sup.conf: one block a CTMC job
SUP_CONF = """stateTransitionRate {{
  field.delim.in = ","
  key.field.ordinals = [0]
  time.field.ordinal = 1
  state.field.ordinal = 2
  state.values = ["F", "P", "L"]
  rate.time.unit = "week"
  input.time.unit = "ms"
  trans.rate.output.precision = 9
}}

contTimeStateTransitionStats {{
  field.delim.in = ","
  key.field.len = 1
  state.values = ["F", "P", "L"]
  time.horizon = 4
  state.trans.file.path = "{rates}"
  state.trans.stat = "stateDwellTime"
  target.states = ["L"]
}}
"""
#: 1,000 products x 1,000 weeks of fulfillment states: 1,000,000 rows
CONF_PRODUCTS, CONF_WEEKS = 1_000, 1_000
CONF_PATH = "sup.conf"


def _fulfillment_csv(path: Path) -> None:
    """The tutorial's weekly states (`productId,epochMs,state`), reliable
    and struggling products in turn, drawn a week at a time for all
    products at once."""
    import numpy as np

    profiles = np.array([
        [[.85, .10, .05], [.60, .25, .15], [.50, .30, .20]],
        [[.40, .30, .30], [.25, .40, .35], [.15, .35, .50]]])
    rng = np.random.default_rng(13)
    kind = np.arange(CONF_PRODUCTS) % 2
    s = np.zeros(CONF_PRODUCTS, np.int64)
    weeks = np.empty((CONF_PRODUCTS, CONF_WEEKS), np.int64)
    for w in range(CONF_WEEKS):
        weeks[:, w] = s
        cum = profiles[kind, s].cumsum(axis=1)
        s = (rng.random(CONF_PRODUCTS)[:, None] > cum).sum(axis=1)
    names = np.array(["F", "P", "L"])
    stamps = [str(w * 604_800_000) for w in range(CONF_WEEKS)]
    with open(path, "w") as fh:
        for p in range(CONF_PRODUCTS):
            pid = f"PROD{p:05d}"
            fh.write("".join(f"{pid},{t},{st}\n" for t, st in
                             zip(stamps, names[weeks[p]])))


def phase_conf():
    """The CTMC pair of the supplier-fulfillment tutorial driven by one
    HOCON `sup.conf` through `runner.run_job` on the card, each file
    against its CPU twin's (run from the same conf text, its rates path
    its own). Returns (seconds, the path's launch counts)."""
    import torch

    from avenir_tpu_torch.runner import run_job

    work = ROOT / "build" / "chip_smoke_conf"
    shutil.rmtree(work, ignore_errors=True)
    t_phase = time.perf_counter()
    data, queries = work / "fulfill.csv", work / "queries.csv"
    outs, secs = {}, {}
    for dev in (DEVICE, "cpu"):
        d = work / dev
        d.mkdir(parents=True, exist_ok=True)
        (d / CONF_PATH).write_text(SUP_CONF.format(rates=d / "rates.txt"))
    _fulfillment_csv(data)
    queries.write_text("".join(f"PROD{p:05d},L\n"
                               for p in range(CONF_PRODUCTS)))
    secs["corpus"] = round(time.perf_counter() - t_phase, 3)
    for dev in (DEVICE, "cpu"):
        d, conf = work / dev, str(work / dev / CONF_PATH)
        if dev == DEVICE:
            _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_job("stateTransitionRate", conf, [str(data)],
                      str(d / "rates.txt"), device=dev)
        t1 = time.perf_counter()
        res2 = run_job("contTimeStateTransitionStats", conf, [str(queries)],
                       str(d / "dwell.csv"), device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if dev == DEVICE:
            counts = _launch_counts()
        secs[dev] = {"stateTransitionRate": round(t1 - t0, 3),
                     "contTimeStateTransitionStats": round(t2 - t1, 3)}
        outs[dev] = _files_of(res) + _files_of(res2)
    check(res.counters["Basic:Entities"] == CONF_PRODUCTS
          and outs[DEVICE] == outs["cpu"] and len(outs[DEVICE]) == 2,
          f"{CONF_PATH}: stateTransitionRate on {CONF_PRODUCTS * CONF_WEEKS} "
          f"event rows and contTimeStateTransitionStats on {CONF_PRODUCTS} "
          f"queries from one HOCON conf ({CARD}): {json.dumps(secs)}; both "
          f"files byte-identical to the CPU twin's")
    check(not any(counts.values()),
          f"{CONF_PATH} path: both jobs are host float64, no kernel of the "
          f"port's own launched: {counts}")
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    return secs, counts


# ------------------------------------------------------------ phase 20
MESH_ROWS = 1_000_000
#: the KNN family's queries, train rows, features and k
MESH_KNN = (1024, 131072, 6, 5)
MESH_FIT_ROWS, MESH_FIT_DEPTH, MESH_LR_ITERS = 1_000_000, 3, 10
MESH_PATH = "mesh"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_inputs():
    """Every family's inputs on the card (rows of MESH_ROWS, KNN at
    MESH_KNN) and the single-device core that answers each."""
    import numpy as np
    import torch

    from avenir_tpu_torch.models.association import _contain_counts_resident
    from avenir_tpu_torch.models.bandits import _ucb1
    from avenir_tpu_torch.models.markov import bigram_counts
    from avenir_tpu_torch.models.regress import _lr_step
    from avenir_tpu_torch.models.tree import _level_histogram
    from avenir_tpu_torch.ops.distance import _block_topk, pairwise_distance

    rng = np.random.default_rng(2026)
    n = MESH_ROWS

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    nq, nt, d, k = MESH_KNN
    q, t = dev(rng.random((nq, d), np.float32)), dev(rng.random((nt, d),
                                                                 np.float32))
    t_lab = dev(rng.integers(0, 2, nt).astype(np.int32))
    ones = dev(np.ones(n, np.float32))
    codes = dev(rng.integers(0, 12, (n, 5)).astype(np.int32))
    lab2 = dev(rng.integers(0, 2, n).astype(np.int32))
    leaf = dev(rng.integers(0, 8, n).astype(np.int32))
    seg = dev(rng.integers(0, 2, (n, 54)).astype(np.int8))
    x = dev(np.concatenate([np.ones((n, 1)), rng.normal(0, 1, (n, 6))],
                           axis=1).astype(np.float32))
    coeff = dev(rng.normal(0, 0.3, 7).astype(np.float32))
    seq = rng.integers(0, 5, (n // 10, 10)).astype(np.int32)
    seq[np.arange(10)[None, :] >= rng.integers(2, 11, n // 10)[:, None]] = -1
    trans = dev((rng.random((n, 64)) < 0.1).astype(np.uint8))
    cand = np.zeros((256, 64), np.float32)
    for c in range(256):
        cand[c, [c % 64, (c // 64 + 1 + c) % 64]] = 1.0
    g = n // 10
    counts = dev(rng.integers(0, 40, (g, 10)).astype(np.int32))
    rewards = dev((rng.random((g, 10)) * 100).astype(np.float32))
    mask = dev(np.ones((g, 10), bool))

    def knn_single():
        dd = pairwise_distance(q, t)
        return _block_topk(dd, torch.arange(nt, device=q.device).expand_as(dd),
                           k, "manhattan")
    return {
        "knn_topk": ((k,), (q, t, t_lab),
                     lambda: (lambda dv, ix: (dv, t_lab[ix]))(*knn_single())),
        "nb_train": ((2, 12), (codes, lab2, ones), None),
        "tree_level": ((8, 54, 2, 2), (leaf, seg, lab2, ones),
                       lambda: _level_histogram(leaf, seg, lab2, ones, 8, 54,
                                                2, 2, dtype=torch.int64)),
        "lr_step": ((0.5,), (coeff, x, lab2.float(), ones),
                    lambda: _lr_step(coeff, x, lab2.float(), 0.5)[0]),
        "markov_counts": ((5, 2), (dev(seq), lab2[:n // 10]),
                          lambda: bigram_counts(dev(seq), lab2[:n // 10], 5,
                                                2)),
        "apriori_support": ((2,), (trans, dev(cand)),
                            lambda: _contain_counts_resident(
                                trans, dev(cand), 2, 8192).long()),
        "bandit_select": ((3, 100.0), (counts, rewards, mask, 10.0),
                          lambda: _ucb1(counts, rewards, mask, 10.0, 100.0,
                                        3)),
        "crosscount": ((12, 2), (codes[:, 0], lab2, ones), None),
    }


def phase_mesh():
    """`parallel/` on one card: a NCCL process group of world size 1 in
    this process, its 1-rank data mesh, the eight families on cuda
    tensors against the port's single-device cores, then
    `DecisionTreeBuilder.fit(mesh=)` and `LogisticRegression.fit(mesh=)`
    on MESH_FIT_ROWS e-learning rows against fit() on the card. Returns
    (seconds, each family's ms and its collective's ms, the path's launch
    counts)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from avenir_tpu_torch.core.dataset import Dataset
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.data import elearn_schema, generate_elearn
    from avenir_tpu_torch.models.regress import LogisticRegression
    from avenir_tpu_torch.models.tree import DecisionTreeBuilder
    from avenir_tpu_torch.parallel import FAMILIES, data_mesh, multihost
    from avenir_tpu_torch.parallel.mesh import all_reduce_sum

    t_phase = time.perf_counter()
    n = multihost.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                             device=DEVICE)
    check(n == 1 and dist.get_backend() == "nccl",
          f"{MESH_PATH}: a {dist.get_backend()} process group of world "
          f"size {n} on the card")
    mesh = data_mesh(device=DEVICE)
    secs, rows = {}, {}
    _reset_launches()
    try:
        for name, (params, args, single) in _mesh_inputs().items():
            fn = FAMILIES[name](mesh, *params)
            out = fn(*args)
            ms = cuda_ms(lambda: fn(*args), 5)
            got = out if isinstance(out, tuple) else (out,)
            if single is None:      # nb_train, crosscount: their oracle
                single = _count_oracle(name, args, params)
            want = single()
            want = want if isinstance(want, tuple) else (want,)
            if name == "lr_step":
                err = float((got[0] - want[0]).abs().max())
                same = err <= LR_MESH_ATOL
            else:
                same = all(torch.equal(a, b) for a, b in zip(got, want))
            # the tensors the family all-reduces: its counts, or LR's
            # float64 gradient and weight total
            coll = ([] if name in ("knn_topk", "bandit_select") else
                    [torch.zeros(args[1].shape[1], dtype=torch.float64,
                                 device=DEVICE),
                     torch.zeros(1, dtype=torch.float64, device=DEVICE)]
                    if name == "lr_step" else [o.clone() for o in got])
            coll_ms = (cuda_ms(lambda: [all_reduce_sum(c, mesh,
                                                       mesh.axis_names)
                                        for c in coll], 20)
                       if coll else None)
            rows[name] = {"ms": ms, "collective_ms": coll_ms,
                          "collective": "all_reduce" if coll else "none",
                          "reduced": [list(c.shape) for c in coll]}
            check(same, f"mesh family {name} ({CARD}): {ms:.4f} ms, its "
                  f"collective " + (f"all_reduce of {rows[name]['reduced']} "
                                    f"{coll_ms:.4f} ms" if coll else
                                    "none on a world of one (no model axis)")
                  + ", equal to the single-device core"
                  + (f" within {LR_MESH_ATOL}" if name == "lr_step" else ""))
        torch.cuda.synchronize()
        secs["families"] = round(time.perf_counter() - t_phase, 3)
        t0 = time.perf_counter()
        obj = elearn_schema().to_json()
        for f in obj["fields"]:
            if f.get("feature"):
                f["splitScanInterval"] = 10
        text = generate_elearn(MESH_FIT_ROWS, seed=23, as_csv=True)
        ds = Dataset.from_csv(text, FeatureSchema.from_json(obj))
        secs["corpus"] = round(time.perf_counter() - t0, 3)
        fits = {}
        for kind, fit in (
                ("tree", lambda m: DecisionTreeBuilder(
                    ds.schema, max_depth=MESH_FIT_DEPTH, device=DEVICE
                ).fit(ds, mesh=m).to_json()),
                ("lr", lambda m: LogisticRegression(
                    iteration_limit=MESH_LR_ITERS, device=DEVICE
                ).fit(ds, mesh=m).coeff)):
            for label, m in (("fit", None), ("mesh", mesh)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fits[kind, label] = fit(m)
                torch.cuda.synchronize()
                secs[f"{kind}_{label}"] = round(time.perf_counter() - t0, 3)
        counts = _launch_counts()
    finally:
        multihost.shutdown()
    check(fits["tree", "mesh"] == fits["tree", "fit"],
          f"DecisionTreeBuilder.fit(mesh=) on {MESH_FIT_ROWS} e-learning "
          f"rows, depth {MESH_FIT_DEPTH} ({CARD}): {secs['tree_mesh']} s, "
          f"fit() {secs['tree_fit']} s; the decision paths identical")
    lr_err = float(np.abs(fits["lr", "mesh"] - fits["lr", "fit"]).max())
    check(lr_err <= LR_MESH_ATOL,
          f"LogisticRegression.fit(mesh=) on {MESH_FIT_ROWS} e-learning rows, "
          f"{MESH_LR_ITERS} iterations ({CARD}): {secs['lr_mesh']} s, fit() "
          f"{secs['lr_fit']} s; coefficients {lr_err:.3g} apart (tolerance "
          f"{LR_MESH_ATOL})")
    check(not any(counts.values()),
          f"{MESH_PATH} path: torch ops and NCCL, no kernel of the port's "
          f"own launched: {counts}")
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    print(f"mesh families ({CARD}; world of one, NCCL; two ranks on one "
          f"GPU are not allowed, so the multi-rank equality is the CPU "
          f"tests' gloo world): {json.dumps(rows)}", flush=True)
    return secs, rows, counts


LR_MESH_ATOL = 1e-7


def _count_oracle(name, args, params):
    """The plain counts of nb_train and crosscount (no single-device core
    of their own), by one `index_add_` on the card."""
    import torch

    def nb():
        codes, labels, w = args
        k, b = params
        f = codes.shape[1]
        key = ((torch.arange(f, device=codes.device)[None, :] * k
                + labels.long()[:, None]) * b + codes.long())
        post = torch.zeros(f * k * b, dtype=torch.int64, device=codes.device)
        post.index_add_(0, key.reshape(-1), torch.ones_like(key.reshape(-1)))
        cls = torch.zeros(k, dtype=torch.int64, device=codes.device)
        cls.index_add_(0, labels.long(), torch.ones_like(labels.long()))
        return post.reshape(f, k, b), cls

    def cross():
        a, b, w = args
        ba, bb = params
        out = torch.zeros(ba * bb, dtype=torch.int64, device=a.device)
        key = a.long() * bb + b.long()
        out.index_add_(0, key, torch.ones_like(key))
        return out.reshape(ba, bb)

    return nb if name == "nb_train" else cross



def _new_kernel_rows(checks, paths):
    """The kernels line's rows of NEW_KERNELS; `paths` maps each path to
    its launch counts. A merge kernel is launched once by each launch of
    its wrappers, so its launches are theirs."""
    rows = []
    for name, src, replaces, (row_name, metric, d, dtype), path, by in \
            NEW_KERNELS:
        row = next(r for r in checks if r["name"] == row_name
                   and r.get("metric") == metric and r["d"] == d
                   and r.get("dtype", "float32") == dtype
                   and r.get("kernel_fn") is None)
        by_path = {p: sum(counts[w] for w in by)
                   for p, counts in paths.items()}
        rows.append({
            "name": name, "route": "cuda",
            "source": f"avenir_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": by_path[path],
            "launches_by_path": by_path,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            **{k: row[k] for k in ("device_ms", "profiler_ms", "floor_ms",
                                   "floor_profiler_ms", "group", "blocks")
               if k in row}})
    return rows


def main() -> None:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        fail(f"torch unavailable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import avenir_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the avenir_tpu_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_card()
    flops, rate, bf16_flops = peaks(torch.cuda.get_device_name(0))
    checks = phase_kernels(flops, rate)
    launches = phase_main_path()
    check_counts = phase_kernel_check()
    checks += phase_packed_bf16(flops, rate, bf16_flops, checks)
    sweep_counts = phase_sweep()
    path_counts = {n: check_counts[n] + sweep_counts[n] for n in check_counts}
    check(min(v for n, v in path_counts.items()
              if n not in ("matmul_ceiling", "subseq_support_fold",
                           "centre_sums", "metropolis_walk")) >= 1,
          f"{CHECK_PATH} launched every KNN kernel: {path_counts}")
    nb_secs = phase_naive_bayes()
    ceiling = phase_ceiling(rate, bf16_flops)
    bench_counts = phase_bench()
    pipe_counts = phase_pipeline()
    profile_secs = phase_profile()
    t0 = time.perf_counter()
    tree_secs = phase_tree_text()
    t_tree = time.perf_counter() - t0
    t0 = time.perf_counter()
    assoc_secs = phase_association()
    t_assoc = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq_secs, seq_counts, seq_row = phase_sequence(flops, rate)
    t_seq = time.perf_counter() - t0
    t0 = time.perf_counter()
    bandit_secs = phase_bandits()
    t_bandit = time.perf_counter() - t0
    t0 = time.perf_counter()
    markov_secs, markov_rows = phase_markov(flops, rate)
    t_markov = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream_secs, stream_counts, stream_figs = phase_stream(rate, bf16_flops)
    t_stream = time.perf_counter() - t0
    t0 = time.perf_counter()
    last_secs, last_rows, tmc_counts, km_counts, centre_row = phase_last(
        flops, rate)
    t_last = time.perf_counter() - t0
    t0 = time.perf_counter()
    score = phase_score()
    t_score = time.perf_counter() - t0
    lib_secs, walk_row, lib_counts, lib_rows = phase_library(flops, rate)
    conf_secs, conf_counts = phase_conf()
    mesh_secs, mesh_rows, mesh_counts = phase_mesh()
    print(f"naive bayes seconds: {json.dumps(nb_secs)}", flush=True)
    print(f"profile seconds ({CARD}): {json.dumps(profile_secs)}", flush=True)
    print(f"tree and text seconds ({CARD}; phase 10 "
          f"{t_tree:.1f}s): {json.dumps(tree_secs)}", flush=True)
    print(f"association seconds ({CARD}; phase 11 "
          f"{t_assoc:.1f}s): {json.dumps(assoc_secs)}", flush=True)
    print(f"sequence seconds ({CARD}; phase 12 {t_seq:.1f}s): "
          f"{json.dumps(seq_secs)}", flush=True)
    print(f"bandit seconds ({CARD}; phase 13 {t_bandit:.1f}s): "
          f"{json.dumps(bandit_secs)}", flush=True)
    print(f"markov seconds ({CARD}; phase 14 {t_markov:.1f}s): "
          f"{json.dumps(markov_secs)}", flush=True)
    print(f"markov device programs, torch ops, not kernels ({CARD}): "
          f"{json.dumps(markov_rows)}", flush=True)
    print(f"stream seconds ({CARD}; phase 15 {t_stream:.1f}s): "
          f"{json.dumps(stream_secs)}", flush=True)
    print(f"stream figures ({CARD}): {json.dumps(stream_figs)}", flush=True)
    print(f"last-jobs seconds ({CARD}; phase 16 {t_last:.1f}s): "
          f"{json.dumps(last_secs)}", flush=True)
    print(f"LR and k-means device programs ({CARD}; LR torch ops, k-means "
          f"torch ops and centre_sums): {json.dumps(last_rows)}", flush=True)
    print(f"score plane ({CARD}; phase 17 {t_score:.1f}s): "
          f"{json.dumps(score)}", flush=True)
    print(f"library seconds ({CARD}; phase 18 {lib_secs['phase']}s): "
          f"{json.dumps(lib_secs)}", flush=True)
    print(f"library device programs ({CARD}; the SVM and the net torch ops, "
          f"the walk metropolis_walk): {json.dumps(lib_rows)}", flush=True)
    print(f"conf seconds ({CARD}; phase 19 {conf_secs['phase']}s): "
          f"{json.dumps(conf_secs)}", flush=True)
    print(f"mesh seconds ({CARD}; phase 20 {mesh_secs['phase']}s): "
          f"{json.dumps(mesh_secs)}", flush=True)
    print(f"chip_smoke.py total {time.perf_counter() - t_start:.1f}s "
          f"({CARD})", flush=True)
    paths = {"nearestNeighbor": launches, CHECK_PATH: path_counts,
             BENCH_PATH: bench_counts, PIPE_PATH: pipe_counts,
             SEQ_PATH: seq_counts, STREAM_PATH: stream_counts,
             TMC_PATH: tmc_counts, KMEANS_PATH: km_counts,
             LIB_PATH: lib_counts, CONF_PATH: conf_counts,
             MESH_PATH: mesh_counts}

    # each kernel's row at the shape of the path it is reported on: the
    # job's (manhattan, D=6) for the three it runs; the sweep's
    # (euclidean, D=128) for the packed kernel, which only the second path
    # runs
    main_shape = {"knn_topk": ("manhattan", 6, None),
                  "knn_topk_lanes": ("manhattan", 6, None),
                  "knn_classify_lanes": ("manhattan", 6, "gaussian"),
                  "knn_topk_packed": ("euclidean", 128, None)}
    sources = {"knn_topk": ("knn_topk.cu", 99),
               "knn_topk_lanes": ("knn_topk.cu", 223),
               "knn_classify_lanes": ("knn_classify.cu", 426),
               "knn_topk_packed": ("knn_topk.cu", 131)}
    kernels = []
    for name, (metric, d, fn) in main_shape.items():
        row = next(r for r in checks if r["name"] == name and r["metric"] == metric
                   and r["d"] == d and r.get("kernel_fn") == fn
                   and r.get("dtype", "float32") == "float32")
        src, line = sources[name]
        by_path = {p: counts[name] for p, counts in paths.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"avenir_tpu_torch/ops/csrc/{src}",
            "replaces": f"avenir_tpu/ops/pallas_knn.py:{line}",
            "launches": by_path[CHECK_PATH if name == "knn_topk_packed"
                                else "nearestNeighbor"],
            "launches_by_path": by_path, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    pre = next(r for r in checks if r["name"] == "knn_prepass"
               and r["d"] == 128 and r["dtype"] == "float32")
    kernels.append({
        "name": "knn_prepass", "route": "cuda",
        "source": "avenir_tpu_torch/ops/csrc/knn_prepass.cu",
        "replaces": "avenir_tpu/ops/pallas_knn.py:54",
        "launches": path_counts["knn_prepass"],
        "launches_by_path": {p: counts["knn_prepass"]
                             for p, counts in paths.items()},
        **{k: pre[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "device_ms",
                               "profiler_ms")}})
    kernels.append({
        "name": "matmul_ceiling", "route": "cuda",
        "source": "avenir_tpu_torch/ops/csrc/matmul_ceiling.cu",
        "sources": ["avenir_tpu_torch/ops/csrc/matmul_ceiling.cu",
                    "avenir_tpu_torch/ops/csrc/wgmma_bf16.cuh"],
        "replaces": "bench.py:797", "launches": bench_counts["matmul_ceiling"],
        "launches_by_path": {p: counts["matmul_ceiling"]
                             for p, counts in paths.items()},
        **{k: ceiling[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    kernels += _new_kernel_rows(checks, paths)
    kernels.append({
        "name": "subseq_support", "route": "cuda",
        "source": "avenir_tpu_torch/ops/csrc/subseq_support.cu",
        "replaces": "avenir_tpu/models/sequence.py:84 (XLA scan, not Pallas)",
        "launches": seq_counts["subseq_support_fold"],
        "launches_by_path": {p: counts["subseq_support_fold"]
                             for p, counts in paths.items()},
        **{k: seq_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "block", "candidates", "c_pad", "routes",
                                   "lookup_steps", "lookup_bound_ms",
                                   "walk_steps", "walk_bound_ms",
                                   "walk_route_ms")}})
    kernels.append({**centre_row, "launches": km_counts["centre_sums"],
                    "launches_by_path": {p: counts["centre_sums"]
                                         for p, counts in paths.items()}})
    kernels.append({**walk_row, "launches": lib_counts["metropolis_walk"],
                    "launches_by_path": {p: counts["metropolis_walk"]
                                         for p, counts in paths.items()}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

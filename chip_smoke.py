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
   1..MAX_D, and against float64 oracles at D 6, 37, 128 and 300
   (kernel_check's bfloat16 bar: rtol 2e-2, recall >= 0.999; the true
   distances wherever the plain bfloat16 version meets them, the bf16 dot
   form's own everywhere). The merge kernels alone on ragged split lists
   (splits 1 to 65, every carry width, empty queries, ties, sign bits, keys at
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
   byte-identical to the same job's run with device="cpu". Each run
   parses (stream.sidecar=false) but one more native run on the card,
   the default, which also packs the columnar sidecar: its seconds beside
   the parsing run's are the pack's cost. Then `bayesianPredictor` on a 100,000-row churn test
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
13. The bandits (after phase 12): 25,000 groups x 10 arms of seeded
   stats, the four jobs (greedyRandomBandit logLinear, auerDeterministic,
   randomFirstGreedyBandit, softMaxBandit; batch 3) through
   `pipelines.bandit_round` at rounds 1 and 10 on the card and the
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
   The NB CSV leg at STREAM_NB_CSV_ROWS = 10,000,000 rows (about 380 MB
   in 4 MB blocks; cut from the root bench's 100,000,000, and from
   20,000,000 to make room for phase 26): its model
   and stamp byte-identical to `bayesianDistr` through `run_job` on the
   same file at stream.prefetch.depth=1, parsing (the sidecar off) and
   then by default (parsing and packing the sidecar), its peak RSS over
   its start under 1 GB. Each leg's rows/s, overlap efficiency and stall seconds.
   The depth bar: the streamed jobs of phases 6, 9, 11, 12 and 14
   (bayesianDistr, the fused profile run, the per-class Markov model,
   streamed Apriori and streamed GSP) on their corpora, written again
   as those phases write them, at stream.prefetch.depth 2, 1 and 8 (the
   sidecar off, so that each depth parses), every
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
   stats of 25,000 groups x 10 arms), and an NB model with three
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
21. The sharded driver (`dist/`) on the card, the kernels built first in
   this process so that no worker runs nvcc: `mutualInformation` and
   `bayesianDistr` on phase 6's 1,000,000 churn train rows, the per-class
   `markovStateTransitionModel` on phase 14's 1,000,000 chain rows,
   `frequentItemsApriori` on phase 11's 1,000,000 baskets and GSP on phase
   12's 1,000,000 sequences (4 MB blocks), the sidecar off in every run
   (Shard:ParseSpans > 0 and no replay: the workers parse their byte
   ranges), each through
   `run_sharded(procs=2, device="cuda")` (GSP at procs=4 through the API
   and at procs=2 through the CLI, below), worker
   processes that fold on the card and, for the miners, count the per-k
   rounds by replaying their encoded-block caches; every artifact
   byte-identical to the job's solo `run_job` on the card, with the solo
   and sharded seconds, the `Shard:*` and `Cache:*` counters, and each
   worker's `scan_s` and `perk_s`. GSP's workers must launch
   `subseq_support.cu` (they report their launches in their stats files)
   and run at least one per-k round. Then the SIGSTOP chaos leg on
   `mutualInformation` (`tools.bench_scaling.chaos_leg`: a worker stopped
   on an uncommitted claim, resumed after the run: every block committed,
   `Shard:DedupBlocks` >= 1, bytes equal to the solo run's), workers that
   see no card (`CUDA_VISIBLE_DEVICES` empty) failing the run with
   `ShardError` and writing nothing, and GSP's run at procs=2 as
   `python -m avenir_tpu_torch candidateGenerationWithSelfJoin --shard 2`
   in a fresh process, its line holding its workers' stats: bytes equal
   to the solo run's, per-k rounds and the workers' launches as above.
   Phases 6, 11, 12 and 14 leave their corpora
   in `build/chip_smoke_corpora/` for it and phases 22-23 (phase 3 its
   e-learning CSVs for phase 23, which removes the directory).
22. The delta scan and the columnar sidecar (after phase 21, on copies of
   its churn rows and sequences; 4 MB blocks): a cold `run_incremental`
   of mutualInformation, bayesianDistr, fisherDiscriminant and GSP, each
   checkpointing its carry, then an append of INCR_APPEND_ROWS = 10,000
   churn rows and sequences (1%, seed 202), the cold `run_job` of each on
   the grown files (the sidecar off, a full parse) and its timed refresh:
   every refresh byte-identical to its cold twin, Resume:SkippedBytes and
   Cache:HitBlocks > 0, the seconds and their ratio printed; GSP's
   refresh (its restored miner re-parses every per-k round) launching
   `subseq_support.cu` exactly as often as its cold twin.
   `run_incremental_shared` of the three dataset jobs from copies of
   their seeded states (one delta scan) equal to the solo refreshes;
   `run_sharded_refresh` of mutualInformation at 2 workers equal to the
   solo refresh and the cold run. The sidecar: mutualInformation and GSP
   pack on a cold `run_job` (Sidecar:DeltaBlocks >= 1), then replay with
   Sidecar:HitBlocks equal to the blocks packed, none parsed and no
   `stream.parse` span (GSP's replay still launching the count kernel a
   level), every file equal to its cold twin's; `run_sharded` over the
   warm sidecar with Shard:ParseSpans == 0. Then a child interpreter
   killed (os._exit) at its first mid-scan checkpoint
   (stream.checkpoint.interval.mb = 8), and the resume from it:
   Resume:SkippedBytes equal to the checkpoint's watermark, bytes equal
   to the cold run's.
23. The resident job server and the network edge (`server/`, `net/`) on
   the card. One `JobServer(workers=1)` takes bayesianDistr,
   mutualInformation and fisherDiscriminant from three tenants over
   phase 6's 1,000,000 churn rows (the sidecar off, so the scan parses),
   submitted before `start()`: Server:BatchSize 3, each file equal to the
   solo `run_job` on the card and to its CPU twin, the batch's seconds
   printed beside the solo runs' sum. Phase 3's nearestNeighbor served
   in its default and fused-vote modes: each file equal to phase 3's,
   `knn_topk` / `knn_classify_lanes` launched. GSP on phase 12's
   sequences served twice: the second a warm hit (the pinned spill
   cache: no `stream.parse` span, as many `subseq_support` launches as
   the first, the same files); then a refresh request seeds the managed
   checkpoint, SERVE_APPEND_ROWS sequences are appended, and a second
   refresh restores it (Resume:SkippedBytes > 0) to a cold run's bytes.
   A `NetListener` on 127.0.0.1:0: `POST /submit?wait=1` equal to the
   solo run; SERVE_SCORES `POST /score` calls (the trio's NB model on
   churn rows) over one keep-alive socket, each equal to `score_once`,
   their p50 and p99 ms printed; `/metrics` and `/healthz`; one
   deterministic 429 with Retry-After (a fixed pricer, the server not yet
   started), then the held request served. A `Fleet` of SERVE_HOSTS
   hosts (`serve --spool --device cuda`, fresh interpreters on the one
   card): four requests, one host SIGKILLed after placement, every row
   ok and equal to its solo bytes, requeues >= 1, no lease left.
24. The autotune loop (`tune/`) on the card (after phase 23, which leaves
   phase 6's churn rows and phase 12's sequences in CORPORA; this phase
   removes them). (a) The fused churn trio (bayesianDistr,
   mutualInformation, fisherDiscriminant; the sidecar off) through
   `run_shared` with `stream.autotune` on: pass 1 at the static knobs
   records its signal row and chooses knobs (printed with their reasons
   and the Mem:* counters), pass 2 applies them; every file of pass 2
   equal to pass 1's and to the CPU twin's at the same knobs, and
   Mem:PredictedPeakBytes equal to the twin's. The static pass again,
   not recording, under torch.profiler: its device busy share beside the
   host-clock signal row the tuner reads (spans never synchronize the
   device). (b) candidateGenerationWithSelfJoin (length 2, the sidecar
   off) over two sources of TUNE_GSP_ROWS made rows whose codes spill 61
   bytes a row, under an explicit `stream.encoded.cache.budget.mb` of 64:
   pass 1 evicts one source, the tuned pass 2 runs under the budget the
   cache rule chose and evicts nothing; the same files and as many
   `subseq_support` launches. (c) `JobServer(autotune_dir=)` serves the
   autotuned trio and phase 12's GSP: its tuned price at least the bare
   model's, the balancer's batch sizes printed, every file equal to pass
   1's and to a solo GSP run's. (d) `python -m avenir_tpu_torch tune
   <dir>` exits 0 and lists the trio's and GSP's profiles.
25. The auditors on the card (`analysis/`, `obs/coverage.py`), over the
   eight stream entries of `analysis.manifest.stream_entries("cuda")`
   (NB, MI, Fisher, Markov, Apriori and GSP alone, the churn trio and
   Markov + Apriori fused; their own small corpora, the sidecar off):
   the flow audit (three chunk layouts and the adversarial scheduler,
   byte-identical), the mem audit (the sampled RSS in the model's band at
   two block sizes, the CUDA context and every kernel library loaded
   before the sampled window), the merge audit (shards of 2 and 4, the
   mid-scan resume, the delta scan killed and resumed, solo and fused,
   the sharded steal's duplicate rejected) and span coverage; each row is
   printed and every verdict must be validated, with no finding past the
   allowlist. Then the memory manifest's kernel rows measured around one
   call each (`cuda_peak`), the miner tripwire at AUDIT_MINER_ROWS rows
   (Basic:Records equal to the rows, the encoded-block cache replayed and
   smaller than its CSV, at most the subsequence library bound, and no
   nvcc run or bind at four times the blocks) and the shared-scan
   tripwire at AUDIT_SHARED_ROWS (byte-identical, at least 1.3x, no nvcc
   run or bind in the fused pass). The GSP entries' and
   the miner tripwire's `subseq_support` launches are the `audit` path.
26. The host services on the card: the AST rules over the port's
   package (`analysis/rules.py`), then the keys audit over all 11 key
   sites (each registered input dimension moved one at a time; its jobs,
   Apriori, the Markov model, its incremental run and the Markov scorer,
   on cuda), the proto audit over all 13 commit sites (each killed
   before and after its rename in a fresh interpreter, recovered
   byte-identical) and the race audit over all 8 interleave sites
   (every two-way choice to depth RACE_DEPTH, then RACE_SEEDS seeded
   schedules a site; two resident actor interpreters); each tier's rows,
   its findings past the allowlist (none), its seconds and its launches,
   which are the `host_services` path.
27. The IR tier on the card (`analysis/ir.py`): `run_ir(device="cuda")`
   over the kernel manifest, the seven op entries on the card (each
   called once to warm, then recorded under a dispatch mode and
   `torch.cuda.set_sync_debug_mode("warn")`) and the eight families on a
   gloo world of eight CPU ranks. A row an entry: its ops, the
   synchronizing calls the card reported and the lines they returned to,
   the device-to-host reads the host rules saw (in loops and not),
   the libraries it bound and their fp64 SASS hits (`cuobjdump -sass`),
   its findings; and a row a family: the collective bytes its process
   group was handed, recorded and modelled. Fails unless the report is
   clean under the allowlist with 8 families validated, every
   synchronizing call the card reported returned to a line where the
   capture recorded an op the host rules read as a device-to-host read
   (`Capture.unexplained_syncs`), the SASS leg read the
   two libraries the `knn_topk_pallas` entry bound, and `knn_topk` and
   `knn_prepass` were launched; the entry's output (q [128, 8], t [256,
   8], euclidean, k=5) then holds `knn_topk_plain` at rtol 1e-4, atol
   1e-5, indices apart only at ties. Its launches are the `ir` path.

Phases 4 and 5's sweep are the second path, phase 7's bench the third and
phase 8's pipeline the fourth, phase 12's GSP runs the fifth, phase 15's
KNN stream legs the sixth, phase 16's topMatchesByClass the seventh and
its k-means the eighth, phase 18's library modules the ninth, phase
19's conf jobs the tenth and phase 20's mesh the eleventh (no kernel on
either), phase 21's sharded workers the twelfth (`shard`: the
launches the workers report, summed), phase 22's refreshes, sidecar
packs and replays the thirteenth (`incremental`), phase 23's served
requests the fourteenth (`serve`), phase 24's autotuned runs the
fifteenth (`tune`), phase 25's audits the sixteenth (`audit`),
phase 26's host services the seventeenth (`host_services`) and phase
27's IR entries the eighteenth (`ir`): each
kernel's launches are counted from zero on each path. Then one JSON
line of per-kernel numbers (the pre-pass beside the five kernels, at the
sweep's D=128 float32; the tensor-core form at the bench's D=128
bfloat16; the two merge kernels at the job's shape; the walk at the
first 200,000 steps of phase 18's plain chain), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
before them the script's total seconds.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NQ, NT, K = 8192, 131072, 5
#: phase 3's job conf and the files of its modes, which phase 23 serves
#: again (its train and test CSVs stay in CORPORA)
MAIN_PATH: dict = {}
CHECK_ROWS = 1024
DEVICE = "cuda"
#: the columnar sidecar off (an unprefixed key, which every job's config
#: reads), where a run must parse: the twins that time the parse, the
#: depth bar, the sharded workers of phase 21
SIDECAR_OFF = {"stream.sidecar": "false"}

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
#: phase 13: the bandit stats (25,000 groups; at 100,000, which phase 17
#: inherits, the whole script ran 992.2 s on an NVIDIA H100 80GB HBM3 at
#: 700 W, too near its 1200 s limit on a host 1.22x slower), the rounds,
#: each job's keys (batch 3)
BANDIT_GROUPS, BANDIT_ARMS, BANDIT_SEED = 25_000, 10, 31
BANDIT_ROUNDS = (1, 10)
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
#: root bench's 100,000,000 and 2,000,000; the NB leg from 20,000,000 to
#: make room for phase 26), the blocks of the merge check
STREAM_PATH = "knn_stream"
STREAM_NB_CSV_ROWS, STREAM_KNN_CSV_ROWS = 10_000_000, 500_000
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
    _check_mma_schedule()


def _check_mma_schedule() -> None:
    """The tensor-core form's persistent schedule (blocks, segments) as
    its C side plans it (knn_topk_mma_plan, knn_classify_mma_plan) equals
    knn_kernels.mma_schedule, which the wrapper launches with, at every
    carry width on the bench's, the stream leg's, ragged and empty shapes
    over this card's SMs."""
    import ctypes

    import torch

    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.ops import knn_kernels as kk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = ((NQ, NT), (512, 524288), (300, 2900), (5, 0), (1, 1),
              (100000, 1000))
    bad, n = [], 0
    for name in ("knn_topk", "knn_classify"):
        entry = getattr(_build.load(name), f"{name}_mma_plan")
        for k in (5, 16, 32, 64):
            for nq, nv in shapes:
                out = (ctypes.c_int * 2)()
                err = entry(k, nq, nv, sms, out)
                n += 1
                if err or tuple(out) != kk.mma_schedule(nq, nv, k, sms):
                    bad.append(f"{name}/k={k}/{nq}x{nv}: {err} {tuple(out)}")
    check(not bad, f"tensor-core schedule: {n} (blocks, segments) plans of "
          f"the C side equal knn_kernels.mma_schedule on {sms} SMs"
          + (f"; not {bad}" if bad else ""))


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
    norms alone (float32) and norms with bfloat16 rows (zero-padded to a
    multiple of 16 features, the tensor-core form's operands)."""
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
        nbytes = n * d * 4 + n * 4 + (n * kk._depth16(d) * 2 if bf16 else 0)
        ops_ms, bytes_ms = 2 * n * d / flops * 1e3, nbytes / rate * 1e3
        bound, bound_by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                           else (bytes_ms, "bytes"))
        # the norms alone are one PyTorch call; nothing computes the pair
        lib_ms = None if bf16 else cuda_ms(
            lambda: torch.einsum("ij,ij->i", qt, qt), 20)
        out = [torch.empty(n, dtype=torch.float32, device=q.device) for n
               in (NQ, NT)] + ([torch.empty((n, kk._depth16(d)),
                                            dtype=torch.bfloat16,
                                            device=q.device) for n in (NQ, NT)]
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


def _device_busy(run, rec_out: list = None) -> dict:
    """torch.profiler's device time over one call of run() (a job, or a
    shared scan), and its share of the `job.run` seconds (of the call's
    wall seconds where it records no job.run): kernels, and kernels with
    copies and sets. `rec_out`, when given, receives the span recorder of
    the call."""
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
    if rec_out is not None:
        rec_out.append(rec)
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
    MAIN_PATH.update(base=base, files={})
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
        MAIN_PATH["files"][mode] = _files_of(res)
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
    _keep(Path(train), "elearn_train.csv")
    _keep(Path(test), "elearn_test.csv")
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
    _check_mma_oracle()
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


def _bf16_oracle(q, t):
    """[nq, nt] float64 attribute-averaged distances of the bfloat16 dot
    form itself: |q|^2 + |t|^2 of the float32 values less twice the cross
    term of the bf16-rounded operands, clamped at 0, all in float64 (8
    queries at a time)."""
    import numpy as np
    import torch

    def rows(x):
        return torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    qb, tb = rows(q), rows(t)
    qn = (q.astype(np.float64) ** 2).sum(1)
    tn = (t.astype(np.float64) ** 2).sum(1)
    out = np.empty((q.shape[0], t.shape[0]))
    for s in range(0, q.shape[0], 8):
        d2 = qn[s:s + 8, None] + tn[None, :] - 2.0 * (qb[s:s + 8] @ tb.T)
        out[s:s + 8] = np.sqrt(np.maximum(d2, 0.0) / q.shape[1])
    return out


def _check_mma_oracle() -> None:
    """kernel_check's bfloat16 bar on the tensor-core form at every carry
    width and mode: D 6, 37, 128 and 300, 256 queries against 3000 train
    rows of which 2900 valid (seeded normals, as kernel_check draws).
    Top-k modes (exact, lanes, packed): distances within rtol 2e-2 (atol
    1e-5) and tie-tolerant recall >= 0.999 (kernel_check.topk_faults). The
    vote (labels, kernel none, 3 classes): each query's class counts equal
    to those of the oracle's k nearest, unless the oracle's k-th and
    (k + 1)-th distances lie within 2 x 2e-2 of each other (a tie at the
    boundary). Two float64 oracles: the bfloat16 dot form's own distances
    (_bf16_oracle), which every case must meet; and the true distances
    (kernel_check.oracle), which a case must meet wherever the plain
    bfloat16 version (the same function in torch ops) meets them: the dot
    form's bf16 cancellation may put the true bar out of its reach (at D=6
    on these data), and the line says where. Each call one launch on
    knn_partial_mma."""
    import numpy as np
    import torch

    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools import kernel_check

    rtol, nv, bad, n, out_of_reach = 2e-2, 2900, [], 0, []
    rng = np.random.default_rng(11)
    modes = {"exact": kk.knn_topk, "lanes": kk.knn_topk_lanes,
             "packed": kk.knn_topk_packed, "labels": kk.knn_classify_lanes}

    def faults(mode, got, oracle, k, lh):
        if mode != "labels":
            return kernel_check.topk_faults(got[0], got[1], oracle, k, rtol)
        order = np.argsort(oracle, axis=1, kind="stable")
        want = np.stack([np.bincount(lh[order[i, :k]], minlength=3)
                         for i in range(oracle.shape[0])])
        srt = np.take_along_axis(oracle, order[:, :k + 1], 1)
        tied = srt[:, k] - srt[:, k - 1] <= 2 * rtol * srt[:, k - 1]
        wrong = (got != want).any(1) & ~tied
        return [f"{int(wrong.sum())} votes off"] if wrong.any() else []

    for d in (6, 37, 128, 300):
        qh = rng.normal(size=(256, d)).astype(np.float32)
        th = rng.normal(size=(3000, d)).astype(np.float32)
        lh = rng.integers(0, 3, 3000).astype(np.int32)
        true, form = (kernel_check.oracle(qh, th[:nv], "euclidean"),
                      _bf16_oracle(qh, th[:nv]))
        q, t = torch.from_numpy(qh).to(DEVICE), torch.from_numpy(th).to(DEVICE)
        labels = torch.from_numpy(lh).to(DEVICE)
        for k in (5, 16, 32, 64):
            for mode, wrap in modes.items():
                args = ((q, t, labels, k, 3, None, "none", 1.0, "euclidean",
                         nv) if mode == "labels"
                        else (q, t, k, "euclidean", nv))
                plain = getattr(kk, wrap.__name__ + "_plain")
                n0 = kk.knn_partial_mma.launches
                got = wrap(*args, compute_dtype="bfloat16")
                launched = kk.knn_partial_mma.launches - n0
                ref = plain(*args, compute_dtype="bfloat16")
                got, ref = ([x.cpu().numpy() for x in r] if mode != "labels"
                            else r.cpu().numpy() for r in (got, ref))
                why = faults(mode, got, form, k, lh)
                if faults(mode, ref, true, k, lh[:nv]):
                    out_of_reach.append(f"D={d}/k={k}/{mode}")
                else:
                    why = why + faults(mode, got, true, k, lh[:nv])
                n += 1
                if why or launched != 1:
                    bad.append(f"D={d}/k={k}/{mode}: {why or launched}")
    check(not bad, f"tensor-core form against float64 oracles, D 6/37/128/"
          f"300, k 5/16/32/64, 4 modes (kernel_check's bfloat16 bar: rtol "
          f"{rtol}, recall >= 0.999; votes equal but at boundary ties): "
          f"{n - len(bad)} of {n} hold against the bf16 form's oracle and, "
          f"where the plain bfloat16 version meets it, the true one; the "
          f"true bar out of the plain version's reach in "
          f"{len(out_of_reach)} cases ({', '.join(out_of_reach) or 'none'})"
          f"; one launch each" + (f"; not {bad}" if bad else ""))


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
    # each run parses (the sidecar off) but `{DEVICE}_pack`, the default,
    # which parses and packs the columnar sidecar: its cost is the
    # difference
    models, secs = {}, {}
    for dev, engine, key in ((DEVICE, "native", DEVICE),
                             (DEVICE, "native", f"{DEVICE}_pack"),
                             (DEVICE, "python", f"{DEVICE}_python"),
                             ("cpu", "native", "cpu")):
        props = {**distr, "csv.engine": engine,
                 **({} if key.endswith("_pack") else SIDECAR_OFF)}
        models[key] = work / f"model_{key}.csv"
        res, secs[key] = timed("bayesianDistr", props, [str(train)],
                               models[key], dev, [engine])
        packed = res.counters["Sidecar:DeltaBlocks"]
        check(res.counters["Distribution Data:Records"] == NB_TRAIN_ROWS
              and (packed >= 1 if key.endswith("_pack") else not packed),
              f"bayesianDistr {key}, engine={engine}: {secs[key]:.2f}s, "
              f"{res.counters}")
    same = all((work / f"model_{key}.csv{ext}").read_bytes()
               == (work / f"model_cpu.csv{ext}").read_bytes()
               for ext in ("", ".stamp.json")
               for key in (DEVICE, f"{DEVICE}_pack", f"{DEVICE}_python"))
    check(same, "bayesianDistr: model file and stamp byte-identical to the "
          "CPU run's under both parsers and with the sidecar's pack")
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
    _keep(train, "churn_train.csv")
    shutil.rmtree(work)
    return {"distr_s": secs[DEVICE], "distr_pack_s": secs[f"{DEVICE}_pack"],
            "distr_python_s": secs[f"{DEVICE}_python"],
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
                  "mut.mutual.info.score.algorithms": MI_ALGOS,
                  # the sidecar off: the runs parse, so the reads compare
                  "stream.sidecar": "false"})
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
    _keep(corpus["baskets"], "baskets.csv")
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
    _keep(Path(csv), "seq.csv")
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
    """The four bandit jobs through `bandit_round` at rounds 1 and 10 on
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

    # fused with GSP through run_shared: one scan (the sidecar off, so
    # each run reads the text and the reads compare)
    cgs = {"cgs.support.threshold": "0.02", "cgs.item.set.length": "2",
           "cgs.skip.field.count": "2", "cgs.stream.block.size.mb": "4",
           "cgs.stream.sidecar": "false"}
    mst_off = {**mst, "mst.stream.sidecar": "false"}
    fused, fused_blocks = _blocks_read(lambda: timed(
        "run_shared", DEVICE, lambda: run_shared(
            [(MARKOV_PATH, mst_off, str(work / "fused_mst.txt")),
             ("candidateGenerationWithSelfJoin", cgs,
              str(work / "fused_gsp"))], [chains], device=DEVICE)))
    _, mst_blocks = _blocks_read(lambda: run_job(
        MARKOV_PATH, mst_off, [chains], str(work / "solo_mst.txt"),
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
    _keep(Path(chains), "chains.csv")
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
    # the sidecar off: each depth parses (a repeat run would replay)
    distr = {"bad.feature.schema.file.path": c["schema"],
             "bad.stream.block.size.mb": "4", "csv.engine": "native",
             **SIDECAR_OFF}
    profile = {f"{p}.stream.block.size.mb": "4" for p in ("bad", "mut", "fid")}
    profile.update({"csv.engine": "native",
                    "mut.mutual.info.score.algorithms": MI_ALGOS,
                    **SIDECAR_OFF})
    mst = {"mst.model.states": ",".join(MARKOV_STATES),
           "mst.skip.field.count": "2", "mst.class.label.field.ord": "1",
           "mst.class.labels": "C,L", "mst.stream.block.size.mb": "4",
           **SIDECAR_OFF}
    jobs = {
        "bayesianDistr": ("bad", distr, lambda p, out: [run_job(
            "bayesianDistr", p, [c["churn"]], out + ".csv", device=DEVICE)]),
        "profile_pipeline_fused": (None, profile, lambda p, out: list(
            profile_pipeline(p, c["churn"], out, schema_path=c["schema"],
                             device=DEVICE).run(fuse=True).values())),
        MARKOV_PATH: ("mst", mst, lambda p, out: [run_job(
            MARKOV_PATH, p, [c["chains"]], out + ".txt", device=DEVICE)]),
        "frequentItemsApriori": ("fia", {**ASSOC_PROPS, **ASSOC_BLOCK,
                                         **SIDECAR_OFF},
                                 lambda p, out: [run_job(
                                     "frequentItemsApriori", p,
                                     [c["baskets"]], out, device=DEVICE)]),
        "candidateGenerationWithSelfJoin": (
            "cgs", {**GSP_PROPS, **GSP_BLOCK, **SIDECAR_OFF},
            lambda p, out: [run_job(
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
    # the job parsing (the sidecar off), then as a user runs it by
    # default: parsing and packing the columnar sidecar
    nb_job = {"bad.feature.schema.file.path": str(schema),
              "bad.stream.block.size.mb": "4",
              "bad.stream.prefetch.depth": "1", "csv.engine": "native"}
    jobs = {}
    for key, props in (("nb_csv_job_depth1", {**nb_job, **SIDECAR_OFF}),
                       ("nb_csv_job_depth1_pack", nb_job)):
        torch.cuda.synchronize()
        t_job = time.perf_counter()
        jobs[key] = run_job("bayesianDistr", props, [str(path)],
                            str(work / f"{key}.csv"), device=DEVICE)
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t_job
    same = all((work / f"nb_leg.csv{e}").read_bytes()
               == (work / f"{key}.csv{e}").read_bytes()
               for e in ("", ".stamp.json") for key in jobs)
    packed = [res.counters["Sidecar:DeltaBlocks"] for res in jobs.values()]
    check(same and nb_csv["csv_peak_rss_mb"] < 1024
          and all(res.counters["Distribution Data:Records"]
                  == STREAM_NB_CSV_ROWS for res in jobs.values())
          and packed[0] == 0 and packed[1] >= 1,
          f"NB CSV leg, {STREAM_NB_CSV_ROWS} rows ({nb_csv['csv_bytes']} "
          f"bytes, 4 MB blocks) ({CARD}): {json.dumps(nb_csv)}; model and "
          f"stamp byte-identical to bayesianDistr at stream.prefetch.depth=1 "
          f"({secs['nb_csv_job_depth1']:.2f}s parsing, "
          f"{secs['nb_csv_job_depth1_pack']:.2f}s packing {packed[1]:.0f} "
          f"sidecar blocks); peak RSS "
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



# ----------------------------------------------------------------- phase 21
#: phase 21: the sharded driver's path; the workers of each run (GSP's
#: run through the API; its run at SHARD_PROCS is the CLI's), each run's
#: time limit, and the corpora the earlier phases
#: leave behind for it (each made anew, from the same generator and seed,
#: when phase 21 runs alone)
SHARD_PATH = "shard"
SHARD_PROCS, SHARD_GSP_PROCS = 2, 4
SHARD_TIMEOUT_S = 300.0
CORPORA = ROOT / "build" / "chip_smoke_corpora"


def _keep(path: Path, name: str) -> None:
    """Move an earlier phase's corpus into CORPORA for phase 21."""
    CORPORA.mkdir(parents=True, exist_ok=True)
    shutil.move(str(path), str(CORPORA / name))


def _shard_corpora(work: Path) -> dict:
    """Phase 21's inputs: phase 6's churn train rows, phase 11's baskets,
    phase 12's sequences and phase 14's chains, kept by those phases, or
    written here from their generators and seeds."""
    from avenir_tpu_torch.data import (generate_churn,
                                       generate_markov_chains)
    from avenir_tpu_torch.tools import bench

    t0 = time.perf_counter()
    out, made = {}, []
    for key, name in (("churn", "churn_train.csv"), ("baskets", "baskets.csv"),
                      ("seq", "seq.csv"), ("chains", "chains.csv")):
        path = CORPORA / name
        if not path.exists():
            made.append(key)
            CORPORA.mkdir(parents=True, exist_ok=True)
            if key == "churn":
                path.write_text(generate_churn(NB_TRAIN_ROWS, seed=201,
                                               as_csv=True))
            elif key == "baskets":
                picks = bench.apriori_picks(ASSOC_TX, seed=4)
                path.write_text("".join(
                    ",".join([f"T{r}", *(f"i{j}" for j in row)]) + "\n"
                    for r, row in enumerate(picks.tolist())))
            elif key == "seq":
                _keep(Path(_sequence_corpus(work)[0]), name)
            else:
                path.write_text("\n".join(generate_markov_chains(
                    MARKOV_ROWS, seed=MARKOV_SEED,
                    n_entities=MARKOV_ENTITIES)) + "\n")
        out[key] = str(path)
    print(f"shard corpora: {json.dumps({k: os.path.getsize(v) for k, v in out.items()})} "
          f"bytes; written here: {made or 'none'} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return out


def phase_shard():
    """The sharded driver on the card: each job of the sharded path through
    `run_sharded(device="cuda")` against its solo `run_job` on the card,
    byte for byte, with the workers' kernel launches; the SIGSTOP chaos
    leg; a worker without the device failing the run; and the CLI's
    `--shard`. Returns (seconds and counters, the workers' launch
    counts)."""
    import torch

    from avenir_tpu_torch.data import churn_schema
    from avenir_tpu_torch.data.generators import MARKOV_STATES
    from avenir_tpu_torch.dist import ShardError, StragglerPolicy, run_sharded
    from avenir_tpu_torch.dist.driver import worker_launches
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.runner import run_job
    from avenir_tpu_torch.tools.bench_scaling import chaos_leg, same_files

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_shard"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # every kernel is built here, once: no worker runs nvcc
    built = _build.build_all()
    corpora = _shard_corpora(work)
    schema = str(work / "churn.json")
    churn_schema().save(schema)
    # the sidecar off in every run: the workers parse their byte ranges
    # (phase 22 drives the replay over a warm sidecar)
    mi = {"mut.feature.schema.file.path": schema,
          "mut.mutual.info.score.algorithms": MI_ALGOS,
          "mut.stream.block.size.mb": "4", **SIDECAR_OFF}
    gsp = {**GSP_PROPS, **GSP_BLOCK, **SIDECAR_OFF}
    runs = [
        ("mutualInformation", mi, "churn", SHARD_PROCS),
        ("bayesianDistr", {"bad.feature.schema.file.path": schema,
                           "bad.stream.block.size.mb": "4", **SIDECAR_OFF},
         "churn", SHARD_PROCS),
        ("markovStateTransitionModel",
         {"mst.model.states": ",".join(MARKOV_STATES),
          "mst.skip.field.count": "2", "mst.class.label.field.ord": "1",
          "mst.class.labels": "C,L", "mst.stream.block.size.mb": "4",
          **SIDECAR_OFF}, "chains", SHARD_PROCS),
        ("frequentItemsApriori",
         {"fia.support.threshold": ASSOC_PROPS["fia.support.threshold"],
          "fia.item.set.length": ASSOC_PROPS["fia.item.set.length"],
          **ASSOC_BLOCK, **SIDECAR_OFF}, "baskets", SHARD_PROCS),
        (SEQ_PATH, gsp, "seq", SHARD_GSP_PROCS)]
    secs = {"builds_s": {k: round(v, 1) for k, v in built.items()}}
    launches = {fn.__name__: 0 for fn in _wrappers()}
    solo_out = {}

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, round(time.perf_counter() - t0, 3)

    for name, props, key, procs in runs:
        inp = corpora[key]
        row = {}
        if name not in solo_out:
            solo_out[name] = str(work / f"solo_{name}")
            _, row["solo_s"] = timed(lambda: run_job(
                name, props, [inp], solo_out[name], device=DEVICE))
        res, row["sharded_s"] = timed(lambda: run_sharded(
            name, props, [inp], str(work / f"sharded_{name}_{procs}"),
            procs=procs, device=DEVICE, timeout_s=SHARD_TIMEOUT_S))
        run_launches = worker_launches(res)
        for fn, n in run_launches.items():
            launches[fn] += n
        row["counters"] = {k: v for k, v in res.counters.items()
                           if k.startswith(("Shard:", "Cache:"))}
        row["workers"] = [{k: w.get(k) for k in ("worker", "device",
                                                  "scan_s", "perk_s",
                                                  "folded", "perk_folded",
                                                  "stolen", "mirrored")}
                          for w in res.payload["workers"]]
        row["subseq_support_launches"] = run_launches["subseq_support_fold"]
        secs[f"{name}_{procs}"] = row
        ok = (same_files(solo_out[name], res.outputs)
              and res.counters["Shard:ParseSpans"] > 0
              and res.counters["Shard:ReplaySpans"] == 0
              and all(w["device"].startswith("cuda")
                      for w in res.payload["workers"]))
        if name in (SEQ_PATH, "frequentItemsApriori"):
            ok = ok and res.counters["Shard:PerKRounds"] >= 1 \
                and res.counters["Shard:PerKBlocks"] >= \
                res.counters["Shard:Blocks"]
        if name == SEQ_PATH:
            ok = ok and run_launches["subseq_support_fold"] > 0
        check(ok, f"{name} sharded over {procs} workers on the card "
              f"({CARD}): byte-identical to the solo run_job on the card; "
              f"{json.dumps(row)}")

    # the chaos leg: a worker stopped while it holds a claim
    res, caught = chaos_leg(
        "mutualInformation", mi, corpora["churn"], str(work / "chaos"),
        DEVICE, policy=StragglerPolicy(mirror_floor_s=0.5,
                                       mirror_multiple=2.0, poll_s=0.02),
        timeout_s=SHARD_TIMEOUT_S)
    for fn, n in worker_launches(res).items():
        launches[fn] += n
    secs["chaos"] = {**caught, "counters": {
        k: v for k, v in res.counters.items() if k.startswith("Shard:")}}
    check(res.counters["Shard:DedupBlocks"] >= 1 and caught["resumed"]
          and res.counters["Shard:ParseSpans"] > 0
          and same_files(solo_out["mutualInformation"], res.outputs),
          f"chaos leg: worker {caught['victim']} stopped on a claim, every "
          f"block committed, the late commit deduped, bytes equal to the "
          f"solo run's: {json.dumps(secs['chaos'])}")

    # a worker that cannot open the card fails the run; nothing falls back
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        run_sharded("mutualInformation", mi, [corpora["churn"]],
                    str(work / "nodev"), procs=SHARD_PROCS, device=DEVICE,
                    timeout_s=SHARD_TIMEOUT_S)
        refused = ""
    except ShardError as e:
        refused = str(e)
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES")
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    check("none is available" in refused and not (work / "nodev").exists(),
          f"workers without the card fail the run (ShardError), no CPU "
          f"fallback: {refused.splitlines()[0] if refused else 'no error'}")

    # GSP over SHARD_PROCS workers through the CLI's --shard: a fresh
    # coordinator process, whose line carries its workers' stats
    conf = work / "gsp.properties"
    conf.write_text("".join(f"{k}={v}\n" for k, v in
                            gsp.items()))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch", SEQ_PATH, "--shard",
         str(SHARD_PROCS), "--conf", str(conf), corpora["seq"],
         str(work / "cli")], capture_output=True, text=True,
        timeout=SHARD_TIMEOUT_S + 120, cwd=ROOT, env=env)
    cli_s = round(time.perf_counter() - t0, 3)
    line = (json.loads(proc.stdout.strip().splitlines()[-1])
            if proc.returncode == 0 else {})
    c = line.get("counters", {})
    workers = line.get("workers", [])
    run_launches = worker_launches(
        types.SimpleNamespace(payload={"workers": workers}))
    for fn, n in run_launches.items():
        launches[fn] += n
    row = {"cli_s": cli_s,
           "counters": {k: v for k, v in c.items()
                        if k.startswith(("Shard:", "Cache:"))},
           "workers": [{k: w.get(k) for k in ("worker", "device", "scan_s",
                                               "perk_s", "folded",
                                               "perk_folded", "stolen",
                                               "mirrored")}
                       for w in workers],
           "subseq_support_launches": run_launches.get(
               "subseq_support_fold", 0)}
    secs[f"{SEQ_PATH}_{SHARD_PROCS}"] = row
    check(proc.returncode == 0
          and same_files(solo_out[SEQ_PATH], line.get("outputs", []))
          and len(workers) == SHARD_PROCS
          and all(w["device"].startswith("cuda") for w in workers)
          and c.get("Shard:PerKRounds", 0) >= 1
          and c.get("Shard:PerKBlocks", 0) >= c.get("Shard:Blocks", 1)
          and c.get("Shard:ParseSpans", 0) > 0
          and c.get("Shard:ReplaySpans", 1) == 0
          and row["subseq_support_launches"] > 0,
          f"python -m avenir_tpu_torch {SEQ_PATH} --shard {SHARD_PROCS} on "
          f"the card ({CARD}): {cli_s}s with the interpreter's boot, bytes "
          f"equal to the solo run_job's; {json.dumps(row)} "
          f"{proc.stderr[-400:] if proc.returncode else ''}")
    shutil.rmtree(work)
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    print(f"shard path launches (the workers'): {json.dumps(launches)}",
          flush=True)
    return secs, launches

INCR_PATH = "incremental"
#: the append of phase 22: 1% of phase 6's churn rows and of phase 12's
#: sequences, each from its own seed
INCR_APPEND_ROWS, INCR_APPEND_SEED = 10_000, 202
#: phase 22's block size, and its crash leg's mid-scan checkpoint
#: interval: the first checkpoint after 2 blocks
INCR_BLOCK_MB, INCR_CKPT_MB = "4", "8"

_INCR_CHILD = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
from avenir_tpu_torch.core import incremental

def kill(meta):
    if not meta.get("complete"):
        os._exit(137)          # a hard kill at the first mid-scan checkpoint
incremental._checkpoint_hook = kill

from avenir_tpu_torch.runner import run_incremental
run_incremental("mutualInformation", json.loads(sys.argv[2]), [sys.argv[3]],
                sys.argv[4], state_dir=sys.argv[5], device=sys.argv[6])
print("COMPLETED")
'''


def phase_incremental():
    """The delta-scan layer on the card: run_incremental and its refresh
    after a 1% append against a cold run_job (MI, NB, GSP), the fused
    refresh, the sharded refresh, the columnar sidecar's pack and replay,
    a sharded scan over a warm sidecar, and a child killed at its first
    mid-scan checkpoint resumed. Returns (seconds and counters, the launch
    counts of the refreshes and replays)."""
    import torch

    from avenir_tpu_torch import obs
    from avenir_tpu_torch.data import (churn_schema, generate_churn,
                                       generate_token_sequences)
    from avenir_tpu_torch.dist import (StragglerPolicy, run_sharded,
                                       run_sharded_refresh)
    from avenir_tpu_torch.runner import (run_incremental,
                                         run_incremental_shared, run_job)

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_incr"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    corpora = _shard_corpora(work)
    churn, seq = str(work / "churn.csv"), str(work / "seq.csv")
    shutil.copyfile(corpora["churn"], churn)
    shutil.copyfile(corpora["seq"], seq)
    schema = str(work / "churn.json")
    churn_schema().save(schema)
    trio = {"mutualInformation": {
                "mut.feature.schema.file.path": schema,
                "mut.mutual.info.score.algorithms": MI_ALGOS,
                "mut.stream.block.size.mb": INCR_BLOCK_MB},
            "bayesianDistr": {"bad.feature.schema.file.path": schema,
                              "bad.stream.block.size.mb": INCR_BLOCK_MB},
            "fisherDiscriminant": {"fid.feature.schema.file.path": schema,
                                   "fid.stream.block.size.mb": INCR_BLOCK_MB}}
    gsp = {**GSP_PROPS, "cgs.stream.block.size.mb": INCR_BLOCK_MB}
    confs = {**trio, SEQ_PATH: gsp}
    prefix = {"mutualInformation": "mut", "bayesianDistr": "bad",
              "fisherDiscriminant": "fid", SEQ_PATH: "cgs"}
    inputs = {SEQ_PATH: [seq]}

    def inp(job):
        return inputs.get(job, [churn])

    def out(tag, job):
        return str(work / tag / job) + (os.sep if job == SEQ_PATH else "")

    def state(tag, job):
        return str(work / "state" / tag / job)

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        return res, round(time.perf_counter() - t0, 4)

    def deltas(res):
        return {k: res.counters[k] for k in (
            "Cache:HitBlocks", "Cache:DeltaBlocks", "Resume:SkippedBytes",
            "Sidecar:HitBlocks", "Sidecar:DeltaBlocks")}

    secs = {"corpus_bytes": os.path.getsize(churn),
            "seq_bytes": os.path.getsize(seq)}

    # seed: a cold run_incremental of each job (its carry checkpointed);
    # the fused and sharded refreshes start from copies of these states
    for job, conf in confs.items():
        res, secs[f"seed_{job}_s"] = timed(lambda: run_incremental(
            job, conf, inp(job), out("seed", job),
            state_dir=state("solo", job), device=DEVICE))
        check(res.counters["Cache:HitBlocks"] == 0
              and res.counters["Cache:DeltaBlocks"] >= 1,
              f"{job} cold run_incremental on the card ({CARD}): "
              f"{secs[f'seed_{job}_s']}s, {json.dumps(deltas(res))}")
        if job in trio:
            shutil.copytree(state("solo", job), state("fused", job))
    shutil.copytree(state("solo", "mutualInformation"),
                    state("sharded", "mutualInformation"))
    with open(churn, "a") as fh:
        fh.write(generate_churn(INCR_APPEND_ROWS, seed=INCR_APPEND_SEED,
                                as_csv=True))
    with open(seq, "a") as fh:
        fh.write("\n".join(generate_token_sequences(
            INCR_APPEND_ROWS, vocab=GSP_VOCAB, seed=INCR_APPEND_SEED)) + "\n")

    # the cold twins: a full parse each (the sidecar off)
    cold = {}
    for job in confs:
        off = {**confs[job], f"{prefix[job]}.stream.sidecar": "false"}
        _reset_launches()
        cold[job], secs[f"cold_{job}_s"] = timed(lambda: run_job(
            job, off, inp(job), out("cold", job), device=DEVICE))
        if job == SEQ_PATH:
            secs["cold_gsp_launches"] = _launch_counts()[
                "subseq_support_fold"]

    # the refresh path: its launches counted from zero
    _reset_launches()
    refresh = {}
    for job in confs:
        before = _launch_counts()["subseq_support_fold"]
        refresh[job], secs[f"refresh_{job}_s"] = timed(
            lambda: run_incremental(job, confs[job], inp(job),
                                    out("refresh", job),
                                    state_dir=state("solo", job),
                                    device=DEVICE))
        launched = _launch_counts()["subseq_support_fold"] - before
        row = {"cold_s": secs[f"cold_{job}_s"],
               "refresh_s": secs[f"refresh_{job}_s"],
               "speedup": round(secs[f"cold_{job}_s"]
                                / max(secs[f"refresh_{job}_s"], 1e-9), 3),
               **deltas(refresh[job])}
        ok = (_files_of(refresh[job]) == _files_of(cold[job])
              and refresh[job].counters["Resume:SkippedBytes"] > 0
              and refresh[job].counters["Cache:HitBlocks"] > 0)
        if job == SEQ_PATH:
            row["subseq_support_launches"] = launched
            row["cold_launches"] = secs["cold_gsp_launches"]
            ok = ok and launched == secs["cold_gsp_launches"] > 0
        secs[f"refresh_{job}"] = row
        check(ok, f"{job} refresh after a {INCR_APPEND_ROWS}-row append on "
              f"the card ({CARD}): byte-identical to the cold run_job; "
              f"{json.dumps(row)}")

    # one delta scan for the three dataset jobs
    with obs.capture() as rec:
        fused, secs["fused_refresh_s"] = timed(lambda: run_incremental_shared(
            [(job, conf, out("fused", job)) for job, conf in trio.items()],
            [churn], state_dirs={job: state("fused", job) for job in trio},
            device=DEVICE))
    groups = [sp.attrs["jobs"] for sp in rec.spans()
              if sp.name == "job.dispatch"
              and sp.attrs.get("mode") == "incremental_shared"]
    check(groups == [",".join(trio)] and all(
        _files_of(fused[job]) == _files_of(refresh[job])
        and deltas(fused[job])["Resume:SkippedBytes"]
        == deltas(refresh[job])["Resume:SkippedBytes"] for job in trio),
        f"run_incremental_shared of {', '.join(trio)} on the card ({CARD}): "
        f"{secs['fused_refresh_s']}s, one delta scan {groups}, every file "
        f"equal to its solo refresh's")

    # the sharded refresh: the appended tail across 2 workers
    mi = trio["mutualInformation"]
    res, secs["sharded_refresh_s"] = timed(lambda: run_sharded_refresh(
        "mutualInformation", mi, [churn], out("sharded", "mutualInformation"),
        procs=SHARD_PROCS, state_dir=state("sharded", "mutualInformation"),
        policy=StragglerPolicy(mirror_floor_s=60.0), device=DEVICE,
        timeout_s=SHARD_TIMEOUT_S))
    row = {**deltas(res), **{k: v for k, v in res.counters.items()
                             if k.startswith("Shard:")}}
    secs["sharded_refresh"] = row
    check(_files_of(res) == _files_of(refresh["mutualInformation"])
          == _files_of(cold["mutualInformation"])
          and res.counters["Shard:Workers"] == SHARD_PROCS
          and res.counters["Resume:SkippedBytes"] > 0
          and all(w["device"].startswith("cuda")
                  for w in res.payload["workers"]),
          f"run_sharded_refresh of mutualInformation at {SHARD_PROCS} workers "
          f"on the card ({CARD}): {secs['sharded_refresh_s']}s with the "
          f"workers' boot, equal to the solo refresh and the cold run; "
          f"{json.dumps(row)}")

    # the sidecar: MI and GSP pack on a cold run_job, then replay
    scdir = str(work / "sc")
    for job in ("mutualInformation", SEQ_PATH):
        conf = {**confs[job], f"{prefix[job]}.stream.sidecar.dir": scdir}
        pack, secs[f"sidecar_pack_{job}_s"] = timed(lambda: run_job(
            job, conf, inp(job), out("pack", job), device=DEVICE))
        before = _launch_counts()["subseq_support_fold"]
        with obs.capture() as rec:
            warm, secs[f"sidecar_replay_{job}_s"] = timed(lambda: run_job(
                job, conf, inp(job), out("replay", job), device=DEVICE))
        launched = _launch_counts()["subseq_support_fold"] - before
        parsed = sum(sp.name == "stream.parse" for sp in rec.spans())
        row = {"pack_s": secs[f"sidecar_pack_{job}_s"],
               "replay_s": secs[f"sidecar_replay_{job}_s"],
               "pack": deltas(pack), "replay": deltas(warm),
               "replay_parse_spans": parsed}
        ok = (_files_of(pack) == _files_of(warm) == _files_of(cold[job])
              and pack.counters["Sidecar:DeltaBlocks"] >= 1
              and warm.counters["Sidecar:HitBlocks"]
              == pack.counters["Sidecar:DeltaBlocks"]
              and warm.counters["Sidecar:DeltaBlocks"] == 0 and parsed == 0)
        if job == SEQ_PATH:
            row["replay_subseq_support_launches"] = launched
            ok = ok and launched > 0
        secs[f"sidecar_{job}"] = row
        check(ok, f"{job} through the columnar sidecar on the card "
              f"({CARD}): packed, then replayed with no parse, every file "
              f"equal to the cold run's; {json.dumps(row)}")
    warm_mi = {**mi, "mut.stream.sidecar.dir": scdir}
    res, secs["sharded_warm_s"] = timed(lambda: run_sharded(
        "mutualInformation", warm_mi, [churn], out("sharded_warm",
                                                    "mutualInformation"),
        procs=SHARD_PROCS, factor=2, device=DEVICE,
        timeout_s=SHARD_TIMEOUT_S))
    row = {k: v for k, v in res.counters.items()
           if k.startswith(("Shard:", "Sidecar:"))}
    secs["sharded_warm"] = row
    check(_files_of(res) == _files_of(cold["mutualInformation"])
          and res.counters["Shard:ParseSpans"] == 0
          and res.counters["Shard:ReplaySpans"] >= 1,
          f"run_sharded of mutualInformation over the warm sidecar "
          f"({CARD}): {secs['sharded_warm_s']}s, no block parsed in the "
          f"workers; {json.dumps(row)}")

    # a child killed at its first mid-scan checkpoint, then the resume
    crash_state = state("crash", "mutualInformation")
    conf = {**mi, "mut.stream.checkpoint.interval.mb": INCR_CKPT_MB}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _INCR_CHILD, str(ROOT), json.dumps(conf),
         churn, out("killed", "mutualInformation"), crash_state, DEVICE],
        capture_output=True, text=True, timeout=SHARD_TIMEOUT_S, cwd=ROOT)
    secs["crash_child_s"] = round(time.perf_counter() - t0, 3)
    from avenir_tpu_torch.core.incremental import CheckpointStore

    loaded = CheckpointStore(crash_state).load()
    covered = sum(loaded[0]["watermarks"]) if loaded else 0
    res, secs["resume_s"] = timed(lambda: run_incremental(
        "mutualInformation", conf, [churn], out("resumed",
                                                "mutualInformation"),
        state_dir=crash_state, device=DEVICE))
    row = {"child_rc": proc.returncode, "covered": covered, **deltas(res)}
    secs["crash"] = row
    check(proc.returncode == 137 and "COMPLETED" not in proc.stdout
          and loaded is not None and loaded[0]["complete"] is False
          and 0 < covered < os.path.getsize(churn)
          and res.counters["Resume:SkippedBytes"] == covered
          and _files_of(res) == _files_of(cold["mutualInformation"]),
          f"a run_incremental child killed at its first mid-scan checkpoint "
          f"({secs['crash_child_s']}s with its boot), resumed on the card "
          f"({CARD}) in {secs['resume_s']}s to the cold bytes; "
          f"{json.dumps(row)} {proc.stderr[-300:] if proc.returncode != 137 else ''}")
    counts = _launch_counts()
    shutil.rmtree(work)
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    print(f"incremental path launches: {json.dumps(counts)}", flush=True)
    return secs, counts


SERVE_PATH = "serve"
#: phase 23: the /score calls on one keep-alive socket, the fleet's
#: hosts, the sequences appended before the GSP refresh, and the fleet's
#: lease TTL (the reference tutorial's 1 s is shorter than a torch host's
#: boot on the card; a lease on a live host is renewed either way)
SERVE_SCORES, SERVE_HOSTS, SERVE_APPEND_ROWS = 64, 2, 10_000
SERVE_LEASE_TTL_S = 5.0
SERVE_WAIT_S = 600.0
#: the phase's admission budget: the reference's footprint model prices
#: GSP over GSP_VOCAB tokens in 4 MB blocks at 3,282,995,218 bytes (its
#: scan state, 3 x 65,536 rows x 4,096 candidates x 4 bytes), past the
#: default 3 GiB, so the served GSP requests would be refused at it
SERVE_BUDGET_BYTES = 8 << 30


def _http_json(url: str, obj=None, timeout: float = SERVE_WAIT_S):
    """(status, body, headers) of a GET (obj None) or a JSON POST; an
    HTTP error status comes back, not raised."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}"), dict(exc.headers)


def phase_server():
    """The job server, its listener and a fleet on the card (docstring
    item 23). Returns (seconds and figures, the launch counts of the
    served requests). Every server, listener and fleet it starts is
    stopped on the way out, a failed check's too, so that no thread or
    host process outlives the phase."""
    import contextlib

    with contextlib.ExitStack() as stack:
        return _serve_phase(stack)


def _serve_phase(stack):
    import http.client
    import signal

    import numpy as np
    import torch

    from avenir_tpu_torch import obs
    from avenir_tpu_torch.data import (churn_schema, elearn_schema,
                                       generate_elearn,
                                       generate_token_sequences)
    from avenir_tpu_torch.net.fault import FaultPolicy
    from avenir_tpu_torch.net.fleet import Fleet
    from avenir_tpu_torch.net.listener import NetListener
    from avenir_tpu_torch.runner import run_job
    from avenir_tpu_torch.server import JobRequest, JobServer
    from avenir_tpu_torch.server.score import score_once

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    corpora = _shard_corpora(work)
    churn = corpora["churn"]
    seq = str(work / "seq.csv")
    shutil.copyfile(corpora["seq"], seq)
    schema = str(work / "churn.json")
    churn_schema().save(schema)
    trio = {"bayesianDistr": ("bad", {"bad.feature.schema.file.path": schema,
                                      **SIDECAR_OFF}),
            "mutualInformation": ("mut", {
                "mut.feature.schema.file.path": schema,
                "mut.mutual.info.score.algorithms": MI_ALGOS,
                **SIDECAR_OFF}),
            "fisherDiscriminant": ("fid", {
                "fid.feature.schema.file.path": schema, **SIDECAR_OFF})}
    gsp = {**GSP_PROPS, **GSP_BLOCK, **SIDECAR_OFF}
    secs = {"churn_bytes": os.path.getsize(churn),
            "seq_bytes": os.path.getsize(seq)}

    def out(tag):
        return str(work / tag) + os.sep

    def gsp_launches():
        return _launch_counts()["subseq_support_fold"]

    def serve(srv, req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = srv.submit(req).result(SERVE_WAIT_S)
        torch.cuda.synchronize()
        return res, round(time.perf_counter() - t0, 4)

    # the solo twins first, on the card and on the CPU: the launches of
    # the served requests are counted from zero after them
    solo, cpu, solo_s = {}, {}, {}
    for job, (_p, conf) in trio.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo[job] = run_job(job, conf, [churn], out(f"solo_{job}"),
                            device=DEVICE)
        torch.cuda.synchronize()
        solo_s[job] = round(time.perf_counter() - t0, 4)
        cpu[job] = run_job(job, conf, [churn], out(f"cpu_{job}"),
                           device="cpu")
    if not MAIN_PATH.get("files"):
        fail("phase 23 serves phase 3's nearestNeighbor: run phase 3 first")
    train = str(CORPORA / "elearn_train.csv")
    test = str(CORPORA / "elearn_test.csv")
    knn_modes = {"default": {}, "fused": {"nen.device.fused.vote": "true"}}
    _reset_launches()

    # ---- the trio batched into one shared scan
    srv = JobServer(workers=1, device=DEVICE,
                    budget_bytes=SERVE_BUDGET_BYTES,
                    state_root=str(work / "state"))
    stack.callback(srv.shutdown, drain=False)
    tickets = {job: srv.submit(JobRequest(job, conf, [churn],
                                          out(f"srv_{job}"),
                                          tenant=f"tenant_{p}"))
               for job, (p, conf) in trio.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.start()
    served = {job: t.result(SERVE_WAIT_S) for job, t in tickets.items()}
    torch.cuda.synchronize()
    secs["trio_batch_s"] = round(time.perf_counter() - t0, 4)
    secs["trio_solo_sum_s"] = round(sum(solo_s.values()), 4)
    secs["trio_solo_s"] = solo_s
    ok = all(served[j].counters["Server:BatchSize"] == 3.0
             and _files_of(served[j]) == _files_of(solo[j])
             == _files_of(cpu[j]) for j in trio)
    check(ok, f"the trio served as one batch on the card ({CARD}): "
          f"{secs['trio_batch_s']}s against the solo runs' "
          f"{secs['trio_solo_sum_s']}s ({json.dumps(solo_s)}); "
          f"Server:BatchSize 3, every file equal to the solo run_job's and "
          f"its CPU twin's ({secs['churn_bytes']} bytes of churn rows)")

    # ---- phase 3's nearestNeighbor, served
    if not (os.path.exists(train) and os.path.exists(test)):
        Path(train).write_text(generate_elearn(NT, seed=101, as_csv=True))
        Path(test).write_text(generate_elearn(NQ, seed=102, as_csv=True))
    # phase 3's schema went with its work directory: the same schema here
    knn_schema = str(work / "elearn.json")
    elearn_schema().save(knn_schema)
    knn = {}
    for mode, extra in knn_modes.items():
        before = _launch_counts()
        res, secs[f"knn_{mode}_s"] = serve(srv, JobRequest(
            "nearestNeighbor", {**MAIN_PATH["base"], **extra,
                                "nen.feature.schema.file.path": knn_schema},
            [train, test], str(work / f"knn_{mode}.txt"), tenant="knn"))
        after = _launch_counts()
        knn[mode] = {n: after[n] - before[n] for n in after
                     if after[n] != before[n]}
        wrapper = "knn_topk" if mode == "default" else "knn_classify_lanes"
        check(_files_of(res) == MAIN_PATH["files"][mode]
              and knn[mode].get(wrapper, 0) > 0,
              f"nearestNeighbor {mode} served on the card ({CARD}): "
              f"{secs[f'knn_{mode}_s']}s, its file equal to phase 3's, "
              f"launches {json.dumps(knn[mode])}")
    secs["knn_launches"] = knn

    # ---- GSP twice (the second a warm hit), then two refreshes
    runs = {}
    for tag in ("cold", "warm"):
        before = gsp_launches()
        with obs.capture() as rec:
            res, secs[f"gsp_{tag}_s"] = serve(srv, JobRequest(
                SEQ_PATH, gsp, [seq], out(f"gsp_{tag}"), tenant="gsp"))
        runs[tag] = {"res": res, "launches": gsp_launches() - before,
                     "parse_spans": sum(sp.name == "stream.parse"
                                        for sp in rec.spans())}
    cold, warm = runs["cold"], runs["warm"]
    secs["gsp"] = {t: {"s": secs[f"gsp_{t}_s"], "launches": r["launches"],
                       "parse_spans": r["parse_spans"],
                       "warm_hit": r["res"].counters["Server:WarmHit"]}
                   for t, r in runs.items()}
    check(cold["res"].counters["Server:WarmHit"] == 0.0
          and warm["res"].counters["Server:WarmHit"] == 1.0
          and cold["parse_spans"] > 0 and warm["parse_spans"] == 0
          and warm["launches"] == cold["launches"] > 0
          and _files_of(warm["res"]) == _files_of(cold["res"]),
          f"GSP served twice on the card ({CARD}): the second a warm hit "
          f"from the pinned spill cache, no parse span, the same "
          f"subseq_support launches and files; {json.dumps(secs['gsp'])}")
    seed, secs["gsp_refresh_seed_s"] = serve(srv, JobRequest(
        SEQ_PATH, gsp, [seq], out("gsp_seed"), tenant="gsp",
        mode="refresh"))
    with open(seq, "a") as fh:
        fh.write("\n".join(generate_token_sequences(
            SERVE_APPEND_ROWS, vocab=GSP_VOCAB, seed=INCR_APPEND_SEED))
            + "\n")
    refreshed, secs["gsp_refresh_s"] = serve(srv, JobRequest(
        SEQ_PATH, gsp, [seq], out("gsp_refresh"), tenant="gsp",
        mode="refresh"))
    srv.shutdown()
    # the served requests' launches; nothing later in the phase launches
    # a kernel in this process but the cold twin (the edge's jobs and the
    # fleet hosts' launch none)
    counts = _launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gsp_cold = run_job(SEQ_PATH, gsp, [seq], out("gsp_cold"), device=DEVICE)
    torch.cuda.synchronize()
    secs["gsp_cold_after_append_s"] = round(time.perf_counter() - t0, 4)
    skipped = refreshed.counters["Resume:SkippedBytes"]
    check(seed.counters["Resume:SkippedBytes"] == 0 and skipped > 0
          and _files_of(refreshed) == _files_of(gsp_cold),
          f"GSP refresh served after a {SERVE_APPEND_ROWS}-row append "
          f"({CARD}): {secs['gsp_refresh_s']}s (seed "
          f"{secs['gsp_refresh_seed_s']}s, cold twin "
          f"{secs['gsp_cold_after_append_s']}s), Resume:SkippedBytes "
          f"{skipped:.0f}, equal to the cold run's files")

    # ---- the HTTP edge
    net = JobServer(workers=1, device=DEVICE,
                    state_root=str(work / "net_state")).start()
    stack.callback(net.shutdown, drain=False)
    lis = NetListener(net, port=0).start()
    stack.callback(lis.stop)
    url = f"http://127.0.0.1:{lis.port}"
    mi_job, (_p, mi_conf) = "mutualInformation", trio["mutualInformation"]
    t0 = time.perf_counter()
    code, row, _h = _http_json(url + "/submit?wait=1", {
        "job": mi_job, "conf": mi_conf, "inputs": [churn],
        "output": out("net_mi")})
    secs["submit_wait_s"] = round(time.perf_counter() - t0, 4)
    check(code == 200 and row["ok"]
          and [Path(p).read_bytes() for p in row["outputs"]]
          == [Path(p).read_bytes() for p in solo[mi_job].outputs],
          f"POST /submit?wait=1 of mutualInformation ({CARD}): "
          f"{secs['submit_wait_s']}s, the bytes of the solo run")
    nb_model = solo["bayesianDistr"].outputs[0]
    nb_conf = {"field.delim": ",", "schema.path": schema,
               "predict.class.cost": "2,1", "predict.class": "open,closed"}
    with open(churn) as fh:
        rows = [next(fh).rstrip("\n") for _ in range(SERVE_SCORES)]
    want = [score_once("bayes", nb_model, r, nb_conf, device=DEVICE)
            for r in rows]
    conn = http.client.HTTPConnection("127.0.0.1", lis.port,
                                      timeout=SERVE_WAIT_S)
    got, ms, socks = [], [], set()
    for r in rows:
        t0 = time.perf_counter()
        conn.request("POST", "/score", json.dumps({
            "kind": "bayes", "model": nb_model, "row": r,
            "conf": nb_conf}).encode(), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        ms.append((time.perf_counter() - t0) * 1000.0)
        socks.add(id(conn.sock))
        got.append(body.get("row") if resp.status == 200 else None)
    conn.close()
    p50, p99 = (float(np.percentile(ms, q)) for q in (50, 99))
    secs["score_ms"] = {"p50": round(p50, 3), "p99": round(p99, 3),
                        "min": round(min(ms), 3), "max": round(max(ms), 3),
                        "first": round(ms[0], 3)}
    check(got == want and len(socks) == 1,
          f"{SERVE_SCORES} POST /score (bayes) over one keep-alive socket "
          f"({CARD}): every row equal to score_once; ms p50 {p50:.3f}, p99 "
          f"{p99:.3f} (first {ms[0]:.3f})")
    code_m, snap, _h = _http_json(url + "/metrics")
    code_h, health, _h = _http_json(url + "/healthz")
    check(code_m == 200 and snap["stats"]["served"] >= 1
          and snap["score"]["stats"]["scores"] >= SERVE_SCORES
          and code_h == 200 and health["status"] == "serving",
          f"GET /metrics (served {snap['stats']['served']:.0f}, scores "
          f"{snap['score']['stats']['scores']}) and /healthz "
          f"({health['status']})")
    lis.stop()
    net.shutdown()
    shed = JobServer(workers=1, device=DEVICE, budget_bytes=150 << 20,
                     pricer=lambda reqs, reserve: (100 << 20) * len(reqs),
                     rss_probe=lambda: 0,
                     state_root=str(work / "shed_state"))
    stack.callback(shed.shutdown, drain=False)
    edge = NetListener(shed, port=0).start()
    stack.callback(edge.stop)
    shed_url = f"http://127.0.0.1:{edge.port}"
    nb_job, (_p, nb_jconf) = "bayesianDistr", trio["bayesianDistr"]
    first = _http_json(shed_url + "/submit", {
        "job": nb_job, "conf": nb_jconf, "inputs": [churn],
        "output": out("shed0")})
    flood = _http_json(shed_url + "/submit", {
        "job": nb_job, "conf": nb_jconf, "inputs": [churn],
        "output": out("shed1")})
    shed.start()
    done = _http_json(shed_url + f"/result/{first[1]['req_id']}"
                      f"?timeout={SERVE_WAIT_S:.0f}")
    edge.stop()
    shed.shutdown()
    check(first[0] == 202 and flood[0] == 429
          and int(flood[2].get("Retry-After", 0)) >= 1
          and done[0] == 200 and done[1]["ok"]
          and [Path(p).read_bytes() for p in done[1]["outputs"]]
          == [Path(p).read_bytes() for p in solo[nb_job].outputs],
          f"the edge sheds a flood with 429 (Retry-After "
          f"{flood[2].get('Retry-After')}) against the admission model, "
          f"then serves the held request to the solo bytes")

    # ---- a fleet of hosts on the one card, one SIGKILLed
    policy = FaultPolicy(poll_interval_s=0.1, lease_ttl_s=SERVE_LEASE_TTL_S,
                         restart_backoff_base_s=0.5,
                         heartbeat_timeout_s=120.0, hedge=False)
    fleet = Fleet(str(work / "fleet"), hosts=SERVE_HOSTS, workers=1,
                  fault_policy=policy, device=DEVICE)
    stack.callback(fleet.stop)
    t0 = time.perf_counter()
    fleet.start(timeout=SERVE_WAIT_S)
    secs["fleet_boot_s"] = round(time.perf_counter() - t0, 3)
    load = [(job, conf) for job, (_p, conf) in trio.items()]
    load.append(load[0])
    t0 = time.perf_counter()
    names = [fleet.submit({"job": job, "conf": conf, "inputs": [churn],
                           "output": out(f"fleet{i}"), "tenant": f"t{i}"})
             for i, (job, conf) in enumerate(load)]
    # the host with the most placed requests (the corpus' sticky host)
    hosts = fleet.router.snapshot()["hosts"]
    victim = max(range(SERVE_HOSTS),
                 key=lambda h: hosts[h]["assigned_requests"])
    os.kill(fleet.host_pid(victim), signal.SIGKILL)
    got_rows = fleet.collect(names, timeout=SERVE_WAIT_S)
    secs["fleet_s"] = round(time.perf_counter() - t0, 3)
    fsnap = fleet.fault_snapshot()
    codes = fleet.stop()
    rows_ok = [got_rows[n].get("ok") for n in names]
    same = [[Path(p).read_bytes() for p in got_rows[n]["outputs"]]
            == [Path(p).read_bytes() for p in solo[job].outputs]
            for n, (job, _c) in zip(names, load)]
    secs["fleet"] = {"requeues": fsnap["stats"]["requeues"],
                     "restarts": fsnap["stats"]["restarts"],
                     "leases_outstanding": fsnap["leases_outstanding"],
                     "victim": victim, "stop_codes": codes}
    check(all(rows_ok) and all(same)
          and fsnap["stats"]["requeues"] >= 1
          and fsnap["leases_outstanding"] == 0,
          f"a Fleet of {SERVE_HOSTS} hosts on the card ({CARD}; boot "
          f"{secs['fleet_boot_s']}s): {len(load)} requests, host {victim} "
          f"SIGKILLed after placement, every row ok and equal to its solo "
          f"bytes in {secs['fleet_s']}s; {json.dumps(secs['fleet'])}")
    shutil.rmtree(work)
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    print(f"serve path launches: {json.dumps(counts)}", flush=True)
    return secs, counts


TUNE_PATH = "tune"
#: phase 24(b)'s corpus: fixed-width rows of 64 bytes (`s<7 digits>`, then
#: TUNE_GSP_TOKENS tokens of 4 characters, all hot but one),
#: so a 4 MB block holds 65,536 rows, one page of the per-k count, and any
#: larger power of two a whole number of pages: the launches do not move
#: with the block size the tuner picks. Source a (first) brings
#: TUNE_GSP_A_ROWS cold tokens, one new a row, so the codes pass 65,535;
#: every row of source b takes one of a's last cold tokens, so each of its
#: blocks spills uint32 codes, 45 bytes a row (1 count + 11 x 4): b spills
#: 65,250,422 bytes (62.23 MiB), a 3,150,044. Under the explicit budget
#: of TUNE_GSP_BUDGET_MB, b stays and a is evicted; the reference's cache
#: rule then asks for pow2(1.5 x 62.23 MiB) = 128 MB, room for both. A
#: spill under 60.34 MiB would round to the rule's 64 MB floor, which
#: moves nothing: the rule clamps the current budget into the registry's
#: range, so a budget under 64 MB reads as 64.
TUNE_GSP_A_ROWS, TUNE_GSP_B_ROWS = 70_000, 1_450_000
TUNE_GSP_TOKENS, TUNE_GSP_HOT = 11, 30
TUNE_GSP_BUDGET_MB = "64"
TUNE_GSP_PROPS = {"cgs.support.threshold": "0.02",
                  "cgs.item.set.length": "2", **GSP_BLOCK,
                  "cgs.stream.encoded.cache.budget.mb": TUNE_GSP_BUDGET_MB,
                  **{"cgs." + k: v for k, v in SIDECAR_OFF.items()}}


def _tune_gsp_sources(work: Path, seed: int) -> list:
    """Phase 24(b)'s two sources (TUNE_GSP_PROPS' comment), made with
    numpy: a row is `s<7 digits>`, TUNE_GSP_TOKENS - 1 hot tokens
    `h<3 digits>` drawn from TUNE_GSP_HOT, and one cold token, 4 base-36
    digits: row i of source a takes cold token i, a row of source b one of
    a's last 4,000."""
    import numpy as np

    rng = np.random.default_rng(seed)
    digits = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyz",
                           dtype=np.uint8)
    hot_bytes = np.frombuffer("".join(
        f"h{i:03d}" for i in range(TUNE_GSP_HOT)).encode(),
        dtype=np.uint8).reshape(-1, 4)

    def write(path, first_id, cold):
        rows = len(cold)
        buf = np.empty((rows, 64), dtype=np.uint8)
        buf[:, 0] = ord("s")
        ids = np.arange(first_id, first_id + rows)
        for j in range(7):
            buf[:, 7 - j] = ord("0") + (ids // 10 ** j) % 10
        toks = hot_bytes[rng.integers(0, TUNE_GSP_HOT,
                                      (rows, TUNE_GSP_TOKENS))]
        toks[np.arange(rows), rng.integers(0, TUNE_GSP_TOKENS, rows)] = \
            np.stack([digits[cold // 36 ** (3 - j) % 36] for j in range(4)],
                     axis=1)
        cells = buf[:, 8:63].reshape(rows, TUNE_GSP_TOKENS, 5)
        cells[:, :, 0] = ord(",")
        cells[:, :, 1:] = toks
        buf[:, 63] = ord("\n")
        path.write_bytes(buf.tobytes())
        return str(path)

    a_cold = np.arange(TUNE_GSP_A_ROWS)
    b_cold = rng.integers(TUNE_GSP_A_ROWS - 4000, TUNE_GSP_A_ROWS,
                          TUNE_GSP_B_ROWS)
    return [write(work / "gsp_a.csv", 0, a_cold),
            write(work / "gsp_b.csv", TUNE_GSP_A_ROWS, b_cold)]


def phase_tune():
    """The autotune loop on the card (docstring item 24). Returns (seconds
    and figures, the launch counts of the phase's card runs)."""
    import contextlib

    with contextlib.ExitStack() as stack:
        return _tune_phase(stack)


def _tune_phase(stack):
    import torch

    from avenir_tpu_torch.data import churn_schema
    from avenir_tpu_torch.runner import run_job, run_shared
    from avenir_tpu_torch.server import JobRequest, JobServer
    from avenir_tpu_torch.server.jobserver import (DEFAULT_RESERVE_BYTES,
                                                   price_request_bytes)
    from avenir_tpu_torch.tune import (ProfileStore, corpus_digest,
                                       extract_signals, residual_factor)

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_tune"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    corpora = _shard_corpora(work)
    churn = str(work / "churn.csv")
    shutil.copyfile(corpora["churn"], churn)
    schema = str(work / "churn.json")
    churn_schema().save(schema)
    tune_dir = str(work / "tune")
    store = ProfileStore(tune_dir)
    auto = {"stream.autotune": "true", "stream.autotune.dir": tune_dir}
    trio = (("bayesianDistr", "bad"), ("mutualInformation", "mut"),
            ("fisherDiscriminant", "fid"))
    group = "+".join(sorted(j for j, _p in trio))
    secs, figs = {}, {}

    def conf(p, extra=()):
        c = {f"{p}.feature.schema.file.path": schema,
             **{f"{p}.{k}": v for k, v in SIDECAR_OFF.items()},
             **{f"{p}.{k}": v for k, v in dict(extra).items()}}
        if p == "mut":
            c["mut.mutual.info.score.algorithms"] = "mutual.info.maximization"
        return c

    def specs(tag, extra=()):
        return [(j, conf(p, extra), str(work / tag / j)) for j, p in trio]

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[what] = round(time.perf_counter() - t0, 4)
        return out

    def mem(res):
        return {k: v for k, v in res.counters.items() if k.startswith("Mem:")}

    # (c)'s GSP request over phase 12's sequences, and its solo twin on the
    # card, run before the count starts
    seq = str(work / "seq.csv")
    shutil.copyfile(corpora["seq"], seq)
    gsp_req = {**GSP_PROPS, **GSP_BLOCK,
               **{"cgs." + k: v for k, v in SIDECAR_OFF.items()}}
    solo = timed("gsp_solo_s", lambda: run_job(
        SEQ_PATH, gsp_req, [seq], str(work / "gsp_solo") + os.sep,
        device=DEVICE))
    # launches are counted from zero here, on every autotuned card run of
    # the phase
    _reset_launches()

    # ---- (a) the fused churn trio, pass 1 static and pass 2 tuned
    p1 = timed("trio_pass1_s", lambda: run_shared(
        specs("p1", auto), [churn], device=DEVICE))
    prof = store.load(group, corpus_digest([churn]))
    check(prof is not None and bool(prof["runs"]),
          f"(a) pass 1 of the fused trio recorded its signals: {prof}")
    knobs = dict(prof["knobs"])
    row = prof["runs"][-1]
    figs["trio_knobs"] = knobs
    figs["trio_reasons"] = prof["reasons"]
    figs["trio_signals"] = row["signals"]
    figs["trio_mem_pass1"] = {j: mem(p1[j]) for j, _p in trio}
    print(f"(a) pass 1, static knobs ({CARD}; {secs['trio_pass1_s']}s): "
          f"knobs used {json.dumps(row['knobs_used'])}; signal row "
          f"{json.dumps(row['signals'])}; chosen {json.dumps(knobs)}, "
          f"reasons {json.dumps(prof['reasons'])}; Mem "
          f"{json.dumps(figs['trio_mem_pass1'])}", flush=True)
    p2 = timed("trio_pass2_s", lambda: run_shared(
        specs("p2", auto), [churn], device=DEVICE))
    prof2 = store.load(group, corpus_digest([churn]))
    used2 = prof2["runs"][-1]["knobs_used"]
    pinned = {k: f"{v:g}" for k, v in knobs.items()}
    cpu = timed("trio_cpu_twin_s", lambda: run_shared(
        specs("cpu", pinned), [churn], device="cpu"))
    same = all(_files_of(p2[j]) == _files_of(p1[j]) == _files_of(cpu[j])
               for j, _p in trio)
    pred = all(p2[j].counters["Mem:PredictedPeakBytes"]
               == cpu[j].counters["Mem:PredictedPeakBytes"] for j, _p in trio)
    figs["trio_mem_pass2"] = {j: mem(p2[j]) for j, _p in trio}
    check(bool(knobs) and all(used2[k] == v for k, v in knobs.items())
          and same and pred,
          f"(a) pass 2 applied the chosen knobs {json.dumps(knobs)} "
          f"({CARD}; {secs['trio_pass2_s']}s against pass 1's "
          f"{secs['trio_pass1_s']}s): every file byte-identical to pass 1's "
          f"and to the CPU twin's at the same knobs, Mem:PredictedPeakBytes "
          f"equal to the twin's: {json.dumps(figs['trio_mem_pass2'])}")
    # what the host-clock spans saw against the device: pass 1's knobs, not
    # recording, under torch.profiler
    recs = []
    busy = _device_busy(lambda: run_shared(specs("busy"), [churn],
                                           device=DEVICE), rec_out=recs)
    busy_sig = extract_signals(recs[0].spans()).to_json()
    figs["trio_busy"] = {**busy, "signals": busy_sig}
    print(f"(a) the static pass again under torch.profiler ({CARD}): device "
          f"busy share {busy['device_busy_share']:.4f} of "
          f"{busy['job_run_s']:.3f}s ({busy['device_s']:.4f}s on the "
          f"device); its host-clock signal row {json.dumps(busy_sig)}",
          flush=True)

    # ---- (b) GSP with a budget that evicts, then the tuned budget
    gsp_in = _tune_gsp_sources(work, 241)
    gsp_conf = {**TUNE_GSP_PROPS, "cgs.stream.autotune": "true",
                "cgs.stream.autotune.dir": tune_dir}
    gsp = []
    for i in (1, 2):
        before = _launch_counts()["subseq_support_fold"]
        res = timed(f"gsp_pass{i}_s", lambda: run_job(
            SEQ_PATH, gsp_conf, gsp_in, str(work / f"gsp{i}") + os.sep,
            device=DEVICE))
        gsp.append((res, _launch_counts()["subseq_support_fold"] - before,
                    store.load(SEQ_PATH, corpus_digest(gsp_in))))
    (g1, n1, gp1), (g2, n2, gp2) = gsp
    cache = [{k: r.counters[k] for k in ("Cache:SpillBytes",
                                         "Cache:EvictedBytes")}
             for r, _n, _p in gsp]
    budget = gp1["knobs"].get("stream.encoded.cache.budget.mb")
    figs["gsp"] = {"bytes": [os.path.getsize(p) for p in gsp_in],
                   "cache": cache, "launches": [n1, n2],
                   "knobs": gp1["knobs"], "reasons": gp1["reasons"],
                   "signals": gp1["runs"][-1]["signals"],
                   "mem": [mem(g1), mem(g2)]}
    check(cache[0]["Cache:EvictedBytes"] > 0 and budget is not None
          and gp2["runs"][-1]["knobs_used"][
              "stream.encoded.cache.budget.mb"] == budget
          and cache[1]["Cache:EvictedBytes"] == 0
          and _files_of(g2) == _files_of(g1) and n1 == n2 >= 1,
          f"(b) {SEQ_PATH} over sources of {TUNE_GSP_A_ROWS} and "
          f"{TUNE_GSP_B_ROWS} rows ({CARD}): "
          f"pass 1 under the explicit budget {TUNE_GSP_BUDGET_MB} MB "
          f"{json.dumps(cache[0])} in {secs['gsp_pass1_s']}s; the tuned "
          f"pass 2 at {budget} MB {json.dumps(cache[1])} in "
          f"{secs['gsp_pass2_s']}s; files equal, subseq_support launched "
          f"{n1} / {n2} times; {json.dumps(figs['gsp'])}")

    # ---- (c) the job server with the profile store
    srv = JobServer(workers=1, device=DEVICE, autotune_dir=tune_dir,
                    budget_bytes=SERVE_BUDGET_BYTES,
                    state_root=str(work / "state"))
    stack.callback(srv.shutdown, drain=False)
    reqs = [JobRequest(j, conf(p, {"stream.autotune": "true"}), [churn],
                       str(work / "srv" / j), tenant=f"tenant_{p}")
            for j, p in trio]
    reqs.append(JobRequest(SEQ_PATH, gsp_req, [seq],
                           str(work / "srv_gsp") + os.sep, tenant="seq"))
    tuned_price = srv._pricer(reqs[:3], DEFAULT_RESERVE_BYTES)
    bare_price = price_request_bytes(reqs[:3], DEFAULT_RESERVE_BYTES)
    # the fold costs the balancer reads when it composes the batch
    costs = {j: store.fold_cost_ms(j, corpus_digest([churn]))
             for j, _p in trio}
    tickets = [srv.submit(r) for r in reqs]
    served = timed("served_s", lambda: (srv.start(), [
        t.result(SERVE_WAIT_S) for t in tickets])[1])
    sizes = {r.job: served[i].counters["Server:BatchSize"]
             for i, r in enumerate(reqs)}
    figs["server"] = {"tuned_price": tuned_price, "bare_price": bare_price,
                      "batch_sizes": sizes, "fold_cost_ms": costs,
                      "split": any(v < 3 for j, v in sizes.items()
                                   if j != SEQ_PATH)}
    check(tuned_price >= bare_price
          and all(_files_of(served[i]) == _files_of(p1[r.job])
                  for i, r in enumerate(reqs[:3]))
          and _files_of(served[3]) == _files_of(solo),
          f"(c) JobServer(autotune_dir=) on the card ({CARD}; "
          f"{secs['served_s']}s): tuned price {tuned_price} >= the bare "
          f"model's {bare_price}; the balancer "
          f"{'split' if figs['server']['split'] else 'kept'} the trio "
          f"(batch sizes {json.dumps(sizes)}, fold costs "
          f"{json.dumps(costs)} ms); every file equal to pass 1's and "
          f"the GSP solo run's")
    counts = _launch_counts()

    # ---- (d) the tune subcommand
    proc = subprocess.run(
        [sys.executable, "-m", "avenir_tpu_torch", "tune", tune_dir],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    listed = [ln.split()[0] for ln in proc.stdout.splitlines()
              if ln and not ln.startswith(" ")]
    check(proc.returncode == 0 and group in listed and SEQ_PATH in listed,
          f"(d) python -m avenir_tpu_torch tune: exit {proc.returncode}, "
          f"profiles {listed}")
    figs["residual_factors"] = {
        f"{p['job']}_{p['corpus_digest']}": residual_factor(
            p.get("residuals") or []) for p in store.profiles()}
    print(f"tune figures ({CARD}): {json.dumps(figs)}", flush=True)
    shutil.rmtree(work)
    shutil.rmtree(CORPORA, ignore_errors=True)
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    print(f"tune path launches: {json.dumps(counts)}", flush=True)
    return secs, counts


LR_MESH_ATOL = 1e-7


AUDIT_PATH = "audit"
#: the reference's row counts of the miner and shared-scan tripwires
AUDIT_MINER_ROWS = 20_000
AUDIT_SHARED_ROWS = 30_000
#: phase 26: the host services' path, and the race audit's size on the
#: card: every two-way choice to depth 3 (the reference's default), then
#: 16 seeded schedules a site (its default 64 takes about twice as long)
HOST_PATH = "host_services"
RACE_DEPTH, RACE_SEEDS = 3, 16


def _audit_line(row: dict) -> dict:
    """An audit row without its bulk (the mem rows' terms)."""
    if "runs" in row:
        return {**row, "runs": [{k: v for k, v in r.items() if k != "terms"}
                                for r in row["runs"]]}
    return row


def phase_audit():
    """The auditors and the miner and shared-scan tripwires on the card
    (docstring item 25; the tripwire's IR leg is phase 27). Returns
    (seconds and figures, the launch counts of the phase)."""
    from avenir_tpu_torch.analysis.mem import kernel_device_entries
    from avenir_tpu_torch.tools.bench_scaling import (audit_tripwire,
                                                      miner_tripwire,
                                                      shared_scan_tripwire)

    t_phase = time.perf_counter()
    _reset_launches()
    try:
        audit = audit_tripwire(device=DEVICE, kernels=False, host=False,
                               ir=False)
    except RuntimeError as e:
        fail(f"the audits on {DEVICE} ({CARD}): {e}")
    secs = {k: round(v, 1) for k, v in audit.items() if k.endswith("_s")}
    for what, rows in audit["rows"].items():
        for row in rows:
            print(f"{what} audit row ({CARD}): {json.dumps(_audit_line(row))}",
                  flush=True)
    verdicts = {k: v for k, v in audit.items() if k.endswith("_validated")}
    check(all(v == 8 for v in verdicts.values()),
          f"the audits on {DEVICE} ({CARD}; {json.dumps(secs)}): "
          f"{json.dumps(verdicts)} of 8, allowlisted "
          f"{[audit[f'{t}_allowlisted'] for t in ('flow', 'mem', 'merge')]}")
    audits = _launch_counts()
    t0 = time.perf_counter()
    kernels = kernel_device_entries(DEVICE)
    secs["kernel_rows"] = round(time.perf_counter() - t0, 1)
    # the kernel rows' calls are measurements, not the path's launches
    _reset_launches()
    for row in kernels:
        print(f"memory manifest kernel row ({CARD}): {json.dumps(row)}",
              flush=True)
    t0 = time.perf_counter()
    miner = miner_tripwire(rows=AUDIT_MINER_ROWS, device=DEVICE)
    secs["miner_tripwire"] = round(time.perf_counter() - t0, 1)
    print(f"miner tripwire ({CARD}; {secs['miner_tripwire']}s): "
          f"{json.dumps(miner)}", flush=True)
    t0 = time.perf_counter()
    shared = shared_scan_tripwire(rows=AUDIT_SHARED_ROWS, device=DEVICE)
    secs["shared_scan_tripwire"] = round(time.perf_counter() - t0, 1)
    print(f"shared-scan tripwire ({CARD}; {secs['shared_scan_tripwire']}s):"
          f" {json.dumps(shared)}", flush=True)
    counts = {k: v + audits[k] for k, v in _launch_counts().items()}
    check(counts["subseq_support_fold"] >= 1
          and miner["gsp_subseq_support_launches"] >= 1,
          f"the GSP entries and the miner tripwire launched subseq_support "
          f"{counts['subseq_support_fold']}x (the tripwire "
          f"{miner['gsp_subseq_support_launches']}x)")
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    print(f"audit path launches: {json.dumps(counts)}", flush=True)
    return secs, counts


def phase_host_services():
    """The AST rules and the keys, proto and race audits on the card
    (docstring item 26). Returns (seconds, the launch counts of the
    phase)."""
    from avenir_tpu_torch.analysis import keys, proto, race
    from avenir_tpu_torch.analysis.engine import load_baseline
    from avenir_tpu_torch.analysis.rules import run_rules

    t_phase = time.perf_counter()
    root = str(ROOT)
    tiers = (
        ("ast", lambda b: run_rules([str(ROOT / "avenir_tpu_torch")],
                                    baseline=b, root=root),
         None, None, 0),
        ("keys", lambda b: keys.run_keys(baseline=b, root=root,
                                         device=DEVICE),
         "key_audit", "key_validated", len(keys.KEY_SITES)),
        ("proto", lambda b: proto.run_proto(baseline=b, root=root,
                                            device=DEVICE),
         "proto_audit", "commit_point_validated", len(proto.COMMIT_SITES)),
        ("race", lambda b: race.run_race(baseline=b, root=root,
                                         device=DEVICE, depth=RACE_DEPTH,
                                         seeds=RACE_SEEDS),
         "race_audit", "interleaving_validated",
         len(race.INTERLEAVE_SITES)))
    secs, counts = {}, None
    for name, run, attr, flag, n_sites in tiers:
        _reset_launches()
        t0 = time.perf_counter()
        try:
            rep = run(load_baseline())
        except RuntimeError as e:
            fail(f"the {name} tier on {DEVICE} ({CARD}) failed to run: {e}")
        secs[name] = round(time.perf_counter() - t0, 1)
        launches = _launch_counts()
        counts = (launches if counts is None
                  else {k: v + launches[k] for k, v in counts.items()})
        rows = getattr(rep, attr) if attr else []
        for row in rows:
            print(f"{name} audit row ({CARD}): {json.dumps(row)}",
                  flush=True)
        for f in rep.findings + rep.errors:
            print(f.render(), flush=True)
        ok_rows = sum(1 for r in rows if r[flag]) if flag else 0
        check(rep.clean and ok_rows == n_sites,
              f"{name} tier on {DEVICE} ({CARD}; {secs[name]}s): "
              f"{len(rep.scanned)} files, {len(rep.findings)} findings "
              f"past the allowlist, {len(rep.suppressed)} allowlisted, "
              f"{len(rep.stale)} stale, {ok_rows} of {n_sites} sites "
              f"validated, launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}")
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    print(f"host_services path launches: {json.dumps(counts)}", flush=True)
    return secs, counts


IR_PATH = "ir"


def _ir_entry_row(spec, cap, report) -> dict:
    """One op entry's row of the IR phase: what its recorded call ran on
    the card, the synchronizing calls the card reported in it, the
    libraries it bound with their fp64 SASS hits, and its findings."""
    from avenir_tpu_torch.analysis import ir

    reads = [e for e in cap.events if ir.is_host_read(e)]
    keys = sorted({f.key.split("::", 1)[1] for f in report.findings
                   + report.suppressed if f.path == spec.path
                   and f.scope.split(".lib")[0] == spec.name})
    sites = set(cap.syncs)
    return {"entry": spec.name, "device": cap.device,
            "ops": len(cap.events), "seconds": round(cap.seconds, 4),
            "syncs": len(cap.syncs), "sync_sites": sorted(sites),
            "sync_ops": sorted({e.op for e in reads
                                if sites.intersection(e.chain)}),
            "unexplained_syncs": cap.unexplained_syncs(),
            "host_reads": len(reads),
            "host_reads_in_loops": sum(1 for e in reads if e.loop_site),
            "libraries": list(cap.libraries),
            "sass_fp64": cap.sass, "findings": keys}


def phase_ir():
    """The IR tier on the card (docstring item 27). Returns (seconds, the
    launch counts of the phase)."""
    import torch

    from avenir_tpu_torch.analysis import ir
    from avenir_tpu_torch.analysis.engine import load_baseline
    from avenir_tpu_torch.analysis.manifest import manifest_entries
    from avenir_tpu_torch.ops import knn_kernels as kk
    from avenir_tpu_torch.tools import knn_tolerance as tol

    t_phase = time.perf_counter()
    specs = manifest_entries(DEVICE)
    captures = {}
    _reset_launches()
    try:
        rep = ir.run_ir(baseline=load_baseline(), device=DEVICE,
                        entries=specs, captures=captures)
    except ir.IRTraceError as e:
        fail(f"the IR tier on {DEVICE} ({CARD}): trace error: {e}")
    counts = _launch_counts()
    secs = {"run_ir": round(time.perf_counter() - t_phase, 1)}
    for spec in specs:
        cap = captures[spec.name]
        if spec.is_family:
            row = next(r for r in rep.payload_audit
                       if r["family"] == spec.name)
            print(f"ir family row ({CARD}): {json.dumps(row)}", flush=True)
            continue
        row = _ir_entry_row(spec, cap, rep)
        print(f"ir entry row ({CARD}): {json.dumps(row)}", flush=True)
        # the card's own account of the capture: every synchronizing call
        # it reported returned to a line where the capture recorded an op
        # that the host rules read as a device-to-host read
        check(not row["unexplained_syncs"],
              f"ir {spec.name} on {DEVICE} ({CARD}): {row['syncs']} "
              f"synchronizing calls at {row['sync_sites']} "
              f"({row['sync_ops']}); the host rules read "
              f"{row['host_reads']} device-to-host reads "
              f"({row['host_reads_in_loops']} in loops); unexplained "
              f"{row['unexplained_syncs']}")
    for f in rep.findings + rep.errors:
        print(f.render(), flush=True)
    for e in rep.stale:
        print(f"stale allowlist entry: {e.key}", flush=True)
    knn = captures["knn_topk_pallas"]
    ok_rows = sum(1 for r in rep.payload_audit
                  if r["payload_model_validated"])
    check(rep.clean and ok_rows == 8,
          f"ir tier on {DEVICE} ({CARD}; {secs['run_ir']}s): "
          f"{len(rep.findings)} findings past the allowlist, "
          f"{len(rep.suppressed)} allowlisted, {len(rep.stale)} stale, "
          f"{ok_rows} of 8 families' payloads validated")
    check(set(knn.libraries) == {"knn_prepass", "knn_topk"}
          and set(knn.sass) == set(knn.libraries),
          f"ir SASS leg ({CARD}): knn_topk_pallas bound {knn.libraries}, "
          f"scanned {sorted(knn.sass)}, fp64 hits {knn.sass}")
    check(counts["knn_topk"] >= 1 and counts["knn_prepass"] >= 1,
          f"{IR_PATH} launches: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    # the knn entry's output against the plain version (these launches
    # are the comparison's, read after the path's counts)
    fn, (q, t) = next(s for s in specs
                      if s.name == "knn_topk_pallas").build(None)
    gd, gi = fn(q, t)
    pd, pi = kk.knn_topk_plain(q, t, 5, "euclidean")
    torch.cuda.synchronize()
    rtol, atol = 1e-4, 1e-5
    mism = gi != pi
    close = bool(((gd - pd).abs() <= atol + rtol * pd.abs()).all())
    tied = tol.tied(q, t, gi, pd, mism, "euclidean", rtol, atol)
    check(close and tied,
          f"ir knn_topk_pallas on {DEVICE} ({CARD}): max|err| "
          f"{(gd - pd).abs().max().item():.3g} against knn_topk_plain, "
          f"index mismatches {int(mism.sum())} (rtol {rtol} atol {atol} "
          f"ties-only {tied})")
    secs["phase"] = round(time.perf_counter() - t_phase, 1)
    print(f"ir path launches: {json.dumps(counts)}", flush=True)
    return secs, counts


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
    shutil.rmtree(CORPORA, ignore_errors=True)

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
    shard_secs, shard_counts = phase_shard()
    incr_secs, incr_counts = phase_incremental()
    serve_secs, serve_counts = phase_server()
    tune_secs, tune_counts = phase_tune()
    audit_secs, audit_counts = phase_audit()
    host_secs, host_counts = phase_host_services()
    ir_secs, ir_counts = phase_ir()
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
    print(f"shard seconds ({CARD}; phase 21 {shard_secs['phase']}s): "
          f"{json.dumps(shard_secs)}", flush=True)
    print(f"incremental seconds ({CARD}; phase 22 {incr_secs['phase']}s): "
          f"{json.dumps(incr_secs)}", flush=True)
    print(f"serve seconds ({CARD}; phase 23 {serve_secs['phase']}s): "
          f"{json.dumps(serve_secs)}", flush=True)
    print(f"tune seconds ({CARD}; phase 24 {tune_secs['phase']}s): "
          f"{json.dumps(tune_secs)}", flush=True)
    print(f"audit seconds ({CARD}; phase 25 {audit_secs['phase']}s): "
          f"{json.dumps(audit_secs)}", flush=True)
    print(f"host services seconds ({CARD}; phase 26 {host_secs['phase']}s):"
          f" {json.dumps(host_secs)}", flush=True)
    print(f"ir seconds ({CARD}; phase 27 {ir_secs['phase']}s): "
          f"{json.dumps(ir_secs)}", flush=True)
    print(f"chip_smoke.py total {time.perf_counter() - t_start:.1f}s "
          f"({CARD})", flush=True)
    paths = {"nearestNeighbor": launches, CHECK_PATH: path_counts,
             BENCH_PATH: bench_counts, PIPE_PATH: pipe_counts,
             SEQ_PATH: seq_counts, STREAM_PATH: stream_counts,
             TMC_PATH: tmc_counts, KMEANS_PATH: km_counts,
             LIB_PATH: lib_counts, CONF_PATH: conf_counts,
             MESH_PATH: mesh_counts, SHARD_PATH: shard_counts,
             INCR_PATH: incr_counts, SERVE_PATH: serve_counts,
             TUNE_PATH: tune_counts, AUDIT_PATH: audit_counts,
             HOST_PATH: host_counts, IR_PATH: ir_counts}

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

"""Chip smoke test of the PyTorch/H100 port: builds the CUDA kernels, loads
the paper's four studies through the port's registry and loaders
(generating their corrupted sets on the card), holds the corruptors and
each kernel against the CPU or their plain PyTorch versions, trains the
three model families at full width, and runs ``test_prio`` and MNIST's
active learning end to end through the port's command line
(``simple_tip_tpu_torch.cli.main``) at full dataset sizes.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Needs one CUDA card; exits non-zero without one (and without the
``simple_tip_tpu_torch`` package beside it). Phases:

1. build the nine kernel sources with ``nvcc`` for sm_90a (one process per
   source, all started together; build seconds printed);
2. data, in a temp ``TIP_DATA_DIR``: ``mnist.npz`` and ``fmnist.npz``
   (60,000 / 10,000) and ``cifar10.npz`` (50,000 / **5,000**), uint8 from
   ``data/synthetic.py`` at ``--seed`` with no corruption cache (state
   ``nominal-only``), and IMDB's five token caches at 25,000 / **12,500** /
   **12,500** (state ``real``); each study loaded through
   ``get_case_study(name).spec.loader(device=card)``, which generates the
   MNIST-C, fmnist-C and CIFAR-10-C style sets (10,000 / 10,000 / 5,000) on the card
   (seconds printed). Checks: each cache's shape, dtype and range, its
   labels equal to ``y_test`` in the generator's order (so the per-kind
   counts of ``_allocate``), two rows of each kind recomputed one at a time
   within one uint8 level, the OOD set (20,000 / 20,000 / 10,000 / 25,000
   rows) the nominal and corrupted sets mixed, the state ``real`` after,
   and every array read back byte-equal after the loaders'
   ``cache_clear()``;
3. the image corruptor on the card against the CPU: each of the 27 kinds at
   each severity on 32 images of each shape (28x28x1, 32x32x3) at the same
   global indices: the words of every draw slot byte-equal, the draws within
   1e-6, the outputs within 1e-5 but for canny, spatter and snow, where the
   pixels apart are counted and capped at 0.1%;
4. the text side: 2,000 English-like texts (``synthetic.english_like_texts``
   over the bundled thesaurus's words) into a ``TextCorruptor`` of **2,000
   words** built on the card and one built on the CPU:
   distance matrices byte-equal (and a 1,000-word subset's matrix computed
   on the CPU, and 200 pairs against the host ``levenshtein``),
   ``lev_matrix`` timed at 2,000 words, ``corrupt(texts, 0.5, 0)`` string-equal, and
   ``build_imdb_caches`` on the texts (shapes and dtypes);
5. training (``casestudies.base.CaseStudy.train`` in a temp ``TIP_ASSETS``
   on the registry's specs, each put back into the registry with its
   epochs cut, so that the command line below reads their checkpoints;
   cuDNN's algorithms deterministic, so that the weights repeat between
   runs): each family at full width on its loader's training set (MNIST 60,000,
   CIFAR-10 50,000, IMDB 25,000) with the registry's train configs
   (batch 128 / 32 / 32, lr 1e-3, validation split 0.1), **epochs cut to 1**
   (the registry trains 15 / 20 / 10); MNIST and IMDB train runs 0 and 1
   (two-member ``train_ensemble``s), CIFAR-10 run 0. Per run: epoch
   seconds and steps, first-step and mean epoch loss, accuracy on the
   held-out 10% and on the nominal test set; checks: the mean loss is below
   the first step's, accuracy clears its floor (``ACCURACY_FLOOR``), each
   checkpoint reads back byte-equal; the IMDB epochs must launch B4, B5 and
   B6 once a step (704 steps a run);
6. per kernel, at its main path's shapes and on the trained weights: max
   error against the plain version, and the times of the kernel, the plain
   version and one library call used as a yardstick only:
   - B1 fused MNIST forward: max |dp| <= 1e-5 over 10,000 images (library:
     the module forward, cuDNN), also replayed from a CUDA graph;
   - B2 DSA nearest, on each path's own DSA (its training subsample, its
     nominal test traces, its badges: MNIST 10,000 queries x 18,000 rows x
     1,600 features, CIFAR-10 10,000 x 15,000 x 2,304, IMDB 500-query
     badges x 7,500 x 20) through the DSA's class layout: min d2 within
     rtol 1e-4, argmins equal or, where they differ, the two rows' exact
     distances within rtol 1e-4 (library: ``torch.cdist`` with a masked
     min); timed per score call, and summed over the score calls the paths
     made; the training tiles the score call's two plans visit, against two
     full walks;
   - B3 fused CIFAR-10 forward: max |dp| <= 1e-5 over 10,000 (training) images
     (library: the module forward, cuDNN), also replayed from a CUDA graph;
   - B4 flash attention: out and lse within atol 1e-5 + rtol 1e-5 on the
     q/k/v of a real IMDB forward over one prediction batch and on a ragged
     shape (T=300, dh=8); timed at that batch and at a training step's
     [32, 100, 2, 32] (library: ``scaled_dot_product_attention``'s forward),
     each also replayed from a CUDA graph (the card's time without the
     host's launch cost, which bounds both calls at the step's shape);
   - B5 and B6 flash backward: dq, dk and dv within atol 1e-5 + rtol 1e-4
     (atol cut to 1e-4 of the largest |want|, so that small gradients are
     held too) on the q, k, v and dO (scaled to unit RMS) of a real IMDB
     training step [32, 100, 2, 32], on
     a ragged [4, 300, 2, 8] and at dh=128 [4, 200, 2, 128]; timed at the
     training step and at [8192, 100, 2, 32] (library: the backward of
     ``scaled_dot_product_attention``, dq, dk and dv together), each also
     replayed from a CUDA graph (the card alone) and by the host's own time
     per eager call;
   - B4, B5 and B6 at wide heads, [64, 128, 2, 256] (their wide-head
     variants): out and lse against the plain version as above, dq, dk and
     dv with the backward's checks; timed beside the SDPA forward and
     backward;
   - the IMDB gradients through ``FlashAttention`` at full width (one batch
     of 32, every parameter, ``train=False``) on the card against the CPU
     within rtol 2e-4 / atol 2e-5 (atol cut per leaf to 2e-4 of its largest
     |gradient| plus the f32 rounding floor), with non-zero q/k/v kernel
     gradients;
7. per path (the loaders' data: MNIST 60,000 / 10,000 / 20,000; CIFAR-10
   **25,000 / 1,000 / 2,000** (its first training and nominal rows,
   ``PATH_CUTS``; trained on all 50,000); IMDB 25,000 / 12,500 / 25,000 with
   ``dsa_badge_size=500``), ``cli.main(["--phase", "test_prio",
   "--case-study", name, "--runs", "0"])`` in-process (all 39 approaches
   with the five SA variants) on run 0's trained checkpoint with every
   launch counter set to 0 just before and read just after: each kernel of
   the path must
   have launched; every artifact is checked for the JAX package's name,
   dtype and shape, every CAM order for being a permutation, SA scores for
   NaN (and +inf outside dsa and pc-lsa); APFD of deep_gini, dsa and
   NAC_0.75 is printed, then per SA variant its setup and score seconds on
   both datasets and its +inf count, pc-mmdsa's chosen k, and the family's
   row of the APFD table (``plotters/eval_apfd_table``: all 39 approaches,
   nominal and OOD, with their reported times). The run fills both caches
   under the temp ``TIP_ASSETS`` with their defaults: per path each SA
   entry's bytes and store seconds, the seconds of hashing each
   fingerprint and the coverage-statistics entry are printed
   (``CacheRecorder``), every SA entry's meta checked (for CIFAR-10, whose
   entries are the largest, that is their whole check);
   then, for MNIST and IMDB, a fresh interpreter (``chip_smoke.py
   --warm-cache FAMILY``, as a run scheduler starts one) builds run 0's
   ``SurpriseHandler`` and ``CoverageWorker`` from the registry on the same
   (weights, training set, taps): 5 SA hits, no training-set forward pass,
   each variant's nominal scores and SC-CAM order byte-equal to the
   artifacts, B2 launched from the loaded DSA, the coverage statistics a
   hit and byte-equal to a recompute, and pc-mdsa's entry loaded onto the
   CPU, its scores of 500 rows within ``SA_RTOL`` of the card's; its warm
   setup seconds are printed beside the cold ones; and IMDB's
   ``CoverageWorker`` with ``spill="disk"``: its 12 metrics' scores and CAM
   orders on both sets byte-equal to the artifacts, its spill directories
   removed;
7b. the fused and grouped chain (``engine/run_program.py``): (a) for MNIST
   and IMDB, ``TIP_FUSED_CHAIN=1 cli.main(["--phase", "test_prio", ...])``
   of run 0 at full size in a fresh ``TIP_ASSETS`` holding the
   checkpoints, both caches pointed at phase 7's (every SA variant a hit),
   the counters read around it: CAM orders, coverage scores, VR and SA
   byte-equal to phase 7's artifacts, ``is_misclassified`` equal but on
   rows whose two largest probabilities lie within 1e-5 (counted: phase 7
   predicts MNIST through B1, the chain through the module), the other
   uncertainties within 1e-5; its phase seconds printed beside phase 7's
   fault predictors and coverage, the chain's and the ranks' seconds
   apart; (b) for each family, on one full badge (512 rows) of the nominal
   set, the chain program (a CUDA graph) against the eager chain on the
   card, every output byte-equal, and the badge with rows 300 on as
   padding (those rows' words zero, the others the full badge's), both
   timed; (c) ``GroupChainRunner`` over MNIST runs 0 and 1 at G=2 and at
   G=3 (a padded third member) on **the first 1,024 rows of the nominal
   and of the OOD set**: each member's result (VR and a top-100 AL select
   included) byte-equal to ``FusedChainRunner``'s for its run, one group
   dispatch per badge; the kernels line gives B4's launches in the fused
   IMDB run (``fused_chain_launches``);
7c. (run after 7d, once every CPU-reference child started so far has
   ended: ``wait_children``) the online scoring service
   (``serving/``): one ``FusedChainExecutor``
   with MNIST and IMDB registered (run 0's trained weights, the full
   training sets, both caches phase 7's, so the coverage statistics are a
   load; badge 512), each engine over it serving both as tenants. The
   capacity probe times two warm 512-row badges a family (badge ms,
   rows/s); the full nominal sets (10,000 / 12,500 rows) are cut into
   seeded requests of 1-700 rows, and the badges these pack into when the
   queue is deep are counted (chunks never split: a fill of ~0.7); the
   rates' base is the rows a second of each tenant, both at once, that keep
   the card busy at those badge times and badges. Both tenants are driven
   open-loop (``drive``) at 0.5x, 1.0x and 2.0x of it, each rate on an
   engine of its own (flush deadline 25 ms; at 2.0x a queue bound of 2
   badges). Checks: every answer byte-equal to the offline walk of the
   same rows (``FusedChainRunner.score_dataset``: pred, uncertainties, the
   12 coverage scores); no shed and no error at 0.5x and 1.0x; at 2.0x
   sheds, ``serving.shed`` equal to the loadgen's count, and a request
   served after the burst; IMDB's badges ride between MNIST's (the fair
   rotation); B4's launches over the traffic equal IMDB's badges times the
   launches its graph records a replay (``serving_launches`` on the kernels
   line). Then MNIST run 1's weights are registered as a third tenant
   (another program, so a capture) while the loop thread serves 2,000 rows
   of run 0 at 2,000 rows/s: no error, no shed, every answer byte-equal,
   and the new tenant's first answer byte-equal to its own walk. Prints per
   rate and family the sustained inputs/s, p50/p95/p99 ms, mean badge
   fill, badges, sheds and errors; register seconds, badge ms and the
   phase's seconds;
7d. the study-execution layer (``parallel/run_scheduler.py``,
   ``resilience/``, ``utils/device_watchdog.py``, ``data/real_onramp.py``):
   (a) the watchdog on the card: ``probe_local_chips`` (cards counted in a
   subprocess) and ``ensure_responsive_backend``, seconds printed; (b) on
   **a cut of MNIST's data, its first 20,000 training and 2,000 nominal
   rows** (``SCHED_DATA``; the loader generates the 2,000 corrupted rows),
   ``cli.main(... "--runs", "0,1", "--workers", "2")``
   with ``TIP_WORKER_PLATFORMS=default,default``, both caches of the phase's
   own (the workers fit and store) and each worker's event stream under
   ``TIP_OBS_DIR``, then runs 0 and 1's in-process ``cli.main --phase
   test_prio`` walk on the same caches (every SA fit a load of a worker's
   entry): each run on exactly one worker, both card workers running at
   once, each launching B1 and B2 (read from its flushed metrics), no run on
   a CPU worker, every artifact byte-equal to the in-process walk's for the
   same run and route, both runs journaled; the scheduler's
   wall time, each run's seconds in its worker and the in-process seconds
   printed; (c) the
   drills in a fresh ``python -c`` interpreter (``drills_main``; its
   synthetic-phase workers import no torch), on two ``default`` workers: a
   ``worker.run`` kill of one run (requeued onto a CPU worker, the JAX
   contract for a synthetic phase; completes), a
   wedge past a 3 s ``run_timeout_s`` (reaped, requeued, counted), and a
   journaled phase whose two failing runs are the only ones its resume
   (plan cleared) runs; (d) the onramp: ``prepare_all`` on raw layouts
   written from ``--seed`` (the 15 MNIST-C folders of 10,000 images, a
   CIFAR-10-C release of two corruptions of 5,000, fmnist-C, 1,000 + 1,000
   English-like IMDB texts), IMDB's corruption on the card; the loaders read
   the results: every MNIST-C slice byte-equal to the written rows in the
   cache and in ``load_mnist``'s OOD set, IMDB's corrupted set loaded;
7e. sequence parallelism (``parallel/ring_attention.py``,
   ``parallel/ulysses_attention.py``, ``parallel/exchange.py``) and the
   full-study command (``full_study.py``, ``parallel/distributed.py``): one
   group of 4 ranks on the card, spawned before phase 7d so that their
   start runs beside it (``SpGroup``, ``run_ranks``; gloo, since NCCL
   refuses two ranks on one GPU; the exchanges that gloo cannot take on
   CUDA tensors staged through host memory, counted per operation and
   printed), each rank on every B4, B5 and B6 launch: (a) IMDB run 0's
   model at full width (vocab 2000, T=100, 2 heads of 32) as ring over 2
   and over 4 ranks and as ulysses over 2, its probabilities and taps on
   one prediction batch (600 rows) within rtol 2e-4 / atol 2e-5 of the
   one-rank flash model and one training step's gradients (32 rows) to
   phase 6's tolerance, the counters zeroed just before each case and read
   just after: B4, B5 and B6 launched in every rank; (b) the long-context
   core at [1, 32768, 2, 32], ring and ulysses over 2 ranks, forward and
   backward on each rank's shard, gathered and held against one-rank flash
   attention at the full length (output within rtol 2e-4 / atol 2e-5,
   gradients as phase 6's B5/B6 checks), then timed (3 repetitions) beside
   one-rank B4-B6 and their bound; NCCL chosen and formed at world size 1,
   the ring model's step byte-equal to the flash model's; (c)
   ``python -m simple_tip_tpu_torch.full_study --case-studies imdb --runs
   0,1 --phases test_prio,evaluation`` as two hosts on a localhost
   coordinator on the card, on phase 5's checkpoints with both caches
   phase 7's, started after (a) and (b) and run beside phases 8-12
   (checked after phase 12): each host reports 1/2 runs, only host 0 prints the
   evaluation lines, every host reaches both rendezvous and host 0
   aggregates only after every host's phase ended (the event streams),
   run 0's artifacts byte-equal to phase 7's, run 1's complete; each
   host's B4 launches read from its flushed metrics;
8. per path, the slice with DSA on a small subset (**1,000 training, 250
   test rows**) on the card and on the
   CPU (the plain versions), compared artifact by artifact; then the four
   other SA variants fitted and scored on the card and on the CPU from the
   same traces (``SA_CHECK``: MNIST 20,000 training rows, CIFAR-10 25,000,
   IMDB 2,000; 500 test rows; pc-mlsa on MNIST and CIFAR-10 on 500
   training rows of one class at their 64 features of highest variance,
   since its EM at 1,600 or 2,304 features takes minutes on the CPU and is
   ill-conditioned on so few rows): the same chosen k and ``reg_covar``
   rungs, the same +inf rows, finite scores (and pc-lsa's log densities
   before the exp) within rtol 1e-3, SC-CAM orders equal in all but 5% of
   their positions; on MNIST and CIFAR-10 pc-mlsa is also read at full
   width on one class's rows (``MlsaFullWidth``: finite scores and the
   APFD of both sides' SC-CAM orders within 0.02 gated; each side's
   ``reg_covar`` rung, the score gap and SC-CAM moves printed, and the rows
   that move in or out of its top-k and SC-CAM first-k at k = 20% of the
   class's rows, the share that active learning selects); its CPU fit runs
   in a child process (``--cpu-ref``, ``CpuReference``) beside the phases
   that follow, and is read and checked after phase 9, as are the four
   small variants' CPU fits (a child process too);
9. MNIST's active-learning phase (``cli.main(["--phase",
   "active_learning", ...])`` on run 0's checkpoint, the registry's spec
   cut as below, the launch counters set to 0 just before and read just
   after: B1 and B2 must launch) at full width with the JAX
   registry's observed share 0.5 and 1,000 selected rows, its 80 retrains
   through ``parallel/al_ensemble.py``, with two cuts: **retrains run one
   epoch** (the registry trains 15) and **the AL training base is the
   first 6,000 of the 60,000 training rows**, **the nominal and OOD sets
   their first 5,000 and 10,000 rows**.
   Checks: the 81 pickles'
   names and layout, every accuracy in [0, 1], the selections' sanity
   checks (inside ``evaluate``), each retrain's one epoch, and the random
   baseline's retrain at ``AL_RANDOM_FLOOR`` on both nominal splits. Its
   training base is cut, so its fingerprint is not that of ``test_prio``:
   both caches miss by design, and each variant's outcome is printed.
   Prints the seconds of scoring the original model, of
   each selection (FP / NC / SA), of all retrains and per retrain, and of
   scoring the retrained models, and MNIST's row of the AL table
   (``plotters/eval_active_learning_table``);
10. the four selection builders on a small subset (``AL_CHECK``) on the card
   and on the CPU, rows moved per selection counted: the random baseline
   equal; an uncertainty's top-k equal but for rows within 1e-5 of its
   edge; a coverage top-k or CAM first-k equal but where the metric's
   scores differ by the known flipped threshold bits (at most 2 per row,
   1% of rows); an SA top-k equal but for rows within ``SA_RTOL`` of its
   edge, an SC-CAM first-k within ``SA_ORDER_CAP`` of its rows; VR is
   counted only (other generators). The SA builder runs dsa, pc-lsa,
   pc-mdsa and pc-mmdsa: pc-mlsa's CPU fit at 1,600 features takes about
   a minute a class, and its known card/CPU gap is counted at full width
   in phase 8; both caches are off here (the CPU would load the card's
   fits); the CPU side runs in a child process (``--cpu-ref``) started
   after training, beside phases 6-9;
11. ``at_collection`` (``CaseStudy.collect_activations``) of MNIST run 0 on
   the first 1,000 rows of each set, on the card and on the CPU: the same
   files, dtypes and shapes, labels byte-equal, each tap within 1e-5 of its
   largest magnitude;
12. ``cli.main`` ``--phase evaluation`` (``--eval test_prio``,
   ``active_learning``, ``test_prio_statistics`` and
   ``active_learning_statistics``) and ``--phase check`` over the paths'
   assets: both tables written with their LaTeX paper tables, the four
   statistics CSVs the 39 x 39 grid under the human labels, every path's
   run 0 complete (models, prio artifacts, times; MNIST's AL pickles);

then phase 7f, the observability and planning plane (``obs/``, ``plan/``,
``utils/flops.py``, ``utils/profiling.py``; ``run_obs_phase``), after
phase 12 so that it moves no earlier phase: (c) ``store.refresh`` over the
event streams of phases 7d and 7e into a fresh index, which must give rows
of a non-TPU platform with positive seconds; ``python -m
simple_tip_tpu_torch.obs predict`` for MNIST's ``test_prio`` (an estimate,
or exit 3 on an insufficient corpus: which is printed) and ``python -m
simple_tip_tpu_torch.plan suggest`` twice (byte-identical files, or exit 3
twice); (d) the bundled SLO rules written (``slo.write_default_rules``)
and one ``alerts.tick()`` over the live registry phases 7c-12 left, each
rule's state printed; then, on a fresh registry, (a) ``detect_device()``
must name the card and ``resolve_peaks`` give the H100 SXM entry (3xTF32
FLOP/s, HBM3 bytes/s), MNIST run 0's fused chain walks its 10,000 nominal
rows (replays of the captured graph; each dispatch graded by the run
program's ``observe_dispatch`` against the chain's analytic cost,
``devicemeter.chain_cost``: the forward's matmul FLOPs, and the bytes of
the forward, the coverage metrics and the outputs) and B1
scores the same rows in 5 launches of 2,000 (each graded against its
analytic cost); the roofline rows (achieved FLOP/s and GB/s, MFU, HBM
fraction, verdict) are printed beside the card's name and power limit, and
the phase fails if a program cannot be graded, if its fastest dispatch
grades a share above ``OBS_SHARE_CAP`` (the count would be wrong) or if B1
did not launch; (b) the same walk and B1 under ``maybe_trace("chain_walk")``
with ``TIP_PROFILE_DIR`` set, the ``torch.profiler`` trace spliced under
its span (``obs/splice.py``): the spliced document must hold device kernel
events inside the span's window, B1's among them, and the device's busy
share of that window is printed (this window's only). A ``{"obs": ...}``
line carries the phase's record.

then phase 7g, the bf16 scoring mode (``TIP_COMPUTE_DTYPE=bfloat16``;
``run_bf16_phase``), last, on a free card: (a) B1, B3 and B4 in bf16 on
the trained weights: B1 over MNIST's 10,000 nominal images and B3 over
CIFAR-10's first 10,000 training images against their plain versions
(``BF16_FUSED_MAX``, ``_MEAN``, ``_ROWS``), the float32 kernel and the bf16 module (cuDNN bf16;
``BF16_MODE_MAX``, ``BF16_MODE_MEAN``, ``BF16_ARGMAX_SHARE`` on these
trained weights), B4 on the bf16 q/k/v of an IMDB bf16 forward over
one prediction batch and on a ragged [3, 37, 2, 32] x Tkv 53 (its one-tile
route) and on [2, 200, 2, 64] (its two-pass route), each shape's route
counter moved (outputs within
one bf16 ulp at their largest magnitude, their mean within
``BF16_MEAN_ULPS`` of it, lse within 1e-5), each timed eager and from a CUDA graph beside its
plain version and its library yardstick (the bf16 module forward; SDPA on
bf16); (b) ``TIP_COMPUTE_DTYPE=bfloat16 cli.main --phase test_prio`` of
run 0 in a fresh ``TIP_ASSETS`` (its SA fits and coverage statistics made
anew under the bf16 key): MNIST at full size (B1 in bf16 and B2 must
launch, B1 must not), CIFAR-10 on **its first 25,000 training and 1,000
nominal rows**, phase 7's cut (``PATH_CUTS``; B3 in
bf16 and B2 must launch, B3 must not), IMDB under ``TIP_FUSED_CHAIN=1``
(B4 in bf16 and B2 must launch, B4 must not); every artifact's name, dtype
and shape checked as in phase 7, APFD printed beside phase 7's float32
APFD; (c) the caches' dtype tag: MNIST's bf16 SA entries all under the bf16
key, none under the float32 key, phase 7's directory holding no bf16 entry
and its float32 DSA entry not served to the bf16 key.

Cuts of depth, so that phase 7g fits the command's time: **CIFAR-10's
nominal test set is 5,000 images** (its OOD set 10,000) and **IMDB's
12,500 texts** (OOD 25,000) in every phase that scores them; phase 7's
and 7g's CIFAR-10 runs score its first 25,000 training and 1,000 nominal
rows (``PATH_CUTS``); phase 7d runs on a MNIST cut (``SCHED_DATA``); AL's
base is 6,000 rows and its test sets 5,000 / 10,000; the small slices
1,000 / 250 rows; the text
check's dictionary 2,000 words. Training stays at full size.

Each kernel's bound is the larger of its bytes at 3.35 TB/s and its FLOPs
at the rate of the unit that does each of its products (``UNITS``): 3xTF32
on the tensor cores (three TF32 products at 495 TF/s) for B2, B4, B5 and
B6, and for B1's conv2 and B3's three convs; float32 FMAs at 67 TF/s for
B1's conv1 and the dense layers of B1 and B3; in the bf16 mode bf16
products on the tensor cores at 989.4 TF/s for B4 and the convs of B1 and
B3 (conv1 of B1 and the dense layers on the FMAs). B1 and B3 also report the
bound with every FMA at 67 TF/s (``f32_bound_ms``), the bound of earlier
kernels that ran on the FMAs alone.

Prints the card's name and power limit, per-run training records, per-path
seconds, one ``{"kernels": [...]}`` line, and last ``{"ok": true, "device":
{...}}``. Inputs are made with numpy from ``--seed``: the MNIST, CIFAR-10
and IMDB stand-ins of ``data/synthetic.py`` written as the real datasets'
files, whose ambiguous 8% keep a trained model's nominal faults, and so
nominal APFD, defined; the image OOD sets are the loaders' generated
corruptions. Weights are the port's own training on them, from flax's
initializers drawn from the run id.
"""

import argparse
import asyncio
import contextlib
import dataclasses
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed
import torch.nn.functional as F

from simple_tip_tpu_torch import _build, cli, obs
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.casestudies import base
from simple_tip_tpu_torch.casestudies.base import CaseStudy
from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.data import image_corruptor, imdb_prep, loaders, synthetic
from simple_tip_tpu_torch.device import resolve, synchronize
from simple_tip_tpu_torch.engine import (
    coverage_stats_cache,
    eval_active_learning,
    eval_prioritization,
    run_program,
    sa_prep,
)
from simple_tip_tpu_torch.engine.coverage_handler import PROFILE_BADGE_SIZE, CoverageWorker
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.run_program import (
    KERNEL_COUNTERS,
    FusedChainRunner,
    GroupChainRunner,
    badge_layout,
)
from simple_tip_tpu_torch.engine.sa_prep import SharedTrainPrep, VariantFitter
from simple_tip_tpu_torch.engine.surprise_handler import (
    SA_VARIANTS,
    SurpriseHandler,
    _sc_cam_order,
)
from simple_tip_tpu_torch.models import Cifar10ConvNet, ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.models.predict import PREDICT_BATCH, predict, to_device
from simple_tip_tpu_torch.models.train import (
    categorical_crossentropy,
    evaluate_accuracy,
    training_rows,
)
from simple_tip_tpu_torch.obs import devicemeter
from simple_tip_tpu_torch.ops import LAUNCH_COUNTERS, dsa_cuda, flash_attention, fused_forward
from simple_tip_tpu_torch.ops.apfd import apfd_from_order
from simple_tip_tpu_torch.ops.levenshtein import lev_matrix, levenshtein
from simple_tip_tpu_torch.ops.text_corruptor import TextCorruptor
from simple_tip_tpu_torch.parallel import exchange, shared_loop
from simple_tip_tpu_torch.parallel.distributed import run_ranks, sp_backend
from simple_tip_tpu_torch.parallel.ring_attention import ring_attention, sequence_parallel_group
from simple_tip_tpu_torch.parallel.ulysses_attention import ulysses_attention
from simple_tip_tpu_torch.plotters import eval_active_learning_table, eval_apfd_table, times_collector
from simple_tip_tpu_torch.plotters.utils import APPROACHES, human_approach_names
from simple_tip_tpu_torch.serving import (
    Chunk,
    ContinuousBatcher,
    FusedChainExecutor,
    ScoringEngine,
    ServingKnobs,
    drive,
)
from simple_tip_tpu_torch.utils import artifact_check, checkpoint
from simple_tip_tpu_torch.utils.flops import conv_net_forward_flops

START = time.perf_counter()  # the command's clock, from the imports on
SMALL_TRAIN, SMALL_TEST = 1_000, 250
# Phase 7's CLI run of CIFAR-10, and phase 7g's bf16 one, score its first
# 25,000 training and 1,000 nominal rows (a cut data directory; the loader
# generates its 1,000 corrupted rows; the model is trained on all 50,000):
# 2,500 training rows a class, above its SA tap's 2,304 features.
PATH_CUTS = {"cifar10": (25_000, 1_000)}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# The unit that does each kernel's products, and its rate for them: float32
# FMAs outside the tensor cores (67 TF/s), or 3xTF32 on the tensor cores
# (three TF32 products at 495 TF/s, so 165 TF/s of float32-accurate work).
UNITS = {
    "f32": (67e12, "float32 FMAs on the CUDA cores, 67 TF/s"),
    "3xtf32": (495e12 / 3, "3xTF32 on the tensor cores, 3 TF32 products at 495 TF/s"),
    "bf16": (989.4e12, "bfloat16 products on the tensor cores, 989.4 TF/s (dense)"),
}
UNCERTAINTIES = ("softmax", "pcs", "softmax_entropy", "deep_gini")
NC_METRICS = (
    "NBC_0", "NBC_0.5", "NBC_1", "SNAC_0", "SNAC_0.5", "SNAC_1",
    "NAC_0", "NAC_0.75", "TKNC_1", "TKNC_2", "TKNC_3", "KMNC_2",
)
SA_NAMES = tuple(SA_VARIANTS)
NEW_SA = ("pc-lsa", "pc-mdsa", "pc-mlsa", "pc-mmdsa")
# The card-against-CPU check of the four SA variants, on the same traces:
# training rows (more per class than the tap has features, so that MDSA's
# covariances are not singular), test rows, and for pc-mlsa on the convnets
# the rows and features of its one-class check. Its EM at 1,600 or 2,304
# features takes minutes a class on the CPU, and on 500 rows its covariances
# are singular but for the ridge (condition ~1e7), where float32 EM on an
# H100 and on its host's CPU differed by 2.1e-3 to 7.4e-2 over three runs
# on MNIST: so it is gated on one class's 500 training rows at their 64
# features of highest variance, and read at full width apart (below).
# Scores must agree within SA_RTOL (finite rows, equal +inf rows; pc-lsa
# also its log densities before the exp, whose +inf scores leave few
# finite rows), the chosen k and MLSA rungs exactly, and the SC-CAM orders
# in all but SA_ORDER_CAP of their positions.
SA_CHECK = {"mnist": (20_000, 500, (500, 64)), "cifar10": (25_000, 500, (500, 64)),
            "imdb": (2_000, 500, None)}
SA_RTOL = 1e-3
SA_ORDER_CAP = 0.05
# pc-mlsa at full width (``MlsaFullWidth``): its EM's float32 Cholesky of
# near-singular covariances fails on one device and not the other near the
# ridge, so even the reg_covar rung can differ (CIFAR-10, 1e-4 on an H100
# against 1e-6 on its host's CPU, scores 5.5x apart); what is gated is the
# APFD of each side's SC-CAM order, within MLSA_APFD_GAP.
MLSA_APFD_GAP = 0.02
# Its CPU side (minutes of EM) runs in a child process beside the card
# phases that follow (``CpuReference``), on this many of the host's threads,
# and is read after phase 9.
MLSA_CPU_THREADS = 6
# The other CPU sides of card-against-CPU checks (phase 8's four small SA
# variants, phase 10's selections) run in child processes too, on this many
# threads each. Every such child runs at this niceness, so that the card
# phases beside it, whose host work launches the kernels, keep their cores.
CPU_REF_THREADS = 2
CPU_REF_NICE = 10
CPU_REF_TIMEOUT_S = 900
# Per path: model, (train, nominal, ood) sizes, NC and SA taps, DSA badge,
# batch size (the JAX case study's prediction badge), coverage neurons of
# the NC taps, the kernels the test_prio path must launch; for training the
# JAX registry's batch size, the runs trained, the classes, and the kernels
# the training epoch must launch once a step.
PATHS = {
    "mnist": dict(
        model=MnistConvNet, sizes=(60_000, 10_000, 20_000), nc=[0, 1, 2, 3], sa=[3],
        dsa_badge=None, batch=128,
        neurons=26 * 26 * 32 + 13 * 13 * 32 + 11 * 11 * 64 + 5 * 5 * 64,
        kernels=("fused_mnist_forward", "dsa_nearest"), chain_kernels=("dsa_nearest",),
        train_batch=128, runs=[0, 1], classes=10, train_kernels=(),
    ),
    "cifar10": dict(
        model=Cifar10ConvNet, sizes=(50_000, 5_000, 10_000), nc=[0, 1, 2, 3], sa=[3],
        dsa_badge=None, batch=32,
        neurons=30 * 30 * 32 + 15 * 15 * 32 + 13 * 13 * 64 + 6 * 6 * 64,
        kernels=("fused_cifar10_forward", "dsa_nearest"), chain_kernels=("dsa_nearest",),
        train_batch=32, runs=[0], classes=10, train_kernels=(),
    ),
    "imdb": dict(
        model=ImdbTransformer, sizes=(25_000, 12_500, 25_000), nc=[3, 5], sa=[5],
        dsa_badge=500, batch=600, neurons=32 + 20,
        kernels=("flash_attention_fwd", "dsa_nearest"),
        chain_kernels=("flash_attention_fwd", "dsa_nearest"),
        train_batch=32, runs=[0, 1], classes=2,
        train_kernels=("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    ),
}
# Accuracy a trained run must reach after its one epoch, on the held-out 10%
# and on the nominal test set: well above twice chance (0.2, 0.6). One epoch
# reached 0.954-0.961 on all three (CIFAR-10 and IMDB on an H100, MNIST on
# the CPU); the stand-ins' 8% ambiguous samples cap it near 0.96.
ACCURACY_FLOOR = {"mnist": 0.85, "cifar10": 0.85, "imdb": 0.85}
# MNIST's active-learning phase: the JAX registry's observed share and
# selection size, and the cut of its training
# base (retrains run the paths' one epoch). The random baseline's retrain
# must reach AL_RANDOM_FLOOR on both nominal splits (its 92 steps on the
# cut base; the full-set epoch reaches ACCURACY_FLOOR).
AL_FAMILY = "mnist"
AL_TRAIN_ROWS = 6_000
AL_TEST_ROWS = (5_000, 10_000)
AL_OBSERVED_SHARE = 0.5
AL_NUM_SELECTED = 1000
AL_RANDOM_FLOOR = 0.7
# The card-against-CPU check of the selection builders: training rows (as
# SA_CHECK's, so that MDSA's covariances are not singular), test rows per
# set (half of them observed), rows selected (20% of the observed, as in the
# AL phase), and the SA variants (pc-mlsa's CPU fit at 1,600 features takes
# about a minute a class; its gap is read at full width in phase 8).
AL_CHECK = (20_000, 500, 50)
AL_CHECK_SA = ("dsa", "pc-lsa", "pc-mdsa", "pc-mmdsa")
AL_UNCERTAINTY_ATOL = 1e-5
# The fresh-interpreter check of the caches that phase 7 filled: the paths
# it runs on (CIFAR-10's entries, the largest, are checked by their meta),
# its limit in seconds, and the rows of the nominal set on which an entry
# loaded onto the CPU is scored against the card.
WARM_CACHE_PATHS = ("mnist", "imdb")
WARM_CACHE_TIMEOUT_S = 600
CPU_ENTRY_ROWS = 500
CACHE_VARS = ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR")
# at_collection: rows dumped per set, and the tolerance of each tap (card
# against CPU) relative to the tap's largest magnitude
ACTIVATION_ROWS = 1_000
ACTIVATION_RTOL = 1e-5
# The data phase's fixtures: the real datasets' splits, uint8 images of
# data/synthetic.py at --seed plus an offset (fmnist's 1 sets it apart from
# MNIST's), no corruption cache; the registry's loaders then generate
# 10,000 corrupted images each on the card with the seed each loader gives
# it (CORRUPTION_SEEDS). At offset 0 the three paths train and score the
# arrays that the card-against-CPU SA tolerances were set on; with
# CIFAR-10's drawn at --seed + 2, its pc-mdsa (2,500 rows a class at 2,304
# features: nearly singular covariances) came 1.4e-2 apart in one of two
# runs.
IMAGE_FIXTURES = {"mnist": (60_000, 10_000, (28, 28, 1), 0),
                  "fmnist": (60_000, 10_000, (28, 28, 1), 1),
                  "cifar10": (50_000, 5_000, (32, 32, 3), 0)}
IMDB_FIXTURE = (25_000, 12_500, 0)
CORRUPTION_SEEDS = {"mnist": 11, "fmnist": 22, "cifar10": 33}
# Rows per kind recomputed one at a time against the generated cache (within
# one uint8 level, or CORRUPTOR_ATOL for fmnist's floats).
ROWS_PER_KIND = 2
# The corruptor card against CPU: images per (kind, severity) at the global
# indices CORRUPTOR_INDICES; the draws' words byte-equal, their floats within
# CORRUPTOR_DRAW_ATOL, the outputs within CORRUPTOR_ATOL but for the kinds
# that threshold floats, where differing pixels are counted and capped at
# CORRUPTOR_FLIP_CAP of the pixels.
CORRUPTOR_INDICES = np.arange(100, 132)
CORRUPTOR_DRAW_ATOL = 1e-6
CORRUPTOR_ATOL = 1e-5
CORRUPTOR_FLIP_CAP = 1e-3
THRESHOLDED_KINDS = ("canny_edges", "spatter", "snow")
# The text check: English-like texts, the corruptor's dictionary, and the
# words of the card-against-CPU check of the distance matrix.
TEXTS = 2_000
DICTIONARY = 2_000
LEV_CHECK_WORDS = 1_000
# The fused and grouped chain (``TIP_FUSED_CHAIN``, ``TIP_CHAIN_GROUP``):
# the paths run through the command line with the chain on; the tolerances
# of its artifacts against the per-phase route's (uncertainties, and the
# gap of the two largest probabilities under which a prediction may flip:
# the per-phase route predicts MNIST through B1, the chain through the
# module); the rows from which the graph check's badge is padding, its
# timing repetitions; the group check's family, rows per set (cut from the
# full sets), group sizes (G=3 pads a third member) and AL select size.
CHAIN_PATHS = ("mnist", "imdb")
CHAIN_UNCERTAINTY_ATOL = 1e-5
CHAIN_TIE_GAP = 1e-5
CHAIN_PAD_VALID = 300
CHAIN_REPS = 20
CHAIN_GROUP_FAMILY = "mnist"
CHAIN_GROUP_ROWS = 1_024
CHAIN_GROUP_SIZES = (2, 3)
CHAIN_SELECT_K = 100
# The online scoring service (phase 7c): the families served as two tenants
# of one engine, the badge (the offline walk's), the warm badges of the
# capacity probe, the open-loop rates as multiples of MNIST's capacity, the
# range of a request's rows, the flush deadline (the knob's default), the
# 2.0x rate's queue bound in badges and the rows of the request served
# after its burst.
SERVE_FAMILIES = ("mnist", "imdb")
SERVE_BADGE = PROFILE_BADGE_SIZE
SERVE_PROBE_BADGES = 2
SERVE_RATES = (0.5, 1.0, 2.0)
SERVE_OVERLOAD = 2.0
SERVE_REQUEST_ROWS = (1, 700)
SERVE_FLUSH_S = 0.025
SERVE_OVERLOAD_QUEUE_BADGES = 2
SERVE_FINAL_ROWS = 100
# A tenant registered while another is served: the MNIST rows and rate of
# the traffic it lands in, and how long that traffic runs before it.
SERVE_LATE_ROWS = 2_000
SERVE_LATE_RATE = 2_000.0
SERVE_LATE_START_S = 0.1
# The study-execution layer (phase 7d): MNIST's runs 0 and 1 over two card
# workers, the drills' run timeouts (the wedge drill's is the one it
# exceeds), the onramp's CIFAR-10-C release (corruptions, rows each) and
# IMDB corpus (train, test texts).
SCHED_FAMILY = "mnist"
SCHED_RUNS = (0, 1)
# Phase 7d's runs score a cut of MNIST's data: its first 20,000 training and
# 2,000 nominal rows (the loader generates 2,000 corrupted rows): 2,000
# training rows a class, above the SA tap's 1,600 features.
SCHED_DATA = (20_000, 2_000)
SCHED_WORKERS = 2
SCHED_WEDGE_TIMEOUT_S = 3.0
SCHED_DRILL_RUN_TIMEOUT_S = 120.0
SCHED_DRILL_TIMEOUT_S = 300
ONRAMP_CIFAR = (("fog", "snow"), 5_000)
ONRAMP_TEXTS = (1_000, 1_000)
# Sequence parallelism and the full-study command (phase 7e): one spawned group of
# SP_WORLD ranks on the card (gloo: NCCL refuses two ranks on one GPU; its
# first two ranks form the 2-rank subgroup), the IMDB cases over it (core,
# ranks) on run 0's weights, their tolerance against the one-rank flash
# model (the gradients': phase 6's), the training step's rows, the
# long-context core's shape, cores and timing repetitions, and the study
# command's family, runs and time limit in seconds (the group's limit covers
# the phases it waits through: it is spawned before phase 7d).
SP_WORLD = 4
SP_CASES = (("ring", 2), ("ring", 4), ("ulysses", 2))
SP_RTOL, SP_ATOL = 2e-4, 2e-5
SP_STEP_ROWS = 32
SP_LONG_SHAPE = (1, 32768, 2, 32)
SP_LONG_CORES = ("ring", "ulysses")
SP_LONG_REPS = 3
SP_TIMEOUT_S = 900
STUDY_FAMILY = "imdb"
STUDY_RUNS = (0, 1)
STUDY_TIMEOUT_S = 400
# The flash kernels every rank of the sequence-parallel path must launch.
SP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# The observability and planning plane (phase 7f): the family whose run 0's
# chain is walked and graded, B1's rows a launch on the same rows, the
# largest share of a peak a graded dispatch may show, the device event
# categories of a torch Chrome trace, and B1's kernel name there.
OBS_FAMILY = "mnist"
OBS_B1_ROWS = 2_000
OBS_SHARE_CAP = 1.05
OBS_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OBS_B1_KERNEL = "mnist_forward_kernel"
# What each graded program's analytic cost counts (the phase's record says it).
OBS_COST_BASIS = {
    "chain": "FLOPs: the forward's matmuls and convs (the MFU convention: the coverage's "
             "comparisons are not FLOPs); bytes: the forward's activations, the taps read "
             "once by the coverage, its thresholds once a dispatch, every profile, score and "
             "output written once (devicemeter.chain_cost)",
    "fused_forward": "FLOPs: the forward's matmuls and convs; bytes: the input read and the "
                     "probabilities written once",
}
# The bf16 scoring mode (phase 7g). Its kernels round activations to bf16
# where the TPU kernels do, so a float32 sum taken in another order than the
# plain version's (and the tensor cores' own accumulation, which rounds
# toward zero) can flip one rounding. On trained weights, whose softmax is
# sharp, one flipped activation moves a probability by up to ~2^-8 of its
# contribution to a logit: 2.06e-3 at most over 10,000 CIFAR-10 images, 11
# images with a |dp| above 1e-4, a mean |dp| of 1.2e-7, the same classes
# predicted, where the plain version on the card and on the CPU agree within
# 6.7e-6 (scripts/torch_bf16_trained.py; on initialised weights the kernels
# are within 1.1e-4, held at 5e-4 in tests/test_torch_kernels_cuda.py). So
# B1 and B3 in bf16 are held to their plain versions at BF16_FUSED_MAX at
# most, BF16_FUSED_MEAN on average, at most BF16_FUSED_ROWS of the images
# with a |dp| above 1e-4, and predicted classes apart on at most
# BF16_ARGMAX_SHARE. Against the float32 kernel and the bf16 module (whose
# convolutions round their outputs and add their biases in bf16) the bf16
# mode itself differs: on initialised weights within 5e-3, the JAX package's
# gate (tests/test_fused_forward.py:38-44, held in the cuda-marked tests);
# on these trained weights each is held to BF16_MODE_MAX at most,
# BF16_MODE_MEAN on average and BF16_ARGMAX_SHARE. B4's p is rounded to bf16
# too: its outputs are held within one bf16 ulp at the output's largest
# magnitude, their mean |difference| within BF16_MEAN_ULPS of that ulp (a
# flipped p moves every output of its query row, so a count of outputs
# apart is no measure), its float32 lse within 1e-5 + 1e-5 |lse|. The end-to-end runs: MNIST run 0 at full size,
# CIFAR-10 run 0 on a cut of its data (PATH_CUTS: training, nominal rows;
# B3 in bf16 is otherwise on no path), IMDB run 0 under the fused
# chain; each in a fresh TIP_ASSETS, with the kernels each must launch and
# the float32 forward kernels each must not. CIFAR-10's cut is phase 7's
# (PATH_CUTS), so the two runs' APFD compare on the same rows.
BF16_FUSED_MAX = 1e-2
BF16_FUSED_MEAN = 1e-6
BF16_FUSED_ROWS = 5e-3
BF16_MODE_MAX = 0.05
BF16_MODE_MEAN = 1e-3
BF16_ARGMAX_SHARE = 0.01
BF16_MEAN_ULPS = 1 / 64
BF16_PATHS = {
    "mnist": dict(fused_chain=False, kernels=("fused_mnist_forward_bf16", "dsa_nearest"),
                  not_launched=("fused_mnist_forward",)),
    "cifar10": dict(fused_chain=False, kernels=("fused_cifar10_forward_bf16", "dsa_nearest"),
                    not_launched=("fused_cifar10_forward",)),
    "imdb": dict(fused_chain=True, kernels=("flash_attention_fwd_bf16", "dsa_nearest"),
                 not_launched=("flash_attention_fwd",)),
}
# Each kernel wrapper's launch counter (the names the workers' metrics use).
COUNTERS = {name: (sys.modules[module], attr)
            for name, (module, attr) in LAUNCH_COUNTERS.items()}


TIMELINE = {}


def timeline(phase: str) -> None:
    """Print and keep the command's seconds at the start of ``phase``."""
    TIMELINE[phase] = round(time.perf_counter() - START, 1)
    print(json.dumps({"timeline": phase, "t_s": TIMELINE[phase]}), flush=True)


def zero_counters() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counters() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def write_fixtures(folder: str, seed: int) -> dict:
    """The data phase's inputs under ``folder`` (``TIP_DATA_DIR``): the three
    image archives, uint8 as the real ones (no corruption cache), and
    IMDB's five token caches. Returns each image set's nominal test split."""
    os.makedirs(os.path.join(folder, "imdb"), exist_ok=True)
    nominal = {}
    for name, (n_train, n_test, shape, offset) in IMAGE_FIXTURES.items():
        (x_tr, y_tr), (x_te, y_te) = synthetic.image_classification(seed + offset, n_train,
                                                                    n_test, shape)

        def to_uint8(x):
            x = np.round(x * 255).astype(np.uint8)
            return x[..., 0] if x.shape[-1] == 1 else x

        np.savez(os.path.join(folder, f"{name}.npz"), x_train=to_uint8(x_tr), y_train=y_tr,
                 x_test=to_uint8(x_te), y_test=y_te)
        nominal[name] = (x_te, y_te)
    n_train, n_test, offset = IMDB_FIXTURE
    (x_tr, y_tr), (x_te, y_te) = synthetic.token_classification(seed + offset, n_train, n_test)
    arrays = {"x_train": x_tr, "y_train": y_tr, "x_test": x_te, "y_test": y_te,
              "x_corrupted": synthetic.corrupt_tokens(x_te, seed + offset + 1)}
    for key, value in arrays.items():
        np.save(os.path.join(folder, "imdb", f"{key}.npy"), value)
    return nominal


def clear_loaders() -> None:
    for fn in (loaders.load_mnist, loaders.load_fmnist, loaders.load_cifar10, loaders.load_imdb):
        fn.cache_clear()


def expected_corruption(name: str, y_test: np.ndarray):
    """The generator's numpy draws for ``name``: per output row its kind,
    source row and severity, and the labels."""
    kinds = (image_corruptor.CIFAR10_C_KINDS if name == "cifar10"
             else image_corruptor.MNIST_C_KINDS)
    rng = np.random.default_rng(CORRUPTION_SEEDS[name])
    allocation = image_corruptor._allocate(rng, len(y_test), len(y_test), len(kinds))
    kind_of, source, severity = [], [], []
    for kind, idx in zip(kinds, allocation):
        kind_of += [kind] * len(idx)
        source.append(idx)
        severity.append(rng.integers(1, 6, size=len(idx)))
    perm = rng.permutation(len(y_test))
    source, severity = np.concatenate(source)[perm], np.concatenate(severity)[perm]
    counts = {kind: len(idx) for kind, idx in zip(kinds, allocation)}
    return np.asarray(kind_of)[perm], source, severity, y_test[source], counts


def check_generated(name: str, triple, nominal, folder: str, dev) -> dict:
    """A generated corruption cache against the generator's draws: shape,
    dtype, range, per-kind counts and labels; ``ROWS_PER_KIND`` rows of each
    kind recomputed one at a time on the card; the OOD mix."""
    x_te, y_te = nominal
    images = np.load(os.path.join(folder, f"{name}_c_images.npy"))
    labels = np.load(os.path.join(folder, f"{name}_c_labels.npy"))
    kind_of, source, severity, want_labels, counts = expected_corruption(name, y_te)
    uint8 = name != "fmnist"
    want_dtype = np.uint8 if uint8 else np.float32
    if images.dtype != want_dtype or images.shape != x_te.shape:
        raise AssertionError(f"{name}: cache {images.dtype}{images.shape}, want "
                             f"{np.dtype(want_dtype)}{x_te.shape}")
    if not uint8 and not (images.min() >= 0 and images.max() <= 1):
        raise AssertionError(f"{name}: cached floats outside [0, 1]")
    if labels.dtype != np.int64 or not np.array_equal(labels, want_labels):
        raise AssertionError(f"{name}: cached labels are not y_test in the generator's order")
    n, k = len(y_te), len(counts)
    if list(counts.values()) != [n // k + (i < n % k) for i in range(k)]:
        raise AssertionError(f"{name}: per-kind counts {counts}")
    worst = 0.0
    for kind in counts:
        for row in np.flatnonzero(kind_of == kind)[:ROWS_PER_KIND]:
            one = image_corruptor.corrupt_images(
                x_te[[source[row]]], kind, int(severity[row]), seed=CORRUPTION_SEEDS[name],
                global_indices=[source[row]], device=dev)[0]
            if uint8:
                err = float(np.abs(np.round(one * 255).astype(np.int64)
                                   - images[row].astype(np.int64)).max())
                limit = 1.0
            else:
                err, limit = float(np.abs(one - images[row]).max()), CORRUPTOR_ATOL
            worst = max(worst, err)
            if err > limit:
                raise AssertionError(f"{name} row {row} ({kind}, severity {severity[row]}): "
                                     f"{err} from its recomputation")
    (_, _), (x_nom, y_nom), (ood_x, ood_y) = triple
    corrupted = images.astype(np.float32) / 255.0 if uint8 else images
    want_x, want_y = loaders._ood_mix(x_nom, y_nom, corrupted, labels, seed=0)
    if not (np.array_equal(ood_x, want_x) and np.array_equal(ood_y, want_y)):
        raise AssertionError(f"{name}: the OOD set is not the nominal and corrupted sets mixed")
    return {"kinds": counts, "recomputed_rows": ROWS_PER_KIND * len(counts),
            "recomputed_max_err": worst}


def data_phase(folder: str, seed: int, dev) -> tuple:
    """Fixtures into ``folder``, then every study's data through the
    registry's loader: the corrupted sets generated on the card (seconds
    printed) and checked, the presence states before and after, and the
    caches read back byte-equal. Returns ({study: triple}, the record)."""
    os.environ["TIP_DATA_DIR"] = folder
    clear_loaders()
    t0 = time.perf_counter()
    nominal = write_fixtures(folder, seed)
    record = {"fixtures_s": time.perf_counter() - t0}
    data = {}
    for name in ("mnist", "fmnist", "cifar10", "imdb"):
        before = loaders.dataset_presence(name)
        if before != ("real" if name == "imdb" else "nominal-only"):
            raise AssertionError(f"{name}: presence {before} before loading")
        t0 = time.perf_counter()
        data[name] = base.get_case_study(name).spec.loader(device=dev)
        synchronize(dev)
        seconds = time.perf_counter() - t0
        after = loaders.dataset_presence(name)
        if after != "real":
            raise AssertionError(f"{name}: presence {after} after loading")
        rows = [len(pair[1]) for pair in data[name]]
        rec = {"state_before": before, "state_after": after, "load_s": seconds, "rows": rows}
        if name in PATHS and rows != list(PATHS[name]["sizes"]):
            raise AssertionError(f"{name}: rows {rows}, want {PATHS[name]['sizes']}")
        if name != "imdb":
            rec.update(check_generated(name, data[name], nominal[name], folder, dev))
        record[name] = rec
    clear_loaders()
    for name, triple in data.items():
        again = base.get_case_study(name).spec.loader(device=dev)
        for (x, y), (x2, y2) in zip(triple, again):
            if x.tobytes() != x2.tobytes() or y.tobytes() != y2.tobytes():
                raise AssertionError(f"{name}: the cached data does not read back byte-equal")
    print(json.dumps({"data": record}))
    return data, record


def _draw_close(kind: str, name: str, dist: str, a: torch.Tensor, b: torch.Tensor) -> float:
    if dist in ("randint", "bernoulli"):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{kind} draw {name}: card and CPU differ")
        return 0.0
    err = float((a.cpu().double() - b.double()).abs().max())
    if err > CORRUPTOR_DRAW_ATOL:
        raise AssertionError(f"{kind} draw {name}: card vs CPU {err} > {CORRUPTOR_DRAW_ATOL}")
    return err


def check_corruptor(images: dict, seed: int, dev) -> dict:
    """Every kind at every severity on ``len(CORRUPTOR_INDICES)`` images of
    each shape at the same global indices, on the card and on the CPU: the
    words of every draw slot byte-equal, the draws within
    ``CORRUPTOR_DRAW_ATOL``, the outputs within ``CORRUPTOR_ATOL`` (pixels
    apart counted and capped for ``THRESHOLDED_KINDS``)."""
    report, breaches = {}, []
    idx = torch.from_numpy(CORRUPTOR_INDICES)
    for shape_name, x in images.items():
        x_cpu = torch.from_numpy(np.ascontiguousarray(x[: len(CORRUPTOR_INDICES)]))
        x_card = x_cpu.to(dev)
        for kind in sorted(image_corruptor.CORRUPTIONS):
            worst = {"out": 0.0, "draws": 0.0, "apart": 0}
            for severity in range(1, 6):
                plan = image_corruptor.draw_plan(kind, severity, tuple(x_cpu.shape[1:]))
                for slot, (name, dist, shape, _, _) in enumerate(plan):
                    count = int(np.prod(shape)) if shape else 1
                    words_card = image_corruptor.random_words(seed, idx.to(dev), slot, count)
                    words_cpu = image_corruptor.random_words(seed, idx, slot, count)
                    if not all(torch.equal(a.cpu(), b) for a, b in zip(words_card, words_cpu)):
                        breaches.append(f"{kind} slot {slot}: words differ")
                d_card = image_corruptor.draw(kind, severity, seed, CORRUPTOR_INDICES,
                                              tuple(x_cpu.shape[1:]), dev)
                d_cpu = image_corruptor.draw(kind, severity, seed, CORRUPTOR_INDICES,
                                             tuple(x_cpu.shape[1:]), "cpu")
                for name, dist, *_ in plan:
                    worst["draws"] = max(worst["draws"], _draw_close(
                        kind, name, dist, d_card[name], d_cpu[name]))
                out_card = image_corruptor.apply(kind, severity, x_card, d_card).cpu()
                out_cpu = image_corruptor.apply(kind, severity, x_cpu, d_cpu)
                err = (out_card - out_cpu).abs()
                apart = int((err > CORRUPTOR_ATOL).sum())
                worst["out"] = max(worst["out"], float(err.max()))
                worst["apart"] += apart
                if kind in THRESHOLDED_KINDS:
                    if apart > CORRUPTOR_FLIP_CAP * err.numel():
                        breaches.append(f"{shape_name} {kind} {severity}: {apart} pixels apart")
                elif apart:
                    breaches.append(f"{shape_name} {kind} {severity}: card vs CPU "
                                    f"{float(err.max())} > {CORRUPTOR_ATOL}")
            report[f"{shape_name}:{kind}"] = worst
    summary = {"images": len(CORRUPTOR_INDICES), "kinds": len(image_corruptor.CORRUPTIONS),
               "max_out_err": max(v["out"] for v in report.values()),
               "max_draw_err": max(v["draws"] for v in report.values()),
               "pixels_apart": {k: v["apart"] for k, v in report.items() if v["apart"]},
               "by_kind": report}
    print(json.dumps({"corruptor_card_vs_cpu": {k: v for k, v in summary.items()
                                                if k != "by_kind"}}))
    if breaches:
        raise AssertionError("corruptor card vs CPU: " + "; ".join(breaches))
    return summary


def check_text(seed: int, dev, folder: str) -> dict:
    """``TEXTS`` English-like texts over the bundled thesaurus's words: the
    text corruptor built on the card and on the CPU (distance matrices
    byte-equal, the same matrix of a ``LEV_CHECK_WORDS``-word subset on the
    CPU, pairs against the host ``levenshtein``), ``corrupt`` string-equal,
    ``lev_matrix`` timed at ``DICTIONARY`` words, ``build_imdb_caches`` on
    the texts."""
    asset = os.path.join(os.path.dirname(image_corruptor.__file__), "assets",
                         "en_thesaurus.jsonl")
    with open(asset) as f:
        base_words = [json.loads(line)["word"] for line in f]
    texts, labels = synthetic.english_like_texts(seed, TEXTS, base_words=base_words)
    t0 = time.perf_counter()
    card = TextCorruptor(texts, cache_dir=None, dictionary_size=DICTIONARY, device=dev)
    card_build_s = time.perf_counter() - t0
    words = card.common_words
    if len(words) != DICTIONARY:
        raise AssertionError(f"text: {len(words)} dictionary words, want {DICTIONARY}")
    synchronize(dev)
    t0 = time.perf_counter()
    matrix = lev_matrix(words, dev)
    lev_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    sub = np.sort(rng.choice(len(words), LEV_CHECK_WORDS, replace=False))
    t0 = time.perf_counter()
    sub_cpu = lev_matrix([words[i] for i in sub], "cpu")
    lev_cpu_s = time.perf_counter() - t0
    pairs = rng.integers(0, len(words), size=(200, 2))
    if (matrix.tobytes() != card.lev_dist.tobytes()
            or matrix[np.ix_(sub, sub)].tobytes() != sub_cpu.tobytes()
            or any(matrix[i, j] != min(levenshtein(words[i], words[j]), 255) for i, j in pairs)):
        raise AssertionError("text: the card's distance matrix differs from the CPU's")
    t0 = time.perf_counter()
    cpu = TextCorruptor(texts, cache_dir=None, dictionary_size=DICTIONARY, device="cpu")
    cpu_build_s = time.perf_counter() - t0
    if cpu.lev_dist.tobytes() != card.lev_dist.tobytes():
        raise AssertionError("text: the CPU's full distance matrix differs from the card's")
    t0 = time.perf_counter()
    got = card.corrupt(texts, severity=0.5, seed=0)
    corrupt_s = time.perf_counter() - t0
    if got != cpu.corrupt(texts, severity=0.5, seed=0):
        raise AssertionError("text: corrupt differs between the card's and the CPU's corruptor")
    changed = sum(a != b for a, b in zip(got, texts))
    half = TEXTS // 2
    out = os.path.join(folder, "imdb_caches")
    t0 = time.perf_counter()
    imdb_prep.build_imdb_caches(texts[:half], labels[:half], texts[half:], labels[half:], out,
                                device=dev)
    caches_s = time.perf_counter() - t0
    for name, dtype, shape in (("x_train", np.int32, (half, 100)), ("y_train", np.int64, (half,)),
                               ("x_test", np.int32, (half, 100)), ("y_test", np.int64, (half,)),
                               ("x_corrupted", np.int32, (half, 100))):
        a = np.load(os.path.join(out, f"{name}.npy"))
        if a.dtype != dtype or a.shape != shape:
            raise AssertionError(f"text: {name} is {a.dtype}{a.shape}, want "
                                 f"{np.dtype(dtype)}{shape}")
    record = {"texts": TEXTS, "dictionary": DICTIONARY, "longest_word_bytes":
              max(len(w.encode()) for w in words), "lev_matrix_s": lev_s,
              "card_build_s": card_build_s, "cpu_build_s": cpu_build_s,
              "lev_cpu_s_at_check_words": lev_cpu_s, "check_words": LEV_CHECK_WORDS,
              "corrupt_s": corrupt_s, "texts_changed": changed,
              "thesaurus_words": len(card.thesaurus), "imdb_caches_s": caches_s}
    print(json.dumps({"text": record}))
    return record


def registry_spec(family: str):
    """The registry's spec of ``family`` with its training cut to one
    epoch (its batch size, learning rate and validation split kept)."""
    spec = base.CASE_STUDIES[family]
    cfg = PATHS[family]
    if (list(spec.nc_activation_layers), list(spec.sa_activation_layers),
            spec.prediction_badge_size, spec.dsa_badge_size, spec.train_cfg.batch_size) != (
            cfg["nc"], cfg["sa"], cfg["batch"], cfg["dsa_badge"], cfg["train_batch"]):
        raise AssertionError(f"{family}: PATHS differs from the registry")
    return dataclasses.replace(spec, train_cfg=dataclasses.replace(spec.train_cfg, epochs=1))


def device_args(dev) -> tuple:
    """The command line's device flags: none on the card (its default),
    ``--device cpu`` when rehearsing on the CPU."""
    return ("--device", "cpu") if dev.type == "cpu" else ()


def run_cli(*argv):
    """``cli.main`` in-process; raises unless it exits 0. Returns what the
    phase returned (``cli.dispatch_phase``'s value), if it ran one."""
    out = {}
    dispatch = cli.dispatch_phase

    def recording(*args, **kwargs):
        out["result"] = dispatch(*args, **kwargs)
        return out["result"]

    cli.dispatch_phase = recording
    try:
        code = cli.main(list(argv))
    finally:
        cli.dispatch_phase = dispatch
    if code != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {code}")
    return out.get("result")


def predicted_classes(family: str, params, x: np.ndarray, dev) -> list:
    """Counts of each predicted class on ``x`` (DSA needs at least two)."""
    model = BaseModel(PATHS[family]["model"](), params, device=dev)
    probs = predict(model.net, model.fused, x, dev)
    counts = torch.bincount(probs.argmax(1), minlength=probs.shape[1]).tolist()
    print(f"{family}: trained run 0 predicts classes {counts} on {x.shape[0]} training inputs")
    if sum(1 for c in counts if c) < 2:
        raise AssertionError(f"{family}: DSA's other-class distance needs two predicted classes")
    return counts


def case_study(family: str, data) -> CaseStudy:
    """The family's one-epoch registry study over ``data`` instead of its
    loader's."""
    return CaseStudy(dataclasses.replace(registry_spec(family), loader=lambda device=None: data))


def train_family(family: str, data, dev) -> tuple:
    """Train the family's runs through ``CaseStudy.train`` with the counters
    read around it; check losses, accuracies and checkpoints. Returns (the
    case study, the record)."""
    cfg = PATHS[family]
    cs = CaseStudy(registry_spec(family))
    zero_counters()
    t0 = time.perf_counter()
    histories = cs.train(cfg["runs"], device=dev)
    train_s = time.perf_counter() - t0
    launches = read_counters()
    (x_tr, y_tr), (x_nom, y_nom), _ = data
    n_fit = training_rows(x_tr.shape[0], cs.spec.train_cfg.validation_split)
    runs = {}
    for run in cfg["runs"]:
        [rec] = histories[run]
        if not rec["mean_loss"] < rec["first_loss"]:
            raise AssertionError(f"{family} run {run}: mean epoch loss {rec['mean_loss']} "
                                 f"is not below the first step's {rec['first_loss']}")
        params = cs.load_params(run)
        with open(cs.model_path(run), "rb") as f:
            if checkpoint.to_bytes(params) != f.read():
                raise AssertionError(f"{family} run {run}: the checkpoint does not read back")
        acc = {
            "held_out_accuracy": evaluate_accuracy(cs.model_def, params, x_tr[n_fit:],
                                                   y_tr[n_fit:], dev),
            "test_accuracy": evaluate_accuracy(cs.model_def, params, x_nom, y_nom, dev),
        }
        for name, value in acc.items():
            if not value >= ACCURACY_FLOOR[family]:
                raise AssertionError(f"{family} run {run}: {name} {value} below the floor "
                                     f"{ACCURACY_FLOOR[family]}")
        runs[run] = {**rec, **acc}
    steps = sum(r["steps"] for r in runs.values())
    for name in cfg["train_kernels"]:
        if launches[name] != steps:
            raise AssertionError(f"{family} training launched {name} {launches[name]} times "
                                 f"in {steps} steps")
    record = {"train": family, "rows": n_fit, "batch": cfg["train_batch"], "train_s": train_s,
              "runs": runs, "launches": launches}
    print(json.dumps(record))
    return cs, record


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of the host's own time per call of ``fn()``, the
    calls queued back to back (after a warm-up; the card is waited for only
    after the last)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - start
    torch.cuda.synchronize()
    return took * 1e3 / reps


def graph_ms(fn, reps: int, stream=None) -> float:
    """Mean milliseconds of ``fn()`` replayed from one CUDA graph of ``reps``
    calls: the card's time alone, without the host's cost of each launch.
    Captured on ``stream`` where given (a backward must be captured on the
    stream of its forward), else on a new one."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, unit: str = "f32"):
    """(least milliseconds at the published peaks, what bounds them), the
    operations counted at the rate of ``unit`` (a key of ``UNITS``)."""
    return mixed_bound_ms([(flops, unit)], nbytes)


def mixed_bound_ms(work, nbytes: float):
    """``bound_ms`` for work done by several units: ``work`` is (FLOPs, key
    of ``UNITS``) pairs, each at its unit's rate, one after another."""
    t_ops = sum(flops / UNITS[unit][0] for flops, unit in work) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _module(family: str, params, dev):
    net = PATHS[family]["model"]().to(dev).eval()
    net.load_state_dict(params["module"])
    return net


def _fused_record(name: str, kernel, plain, net, fused, x, work, replaces: str) -> dict:
    """A fused forward against its plain version on ``x``, max |dp| <= 1e-5,
    and its times: eager, replayed from a CUDA graph, the plain version's and
    the module forward's (cuDNN). ``work`` is its (FLOPs, unit) pairs; the
    bound takes each at its unit's rate, ``f32_bound_ms`` all at 67 TF/s."""
    got = kernel(fused, x)
    want = plain(fused, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"{name} disagrees with its plain version: {err}")
    with torch.no_grad():
        ms = cuda_ms(lambda: kernel(fused, x), 20)
        device = graph_ms(lambda: kernel(fused, x), 20)
        plain_ms = cuda_ms(lambda: plain(fused, x), 3)
        library_ms = cuda_ms(lambda: net(x), 20)
    b = x.shape[0]
    # images read and probabilities written once; the plain version's weights once
    nbytes = b * (x[0].numel() + 10) * 4 + sum(
        t.numel() * 4 for k, t in fused.items() if not k.endswith(("_tc", "_bf")))
    bound, by = mixed_bound_ms(work, nbytes)
    f32_bound, f32_by = bound_ms(sum(flops for flops, _ in work), nbytes)
    return {
        "name": name,
        "route": "cuda",
        "source": f"simple_tip_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "timed": f"one launch over {b} images",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "bound_unit": "convolutions in 3xTF32 on the tensor cores (3 TF32 products at 495 "
                      "TF/s); conv1 (B1) and the dense layers on float32 FMAs, 67 TF/s",
        "f32_bound_ms": f32_bound,
        "f32_bound_by": f32_by,
        "library_ms": library_ms,
        "device_ms": device,
    }


def check_fused_forward(params, x_test: np.ndarray, dev) -> dict:
    """B1 against its plain version on the nominal test set."""
    fused = {k: v.to(dev) for k, v in params["fused"].items()}
    x = torch.from_numpy(x_test).to(dev)
    b = x.shape[0]
    # the positions the floor pool 11->5 needs: conv2 10x10, so conv1 24x24
    work = [(b * 2 * 24 * 24 * 32 * 9, "f32"), (b * 2 * 10 * 10 * 64 * 288, "3xtf32"),
            (b * 2 * 1600 * 10, "f32")]
    return _fused_record("fused_mnist_forward", fused_forward.fused_mnist_probs,
                         fused_forward.fused_mnist_probs_plain, _module("mnist", params, dev),
                         fused, x, work, "simple_tip_tpu/ops/fused_forward.py:60")


def check_cifar10_forward(params, x_test: np.ndarray, dev) -> dict:
    """B3 against its plain version on 10,000 images (the first training
    images: the nominal test set is cut to 5,000)."""
    fused = {k: v.to(dev) for k, v in params["fused"].items()}
    x = torch.from_numpy(x_test).to(dev)
    b = x.shape[0]
    # the positions the floor pools need: conv3 4x4, conv2 12x12, so conv1 28x28
    convs = 28 * 28 * 32 * 27 + 12 * 12 * 64 * 288 + 4 * 4 * 64 * 576
    work = [(b * 2 * convs, "3xtf32"), (b * 2 * (1024 * 64 + 64 * 10), "f32")]
    return _fused_record("fused_cifar10_forward", fused_forward.fused_cifar10_probs,
                         fused_forward.fused_cifar10_probs_plain, _module("cifar10", params, dev),
                         fused, x, work, "simple_tip_tpu/ops/fused_forward.py:153")


def _cdist_nearest(x, labels, train, train_labels, want_same):
    d2 = torch.cdist(x, train).square_()
    same = labels[:, None] == train_labels[None, :]
    return torch.where(same if want_same else ~same, d2, torch.inf).min(dim=1)


def check_dsa_nearest(family: str, params, x_train, x_test, dev) -> dict:
    """B2 against its plain version on one path's own DSA: the path's
    scorer (``SA_VARIANTS["dsa"]``, its subsample and badge) fitted on the
    path's training traces and run over its nominal test traces, every
    badge checked through the DSA's class layout and the DSA's query plan
    per badge (or the full walk, where its searches are too small to plan);
    one score call (the plan, then the same-class search from the test
    traces and the other-class search from their nearest training traces)
    timed on the first badge. Returns the per-path record, times per score
    call."""
    cfg = PATHS[family]
    model = BaseModel(cfg["model"](), params, cfg["sa"], include_last_layer=True,
                      batch_size=1024, device=dev)
    train_outs = model.get_activations(x_train)
    test_outs = model.get_activations(x_test)
    prep = SharedTrainPrep(train_outs[:-1], train_outs[-1].argmax(1).cpu().numpy(), dev)
    dsa = SA_VARIANTS["dsa"](VariantFitter(prep, dev, cfg["dsa_badge"]))
    x = dsa.traces(test_outs[:-1])
    labels = test_outs[-1].argmax(1).to(torch.int32)
    chunk = dsa.badge_size or x.shape[0]
    host_labels = labels.cpu().numpy()
    worst, differing = 0.0, 0
    times, visited, planned = {}, 0, False
    for start in range(0, x.shape[0], chunk):
        xc, lc = x[start : start + chunk], labels[start : start + chunk]
        queries = dsa.query_plan(host_labels[start : start + chunk])
        closest = None
        for want_same in (True, False):
            q = xc if want_same else closest
            args = (q, lc, dsa.rows, dsa.rows_sq, dsa.train_labels, want_same)
            got_min, got_arg = dsa_cuda.masked_nearest(*args, dsa.layout, queries)
            want_min, want_arg = dsa_cuda.masked_nearest_plain(*args)
            finite = torch.isfinite(want_min)
            if not torch.equal(finite, torch.isfinite(got_min)):
                raise AssertionError(f"DSA nearest ({family}): masked rows differ")
            rel = ((got_min - want_min).abs() / want_min.abs().clamp_min(1e-30))[finite]
            if rel.numel() and float(rel.max()) > 1e-4:
                raise AssertionError(
                    f"DSA nearest ({family}): min d2 off by {float(rel.max())} relative")
            if finite.any():
                worst = max(worst, float((got_min - want_min)[finite].abs().max()))
            differ = (got_arg != want_arg) & finite
            differing += int(differ.sum())
            if differ.any():
                rows = q[differ].double()
                d_got = (rows - dsa.rows[got_arg[differ].long()].double()).square().sum(1)
                d_want = (rows - dsa.rows[want_arg[differ].long()].double()).square().sum(1)
                gap = float(((d_got - d_want).abs() / d_want.clamp_min(1e-30)).max())
                if gap > 1e-4:
                    raise AssertionError(f"DSA nearest ({family}): differing argmins {gap} apart")
            if want_same:
                closest = dsa.rows.index_select(0, want_arg.long())
        if start == 0:
            # One score call as the DSA makes it: the query plan (where the
            # DSA plans), then both searches.
            planned = queries is not None
            walks = queries if planned else dsa_cuda.full_walk(len(xc), dsa.rows.shape[0], dev)
            visited = sum(total for total, _ in walks.visits.values())
            searches = ((xc, True), (closest, False))

            def kernel_call():
                plan = dsa.query_plan(host_labels[:chunk])
                for q, same in searches:
                    dsa_cuda.masked_nearest(q, lc, dsa.rows, dsa.rows_sq, dsa.train_labels,
                                            same, dsa.layout, plan)

            calls = {
                "ms": kernel_call,
                "plain_ms": lambda: [dsa_cuda.masked_nearest_plain(
                    q, lc, dsa.rows, dsa.rows_sq, dsa.train_labels, same) for q, same in searches],
                "library_ms": lambda: [_cdist_nearest(q, lc, dsa.rows, dsa.train_labels, same)
                                       for q, same in searches],
            }
            # small calls (IMDB's badges) take more repetitions against the timer's noise
            reps = (3, 2) if planned else (50, 50)
            times = {key: cuda_ms(fn, reps[key != "ms"]) for key, fn in calls.items()}
    c = min(chunk, x.shape[0])
    n, d = dsa.rows.shape
    print(f"dsa_nearest {family}: {differing} argmins differ over {x.shape[0]} queries "
          "(near ties within rtol 1e-4)")
    # The two searches together need every (query, training row) pair once:
    # the same-class pairs in the first, the other-class pairs in the second.
    flops = 2 * c * n * d
    nbytes = 2 * ((c + n) * d * 4 + (c + n) * 8 + c * 8)
    # the kernel's unit: 3xTF32 on the tensor cores, or f32 FMAs for few features
    unit = "3xtf32" if dsa_cuda.tensor_cores(d) else "f32"
    bound, by = bound_ms(flops, nbytes, unit)
    full = 2 * -(-c // dsa_cuda.BLOCK_QUERIES) * -(-n // dsa_cuda.BLOCK_TRAIN)
    return {"queries_per_call": c, "train_rows": n, "features": d,
            "max_abs_err": worst, **times, "bound_ms": bound, "bound_by": by,
            "bound_unit": UNITS[unit][1], "planned": planned, "tiles_visited": visited,
            "tiles_two_full_walks": full}


def dsa_nearest_entry(by_path: dict, launches: dict) -> dict:
    """B2's kernels-line entry: per path, its record (times per score call,
    two launches each) beside its launches on the main path; at the top,
    the sums over the score calls that the main paths made, so ``ms`` and
    ``launches`` describe the same work."""
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    ops_ms = 0.0
    for family, rec in by_path.items():
        rec["launches"] = launches[family]
        calls = launches[family] / 2
        for key in total:
            total[key] += calls * rec[key]
        ops_ms += calls * rec["bound_ms"] * (rec["bound_by"] == "operations")
    return {
        "name": "dsa_nearest",
        "route": "cuda",
        "source": "simple_tip_tpu_torch/csrc/dsa_nearest.cu",
        "replaces": "simple_tip_tpu/ops/dsa_pallas.py:42",
        "launches": sum(launches.values()),
        "max_abs_err": max(rec["max_abs_err"] for rec in by_path.values()),
        **total,
        "bound_by": "operations" if 2 * ops_ms >= total["bound_ms"] else "bytes",
        "bound_unit": "; ".join(f"{family}: {rec['bound_unit']}" for family, rec in by_path.items()),
        "timed": "sum over the main paths' DSA score calls of each path's time per call",
        "by_path": by_path,
    }


def _attention_close(got, want, what: str) -> float:
    """Max |got - want|; raises unless |got - want| <= 1e-5 + 1e-5 |want|."""
    excess = float(((got - want).abs() - 1e-5 * want.abs()).max())
    if excess > 1e-5:
        raise AssertionError(f"flash attention {what}: off by {excess} beyond rtol 1e-5")
    return float((got - want).abs().max())


def check_flash_attention(params, tokens: np.ndarray, dev, seed: int) -> dict:
    """B4 against its plain version: the q/k/v of a real IMDB forward over
    one prediction batch (timed), and a ragged shape (T=300, dh=8)."""
    net = _module("imdb", params, dev)
    attn = net.block.attention
    with torch.no_grad():
        emb = net.embedding(to_device(tokens[:PREDICT_BATCH], dev))
        b, t, _ = emb.shape
        q, k, v = (p(emb).reshape(b, t, attn.num_heads, attn.head_dim) for p in
                   (attn.query, attn.key, attn.value))
    rng = np.random.default_rng(seed)
    ragged = [torch.from_numpy(rng.normal(size=(4, 300, 2, 8)).astype(np.float32)).to(dev)
              for _ in range(3)]
    err = 0.0
    for name, (qq, kk, vv) in (("imdb", (q, k, v)), ("ragged", ragged)):
        out, lse = flash_attention.flash_attention_fwd(qq, kk, vv)
        want_out, want_lse = flash_attention.flash_attention_plain(qq, kk, vv)
        torch.cuda.synchronize()
        err = max(err, _attention_close(out, want_out, f"{name} out"),
                  _attention_close(lse, want_lse, f"{name} lse"))
    h, dh = attn.num_heads, attn.head_dim

    def timed(q, k, v, reps):
        """Kernel, plain and SDPA forward times and the bound at q's shape."""
        qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
        n = q.shape[0]

        def kernel():
            return flash_attention.flash_attention_fwd(q, k, v)

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh)

        with torch.no_grad():
            rec = {
                "shape": [n, t, h, dh],
                "ms": cuda_ms(kernel, reps),
                "plain_ms": cuda_ms(lambda: flash_attention.flash_attention_plain(q, k, v), 5),
                "library_ms": cuda_ms(library, reps),
                # the same calls replayed from CUDA graphs: the card's time alone
                "device_ms": graph_ms(kernel, 20),
                "library_device_ms": graph_ms(library, 20),
                # the host's time per eager call, which bounds it where the card's is less
                "host_ms": host_ms(kernel, reps),
                "library_host_ms": host_ms(library, reps),
            }
        # two products of 2*dh FLOPs per (query, key) pair; q, k, v read and out
        # written once, lse written once
        flops = 4 * n * h * t * t * dh
        nbytes = 4 * (4 * n * t * h * dh + n * h * t)
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, "3xtf32")
        return rec

    big = timed(q, k, v, 20)
    step = timed(*(x[:32].contiguous() for x in (q, k, v)), 100)
    print(f"flash_attention timed at q/k/v [{b}, {t}, {h}, {dh}] and [32, {t}, {h}, {dh}]")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "simple_tip_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "simple_tip_tpu/ops/flash_attention.py:58",
        "timed": f"one launch at one prediction batch, q/k/v [{b}, {t}, {h}, {dh}]; "
                 "library: scaled_dot_product_attention's forward",
        "max_abs_err": err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "bound_unit": UNITS["3xtf32"][1],
        "library_ms": big["library_ms"],
        "device_ms": big["device_ms"],
        "library_device_ms": big["library_device_ms"],
        "at_training_step": step,
    }


# The card-alone and host times of B5/B6 and the SDPA backward, per entry.
TIMES = ("device_ms", "host_ms", "library_device_ms", "library_host_ms", "library_graph_error")


def _bwd_close(got, want, what: str) -> tuple:
    """(max |got - want|, that over max |want|); raises unless |got - want|
    <= atol + 1e-4 |want| with atol = min(1e-5, 1e-4 max |want|), so the
    check can fail whatever the scale of the gradients."""
    scale = float(want.abs().max())
    excess = float(((got - want).abs() - 1e-4 * want.abs()).max())
    if excess > min(1e-5, 1e-4 * scale):
        raise AssertionError(f"flash backward {what}: off by {excess} beyond rtol 1e-4 "
                             f"(max |want| {scale})")
    err = float((got - want).abs().max())
    return err, err / scale


def imdb_step_tensors(net, tokens: np.ndarray, labels: np.ndarray, dev):
    """q, k, v [B, 100, 2, 32] of an IMDB forward over ``tokens`` and dO, the
    gradient of the batch's mean cross-entropy (``train=False``) with
    respect to the attention core's output, scaled to unit RMS: the
    backward is linear in dO, and the mean's dO (RMS ~1e-3) would leave dq
    and dk near 1e-5, the size of the check's atol."""
    attn = net.block.attention
    x = to_device(tokens, dev)
    emb = net.embedding(x).detach()
    b, t, _ = emb.shape
    with torch.no_grad():
        q, k, v = (p(emb).reshape(b, t, attn.num_heads, attn.head_dim).contiguous()
                   for p in (attn.query, attn.key, attn.value))
    core = flash_attention.flash_attention(q, k, v).detach().requires_grad_()
    probs, _ = net.suffix((emb, attn.out(core.reshape(b, t, -1))))
    y = F.one_hot(torch.as_tensor(labels, device=dev), probs.shape[1]).float()
    (dout,) = torch.autograd.grad(categorical_crossentropy(probs, y).mean(), core)
    return q, k, v, (dout / dout.pow(2).mean().sqrt()).contiguous()


def sdpa_backward_times(q, k, v, dout, reps: int) -> dict:
    """Times of the backward of ``scaled_dot_product_attention`` (dq, dk and
    dv together) on [B, T, H, dh] inputs: eager (CUDA events), the host's
    time per eager call, and replayed from a CUDA graph. The forward runs on
    a side stream, so that its backward runs and is captured there. A
    capture that fails is recorded in the result (it is the yardstick, not a
    check)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous().requires_grad_() for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qh, kh, vh)
        doh = dout.permute(0, 2, 1, 3).contiguous()

        def library():
            return torch.autograd.grad(sdpa, (qh, kh, vh), doh, retain_graph=True)

        rec = {"library_ms": cuda_ms(library, reps), "library_host_ms": host_ms(library, reps)}
        try:
            rec["library_device_ms"] = graph_ms(library, 20, side)
        except RuntimeError as exc:
            rec["library_device_ms"] = None
            rec["library_graph_error"] = str(exc)[:500]
    torch.cuda.current_stream().wait_stream(side)
    return rec


def _bwd_times(kernel, plain, args, reps: int) -> dict:
    """A backward kernel's eager time, its plain version's, the card's time
    alone (replayed from a CUDA graph) and the host's own time per eager
    call, on ``args``."""
    return {"ms": cuda_ms(lambda: kernel(*args), reps),
            "plain_ms": cuda_ms(lambda: plain(*args), 3),
            "device_ms": graph_ms(lambda: kernel(*args), 20),
            "host_ms": host_ms(lambda: kernel(*args), reps)}


def check_flash_backward(params, data, dev, seed: int) -> list:
    """B5 and B6 against their plain versions on a real IMDB training step
    (the batch of 32 and its dO), a ragged [4, 300, 2, 8] and dh=128
    [4, 200, 2, 128]; timed at the step and at [8192, 100, 2, 32] (eager,
    replayed from a CUDA graph, and the host's time per eager call), with
    B4 beside them (``fwd_ms``) for the training step's breakdown."""
    net = _module("imdb", params, dev)
    (x_tr, y_tr), _, _ = data
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    cases = {
        "step": imdb_step_tensors(net, x_tr[:32], y_tr[:32], dev),
        "ragged": tuple(normal(4, 300, 2, 8) for _ in range(4)),
        "dh128": tuple(normal(4, 200, 2, 128) for _ in range(4)),
        "timing": imdb_step_tensors(net, x_tr[:PREDICT_BATCH], y_tr[:PREDICT_BATCH], dev),
    }
    err = {"dq": 0.0, "dkv": 0.0}
    rel = {}  # per case and gradient: max |got - want| / max |want|
    timed = {}
    for name, (q, k, v, dout) in cases.items():
        out, lse = flash_attention.flash_attention_fwd(q, k, v)
        dvec = flash_attention.attention_delta(out, dout)
        args = (q, k, v, dout, lse, dvec)
        dq = flash_attention.flash_bwd_dq(*args)
        dk, dv = flash_attention.flash_bwd_dkv(*args)
        want_dk, want_dv = flash_attention.flash_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        close = {"dq": _bwd_close(dq, flash_attention.flash_bwd_dq_plain(*args), f"{name} dq"),
                 "dk": _bwd_close(dk, want_dk, f"{name} dk"),
                 "dv": _bwd_close(dv, want_dv, f"{name} dv")}
        rel[name] = {g: r for g, (_, r) in close.items()}
        err["dq"] = max(err["dq"], close["dq"][0])
        err["dkv"] = max(err["dkv"], close["dk"][0], close["dv"][0])
        if name not in ("step", "timing"):
            continue
        reps = 20 if name == "step" else 5
        library = sdpa_backward_times(q, k, v, dout, reps)
        b, t, h, dh = q.shape
        pairs = b * h * t * t * dh  # one product is 2 * pairs FLOPs
        io = 4 * b * t * h * dh  # bytes of one [B, T, H, dh] array
        rows = 4 * 2 * b * h * t  # lse and D
        timed[name] = {
            "shape": [b, t, h, dh],
            "fwd_ms": cuda_ms(lambda: flash_attention.flash_attention_fwd(q, k, v), reps),
            "dq": {**_bwd_times(flash_attention.flash_bwd_dq, flash_attention.flash_bwd_dq_plain,
                                args, reps),
                   "bound": bound_ms(3 * 2 * pairs, 5 * io + rows, "3xtf32"), **library},
            "dkv": {**_bwd_times(flash_attention.flash_bwd_dkv,
                                 flash_attention.flash_bwd_dkv_plain, args, reps),
                    "bound": bound_ms(4 * 2 * pairs, 6 * io + rows, "3xtf32"), **library},
        }
    print(json.dumps({"flash_backward_relative_err": rel}))
    print(json.dumps({"flash_backward_timed": timed}))
    entries = []
    for key, name, line in (("dq", "flash_attention_bwd_dq", 174),
                            ("dkv", "flash_attention_bwd_dkv", 203)):
        step, big = timed["step"][key], timed["timing"][key]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "simple_tip_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"simple_tip_tpu/ops/flash_attention.py:{line}",
            "timed": "one launch at an IMDB training step, q/k/v/dO [32, 100, 2, 32]; "
                     "library: the backward of scaled_dot_product_attention (dq, dk, dv)",
            "max_abs_err": err[key],
            "ms": step["ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": step["bound"][0],
            "bound_by": step["bound"][1],
            "bound_unit": UNITS["3xtf32"][1],
            "library_ms": step["library_ms"],
            **{t: step[t] for t in TIMES if t in step},
            "at_8192": {"ms": big["ms"], "plain_ms": big["plain_ms"],
                        "bound_ms": big["bound"][0], "bound_by": big["bound"][1],
                        "library_ms": big["library_ms"],
                        **{t: big[t] for t in TIMES if t in big}},
        })
    return entries


WIDE_SHAPE = (64, 128, 2, 256)  # [B, T, H, dh]: past the narrow kernels' dh <= 128


def check_wide_heads(dev, seed: int) -> dict:
    """B4, B5 and B6 at head_dim 256, where they take their wide-head
    variants, against their plain versions on seeded q, k, v and dO: out and
    lse with the forward's check, dq, dk and dv with the backward's. Timed
    (eager, replayed from a CUDA graph, plain) beside the SDPA forward and
    backward on the same inputs."""
    rng = np.random.default_rng(seed + 1)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=WIDE_SHAPE).astype(np.float32)).to(dev)
                     for _ in range(4))
    fa = flash_attention
    out, lse = fa.flash_attention_fwd(q, k, v)
    want_out, want_lse = fa.flash_attention_plain(q, k, v)
    args = (q, k, v, dout, lse, fa.attention_delta(out, dout))
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    err = {"out": _attention_close(out, want_out, "wide-head out"),
           "lse": _attention_close(lse, want_lse, "wide-head lse"),
           "dq": _bwd_close(dq, fa.flash_bwd_dq_plain(*args), "wide-head dq")[0],
           "dk": _bwd_close(dk, want_dk, "wide-head dk")[0],
           "dv": _bwd_close(dv, want_dv, "wide-head dv")[0]}
    b, t, h, dh = WIDE_SHAPE
    pairs = b * h * t * t * dh  # one product is 2 * pairs FLOPs
    io = 4 * b * t * h * dh  # bytes of one [B, T, H, dh] array
    rows = 4 * 2 * b * h * t  # lse and D
    qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))

    def forward():
        return fa.flash_attention_fwd(q, k, v)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh)

    with torch.no_grad():
        fwd = {"ms": cuda_ms(forward, 20), "device_ms": graph_ms(forward, 20),
               "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3),
               "library_ms": cuda_ms(sdpa, 20),
               "bound": bound_ms(2 * 2 * pairs, 4 * io + 4 * b * h * t, "3xtf32")}
    library = sdpa_backward_times(q, k, v, dout, 20)
    record = {
        "shape": list(WIDE_SHAPE),
        "max_abs_err": err,
        "fwd": fwd,
        "dq": {**_bwd_times(fa.flash_bwd_dq, fa.flash_bwd_dq_plain, args, 20),
               "bound": bound_ms(3 * 2 * pairs, 5 * io + rows, "3xtf32"), **library},
        "dkv": {**_bwd_times(fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, args, 20),
                "bound": bound_ms(4 * 2 * pairs, 6 * io + rows, "3xtf32"), **library},
    }
    print(json.dumps({"wide_heads": record}))
    return record


def check_imdb_gradients(params, data, dev) -> dict:
    """Every parameter gradient of one full-width IMDB batch of 32 (loss
    with ``train=False``) through ``FlashAttention``, on the card and on
    the CPU, within rtol 2e-4 / atol 2e-5; the q/k/v kernels' gradients
    must be non-zero. The q and k kernels' gradients are ~1e-5, so each
    leaf's atol is cut to 2e-4 of its largest |gradient| plus 1e-7 of the
    model's largest, the f32 rounding floor that holds the key bias (its
    true gradient is 0: softmax ignores a shift shared by a query's keys)."""
    (x_tr, y_tr), _, _ = data
    grads = []
    for device in (dev, torch.device("cpu")):
        net = _module("imdb", params, device)
        probs, _ = net(to_device(x_tr[:32], device))
        y = F.one_hot(torch.as_tensor(y_tr[:32], device=device), 2).float()
        loss = categorical_crossentropy(probs, y).mean()
        names, tensors = zip(*net.named_parameters())
        grads.append(dict(zip(names, torch.autograd.grad(loss, tensors))))
    card, cpu = grads
    faults, worst = gradient_faults(card, cpu, "IMDB")
    if faults:
        raise AssertionError("card vs CPU: " + "; ".join(faults))
    floor = 1e-7 * max(float(g.abs().max()) for g in cpu.values())
    relative = {name: float((card[name].cpu() - want).abs().max()) / max(float(want.abs().max()),
                                                                          floor)
                for name, want in cpu.items() if name.startswith("block.attention.")}
    norms = {p: float(card[f"block.attention.{p}.weight"].norm())
             for p in ("query", "key", "value")}
    if not all(n > 0 for n in norms.values()):
        raise AssertionError(f"IMDB q/k/v kernel gradients vanish on the card: {norms}")
    record = {"imdb_gradients_card_vs_cpu_max_abs": worst, "qkv_kernel_grad_norms": norms,
              "attention_relative_err": relative}
    print(json.dumps(record))
    return record


def expected_artifacts(family: str, n: int, sa_names=SA_NAMES):
    """{file suffix: (dtype, shape)} the JAX package writes per dataset."""
    neurons = PATHS[family]["neurons"]

    def score_dtype(bits):  # sum_score's smallest integer type for the max
        return np.dtype(np.int16 if bits <= np.iinfo(np.int16).max else np.int32)

    out = {"is_misclassified": (np.dtype(bool), (n,))}
    for u in UNCERTAINTIES:
        out[f"uncertainty_{u}"] = (np.dtype(np.float32), (n,))
    if PATHS[family]["model"].has_dropout:
        out["uncertainty_VR"] = (np.dtype(np.float64), (n,))
    for m in NC_METRICS:
        bits = neurons * (2 if m[:3] in ("NBC", "KMN") else 1)
        out[f"{m}_scores"] = (score_dtype(bits), (n,))
        out[f"{m}_cam_order"] = (np.dtype(np.int64), (n,))
    for name in sa_names:
        out[f"{name}_scores"] = (np.dtype(np.float64), (n,))
        out[f"{name}_cam_order"] = (np.dtype(np.int64), (n,))
    return out


def read_artifacts(family: str, rows: dict, sa_names=SA_NAMES):
    """Load and check every artifact and time record of model 0 (``rows``
    per dataset): SA scores hold no NaN, and only dsa's and pc-lsa's may
    hold +inf (no other-class row; a KDE density that underflows).

    Returns ``({(ds, suffix): array}, {ds: {metric: [setup, pred, quant, cam]}})``.
    """
    found, records = {}, {}
    metrics = [*UNCERTAINTIES, *NC_METRICS, *sa_names]
    if PATHS[family]["model"].has_dropout:
        metrics.append("VR")
    for ds in ("nominal", "ood"):
        n = rows[ds]
        expected = expected_artifacts(family, n, sa_names)
        for suffix, (dtype, shape) in expected.items():
            path = os.path.join(subdir("priorities"), f"{family}_{ds}_0_{suffix}.npy")
            a = np.load(path)
            if a.dtype != dtype or a.shape != shape:
                raise AssertionError(f"{path}: {a.dtype}{a.shape}, want {dtype}{shape}")
            if suffix.endswith("cam_order") and not np.array_equal(np.sort(a), np.arange(n)):
                raise AssertionError(f"{path} is not a permutation")
            if a.dtype.kind == "f" and np.isnan(a).any():
                raise AssertionError(f"{path} has NaN values")
            if (a.dtype.kind == "f" and not suffix.startswith(("dsa", "pc-lsa"))
                    and not np.isfinite(a).all()):
                raise AssertionError(f"{path} has non-finite values")
            found[(ds, suffix)] = a
        extra = {p for p in os.listdir(subdir("priorities")) if p.startswith(f"{family}_")} - {
            f"{family}_{d}_0_{s}.npy" for d in ("nominal", "ood")
            for s in expected
        }
        if extra:
            raise AssertionError(f"{family}: unexpected artifacts {sorted(extra)}")
        records[ds] = {}
        for metric in metrics:
            path = os.path.join(subdir("times"), f"{family}_{ds}_0_{metric}")
            with open(path, "rb") as f:
                rec = [float(v) for v in pickle.load(f)]
            if len(rec) != 4:
                raise AssertionError(f"{path}: time record {rec} is not [setup, pred, quant, cam]")
            records[ds][metric] = rec
    return found, records


def run_slice(family: str, params, data, dev, root: str, sa_names=SA_NAMES):
    """evaluate() into ``root`` with the SA variants ``sa_names``; returns
    (phase seconds, artifacts, time records, {variant: chosen k})."""
    cfg = PATHS[family]
    (x_tr, _), (x_nom, y_nom), (x_ood, y_ood) = data
    os.environ["TIP_ASSETS"] = root
    phases, chosen_k = eval_prioritization.evaluate(
        model_id=0, case_study=family, model_def=cfg["model"](), params=params,
        training_dataset=x_tr, nominal_test_dataset=x_nom, nominal_test_labels=y_nom,
        ood_test_dataset=x_ood, ood_test_labels=y_ood,
        nc_activation_layers=cfg["nc"], sa_activation_layers=cfg["sa"],
        dsa_badge_size=cfg["dsa_badge"], batch_size=cfg["batch"], device=dev, sa_names=sa_names,
    )
    rows = {"nominal": x_nom.shape[0], "ood": x_ood.shape[0]}
    return (phases, *read_artifacts(family, rows, sa_names), chosen_k)


def compare_small(family: str, card: dict, cpu: dict) -> dict:
    """Card against CPU (plain versions) on the small subset. DSA scores
    apart by more than rtol 1e-4 are returned per dataset under
    ``dsa_rows_apart`` for ``dsa_ties`` to hold."""
    report = {"dsa_rows_apart": {}}
    for (ds, suffix), a in card.items():
        b = cpu[(ds, suffix)]
        if suffix == "is_misclassified":
            if not np.array_equal(a, b):
                raise AssertionError(f"{family} {ds} predictions differ between card and CPU")
        elif suffix.startswith("uncertainty_") and suffix != "uncertainty_VR":
            err = np.abs(a - b)
            if err.max() > 1e-5:
                row = int(err.argmax())
                raise AssertionError(f"{family} {ds} {suffix}: card vs CPU {float(err.max())} > "
                                     f"1e-5 (row {row}: {a[row]} / {b[row]}; "
                                     f"{int((err > 1e-5).sum())} rows)")
        elif suffix == "dsa_scores":
            fin = np.isfinite(b)
            if not np.array_equal(fin, np.isfinite(a)):
                raise AssertionError(f"{family} {ds} dsa: non-finite entries differ")
            rel = np.where(fin, np.abs(a - b) / np.abs(b).clip(1e-30), 0.0)
            report["dsa_rows_apart"][ds] = np.flatnonzero(rel > 1e-4).tolist()
        elif suffix.endswith("_scores"):
            # cuDNN (or the attention kernel) and the CPU sum in other
            # orders; an activation within float32 rounding of a threshold
            # can flip one coverage bit, and with it a score by 1.
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            report[f"{ds}_{suffix}_rows_differing"] = int((diff > 0).sum())
            if diff.max() > 2 or (diff > 0).mean() > 0.01:
                raise AssertionError(f"{family} {ds} {suffix}: card vs CPU {int(diff.max())} apart")
    return report


def _dsa_first_search(family: str, params, small, ds: str, device):
    """DSA's first search as ``evaluate`` runs it (the surprise handler's
    traces of the whole dataset ``ds`` of the small subset, batches of
    1,024, a 30% subsample): (the nearest same-class row of each query, the
    centred queries, the centred training rows), the last two on the CPU
    in float64."""
    cfg = PATHS[family]
    model = BaseModel(cfg["model"](), params, cfg["sa"], include_last_layer=True,
                      batch_size=1024, device=device)
    x = (small[1] if ds == "nominal" else small[2])[0]
    train, test = model.get_activations(small[0][0]), model.get_activations(x)

    def flat(outs):
        return torch.cat([t.reshape(t.shape[0], -1) for t in outs[:-1]], dim=1)

    dsa = SA_VARIANTS["dsa"](VariantFitter(SharedTrainPrep(
        flat(train), train[-1].argmax(1).cpu().numpy(), device), device, cfg["dsa_badge"]))
    labels = test[-1].argmax(1).to(torch.int32)
    queries = dsa.traces([flat(test)])
    _, idx = dsa.nearest(queries, labels, True)
    return idx.cpu().numpy(), queries.cpu().double(), dsa.rows.cpu().double()


def first_search_tie(card: dict, cpu: dict, picks: tuple) -> bool:
    """Whether card and CPU picking other rows ``picks`` = (card's, CPU's)
    for one query is a tie: each side's pick is the nearer of the two on
    its own traces (exact distances ``{row: distance}``, within rtol 1e-4,
    the float32 expansion's rounding), so the two traces order them
    differently, and neither distance moves between the sides by more
    than 1e-3 of it (traces that far apart are a fault, not a tie)."""
    a, b = picks
    if a == b:
        return False
    scale = max(card[a], card[b], cpu[a], cpu[b])
    moved = max(abs(card[a] - cpu[a]), abs(card[b] - cpu[b]))
    return (card[a] <= card[b] + 1e-4 * scale and cpu[b] <= cpu[a] + 1e-4 * scale
            and moved <= 1e-3 * scale)


def dsa_ties(family: str, params, small, dev, rows_apart: dict) -> dict:
    """Hold the small subset's DSA rows that card and CPU score apart: each
    must be a tie of the first search (the same-class row nearest to the
    query; ``first_search_tie``). The card's traces and the CPU's differ in
    rounding (cuDNN, the kernels, the CPU's sums), which moves nearest
    distances of ~0.1-1 by ~1e-5 relative; two rows that close can swap,
    and the ratio's denominator (the swapped row's distance to the nearest
    other-class row) then changes. Returns the tied rows per dataset."""
    ties = {}
    for ds, rows in rows_apart.items():
        if not rows:
            continue
        sides = {name: _dsa_first_search(family, params, small, ds, device)
                 for name, device in (("card", dev), ("cpu", torch.device("cpu")))}
        for row in rows:
            picks = (int(sides["card"][0][row]), int(sides["cpu"][0][row]))
            dist = {name: {r: float((q[row] - train[r]).norm()) for r in picks}
                    for name, (_, q, train) in sides.items()}
            if not first_search_tie(dist["card"], dist["cpu"], picks):
                raise AssertionError(f"{family} {ds} dsa row {row}: card and CPU scores apart "
                                     f"by more than rtol 1e-4 without a first-search tie "
                                     f"(nearest rows {picks}, distances {dist})")
            ties.setdefault(ds, []).append({"row": row, "rows": list(picks),
                                            "distances": dist})
    return ties


def apfd_report(art: dict) -> dict:
    apfd = {}
    for ds in ("nominal", "ood"):
        faults = art[(ds, "is_misclassified")]
        apfd[f"{ds}_deep_gini"] = apfd_from_order(
            faults, np.argsort(-art[(ds, "uncertainty_deep_gini")], kind="stable"))
        apfd[f"{ds}_dsa"] = apfd_from_order(faults, art[(ds, "dsa_cam_order")])
        apfd[f"{ds}_NAC_0.75"] = apfd_from_order(faults, art[(ds, "NAC_0.75_cam_order")])
    return apfd


def sa_report(art: dict, records: dict, chosen_k: dict) -> dict:
    """Per SA variant: setup and score seconds on both datasets, the +inf
    count of its scores; pc-mmdsa's chosen k."""
    report = {"chosen_k": chosen_k, "variants": {}}
    for name in SA_NAMES:
        rec = {"setup_s": records["nominal"][name][0]}
        for ds in ("nominal", "ood"):
            rec[f"{ds}_score_s"] = records[ds][name][2]
            rec[f"{ds}_cam_s"] = records[ds][name][3]
            rec[f"{ds}_inf"] = int(np.isinf(art[(ds, f"{name}_scores")]).sum())
        report["variants"][name] = rec
    return report


def apfd_table_row(family: str, root: str) -> dict:
    """The family's APFD table (``plotters/eval_apfd_table``) over the path's
    artifacts: {approach: [nominal, ood, time]}; every approach must have
    both APFDs (VR only where the model has dropout)."""
    os.environ["TIP_ASSETS"] = root
    table = eval_apfd_table.apfd_table([family])
    eval_apfd_table.add_reported_times(table, times_collector.load_times())
    row = {approach: [cells[family, c] for c in eval_apfd_table.COLUMNS]
           for (_, approach), cells in table.items()}
    for approach, (nominal, ood, _) in row.items():
        if approach == "VR" and not PATHS[family]["model"].has_dropout:
            continue
        if not (isinstance(nominal, float) and isinstance(ood, float)):
            raise AssertionError(f"{family}: APFD table has no {approach}: {nominal}, {ood}")
    return row


def _fit_and_score(name: str, train_ats, train_pred, test_ats, test_pred, device):
    """``name``'s registry scorer fitted on the training traces on
    ``device``, its scores of the test traces, and the fit and score seconds."""
    t0 = time.perf_counter()
    prep = SharedTrainPrep(train_ats.to(device), train_pred, device)
    scorer = SA_VARIANTS[name](VariantFitter(prep, device))
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = scorer(test_ats.to(device), test_pred)
    return scorer, scores, fit_s, time.perf_counter() - t0


def _lsa_log_densities(scorer, test_ats, test_pred, device) -> np.ndarray:
    """pc-lsa's per-class KDE log densities of the test traces before the
    exp (NaN for a class whose features were all dropped)."""
    out = np.full(test_ats.shape[0], np.nan)
    for c in np.unique(test_pred):
        lsa = scorer.modal_sa[int(c)]
        if lsa.kde is not None:
            rows = np.flatnonzero(test_pred == c)
            out[rows] = lsa.log_density(test_ats[rows].to(device)).cpu().numpy()
    return out


def _rel_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest relative gap of ``a`` to ``b`` over ``b``'s finite entries."""
    fin = np.isfinite(b)
    return float((np.abs(a[fin] - b[fin]) / np.abs(b[fin]).clip(1e-30)).max(initial=0.0))


def _mlsa_rungs(scorer):
    return [(m.gmm.n_components, m.gmm.reg_covar) for m in scorer.modal_sa.values()]


def _sa_side(picks: dict, train_ats, train_pred, test_ats, test_pred, device) -> dict:
    """The four SA variants of ``NEW_SA`` fitted and scored on ``device`` on
    ``picks``' rows and features: per variant (scores, chosen k, MLSA
    ``reg_covar`` rungs, fit seconds, score seconds, pc-lsa's log densities)."""
    out = {}
    for name in NEW_SA:
        tr, te, cols = picks[name]
        scorer, scores, fit_s, score_s = _fit_and_score(
            name, train_ats[tr][:, cols], train_pred[tr], test_ats[te][:, cols],
            test_pred[te], device)
        k = getattr(scorer.discriminator, "best_k", None)
        rungs = [m.gmm.reg_covar for m in scorer.modal_sa.values() if hasattr(m, "gmm")]
        log_density = (_lsa_log_densities(scorer, test_ats, test_pred, device)
                       if name == "pc-lsa" else None)
        out[name] = (scores, k, rungs, fit_s, score_s, log_density)
    return out


def compare_sa_small(family: str, params, data, dev, folder: str) -> "SaSmall":
    """The four SA variants fitted and scored on the card and on the CPU
    from the same traces (``SA_CHECK``; pc-mlsa on one class and its
    features of highest variance where it says so): the card side here,
    the CPU side in a child process (``CpuReference``, files in ``folder``)
    started first. On the convnets pc-mlsa is also fitted at full width
    (``MlsaFullWidth``, its CPU side in a child process too). Returns the
    pending comparison, whose ``finish()`` gates it."""
    cfg = PATHS[family]
    n_train, n_test, mlsa_cut = SA_CHECK[family]
    (x_tr, _), (x_nom, y_nom), _ = data
    model = BaseModel(cfg["model"](), params, cfg["sa"], include_last_layer=True,
                      batch_size=1024, device=dev)
    train, test = model.get_activations(x_tr[:n_train]), model.get_activations(x_nom[:n_test])

    def rows(outs):
        return torch.cat([t.reshape(t.shape[0], -1) for t in outs[:-1]], dim=1).cpu()

    train_ats, train_pred = rows(train), train[-1].argmax(1).cpu().numpy()
    test_ats, test_pred = rows(test), test[-1].argmax(1).cpu().numpy()
    picks = {name: (slice(None), slice(None), slice(None)) for name in NEW_SA}
    if mlsa_cut is not None:
        cls = int(np.bincount(test_pred).argmax())
        tr = np.flatnonzero(train_pred == cls)[: mlsa_cut[0]]
        top = np.sort(np.argsort(train_ats[tr].var(dim=0).numpy())[-mlsa_cut[1]:])
        picks["pc-mlsa"] = (tr, np.flatnonzero(test_pred == cls), top)
    cpu = CpuReference(os.path.join(folder, f"sa_small_{family}"), "sa_small", picks=picks,
                       train_ats=train_ats, train_pred=train_pred, test_ats=test_ats,
                       test_pred=test_pred)
    card = _sa_side(picks, train_ats, train_pred, test_ats, test_pred, dev)
    full_width = None
    if mlsa_cut is not None:
        full_width = MlsaFullWidth(family, model, train_ats, train_pred, x_nom, y_nom, dev,
                                   folder)
    return SaSmall(family, picks, train_ats, train_pred, card, cpu, full_width)


class SaSmall:
    """``compare_sa_small``'s comparison, pending its CPU sides."""

    def __init__(self, family, picks, train_ats, train_pred, card, cpu, full_width):
        self.family, self.picks, self.card, self.cpu = family, picks, card, cpu
        self.full_width = full_width
        self.rows = {name: int(np.size(train_pred[picks[name][0]])) for name in NEW_SA}
        self.features = {name: int(train_ats[:1, picks[name][2]].shape[1]) for name in NEW_SA}

    def finish(self) -> dict:
        """Gate the two sides: the same chosen k and MLSA ``reg_covar`` rungs,
        the same +inf rows, finite scores (and pc-lsa's log densities) within
        ``SA_RTOL``, SC-CAM orders equal in all but ``SA_ORDER_CAP`` of their
        positions; then the full-width read. Returns the errors and times
        per variant."""
        cpu, waited_s = self.cpu.result()
        report, breaches = {"cpu_waited_s": waited_s}, []
        for name in NEW_SA:
            a, k_card, rungs_card, fit_card, score_card, log_card = self.card[name]
            b, k_cpu, rungs_cpu, fit_cpu, score_cpu, log_cpu = cpu[name]
            rel = _rel_gap(a, b)
            moved = int((_sc_cam_order(a) != _sc_cam_order(b)).sum())
            if k_card != k_cpu or rungs_card != rungs_cpu:
                breaches.append(f"{name}: card k={k_card}, rungs {rungs_card}; "
                                f"CPU k={k_cpu}, rungs {rungs_cpu}")
            if not np.array_equal(np.isinf(a), np.isinf(b)) or np.isnan(a).any() or \
                    np.isnan(b).any():
                breaches.append(f"{name}: non-finite rows differ")
            if rel > SA_RTOL:
                breaches.append(f"{name}: rtol {rel} > {SA_RTOL}")
            if moved > SA_ORDER_CAP * a.shape[0]:
                breaches.append(f"{name}: {moved} of {a.shape[0]} SC-CAM positions differ")
            report[name] = {"rows": [self.rows[name], int(a.shape[0])],
                            "features": self.features[name],
                            "max_rel_err": rel, "cam_positions_moved": moved,
                            "chosen_k": k_card, "reg_covar": rungs_card,
                            "inf": int(np.isinf(a).sum()),
                            "card_fit_s": fit_card, "card_score_s": score_card,
                            "cpu_fit_s": fit_cpu, "cpu_score_s": score_cpu}
            if log_card is not None:
                log_rel = _rel_gap(log_card, log_cpu)
                report[name]["log_density"] = {
                    "finite": int(np.isfinite(log_cpu).sum()), "max_rel_err": log_rel}
                if not all(np.array_equal(f(log_card), f(log_cpu)) for f in (np.isnan, np.isinf)):
                    breaches.append(f"{name}: non-finite log densities differ")
                if log_rel > SA_RTOL:
                    breaches.append(f"{name}: log densities rtol {log_rel} > {SA_RTOL}")
        print(json.dumps({"path": self.family, "sa_card_vs_cpu": report}))
        if breaches:
            raise AssertionError(f"{self.family} SA card vs CPU: " + "; ".join(breaches))
        if self.full_width is not None:
            report["mlsa_full_width"] = self.full_width.finish()
        return report


#: Child processes started by this command, stopped when it ends.
CHILDREN = []


class MlsaFullWidth:
    """pc-mlsa at the tap's full width on the card and on the CPU: fitted on
    every training row of ``SA_CHECK``'s set predicted as the nominal set's
    most predicted class, scored on every nominal row predicted as it. The
    card side runs here; the CPU side in a child process (``CpuReference``,
    ``MLSA_CPU_THREADS`` threads) on the same traces, started at once.
    ``finish()`` waits for it and gates finite scores and the APFD of each
    side's SC-CAM order (faults: misclassified rows) within
    ``MLSA_APFD_GAP``; it reads each side's components and ``reg_covar``
    rung, the score gap and the SC-CAM positions moved."""

    def __init__(self, family: str, model, train_ats, train_pred, x_nom, y_nom, dev,
                 folder: str):
        self.family = family
        test = model.get_activations(x_nom)
        test_pred = test[-1].argmax(1).cpu().numpy()
        self.cls = int(np.bincount(test_pred).argmax())
        te = np.flatnonzero(test_pred == self.cls)
        test_ats = torch.cat([t.reshape(t.shape[0], -1) for t in test[:-1]], dim=1)[
            torch.from_numpy(te).to(dev)].cpu()
        del test
        tr = np.flatnonzero(train_pred == self.cls)
        self.rows, self.features = [int(tr.size), int(te.size)], int(train_ats.shape[1])
        self.faults = test_pred[te] != np.asarray(y_nom)[te]
        self.cpu = CpuReference(os.path.join(folder, f"mlsa_cpu_{family}"), "mlsa_full_width",
                                threads=MLSA_CPU_THREADS, train_ats=train_ats[tr],
                                train_pred=train_pred[tr], test_ats=test_ats,
                                test_pred=test_pred[te])
        self.proc = self.cpu.proc
        scorer, scores, fit_s, score_s = _fit_and_score(
            "pc-mlsa", train_ats[tr], train_pred[tr], test_ats, test_pred[te], dev)
        self.card = (scores, _mlsa_rungs(scorer), fit_s, score_s)

    def finish(self) -> dict:
        try:
            cpu, waited_s = self.cpu.result()
        except AssertionError as e:
            raise AssertionError(f"pc-mlsa CPU fit, {self.family}: {e}") from None
        (a, rungs_card, fit_card, score_card), (b, rungs_cpu, fit_cpu, score_cpu) = self.card, cpu
        breaches = []
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            breaches.append("non-finite scores")
        order_card, order_cpu = _sc_cam_order(a), _sc_cam_order(b)
        apfd_card = apfd_from_order(self.faults, order_card)
        apfd_cpu = apfd_from_order(self.faults, order_cpu)
        if not abs(apfd_card - apfd_cpu) <= MLSA_APFD_GAP:
            breaches.append(f"APFD {apfd_card} on the card, {apfd_cpu} on the CPU, more "
                            f"than {MLSA_APFD_GAP} apart")
        report = {"class": self.cls, "rows": self.rows, "features": self.features,
                  "faults": int(self.faults.sum()),
                  "components_reg_covar": {"card": rungs_card, "cpu": rungs_cpu},
                  "max_rel_err": _rel_gap(a, b),
                  "cam_positions_moved": int((order_card != order_cpu).sum()),
                  "selection_moved": mlsa_selection_moved(a, b, order_card, order_cpu),
                  "apfd_card": apfd_card, "apfd_cpu": apfd_cpu,
                  "card_fit_s": fit_card, "card_score_s": score_card,
                  "cpu_fit_s": fit_cpu, "cpu_score_s": score_cpu,
                  "cpu_waited_s": waited_s}
        print(json.dumps({"path": self.family, "mlsa_full_width": report}))
        if breaches:
            raise AssertionError(f"{self.family} pc-mlsa at full width: " + "; ".join(breaches))
        return report


def wait_children() -> float:
    """Wait until no child process started so far runs (each within
    ``CPU_REF_TIMEOUT_S``; their results are read later); the seconds
    waited."""
    t0 = time.perf_counter()
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.wait(timeout=CPU_REF_TIMEOUT_S)
    return time.perf_counter() - t0


class CpuReference:
    """The CPU side of a card-against-CPU check, computed in a child process
    (``--cpu-ref PATH`` on ``threads`` threads) beside the card phases:
    ``kind`` and its keyword inputs pickled to ``PATH.in.pkl``, its output to
    ``PATH.out.pkl``, its log to ``PATH.log``; ``result()`` waits for it and
    returns (the output, the seconds waited)."""

    def __init__(self, path: str, kind: str, threads: int = CPU_REF_THREADS, **inputs):
        self.path, self.kind = path, kind
        with open(path + ".in.pkl", "wb") as f:
            pickle.dump((kind, threads, inputs), f, protocol=4)
        self.log = open(path + ".log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-ref", path],
            env=dict(os.environ, OMP_WAIT_POLICY="PASSIVE"), stdout=self.log,
            stderr=subprocess.STDOUT)
        CHILDREN.append(self.proc)

    def result(self) -> tuple:
        t0 = time.perf_counter()
        code = self.proc.wait(timeout=CPU_REF_TIMEOUT_S)
        self.log.close()
        if code != 0:
            with open(self.path + ".log") as f:
                raise AssertionError(f"CPU reference {self.kind} exited {code}:\n"
                                     f"{f.read()[-4000:]}")
        with open(self.path + ".out.pkl", "rb") as f:
            return pickle.load(f), time.perf_counter() - t0


def _sa_small_cpu(picks, train_ats, train_pred, test_ats, test_pred):
    return _sa_side(picks, train_ats, train_pred, test_ats, test_pred, torch.device("cpu"))


def _mlsa_full_width_cpu(train_ats, train_pred, test_ats, test_pred):
    scorer, scores, fit_s, score_s = _fit_and_score(
        "pc-mlsa", train_ats, train_pred, test_ats, test_pred, torch.device("cpu"))
    return scores, _mlsa_rungs(scorer), fit_s, score_s


def _al_selections_cpu(tree, datasets, x_train, k):
    with caches_off():
        return al_selections(params_from_jax(tree), datasets, x_train, k, torch.device("cpu"))


def cpu_ref_main(path: str) -> int:
    """The child's side of ``CpuReference``, at a lower scheduling priority
    than the card phases beside it (whose host work launches the kernels)."""
    os.nice(CPU_REF_NICE)
    with open(path + ".in.pkl", "rb") as f:
        kind, threads, inputs = pickle.load(f)
    torch.set_num_threads(threads)
    out = {"sa_small": _sa_small_cpu, "mlsa_full_width": _mlsa_full_width_cpu,
           "al_selections": _al_selections_cpu}[kind](**inputs)
    with open(path + ".out.pkl", "wb") as f:
        pickle.dump(out, f, protocol=4)
    return 0


def moved_rows(card, cpu) -> int:
    """Rows that one selection holds and the other does not."""
    return len(set(np.asarray(card).tolist()) - set(np.asarray(cpu).tolist()))


def mlsa_selection_moved(card, cpu, order_card, order_cpu) -> dict:
    """pc-mlsa's known card/CPU gap as active learning sees it: the rows
    moved in its top-k and its SC-CAM first-k at k = 20% of the rows (the
    AL phase selects 1,000 of 5,000 observed rows)."""
    k = max(1, card.shape[0] // 5)
    return {"k": k, "top_k": moved_rows(np.argsort(card)[-k:], np.argsort(cpu)[-k:]),
            "sc_cam_first_k": moved_rows(order_card[:k], order_cpu[:k])}


def path_cut(family: str, data_dir: str, root: str) -> str:
    """The data directory of ``family``'s ``PATH_CUTS`` cut under ``root``:
    its archive's first training and nominal rows (no corruption cache: the
    loader makes it), written on the first call."""
    folder = os.path.join(root, f"{family}_cut")
    if not os.path.isdir(folder):
        os.makedirs(folder)
        n_train, n_test = PATH_CUTS[family]
        with np.load(os.path.join(data_dir, f"{family}.npz")) as full:
            np.savez(os.path.join(folder, f"{family}.npz"), x_train=full["x_train"][:n_train],
                     y_train=full["y_train"][:n_train], x_test=full["x_test"][:n_test],
                     y_test=full["y_test"][:n_test])
    return folder


def run_path(family: str, params, data, dev, root: str) -> dict:
    """The path at full size (CIFAR-10's on its ``PATH_CUTS`` cut) through
    ``cli.main --phase test_prio`` on the
    registry's study (run 0's checkpoint in ``root``/train) with the
    counters read around it, its SA variants' times and APFD table, then
    the small card-against-CPU comparisons (the slice with DSA, then the
    four other SA variants)."""
    path_root = os.path.join(root, "train")
    os.environ["TIP_ASSETS"] = path_root
    env, rows = {}, {"nominal": len(data[1][1]), "ood": len(data[2][1])}
    sizes = PATHS[family]["sizes"]
    if family in PATH_CUTS:
        env["TIP_DATA_DIR"] = path_cut(family, os.environ["TIP_DATA_DIR"], root)
        n_train, n_test = PATH_CUTS[family]
        rows, sizes = {"nominal": n_test, "ood": 2 * n_test}, (n_train, n_test, 2 * n_test)
    clear_loaders()
    with patched_env(env):
        zero_counters()
        t0 = time.perf_counter()
        with CacheRecorder() as recorder:
            [(phases, chosen_k)] = run_cli("--phase", "test_prio", "--case-study", family,
                                           "--runs", "0", *device_args(dev)).values()
        seconds = time.perf_counter() - t0
    clear_loaders()
    launches = read_counters()
    caches = check_cache_entries(family, recorder)
    art, records = read_artifacts(family, rows)
    for name in PATHS[family]["kernels"]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {family} path")
    apfd = apfd_report(art)
    sa = sa_report(art, records, chosen_k)
    print(json.dumps({"path": family, "sizes": sizes, "slice_s": seconds,
                      "phases_s": phases, "launches": launches, "apfd": apfd}))
    print(json.dumps({"path": family, "time_records": records}))
    print(json.dumps({"path": family, "sa": sa}))
    print(json.dumps({"path": family, "caches": caches}))
    table = apfd_table_row(family, path_root)
    print(json.dumps({"path": family, "apfd_table": table}))
    small = (
        (data[0][0][:SMALL_TRAIN], data[0][1][:SMALL_TRAIN]),
        (data[1][0][:SMALL_TEST], data[1][1][:SMALL_TEST]),
        (data[2][0][:SMALL_TEST], data[2][1][:SMALL_TEST]),
    )
    _, card_art, _, _ = run_slice(family, params, small, dev,
                                  os.path.join(root, f"{family}_card"), ("dsa",))
    _, cpu_art, _, _ = run_slice(family, params, small, torch.device("cpu"),
                                 os.path.join(root, f"{family}_cpu"), ("dsa",))
    small_report = compare_small(family, card_art, cpu_art)
    small_report["dsa_ties"] = dsa_ties(family, params, small, dev,
                                        small_report.pop("dsa_rows_apart"))
    flips = {k: v for k, v in small_report.items() if v}
    print(json.dumps({"path": family, "small_card_vs_cpu_flips": flips}))
    sa_small = compare_sa_small(family, params, data, dev, root)
    return {"sizes": sizes,
            "slice_s": seconds, "phases_s": phases,
            "launches": launches, "apfd": apfd, "time_records": records, "sa": sa,
            "caches": caches, "apfd_table": table, "small": small_report, "sa_small": sa_small}


class CacheRecorder:
    """For the span of a ``with``: each store of the two caches (its entry's
    bytes and seconds), each fingerprint hashed (its seconds), and the
    cache outcomes of every ``SurpriseHandler.evaluate_all`` and
    ``CoverageWorker`` made inside it."""

    def __enter__(self):
        self.sa_stores, self.cov_stores, self.hashes = {}, [], []
        self.sa_outcomes, self.cov_outcomes = [], []
        self._saved = []

        def wrap(owner, name, make):
            original = getattr(owner, name)
            self._saved.append((owner, name, original))
            setattr(owner, name, make(original))

        def sa_store(original):
            def store(cache, sa_name, scorer):
                t0 = time.perf_counter()
                original(cache, sa_name, scorer)
                self.sa_stores[sa_name] = {"bytes": os.path.getsize(cache.path(sa_name)),
                                           "store_s": time.perf_counter() - t0}
            return store

        def cov_store(original):
            def store(cache, stats):
                t0 = time.perf_counter()
                original(cache, stats)
                self.cov_stores.append({"bytes": os.path.getsize(cache.path),
                                        "store_s": time.perf_counter() - t0})
            return store

        def hashing(original):
            def content_fingerprint(version, *args):
                t0 = time.perf_counter()
                fp = original(version, *args)
                self.hashes.append({"version": version, "seconds": time.perf_counter() - t0})
                return fp
            return content_fingerprint

        def sa_outcomes(original):
            def evaluate_all(handler, *args, **kwargs):
                out = original(handler, *args, **kwargs)
                self.sa_outcomes.append(dict(handler.cache_outcomes))
                return out
            return evaluate_all

        def cov_outcome(original):
            def __init__(worker, *args, **kwargs):
                original(worker, *args, **kwargs)
                self.cov_outcomes.append(worker.stats_cache_outcome)
            return __init__

        wrap(sa_prep.SAFitCache, "store", sa_store)
        wrap(coverage_stats_cache.CoverageStatsCache, "store", cov_store)
        wrap(sa_prep, "content_fingerprint", hashing)
        wrap(coverage_stats_cache, "content_fingerprint", hashing)
        wrap(SurpriseHandler, "evaluate_all", sa_outcomes)
        wrap(CoverageWorker, "__init__", cov_outcome)
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)

    def report(self) -> dict:
        return {"sa_entries": self.sa_stores,
                "sa_bytes": sum(e["bytes"] for e in self.sa_stores.values()),
                "sa_store_s": sum(e["store_s"] for e in self.sa_stores.values()),
                "coverage_entries": self.cov_stores, "fingerprints": self.hashes,
                "sa_outcomes": self.sa_outcomes, "coverage_outcomes": self.cov_outcomes}


def entry_meta(path: str) -> dict:
    """The meta of an SA fit cache entry, read without its scorer."""
    with open(path, "rb") as f:
        return pickle.load(f)


def check_cache_entries(family: str, recorder: CacheRecorder) -> dict:
    """Phase 7's stores: an entry of every SA variant and one of the
    coverage statistics, each on disk; each SA entry's meta names its
    variant, this package's version, the run's case study and model."""
    rec = recorder.report()
    if sorted(rec["sa_entries"]) != sorted(SA_NAMES):
        raise AssertionError(f"{family}: SA entries stored for {sorted(rec['sa_entries'])}")
    if len(rec["coverage_entries"]) != 1:
        raise AssertionError(f"{family}: {len(rec['coverage_entries'])} coverage entries stored")
    folder = subdir("sa_fit_cache")
    for name in SA_NAMES:
        paths = [os.path.join(folder, f) for f in os.listdir(folder)
                 if f.startswith(f"{family}_0_") and f.endswith(f"_{name}.pkl")]
        if len(paths) != 1:
            raise AssertionError(f"{family}: {len(paths)} entries of {name} on disk")
        path = paths[0]
        meta = entry_meta(path)
        if (meta["version"], meta["variant"], meta["case_study"], meta["model_ref"]) != (
                sa_prep.CACHE_FORMAT_VERSION, name, family, "0"):
            raise AssertionError(f"{path}: meta {meta}")
    return rec


@contextlib.contextmanager
def patched_env(values: dict):
    """``os.environ`` with ``values`` set (None unsets) for a ``with``."""
    saved = {var: os.environ.get(var) for var in values}
    for var, value in values.items():
        if value is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = value
    try:
        yield
    finally:
        for var, value in saved.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value


def caches_off():
    """Both caches off, as a card-against-CPU comparison needs (the CPU side
    would load the card's fits)."""
    return patched_env(dict.fromkeys(CACHE_VARS, "off"))


def tensor_devices(obj, seen=None) -> set:
    """The device types of every tensor and ``torch.device`` reachable from
    ``obj`` through attributes, dicts, lists and tuples."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return set()
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return {obj.device.type}
    if isinstance(obj, torch.device):
        return {obj.type}
    if isinstance(obj, dict):
        children = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        children = list(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        children = list(vars(obj).values())
    else:
        return set()
    return set().union(*(tensor_devices(c, seen) for c in children)) if children else set()


def same_bytes(a, b) -> bool:
    """Arrays (or tensors) equal in dtype, shape and every byte."""
    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def warm_cache_check(family: str, spec, params, data, dev) -> dict:
    """Run 0's ``SurpriseHandler`` and ``CoverageWorker`` on the (weights,
    training set, taps) of ``test_prio``, against the caches it filled (the
    ``TIP_ASSETS`` of its artifacts), in a process that fitted nothing:
    per SA variant its cache outcome, setup seconds and whether its nominal
    scores and SC-CAM order equal the artifacts byte for byte; the
    training-set forward passes run; B2's launches; the coverage worker's
    outcome and its statistics against a recompute; pc-mdsa's entry loaded
    onto the CPU, its devices and its scores of ``CPU_ENTRY_ROWS`` rows
    against the card's."""
    (x_tr, _), (x_nom, _), _ = data
    model = spec.model_factory()
    handler = SurpriseHandler(model, params, list(spec.sa_activation_layers), x_tr, device=dev,
                              dsa_badge_size=spec.dsa_badge_size, case_study=family,
                              model_id=0)
    train_passes = []
    traces = handler._traces

    def counting(dataset):
        if dataset is x_tr:
            train_passes.append(len(dataset))
        return traces(dataset)

    handler._traces = counting
    zero_counters()
    t0 = time.perf_counter()
    results, chosen_k = handler.evaluate_all({"nominal": x_nom})
    sa_s = time.perf_counter() - t0
    report = {"family": family, "sa_s": sa_s, "chosen_k": chosen_k,
              "train_forward_passes": len(train_passes),
              "b2_launches": read_counters()["dsa_nearest"], "variants": {}}
    for name, per_ds in results.items():
        scores, order, times = per_ds["nominal"]
        want = {kind: np.load(os.path.join(subdir("priorities"),
                                           f"{family}_nominal_0_{name}_{kind}.npy"))
                for kind in ("scores", "cam_order")}
        report["variants"][name] = {
            "outcome": handler.cache_outcomes[name], "setup_s": times[0],
            "scores_equal": same_bytes(scores, want["scores"]),
            "order_equal": same_bytes(order, want["cam_order"])}

    base_model = BaseModel(model, params, activation_layers=list(spec.nc_activation_layers),
                           batch_size=spec.prediction_badge_size, device=dev)
    t0 = time.perf_counter()
    worker = CoverageWorker(base_model, x_tr)
    cov_s = time.perf_counter() - t0
    with caches_off():
        t0 = time.perf_counter()
        fresh = CoverageWorker(base_model, x_tr)
        recompute_s = time.perf_counter() - t0
    report["coverage"] = {
        "outcome": worker.stats_cache_outcome, "setup_s": cov_s, "recompute_s": recompute_s,
        "nbc_setup_s": worker.setup_times["NBC_0"],
        "stats_equal": all(same_bytes(a, b) for got, want in zip(worker.stats, fresh.stats)
                           for a, b in zip(got, want))}

    t0 = time.perf_counter()
    on_cpu = handler.cache.load("pc-mdsa", device="cpu")
    load_s = time.perf_counter() - t0
    ats, preds = traces(x_nom[:CPU_ENTRY_ROWS])
    card_scores = results["pc-mdsa"]["nominal"][0][:CPU_ENTRY_ROWS]
    cpu_scores = on_cpu([a.cpu() for a in ats], preds)
    report["cpu_entry"] = {"variant": "pc-mdsa", "load_s": load_s,
                           "devices": sorted(tensor_devices(on_cpu)),
                           "rows": CPU_ENTRY_ROWS, "rel_gap": _rel_gap(cpu_scores, card_scores)}
    return report


def warm_cache_verdict(report: dict) -> None:
    """Raise unless the fresh process hit every SA variant and the coverage
    statistics, fitted and walked the training set nowhere, reproduced
    every artifact byte for byte, launched B2 from the loaded DSA, and
    loaded an entry onto the CPU that scores as the card does (within
    ``SA_RTOL``)."""
    faults = []
    for name, v in report["variants"].items():
        if v["outcome"] != "hit":
            faults.append(f"{name}: cache {v['outcome']}")
        if not (v["scores_equal"] and v["order_equal"]):
            faults.append(f"{name}: scores or SC-CAM order differ from the artifact")
    if sorted(report["variants"]) != sorted(SA_NAMES):
        faults.append(f"variants {sorted(report['variants'])}")
    if report["train_forward_passes"]:
        faults.append(f"{report['train_forward_passes']} training-set forward passes")
    if not report["b2_launches"] > 0:
        faults.append("B2 was not launched from the loaded DSA")
    cov = report["coverage"]
    if cov["outcome"] != "hit" or not cov["stats_equal"]:
        faults.append(f"coverage statistics: {cov['outcome']}, equal {cov['stats_equal']}")
    entry = report["cpu_entry"]
    if entry["devices"] != ["cpu"] or not entry["rel_gap"] <= SA_RTOL:
        faults.append(f"entry on the CPU: devices {entry['devices']}, gap {entry['rel_gap']}")
    if faults:
        raise AssertionError(f"warm cache, {report['family']}: " + "; ".join(faults))


def warm_cache_main(family: str) -> int:
    """The fresh interpreter's side of ``WarmCache``: the study and run
    0's weights from the registry, the check's report as the last line."""
    dev = resolve(None)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cs = base.get_case_study(family)
    data = cs.spec.loader(device=dev)
    report = warm_cache_check(family, cs.spec, params_from_jax(cs.load_params(0)), data, dev)
    print(json.dumps(report))
    return 0


class WarmCache:
    """``warm_cache_check`` in a fresh interpreter (as a run scheduler
    starts one) on phase 7's ``TIP_ASSETS``; ``finish`` waits for it, checks
    it by ``warm_cache_verdict`` and prints it beside phase 7's cold setup
    seconds."""

    def __init__(self, family: str, root: str):
        self.family = family
        env = dict(os.environ, TIP_ASSETS=os.path.join(root, "train"))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--warm-cache", family], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        CHILDREN.append(self.proc)

    def finish(self, cold_records: dict) -> dict:
        out, err = self.proc.communicate(timeout=WARM_CACHE_TIMEOUT_S)
        if self.proc.returncode != 0:
            raise AssertionError(f"warm cache, {self.family}: exit {self.proc.returncode}\n"
                                 f"{err[-4000:]}")
        report = json.loads(out.strip().splitlines()[-1])
        report["process_s"] = time.perf_counter() - self.t0
        report["cold_setup_s"] = {name: cold_records["nominal"][name][0] for name in SA_NAMES}
        print(json.dumps({"warm_cache": report}))
        warm_cache_verdict(report)
        return report


def check_disk_spill(family: str, params, data, dev, root: str) -> dict:
    """A ``CoverageWorker`` with ``spill="disk"`` on phase 7's assets: every
    metric's scores and CAM order on both sets byte-equal to phase 7's
    artifacts (spilled in memory), and its temp directories gone."""
    cfg = PATHS[family]
    os.environ["TIP_ASSETS"] = os.path.join(root, "train")
    base_model = BaseModel(cfg["model"](), params, activation_layers=cfg["nc"],
                           batch_size=cfg["batch"], device=dev)
    worker = CoverageWorker(base_model, data[0][0], spill="disk")
    report = {"family": family, "stats_outcome": worker.stats_cache_outcome, "seconds": {}}
    faults = []
    for ds, (x, _) in (("nominal", data[1]), ("ood", data[2])):
        t0 = time.perf_counter()
        _, scores, orders = worker.evaluate_all(x, ds)
        report["seconds"][ds] = time.perf_counter() - t0
        for metric in NC_METRICS:
            for kind, got in (("scores", scores[metric]), ("cam_order", orders[metric])):
                want = np.load(os.path.join(subdir("priorities"),
                                            f"{family}_{ds}_0_{metric}_{kind}.npy"))
                if not same_bytes(got, want):
                    faults.append(f"{ds} {metric} {kind}")
        if os.path.exists(worker._temp_root()):
            faults.append(f"{ds}: {worker._temp_root()} left behind")
    report["metrics"] = len(NC_METRICS)
    print(json.dumps({"disk_spill": report}))
    if faults:
        raise AssertionError(f"disk spill, {family}: differs from memory on " + ", ".join(faults))
    return report


# -- the fused and grouped chain route (phase 8 of the docstring) ---------------

def tree_faults(got, want, path: str = "") -> list:
    """The paths at which two nests (dicts, lists, tuples) of tensors or
    arrays differ in dtype, shape or any byte; numbers compare equal or not."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(map(str, got))} != {sorted(map(str, want))}"]
        return [f for k in want for f in tree_faults(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [f"{path}: {len(got)} items != {len(want)}"]
        return [f for i, (g, w) in enumerate(zip(got, want))
                for f in tree_faults(g, w, f"{path}/{i}")]
    if isinstance(want, (torch.Tensor, np.ndarray)):
        return [] if same_bytes(got, want) else [path or "/"]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]


def clone_tree(tree):
    """Host copies of every tensor in a nest (a graph's outputs are
    overwritten by its next replay)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.cpu().numpy().copy() if isinstance(tree, torch.Tensor) else tree


def padding_faults(cov: dict, valid: int, full: dict) -> list:
    """A chain's packed profiles on a badge whose rows from ``valid`` on are
    padding: those rows all zero, the rows before them the full badge's."""
    faults = []
    for mid, (_, packed) in cov.items():
        if np.any(packed[valid:]):
            faults.append(f"{mid}: padding rows hold set bits")
        if not same_bytes(packed[:valid], full[mid][1][:valid]):
            faults.append(f"{mid}: valid rows differ from the unpadded badge")
    return faults


def member_faults(results: list, refs: list) -> list:
    """Each group member's result against its own ``FusedChainRunner``
    result, byte for byte (timing records aside)."""
    if len(results) != len(refs):
        return [f"{len(results)} member results for {len(refs)} runs"]
    faults = []
    for g, (got, want) in enumerate(zip(results, refs)):
        keys = [k for k in want if not k.endswith("_times")]
        faults += tree_faults({k: got.get(k) for k in keys}, {k: want[k] for k in keys},
                              f"member {g}")
    return faults


def top2_gap(probs: np.ndarray) -> np.ndarray:
    """Per row, the largest probability less the second largest."""
    top = np.sort(probs, axis=1)
    return top[:, -1] - top[:, -2]


def fused_against_per_phase(fused: dict, per_phase: dict, gaps: dict) -> dict:
    """The fused route's artifacts against the per-phase route's of one
    run: CAM orders, coverage scores, VR and SA byte-equal; the other
    uncertainties within ``CHAIN_UNCERTAINTY_ATOL``; ``is_misclassified``
    equal but on rows whose two largest probabilities lie within
    ``CHAIN_TIE_GAP`` (``gaps[ds]``: the per-phase probabilities' gap per
    row; the per-phase route predicts through B1 on MNIST, the chain
    through the module), which are counted. Raises on any other
    difference; returns the counts and the largest uncertainty gaps."""
    if set(fused) != set(per_phase):
        raise AssertionError(f"fused route artifacts {sorted(set(fused) ^ set(per_phase))} "
                             "are not the per-phase route's")
    faults, near_tie, unc_gap = [], {}, {}
    for (ds, suffix), want in per_phase.items():
        got = fused[(ds, suffix)]
        if suffix == "is_misclassified":
            rows = np.flatnonzero(got != want)
            far = rows[gaps[ds][rows] > CHAIN_TIE_GAP]
            if far.size:
                faults.append(f"{ds} is_misclassified differs on {far.size} rows that are "
                              f"no near tie (first {far[:5].tolist()})")
            near_tie[ds] = int(rows.size)
        elif suffix.startswith("uncertainty_") and suffix != "uncertainty_VR":
            gap = float(np.abs(got.astype(np.float64) - want).max())
            unc_gap[f"{ds} {suffix}"] = gap
            if got.dtype != want.dtype or got.shape != want.shape or gap > CHAIN_UNCERTAINTY_ATOL:
                faults.append(f"{ds} {suffix}: {got.dtype}{got.shape} off by {gap}")
        elif not same_bytes(got, want):
            faults.append(f"{ds} {suffix}")
    if faults:
        raise AssertionError("fused route against per-phase: " + "; ".join(faults))
    return {"misclassified_near_tie": near_tie, "uncertainty_max_abs": unc_gap}


def chain_seconds(records: dict) -> dict:
    """The chain's and the ranks' seconds (both sets) from the fused route's
    time records: the chain's in every record's pred slot, the ranks' in the
    coverage records' cam slots."""
    return {"chain_s": sum(records[ds]["softmax"][1] for ds in records),
            "rank_s": sum(records[ds][m][3] for ds in records for m in NC_METRICS)}


def run_fused_path(family: str, params, data, dev, root: str, per_phase_s: dict) -> dict:
    """(a) ``TIP_FUSED_CHAIN=1 cli.main --phase test_prio`` of run 0 at full
    size in a fresh ``TIP_ASSETS`` holding the checkpoints, both caches
    pointed at phase 7's (so SA is a load), the counters read around it;
    every artifact against phase 7's (``fused_against_per_phase``)."""
    src, dst = os.path.join(root, "train"), os.path.join(root, f"{family}_fused")
    shutil.copytree(os.path.join(src, "models", family), os.path.join(dst, "models", family))
    env = {"TIP_ASSETS": dst, "TIP_FUSED_CHAIN": "1",
           "TIP_SA_CACHE_DIR": os.path.join(src, "sa_fit_cache"),
           "TIP_COV_STATS_CACHE_DIR": os.path.join(src, "coverage_stats_cache")}
    with patched_env(env):
        zero_counters()
        t0 = time.perf_counter()
        with CacheRecorder() as recorder:
            [(phases, _)] = run_cli("--phase", "test_prio", "--case-study", family,
                                    "--runs", "0", *device_args(dev)).values()
        seconds = time.perf_counter() - t0
        launches = read_counters()
        rows = {"nominal": len(data[1][1]), "ood": len(data[2][1])}
        fused, records = read_artifacts(family, rows)
    if any(o != "hit" for outcomes in recorder.sa_outcomes for o in outcomes.values()):
        raise AssertionError(f"{family} fused: SA was not a load ({recorder.sa_outcomes})")
    os.environ["TIP_ASSETS"] = src
    per_phase, _ = read_artifacts(family, rows)
    model = BaseModel(PATHS[family]["model"](), params, device=dev)
    gaps = {ds: top2_gap(predict(model.net, model.fused, x, dev).cpu().numpy())
            for ds, (x, _) in (("nominal", data[1]), ("ood", data[2]))}
    report = fused_against_per_phase(fused, per_phase, gaps)
    for name in PATHS[family]["chain_kernels"]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the fused {family} path")
    record = {"fused_path": family, "slice_s": seconds, "phases_s": phases,
              **chain_seconds(records), "per_phase_s": per_phase_s,
              "per_phase_fp_nc_s": per_phase_s["fault_predictors"] + per_phase_s["neuron_coverage"],
              "launches": launches, "sa_outcomes": recorder.sa_outcomes, **report}
    print(json.dumps(record))
    return record


def check_graph_vs_eager(family: str, params, data, dev) -> dict:
    """(b) The chain program (a CUDA graph) against the eager chain on the
    card, on one full badge of real inputs: every output byte-equal; then
    the badge with its rows from ``CHAIN_PAD_VALID`` on masked as padding
    (``padding_faults``); both timed per badge."""
    cfg = PATHS[family]
    runner = FusedChainRunner(cfg["model"](), params, data[0][0], cfg["nc"],
                              batch_size=cfg["batch"], device=dev)
    x = data[1][0][:runner.badge_size]
    xs = to_device(x, dev)
    prog = runner.chain_program(*badge_layout(x, runner.badge_size, dev))
    _, x_buf, valid = prog.args
    x_buf.copy_(xs)
    valid.fill_(xs.shape[0])
    graph_out = clone_tree(prog())
    with torch.no_grad():
        eager_out = clone_tree(prog.fn(*prog.args))
    faults = tree_faults(graph_out, eager_out)
    valid.fill_(CHAIN_PAD_VALID)
    faults += padding_faults(clone_tree(prog())[2], CHAIN_PAD_VALID, graph_out[2])
    valid.fill_(xs.shape[0])

    def eager():
        with torch.no_grad():
            prog.fn(*prog.args)

    record = {"graph_vs_eager": family, "badge": list(xs.shape), "graph": prog.graph is not None,
              "faults": faults, "graph_ms": cuda_ms(prog, CHAIN_REPS),
              "eager_ms": cuda_ms(eager, CHAIN_REPS), "eager_host_ms": host_ms(eager, CHAIN_REPS)}
    print(json.dumps(record))
    if faults or (dev.type == "cuda" and prog.graph is None):
        raise AssertionError(f"{family}: the chain graph differs from the eager chain: {faults}")
    return record


def check_group_runner(params_by_run: dict, data, dev) -> dict:
    """(c) ``GroupChainRunner`` over MNIST runs 0 and 1 at G=2 and at G=3
    (a padded third member) on the first ``CHAIN_GROUP_ROWS`` rows of the
    nominal and OOD sets: each member's result byte-equal to
    ``FusedChainRunner``'s for its run (``member_faults``), one group
    dispatch per badge."""
    cfg = PATHS[CHAIN_GROUP_FAMILY]
    runs = sorted(params_by_run)
    sets = {"nominal": data[1][0][:CHAIN_GROUP_ROWS], "ood": data[2][0][:CHAIN_GROUP_ROWS]}
    common = dict(training_set=data[0][0], nc_layers=cfg["nc"], batch_size=cfg["batch"],
                  device=dev)
    t0 = time.perf_counter()
    refs = {}
    for run in runs:
        runner = FusedChainRunner(cfg["model"](), params_by_run[run], **common)
        refs[run] = {ds: runner.evaluate_dataset(x, seed=run, select_k=CHAIN_SELECT_K)
                     for ds, x in sets.items()}
    record = {"group_runner": CHAIN_GROUP_FAMILY, "rows": CHAIN_GROUP_ROWS, "runs": runs,
              "per_model_s": time.perf_counter() - t0, "groups": {}}
    badges = sum(-(-len(x) // PROFILE_BADGE_SIZE) for x in sets.values())
    faults = []
    for g in CHAIN_GROUP_SIZES:
        t0 = time.perf_counter()
        group = GroupChainRunner(cfg["model"](), [params_by_run[r] for r in runs],
                                 group_size=g, **common)
        for ds, x in sets.items():
            results = group.evaluate_dataset(x, seeds=runs, select_k=CHAIN_SELECT_K)
            faults += [f"G={g} {ds} {f}"
                       for f in member_faults(results, [refs[r][ds] for r in runs])]
        if group.group_chain_dispatches != badges:
            faults.append(f"G={g}: {group.group_chain_dispatches} group dispatches "
                          f"for {badges} badges")
        record["groups"][g] = {"seconds": time.perf_counter() - t0,
                               "dispatches": group.group_chain_dispatches}
    record["faults"] = faults
    print(json.dumps(record))
    if faults:
        raise AssertionError("group runner against the per-model runner: " + "; ".join(faults))
    return record


# -- the online scoring service (phase 7c of the docstring) ------------------------

def request_cuts(n: int, seed: int) -> np.ndarray:
    """Boundaries of seeded requests of ``SERVE_REQUEST_ROWS`` rows (the last
    one cut to what is left) over ``n`` rows."""
    rng = np.random.default_rng(seed)
    lo, hi = SERVE_REQUEST_ROWS
    sizes = rng.integers(lo, hi + 1, size=2 * n // (lo + hi) + 2)
    cuts = np.concatenate([[0], np.cumsum(sizes)])
    cuts = cuts[cuts < n]
    return np.append(cuts, n)


def saturated_badges(cuts: np.ndarray) -> int:
    """Badges the batcher packs a family's requests into when its queue is
    deep: each request cut into chunks of at most a badge (as
    ``ScoringEngine.score`` cuts it), chunks never split."""
    packer = ContinuousBatcher(SERVE_BADGE, 0.0)
    packer.add_model(None)
    for i, n in enumerate(np.diff(cuts)):
        for a in range(0, int(n), SERVE_BADGE):
            packer.push(None, Chunk(i, a, None, min(SERVE_BADGE, int(n) - a), 0.0))
    badges = 0
    while packer.take_ready(0.0, force=True) is not None:
        badges += 1
    return badges


class BadgeLog:
    """Every badge an executor runs: ``(model, rows)`` in dispatch order."""

    def __init__(self, executor):
        self.badges = []
        self._run_badge = executor.run_badge
        executor.run_badge = self

    def __call__(self, key, segments):
        parts = self._run_badge(key, segments)
        self.badges.append((key, sum(len(s) for s in segments)))
        return parts

    def since(self, start: int, key) -> list:
        return [rows for k, rows in self.badges[start:] if k == key]


def serving_faults(family: str, responses: dict, cuts: np.ndarray, ref: dict) -> list:
    """Each answered request against the offline walk's rows, byte for byte."""
    faults = []
    for i, got in responses.items():
        a, b = int(cuts[i]), int(cuts[i + 1])
        want = {"pred": ref["pred"][a:b],
                "uncertainties": {k: v[a:b] for k, v in ref["uncertainties"].items()},
                "scores": {k: v[a:b] for k, v in ref["scores"].items()}}
        faults += [f"{family} request {i} [{a}:{b}] {f}" for f in tree_faults(got, want)]
    return faults


async def serve_rate(executor, specs: dict, sets: dict, cuts: dict, rate_rows_s: float,
                     knobs: ServingKnobs, final_rows: int = 0) -> tuple:
    """One engine over the registered models, both tenants driven at once
    open-loop at ``rate_rows_s`` each; then, if asked, one request of
    ``final_rows`` rows. Returns the loadgen reports, the responses by
    family and the final response."""
    engine = ScoringEngine(executor, knobs)
    for family, spec in specs.items():
        engine.register_model(family, **spec)  # warm already: no capture
    responses = {family: {} for family in sets}
    async with engine:
        reports = await asyncio.gather(*(
            drive(engine, family, lambda i, f=family: sets[f][cuts[f][i]:cuts[f][i + 1]],
                  n_requests=len(cuts[family]) - 1,
                  rows_per_request=len(sets[family]) / (len(cuts[family]) - 1),
                  arrival_rows_per_s=rate_rows_s,
                  on_response=responses[family].__setitem__)
            for family in sets))
        final = await engine.score("mnist", sets["mnist"][:final_rows]) if final_rows else None
    return dict(zip(sets, reports)), responses, final


def register_while_serving(executor, spec: dict, x: np.ndarray, late_params, ref: dict,
                           log: BadgeLog, loop) -> dict:
    """A second MNIST tenant (run 1's weights: another fingerprint, and a
    program no longer among the process's resolved ones, so a capture)
    registered from this thread while the loop thread serves run 0's first
    ``SERVE_LATE_ROWS`` rows at ``SERVE_LATE_RATE``: its program new, no
    error and no shed, every answer byte-equal to the offline walk, and the
    new tenant's first answer byte-equal to its own."""
    engine = ScoringEngine(executor, ServingKnobs(max_badge=SERVE_BADGE,
                                                  flush_deadline_s=SERVE_FLUSH_S))
    engine.register_model("mnist", **spec)
    xs = x[:SERVE_LATE_ROWS]
    cuts = request_cuts(len(xs), 7)
    responses = {}
    loop.run(engine.start())
    traffic = loop.submit(drive(
        engine, "mnist", lambda i: xs[cuts[i]:cuts[i + 1]], n_requests=len(cuts) - 1,
        rows_per_request=len(xs) / (len(cuts) - 1), arrival_rows_per_s=SERVE_LATE_RATE,
        on_response=responses.__setitem__))
    time.sleep(SERVE_LATE_START_S)
    resolved = {id(p) for p in run_program._RESOLVED.values()}
    before = len(log.badges)
    t0 = time.perf_counter()
    engine.register_model("mnist-run1", **{**spec, "params": late_params})
    register_s = time.perf_counter() - t0
    during = len(log.badges) - before
    report = traffic.result(120)
    late_rows = x[:SERVE_FINAL_ROWS]
    answer = loop.run(engine.score("mnist-run1", late_rows))
    loop.run(engine.close())
    faults = serving_faults("mnist", responses, cuts, ref)
    faults += serving_faults("mnist-run1", {0: answer}, np.array([0, len(late_rows)]),
                             executor.runner("mnist-run1").score_dataset(late_rows))
    if report["errors"] or report["shed"] or report["ok"] != report["requests"]:
        faults.append(f"late register: {report['ok']} of {report['requests']} answered, "
                      f"{report['shed']} shed, {report['errors']} errors")
    program = executor.program("mnist-run1")
    if id(program) in resolved or (executor.device.type == "cuda" and program.graph is None):
        faults.append("late register: no capture of its own under the traffic")
    return {"register_s": register_s, "badges_during_register": during,
            "p99_ms": report["p99_ms"], "requests": report["requests"], "faults": faults}


def run_serving(params: dict, data: dict, dev, late_params) -> dict:
    """Phase 7c: ``ScoringEngine`` over ``FusedChainExecutor`` with MNIST and
    IMDB registered (run 0's trained weights, the loaders' full training
    and nominal sets, badge ``SERVE_BADGE``; the coverage statistics a load
    from phase 7's cache); the capacity probe; the two tenants driven
    open-loop, both at once, at ``SERVE_RATES`` x the rows a second that
    keep the card busy at the probe's badge times and the requests' packed
    fill (``saturated_badges``), by seeded requests over the full nominal
    sets, every answer byte-equal to the offline walk
    (``FusedChainRunner.score_dataset``: ``evaluate_dataset``'s walk
    without its ranks) and no shed below ``SERVE_OVERLOAD``; at it, with a
    queue bound of ``SERVE_OVERLOAD_QUEUE_BADGES`` badges, sheds counted in
    ``serving.shed`` as the loadgen counts them, the admitted answers
    byte-equal and a request served after the burst; B4's launches over the
    traffic equal IMDB's badges times the launches its graph records; and
    a tenant registered while another is served
    (``register_while_serving``)."""
    t_phase = time.perf_counter()
    executor = FusedChainExecutor(device=dev)
    specs, register_s, stats = {}, {}, {}
    for family in SERVE_FAMILIES:
        cfg = PATHS[family]
        specs[family] = dict(model_def=cfg["model"](), params=params[family],
                             training_set=data[family][0][0], nc_layers=cfg["nc"],
                             batch_size=cfg["batch"], layout_like=data[family][1][0])
        t0 = time.perf_counter()
        executor.register_model(family, badge_size=SERVE_BADGE, **specs[family])
        register_s[family] = time.perf_counter() - t0
        stats[family] = executor.runner(family).worker.stats_cache_outcome
    if any(outcome != "hit" for outcome in stats.values()):
        raise AssertionError(f"serving: registration computed training statistics ({stats})")
    sets = {family: data[family][1][0] for family in SERVE_FAMILIES}

    badge_ms = {}
    for family, x in sets.items():
        badge = [x[:SERVE_BADGE]]
        executor.run_badge(family, badge)  # warm
        times = []
        for _ in range(SERVE_PROBE_BADGES):
            t0 = time.perf_counter()
            executor.run_badge(family, badge)
            times.append(time.perf_counter() - t0)
        badge_ms[family] = 1e3 * sum(times) / len(times)
    capacity = {family: SERVE_BADGE * 1e3 / ms for family, ms in badge_ms.items()}
    refs = {family: executor.runner(family).score_dataset(x) for family, x in sets.items()}
    cuts = {family: request_cuts(len(x), i) for i, (family, x) in enumerate(sets.items())}
    # The rows a second of each tenant, both at once, that keep the card
    # busy at the probe's badge times and the fill these requests pack to
    # (chunks never split, so 1-700-row requests fill a badge to ~0.7):
    # the rates' base. The two tenants at a rate of 1.0x of MNIST's badge
    # capacity ask the card for ~1.5 times what it does.
    packed = {family: saturated_badges(c) for family, c in cuts.items()}
    mix_capacity = 1.0 / sum(packed[f] / len(sets[f]) * badge_ms[f] / 1e3 for f in sets)

    b4 = KERNEL_COUNTERS.index((flash_attention, "LAUNCHES"))
    recorded = {family: executor.program(family).recorded for family in SERVE_FAMILIES}
    if dev.type == "cuda" and (recorded["imdb"][b4] <= 0 or any(recorded["mnist"])):
        raise AssertionError(f"serving: the chain graphs record {recorded} launches")
    log = BadgeLog(executor)
    loop = shared_loop()
    zero_counters()
    dispatched0 = dict(executor.dispatches)
    rates, faults = {}, []
    for multiple in SERVE_RATES:
        overload = multiple >= SERVE_OVERLOAD
        knobs = ServingKnobs(
            max_badge=SERVE_BADGE, flush_deadline_s=SERVE_FLUSH_S,
            queue_bound_rows=SERVE_OVERLOAD_QUEUE_BADGES * SERVE_BADGE if overload else None)
        shed0 = obs.metrics_snapshot()["counters"].get("serving.shed", 0)
        start = len(log.badges)
        t0 = time.perf_counter()
        reports, responses, final = loop.run(serve_rate(
            executor, specs, sets, cuts, multiple * mix_capacity, knobs,
            final_rows=SERVE_FINAL_ROWS if overload else 0))
        seconds = time.perf_counter() - t0
        shed = obs.metrics_snapshot()["counters"].get("serving.shed", 0) - shed0
        record = {"rate": multiple, "rows_per_s": multiple * mix_capacity, "seconds": seconds,
                  "serving_shed": shed, "families": {}}
        for family, rep in reports.items():
            fills = log.since(start, family)
            record["families"][family] = {
                **{k: rep[k] for k in ("requests", "ok", "shed", "errors", "p50_ms", "p95_ms",
                                       "p99_ms", "sustained_inputs_per_s", "elapsed_s")},
                "badges": len(fills), "mean_fill": sum(fills) / (len(fills) * SERVE_BADGE)
                if fills else None}
            faults += serving_faults(family, responses[family], cuts[family], refs[family])
            if rep["errors"] or rep["ok"] + rep["shed"] != rep["requests"]:
                faults.append(f"{multiple}x {family}: {rep['errors']} errors, "
                              f"{rep['ok']} + {rep['shed']} of {rep['requests']} settled")
            if not overload and rep["shed"]:
                faults.append(f"{multiple}x {family}: {rep['shed']} requests shed")
            if not fills:
                faults.append(f"{multiple}x {family}: no badge")
        # the fair rotation: IMDB's badges ride between MNIST's, not after them
        order = [k for k, _ in log.badges[start:]]
        record["first_badges"] = "".join(k[0] for k in order[:24])
        if set(order) == set(SERVE_FAMILIES) and order.index("imdb") > max(
                i for i, k in enumerate(order) if k == "mnist"):
            faults.append(f"{multiple}x: IMDB was served only after MNIST's last badge")
        if overload:
            sheds = sum(rep["shed"] for rep in reports.values())
            if not sheds or shed != sheds:
                faults.append(f"{multiple}x: {sheds} sheds by the loadgen, {shed} counted")
            faults += serving_faults("mnist", {0: final},
                                     np.array([0, SERVE_FINAL_ROWS]), refs["mnist"])
            record["final_request_rows"] = len(final["pred"])
        rates[multiple] = record
        print(json.dumps({"serving_rate": record}))
    launches = read_counters()
    late = register_while_serving(executor, specs["mnist"], sets["mnist"], late_params,
                                  refs["mnist"], log, loop)
    faults += late.pop("faults")
    imdb_badges = executor.dispatches["imdb"] - dispatched0["imdb"]
    b4_want = imdb_badges * recorded["imdb"][b4]
    if dev.type == "cuda" and launches["flash_attention_fwd"] != b4_want:
        faults.append(f"B4 launched {launches['flash_attention_fwd']} times for {imdb_badges} "
                      f"IMDB badges x {recorded['imdb'][b4]} a replay")
    record = {"serving": list(SERVE_FAMILIES), "badge": SERVE_BADGE, "register_s": register_s,
              "stats_cache": stats, "badge_ms": badge_ms, "capacity_rows_s": capacity,
              "saturated_badges": packed, "mix_capacity_rows_s": mix_capacity,
              "requests": {f: len(c) - 1 for f, c in cuts.items()},
              "launches": launches, "imdb_badges": imdb_badges,
              "b4_per_replay": recorded["imdb"][b4], "late_register": late, "faults": faults,
              "phase_s": time.perf_counter() - t_phase}
    print(json.dumps(record))
    if faults:
        raise AssertionError("serving: " + "; ".join(faults[:20]))
    record["rates"] = rates
    return record


# -- the study-execution layer (phase 7d of the docstring) -------------------------


def read_streams(obs_dir: str) -> list:
    """Every complete record of the event streams under ``obs_dir``."""
    records = []
    for name in sorted(os.listdir(obs_dir)) if os.path.isdir(obs_dir) else ():
        if not (name.startswith("events-") and name.endswith(".jsonl")):
            continue
        with open(os.path.join(obs_dir, name)) as f:
            for line in f:
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue  # a torn tail line
    return records


def worker_records(records: list) -> dict:
    """Per scheduler worker (pid) in ``records``: its platform and index (its
    stream's meta), the runs it ran with each run's start and seconds (its
    ``run`` spans) and the kernel launches of its last flushed metrics."""
    workers = {}
    for rec in records:
        w = workers.setdefault(rec.get("pid"), {"platform": None, "worker": None, "runs": {},
                                                "errors": [], "launches": {}})
        if rec.get("type") == "meta":
            w["platform"], w["worker"] = rec.get("platform"), rec.get("worker")
        elif rec.get("type") == "span" and rec.get("name") == "run":
            attrs = rec.get("attrs", {})
            for run in attrs.get("model_ids") or [attrs.get("model_id")]:
                w["runs"][run] = (rec["ts"], rec["dur"])
            if "error" in rec:
                w["errors"].append(rec["error"])
        elif rec.get("type") == "metrics":
            w["launches"] = {name[len("kernel."):-len(".launches")]: value
                             for name, value in rec.get("gauges", {}).items()
                             if name.startswith("kernel.") and name.endswith(".launches")}
    return {pid: w for pid, w in workers.items() if w["worker"] is not None}


def sched_faults(workers: dict, runs, kernels, platform: str = "default",
                 concurrent: int = SCHED_WORKERS) -> list:
    """What is wrong with a scheduled phase's workers: a run that ran on no
    worker or on two, an error, a worker on another platform than
    ``platform``, a worker that launched one of ``kernels`` no time, fewer
    than ``concurrent`` workers running at once."""
    faults, ran_on = [], {}
    busy = {pid: w for pid, w in workers.items() if w["runs"]}
    for pid, w in busy.items():
        for run in w["runs"]:
            ran_on.setdefault(run, []).append(pid)
        if w["errors"]:
            faults.append(f"worker {pid} failed: {w['errors']}")
        if w["platform"] != platform:
            faults.append(f"worker {pid} ran {sorted(w['runs'])} on platform {w['platform']}, "
                          f"want {platform}")
        for name in kernels:
            if not w["launches"].get(name, 0) > 0:
                faults.append(f"worker {pid} launched {name} {w['launches'].get(name, 0)} times")
    for run in runs:
        if len(ran_on.get(run, [])) != 1:
            faults.append(f"run {run} ran on {len(ran_on.get(run, []))} workers")
    if sorted(ran_on) != sorted(runs):
        faults.append(f"the workers ran {sorted(ran_on)}, want {sorted(runs)}")
    spans = [span for w in busy.values() for span in w["runs"].values()]
    overlap = min((s + d for s, d in spans), default=0) - max((s for s, _ in spans), default=0)
    if len(busy) < concurrent or overlap <= 0:
        faults.append(f"{len(busy)} workers ran, overlapping {overlap:.3f} s; want {concurrent} "
                      "at once")
    return faults


def artifact_faults(family: str, got_root: str, want_roots: dict) -> list:
    """Per run, the priority artifacts under ``got_root`` against those under
    ``want_roots[run]``: the same names, every file byte-equal; the time
    records' names equal (their seconds differ by nature)."""
    faults = []
    for run, want_root in want_roots.items():
        for sub, compare in (("priorities", True), ("times", False)):
            def names(root):
                folder = os.path.join(root, sub)
                return sorted(n for n in os.listdir(folder) if n.startswith(f"{family}_")
                              and n.split("_")[2] == str(run))

            got, want = names(got_root), names(want_root)
            if got != want:
                faults.append(f"run {run} {sub}: {len(got)} files, want {len(want)} "
                              f"(apart: {sorted(set(got) ^ set(want))[:5]})")
            for name in sorted(set(got) & set(want)) if compare else ():
                with open(os.path.join(got_root, sub, name), "rb") as f, \
                        open(os.path.join(want_root, sub, name), "rb") as g:
                    if f.read() != g.read():
                        faults.append(f"run {run}: {name} differs from the in-process walk's")
    return faults


def resume_faults(reran: dict, journaled, missing) -> list:
    """A journaled resume ran each missing run once and no journaled run
    (``reran``: run -> attempts in the resume)."""
    faults = [f"journaled run {run} ran again ({reran[run]} attempts)"
              for run in sorted(journaled) if reran.get(run, 0)]
    faults += [f"missing run {run} ran {reran.get(run, 0)} times in the resume"
               for run in sorted(missing) if reran.get(run, 0) != 1]
    return faults


def _attempts(marker_dir: str) -> dict:
    out = {}
    for name in os.listdir(marker_dir):
        if name.startswith("attempt_"):
            with open(os.path.join(marker_dir, name)) as f:
                out[int(name[len("attempt_"):])] = len(f.read().split())
    return out


def drills_main(root: str) -> int:
    """(internal) Phase 7d's drills, run in a fresh interpreter started with
    ``python -c`` so that its workers, spawned for synthetic phases, import
    no torch: on two ``default`` (card) workers, (1) a ``worker.run`` kill
    of one run (requeued onto a CPU worker, the JAX contract for a
    synthetic phase; completes), (2) a wedge past
    ``run_timeout_s`` (reaped, requeued, counted), (3) a journaled phase
    with two runs failing, then its resume with the plan cleared, which
    runs only the two missing runs. Prints the report as its last line."""
    from simple_tip_tpu_torch.parallel.run_scheduler import run_phase_parallel
    from simple_tip_tpu_torch.resilience import RunJournal

    obs_dir = os.path.join(root, "obs")
    os.environ.update({"TIP_ASSETS": root, "TIP_OBS_DIR": obs_dir, "TIP_JOURNAL": "off",
                       "TIP_FAULT_STATE": os.path.join(root, "fault_state")})
    platforms = ["default"] * SCHED_WORKERS
    report, faults = {}, []

    def counters():
        return dict(obs.metrics_snapshot()["counters"])

    def drill(name, phase, runs, kwargs, plan=None, timeout=SCHED_DRILL_RUN_TIMEOUT_S,
              markers=None):
        marker_dir = os.path.join(root, markers or name)
        os.makedirs(marker_dir, exist_ok=True)
        os.environ["TIP_FAULT_PLAN"] = json.dumps(plan) if plan else ""
        before, t0 = counters(), time.perf_counter()
        error = None
        try:
            run_phase_parallel("sched-drill", phase, runs, SCHED_WORKERS,
                               phase_kwargs={"marker_dir": marker_dir, **kwargs},
                               worker_platforms=platforms, run_timeout_s=timeout)
        except RuntimeError as e:
            error = str(e)
        after = counters()
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("scheduler.worker_deaths", "scheduler.timeouts",
                           "scheduler.requeues", "scheduler.journal_skips")}
        done = sorted(int(n[len("run_"):-len(".txt")]) for n in os.listdir(marker_dir)
                      if n.startswith("run_"))
        report[name] = {"seconds": time.perf_counter() - t0, "counters": delta, "done": done,
                        "attempts": _attempts(marker_dir), "error": error}
        return report[name]

    kill = drill("kill", "_test_fault", [0, 1, 2, 3], {}, plan={"faults": [
        {"site": "worker.run", "kind": "die", "match": {"model_id": [1]}, "times": 1,
         "delay_s": 0.5}]})
    if kill["error"] or kill["done"] != [0, 1, 2, 3] or kill["counters"]["scheduler.worker_deaths"] \
            != 1 or kill["counters"]["scheduler.requeues"] != 1:
        faults.append(f"kill drill: {kill}")
    wedge = drill("wedge", "_test_wedge", [0, 1, 2], {"wedge_ids": (0,)},
                  timeout=SCHED_WEDGE_TIMEOUT_S)
    if wedge["error"] or wedge["done"] != [0, 1, 2] or wedge["attempts"].get(0) != 2 or \
            wedge["counters"]["scheduler.timeouts"] != 1 or \
            wedge["counters"]["scheduler.requeues"] != 1:
        faults.append(f"wedge drill: {wedge}")
    os.environ["TIP_JOURNAL"] = os.path.join(root, "journal", "runs.jsonl")
    runs, missing = list(range(6)), {4, 5}
    first = drill("journaled", "_test_fault", runs, {}, plan={"faults": [
        {"site": "worker.run", "kind": "error", "match": {"model_id": sorted(missing)},
         "times": 0}]})
    journaled = RunJournal(os.environ["TIP_JOURNAL"], "sched-drill", "_test_fault").completed()
    if not (first["error"] and "2/6" in first["error"]) or journaled != set(runs) - missing:
        faults.append(f"journaled drill: {first}, journal {sorted(journaled)}")
    resume = drill("resume", "_test_fault", runs, {}, markers="journaled")
    reran = {run: n - first["attempts"].get(run, 0) for run, n in resume["attempts"].items()}
    faults += resume_faults(reran, journaled, missing)
    if resume["error"] or resume["counters"]["scheduler.journal_skips"] != len(journaled):
        faults.append(f"resume drill: {resume}")
    requeues = [r["attrs"] for r in read_streams(obs_dir)
                if r.get("type") == "event" and r.get("name") == "scheduler.requeue"]
    workers = worker_records(read_streams(obs_dir))
    retry_platforms = sorted({w["platform"] for w in workers.values()
                              if w["platform"] == "cpu"})
    if sorted((r["model_id"], r["platform"]) for r in requeues) != [(0, "cpu"), (1, "cpu")] or \
            retry_platforms != ["cpu"]:
        faults.append(f"requeue events {requeues}, CPU workers {retry_platforms}")
    report["requeue_events"] = requeues
    report["faults"] = faults
    print(json.dumps(report))
    return 1 if faults else 0


def write_onramp_raw(folder: str, seed: int) -> dict:
    """The raw layouts ``data/real_onramp.prepare_all`` reads, under
    ``folder``, from ``seed``: the 15 MNIST-C corruption folders at the
    release's 10,000 test images each, a CIFAR-10-C release of
    ``ONRAMP_CIFAR``, the fmnist-C pair (10,000) and ``imdb/raw`` of
    English-like texts over the bundled thesaurus (``ONRAMP_TEXTS``).
    Returns the MNIST-C arrays by corruption."""
    from simple_tip_tpu_torch.data import real_onramp

    rng = np.random.default_rng(seed)
    n = real_onramp.OOD_SIZE
    mnist_c = {}
    for corr in real_onramp.MNIST_CORRUPTION_TYPES:
        sub = os.path.join(folder, "mnist_c", corr)
        os.makedirs(sub)
        mnist_c[corr] = (rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8),
                         rng.integers(0, 10, size=n).astype(np.int64))
        np.save(os.path.join(sub, "test_images.npy"), mnist_c[corr][0])
        np.save(os.path.join(sub, "test_labels.npy"), mnist_c[corr][1])
    names, rows = ONRAMP_CIFAR
    cifar = os.path.join(folder, "CIFAR-10-C")
    os.makedirs(cifar)
    np.save(os.path.join(cifar, "labels.npy"), rng.integers(0, 10, size=rows).astype(np.int64))
    for corr in names:
        np.save(os.path.join(cifar, f"{corr}.npy"),
                rng.integers(0, 256, size=(rows, 32, 32, 3), dtype=np.uint8))
    np.save(os.path.join(folder, "fmnist-c-test.npy"),
            rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8))
    np.save(os.path.join(folder, "fmnist-c-test-labels.npy"),
            rng.integers(0, 10, size=n).astype(np.int64))
    asset = os.path.join(os.path.dirname(image_corruptor.__file__), "assets",
                         "en_thesaurus.jsonl")
    with open(asset) as f:
        base_words = [json.loads(line)["word"] for line in f]
    n_train, n_test = ONRAMP_TEXTS
    texts, labels = synthetic.english_like_texts(seed, n_train + n_test, base_words=base_words)
    raw = os.path.join(folder, "imdb", "raw")
    os.makedirs(raw)
    for split, part in (("train", range(n_train)), ("test", range(n_train, n_train + n_test))):
        with open(os.path.join(raw, f"{split}.jsonl"), "w") as f:
            for i in part:
                f.write(json.dumps({"text": texts[i], "label": int(labels[i])}) + "\n")
    return mnist_c


def onramp_faults(folder: str, mnist_c: dict, report: dict, ood_x, n_test: int) -> list:
    """The onramp's results against what was written: every dataset built,
    each MNIST-C slice byte-equal to its corruption's rows (in the cache and,
    scaled as the loader scales it, in ``load_mnist``'s OOD set, ``ood_x``,
    whose first ``n_test`` rows before the seed-0 mix are the nominal set)."""
    from simple_tip_tpu_torch.data import real_onramp

    faults = [f"onramp {name}: {report.get(name)}" for name in
              ("mnist_c", "cifar10_c", "fmnist_c", "imdb") if report.get(name) != "built"]
    cache = np.load(os.path.join(folder, "mnist_c_images.npy"))
    labels = np.load(os.path.join(folder, "mnist_c_labels.npy"))
    unmixed = np.empty_like(ood_x)
    unmixed[np.random.default_rng(0).permutation(len(ood_x))] = ood_x
    loaded = unmixed[n_test:]
    per = -(-real_onramp.OOD_SIZE // len(real_onramp.MNIST_CORRUPTION_TYPES))
    for i, corr in enumerate(real_onramp.MNIST_CORRUPTION_TYPES):
        lo, hi = i * per, min(real_onramp.OOD_SIZE, (i + 1) * per)
        images, want_labels = mnist_c[corr][0][lo:hi], mnist_c[corr][1][lo:hi]
        if cache[lo:hi, ..., 0].tobytes() != images.tobytes() or \
                labels[lo:hi].tobytes() != want_labels.tobytes():
            faults.append(f"onramp mnist_c {corr}: the cache's slice differs from the written rows")
        if loaded[lo:hi].tobytes() != (images.astype("float32") / 255.0)[..., None].tobytes():
            faults.append(f"onramp mnist_c {corr}: load_mnist's rows differ from the written ones")
    return faults


def run_onramp(folder: str, data_dir: str, seed: int, dev) -> dict:
    """Phase 7d's onramp: the raw layouts written under ``folder`` with
    MNIST's nominal archive beside them, ``prepare_all`` on ``dev`` (IMDB's
    corruption on the card), then the loaders on ``folder``."""
    from simple_tip_tpu_torch.data import real_onramp

    mnist_c = write_onramp_raw(folder, seed)
    os.symlink(os.path.join(data_dir, "mnist.npz"), os.path.join(folder, "mnist.npz"))
    t0 = time.perf_counter()
    report = real_onramp.prepare_all(folder, device=dev)
    prepare_s = time.perf_counter() - t0
    with patched_env({"TIP_DATA_DIR": folder}):
        clear_loaders()
        try:
            presence = {name: loaders.dataset_presence(name) for name in ("mnist", "imdb")}
            _, (x_test, _), (ood_x, _) = loaders.load_mnist(device=dev)
            (imdb_train, _), (imdb_test, _), (imdb_ood, _) = loaders.load_imdb(device=dev)
        finally:
            clear_loaders()
    faults = onramp_faults(folder, mnist_c, report, ood_x, len(x_test))
    corrupted = np.load(os.path.join(folder, "imdb", "x_corrupted.npy"))
    n_train, n_test = ONRAMP_TEXTS
    if presence != {"mnist": "real", "imdb": "real"} or imdb_train.shape != (n_train, 100) or \
            imdb_test.shape != (n_test, 100) or imdb_ood.shape != (2 * n_test, 100) or \
            not (corrupted != imdb_test).any():
        faults.append(f"onramp loaders: {presence}, imdb {imdb_train.shape} {imdb_test.shape} "
                      f"{imdb_ood.shape}, changed tokens {int((corrupted != imdb_test).sum())}")
    return {"report": report, "prepare_s": prepare_s, "presence": presence,
            "imdb_changed_tokens": int((corrupted != imdb_test).sum()), "faults": faults}


def write_sched_data(data_dir: str, folder: str) -> None:
    """``mnist.npz`` of the first ``SCHED_DATA`` training and nominal rows of
    ``data_dir``'s archive (no corruption cache: the loader makes it)."""
    os.makedirs(folder, exist_ok=True)
    n_train, n_test = SCHED_DATA
    with np.load(os.path.join(data_dir, "mnist.npz")) as full:
        np.savez(os.path.join(folder, "mnist.npz"), x_train=full["x_train"][:n_train],
                 y_train=full["y_train"][:n_train], x_test=full["x_test"][:n_test],
                 y_test=full["y_test"][:n_test])


def run_sched_phase(data_dir: str, dev, root: str, seed: int) -> dict:
    """Phase 7d. (1) The watchdog on the card: ``probe_local_chips`` and
    ``ensure_responsive_backend``. (2) On the ``SCHED_DATA`` cut of MNIST,
    ``cli.main(... "--runs", "0,1", "--workers", "2")`` with
    ``TIP_WORKER_PLATFORMS=default,default`` on caches of the phase's own
    (the workers fit and store), each worker's stream under ``TIP_OBS_DIR``,
    then runs 0 and 1's in-process ``cli.main --phase test_prio`` walk on
    those caches (every SA fit a load): each run on one card worker, both at
    once, each worker launching B1 and B2, every artifact byte-equal to the
    in-process walk's, both runs journaled. (3) The drills in a fresh
    interpreter (``drills_main``). (4) The onramp (``run_onramp``)."""
    from simple_tip_tpu_torch.resilience import RunJournal
    from simple_tip_tpu_torch.utils import device_watchdog

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cards = device_watchdog.probe_local_chips()
    probe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    platform = device_watchdog.ensure_responsive_backend() if dev.type == "cuda" else "cpu"
    ensure_s = time.perf_counter() - t0
    watchdog = {"cards": cards, "probe_local_chips_s": probe_s, "platform": platform,
                "ensure_responsive_backend_s": ensure_s}
    print(json.dumps({"sched_watchdog": watchdog}))
    faults = [] if dev.type == "cpu" or (cards >= 1 and platform == "cuda") else [
        f"watchdog: {watchdog}"]

    family, src = SCHED_FAMILY, os.path.join(root, "train")
    inproc, sched = os.path.join(root, "sched_inproc"), os.path.join(root, "sched")
    for folder in (inproc, sched):
        shutil.copytree(os.path.join(src, "models", family), os.path.join(folder, "models", family))
    cut_dir = os.path.join(root, "sched_data")
    write_sched_data(data_dir, cut_dir)
    env = {"TIP_SA_CACHE_DIR": os.path.join(root, "sched_caches", "sa_fit_cache"),
           "TIP_COV_STATS_CACHE_DIR": os.path.join(root, "sched_caches", "coverage_stats_cache"),
           "TIP_DATA_DIR": cut_dir, "TIP_COMPUTE_DTYPE": None,
           "TIP_FUSED_CHAIN": None, "TIP_CHAIN_GROUP": None, "TIP_FAULT_PLAN": None}
    runs = ",".join(str(r) for r in SCHED_RUNS)
    clear_loaders()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the workers share the card with this process
    obs_dir = os.path.join(root, "sched_obs")
    with patched_env({**env, "TIP_ASSETS": sched, "TIP_OBS_DIR": obs_dir,
                      "TIP_WORKER_PLATFORMS": ",".join(["default"] * SCHED_WORKERS)}):
        obs.reset()
        t0 = time.perf_counter()
        run_cli("--phase", "test_prio", "--case-study", family, "--runs", runs,
                "--workers", str(SCHED_WORKERS), *device_args(dev))
        sched_s = time.perf_counter() - t0
        obs.reset()
    # the in-process reference walks, after the workers: their SA fits and
    # coverage statistics are the workers' entries, loaded
    with patched_env({**env, "TIP_ASSETS": inproc}):
        inproc_s, outcomes = {}, {}
        for run in SCHED_RUNS:
            t0 = time.perf_counter()
            with CacheRecorder() as recorder:
                run_cli("--phase", "test_prio", "--case-study", family, "--runs", str(run),
                        *device_args(dev))
            inproc_s[run] = time.perf_counter() - t0
            outcomes[run] = recorder.sa_outcomes
    clear_loaders()
    if any(o != "hit" for per_run in outcomes.values() for d in per_run for o in d.values()):
        faults.append(f"the in-process walks did not load the workers' SA fits: {outcomes}")
    records = read_streams(obs_dir)
    workers = worker_records(records)
    kernels = PATHS[family]["kernels"] if dev.type == "cuda" else ()
    faults += sched_faults(workers, SCHED_RUNS, kernels,
                           platform="default" if dev.type == "cuda" else "cpu")
    faults += artifact_faults(family, sched, {run: inproc for run in SCHED_RUNS})
    journaled = RunJournal(os.path.join(sched, "journal", "runs.jsonl"), family,
                           "test_prio").completed()
    if journaled != set(SCHED_RUNS):
        faults.append(f"journal holds {sorted(journaled)}, want {list(SCHED_RUNS)}")
    worker_s = {run: d for w in workers.values() for run, (_, d) in w["runs"].items()}
    scheduler = {"sched_phase": family, "runs": list(SCHED_RUNS), "workers": SCHED_WORKERS,
                 "scheduler_s": sched_s, "worker_run_s": worker_s,
                 "data": {"training": SCHED_DATA[0], "nominal": SCHED_DATA[1]},
                 "in_process_s": inproc_s,
                 "launches": {pid: w["launches"] for pid, w in workers.items() if w["runs"]},
                 "platforms": {pid: w["platform"] for pid, w in workers.items()}}
    print(json.dumps(scheduler))

    drill_root = os.path.join(root, "sched_drills")
    os.makedirs(drill_root)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.drills_main(sys.argv[1]))",
         drill_root], cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=SCHED_DRILL_TIMEOUT_S)
    drills_s = time.perf_counter() - t0
    lines = child.stdout.strip().splitlines()
    drills = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {
        "faults": [f"drills exited {child.returncode}: {child.stderr[-2000:]}"]}
    faults += drills["faults"] or ([] if child.returncode == 0 else
                                   [f"drills exited {child.returncode}"])
    print(json.dumps({"sched_drills": drills, "drills_s": drills_s}))

    onramp = run_onramp(os.path.join(root, "onramp"), data_dir, seed, dev)
    faults += onramp["faults"]
    print(json.dumps({"onramp": onramp}))
    record = {"watchdog": watchdog, "scheduler": scheduler, "drills_s": drills_s,
              "drills": {k: v for k, v in drills.items() if k != "faults"}, "onramp": onramp,
              "faults": faults, "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"sched_phase_s": record["phase_s"], "faults": faults}))
    if faults:
        raise AssertionError("study execution: " + "; ".join(faults[:20]))
    return record


# -- sequence parallelism and the full-study command (phase 7e of the docstring) --


def close_faults(got, want, what: str, rtol: float, atol: float) -> list:
    """``[what]`` unless |got - want| <= atol + rtol |want| everywhere (and
    the shapes agree)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if got.shape != want.shape:
        return [f"{what}: shape {tuple(got.shape)}, want {tuple(want.shape)}"]
    excess = float(((got - want).abs() - rtol * want.abs()).max())
    return [f"{what}: off by {excess} beyond rtol {rtol} + atol {atol}"] if excess > atol else []


def sp_output_faults(probs, taps: dict, want_probs, want_taps: dict, what: str) -> list:
    """A sequence-parallel forward's probabilities and taps 1-7 against the
    one-rank flash model's, within ``SP_RTOL`` / ``SP_ATOL``."""
    faults = close_faults(probs, want_probs, f"{what} probs", SP_RTOL, SP_ATOL)
    if sorted(taps) != sorted(want_taps):
        return faults + [f"{what}: taps {sorted(taps)}, want {sorted(want_taps)}"]
    for i in sorted(want_taps):
        faults += close_faults(taps[i], want_taps[i], f"{what} tap {i}", SP_RTOL, SP_ATOL)
    return faults


def gradient_faults(got: dict, want: dict, what: str) -> tuple:
    """(faults, max |got - want|) of an IMDB step's gradients, phase 6's
    tolerance: rtol 2e-4, atol per leaf 2e-4 of its largest |want| plus 1e-7
    of the model's largest, at most 2e-5."""
    if sorted(got) != sorted(want):
        return [f"{what}: gradients of {sorted(set(got) ^ set(want))} apart"], float("inf")
    floor = 1e-7 * max(float(torch.as_tensor(g).abs().max()) for g in want.values())
    faults, worst = [], 0.0
    for name, w in want.items():
        g, w = torch.as_tensor(got[name]).cpu(), torch.as_tensor(w).cpu()
        atol = min(2e-5, 2e-4 * float(w.abs().max()) + floor)
        faults += close_faults(g, w, f"{what} gradient {name}", 2e-4, atol)
        worst = max(worst, float((g - w).abs().max()))
    return faults, worst


def sp_launch_faults(launches: dict, what: str, kernels=SP_KERNELS) -> list:
    """A rank (``launches``: rank -> {kernel: launches}) that launched one of
    ``kernels`` no time."""
    return [f"{what}: rank {rank} launched {name} {counts.get(name, 0)} times"
            for rank, counts in sorted(launches.items()) for name in kernels
            if not counts.get(name, 0) > 0]


def imdb_step_gradients(net, x, y) -> dict:
    """{parameter: gradient} of one IMDB step's mean loss (``train=False``)."""
    probs, _ = net(x)
    loss = categorical_crossentropy(probs, F.one_hot(y, 2).float()).mean()
    names, tensors = zip(*net.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, tensors)))


def _sp_counts() -> dict:
    counts = read_counters()
    return {name: counts[name] for name in SP_KERNELS}


def sp_long_context(rank: int, group, seed: int, dev, shape: tuple) -> dict:
    """(b) of phase 7e on one rank of the 2-rank group: each core of
    ``SP_LONG_CORES`` forward and backward on this rank's shard of
    ``shape`` (once counted and checked, then timed), its output and
    gradients gathered; rank 0 then runs one-rank flash attention at the
    full length, times it and holds the cores' results against it."""
    rng = np.random.default_rng(seed + 7)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                     for _ in range(4))
    step = shape[1] // torch.distributed.get_world_size(group)
    local = [x[:, rank * step:(rank + 1) * step].contiguous() for x in (q, k, v, dout)]
    cores = {"ring": ring_attention, "ulysses": ulysses_attention}

    def fwd_bwd(core, args, grad_out):
        leaves = [x.detach().requires_grad_() for x in args]
        out = core(*leaves)
        return [out.detach(), *torch.autograd.grad(out, leaves, grad_out)]

    def timed(fn) -> float:
        fn()
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(SP_LONG_REPS):
            fn()
        synchronize(dev)
        return (time.perf_counter() - t0) * 1e3 / SP_LONG_REPS

    record, results = {}, {}
    for name in SP_LONG_CORES:
        core = cores[name]
        zero_counters()
        got = fwd_bwd(lambda a, b, c: core(a, b, c, group), local[:3], local[3])
        synchronize(dev)
        launches = _sp_counts()
        results[name] = [exchange.all_gather_seq(t.contiguous(), group) for t in got]
        torch.distributed.barrier(group)
        ms = timed(lambda: fwd_bwd(lambda a, b, c: core(a, b, c, group), local[:3], local[3]))
        record[name] = {"ms": ms, "launches": launches}
    if rank == 0:
        want = fwd_bwd(flash_attention.flash_attention, (q, k, v), dout)
        record["flash_one_rank_ms"] = timed(
            lambda: fwd_bwd(flash_attention.flash_attention, (q, k, v), dout))
        faults = []
        for name, got in results.items():
            for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
                scale = float(w.abs().max())
                tol = (SP_RTOL, SP_ATOL) if what == "out" else (1e-4, min(1e-5, 1e-4 * scale))
                faults += close_faults(g, w, f"long-context {name} {what}", *tol)
                record[name].setdefault("max_abs_err", {})[what] = float((g - w).abs().max())
        record["faults"] = faults
    return record


def sp_rank_main(rank: int, world: int, go: str, device_type: str, state: dict, x_pred, x_step,
                 y_step, seed: int, long_shape: tuple) -> dict:
    """(internal) One rank of phase 7e's spawned group on the card: (a) the
    IMDB model at full width on run 0's weights (``state``), each case of
    ``SP_CASES`` this rank is in, against the one-rank flash model it
    computes itself (counters zeroed around each case); (b) on the 2-rank
    group, ``sp_long_context``. The rank is spawned ahead of the phase and
    touches the card only once the file ``go`` exists (``SpGroup``).
    Returns faults, errors, launches, times and the exchanges staged
    through host memory."""
    timeline = {"entered": time.time()}
    deadline = time.monotonic() + SP_TIMEOUT_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError(f"phase 7e's go ({go}) did not come within {SP_TIMEOUT_S} s")
        time.sleep(0.05)
    timeline["go"] = time.time()
    dev = resolve(f"cuda:{rank % torch.cuda.device_count()}" if device_type == "cuda" else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    groups = {n: sequence_parallel_group(n) for n in sorted({n for _, n in SP_CASES})}

    def model(impl="dense", group=None):
        net = ImdbTransformer(attention_impl=impl, sp_group=group).to(dev).eval()
        net.load_state_dict(state)
        return net

    xp = torch.from_numpy(x_pred).to(dev)
    xs, ys = torch.from_numpy(x_step).to(dev), torch.from_numpy(y_step).to(dev)
    reference = model()
    with torch.no_grad():
        want_probs, want_taps = reference(xp)
    want_grads = imdb_step_gradients(reference, xs, ys)
    timeline["reference"] = time.time()
    cases, faults = {}, []
    for impl, n in SP_CASES:
        if rank >= n:
            continue
        net = model(impl, groups[n])
        what = f"{impl} over {n} ranks, rank {rank}"
        zero_counters()
        t0 = time.perf_counter()
        with torch.no_grad():
            probs, taps = net(xp)
        grads = imdb_step_gradients(net, xs, ys)
        synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = _sp_counts()
        faults += sp_output_faults(probs, taps, want_probs, want_taps, what)
        grad_faults, grad_err = gradient_faults(grads, want_grads, what)
        faults += grad_faults
        cases[f"{impl}{n}"] = {
            "launches": launches, "seconds": seconds, "gradient_max_abs_err": grad_err,
            "probs_max_abs_err": float((probs - want_probs).abs().max())}
    timeline["cases"] = time.time()
    long = sp_long_context(rank, groups[2], seed, dev, long_shape) if rank < 2 else {}
    faults += long.pop("faults", [])
    timeline["long"] = time.time()
    return {"cases": cases, "long": long, "faults": faults, "staged": dict(exchange.STAGED),
            "timeline": timeline}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sp_nccl_one_rank(state: dict, x_step, y_step, dev) -> dict:
    """The transport's choice where each rank has a card: NCCL at world size
    1 in this process (the one card), the ring model's step equal to the
    flash model's (n=1 exchanges nothing)."""
    backend = sp_backend(dev.type, 1)
    torch.distributed.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        nets = {}
        for impl, group in (("dense", None), ("ring", torch.distributed.group.WORLD)):
            nets[impl] = ImdbTransformer(attention_impl=impl, sp_group=group).to(dev).eval()
            nets[impl].load_state_dict(state)
        xs, ys = torch.from_numpy(x_step).to(dev), torch.from_numpy(y_step).to(dev)
        want = imdb_step_gradients(nets["dense"], xs, ys)
        got = imdb_step_gradients(nets["ring"], xs, ys)
    finally:
        torch.distributed.destroy_process_group()
    equal = all(torch.equal(got[k], want[k]) for k in want)
    record = {"backend": backend, "gradients_equal": equal}
    if dev.type == "cuda" and backend != "nccl" or not equal:
        raise AssertionError(f"sequence parallelism at world size 1: {record}")
    return record


def study_faults(outs: list, codes: list, records: list, runs) -> list:
    """What is wrong with a multi-host ``full_study`` run of ``runs`` (each
    host's standard output and exit code, the hosts' event streams): a host
    that failed, reported another share than its contiguous one, printed
    evaluation lines though it is not host 0 (or host 0 none), skipped a
    rendezvous, or host 0 aggregating before every host's phases ended."""
    n, faults = len(outs), []
    base_share, rem = divmod(len(runs), n)
    for i, (out, code) in enumerate(zip(outs, codes)):
        if code != 0:
            faults.append(f"host {i} exited {code}: {out[-1500:]}")
        share = f"host {i}/{n}: {base_share + (i < rem)}/{len(runs)} runs"
        if share not in out:
            faults.append(f"host {i} did not report '{share}'")
        if ("[evaluation:" in out) != (i == 0):
            faults.append(f"host {i} {'printed' if i else 'did not print'} evaluation lines")
    spans = [r for r in records if r.get("type") == "span"]
    phase_end = [r["ts"] + r["dur"] for r in spans
                 if r["name"] in ("training", "test_prio", "active_learning", "at_collection")]
    evaluated = [r["ts"] for r in spans if r["name"] == "evaluation"]
    met = {(r["attrs"]["rank"], r["attrs"]["barrier"]) for r in records
           if r.get("type") == "event" and r.get("name") == "barrier"}
    for rank in range(n):
        for when in ("pre", "post"):
            if (rank, f"full_study_{when}_evaluation") not in met:
                faults.append(f"host {rank} skipped the {when}-evaluation rendezvous")
    if not evaluated:
        faults.append("no evaluation span")
    elif phase_end and min(evaluated) < max(phase_end):
        faults.append(f"host 0 aggregated {max(phase_end) - min(evaluated):.3f} s before "
                      "every host's phases ended")
    return faults


def host_launches(records: list) -> dict:
    """Per process of the streams, the kernel launches of its last flushed
    metrics."""
    out = {}
    for rec in records:
        if rec.get("type") == "metrics":
            out[rec["pid"]] = {name[len("kernel."):-len(".launches")]: value
                               for name, value in rec.get("gauges", {}).items()
                               if name.startswith("kernel.") and name.endswith(".launches")}
    return out


class StudyHosts:
    """(c) of phase 7e: ``python -m simple_tip_tpu_torch.full_study`` as two
    hosts over a localhost coordinator on the one card, ``STUDY_FAMILY``'s
    runs ``STUDY_RUNS`` through test_prio and evaluation on phase 5's
    checkpoints (copied into a fresh ``TIP_ASSETS``), both caches phase 7's,
    the event streams in one ``TIP_OBS_DIR``. Started after the group's
    cases and timings, they run beside the phases that follow (their
    seconds are not a clean measure); ``finish`` checks them with
    ``study_faults``, run 0's artifacts byte-equal to phase 7's and run 1's
    complete."""

    hosts = 2

    def __init__(self, data_dir: str, dev, root: str):
        self.src = os.path.join(root, "train")
        self.study = os.path.join(root, "study")
        self.obs_dir = os.path.join(root, "study_obs")
        shutil.copytree(os.path.join(self.src, "models", STUDY_FAMILY),
                        os.path.join(self.study, "models", STUDY_FAMILY))
        env = {k: v for k, v in os.environ.items() if k not in (
            "TIP_FUSED_CHAIN", "TIP_CHAIN_GROUP", "TIP_FAULT_PLAN", "TIP_WORKER_PLATFORMS",
            "TIP_OBS_ROOT")}
        env.update(TIP_ASSETS=self.study, TIP_DATA_DIR=data_dir, TIP_OBS_DIR=self.obs_dir,
                   TIP_SA_CACHE_DIR=os.path.join(self.src, "sa_fit_cache"),
                   TIP_COV_STATS_CACHE_DIR=os.path.join(self.src, "coverage_stats_cache"))
        port = _free_port()
        runs = ",".join(str(r) for r in STUDY_RUNS)
        self.t0 = time.perf_counter()
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "simple_tip_tpu_torch.full_study", "--case-studies",
             STUDY_FAMILY, "--runs", runs, "--phases", "test_prio,evaluation", "--coordinator",
             f"localhost:{port}", "--num-processes", str(self.hosts), "--process-id", str(i),
             *device_args(dev)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__))) for i in range(self.hosts)]
        CHILDREN.extend(self.procs)

    def finish(self) -> dict:
        outs = [p.communicate(timeout=STUDY_TIMEOUT_S)[0] for p in self.procs]
        seconds = time.perf_counter() - self.t0
        records = read_streams(self.obs_dir)
        faults = study_faults(outs, [p.returncode for p in self.procs], records, STUDY_RUNS)
        faults += artifact_faults(STUDY_FAMILY, self.study, {0: self.src})
        with patched_env({"TIP_ASSETS": self.study}):
            missing = artifact_check.check_prio_artifacts(
                STUDY_FAMILY, STUDY_RUNS, PATHS[STUDY_FAMILY]["model"].has_dropout)
        if missing:
            faults.append(f"missing artifacts: {sorted(missing)[:5]}")
        spans = {f"{r['name']}:{r.get('attrs', {}).get('which') or r.get('attrs', {}).get('cs')}"
                 f":{r['pid']}": r["dur"] for r in records
                 if r.get("type") == "span" and r.get("depth") == 1}
        record = {"family": STUDY_FAMILY, "runs": list(STUDY_RUNS), "hosts": self.hosts,
                  "seconds": seconds,
                  "host_lines": [next((line for line in out.splitlines()
                                       if line.startswith("host ")), "") for out in outs],
                  "span_s": spans, "launches": host_launches(records), "faults": faults}
        print(json.dumps({"study_hosts": record}))
        if faults:
            raise AssertionError("full study: " + "; ".join(faults[:20]))
        return record


class SpGroup:
    """Phase 7e's ranks (``sp_rank_main``), spawned ahead of the phase: each
    starts its interpreter, imports torch and this script and joins the
    group while earlier phases run (the seconds that took are the
    timeline's ``spawn_to_entry``), then waits for ``finish`` to create its
    go file before it touches the card."""

    def __init__(self, state: dict, data, dev, root: str, seed: int):
        (x_tr, y_tr), (x_nom, _), _ = data
        self.state = state
        self.x_step = x_tr[:SP_STEP_ROWS].astype(np.int64)
        self.y_step = y_tr[:SP_STEP_ROWS].astype(np.int64)
        self.backend = sp_backend(dev.type, SP_WORLD)
        self.go = os.path.join(root, "sp_go")
        self.spawned = time.time()
        self.result = self.error = None
        args = (self.go, dev.type, state, x_nom[:PATHS["imdb"]["batch"]].astype(np.int64),
                self.x_step, self.y_step, seed, SP_LONG_SHAPE)
        self.thread = threading.Thread(target=self._run, args=(args,), daemon=True)
        self.thread.start()

    def _run(self, args) -> None:
        try:
            self.result = run_ranks(sp_rank_main, SP_WORLD, f"tcp://localhost:{_free_port()}",
                                    self.backend, args=args, timeout_s=SP_TIMEOUT_S)
        except BaseException as e:  # raised in finish, in the main thread
            self.error = e

    def finish(self) -> tuple:
        """(each rank's result, seconds from the go to the last result,
        the go's wall time)."""
        t0, wall0 = time.perf_counter(), time.time()
        with open(self.go, "w"):
            pass
        self.thread.join(SP_TIMEOUT_S)
        if self.thread.is_alive():
            raise AssertionError(f"phase 7e's ranks did not finish within {SP_TIMEOUT_S} s")
        if self.error is not None:
            raise self.error
        return self.result, time.perf_counter() - t0, wall0


def run_sp_phase(group: "SpGroup", dev) -> dict:
    """Phase 7e's (a) and (b) in the spawned group of ``SP_WORLD`` ranks on
    the card (``SpGroup``, ``sp_rank_main``), and the NCCL choice at world
    size 1 (``sp_nccl_one_rank``); (c) is ``StudyHosts``. Raises on any
    fault."""
    t_phase = time.perf_counter()
    ranks, group_s, wall0 = group.finish()
    backend = group.backend
    faults = [f for r in ranks for f in r["faults"]]
    launches = {}
    for rank, r in enumerate(ranks):
        for case, rec in r["cases"].items():
            launches.setdefault(case, {})[rank] = rec["launches"]
        for core in SP_LONG_CORES:
            if core in r["long"]:
                launches.setdefault(f"long_{core}2", {})[rank] = r["long"][core]["launches"]
    for case, by_rank in launches.items():
        faults += sp_launch_faults(by_rank, case, SP_KERNELS if dev.type == "cuda" else ())
    want_ranks = {f"{impl}{n}": n for impl, n in SP_CASES}
    want_ranks.update({f"long_{core}2": 2 for core in SP_LONG_CORES})
    for case, n in want_ranks.items():
        if len(launches.get(case, {})) != n:
            faults.append(f"{case}: {len(launches.get(case, {}))} ranks reported, want {n}")
    long = ranks[0]["long"]
    b, t, h, dh = SP_LONG_SHAPE
    pairs, io, rows = b * h * t * t * dh, 4 * b * t * h * dh, 4 * 2 * b * h * t
    bound = sum(bound_ms(flops, nbytes, "3xtf32")[0] for flops, nbytes in (
        (2 * 2 * pairs, 4 * io + 4 * b * h * t), (3 * 2 * pairs, 5 * io + rows),
        (4 * 2 * pairs, 6 * io + rows)))
    long_record = {
        "shape": list(SP_LONG_SHAPE), "reps": SP_LONG_REPS,
        "flash_one_rank_ms": long.get("flash_one_rank_ms"), "bound_ms": bound,
        **{core: {"ms_by_rank": [r["long"][core]["ms"] for r in ranks[:2]],
                  "max_abs_err": long.get(core, {}).get("max_abs_err")}
           for core in SP_LONG_CORES}}
    staged = {rank: r["staged"] for rank, r in enumerate(ranks)}
    # Seconds from the go to each rank's seeing it, its groups and one-rank
    # reference, its cases and its long-context part; and from the spawn to
    # its entry (interpreter, imports, the group formed).
    timeline = {rank: {"spawn_to_entry": r["timeline"].pop("entered") - group.spawned,
                       **{k: t - wall0 for k, t in r["timeline"].items()}}
                for rank, r in enumerate(ranks)}
    group_record = {"world": SP_WORLD, "backend": backend, "group_s": group_s,
                    "timeline_s": timeline,
             "cases": {rank: r["cases"] for rank, r in enumerate(ranks)},
             "launches": launches, "staged": staged}
    print(json.dumps({"sp_group": group_record}))
    print(json.dumps({"sp_long_context": long_record}))
    one_rank = sp_nccl_one_rank(group.state, group.x_step, group.y_step, dev)
    print(json.dumps({"sp_one_rank": one_rank}))
    record = {"group": group_record, "long_context": long_record, "one_rank": one_rank,
              "faults": faults, "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"sp_phase_s": record["phase_s"], "faults": faults}))
    if faults:
        raise AssertionError("sequence parallelism: " + "; ".join(faults[:20]))
    return record


# -- the observability and planning plane (phase 7f of the docstring) -------------


def share_faults(programs: dict, peaks: dict) -> list:
    """(a)'s gate: each program's analytic cost graded at its fastest
    dispatch (``fastest_s``) against ``peaks``. A program that cannot be
    graded (no peak, no cost, no dispatch) is a fault, and so is an MFU or
    HBM fraction above ``OBS_SHARE_CAP``: the card cannot beat its peak, so
    the count would be wrong."""
    faults = [] if programs else ["no program was graded"]
    for name, entry in sorted(programs.items()):
        graded = devicemeter.grade(entry.get("cost"), entry.get("fastest_s"), peaks=peaks)
        for key in ("mfu", "hbm_frac"):
            value = graded[key]
            if value is None:
                faults.append(f"{name}: {key} cannot be graded ({graded['peak_label']}, "
                              f"cost {entry.get('cost')}, fastest {entry.get('fastest_s')})")
            elif value > OBS_SHARE_CAP:
                faults.append(f"{name}: {key} {value:.4f} above {OBS_SHARE_CAP}")
    return faults


def device_events(spliced: list, window: tuple) -> list:
    """The spliced device events (``OBS_DEVICE_CATS``) that overlap
    ``window`` ([start, end] in the export's microseconds)."""
    start, end = window
    return [e for e in spliced
            if e.get("cat") in OBS_DEVICE_CATS and isinstance(e.get("ts"), (int, float))
            and e["ts"] <= end and e["ts"] + float(e.get("dur") or 0) >= start]


def trace_faults(spliced: list, window: tuple) -> list:
    """(b)'s gate: device kernel events inside the span's window, B1's
    among them."""
    inside = device_events(spliced, window)
    if not any(e.get("cat") == "kernel" for e in inside):
        return [f"no device kernel event in the span's window {window} "
                f"({len(spliced)} spliced events)"]
    if not any(OBS_B1_KERNEL in str(e.get("name")) for e in inside):
        return [f"no {OBS_B1_KERNEL} event among the {len(inside)} device events of the window"]
    return []


def busy_share(events: list, window: tuple) -> float:
    """The share of ``window`` in which at least one of ``events`` (device
    events) ran: their union, clipped to the window, over its length."""
    start, end = window
    spans = sorted((max(start, e["ts"]), min(end, e["ts"] + float(e.get("dur") or 0)))
                   for e in events)
    busy, reach = 0.0, start
    for lo, hi in spans:
        lo = max(lo, reach)
        if hi > lo:
            busy += hi - lo
            reach = hi
    return busy / (end - start) if end > start else 0.0


def store_faults(rows: list) -> list:
    """(c)'s gate on the refreshed index: rows of a non-TPU platform with
    positive seconds."""
    if any(r.get("platform") and str(r["platform"]).lower() != "tpu"
           and isinstance(r.get("seconds"), (int, float)) and r["seconds"] > 0 for r in rows):
        return []
    return [f"the index holds no row of a non-TPU platform with positive seconds "
            f"({len(rows)} rows)"]


def plan_faults(codes: list, files: list) -> list:
    """(c)'s gate on ``plan suggest`` run twice: byte-identical files, or
    exit 3 (insufficient corpus) both times."""
    if codes == [3, 3]:
        return []
    if codes == [0, 0] and files[0] and files[0] == files[1]:
        return []
    return [f"plan suggest twice: exits {codes}, files "
            f"{'identical' if files[0] == files[1] else 'differ'}"]


def _read_bytes(path: str):
    """The file's bytes, or None when it is not there."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _dispatch_s(fn, dev) -> float:
    """Seconds of one call of ``fn``: CUDA events on the card, the host
    clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def obs_walk(runner, fused: dict, x: np.ndarray, dev, device_info: tuple) -> None:
    """The graded walk: the chain over every badge of ``x`` (each dispatch
    graded inside the runner), then B1 over the same rows in launches of
    ``OBS_B1_ROWS``, each graded against its analytic cost."""
    runner.score_dataset(x)
    xs = to_device(x, dev)
    platform, kind, count = device_info
    for start in range(0, xs.shape[0], OBS_B1_ROWS):
        xb = xs[start:start + OBS_B1_ROWS]
        devicemeter.record_program_cost("fused_forward", {
            "flops": float(conv_net_forward_flops(OBS_FAMILY) * xb.shape[0]),
            "bytes_accessed": float(xb.numel() * 4 + xb.shape[0] * 10 * 4)})
        with torch.no_grad():
            dt = _dispatch_s(lambda: fused_forward.fused_mnist_probs(fused, xb), dev)
        devicemeter.observe_dispatch("fused_forward", dt, platform=platform, device_kind=kind,
                                     cores=count)


def run_obs_phase(params, data, dev, root: str, smi: str) -> dict:
    """Phase 7f: (c) the feature store, cost model and planner over phases
    7d and 7e's streams, (d) one alert tick over the live registry, then (a)
    the device meter over MNIST run 0's chain walk and B1, and (b) the same
    walk traced and spliced. Returns the ``{"obs": ...}`` record."""
    from simple_tip_tpu_torch.obs import alerts, slo, splice, store
    from simple_tip_tpu_torch.obs.cli import load_events
    from simple_tip_tpu_torch.utils import maybe_trace

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    faults, record = [], {}

    # (c) the store, the cost model's quote and the planner, as operators run them
    index = os.path.join(root, "obs_index")
    sources = [os.path.join(root, d) for d in ("sched_obs", "study_obs", "sched_drills")]
    report = store.refresh(sources, index)
    rows = store.load_rows(index)
    faults += store_faults(rows)

    def module_cli(module, *argv):
        return subprocess.run([sys.executable, "-m", module, *argv], cwd=here,
                              capture_output=True, text=True, timeout=120)

    pred = module_cli("simple_tip_tpu_torch.obs", "predict", "--phases", "test_prio",
                      "--runs", "100", "--index", index, "--json")
    if pred.returncode not in (0, 3):
        faults.append(f"obs predict exited {pred.returncode}: {pred.stderr[-500:]}")
    predicted = json.loads(pred.stdout) if pred.stdout.strip().startswith("{") else None
    plans = [os.path.join(root, f"plan_{k}.json") for k in "ab"]
    suggested = [module_cli("simple_tip_tpu_torch.plan", "suggest", "--phases", "test_prio",
                            "--runs", "100", "--index", index, "-o", path) for path in plans]
    codes = [r.returncode for r in suggested]
    files = [_read_bytes(path) for path in plans]
    faults += plan_faults(codes, files)
    record["store"] = {"sources": report["sources"], "rows": len(rows),
                       "platforms": sorted({str(r.get("platform")) for r in rows}),
                       "phases": sorted({str(r.get("phase")) for r in rows})[:40]}
    record["predict"] = {"exit": pred.returncode,
                         "outcome": "estimate" if pred.returncode == 0 else "insufficient corpus",
                         "total_s": (predicted or {}).get("total_s"),
                         "basis": {p: i.get("basis") for p, i in
                                   ((predicted or {}).get("by_phase") or {}).items()}}
    record["plan"] = {"exits": codes, "identical": bool(files[0]) and files[0] == files[1],
                      "plan_id": json.loads(files[0])["plan_id"] if codes[0] == 0 and files[0]
                      else None}

    # (d) the bundled SLO rules and one tick over the registry phases 7c-12 left
    with patched_env({"TIP_ASSETS": os.path.join(root, "obs_assets"), "TIP_ALERT_RULES": None,
                      "TIP_ALERT_STATE": os.path.join(root, "alerts"), "TIP_OBS_INDEX": index,
                      "TIP_ALERT_SINKS": "jsonl"}):
        slo.write_default_rules()
        alerts.reset()
        alerts.tick()
        evaluator = alerts.get(create=False)
        record["alerts"] = ({r["rule"]: r["state"] for r in evaluator.view()["rules"]}
                            if evaluator is not None else None)
        alerts.reset()
    if record["alerts"] is None:
        faults.append("the alert evaluator did not mount under the bundled rules")

    # (a) the device meter, on a fresh registry
    obs_dir = os.path.join(root, "obs_7f")
    cfg = PATHS[OBS_FAMILY]
    with patched_env({"TIP_OBS_DIR": obs_dir, "TIP_PROFILE_DIR": None,
                      "TIP_ASSETS": os.path.join(root, "train")}):
        obs.reset_all()
        devicemeter.reset()
        device_info = devicemeter.detect_device(dev)
        platform, kind, count = device_info
        peaks = devicemeter.resolve_peaks(platform, kind, count)
        if dev.type == "cuda" and (platform != "gpu" or kind != torch.cuda.get_device_name(dev)
                                   or peaks.get("analytic_only")):
            faults.append(f"detect_device {device_info} / peaks {peaks} are not the card's")
        runner = FusedChainRunner(cfg["model"](), params, data[0][0], cfg["nc"],
                                  batch_size=cfg["batch"], device=dev)
        fused = BaseModel(cfg["model"](), params, device=dev).fused
        x = data[1][0]
        b1_before = fused_forward.LAUNCHES
        t0 = time.perf_counter()
        obs_walk(runner, fused, x, dev, device_info)
        synchronize(dev)
        walk_s = time.perf_counter() - t0
        b1_launches = fused_forward.LAUNCHES - b1_before
        if dev.type == "cuda" and b1_launches <= 0:
            faults.append("B1 did not launch in the graded walk")
        programs = {}
        for name in ("chain", "fused_forward"):
            window = obs.quantile(f"run_program.dispatch_s.{name}")
            programs[name] = {"cost": devicemeter.program_cost(name), "dispatch_s": window.summary(),
                              "fastest_s": window.percentile(0)}
        faults += share_faults(programs, peaks)
        doc = devicemeter.build_breakdown(
            {n: {"cost": e["cost"], "dispatch_s": e["dispatch_s"]} for n, e in programs.items()},
            platform, kind, cores=count)
        roofline = devicemeter.rows_from_breakdown(doc)
        record["device"] = {"platform": platform, "kind": kind, "count": count,
                            "peaks": peaks, "gpu": smi}
        record["roofline"] = roofline
        record["cost_basis"] = OBS_COST_BASIS
        record["fastest_grades"] = {
            n: {k: devicemeter.grade(e["cost"], e["fastest_s"], peaks=peaks)[k]
                for k in ("mfu", "hbm_frac", "bound")} for n, e in programs.items()}
        record["walk"] = {"rows": int(x.shape[0]), "seconds": walk_s,
                          "chain_dispatches": runner.chain_dispatches, "b1_launches": b1_launches}
        print(smi)
        print(devicemeter.render_roofline(roofline, header=f"roofline of phase 7f on {smi}"))

        # (b) the same walk traced, spliced under its span
        with patched_env({"TIP_PROFILE_DIR": os.path.join(root, "profile")}):
            t0 = time.perf_counter()
            with maybe_trace("chain_walk"):
                obs_walk(runner, fused, x, dev, device_info)
            traced_s = time.perf_counter() - t0
        obs.reset()  # closes the stream: every record on disk
    events, _files, _bad = load_events(obs_dir)
    span = next((r for r in events if r.get("type") == "span" and r.get("name") == "chain_walk"),
                None)
    trace = {"traced_walk_s": traced_s}
    if span is None:
        faults.append("no chain_walk span in the event stream")
    else:
        t0 = min(r["ts"] for r in events if isinstance(r.get("ts"), (int, float)))
        spliced, lines = splice.splice(events, t0)
        window = ((span["ts"] - t0) * 1e6, (span["ts"] + span["dur"] - t0) * 1e6)
        faults += trace_faults(spliced, window)
        inside = device_events(spliced, window)
        started = ((span["attrs"].get("xla_started_ts") or span["ts"]) - t0) * 1e6
        traced = (started, max([e["ts"] + float(e.get("dur") or 0) for e in inside] or [started]))
        trace.update({
            "splice": lines, "spliced_events": len(spliced), "device_events": len(inside),
            "kernel_events": sum(e.get("cat") == "kernel" for e in inside),
            "b1_events": sum(OBS_B1_KERNEL in str(e.get("name")) for e in inside),
            "span_window_ms": (window[1] - window[0]) / 1e3,
            "busy_share_of_span_window": busy_share(inside, window),
            "traced_window_ms": (traced[1] - traced[0]) / 1e3,
            "busy_share_of_traced_window": busy_share(inside, traced),
            "label": "device busy share of this one traced window only, not a study's idle share",
        })
    record["trace"] = trace
    record["phase_s"] = time.perf_counter() - t_phase
    record["faults"] = faults
    print(json.dumps({"obs": record, "gpu": smi}))
    if faults:
        raise AssertionError("observability plane: " + "; ".join(faults[:20]))
    return record


# -- the bf16 scoring mode (phase 7g of the docstring) ---------------------------------


def _bf16_net(family: str, params, dev):
    net = PATHS[family]["model"](compute_dtype="bfloat16").to(dev).eval()
    net.load_state_dict(params["module"])
    return net


def check_fused_forward_bf16(family: str, params, x_np: np.ndarray, dev) -> dict:
    """B1 or B3 in bf16 on ``x_np`` against its plain version (within
    BF16_FUSED_MAX, BF16_FUSED_MEAN, BF16_FUSED_ROWS, BF16_ARGMAX_SHARE),
    the float32 kernel and the bf16 module (cuDNN bf16;
    within BF16_MODE_MAX, BF16_MODE_MEAN and BF16_ARGMAX_SHARE); its times
    eager and from a CUDA graph, the plain version's and the bf16 module
    forward's (the library yardstick)."""
    if family == "mnist":
        name, kernel, plain, f32 = ("fused_mnist_forward_bf16", fused_forward.fused_mnist_probs_bf16,
                                    fused_forward.fused_mnist_probs_bf16_plain,
                                    fused_forward.fused_mnist_probs)
        replaces, bf_ops = "simple_tip_tpu/ops/fused_forward.py:60", ("w2_bf",)
    else:
        name, kernel, plain, f32 = ("fused_cifar10_forward_bf16",
                                    fused_forward.fused_cifar10_probs_bf16,
                                    fused_forward.fused_cifar10_probs_bf16_plain,
                                    fused_forward.fused_cifar10_probs)
        replaces, bf_ops = "simple_tip_tpu/ops/fused_forward.py:153", ("w1_bf", "w2_bf", "w3_bf")
    fused = {k: v.to(dev) for k, v in params["fused"].items()}
    net = _bf16_net(family, params, dev)
    x = torch.from_numpy(x_np).to(dev)
    with torch.no_grad():
        got = kernel(fused, x)
        want = plain(fused, x)
        module = net(x)[0]
        f32_probs = f32(fused, x)
    torch.cuda.synchronize()
    d = (got - want).abs()
    err, mean = float(d.max()), float(d.mean())
    rows = int((d > 1e-4).any(dim=1).sum())
    argmax = int((got.argmax(1) != want.argmax(1)).sum())
    mode = {}
    for other, probs in (("bf16_module", module), ("f32_kernel", f32_probs)):
        d = (got - probs).abs()
        mode[other] = {"max": float(d.max()), "mean": float(d.mean()),
                       "argmax_apart": int((got.argmax(1) != probs.argmax(1)).sum())}
    b = got.shape[0]
    if not (err <= BF16_FUSED_MAX and mean <= BF16_FUSED_MEAN and rows <= BF16_FUSED_ROWS * b
            and argmax <= BF16_ARGMAX_SHARE * b) or any(
            m["max"] > BF16_MODE_MAX or m["mean"] > BF16_MODE_MEAN
            or m["argmax_apart"] > BF16_ARGMAX_SHARE * b for m in mode.values()):
        raise AssertionError(f"{name}: from its plain version max {err}, mean {mean}, {rows} "
                             f"images above 1e-4, {argmax} classes apart; against the bf16 "
                             f"module and the float32 kernel {mode}")
    with torch.no_grad():
        ms = cuda_ms(lambda: kernel(fused, x), 20)
        device = graph_ms(lambda: kernel(fused, x), 20)
        plain_ms = cuda_ms(lambda: plain(fused, x), 3)
        library_ms = cuda_ms(lambda: net(x), 20)
    b = x.shape[0]
    if family == "mnist":  # conv2 at the 10x10 the floor pool needs, so conv1 at 24x24
        work = [(b * 2 * 24 * 24 * 32 * 9, "f32"), (b * 2 * 10 * 10 * 64 * 288, "bf16"),
                (b * 2 * 1600 * 10, "f32")]
        weights = ("w1", "b1", "b2", "wd", "bd")
    else:  # the convs at the positions the floor pools need: 28x28, 12x12, 4x4
        work = [(b * 2 * (28 * 28 * 32 * 27 + 12 * 12 * 64 * 288 + 4 * 4 * 64 * 576), "bf16"),
                (b * 2 * (1024 * 64 + 64 * 10), "f32")]
        weights = ("b1", "b2", "b3", "wd1", "bd1", "wd2", "bd2")
    # images read and probabilities written once, the weights the kernel reads once
    nbytes = b * (x[0].numel() + 10) * 4 + sum(
        fused[k].numel() * fused[k].element_size() for k in (*weights, *bf_ops))
    bound, by = mixed_bound_ms(work, nbytes)
    return {
        "name": name, "route": "cuda", "source": f"simple_tip_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "timed": f"one launch over {b} images (bf16 scoring mode)",
        "max_abs_err": err, "mean_abs_err": mean, "images_above_1e-4": rows,
        "classes_apart": argmax, "vs_bf16_module": mode["bf16_module"],
        "vs_f32_kernel": mode["f32_kernel"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "bound_unit": "convolutions in bf16 on the tensor cores (989.4 TF/s); conv1 (B1) and "
                      "the dense layers on float32 FMAs, 67 TF/s",
        "library_ms": library_ms, "library": "the bf16 module forward (cuDNN bf16)",
        "device_ms": device,
    }


def _bf16_close(got, want, lse, want_lse, what: str) -> tuple:
    """(max |out - want|, outputs apart); raises unless every output is
    within one bf16 ulp at the largest |want|, their mean |difference|
    within BF16_MEAN_ULPS of that ulp, and lse within 1e-5 + 1e-5 |lse|."""
    diff = (got.float() - want.float()).abs()
    ulp = 2.0 ** (float(torch.floor(torch.log2(want.float().abs().max()))) - 7)
    apart = int((diff > 0).sum())
    lse_excess = float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max())
    if float(diff.max()) > ulp or float(diff.mean()) > BF16_MEAN_ULPS * ulp or \
            lse_excess > 1e-5:
        raise AssertionError(f"bf16 flash attention {what}: max |d| {float(diff.max())} "
                             f"(ulp {ulp}), mean {float(diff.mean())}, {apart} of "
                             f"{diff.numel()} apart, lse {lse_excess}")
    return float(diff.max()), apart


def bf16_route_counts() -> dict:
    """The bf16 flash forward's launches by route (not in COUNTERS, which
    count kernels: these split one kernel's launches)."""
    tile = flash_attention.BF16_TILE_LAUNCHES
    return {"tile": tile, "two_pass": flash_attention.BF16_LAUNCHES - tile}


def check_flash_attention_bf16(params, tokens: np.ndarray, dev, seed: int) -> dict:
    """B4 in bf16 against its plain version: the bf16 q/k/v of a real IMDB
    bf16 forward over one prediction batch (timed) and a ragged shape on
    the one-tile route, a shape of the two-pass route; each shape's route
    counter must move by one."""
    net = _bf16_net("imdb", params, dev)
    attn = net.block.attention
    with torch.no_grad():
        emb = net.embedding(to_device(tokens[:PREDICT_BATCH], dev))
        b, t, _ = emb.shape
        q, k, v = (F.linear(emb, p.weight.bfloat16()).add(p.bias.bfloat16()).reshape(
            b, t, attn.num_heads, attn.head_dim) for p in (attn.query, attn.key, attn.value))
    rng = np.random.default_rng(seed)

    def normal(*shapes):
        return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).bfloat16()
                for shape in shapes]

    cases = (("imdb", (q, k, v)),
             ("ragged", normal((3, 37, 2, 32), (3, 53, 2, 32), (3, 53, 2, 32))),
             ("two_pass", normal(*[(2, 200, 2, 64)] * 3)))
    err, apart, routes = 0.0, {}, {}
    for name, (qq, kk, vv) in cases:
        before = bf16_route_counts()
        out, lse = flash_attention.flash_attention_fwd(qq, kk, vv)
        want_out, want_lse = flash_attention.flash_attention_bf16_plain(qq, kk, vv)
        torch.cuda.synchronize()
        moved = {r: n - before[r] for r, n in bf16_route_counts().items()}
        routes[name] = flash_attention.bf16_route(qq.shape[1], kk.shape[1], qq.shape[3])
        if dev.type == "cuda" and moved != {r: int(r == routes[name]) for r in moved}:
            raise AssertionError(f"bf16 flash attention {name}: route counters moved {moved}, "
                                 f"want one {routes[name]} launch")
        e, apart[name] = _bf16_close(out, want_out, lse, want_lse, name)
        err = max(err, e)
    if routes["two_pass"] != "two_pass" or routes["imdb"] != "tile":
        raise AssertionError(f"bf16 flash attention routes {routes}: both must be held")
    h, dh = attn.num_heads, attn.head_dim
    qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))

    def kernel():
        return flash_attention.flash_attention_fwd(q, k, v)

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh)

    with torch.no_grad():
        ms, device = cuda_ms(kernel, 20), graph_ms(kernel, 20)
        plain_ms = cuda_ms(lambda: flash_attention.flash_attention_bf16_plain(q, k, v), 5)
        library_ms = cuda_ms(library, 20)
    # two products of 2*dh FLOPs per (query, key) pair at the bf16 rate; q, k, v
    # read and out written once in bf16, lse written once in float32
    bound, by = bound_ms(4 * b * h * t * t * dh, 2 * 4 * b * t * h * dh + 4 * b * h * t, "bf16")
    print(f"flash_attention_fwd_bf16 timed at q/k/v [{b}, {t}, {h}, {dh}]")
    return {
        "name": "flash_attention_fwd_bf16", "route": "cuda",
        "source": "simple_tip_tpu_torch/csrc/flash_attention_fwd_bf16.cu",
        "replaces": "simple_tip_tpu/ops/flash_attention.py:58",
        "timed": f"one launch at one prediction batch, bf16 q/k/v [{b}, {t}, {h}, {dh}]; "
                 "library: scaled_dot_product_attention on bf16",
        "max_abs_err": err, "outputs_apart": apart, "routes": routes,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "bound_unit": UNITS["bf16"][1], "library_ms": library_ms, "device_ms": device,
    }


def bf16_cache_faults(family: str, tree, x_train: np.ndarray, bf16_root: str,
                      f32_root: str, dev) -> list:
    """Phase 7g (c): the bf16 run's SA entries are all under the bf16 key,
    none under the float32 key phase 7 wrote, and phase 7's directory holds
    no bf16 entry (an f32 fit never serves the bf16 run, nor the reverse)."""
    sa = PATHS[family]["sa"]
    fp32 = sa_prep.train_fingerprint(tree, x_train, sa)[:16]
    fp16 = sa_prep.train_fingerprint(tree, x_train, sa, "bfloat16")[:16]
    faults = [] if fp32 != fp16 else ["the bf16 and float32 SA keys are equal"]
    bf16_entries = os.listdir(os.path.join(bf16_root, "sa_fit_cache"))
    f32_entries = os.listdir(os.path.join(f32_root, "sa_fit_cache"))
    mine = [e for e in bf16_entries if e.startswith(f"{family}_0_")]
    if len(mine) != len(SA_NAMES) or any(fp16 not in e for e in mine):
        faults.append(f"bf16 SA entries {sorted(mine)}, want {len(SA_NAMES)} under {fp16}")
    if not any(fp32 in e for e in f32_entries):
        faults.append(f"phase 7 holds no float32 entry under {fp32}")
    if any(fp32 in e for e in bf16_entries) or any(fp16 in e for e in f32_entries):
        faults.append("a bf16 and a float32 SA entry share a directory's key")
    with patched_env({"TIP_SA_CACHE_DIR": os.path.join(f32_root, "sa_fit_cache")}):
        cache = sa_prep.SAFitCache.from_env(family, 0, tree, x_train, sa, dev,
                                            compute_dtype="bfloat16")
        if cache.load("dsa") is not None:
            faults.append("phase 7's float32 DSA entry served the bf16 key")
    return faults


def run_bf16_path(family: str, root: str, data, dev, f32_apfd: dict,
                  data_dir: str = None) -> dict:
    """``TIP_COMPUTE_DTYPE=bfloat16 cli.main --phase test_prio`` for run 0
    in a fresh TIP_ASSETS holding run 0's checkpoint, the counters set to
    0 just before and read just after; every artifact checked for name,
    dtype and shape; APFD beside phase 7's float32 APFD."""
    cfg = BF16_PATHS[family]
    assets = os.path.join(root, f"bf16_{family}")
    shutil.copytree(os.path.join(root, "train", "models", family),
                    os.path.join(assets, "models", family))
    env = {"TIP_ASSETS": assets, "TIP_COMPUTE_DTYPE": "bfloat16", "TIP_SA_CACHE_DIR": None,
           "TIP_COV_STATS_CACHE_DIR": None, "TIP_CHAIN_GROUP": None,
           "TIP_FUSED_CHAIN": "1" if cfg["fused_chain"] else None}
    if data_dir:
        env["TIP_DATA_DIR"] = data_dir
        clear_loaders()
    with patched_env(env):
        zero_counters()
        routes0 = bf16_route_counts()
        t0 = time.perf_counter()
        [(phases, _)] = run_cli("--phase", "test_prio", "--case-study", family, "--runs", "0",
                                *device_args(dev)).values()
        seconds = time.perf_counter() - t0
        launches = read_counters()
        routes = {r: n - routes0[r] for r, n in bf16_route_counts().items()}
        art, _ = read_artifacts(family, {"nominal": len(data[1][1]), "ood": len(data[2][1])})
    if data_dir:
        clear_loaders()
    faults = []
    if dev.type == "cuda":  # the CPU runs the plain versions: no kernel launches there
        faults += [f"{name} was not launched" for name in cfg["kernels"] if launches[name] <= 0]
        faults += [f"the float32 {name} was launched {launches[name]} times"
                   for name in cfg["not_launched"] if launches[name]]
        b4 = launches["flash_attention_fwd_bf16"]
        if "flash_attention_fwd_bf16" in cfg["kernels"] and (
                routes["tile"] <= 0 or sum(routes.values()) != b4):
            faults.append(f"the bf16 flash forward's routes {routes} do not make its {b4} "
                          "launches, or skip the tile route")
    apfd = apfd_report(art)
    record = {"bf16_path": family, "fused_chain": cfg["fused_chain"], "slice_s": seconds,
              "phases_s": phases, "launches": launches, "b4_bf16_routes": routes,
              "apfd": apfd, "f32_apfd": f32_apfd,
              "rows": {"nominal": len(data[1][1]), "ood": len(data[2][1])}}
    print(json.dumps(record))
    if faults:
        raise AssertionError(f"bf16 {family}: " + "; ".join(faults))
    return {**record, "assets": assets}


def run_bf16_phase(params: dict, trees: dict, data: dict, dev, root: str, paths: dict) -> dict:
    """Phase 7g: (a) B1, B3 and B4 in bf16 on the trained weights against
    their plain versions, timed; (b) the bf16 scoring mode end to end:
    MNIST run 0 at full size, CIFAR-10 run 0 on its PATH_CUTS cut (phase 7's),
    IMDB run 0 under the fused chain; (c) the caches' dtype tag."""
    t_phase = time.perf_counter()
    x_cifar = data["cifar10"][0][0][:10_000]
    kernels = [check_fused_forward_bf16("mnist", params["mnist"], data["mnist"][1][0], dev),
               check_fused_forward_bf16("cifar10", params["cifar10"], x_cifar, dev),
               check_flash_attention_bf16(params["imdb"], data["imdb"][1][0], dev, 0)]
    runs = {"mnist": run_bf16_path("mnist", root, data["mnist"], dev, paths["mnist"]["apfd"]),
            "imdb": run_bf16_path("imdb", root, data["imdb"], dev, paths["imdb"]["apfd"])}
    cut_dir = path_cut("cifar10", os.path.join(root, "datasets"), root)
    with patched_env({"TIP_DATA_DIR": cut_dir}):
        clear_loaders()
        (x_tr, y_tr), nominal, ood = loaders.load_cifar10(device=dev)
    cut = ((x_tr, y_tr), nominal, ood)
    runs["cifar10"] = run_bf16_path("cifar10", root, cut, dev, paths["cifar10"]["apfd"],
                                    data_dir=cut_dir)
    faults = bf16_cache_faults("mnist", trees["mnist"], data["mnist"][0][0],
                               runs["mnist"]["assets"], os.path.join(root, "train"), dev)
    record = {"kernels": kernels, "runs": {f: {k: v for k, v in r.items() if k != "assets"}
                                           for f, r in runs.items()},
              "cache_faults": faults, "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"bf16_phase_s": record["phase_s"], "cache_faults": faults}))
    if faults:
        raise AssertionError("bf16 caches: " + "; ".join(faults))
    return record


def al_spec(data):
    """MNIST's registry study for the AL phase: one-epoch retrains and the
    registry's AL settings (checked), its training base cut to the first
    ``AL_TRAIN_ROWS`` rows of its loader's and its nominal and OOD sets to
    their first ``AL_TEST_ROWS`` (the OOD set is shuffled, so the cut keeps
    its mix)."""
    (x_tr, y_tr), (x_nom, y_nom), (x_ood, y_ood) = data
    n_nom, n_ood = AL_TEST_ROWS
    cut = ((x_tr[:AL_TRAIN_ROWS], y_tr[:AL_TRAIN_ROWS]), (x_nom[:n_nom], y_nom[:n_nom]),
           (x_ood[:n_ood], y_ood[:n_ood]))
    spec = dataclasses.replace(registry_spec(AL_FAMILY), loader=lambda device=None: cut)
    if (spec.al_observed_share, spec.al_num_selected) != (AL_OBSERVED_SHARE, AL_NUM_SELECTED):
        raise AssertionError("AL settings differ from the registry")
    return spec


def read_al_pickles(family: str, has_dropout: bool) -> dict:
    """Load and check run 0's AL pickles: one per approach and observed
    split (VR only with dropout) plus the original model's, each the four
    splits' accuracies in the JAX package's order, Python floats in [0, 1]."""
    folder = subdir("active_learning")
    approaches = [a for a in [*APPROACHES, "random"] if a != "VR" or has_dropout]
    want = {f"{family}_0_{a}_{obs}.pickle" for a in approaches for obs in ("nominal", "ood")}
    want.add(f"{family}_0_original_na.pickle")
    found = set(os.listdir(folder))
    if found != want:
        raise AssertionError(f"AL pickles: missing {sorted(want - found)}, "
                             f"unexpected {sorted(found - want)}")
    splits = [(s, p) for s in ("nominal", "ood") for p in ("observed", "future")]
    out = {}
    for name in sorted(want):
        with open(os.path.join(folder, name), "rb") as f:
            acc = pickle.load(f)
        if list(acc) != splits or not all(type(v) is float and 0 <= v <= 1 for v in acc.values()):
            raise AssertionError(f"{name}: {acc} is not the four splits' accuracies")
        out[name[len(f"{family}_0_"):-len(".pickle")]] = acc
    return out


def run_active_learning(data, dev, root: str) -> dict:
    """MNIST's AL phase on run 0's checkpoint (in ``root``/train) through
    ``cli.main --phase active_learning`` on the registry's study (``al_spec``
    in its place for the call) with the counters read around it. Checks
    launches, pickles, each retrain's epoch and the random baseline's
    floor; prints its seconds and its AL table row."""
    spec = al_spec(data)
    os.environ["TIP_ASSETS"] = os.path.join(root, "train")
    full = base.CASE_STUDIES[AL_FAMILY]
    base.CASE_STUDIES[AL_FAMILY] = spec
    try:
        zero_counters()
        t0 = time.perf_counter()
        with CacheRecorder() as recorder:
            [run] = run_cli("--phase", "active_learning", "--case-study", AL_FAMILY,
                            "--runs", "0", *device_args(dev)).values()
        seconds = time.perf_counter() - t0
    finally:
        base.CASE_STUDIES[AL_FAMILY] = full
    # the AL base is cut (AL_TRAIN_ROWS), so its fingerprint is not test_prio's:
    # both caches miss here by design
    [sa_outcomes] = recorder.sa_outcomes
    if sorted(sa_outcomes) != sorted(SA_NAMES) or len(recorder.cov_outcomes) != 1:
        raise AssertionError(f"AL cache outcomes: SA {sa_outcomes}, "
                             f"coverage {recorder.cov_outcomes}")
    phases, members = run.seconds, run.retrain_epochs
    launches = read_counters()
    for name in PATHS[AL_FAMILY]["kernels"]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {AL_FAMILY} AL path")
    accuracies = read_al_pickles(AL_FAMILY, PATHS[AL_FAMILY]["model"].has_dropout)
    n_train = training_rows(AL_TRAIN_ROWS + AL_NUM_SELECTED, spec.train_cfg.validation_split)
    steps = -(-n_train // spec.train_cfg.batch_size)
    if len(members) != len(accuracies) - 1:
        raise AssertionError(f"{len(members)} retrains for {len(accuracies) - 1} selections")
    for i, history in enumerate(members):
        if [r["steps"] for r in history] != [steps]:
            raise AssertionError(f"AL retrain {i}: epochs {history}, want one of {steps} steps")
    for obs in ("nominal", "ood"):
        for split in (("nominal", "observed"), ("nominal", "future")):
            acc = accuracies[f"random_{obs}"][split]
            if not acc >= AL_RANDOM_FLOOR:
                raise AssertionError(f"random {obs} retrain: {split} accuracy {acc} below "
                                     f"{AL_RANDOM_FLOOR}")
    table = eval_active_learning_table.active_learning_table([AL_FAMILY])
    row = {approach: [cells[col] for col in eval_active_learning_table.columns([AL_FAMILY])]
           for (_, approach), cells in table.items()}
    retrains = len(members)
    record = {
        "family": AL_FAMILY, "seconds": seconds, "phases_s": phases,
        "retrain_mean_s": phases["retrain"] / retrains, "retrains": retrains,
        "steps_per_retrain": steps,
        "member_epoch_s": [h[0]["seconds"] for h in members],
        "member_mean_loss": [h[0]["mean_loss"] for h in members],
        "launches": launches,
        "cache_outcomes": {"sa": sa_outcomes, "coverage": recorder.cov_outcomes[0]},
        "reduced": {"epochs": "1 (registry 15)",
                    "train_rows": f"{AL_TRAIN_ROWS} of {PATHS[AL_FAMILY]['sizes'][0]}",
                    "test_rows": AL_TEST_ROWS},
        "settings": {"observed_share": AL_OBSERVED_SHARE, "num_selected": AL_NUM_SELECTED},
        "accuracies": {name: {f"{s}:{p}": v for (s, p), v in acc.items()}
                       for name, acc in accuracies.items()},
    }
    summary = {k: record[k] for k in ("family", "seconds", "phases_s", "retrain_mean_s",
                                      "retrains", "steps_per_retrain", "launches",
                                      "cache_outcomes", "reduced", "settings")}
    print(json.dumps({"active_learning": summary}))
    print(json.dumps({"active_learning_table": {
        "columns": eval_active_learning_table.columns([AL_FAMILY]), "rows": row}}))
    record["table"] = row
    return record


def _gaps_to_edge(values: np.ndarray, rows, k: int) -> np.ndarray:
    """|value - the k-th largest value| of ``rows`` (0 for equal values,
    +inf ones included)."""
    edge = np.sort(values)[-k]
    v = values[np.asarray(sorted(rows), dtype=np.int64)]
    with np.errstate(invalid="ignore"):  # inf - inf, which the tie replaces
        return np.where(v == edge, 0.0, np.abs(v - edge))


def al_selections(params, datasets, x_train, k: int, device) -> tuple:
    """The four builders on one device: (selections, the uncertainties, NC
    scores and SA values their top-k were taken from, seconds)."""
    cfg = PATHS[AL_FAMILY]
    model = cfg["model"]()
    t0 = time.perf_counter()
    fp, unc = eval_active_learning._get_fp_selection(model, params, datasets, k, cfg["batch"],
                                                     device)
    nc, nc_scores = eval_active_learning._get_nc_selection(model, params, x_train, datasets,
                                                           cfg["nc"], k, cfg["batch"], device)
    sa, sa_scores = eval_active_learning._get_sa_selection(model, params, x_train, datasets,
                                                           cfg["sa"], k, cfg["dsa_badge"],
                                                           device, AL_CHECK_SA)
    sel = {**fp, **nc, **sa, **eval_active_learning._get_random_section(datasets, k)}
    eval_active_learning._selection_sanity_checks(k, sel)
    return sel, unc, nc_scores, sa_scores, time.perf_counter() - t0


def al_check_datasets(data):
    """``AL_CHECK``'s split of the nominal and OOD subsets (seed 0)."""
    n_train, n_test, k = AL_CHECK
    (x_tr, _), (x_nom, y_nom), (x_ood, y_ood) = data
    return eval_active_learning._shuffle_and_split_datasets(
        0, x_nom[:n_test], y_nom[:n_test], x_ood[:n_test], y_ood[:n_test], AL_OBSERVED_SHARE)


def start_al_selections_cpu(tree, data, root: str) -> "CpuReference":
    """The CPU side of ``compare_al_selections``, started in a child process
    beside the card phases (from the flax tree of its run)."""
    n_train, _, k = AL_CHECK
    return CpuReference(os.path.join(root, "al_selections_cpu"), "al_selections", tree=tree,
                        datasets=al_check_datasets(data), x_train=data[0][0][:n_train], k=k)


def compare_al_selections(params, data, dev, cpu_side: "CpuReference") -> dict:
    """The four selection builders on a small subset (``AL_CHECK``) on the
    card, and on the CPU in a child process (``start_al_selections_cpu``):
    rows moved per selection, gated as phase 10 of the module docstring
    says."""
    n_train, n_test, k = AL_CHECK
    x_tr = data[0][0]
    datasets = al_check_datasets(data)
    with caches_off():
        card, unc, nc_card, sa_card, card_s = al_selections(params, datasets, x_tr[:n_train],
                                                            k, dev)
    (cpu, unc_cpu, nc_cpu, sa_cpu, cpu_s), cpu_waited_s = cpu_side.result()
    if list(card) != list(cpu):
        raise AssertionError("AL selections: card and CPU built other selections")
    moved, breaches = {}, []
    for key, rows in card.items():
        metric, split = key
        out = set(np.asarray(rows).tolist()) - set(np.asarray(cpu[key]).tolist())
        moved[f"{metric}:{split}"] = len(out)
        if not out or metric == "VR":
            continue
        out |= set(np.asarray(cpu[key]).tolist()) - set(np.asarray(rows).tolist())
        base = metric[:-len("-cam")] if metric.endswith("-cam") else metric
        if metric == eval_active_learning.RANDOM_SPLIT:
            breaches.append(f"{key}: the random baseline moved")
        elif base in UNCERTAINTIES:
            gap = float(_gaps_to_edge(unc_cpu[key], out, k).max())
            if gap > AL_UNCERTAINTY_ATOL:
                breaches.append(f"{key}: rows moved {gap} from the edge")
        elif base in NC_METRICS:
            diff = np.abs(nc_card[base, split].astype(np.int64)
                          - nc_cpu[base, split].astype(np.int64))
            if not diff.any() or diff.max() > 2 or (diff > 0).mean() > 0.01:
                breaches.append(f"{key}: rows moved, scores apart by {int(diff.max())} "
                                f"on {int((diff > 0).sum())} rows")
        elif metric.endswith("-cam"):
            if len(out) / 2 > SA_ORDER_CAP * k:
                breaches.append(f"{key}: {len(out) // 2} of {k} SC-CAM rows moved")
        else:
            values = sa_cpu[key]
            edge = np.sort(values)[-k]
            gap = float(_gaps_to_edge(values, out, k).max())
            if not gap <= SA_RTOL * abs(edge):
                breaches.append(f"{key}: rows moved {gap} from the edge {edge}")
    counted = {
        "vr": sum(v for key, v in moved.items() if key.startswith("VR:")),
        "coverage": sum(v for key, v in moved.items() if key.split(":")[0].split("-")[0]
                        in NC_METRICS),
        "uncertainty": sum(v for key, v in moved.items() if key.split(":")[0] in UNCERTAINTIES),
        "sa": sum(v for key, v in moved.items()
                  if key.split(":")[0].replace("-cam", "") in AL_CHECK_SA),
    }
    report = {"rows": [n_train, n_test, k], "sa_variants": AL_CHECK_SA, "moved_by_kind": counted,
              "moved": {key: v for key, v in moved.items() if v}, "card_s": card_s,
              "cpu_s": cpu_s, "cpu_waited_s": cpu_waited_s}
    print(json.dumps({"al_selections_card_vs_cpu": report}))
    if breaches:
        raise AssertionError("AL selections card vs CPU: " + "; ".join(breaches))
    return report


def check_collect_activations(tree, data, dev, root: str) -> dict:
    """``CaseStudy.collect_activations`` of MNIST run 0 (the flax tree
    ``tree``) on the first ``ACTIVATION_ROWS`` rows of each set, on the card
    and on the CPU: the same files, dtypes and shapes, labels byte-equal,
    each tap within ``ACTIVATION_RTOL`` of its largest magnitude."""
    cut = tuple((x[:ACTIVATION_ROWS], y[:ACTIVATION_ROWS]) for x, y in data)
    cs = case_study(AL_FAMILY, cut)
    dumps, seconds = {}, {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        os.environ["TIP_ASSETS"] = os.path.join(root, f"activations_{side}")
        cs.save_params(0, tree)
        t0 = time.perf_counter()
        cs.collect_activations([0], device=device)
        seconds[side] = time.perf_counter() - t0
        folder = os.path.join(subdir("activations"), AL_FAMILY, "model_0")
        dumps[side] = {os.path.relpath(os.path.join(d, n), folder): os.path.join(d, n)
                       for d, _, names in os.walk(folder) for n in names}
    if set(dumps["card"]) != set(dumps["cpu"]):
        raise AssertionError("at_collection: card and CPU wrote other files")
    badges = -(-ACTIVATION_ROWS // 100)
    layers = len(PATHS[AL_FAMILY]["model"].all_layers)
    if len(dumps["card"]) != 3 * badges * (layers + 1):
        raise AssertionError(f"at_collection: {len(dumps['card'])} files, want "
                             f"{3 * badges * (layers + 1)}")
    worst = {}
    for name, path in dumps["card"].items():
        a, b = np.load(path), np.load(dumps["cpu"][name])
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"at_collection {name}: {a.dtype}{a.shape} on the card, "
                                 f"{b.dtype}{b.shape} on the CPU")
        layer = name.split(os.sep)[1]
        if layer == "labels":
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"at_collection {name}: labels differ")
            continue
        rel = float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))
        worst[layer] = max(worst.get(layer, 0.0), rel)
        if rel > ACTIVATION_RTOL:
            raise AssertionError(f"at_collection {name}: card vs CPU {rel} of the tap's "
                                 f"largest magnitude > {ACTIVATION_RTOL}")
    report = {"rows_per_set": ACTIVATION_ROWS, "files": len(dumps["card"]),
              "relative_err_by_layer": worst, "card_s": seconds["card"], "cpu_s": seconds["cpu"]}
    print(json.dumps({"at_collection": report}))
    return report


def run_evaluation_and_check(root: str) -> dict:
    """``cli.main --phase evaluation`` (test_prio and active_learning) and
    ``--phase check`` over the paths' assets: the two tables written, and
    each path's run 0 complete in the check's report."""
    os.environ["TIP_ASSETS"] = os.path.join(root, "train")
    for which, tables in (("test_prio", ("apfds.csv", "apfd_paper_table.tex")),
                          ("active_learning", ("active.csv", "active_paper_table.tex"))):
        run_cli("--phase", "evaluation", "--eval", which)
        for table in tables:
            if not os.path.getsize(os.path.join(subdir("results"), table)):
                raise AssertionError(f"evaluation {which}: {table} is empty")
    statistics = {}
    for which, prefix in (("test_prio_statistics", "apfd_correlation"),
                          ("active_learning_statistics", "active_correlation")):
        t0 = time.perf_counter()
        run_cli("--phase", "evaluation", "--eval", which)
        statistics[which] = {"seconds": time.perf_counter() - t0,
                             **check_statistics_csvs(prefix)}

    report = {}
    for family in PATHS:
        dropout = PATHS[family]["model"].has_dropout
        missing = {
            "models": artifact_check.check_model_checkpoints(family, range(1)),
            "prio": sorted(artifact_check.check_prio_artifacts(family, range(1), dropout)),
            "times": sorted(artifact_check.check_times_artifacts(family, range(1), dropout)),
        }
        if family == AL_FAMILY:
            missing["active_learning"] = sorted(
                artifact_check.check_al_artifacts(family, range(1), dropout))
        if any(missing.values()):
            raise AssertionError(f"check {family}: run 0 misses {missing}")
        report[family] = artifact_check.data_source(family)
    run_cli("--phase", "check")
    print(json.dumps({"evaluation_and_check": report, "statistics": statistics}))
    return report


def check_statistics_csvs(prefix: str) -> dict:
    """``results/{prefix}_{p,eff}.csv``: the 39 x 39 grid under the human
    labels on both axes; returns the tested (non-blank) cells of each."""
    labels = human_approach_names(APPROACHES)
    tested = {}
    for suffix in ("p", "eff"):
        path = os.path.join(subdir("results"), f"{prefix}_{suffix}.csv")
        with open(path) as f:
            rows = [line.rstrip("\n").split(",") for line in f]
        if rows[0] != ["", *labels] or [r[0] for r in rows[1:]] != labels or any(
                len(r) != len(labels) + 1 for r in rows):
            raise AssertionError(f"{path} is not the 39 x 39 grid under the human labels")
        tested[f"{suffix}_cells"] = sum(bool(c) for r in rows[1:] for c in r[1:])
    return tested


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="also write the full record as JSON here")
    parser.add_argument("--warm-cache", default=None, metavar="FAMILY",
                        help="(internal) the fresh-interpreter side of the cache phase")
    parser.add_argument("--cpu-ref", default=None, metavar="PATH",
                        help="(internal) the CPU side of a card-against-CPU check")
    args = parser.parse_args()
    if args.cpu_ref:
        return cpu_ref_main(args.cpu_ref)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.warm_cache:
        return warm_cache_main(args.warm_cache)
    dev = resolve(None)
    # Deterministic cuDNN algorithms: the trained weights, and with them the
    # card-against-CPU checks on them (SA fits near singular, DSA's near
    # ties), are then the same in every run of this command on this card.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    timeline("1")
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"build_s {build_s:.3f}")
    print(_build.build_log())

    root = tempfile.mkdtemp(prefix="tip_chip_smoke_")
    paths = {}
    try:
        timeline("2-4")
        t0 = time.perf_counter()
        studies, data_record = data_phase(os.path.join(root, "datasets"), args.seed, dev)
        data = {family: studies[family] for family in PATHS}
        data_record["corruptor"] = check_corruptor(
            {"28x28x1": studies["mnist"][1][0][:len(CORRUPTOR_INDICES)],
             "32x32x3": studies["cifar10"][1][0][:len(CORRUPTOR_INDICES)]}, args.seed, dev)
        data_record["text"] = check_text(args.seed, dev, root)
        print(f"data_s {time.perf_counter() - t0:.3f}")

        os.environ["TIP_ASSETS"] = os.path.join(root, "train")
        for family in PATHS:
            base.CASE_STUDIES[family] = registry_spec(family)
        timeline("5")
        training, params = {}, {}
        trees = {}
        for family in PATHS:
            cs, training[family] = train_family(family, data[family], dev)
            trees[family] = cs.load_params(0)
            params[family] = params_from_jax(trees[family])
        classes = {family: predicted_classes(family, params[family], data[family][0][0], dev)
                   for family in PATHS}
        al_cpu = start_al_selections_cpu(trees[AL_FAMILY], data[AL_FAMILY], root)

        timeline("6")
        kernels = [
            check_fused_forward(params["mnist"], data["mnist"][1][0], dev),
            check_cifar10_forward(params["cifar10"], data["cifar10"][0][0][:10_000], dev),
            check_flash_attention(params["imdb"], data["imdb"][1][0], dev, args.seed),
            *check_flash_backward(params["imdb"], data["imdb"], dev, args.seed),
        ]
        wide = check_wide_heads(dev, args.seed)
        for k in kernels:
            part = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dq": "dq",
                    "flash_attention_bwd_dkv": "dkv"}.get(k["name"])
            if part:
                k["at_wide_heads"] = {"shape": wide["shape"], **wide[part]}
        gradients = check_imdb_gradients(params["imdb"], data["imdb"], dev)
        dsa_by_path = {family: check_dsa_nearest(family, params[family], data[family][0][0],
                                                 data[family][1][0], dev)
                       for family in PATHS}

        for family in PATHS:
            timeline(f"7 {family}")
            paths[family] = run_path(family, params[family], data[family], dev, root)
        timeline("7 warm cache")
        warm_children = {family: WarmCache(family, root) for family in WARM_CACHE_PATHS}
        warm = {family: child.finish(paths[family]["time_records"])
                for family, child in warm_children.items()}
        timeline("7 spill")
        spill = check_disk_spill("imdb", params["imdb"], data["imdb"], dev, root)
        timeline("7b")
        t0 = time.perf_counter()
        fused = {family: run_fused_path(family, params[family], data[family], dev, root,
                                        paths[family]["phases_s"])
                 for family in CHAIN_PATHS}
        graph_eager = {family: check_graph_vs_eager(family, params[family], data[family], dev)
                       for family in PATHS}
        os.environ["TIP_ASSETS"] = os.path.join(root, "train")
        group_cs = CaseStudy(registry_spec(CHAIN_GROUP_FAMILY))
        group_params = {run: params_from_jax(group_cs.load_params(run))
                        for run in PATHS[CHAIN_GROUP_FAMILY]["runs"]}
        group = check_group_runner(group_params, data[CHAIN_GROUP_FAMILY], dev)
        chain_phase_s = time.perf_counter() - t0
        print(json.dumps({"chain_phase_s": chain_phase_s, "gpu": smi}))
        sp_group = SpGroup(params["imdb"]["module"], data["imdb"], dev, root, args.seed)
        timeline("7d")
        sched = run_sched_phase(os.path.join(root, "datasets"), dev, root, args.seed)
        print(json.dumps({"sched_phase_s": sched["phase_s"], "gpu": smi}))
        # 7c's graph captures run with no CPU-reference child beside them (a
        # chain capture at registration failed beside them twice, ROADMAP §C
        # 3), so 7c runs after 7d, when the children have ended
        print(json.dumps({"children_waited_s_before_7c": wait_children()}))
        timeline("7c")
        serving = run_serving(params, data, dev, late_params=group_params[1])
        print(json.dumps({"serving_phase_s": serving["phase_s"], "gpu": smi}))
        timeline("7e")
        sp = run_sp_phase(sp_group, dev)
        study_hosts = StudyHosts(os.path.join(root, "datasets"), dev, root)
        print(json.dumps({"sp_phase_s": sp["phase_s"], "gpu": smi}))
        timeline("9")
        active = run_active_learning(data[AL_FAMILY], dev, root)
        for family in PATHS:
            paths[family]["sa_small"] = paths[family]["sa_small"].finish()
        timeline("10")
        al_check = compare_al_selections(params[AL_FAMILY], data[AL_FAMILY], dev, al_cpu)
        timeline("11")
        activations = check_collect_activations(trees[AL_FAMILY], data[AL_FAMILY], dev, root)
        timeline("12")
        evaluation = run_evaluation_and_check(root)
        sp["study"] = study_hosts.finish()
        timeline("7f")
        observability = run_obs_phase(params[OBS_FAMILY], data[OBS_FAMILY], dev, root, smi)
        timeline("7g")
        bf16 = run_bf16_phase(params, trees, data, dev, root, paths)
        print(json.dumps({"bf16_phase_s": bf16["phase_s"], "gpu": smi}))
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"train_s": {f: t["train_s"] for f, t in training.items()},
                      "paths_s": {f: p["slice_s"] for f, p in paths.items()},
                      "total_s": sum(p["slice_s"] for p in paths.values()),
                      "active_learning_s": active["seconds"],
                      "fused_paths_s": {f: r["slice_s"] for f, r in fused.items()},
                      "chain_phase_s": chain_phase_s,
                      "serving_phase_s": serving["phase_s"],
                      "sched_phase_s": sched["phase_s"],
                      "sp_phase_s": sp["phase_s"],
                      "obs_phase_s": observability["phase_s"],
                      "bf16_phase_s": bf16["phase_s"],
                      "bf16_paths_s": {f: r["slice_s"] for f, r in bf16["runs"].items()},
                      "timeline_s": TIMELINE,
                      "generate_s": {f: data_record[f]["load_s"] for f in IMAGE_FIXTURES},
                      "command_s": time.perf_counter() - START}))

    def launches_by_path(name):
        return {f: p["launches"][name] for f, p in paths.items() if name in PATHS[f]["kernels"]}

    train_launches = training["imdb"]["launches"]
    for k in kernels:
        if k["name"].startswith("flash_attention_bwd"):
            # The backward runs only in training: its launches are the IMDB epoch's.
            k["launches"] = train_launches[k["name"]]
        else:
            k["launches"] = sum(launches_by_path(k["name"]).values())
            if k["name"] == "flash_attention_fwd":
                k["training_launches"] = train_launches[k["name"]]
                k["fused_chain_launches"] = fused["imdb"]["launches"][k["name"]]
                k["serving_launches"] = serving["launches"][k["name"]]
        if k["name"] in PATHS[AL_FAMILY]["kernels"]:
            k["al_launches"] = active["launches"][k["name"]]
        if k["name"] in SP_KERNELS:
            # Per case of phase 7e, each rank's launches (ring and ulysses
            # over its ranks, the long-context cores over 2).
            k["sp_launches"] = {case: [by_rank[r][k["name"]] for r in sorted(by_rank)]
                                for case, by_rank in sp["group"]["launches"].items()}
        if k["name"] == "flash_attention_fwd":
            k["study_host_launches"] = sorted(
                h.get(k["name"], 0) for h in sp["study"]["launches"].values())
        if k["name"] in PATHS[SCHED_FAMILY]["kernels"]:
            k["sched_worker_launches"] = sorted(
                w[k["name"]] for w in sched["scheduler"]["launches"].values())
    b2 = dsa_nearest_entry(dsa_by_path, launches_by_path("dsa_nearest"))
    b2["al_launches"] = active["launches"]["dsa_nearest"]
    b2["sched_worker_launches"] = sorted(
        w["dsa_nearest"] for w in sched["scheduler"]["launches"].values())
    kernels.insert(1, b2)
    for k, family in zip(bf16["kernels"], ("mnist", "cifar10", "imdb")):
        k["launches"] = bf16["runs"][family]["launches"][k["name"]]
        if family == "imdb":
            k["route_launches"] = bf16["runs"][family]["b4_bf16_routes"]
        if family == "cifar10":
            k["launches_on"] = f"CIFAR-10 run 0 on {PATH_CUTS['cifar10']} of its rows"
        kernels.append(k)
    print(json.dumps({"kernels": kernels}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"gpu": smi, "build_s": build_s, "data": data_record,
                       "evaluation": evaluation, "kernels": kernels, "training": training,
                       "imdb_gradients": gradients, "wide_heads": wide, "classes": classes,
                       "paths": paths, "warm_cache": warm, "disk_spill": spill,
                       "active_learning": active, "al_selections": al_check,
                       "fused_chain": {"paths": fused, "graph_vs_eager": graph_eager,
                                       "group_runner": group},
                       "serving": serving, "study_execution": sched,
                       "sequence_parallel": sp, "observability": observability, "bf16": bf16,
                       "at_collection": activations}, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PaLD on one NVIDIA GPU and check it.

    PYTHONPATH=src python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` (timed), and print ptxas's registers, spills
   and shared memory of the focus and cohesion kernels, dense and tri;
2. each kernel against its plain torch version on the card, for every
   built-in weight functional, at a ragged square n = 257 (the focus
   kernel's square entry, also on an asymmetric D) and a rectangular
   (mx, my, mz) = (96, 160, 224) with asymmetric, tie-heavy inputs
   holding +inf entries; ``ignore`` through both tiebreak routes;
3. the main path at full size: ``pald.cohesion(D, method="kernel")`` on a
   clustered n = 8192, d = 8 point set, with the launch counters as proof
   that both kernels ran and no plain version did, and the focus kernel's
   block counters as proof that it ran the nb(nb+1)/2 upper tile pairs of
   the symmetric D, none of them twice; mass conservation, a 64-row slab
   recomputed by the plain versions, community recovery;
4. each kernel and its plain version timed at n = 8192 (CUDA events, the
   kernel's median after a warm-up, the plain version's one call: 8-10 s
   a call, its ops run since phase 2), beside the kernel's bound and its
   floor at the compare rate; then ``ops.focus`` on phase 3's D with one
   64 x 64 tile perturbed (asymmetric): timed, one tile pair run twice,
   and U bitwise the plain version's;
5. the kernels of every built-in weight family timed at n = 8192;
6. the fused features kernels (``pald_fused.cu``) against their plain
   versions on the card: four metrics x five families at a ragged n = 257
   and d in {1, 5, 300} on quantized features with duplicated rows, each
   at three distance-panel sizes (the default, 64 and 192 rows: one, five
   and two panels); their distances bitwise against ``cdist_reference``,
   U and C bitwise across the panel sizes, U bitwise against the dense
   kernels' on the same distances; how many C are bitwise the dense
   kernels';
7. the second main path at full size: ``pald.from_features(X)`` with every
   knob at its default (euclidean, ``ties="drop"``, ``method="auto"`` ->
   fused) on a clustered n = 8192, d = 64 point set, with the launch
   counters as proof that the fused kernels ran once each and neither the
   dense kernels nor any plain version did, and 1 + 2 ceil(n/P) grids
   each; mass, a 64-row slab, community recovery, the panel within its
   budget, peak device memory at least one n^2 float32 buffer below the
   materialize-then-kernel path's, and C bitwise that path's;
8. the fused kernels and their plain versions timed at n = 8192, d = 64,
   a sweep of the panel rows (256 to 4096), each family's fused kernels
   beside phase 5's dense ones, and ``from_features`` end to end, fused
   against materialize-then-kernel, for all four metrics (CUDA events,
   median after a warm-up; a plain version's one call);
9. the plain distance steps on the host CPU bitwise numpy float32's; the
   sparse k-NN kernels (``pald_topk.cu``, ``pald_knn.cu``) against their
   plain versions on the card: the selection bitwise (indices and
   distances) for n in {1, 2, 33, 257, 1000}, d in {1, 5, 8, 300}, k in
   {1, 7, 32, n-1}, four metrics, on quantized features with duplicated
   rows; both kernels' shared memory as their C entries report it against
   the Python copies (``smem_per_cta``) at every k and width (past 1024
   the large-k variants', k up to 16384); the values
   kernel's cube source for five families x both gather kinds x k in {1,
   4, 32, 33, 100, n-1} at n = 257 (rtol 1e-5, atol 1e-6), its features
   and D sources bitwise the cube source (and the features source at
   every metric, d = 5 and 300, k = 32 and 100), and at k = n-1 the
   values scattered against the dense kernels' C;
10. the third main path at full size: ``ops.select_cohere(X, k=32)`` on the
   k-NN example's mixture (n = 50,000, d = 8, communities of 25), with the
   launch counters as proof that the selection and the values kernel's
   features source ran once each and no other kernel, tile source, gather
   or plain version did; a 64-row slab against the plain versions and a
   float64 sum, the example's purity check, peak device memory within
   the graph, values and norms (+ 1 MiB); then
   ``pald.cohesion(D, method="knn", k=32)`` on phase 3's n = 8192 D
   (the values kernel's D source alone);
11. the k-NN kernels timed at n = 50,000: the selection at k in {1, 32,
   256, 1024}, and on the rows in a
   random order at k in {1, 32}; the plain gather and the
   cube source (row 7's kernel); the stage "gather + values" (the
   features source) beside the earlier gather + cube; ``select_cohere`` end
   to end; then ``select_cohere`` at n = 1,000,000 (or the largest n the
   50,000 times, scaled by n^2, put under 60 s) with its peak memory and
   a 64-row slab check; ptxas's registers and spills of both sources;
   then past k = 1024, the kernels' large-k variants (the selection by
   threshold: histogram sweeps, a collect, a sort; the values a block a
   row, its state out of shared memory, the features source in register
   tiles, ``pald_knn_large.cu`` up to 16 features, ``pald_knn_wide.cu`` up
   to 64 and ``pald_knn_piece.cu`` past, the D source in one sweep of each
   row's tile):
   ``select_cohere(X, k)`` at n = 50,000 for k in {1025, 2048, 4096}
   with the wrappers' counts set to 0 and every plain version failing if
   called (one launch of each large-k variant), the graph bitwise and the
   values within rtol 1e-5, atol 1e-6 of the plain versions on a 16-row
   slab, each kernel timed (the selection the median of 3 after
   select_cohere's call, one call at k = 4096; the values kernel its call
   inside the select_cohere run, CUDA events around the wrapper);
   the same at n = 2100, k = 2048 for d in ``D_WIDE`` (17, 64, 100:
   widths 32 and 64 and pieces of 32); the features source's entry and
   padded width at each d; both variants beside
   the shared-memory layouts at k = 256, 512 (times only) and 1024 (for
   the record: the selection bitwise, the values bitwise for the default
   family, an exact count); ``cohesion(D, method="knn", k=2048)`` on phase 3's
   n = 8192 D (the D source's variant once, C bitwise its scatter, a
   16-row slab; the sweep's gather traffic, entries and 32-byte sectors a
   row modeled from the graph's indices (printed, not measured), beside
   two passes in the graph's order); a chunk of 2 at n =
   2100, k = 2048 (the selection and
   both values sources one launch each, each item bitwise alone) and the
   block entry on two candidate blocks, merged, bitwise the full call,
   and timed over all n candidates; the ``*_large[k=...]`` rows of the
   kernels' JSON;
12. the tri kernels (the square entry of ``pald_focus.cu``,
   ``pald_cohesion_tri.cu``) against their plain versions on the card, for
   every built-in weight functional at ragged n in {1, 2, 63, 64, 65, 257}
   on symmetric,
   tie-heavy distances holding +inf pairs (``ignore`` through its index
   tiebreak): U bitwise (except soft) against the plain version and
   bitwise the dense kernel's U (soft too: one kernel), C within rtol
   1e-5, atol 1e-6 of the plain version, bitwise the dense kernel's, and
   bitwise across two calls;
13. the tri main path at full size: ``pald.cohesion(D, method="kernel",
   schedule="tri", ties="ignore")`` on phase 3's D (rebuilt), with the
   launch counters as proof that both tri kernels ran (the cohesion in
   one grid, the focus over nb(nb+1)/2 blocks) and no dense kernel or
   plain version did; mass, U bitwise the
   dense kernel's, C bitwise the dense kernel pipeline's and across two
   calls, a 64-row slab against the plain versions and a float64 sum,
   community recovery; the peak device memory of the tri and the dense
   call (the dense focus again over the upper tile pairs only);
   ``pald.cohesion(D, ties="ignore")`` with default knobs resolves
   to ``method="triplet"``, runs the two tri kernels once each and gives
   the same C bitwise;
14. the tri kernels and their plain versions (one call each) timed at n =
   8192 beside the dense kernels and their bounds, the tri and dense
   pipelines end to end,
   and each family's tri kernels;
15. a ``torch.profiler`` window over one dense and one tri call at
   n = 8192: the device's busy share and the kernel time by name; then
   both pipelines at a ragged n = 8000 (the engine pads it to 8064), timed
   in turns, with their peak device memory;
16. guarded execution (``on_error="fallback"``) on the card: at n = 1024,
   dense and tri, a fault-free fallback plan bitwise the raise plan with
   no event and both kernels launched, then every CUDA entry point faulted
   (``testing.faults.fail_kernel(impl="cuda")``) and the ``impl:torch``
   rung within rtol 1e-5, atol 1e-6 with one event; a real
   ``torch.cuda.OutOfMemoryError``: 8 items at n = 4096 under a memory cap
   (``torch.cuda.set_per_process_memory_fraction``, restored after; 16.5
   items' bytes above the reserved memory) that a chunk of 8 exceeds and
   one of 2 does not, rescued by halving ``batch``,
   bitwise the per-item C; the ``select="chunked"`` rung's graph bitwise
   the CUDA selection's at n = 50,000, k = 32, with both times;
   ``from_features(X, k=2048)`` at n = 2100 on the k-NN kernels' large-k
   variants under "raise" and "fallback" (one launch of each, no
   degradation, the plain versions failing if called), C bitwise between
   the two and the values within rtol 1e-5, atol 1e-6 of the plain
   versions on a 16-row slab;
17. batched chunks: B = 64 items at n = 256 and B = 16 at n = 1024, dense
   and tri, one chunk (one grid a pass, b x the upper tile pairs of focus
   blocks counted on the card) against one item a launch (``batch=1``):
   both times (medians of 3, in turns) beside the card's name and power
   limit, C bitwise; then ``from_features(Xb, method="fused")`` at the
   reference's run_batched cells (B, n) = (3, 128), (3, 256), (2, 512)
   and at (64, 256), (16, 1024), d = 8 and 64, ``from_features(Xb,
   k=32)`` and ``cohesion(Db, method="knn", k=32)`` at (64, 256) and
   (16, 1024), and a ragged tie-heavy (5, 201) under split and ignore
   through each: the wrappers' counts set to 0, one launch of each kernel
   a chunk, C bitwise the item loop, the two timed in turns; each chunked
   kernel (fused pair, selection, both values sources) at (64, 256)
   against its plain version item by item, beside its bound and the item
   loop (the kernels' ``*_chunk`` rows).  Reports only; no speed gate;
18. the tuning cache on the card (``repro_torch.tuning``): the measured
   method crossover (``tune_methods`` at n in {64, ..., 1024}: each
   method's ms and the winner per n, and the record n = 8192 resolves
   to), the engine's +inf pad swept at the ragged n = 8000 (``tune(8000,
   "pald" / "pald_tri", impl="cuda")``, block in {64, 128, 256, 512}: each
   row's ms and padded n), then ``plan(D, method="kernel", block="auto")``
   at n = 8000 from that cache (``block_source`` the record keyed by the
   card's name, C bitwise an explicit plan with the same block and within
   rtol 1e-5, atol 1e-6 of ``block=128``), ``pald.cohesion(D)`` with
   default knobs at n = 256 and 1024 reading its method from the cache
   (C within rtol 1e-5, atol 1e-6 of ``method="kernel"``), and the cache
   truncated (``testing.faults.corrupt_tuning_cache``): the plan falls
   back to the defaults, C bitwise a fresh plan's, the corrupt file moved
   aside;
19. dense distributed PaLD (``core/distributed.py``) in a world of 4
   ranks sharing the card (``testing/world.py``: gloo, every collective
   staged through the host; NCCL refuses two ranks on one device):
   allgather and ring on ("data",) and 2d on (2, 2) at n = 8192 (phase
   3's D), each rank's wall time, kernel time (CUDA events around every
   kernel call), focus and cohesion launches and staged bytes, and rank
   0's C within rtol 1e-5, atol 1e-6 of single-device ``cohesion(D,
   method="kernel")`` with mass n/2; bfloat16 communication at n = 2048
   against single-device on the bfloat16-cast D; ring at a ragged n =
   8190; the pod stream on (2, 2, 2) in a world of 8 at n = 2048; then a
   world of one rank on NCCL: ring and allgather at n = 8192 against the
   gloo world's C (bitwise, or within tolerance where the sums run in
   another order);
20. the focus kernel's rectangular entry and the cohesion kernel alone at
   the allgather body's shape (DXZ = DXY (2048, 8192), DYZ (8192, 8192)):
   CUDA events, U bitwise and C within rtol 1e-4 of the plain versions,
   beside their bounds;
21. ``pald_distributed_from_features`` at n = 8192, d = 64, ring and
   allgather on 4 ranks, C within rtol 1e-5, atol 1e-6 of single-device
   ``from_features(X, method="kernel")``;
22. the sharded k-NN pipeline (``core/distributed_knn.py``) on the k-NN
   example's mixture (n = 50,000, k = 32, d = 8) on 4 ranks, allgather,
   ring and 2d on (2, 2): graph and values bitwise single-device
   ``select_cohere``, each rank's launches of the selection's block entry
   and of the values kernel's sources; ``pald.from_features(X, k=32,
   mesh=)`` at n = 8175, C bitwise single-device and ``explain()`` naming
   the mesh; then the block entry and the neighbor-row source at a
   shard's shapes against their plain versions, timed;
23. the guard: a fault at ``distributed_knn.body`` armed in every rank
   (``World.run(faults=...)``): ``on_error="fallback"`` bitwise
   single-device (the module, and a mesh plan through its
   ``mesh:single-device`` rung), ``"raise"`` raising in every rank, the
   world then running on; every call of a world within its deadline, and
   every rank process exiting 0.
24. the LM serving path (``models/``, ``train/serve_step.py``,
   ``launch/serve.py``): gemma2-2b at full width and depth (26 layers,
   d = 2304, vocab 256,000, 2.6e9 parameters) seeded on the card; in
   float32, the logits of a prefill of 4 x 32 tokens and of 31 greedy
   decode steps against one cache-free forward over the same positions
   (rtol 1e-3, atol 1e-3); then served in bfloat16 at the serve driver's
   defaults (batch 4, prompt 32, 32 tokens, temperature 0.8) five times,
   the first a warm-up: tokens in the vocabulary, logits finite, prefill
   ms, decode ms a step, tok/s, peak device memory beside the parameters'
   and caches' bytes, a profiler window over one decode step (device
   events, busy share); then each of the ten archs' reduced configs, the
   same float32 gate (prefill of 2 x 8, 3 decode steps) and a bfloat16
   serve;
25. the port's examples as programs (``python -m
   repro_torch.examples.<name>``) at their defaults: ``quickstart``,
   ``pald_knn_clusters`` (n = 50,000, and ``--mesh 4 --strategy ring``:
   four spawned ranks on the card), ``pald_text_analysis`` (n = 2712, one
   NCCL rank), ``serve_lm --arch gemma2-2b --full`` and ``train_lm``
   (llama-100m, 300 steps of 8 x 256 tokens, checkpoints, then the text
   analysis of the trained embedding table: the focus kernel's
   rectangular entry and the cohesion kernel on one NCCL rank): each
   exits 0 with its success line; their output and wall times are
   printed (``train_lm`` in a fresh checkpoint directory, and its log must
   show steps 0 and 299);
26. training on one device (``optim/``, ``train/train_step.py``,
   ``data/``, ``launch/train.py``): gemma2-2b at full width and depth
   (float32 master weights, AdamW, bfloat16 compute, ``remat="full"``)
   through ``launch.train.run`` at the driver's defaults (batch 8 x seq
   128, SyntheticTokens seed 0) for 5 steps: step ms (median of steps
   2-5), tok/s, peak device memory against the 18 B a weight the state
   holds, a profiler window over one step (busy share, device events,
   matmul kernels' share), forward + backward and AdamW timed apart;
   loss and grad norm finite at every step; the float32 gradients of
   remat "nothing" (within 2^-8 of each leaf's largest) and of four
   microbatches (within 2^-5) against remat "full" in one, the peak
   memory of each; one step in four microbatches against one (loss within
   rtol 1e-5, grad norm within rtol 1e-2, weights within 4 lr); the loss
   falling over 5 steps on one repeated batch; then mamba2-780m (batch 2
   x seq 512: two SSD chunks) and granite-moe-1b-a400m (batch 4 x 256) at
   full width and depth, two steps each through ``launch.train.run``,
   every gradient and weight finite (the reference's SSD gradients are
   nan at mamba2's init), step ms and peak memory;
27. training sharded over a mesh (``sharding/``, ``train/train_step.py``
   with ``mesh=``, the sharded checkpoints, ``runtime/elastic.py``,
   ``launch/train.py --mesh``): (a) gemma2-2b at full width, its depth
   cut to 4 layers (2 repeats of its local/global pattern), ``fsdp``,
   batch 8 x seq 128 of SyntheticTokens seed 0, ``remat="full"``: one
   step on one device in 1 and in 2 microbatches, its loss, grad norm,
   float32 gradients and updated weights kept on the host, the card
   freed; (b) the same step from the same weights on a (2, 2) mesh over
   (data, model) in a gloo world of 4 ranks on the card: each rank's
   state bytes exactly the layout's (about a quarter of 12 B a weight),
   the loss within rtol 1e-6 and every gradient block within 2^-8 of its
   leaf's largest of the 2-microbatch step (each data rank's rows are one
   microbatch's), and against the 1-microbatch step the loss within rtol
   1e-5, the grad norm within rtol 1e-2, the gradients within 2^-5, the
   weights within 4 lr; 2 more steps on the repeated batch, losses finite
   and falling; per rank the step ms (median), the bytes staged through
   the host a step and the peak device memory against state + gathered
   bfloat16 + the largest float32 leaf; a sharded save at step 2 and the
   uninterrupted step 3; (c) zero3 on (2, 2, 2) in a world of 8 on reduced
   gemma2-2b: every initial block bitwise the single-device weights' at
   the rank's position, one step held by (b)'s gates (against 4
   microbatches); (d) the checkpoint of (b) resumed in a world of 2 on
   ``choose_mesh(2, target_model=2)``: every restored block bitwise the
   saved leaf's slice, step 3 finite and within rtol 1e-3 of (b)'s; (e)
   ``python -m repro_torch.launch.train --arch llama3.2-3b --smoke --mesh
   2x2 --steps 6`` in a fresh ``--ckpt-dir``, exit 0, and a restart to 8
   steps continuing from step 5; (f) one NCCL rank on a (1, 1) mesh: (a)'s
   step bitwise (every gradient and weight's bytes, the loss, the grad
   norm).
28. the dry run (``launch/dryrun.py``, ``specs.py``, ``cost_analysis.py``,
   ``dryrun_pald.py``): (a) granite-moe train_4k, gemma2-2b prefill_32k
   and decode_32k at the single pod's per-rank shapes (16, 2 and 8 rows),
   each counted on meta and measured on the card at full depth (CUDA
   events; ``max_memory_allocated`` within 2x of the meta estimate, the
   ratio printed), gemma2-2b decode_32k also by its 1- and 2-repeat
   probes (each probe's peak within 2x of its estimate; the
   extrapolation's error against full depth printed); (b) the dense PaLD
   cells at n = 102,400 on (16, 16): allgather, ring and 2d, one rank's
   arrays at their post-collective shapes and its kernels timed through
   the rectangular entries (a loop's trip times its trips) beside the
   counted bound, the launch counters up and no plain version run in the
   timed calls, the peak within 2x of the estimate; then the first 16
   rows of each call's U and C, at its full y and z (allgather's D 102,400
   x 102,400 of y and z, past 2^31 elements), against the plain versions
   on the same operands: U bitwise, C within rtol 1e-4, atol 1e-6; (c) ``hillclimb cell --set
   remat=dots`` on meta against (a)'s decode cell saved as the baseline;
   (d) the self-test's counted production cell (full internvl2-1b); every
   cell's JSON "ok".
29. user-registered weight functionals compiled into the kernels
   (``kernels/_functor.py``, the user libraries of ``kernels/_build.py``):
   ``harsh`` (drop's callables under a new name, no kernel id), clones of
   ignore and soft, and a smooth functional with ``exp`` and a share,
   traced before phase 2 and built by nvcc in a thread beside phases 2-28
   (harsh's six sources first: one functional's nvcc seconds; then the
   other eighteen at once); each user path driven with the wrappers'
   counts set to 0 and every plain version failing if called, each
   kernel launched: the clones' C bitwise the built-ins' through
   ``cohesion(D, method="kernel")`` at n = 8192 on phase 3's D (dense and
   tri; harsh, the ignore clone, the soft clone dense), the ignore clone
   at n = 8000, ``from_features(X)`` at n = 8192, d = 64 (harsh),
   ``select_cohere(X, k=32)`` on phase 10's mixture (harsh and the soft
   clone, graph and values bitwise, a 64-row slab against the plain
   versions), ``cohesion(D, method="knn", k=32)`` at n = 8192 (harsh) and
   phase 17's chunk cells (harsh, one launch of each kernel a chunk); the
   clones' kernels timed in turns against the built-ins' at n = 8192 (and
   the k-NN sources at their main-path sizes) beside the card's name and
   power limit; the smooth functional within rtol 1e-5, atol 1e-6 of its
   plain versions on a 16-row slab at n = 8192 and whole at n = 1024
   (dense, tri, fused, both k-NN paths); the values kernel's large-k
   variant (n = 2100, k = 2048, features and D sources) with the ignore
   and soft clones bitwise their built-ins and the smooth functional on a
   16-row slab against its plain version; a functional with an op outside
   the compiler's table raising ``NotImplementedError`` on the card,
   naming the op, and ``FallbackExhausted`` under ``on_error="fallback"``;
   ``explain()`` naming harsh's compiled key and its libraries.

The whole run reads and writes a tuning cache of its own, a fresh
temporary file (``$REPRO_TORCH_TUNE_CACHE``) removed at the end, so a
cache left on the machine changes nothing that phases 1-17 measure: they
plan on a cold cache.

The line before the last is one JSON object with the kernels' numbers
(``launches``: wrapper calls on the main path; ``grid_launches``: the grids
those calls issued; ``blocks``, for the focus kernels: the thread blocks
of those grids, counted by the kernel on the card; ``bound_ms``: the function's least work, shared by the
dense, tri and fused kernels of one pass, see :func:`pass_ops`;
``dryrun_launches``, on the rectangular rows: phase 28's launches; the
rows named ``<kernel>_large[k=...]``: phase 11's large-k variants (``,d=``
in the name: the values' features source past 16 features), their
plain versions timed on a 16-row slab (``plain_on``); the
rows named ``<kernel>[<functional>]``: phase 29's user functors, each with
its compiled ``key``, the built-in's time in the same turns
(``builtin_ms``) and where its plain time was measured (``plain_from``:
an earlier phase's plain version of the same callables on the same
inputs, or this phase)); the last line is ``{"ok": true, "device": {...}}``.  Without a GPU the script
exits 2 before printing any result, and 3 when it is run alone (no
``src/repro_torch`` beside it); any failed check raises (exit 1).  A
passing run exits 0.  The phases that start worlds of ranks stop them
before they end, and fail when a rank exits otherwise than cleanly.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

N_MAIN = 8192          # the dense methods' size in benchmarks/run.py
D_MAIN = 8
D_FUSED = 64           # the embedding width of examples/pald_text_analysis.py
# the k-NN main path: examples/pald_knn_clusters.py's defaults
N_KNN, K_KNN, D_KNN, COMM_KNN = 50_000, 32, 8, 25
N_KNN_BIG = 1_000_000  # the size the reference's k-NN pipeline reached
BIG_LIMIT_S = 60.0     # projected wall time allowed for the n = N_KNN_BIG run
METRICS = ("sqeuclidean", "euclidean", "cosine", "manhattan")
SLAB = 64
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_LANES = 128 * 132      # FP32 lanes per SM x SMs of an H100 SXM
# grid launches per kernel on its main path, from the wrappers'
# ``.grid_launches`` (a call may issue more than one grid: the row-norm
# pre-pass, a panel writer per panel); filled by phases 3, 7, 10, 13
GRIDS = {}
# thread blocks of the focus kernels' main-path grids, counted on the card
# (``pald_focus.tile_counts``); filled by phases 3 and 13
BLOCKS = {}
RTOL, ATOL = 1e-5, 1e-6            # the conformance tolerance
# at n = 8192 a C entry is a sum of up to n positive float32 terms taken in
# another order than the plain version's, so the full-size check is looser
RTOL_MAIN = 1e-4


def fail(msg: str) -> None:
    raise AssertionError(msg)


def smi(query: str, fmt: str = "csv,noheader") -> str:
    """First line of ``nvidia-smi --query-gpu=<query>`` (card 0)."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want, exact, rtol=RTOL, atol=ATOL) -> float:
    """Hold a kernel result against its plain version; return max |err|."""
    import torch

    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if exact:
        if not torch.equal(got, want):
            fail(f"{name}: not bitwise equal (max |err| {err!r})")
    elif not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: max |err| {err!r} beyond rtol {rtol}, atol {atol}")
    return err


def functionals():
    from repro_torch.core.weights import (DROP, IGNORE, SPLIT, kernelized,
                                          soft_threshold)

    return [DROP, SPLIT, IGNORE, soft_threshold(), kernelized()]


def exact_focus(w) -> bool:
    """U is an exact count (integers or halves) unless the focus is smooth."""
    return not w.name.startswith("soft")


def quantized_distances(rng, n, dev):
    import torch

    X = rng.integers(0, 6, size=(n, 3)).astype(np.float64)
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return torch.as_tensor(D, dtype=torch.float32, device=dev)


def phase_kernels_vs_plain(dev) -> None:
    """Phase 2: every functional, square and rectangular, both routes."""
    import torch
    from repro_torch.core.weights import index_xwins
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weights_ref

    rng = np.random.default_rng(SEED)
    n = 257
    D = quantized_distances(rng, n, dev)
    mx, my, mz = 96, 160, 224

    def rect(shape):
        a = rng.integers(0, 8, size=shape).astype(np.float32) * 0.5
        a[rng.random(shape) < 0.03] = np.inf
        return torch.as_tensor(a, device=dev)

    DXZ, DYZ, DXY = rect((mx, mz)), rect((my, mz)), rect((mx, my))
    Da = rect((n, n))  # square, asymmetric: the square entry's second loop
    Wr = torch.as_tensor(rng.random((mx, my)).astype(np.float32), device=dev)
    XWr = torch.as_tensor(rng.random((mx, my)) < 0.5, device=dev)
    offs = (37, 5)
    checked = 0
    for w in functionals():
        kw = dict(ties=w)
        Uk = ops.focus_general(D, D, D, impl="cuda", **kw)
        Up = ops.focus_general(D, D, D, impl="torch", **kw)
        compare(f"focus {w.name} n={n}", Uk, Up, exact_focus(w))
        W = weights_ref(Up)
        routes = ([dict(xw_offsets=(0, 0)),
                   dict(xwins=index_xwins(0, n, 0, n, device=dev))]
                  if w.needs_index_tiebreak else [{}])
        for r in routes:
            Ck = ops.cohesion_general(D, D, D, W, impl="cuda", **kw, **r)
            Cp = ops.cohesion_general(D, D, D, W, impl="torch", **kw, **r)
            compare(f"cohesion {w.name} n={n} {sorted(r)}", Ck, Cp, False)
            checked += 1
        Uk = ops.focus(Da, impl="cuda", **kw)
        Up = ops.focus(Da, impl="torch", **kw)
        compare(f"focus {w.name} n={n} asymmetric", Uk, Up, exact_focus(w))
        Uk = ops.focus_general(DXZ, DYZ, DXY, impl="cuda", **kw)
        Up = ops.focus_general(DXZ, DYZ, DXY, impl="torch", **kw)
        compare(f"focus {w.name} {(mx, my, mz)}", Uk, Up, exact_focus(w))
        routes = ([dict(xw_offsets=offs), dict(xwins=XWr)]
                  if w.needs_index_tiebreak else [{}])
        for r in routes:
            Ck = ops.cohesion_general(DXZ, DYZ, DXY, Wr, impl="cuda", **kw, **r)
            Cp = ops.cohesion_general(DXZ, DYZ, DXY, Wr, impl="torch", **kw,
                                      **r)
            compare(f"cohesion {w.name} {(mx, my, mz)} {sorted(r)}", Ck, Cp,
                    False)
            checked += 1
        checked += 3
    torch.cuda.synchronize()
    print(f"phase 2: {checked} kernel-vs-plain checks passed (U bitwise "
          f"except soft; soft U and every C within rtol {RTOL}, atol {ATOL})")


def clustered_points(n, d, seed):
    """Four planted, well-separated clusters of very different scales."""
    rng = np.random.default_rng(seed)
    sizes = [n // 8, n // 4, n // 4, n - n // 8 - 2 * (n // 4)]
    scales = [0.05, 0.5, 2.0, 8.0]
    centers = np.zeros((4, d))
    centers[:, 0] = [0.0, 100.0, 300.0, 700.0]
    X = np.concatenate([rng.normal(size=(s, d)) * sc + c
                        for s, sc, c in zip(sizes, scales, centers)])
    labels = np.repeat(np.arange(4), sizes)
    return X.astype(np.float32), labels


def distances_on_device(X):
    """Euclidean D by the difference formula in row chunks: bitwise
    symmetric (the same ops in the same order for (i, j) and (j, i)) with
    an exactly-zero diagonal.  torch.cdist's matmul mode is neither."""
    import torch

    n, d = X.shape
    D = torch.empty((n, n), dtype=torch.float32, device=X.device)
    for s in range(0, n, 512):
        diff = X[s:s + 512, None, :] - X[None, :, :]
        sq = diff * diff
        acc = sq[..., 0]
        for k in range(1, d):
            acc = acc + sq[..., k]
        D[s:s + 512] = torch.sqrt(acc)
    return D


def phase_main_path(dev, n=N_MAIN, d=D_MAIN):
    """Phase 3: the user's entry point at full size, through both kernels."""
    import torch
    from repro_torch.core import pald
    from repro_torch.kernels import ops, pald_cohesion, pald_focus

    X, labels = clustered_points(n, d, SEED)
    D = distances_on_device(torch.as_tensor(X, device=dev))
    if not torch.equal(D, D.T) or bool((torch.diagonal(D) != 0).any()):
        fail("D is not bitwise symmetric with a zero diagonal")

    def plain_called(*a, **k):
        fail("a plain torch version ran on the main path")

    patched = [(ops, "focus_general_torch"), (ops, "cohesion_general_torch"),
               (pald_focus, "focus_general_torch"),
               (pald_cohesion, "cohesion_general_torch")]
    saved = [getattr(m, a) for m, a in patched]
    for m, a in patched:
        setattr(m, a, plain_called)
    kernels = (pald_focus.focus_general_cuda,
               pald_cohesion.cohesion_general_cuda)
    try:
        for k in kernels:
            k.launches = k.grid_launches = 0
        pald_focus.reset_tile_counts()
        t0 = time.perf_counter()
        C = pald.cohesion(D, method="kernel", ties="ignore")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"focus": kernels[0].launches,
                    "cohesion": kernels[1].launches}
        GRIDS.update(focus_general=kernels[0].grid_launches,
                     cohesion_general=kernels[1].grid_launches)
        tiles = pald_focus.tile_counts(D.device)
    finally:
        for (m, a), f in zip(patched, saved):
            setattr(m, a, f)
    print(f"phase 3: cohesion(D, method='kernel', ties='ignore') n={n} "
          f"d={d}: {secs:.3f} s wall (first call), launches {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path was not launched: {launches}")
    focus_blocks_check(3, "focus_general", tiles, n)
    BLOCKS["focus_general"] = tiles[0]
    if C.shape != (n, n) or C.dtype != torch.float32 or C.device != D.device:
        fail(f"C is {tuple(C.shape)} {C.dtype} on {C.device}")
    if not bool(torch.isfinite(C).all()):
        fail("C has non-finite values")
    mass = float(C.double().sum())
    if abs(mass - n / 2) > 1e-4 * n / 2:
        fail(f"mass {mass!r} != n/2 = {n / 2}")
    print(f"phase 3: mass sum(C) = {mass!r} (n/2 = {n / 2})")

    U_slab, r0 = slab_check(3, C, D, "ignore")
    communities_check(3, C, labels)
    return D, launches, U_slab, r0


def focus_blocks_check(phase, name, tiles, n):
    """The focus kernel ran the nb (nb + 1) / 2 upper tile pairs of the
    symmetric D and no tile pair twice, as the kernel counted them
    (``tiles``: ``pald_focus.tile_counts`` over the one call); fails
    otherwise."""
    from repro_torch.kernels import pald_focus

    blocks, again = tiles
    upper = pald_focus.focus_blocks(n, n, True)
    full = pald_focus.focus_blocks(n, n, False)
    print(f"phase {phase}: {name} ran {blocks} thread blocks (upper tile "
          f"pairs {upper}, the full grid {full}); tile pairs run twice "
          f"(asymmetric thresholds): {again}")
    if blocks != upper or again:
        fail(f"{name} did not run each upper tile pair of the symmetric D "
             f"once")


def slab_check(phase, C, D, ties):
    """A contiguous 64-row slab of C (normalized), not tile-aligned,
    recomputed by the plain versions through the rectangular forms with
    global offsets (rtol 1e-4), and held to the conformance tolerance
    against the same float32 terms summed in float64 (how far each
    float32 sum order drifts).  Returns the slab's U and first row."""
    import torch
    from repro_torch.kernels import ops

    n = D.shape[0]
    r0 = min(3001, n - SLAB)
    rows = D[r0:r0 + SLAB]
    U_slab = ops.focus_general(rows, D, rows, impl="torch", ties=ties)
    zero = U_slab == 0
    W_slab = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, U_slab))
    diag = torch.arange(SLAB, device=D.device)
    W_slab[diag, r0 + diag] = 0.0
    C_slab = ops.cohesion_general(rows, D, rows, W_slab, impl="torch",
                                  ties=ties, xw_offsets=(r0, 0)) / (n - 1)
    compare(f"C rows {r0}:{r0 + SLAB}", C[r0:r0 + SLAB], C_slab, False,
            rtol=RTOL_MAIN)
    C64 = cohesion_slab_f64(rows, D, W_slab, r0, ties=ties) / (n - 1)
    rel = {k: float(((v.double() - C64).abs() / C64.abs().clamp_min(1e-300))
                    .max()) for k, v in (("kernel", C[r0:r0 + SLAB]),
                                         ("plain", C_slab))}
    print(f"phase {phase}: C rows {r0}:{r0 + SLAB} against a float64 sum of "
          f"the same terms: max relative error kernel {rel['kernel']!r}, "
          f"plain {rel['plain']!r}")
    compare(f"C rows {r0}:{r0 + SLAB} vs float64", C[r0:r0 + SLAB].double(),
            C64, False)
    return U_slab, r0


def communities_check(phase, C, labels):
    """Every community of C inside one planted cluster, and each cluster's
    largest community at least half of it."""
    from repro_torch.core import analysis

    comms = analysis.communities(C.cpu().numpy())
    mixed = [c for c in comms if len(set(labels[c].tolist())) > 1]
    if mixed:
        fail(f"{len(mixed)} communities span planted clusters")
    sizes = np.bincount(labels)
    largest = [max((len(c) for c in comms if labels[c[0]] == k), default=0)
               for k in range(len(sizes))]
    print(f"phase {phase}: {len(comms)} communities, each inside one planted "
          f"cluster; largest per cluster {largest} of {sizes.tolist()}")
    if any(2 * big < size for big, size in zip(largest, sizes)):
        fail("a planted cluster is not recovered: its largest community "
             "holds less than half of it")


def cohesion_slab_f64(rows, D, W_slab, r0, chunk=64, ties="ignore"):
    """Un-normalized C[r0:r0+m] with the float32 support terms accumulated
    in float64."""
    import torch
    from repro_torch.core.weights import index_xwins, support_weight

    m, n = rows.shape
    C = torch.zeros((m, n), dtype=torch.float64, device=rows.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        own = index_xwins(r0, m, s, e - s, device=rows.device)[:, :, None]
        g = support_weight(rows[:, None, :], D[None, s:e, :],
                           rows[:, s:e, None], ties, own)
        C += torch.einsum("xyz,xy->xz", g.double(), W_slab[:, s:e].double())
    return C


def time_ms(fn, reps, warm=True):
    """Median of ``reps`` CUDA-event timings after one warm-up call
    (``warm=False``: none, the caller has run ``fn`` already; the output
    is then the last timed call's)."""
    import torch

    out = fn() if warm else None
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        last = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out if warm else last


def pass_ops(pass_, n):
    """Lane instructions that a pass over a square symmetric D needs at
    least.  U[x, y] and the support between x and y are functions of the
    unordered pair {x, y}, so the work is counted once per (unordered pair,
    z): focus = min + compare + add over the n (n + 1) / 2 pairs (U's
    diagonal is an output); cohesion = min, compare with d_xy, d_xz < d_yz,
    d_yz < d_xz and one predicated add per role (6) over the n (n - 1) / 2
    pairs with x != y (W[x, x] = 0: the diagonal adds nothing).  The dense,
    tri and fused kernels compute the same U and C, so they share it."""
    if pass_ == "focus":
        return 3 * (n * (n + 1) // 2) * n
    return 6 * (n * (n - 1) // 2) * n


def bound_ms(pass_, n, clock_mhz):
    """Least time for a pass on a square symmetric D (dense or tri): the
    larger of its bytes (D, and W for cohesion, read once, the output
    written once) over HBM bandwidth and :func:`pass_ops` over the FP32
    lanes at the card's maximum SM clock."""
    nbytes = 4 * n * n * (2 if pass_ == "focus" else 3)
    ops = pass_ops(pass_, n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (FP32_LANES * clock_mhz * 1e6)
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                        else "bytes")


ALU_LANES = 64 * 132        # the ALU pipe (FSETP, FSEL, FMNMX): 16 lanes a
#                             sub-partition, half the FP32 pipe's width


def compare_bound_ms(pass_, n, clock_mhz):
    """A strict pass's least time at the compare rate, which the ALU pipe
    issues at half the FP32 rate on an H100 (a micro-probe, PERF.md
    section 6).  Cohesion: 3 ALU-pipe instructions per unordered pair
    {x, y} with x != y and z (the min of the two distances, the focus
    compare and the ordering compare, each serving both roles), the same
    time as :func:`bound_ms`'s 3 per ordered triple at the FP32 rate.
    Focus: 2 per unordered pair (U's diagonal included) and z, the min and
    the compare (the add is on the FP32 pipe), above :func:`bound_ms`,
    which counts all three at the FP32 rate."""
    if pass_ == "focus":
        work = 2 * (n * (n + 1) // 2) * n
    else:
        work = 3 * (n * (n - 1) // 2) * n
    return 1e3 * work / (ALU_LANES * clock_mhz * 1e6)


def phase_timing(D, launches, U_slab, r0, clock_mhz, reps=5):
    """Phase 4: kernel and plain version at the main path's shapes."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weights_ref

    n = D.shape[0]
    src = {"focus": ("src/repro_torch/csrc/pald_focus.cu",
                     "src/repro/kernels/pald_focus.py:55"),
           "cohesion": ("src/repro_torch/csrc/pald_cohesion.cu",
                        "src/repro/kernels/pald_cohesion.py:134")}

    def timed(name, kernel, plain):
        ms_k, out_k = time_ms(kernel, reps)
        # the plain version once (8-10 s a call; phase 2 ran its ops)
        ms_p, out_p = time_ms(plain, 1, warm=False)
        b_ms, b_by = bound_ms(name, n, clock_mhz)
        cmp = (f", floor at the compare rate "
               f"{compare_bound_ms(name, n, clock_mhz)!r} ms")
        print(f"phase 4: {name} n={n}: kernel {ms_k!r} ms, plain {ms_p!r} "
              f"ms, bound {b_ms!r} ms ({b_by}; {pass_ops(name, n)} lane "
              f"instructions at {clock_mhz} MHz), kernel/bound "
              f"{ms_k / b_ms:.3f}{cmp}, library: none")
        row = {"name": f"{name}_general", "route": "cuda",
               "source": src[name][0], "replaces": src[name][1],
               "launches": launches[name],
               "grid_launches": GRIDS[f"{name}_general"],
               "max_abs_err": None, "ms": ms_k, "plain_ms": ms_p,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if name == "focus":
            row["blocks"] = BLOCKS["focus_general"]
        return row, out_k, out_p

    focus_row, Uk, Up = timed(
        "focus", lambda: ops.focus(D, impl="cuda", ties="ignore"),
        lambda: ops.focus(D, impl="torch", ties="ignore"))
    focus_row["max_abs_err"] = compare(f"focus n={n}", Uk, Up, True)
    compare(f"U rows {r0}:{r0 + SLAB}", Uk[r0:r0 + SLAB], U_slab, True)
    del Up
    focus_asymmetric(D, ms_sym=focus_row["ms"], reps=reps)
    W = weights_ref(Uk)
    coh_row, Ck, Cp = timed(
        "cohesion",
        lambda: ops.cohesion_from_weights(D, W, impl="cuda", ties="ignore"),
        lambda: ops.cohesion_from_weights(D, W, impl="torch", ties="ignore"))
    coh_row["max_abs_err"] = compare(f"cohesion n={n}", Ck, Cp, False,
                                     rtol=RTOL_MAIN)
    return [focus_row, coh_row]


# the tile pair (X, Y) that phase 4 makes asymmetric
ASYM_TILE = (10, 40)


def focus_asymmetric(D, ms_sym, reps):
    """Phase 4's last step: ``ops.focus`` on D with one upper tile
    D[X, Y] perturbed.  The square entry runs the same nb (nb + 1) / 2
    blocks, that one tile pair twice (its mirror from the thresholds
    D[y, x]); U bitwise the plain version's, which computes both orders of
    every pair."""
    from repro_torch.kernels import ops, pald_focus

    n = D.shape[0]
    t = pald_focus.TILE
    (bx, by) = ASYM_TILE
    Da = D.clone()
    xs, ys = slice(bx * t, (bx + 1) * t), slice(by * t, (by + 1) * t)
    Da[xs, ys] = Da[xs, ys] * 1.25 + 0.5
    pald_focus.reset_tile_counts()
    Ua = ops.focus(Da, impl="cuda", ties="ignore")
    blocks, again = pald_focus.tile_counts(D.device)
    ms_a, Ua2 = time_ms(lambda: ops.focus(Da, impl="cuda", ties="ignore"),
                        reps)
    compare("U asymmetric twice", Ua2, Ua, True)
    del Ua2
    compare("U asymmetric", Ua, ops.focus(Da, impl="torch", ties="ignore"),
            True)
    print(f"phase 4: focus n={n} on D with tile {ASYM_TILE} perturbed "
          f"(asymmetric): {ms_a!r} ms (symmetric D {ms_sym!r} ms, "
          f"{ms_a / ms_sym:.3f}x), {blocks} thread blocks, tile pairs run "
          f"twice {again}; U bitwise the plain version's")
    if blocks != pald_focus.focus_blocks(n, n, True) or again != 1:
        fail("the asymmetric D did not run the upper tile pairs with one "
             "of them twice")


def phase_families(D, reps=3):
    """Phase 5: every built-in family's kernels at the main path's size
    (kernel times only; the main path runs ``ignore``).  Returns
    {family: (focus ms, cohesion ms)}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weights_ref

    n = D.shape[0]
    times = {}
    for w in functionals():
        ms_f, U = time_ms(lambda: ops.focus(D, impl="cuda", ties=w), reps)
        W = weights_ref(U)
        ms_c, _ = time_ms(lambda: ops.cohesion_from_weights(
            D, W, impl="cuda", ties=w), reps)
        print(f"phase 5: {w.name} n={n}: focus kernel {ms_f!r} ms, cohesion "
              f"kernel {ms_c!r} ms (median of {reps})")
        times[w.name] = (ms_f, ms_c)
    return times


def fused_features(rng, n, d, dev):
    """Features quantized to 0.1 (rounded products and sums, exact ties),
    every fifth row a duplicate of an earlier one; no +inf."""
    import torch

    X = np.round(rng.normal(size=(n, d)) * 10) / 10
    dup = np.arange(5, n, 5)
    X[dup] = X[rng.integers(0, 5, size=dup.size)]
    return torch.as_tensor(X.astype(np.float32), device=dev)


# the fused passes' panel rows in phase 6 (n = 257): the default (one
# 320-row panel), then five panels and two, the last one ragged
PANEL_SIZES = (None, 64, 192)


def phase_fused_vs_plain(dev) -> None:
    """Phase 6: the fused kernels against their plain versions and against
    the dense kernels on the same distances, each at three panel sizes."""
    import torch
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import ops, pald_fused
    from repro_torch.kernels.ref import weights_ref

    rng = np.random.default_rng(SEED + 6)
    n = 257
    checked = 0
    c_bitwise = c_total = 0
    for d in (1, 5, 300):
        X = fused_features(rng, n, d, dev)
        for metric in METRICS:
            D = cdist_reference(X, metric=metric)
            compare(f"fused distances {metric} d={d}",
                    pald_fused.dist_fused_cuda(X, metric=metric), D, True)
            checked += 1
            for w in functionals():
                kw = dict(metric=metric, ties=w)
                tag = f"{w.name} {metric} n={n} d={d}"
                Ks = {P: pald_fused.focus_fused_cuda(X, _panel_rows=P, **kw)
                      for P in PANEL_SIZES}
                Uk = Ks[None]
                Up = pald_fused.focus_fused_torch(X, **kw)
                compare(f"focus_fused {tag}", Uk, Up, exact_focus(w))
                W = weights_ref(Up)
                Cs = {P: pald_fused.cohesion_fused_cuda(X, W, _panel_rows=P,
                                                        **kw)
                      for P in PANEL_SIZES}
                Ck = Cs[None]
                Cp = pald_fused.cohesion_fused_torch(X, W, **kw)
                compare(f"cohesion_fused {tag}", Ck, Cp, False)
                for P in PANEL_SIZES[1:]:
                    compare(f"focus_fused P={P} vs default P {tag}", Ks[P],
                            Uk, True)
                    compare(f"cohesion_fused P={P} vs default P {tag}",
                            Cs[P], Ck, True)
                    checked += 2
                # the dense kernels on the same distances: the same loops
                Ud = ops.focus(D, impl="cuda", ties=w)
                compare(f"focus_fused vs dense {tag}", Uk, Ud,
                        exact_focus(w))
                Cd = ops.cohesion_from_weights(D, W, impl="cuda", ties=w)
                compare(f"cohesion_fused vs dense {tag}", Ck, Cd, False)
                c_bitwise += bool(torch.equal(Ck, Cd))
                c_total += 1
                checked += 4
    torch.cuda.synchronize()
    print(f"phase 6: {checked} fused checks passed (distances bitwise; U "
          f"bitwise except soft against the plain versions and the dense "
          f"kernels; C within rtol {RTOL}, atol {ATOL}; U and C bitwise "
          f"across panel sizes {PANEL_SIZES[1:]} and the default "
          f"{pald_fused.panel_rows(n)})")
    print(f"phase 6: C bitwise the dense kernels' in {c_bitwise} of "
          f"{c_total}")


def phase_fused_main_path(dev, n=N_MAIN, d=D_FUSED):
    """Phase 7: ``pald.from_features(X)`` at full size, default knobs."""
    import torch
    from repro_torch.core import pald
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import (ops, pald_cohesion, pald_focus,
                                     pald_fused)

    X, labels = clustered_points(n, d, SEED)
    Xg = torch.as_tensor(X, device=dev)

    def plain_called(*a, **k):
        fail("a plain torch version ran on the fused main path")

    patched = [(ops, "focus_fused_torch"), (ops, "cohesion_fused_torch"),
               (pald_fused, "focus_fused_torch"),
               (pald_fused, "cohesion_fused_torch"),
               (ops, "focus_general_torch"), (ops, "cohesion_general_torch"),
               (pald_focus, "focus_general_torch"),
               (pald_cohesion, "cohesion_general_torch")]
    saved = [getattr(m, a) for m, a in patched]
    for m, a in patched:
        setattr(m, a, plain_called)
    counted = {"focus_fused": pald_fused.focus_fused_cuda,
               "cohesion_fused": pald_fused.cohesion_fused_cuda,
               "focus_general": pald_focus.focus_general_cuda,
               "cohesion_general": pald_cohesion.cohesion_general_cuda}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for k in counted.values():
            k.launches = k.grid_launches = 0
        t0 = time.perf_counter()
        C = pald.from_features(Xg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {name: k.launches for name, k in counted.items()}
        GRIDS.update((name, counted[name].grid_launches)
                     for name in ("focus_fused", "cohesion_fused"))
        peak_fused = torch.cuda.max_memory_allocated() - base
    finally:
        for (m, a), f in zip(patched, saved):
            setattr(m, a, f)
    print(f"phase 7: from_features(X) n={n} d={d} (euclidean, drop, auto -> "
          f"fused): {secs:.3f} s wall (first call), launches {launches}")
    if launches["focus_fused"] != 1 or launches["cohesion_fused"] != 1:
        fail(f"the fused kernels did not run once each: {launches}")
    if launches["focus_general"] or launches["cohesion_general"]:
        fail(f"a dense kernel ran on the fused path: {launches}")
    if C.shape != (n, n) or C.dtype != torch.float32 or C.device != Xg.device:
        fail(f"C is {tuple(C.shape)} {C.dtype} on {C.device}")
    if not bool(torch.isfinite(C).all()):
        fail("C has non-finite values")
    mass = float(C.double().sum())
    if abs(mass - n / 2) > 1e-4 * n / 2:
        fail(f"mass {mass!r} != n/2 = {n / 2}")
    print(f"phase 7: mass sum(C) = {mass!r} (n/2 = {n / 2})")

    # the same call through materialize-then-kernel: D is an extra buffer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    Cm = pald.from_features(Xg, method="kernel")
    torch.cuda.synchronize()
    peak_kernel = torch.cuda.max_memory_allocated() - base
    buf = 4 * n * n
    print(f"phase 7: peak device memory above the input: fused "
          f"{peak_fused} B ({peak_fused / buf:.3f} n^2 float32 buffers), "
          f"materialize-then-kernel {peak_kernel} B "
          f"({peak_kernel / buf:.3f}); difference "
          f"{(peak_kernel - peak_fused) / buf:.3f} buffers")
    if peak_kernel - peak_fused < buf:
        fail("the fused path's peak memory is not one n^2 float32 buffer "
             "below the materialize-then-kernel path's")
    rows, stride = pald_fused.panel_rows(n), pald_fused.panel_stride(n)
    panel = 4 * rows * stride
    want = pald_fused.fused_grids(n, "euclidean")
    print(f"phase 7: distance panel {rows} x {stride} float32 = {panel} B "
          f"({panel / buf:.3f} n^2 buffers; budget "
          f"{pald_fused.PANEL_BUDGET} B), {-(-n // rows)} panels a pass; "
          f"grid launches focus_fused {GRIDS['focus_fused']}, "
          f"cohesion_fused {GRIDS['cohesion_fused']} (1 + 2 ceil(n/P) = "
          f"{want})")
    if panel > pald_fused.PANEL_BUDGET:
        fail(f"the panel ({rows} rows, {panel} B) is over its budget")
    if GRIDS["focus_fused"] != want or GRIDS["cohesion_fused"] != want:
        fail(f"the fused passes did not issue {want} grids each")
    compare("C fused vs materialize-then-kernel", C, Cm, False,
            rtol=RTOL_MAIN)
    same = bool(torch.equal(C, Cm))
    print(f"phase 7: C fused bitwise equal to materialize-then-kernel: "
          f"{same}")
    if not same:
        fail("C fused is not bitwise the materialize-then-kernel C")
    del Cm

    # the slab by the plain versions on the materialized distances
    # (bitwise the kernels' own)
    D = cdist_reference(Xg)
    slab_check(7, C, D, "drop")
    communities_check(7, C, labels)
    return Xg, D, launches


def fused_bound_ms(pass_, n, d, clock_mhz):
    """Least time for a fused pass: the larger of its bytes (X and, for
    cohesion, W read once, the output written once) over HBM bandwidth and
    its lane instructions (:func:`pass_ops`, plus the symmetric distance
    work, 2d + 4 for each of the n (n - 1) / 2 unordered pairs) over the
    FP32 lanes at the maximum clock."""
    nbytes = 4 * (n * d + n * n + (n * n if pass_ == "cohesion" else 0))
    ops = pass_ops(pass_, n) + n * (n - 1) // 2 * (2 * d + 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (FP32_LANES * clock_mhz * 1e6)
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                        else "bytes")


# panel rows timed in phase 8 (n = 8192: 32 to 2 panels)
PANEL_SWEEP = (256, 512, 1024, 2048, 4096)


def phase_fused_timing(Xg, D, launches, clock_mhz, dense_families, reps=5):
    """Phase 8: the fused kernels and their plain versions at the main
    path's shapes, a sweep of the panel rows, each family's fused kernels
    beside phase 5's dense ones, then from_features end to end for every
    metric, fused against materialize-then-kernel."""
    import torch
    from repro_torch.core import pald
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import ops, pald_fused
    from repro_torch.kernels.ref import weights_ref

    n, d = Xg.shape
    replaces = {"focus": "src/repro/kernels/pald_fused.py:71",
                "cohesion": "src/repro/kernels/pald_fused.py:144"}
    rows = []

    def timed(name, kernel, plain):
        ms_k, out_k = time_ms(kernel, reps)
        ms_p, out_p = time_ms(plain, 1, warm=False)  # phase 6 ran its ops
        b_ms, b_by = fused_bound_ms(name, n, d, clock_mhz)
        print(f"phase 8: {name}_fused n={n} d={d}: kernel {ms_k!r} ms, plain "
              f"{ms_p!r} ms, bound {b_ms!r} ms ({b_by}), kernel/bound "
              f"{ms_k / b_ms:.3f}, loops' floor at the compare rate "
              f"{compare_bound_ms(name, n, clock_mhz)!r} ms, library: none")
        rows.append({"name": f"{name}_fused", "route": "cuda",
                     "source": "src/repro_torch/csrc/pald_fused.cu",
                     "replaces": replaces[name],
                     "launches": launches[f"{name}_fused"],
                     "grid_launches": GRIDS[f"{name}_fused"],
                     "max_abs_err": None, "ms": ms_k, "plain_ms": ms_p,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        return out_k, out_p

    # the plain versions with (512, n) slabs: fewer, larger launches
    Uk, Up = timed("focus",
                   lambda: pald_fused.focus_fused_cuda(Xg, ties="drop"),
                   lambda: pald_fused.focus_fused_torch(Xg, block=512,
                                                        ties="drop"))
    rows[0]["max_abs_err"] = compare(f"focus_fused n={n}", Uk, Up, True)
    compare(f"focus_fused vs dense kernel n={n}", Uk,
            ops.focus(D, impl="cuda", ties="drop"), True)
    W = weights_ref(Uk)
    del Up
    Ck, Cp = timed("cohesion",
                   lambda: pald_fused.cohesion_fused_cuda(Xg, W, ties="drop"),
                   lambda: pald_fused.cohesion_fused_torch(Xg, W, block=512,
                                                           ties="drop"))
    rows[1]["max_abs_err"] = compare(f"cohesion_fused n={n}", Ck, Cp, False,
                                     rtol=RTOL_MAIN)
    del Cp

    for P in PANEL_SWEEP:
        ms_f, U_P = time_ms(lambda: pald_fused.focus_fused_cuda(
            Xg, ties="drop", _panel_rows=P), 3)
        compare(f"focus_fused P={P}", U_P, Uk, True)
        del U_P
        ms_c, C_P = time_ms(lambda: pald_fused.cohesion_fused_cuda(
            Xg, W, ties="drop", _panel_rows=P), 3)
        compare(f"cohesion_fused P={P}", C_P, Ck, True)
        del C_P
        print(f"phase 8: panel P={P} ({4 * P * pald_fused.panel_stride(n)} "
              f"B, {-(-n // P)} panels) n={n} d={d}: focus_fused {ms_f!r} "
              f"ms, cohesion_fused {ms_c!r} ms (drop; median of 3; default "
              f"P={pald_fused.panel_rows(n)})")
    del Uk, Ck, W

    for w in functionals():
        ms_f, Uw = time_ms(lambda: pald_fused.focus_fused_cuda(Xg, ties=w), 3)
        Ww = weights_ref(Uw)
        del Uw
        ms_c, _ = time_ms(lambda: pald_fused.cohesion_fused_cuda(
            Xg, Ww, ties=w), 3)
        del Ww
        f_d, c_d = dense_families[w.name]
        print(f"phase 8: {w.name} n={n} d={d}: focus_fused {ms_f!r} ms "
              f"(dense focus, phase 5: {f_d!r}), cohesion_fused {ms_c!r} ms "
              f"(dense cohesion, phase 5: {c_d!r}; median of 3)")

    ms_cd, _ = time_ms(lambda: cdist_reference(Xg), 3)
    print(f"phase 8: cdist_reference (plain torch, euclidean) n={n} d={d}: "
          f"{ms_cd!r} ms")
    for metric in METRICS:
        ms_f, _ = time_ms(lambda: pald_fused.focus_fused_cuda(
            Xg, metric=metric), 3)
        Wm = weights_ref(pald_fused.focus_fused_cuda(Xg, metric=metric))
        ms_c, _ = time_ms(lambda: pald_fused.cohesion_fused_cuda(
            Xg, Wm, metric=metric), 3)
        del Wm
        ms_e, _ = time_ms(lambda: pald.from_features(Xg, metric=metric), 3)
        ms_m, _ = time_ms(lambda: pald.from_features(
            Xg, metric=metric, method="kernel"), 3)
        print(f"phase 8: {metric} n={n} d={d}: focus_fused {ms_f!r} ms, "
              f"cohesion_fused {ms_c!r} ms; from_features end to end: fused "
              f"{ms_e!r} ms, materialize-then-kernel {ms_m!r} ms "
              f"(fused/materialize {ms_e / ms_m:.3f}; median of 3)")
    return rows


# ---------------------------------------------------------------------------
# the sparse k-NN slice (phases 9-11)
# ---------------------------------------------------------------------------
def knn_features(rng, n, d, dev):
    """Features quantized to 0.1 (exact ties at the k boundary), every
    fifth row a duplicate of an earlier one (zero distances)."""
    import torch

    X = np.round(rng.normal(size=(n, d)) * 10) / 10
    dup = np.arange(5, n, 5)
    X[dup] = X[rng.integers(0, 5, size=dup.size)]
    return torch.as_tensor(X.astype(np.float32), device=dev)


def host_dist_steps(n=257, d=1, seed=1):
    """The plain distance code on the host CPU against numpy float32, which
    rounds every IEEE operation exactly, on the input on which
    ``cdist_reference`` once differed from the kernels (ragged n = 257,
    d = 1, features quantized to 0.1).  First each float32 torch operation
    of the euclidean distance alone, fed numpy's operands (a report: it
    names the operation a CPU rounds otherwise, at 1 to 8 threads), then
    ``row_norms``, ``finish_dist`` and ``cdist_reference`` themselves,
    which must be bitwise numpy's steps."""
    import torch
    from repro_torch.core.features import (cdist_reference, finish_dist,
                                           row_norms)

    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, d)) * 10) / 10
    X[5::5] = X[rng.integers(0, 5, size=X[5::5].shape[0])]
    X = X.astype(np.float32)
    f32 = np.float32
    na = np.zeros(n, f32)
    acc = np.zeros((n, n), f32)
    for k in range(d):
        na = na + X[:, k] * X[:, k]
        acc = acc + X[:, None, k] * X[None, :, k]
    s = na[:, None] + na[None, :]
    t = f32(2) * acc
    d2 = np.maximum(s - t, f32(0))
    D = np.sqrt(d2)
    np.fill_diagonal(D, 0)
    T = torch.from_numpy
    steps = {
        "a*b": (lambda: T(X[:, None, 0]) * T(X[None, :, 0]),
                X[:, None, 0] * X[None, :, 0]),
        "na+nb": (lambda: T(na)[:, None] + T(na)[None, :], s),
        "2*acc": (lambda: 2.0 * T(acc), t),
        "s-t": (lambda: T(s) - T(t), s - t),
        "sqrt": (lambda: torch.sqrt(T(d2).double()).float(), np.sqrt(d2)),
    }
    report = {name: [] for name in steps}
    for threads in (1, 8):
        before = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            for name, (op, want) in steps.items():
                report[name].append(str(int((op().numpy() != want).sum())))
            got_n = row_norms(T(X), "euclidean").numpy()
            got_f = finish_dist(T(acc), T(na)[:, None], T(na)[None, :],
                                "euclidean").numpy()
            got_c = cdist_reference(T(X)).numpy()
        finally:
            torch.set_num_threads(before)
        for what, got, want in (("row_norms", got_n, na),
                                ("finish_dist", got_f, np.sqrt(d2)),
                                ("cdist_reference", got_c, D)):
            if not np.array_equal(got, want):
                fail(f"{what} on the host at {threads} threads: "
                     f"{int((got != want).sum())} entries differ from numpy "
                     "float32's steps")
    print(f"phase 9: host CPU ({torch.backends.cpu.get_cpu_capability()}), "
          f"float32 torch ops against numpy's, entries that differ of "
          f"{n * n} at 1/8 threads: "
          f"{', '.join(k + ' ' + '/'.join(v) for k, v in report.items())}; "
          f"row_norms, finish_dist and "
          f"cdist_reference bitwise numpy float32's steps at 1 and 8 threads")


def phase_knn_vs_plain(dev) -> None:
    """Phase 9: the plain distance steps on the host; the selection kernel
    bitwise against its plain version; both kernels' shared memory
    against the Python copies of their layouts; the values kernel's cube
    source against its plain version, its features and D sources bitwise
    against the cube source, and at k = n-1 against the dense kernels."""
    import torch
    from repro_torch.core import knn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import _build, ops, pald_knn, pald_topk

    host_dist_steps()
    rng = np.random.default_rng(SEED + 9)
    topk_checks = 0
    for n in (1, 2, 33, 257, 1000):
        for d in (1, 5, 8, 300):
            X = knn_features(rng, n, d, dev)
            ks = sorted({k for k in (1, 7, 32, n - 1) if 0 <= k <= n - 1})
            for metric in METRICS:
                for k in ks:
                    gk = pald_topk.topk_select_cuda(X, k, metric=metric)
                    gp = pald_topk.topk_select_torch(X, k, metric=metric)
                    tag = f"topk {metric} n={n} d={d} k={k}"
                    compare(f"{tag} indices", gk.indices, gp.indices, True)
                    compare(f"{tag} distances", gk.distances, gp.distances,
                            True)
                    topk_checks += 1
    smem_checks = 0
    topk_c = _build.load("pald_topk_smem_bytes")
    knn_c = _build.load("pald_knn_smem_bytes")
    for k in (1, 31, 32, 33, 128, 129, 256, 257, pald_topk.LARGE_K,
              pald_topk.LARGE_K + 1, 2048, 4096, 16384):
        if knn_c(k, -1) != pald_knn.smem_per_cta(k):
            fail(f"pald_knn shared memory at k={k}: the kernel's "
                 f"{knn_c(k, -1)} B, smem_per_cta {pald_knn.smem_per_cta(k)}")
        for d in (0, 1, 5, 8, 64, 65, 300):
            got = (topk_c(k, d), knn_c(k, d))
            want = (pald_topk.smem_per_cta(k, d),
                    pald_knn.smem_per_cta(k, d))
            if got != want:
                fail(f"shared memory at k={k}, d={d}: the kernels' {got} B, "
                     f"smem_per_cta {want}")
            smem_checks += 1
    n = 257
    X = knn_features(rng, n, 5, dev)
    D = cdist_reference(X)
    val_checks = bitwise = sources = 0
    for k in (1, 4, 32, 33, 100, n - 1):
        graph = pald_topk.topk_select_cuda(X, k)
        idx, dn = graph.indices, graph.distances
        tiles = {"distance": knn.gather_tile_from_distances(D, idx),
                 "features": knn.gather_tile_from_features(X, idx,
                                                           "euclidean")}
        compare(f"gathered tiles k={k}", tiles["features"],
                tiles["distance"], True)
        for w in functionals():
            for kind, g in tiles.items():
                vk = pald_knn.knn_values_cuda(dn, g, idx, ties=w)
                vp = pald_knn.knn_values_torch(dn, g, idx, ties=w)
                compare(f"knn_values {w.name} {kind} n={n} k={k}", vk, vp,
                        False)
                bitwise += bool(torch.equal(vk, vp))
                val_checks += 1
                vs = (pald_knn.knn_values_from_distances_cuda(D, dn, idx,
                                                              ties=w)
                      if kind == "distance" else
                      pald_knn.knn_values_from_features_cuda(X, dn, idx,
                                                             ties=w))
                compare(f"knn_values {w.name} {kind} source vs the cube "
                        f"n={n} k={k}", vs, vk, True)
                sources += 1
            if k == n - 1:
                C = knn.scatter_dense(graph, pald_knn.knn_values_cuda(
                    dn, tiles["distance"], idx, ties=w))
                compare(f"k-NN at k=n-1 vs the dense kernels {w.name}", C,
                        ops.pald(D, impl="cuda", ties=w), False)
                val_checks += 1
    # the features source at every metric, with its rows staged (d = 5)
    # and read from X (d = 300), the tile in shared memory (k <= 64) and
    # not (k = 100)
    for d in (5, 300):
        Xd = knn_features(rng, n, d, dev)
        for metric in METRICS:
            for k in (32, 100):
                graph = pald_topk.topk_select_cuda(Xd, k, metric=metric)
                idx, dn = graph.indices, graph.distances
                g = knn.gather_tile_from_features(Xd, idx, metric)
                for w in functionals()[:3]:
                    vk = pald_knn.knn_values_cuda(dn, g, idx, ties=w)
                    vs = pald_knn.knn_values_from_features_cuda(
                        Xd, dn, idx, metric=metric, ties=w)
                    compare(f"knn_values {w.name} features source {metric} "
                            f"d={d} k={k} vs the cube", vs, vk, True)
                    sources += 1
    torch.cuda.synchronize()
    print(f"phase 9: {topk_checks} selection checks bitwise (indices and "
          f"distances); {smem_checks} (k, d) where both kernels' shared "
          f"memory is smem_per_cta's; {val_checks} values checks "
          f"within rtol {RTOL}, atol {ATOL} ({bitwise} of "
          f"{val_checks - 5} kernel-vs-plain bitwise; k = n-1 against the "
          f"dense kernels for 5 families); {sources} features and D "
          f"sources bitwise the cube source (k in 1, 4, 32, 33, 100, n-1; "
          f"four metrics at d = 5 and 300)")


def make_mixture(n, comm_size, d, seed=0):
    """~n points in n // comm_size well-separated Gaussian communities
    (examples/pald_knn_clusters.py::make_mixture)."""
    rng = np.random.default_rng(seed)
    c = max(n // comm_size, 1)
    centers = rng.normal(size=(c, d)) * (6.0 * c ** (1.0 / d))
    X = np.concatenate(
        [centers[i] + rng.normal(size=(comm_size, d)) for i in range(c)])
    labels = np.repeat(np.arange(c), comm_size)
    return X.astype(np.float32), labels


def knn_values_f64(dn, g, idx, r0, ties):
    """Un-normalized (m, k+1) values with the plain version's float32 terms
    and weights accumulated in float64."""
    import torch
    from repro_torch.core.weights import (focus_weight, resolve_weight,
                                          support_weight)

    w = resolve_weight(ties)
    zero = torch.zeros_like(dn)
    fw_self = focus_weight(zero, dn, dn, w)
    fw = focus_weight(dn[:, None, :], g, dn[:, :, None], w)
    U = fw_self.double() + fw.double().sum(-1)
    W = torch.where(U > 0, 1.0 / torch.where(U > 0, U, 1.0), 0.0)
    rows = r0 + torch.arange(dn.shape[0], device=dn.device)
    ow = rows[:, None] > idx
    sw_self = support_weight(zero, dn, dn, w, ow)
    sw = support_weight(dn[:, None, :], g, dn[:, :, None], w, ow[:, :, None])
    return torch.cat([(sw_self.double() * W).sum(1, keepdim=True),
                      (sw.double() * W[:, :, None]).sum(1)], dim=1)


def knn_slab_check(tag, Xg, graph, vals, r0, k, ties="drop"):
    """Rows r0:r0+64 of a select_cohere result against the plain versions
    (graph bitwise; values to rtol 1e-5) and a float64 sum (rtol 1e-5).
    The values are normalized by n-1, so atol 1e-6 applies before the
    division: it is 1e-6 / (n-1) here."""
    from repro_torch.core import knn
    from repro_torch.kernels import pald_knn, pald_topk

    n = Xg.shape[0]
    sl = slice(r0, r0 + SLAB)
    gp = pald_topk.topk_select_torch(Xg, k, rows=(r0, r0 + SLAB))
    compare(f"{tag} graph indices rows {r0}:{r0 + SLAB}", graph.indices[sl],
            gp.indices, True)
    compare(f"{tag} graph distances rows {r0}:{r0 + SLAB}",
            graph.distances[sl], gp.distances, True)
    g = knn.gather_tile_from_features(Xg, gp.indices, "euclidean")
    vp = pald_knn.knn_values_torch(gp.distances, g, gp.indices, ties=ties,
                                   row_off=r0) / (n - 1)
    atol = ATOL / (n - 1)
    err = compare(f"{tag} values rows {r0}:{r0 + SLAB}", vals[sl], vp, False,
                  atol=atol)
    v64 = knn_values_f64(gp.distances, g, gp.indices, r0, ties) / (n - 1)
    rel = {name: float(((v.double() - v64).abs() /
                        v64.abs().clamp_min(1e-300)).max())
           for name, v in (("kernel", vals[sl]), ("plain", vp))}
    compare(f"{tag} values rows {r0}:{r0 + SLAB} vs float64",
            vals[sl].double(), v64, False, atol=atol)
    print(f"{tag}: rows {r0}:{r0 + SLAB} graph bitwise the plain version's; "
          f"values max |err| {err!r} against it (rtol {RTOL}, atol "
          f"{atol!r}); against a float64 sum of "
          f"the same terms max relative error kernel {rel['kernel']!r}, "
          f"plain {rel['plain']!r}")
    return err


def phase_knn_main_path(dev, n=N_KNN, k=K_KNN, d=D_KNN, comm=COMM_KNN):
    """Phase 10: ``ops.select_cohere`` at the k-NN example's size, through
    both k-NN kernels, then ``cohesion(D, method="knn")`` at n = 8192."""
    import torch
    from repro_torch.core import knn, pald
    from repro_torch.kernels import (ops, pald_cohesion, pald_focus,
                                     pald_fused, pald_knn, pald_topk)

    X, labels = make_mixture(n, comm, d, SEED)
    n = X.shape[0]
    Xg = torch.as_tensor(X, device=dev)

    counted = {"topk_select": pald_topk.topk_select_cuda,
               "knn_values_features": pald_knn.knn_values_from_features_cuda,
               "knn_values_distances":
                   pald_knn.knn_values_from_distances_cuda,
               "knn_values": pald_knn.knn_values_cuda,
               "focus_general": pald_focus.focus_general_cuda,
               "cohesion_general": pald_cohesion.cohesion_general_cuda,
               "focus_fused": pald_fused.focus_fused_cuda,
               "cohesion_fused": pald_fused.cohesion_fused_cuda}
    with plain_forbidden("phase 10"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for f in counted.values():
            f.launches = f.grid_launches = 0
        t0 = time.perf_counter()
        graph, vals = ops.select_cohere(Xg, k=k, metric="euclidean",
                                        normalize=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {name: f.launches for name, f in counted.items()}
        GRIDS.update((name, counted[name].grid_launches)
                     for name in ("topk_select", "knn_values_features",
                                  "knn_values"))
        peak = torch.cuda.max_memory_allocated() - base
    print(f"phase 10: select_cohere(X, k={k}) n={n} d={d} (euclidean, drop):"
          f" {secs:.3f} s wall (first call), launches {launches}, selection "
          f"grids {GRIDS['topk_select']} (row norms, selection)")
    if launches["topk_select"] != 1 or launches["knn_values_features"] != 1:
        fail(f"the k-NN kernels did not run once each: {launches}")
    if any(launches[name] for name in launches
           if name not in ("topk_select", "knn_values_features")):
        fail(f"another kernel or tile source ran on the k-NN path: "
             f"{launches}")
    if GRIDS["topk_select"] != 2:
        fail(f"the selection issued {GRIDS['topk_select']} grids")
    if (tuple(graph.indices.shape) != (n, k) or tuple(vals.shape) != (n, k + 1)
            or vals.device != Xg.device or vals.dtype != torch.float32):
        fail(f"graph {tuple(graph.indices.shape)}, values "
             f"{tuple(vals.shape)} {vals.dtype} on {vals.device}")
    if not bool(torch.isfinite(vals).all()):
        fail("the values have non-finite entries")
    g_bytes = 4 * n * k * k
    terms = {"graph": 8 * n * k, "values": 4 * n * (k + 1), "norms": 4 * n,
             "slack": 1 << 20}
    allowed = sum(terms.values())
    print(f"phase 10: peak device memory above the input {peak} B, allowed "
          f"{allowed} B = {' + '.join(f'{t} {b}' for t, b in terms.items())}"
          f" ({peak / g_bytes:.3f} x the (n, k, k) cube of {g_bytes} B, "
          f"which nothing allocates; a dense D would be {4 * n * n} B)")
    if peak > allowed:
        fail(f"select_cohere peaked at {peak} B above its input, over "
             f"{allowed} B")

    knn_slab_check("phase 10", Xg, graph, vals, min(30001, n - SLAB), k)

    # the example's own check: no strong component spans two communities
    t0 = time.perf_counter()
    comms = knn.communities(graph, vals)
    big = [cc for cc in comms if len(cc) > 1]
    pure = sum(1 for cc in comms if len({labels[m] for m in cc}) == 1)
    covered = sum(len(cc) for cc in big
                  if len(cc) >= 0.5 * comm
                  and len({labels[m] for m in cc}) == 1)
    print(f"phase 10: {len(big)} strong components in "
          f"{time.perf_counter() - t0:.1f} s (host); purity "
          f"{pure / max(len(comms), 1):.1%}, {covered / n:.1%} of points in "
          f"a majority-recovered community")
    if pure != len(comms):
        fail(f"{len(comms) - pure} strong components span two planted "
             "communities")

    # the distance kind: selection by a stable sort of D's rows, then the
    # values kernel, on phase 3's matrix
    Xd, _ = clustered_points(N_MAIN, D_MAIN, SEED)
    D = distances_on_device(torch.as_tensor(Xd, device=dev))
    for f in counted.values():
        f.launches = 0
    t0 = time.perf_counter()
    C = pald.cohesion(D, method="knn", k=k)
    torch.cuda.synchronize()
    secs_d = time.perf_counter() - t0
    launches_d = {name: f.launches for name, f in counted.items()}
    print(f"phase 10: cohesion(D, method='knn', k={k}) n={N_MAIN}: "
          f"{secs_d:.3f} s wall (first call), launches {launches_d}")
    if (launches_d["knn_values_distances"] != 1
            or sum(launches_d.values()) != 1):
        fail(f"cohesion(D, method='knn') did not run the values kernel's D "
             f"source alone, once: {launches_d}")
    gp, vp = ops.pald_knn(D, k=k, impl="torch", normalize=True)
    Cp = knn.scatter_dense(gp, vp)
    compare(f"cohesion(D, method='knn') n={N_MAIN} vs plain", C, Cp, False)
    nnz = int((C != 0).sum())
    print(f"phase 10: C within rtol {RTOL}, atol {ATOL} of the plain "
          f"versions; {nnz} nonzeros (n (k+1) = {N_MAIN * (k + 1)})")
    if nnz > N_MAIN * (k + 1):
        fail("C has entries outside the k-NN restriction")
    del D, C, Cp
    return Xg, graph, launches, secs


def knn_bound_ms(kernel, n, k, d, clock_mhz):
    """Least time for a k-NN kernel's work: the larger of its bytes (each
    input read once, each output written once) over HBM bandwidth and its
    lane instructions over the FP32 lanes at the maximum clock.  Selection:
    X and the (n, k) distances and indices; the distance loop is symmetric
    (d(x, y) and d(y, x) are bitwise equal), so 2d + 4 instructions for
    each of the n (n-1) / 2 unordered pairs, plus one compare for each of
    the n^2 (row, candidate) visits.  Values from the cube: g, dn, idx and
    the (n, k+1) output; n k (k+1) 7 instructions.  Values from D (the D
    source): the entries of the (n, n) D that the rows' neighbor tiles
    hold, at most n k^2 and at most all n^2 of D, with dn, idx and the
    output; the same 7 n k (k+1).  The stage "gather + values" (the
    features source): X, dn, idx and the output; each row's k (k-1) / 2
    tile distances at 2d + 4 and the same 7 k (k+1)."""
    if kernel == "topk_select":
        nbytes = 4 * (n * d + 2 * n * k)
        ops = n * (n - 1) // 2 * (2 * d + 4) + n * n
    elif kernel == "knn_values":
        nbytes = 4 * (n * k * k + 2 * n * k + n * (k + 1))
        ops = 7 * n * k * (k + 1)
    elif kernel == "knn_values_distances":
        nbytes = 4 * (min(n * k * k, n * n) + 2 * n * k + n * (k + 1))
        ops = 7 * n * k * (k + 1)
    else:
        nbytes = 4 * (n * d + 2 * n * k + n * (k + 1))
        ops = n * (k * (k - 1) // 2 * (2 * d + 4) + 7 * k * (k + 1))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (FP32_LANES * clock_mhz * 1e6)
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                        else "bytes")


# The k-NN path before the values kernel built its own tiles, at n =
# 50,000, k = 32, d = 8 (PERF.md; NVIDIA H100 80GB HBM3, 700 W): the plain
# torch gather into the (n, k, k) cube and the values kernel on it (the
# stage the features source replaces), select_cohere, and select_cohere
# at n = 10^6
CUBE_GATHER_MS, CUBE_VALUES_MS = 6.87, 0.248
CUBE_SELECT_COHERE_MS, CUBE_SELECT_COHERE_BIG_S = 13.74, 1.82


def phase_knn_timing(Xg, graph, launches, clock_mhz, reps=5):
    """Phase 11: the selection (at k = 1, 32, 256 and 1024, and on the
    rows in a random order), the values kernel's cube source with the plain gather
    that feeds it, the stage "gather + values" (the features source), and
    select_cohere at n = N_KNN, each beside its plain version and bound;
    then select_cohere at N_KNN_BIG (or the largest n its projected time
    allows) with its peak memory; ptxas's report of both sources."""
    import torch
    from repro_torch.kernels import _build, ops, pald_knn, pald_topk

    n, d = Xg.shape
    k = graph.indices.shape[1]
    rows = []

    def row(name, src, replaces, ms_k, ms_p, err, launched, grids, **extra):
        b_ms, b_by = knn_bound_ms(name, n, k, d, clock_mhz)
        print(f"phase 11: {name} n={n} k={k} d={d}: kernel {ms_k!r} ms, "
              f"plain {ms_p!r} ms, bound {b_ms!r} ms ({b_by}), kernel/bound "
              f"{ms_k / b_ms:.3f}, library: none (no single PyTorch call "
              f"computes it)")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launched,
                     "grid_launches": grids, "max_abs_err": err,
                     "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, **extra})

    ms_k, gk = time_ms(lambda: pald_topk.topk_select_cuda(Xg, k), reps)
    ms_p, gp = time_ms(lambda: pald_topk.topk_select_torch(Xg, k), 1)
    compare(f"topk n={n} indices", gk.indices, gp.indices, True)
    err = compare(f"topk n={n} distances", gk.distances, gp.distances, True)
    row("topk_select", "src/repro_torch/csrc/pald_topk.cu",
        "src/repro/kernels/pald_topk.py:181", ms_k, ms_p, err,
        launches["topk_select"], GRIDS["topk_select"])
    del gp
    # the list layouts: registers up to k = 32, shared memory past it
    for kk in (1, 32, 256, pald_topk.LARGE_K):
        ms_kk, _ = time_ms(lambda: pald_topk.topk_select_cuda(Xg, kk), 3)
        print(f"phase 11: topk_select n={n} k={kk}: kernel {ms_kk!r} ms "
              f"(median of 3)")
    # the mixture lists its communities in turn, so a block's own chunk
    # (visited first) holds most of its rows' neighbors; the same points
    # in a random order show the selection without that help
    perm = torch.as_tensor(np.random.default_rng(SEED).permutation(n),
                           device=Xg.device)
    Xs = Xg[perm].contiguous()
    for kk in (1, k):
        ms_s, gs = time_ms(lambda: pald_topk.topk_select_cuda(Xs, kk), 3)
        print(f"phase 11: topk_select n={n} k={kk} on the rows in a random "
              f"order: kernel {ms_s!r} ms (median of 3)")
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    compare(f"topk n={n} k={k} rows in a random order, distances",
            gs.distances[inv], gk.distances, True)
    del Xs, gs

    idx, dn = gk.indices, gk.distances
    ms_g, g = time_ms(lambda: ops._gather_tiles(Xg, idx, "features",
                                                "euclidean"), reps)
    print(f"phase 11: gather_tile_from_features (plain torch) n={n} k={k}: "
          f"{ms_g!r} ms for {g.numel() * 4} B (before: {CUBE_GATHER_MS} ms)")
    ms_k, vk = time_ms(lambda: pald_knn.knn_values_cuda(dn, g, idx), reps)
    ms_p, vp = time_ms(lambda: pald_knn.knn_values_torch(
        dn, g, idx, block=4096), 1)
    err = compare(f"knn_values n={n}", vk, vp, False)
    row("knn_values", "src/repro_torch/csrc/pald_knn.cu",
        "src/repro/kernels/pald_knn.py:74", ms_k, ms_p, err,
        launches["knn_values"], GRIDS["knn_values"],
        entry="cube (timed); the main path launches the features source")
    del g, vp
    ms_f, vf = time_ms(lambda: pald_knn.knn_values_from_features_cuda(
        Xg, dn, idx), reps)
    ms_fp, vfp = time_ms(lambda: pald_knn.knn_values_from_features_torch(
        Xg, dn, idx, block=4096), 1)
    compare(f"knn_values features source n={n} vs the cube", vf, vk, True)
    err = compare(f"knn_values features source n={n} vs plain", vf, vfp,
                  False)
    row("knn_values_features", "src/repro_torch/csrc/pald_knn.cu",
        "src/repro/kernels/pald_knn.py:74", ms_f, ms_fp, err,
        launches["knn_values_features"], GRIDS["knn_values_features"],
        stage="gather + values", cube_path_ms=ms_g + ms_k)
    print(f"phase 11: gather + values n={n} k={k}: features source "
          f"{ms_f!r} ms against the cube path's {CUBE_GATHER_MS} + "
          f"{CUBE_VALUES_MS} "
          f"ms and this call's plain gather + cube {ms_g + ms_k!r} ms")
    del vk, vf, vfp
    ms_e, _ = time_ms(lambda: ops.select_cohere(Xg, k=k, normalize=True),
                      reps)
    print(f"phase 11: select_cohere n={n} k={k} end to end: {ms_e!r} ms "
          f"(median of {reps}; before: {CUBE_SELECT_COHERE_MS} ms)")

    # the reference's largest run, if the times scaled by n^2 allow it
    big = N_KNN_BIG
    if ms_e * 1e-3 * (big / n) ** 2 > BIG_LIMIT_S:
        big = int(n * (BIG_LIMIT_S / (ms_e * 1e-3)) ** 0.5) // 1000 * 1000
        print(f"phase 11: n = {N_KNN_BIG} would take ~"
              f"{ms_e * 1e-3 * (N_KNN_BIG / n) ** 2:.0f} s; cut to n = {big}")
    Xb, _ = make_mixture(big, COMM_KNN, d, SEED)
    Xb = torch.as_tensor(Xb, device=Xg.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gb, vb = ops.select_cohere(Xb, k=k, normalize=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    ms_t, _ = time_ms(lambda: pald_topk.topk_select_cuda(Xb, k), 1)
    ms_v, _ = time_ms(lambda: pald_knn.knn_values_from_features_cuda(
        Xb, gb.distances, gb.indices), 1)
    print(f"phase 11: select_cohere n={big} k={k} d={d}: {secs:.3f} s wall "
          f"(first call; before: {CUBE_SELECT_COHERE_BIG_S} s); topk_select "
          f"kernel {ms_t!r} ms, gather + "
          f"values (features source) {ms_v!r} ms (one timed call each after "
          f"a warm-up); peak device memory above the input {peak} B (the "
          f"cube alone would be {4 * big * k * k} B)")
    knn_slab_check("phase 11", Xb, gb, vb, min(654321, big - SLAB), k)
    for source in ("pald_topk", "pald_knn"):
        for kernel, resources in _build.ptxas_report(source):
            print(f"phase 11: ptxas {source}: {kernel}: {resources}")
    return rows


# phase 11 past k = LARGE_K (1024): the k-NN kernels' large-k variants.
# select_cohere at the example's n = 50,000 for each of LARGE_KS, and at
# n = 2100 for each of D_WIDE (pald_knn_wide.cu's and pald_knn_piece.cu's
# register tiles); the D
# source through cohesion(D, method="knn") at phase 3's n = 8192; a chunk
# of two items and the block entry at n = 2100; both variants beside the
# shared-memory layouts at k = 1024, where they are never routed.  The
# plain versions run on a LARGE_SLAB-row slab (a (16, k, k) tile: 1 GB at
# k = 4096).
LARGE_KS = (1025, 2048, 4096)
RECORD_KS = (256, 512, 1024)
LARGE_SLAB = 16
# the families whose focus is an exact count: their k-NN values are bitwise
# across the values kernels' layouts, the others' within rounding
EXACT_FAMILIES = ("drop", "split", "ignore")
K_LARGE_D = 2048
N_LARGE_CHUNK, K_LARGE_CHUNK = 2100, 2048
# feature widths past pald_knn_large.cu's widest (16): pald_knn_wide.cu's
# widths 32 and 64, and pald_knn_piece.cu's pieces of 32 features
D_WIDE = (17, 64, 100)


@contextlib.contextmanager
def plain_forbidden(tag):
    """Every plain selection, gather and values version (and the dense and
    fused plain passes) fails while the block runs: the k-NN main path
    must stay on the kernels."""
    from repro_torch.kernels import ops, pald_knn, pald_topk

    def plain_called(*a, **kw):
        fail(f"{tag}: a plain torch version ran on the k-NN main path")

    patched = [(ops, "topk_select_torch"), (ops, "knn_values_torch"),
               (ops, "_gather_tiles"), (pald_topk, "topk_select_torch"),
               (pald_knn, "knn_values_torch"),
               (pald_knn, "knn_values_from_features_torch"),
               (pald_knn, "knn_values_from_distances_torch"),
               (ops, "focus_fused_torch"), (ops, "cohesion_fused_torch"),
               (ops, "focus_general_torch"), (ops, "cohesion_general_torch")]
    saved = [getattr(m, a) for m, a in patched]
    for m, a in patched:
        setattr(m, a, plain_called)
    try:
        yield
    finally:
        for (m, a), f in zip(patched, saved):
            setattr(m, a, f)


@contextlib.contextmanager
def large_variants_everywhere():
    """Route every k to the k-NN kernels' large-k variants (for the record
    at k = 1024 only; the wrappers never take them there)."""
    from repro_torch.kernels import pald_knn, pald_topk

    saved = pald_topk.LARGE_K, pald_knn.LARGE_K
    pald_topk.LARGE_K = pald_knn.LARGE_K = 0
    try:
        yield
    finally:
        pald_topk.LARGE_K, pald_knn.LARGE_K = saved


@contextlib.contextmanager
def timed_calls(module, name, times):
    """Time each call of ``module.name`` in the block with CUDA events
    around it (appended to ``times``, ms): a kernel's time inside the
    main path's own run."""
    import torch

    f = getattr(module, name)

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = f(*a, **kw)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, f)


def reset_counts(*wrappers):
    for f in wrappers:
        f.launches = f.large_launches = f.grid_launches = 0


def large_k_slab(tag, X, graph, vals, r0, k):
    """Rows r0:r0+LARGE_SLAB of a select_cohere result (un-normalized)
    against the plain versions: the graph bitwise, the values within rtol
    1e-5, atol 1e-6.  Returns (values error, the plain selection's and
    values' ms on the slab)."""
    from repro_torch.kernels import pald_knn, pald_topk

    rows = (r0, r0 + LARGE_SLAB)
    sl = slice(*rows)
    ms_tp, gp = time_ms(lambda: pald_topk.topk_select_torch(X, k, rows=rows),
                        1)
    compare(f"{tag} graph indices rows {r0}:{rows[1]}", graph.indices[sl],
            gp.indices, True)
    compare(f"{tag} graph distances rows {r0}:{rows[1]}",
            graph.distances[sl], gp.distances, True)
    ms_vp, vp = time_ms(lambda: pald_knn.knn_values_from_features_torch(
        X, gp.distances, gp.indices, block=LARGE_SLAB, row_off=r0), 1)
    err = compare(f"{tag} values rows {r0}:{rows[1]}", vals[sl], vp, False)
    return err, ms_tp, ms_vp


def features_source(k, d):
    """The CUDA source whose entry the features source launches at (k,
    d)."""
    from repro_torch.kernels import _build, pald_knn

    stem = _build.SIGNATURES[pald_knn.features_entry(k, d)][0]
    return f"src/repro_torch/csrc/{stem}.cu"


def gather_traffic(idx, k):
    """A model of the D source's reads of D a row at k, worked out from
    the graph's indices (n, k), not counted on the card: the sweep reads each entry of the row's tile once, a warp
    taking 32 consecutive columns of the row's neighbors sorted by index;
    for comparison, a read of each entry in each pass, a warp taking 32
    consecutive neighbors in the graph's order (the one-warp rows' reads
    at k <= 1024).  The 32-byte sectors of a
    warp's read are its distinct column // 8 (D's rows start on a sector
    when its row length is a multiple of 8) and no read hits a cache; the
    mean over the rows."""
    import torch

    def sectors(cols):
        c = (cols // 8).reshape(cols.shape[0], -1, 32)
        c, _ = torch.sort(c, dim=-1)
        distinct = 1 + (c[..., 1:] != c[..., :-1]).sum(-1)
        return float(distinct.sum(-1).double().mean()) * k

    full = idx[:, :k // 32 * 32].long()
    return {"sweep_entries": k * k,
            "sweep_sectors": sectors(torch.sort(full, dim=1)[0]),
            "two_pass_entries": 2 * k * k,
            "two_pass_sectors": 2 * sectors(full)}


def phase_knn_large_k(Xg, clock_mhz, card):
    """Phase 11, past k = 1024 (module docstring): the main path through
    the large-k variants (their launch counts, the plain versions
    forbidden), slab checks, times and the kernels' rows."""
    import torch
    from repro_torch.core import knn, pald
    from repro_torch.core.features import cdist_reference
    from repro_torch.core.weights import DEFAULT_TIES
    from repro_torch.kernels import ops, pald_knn, pald_topk

    n, d = Xg.shape
    sel = pald_topk.topk_select_cuda
    val = pald_knn.knn_values_from_features_cuda
    dsrc = pald_knn.knn_values_from_distances_cuda
    rows = []

    def row(name, src, k, ms, plain_ms, err, launched, nn=n, dd=d, tag="",
            **extra):
        kind = "topk_select" if name == "topk_block" else name
        b_ms, b_by = knn_bound_ms(kind, nn, k, dd, clock_mhz)
        print(f"phase 11: {name} large-k variant n={nn} k={k} d={dd}: "
              f"kernel {ms!r} ms, plain {plain_ms!r} ms on a {LARGE_SLAB}-row "
              f"slab, bound {b_ms!r} ms ({b_by}), kernel/bound {ms / b_ms:.3f}, "
              f"library: none; {card}")
        extra.setdefault("x_bound", ms / b_ms)
        rows.append({"name": f"{name}_large[k={k}{tag}]", "route": "cuda",
                     "source": src, "replaces": "src/repro/kernels/"
                     + ("pald_topk.py:181" if kind == "topk_select"
                        else "pald_knn.py:74"),
                     "launches": launched, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms,
                     "plain_on": f"a {LARGE_SLAB}-row slab", "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "n": nn, "k": k,
                     **extra})

    def run_large(X, k):
        """select_cohere(X, k) with every count at 0 and the plain versions
        forbidden: each large-k variant once; (graph, values, the values
        kernel's ms inside the run)."""
        nx, dx = X.shape
        reset_counts(sel, val, dsrc, pald_knn.knn_values_cuda)
        val_ms = []  # the values kernel timed inside the main path's run
        t0 = time.perf_counter()
        with plain_forbidden(f"select_cohere k={k} d={dx}"), \
                timed_calls(ops, "knn_values_from_features_cuda", val_ms):
            graph, vals = ops.select_cohere(X, k=k)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = [(f.launches, f.large_launches) for f in (sel, val)]
        others = dsrc.launches + pald_knn.knn_values_cuda.launches
        print(f"phase 11: select_cohere(X, k={k}) n={nx} d={dx}: {secs:.3f} "
              f"s wall (first call at this k), launches (all, large-k "
              f"variant): selection {launched[0]}, values {launched[1]}")
        if launched != [(1, 1), (1, 1)] or others:
            fail(f"select_cohere k={k} d={dx} did not run the large-k "
                 f"variants once each: {launched}, other sources {others}")
        if (tuple(vals.shape) != (nx, k + 1)
                or not bool(torch.isfinite(vals).all())):
            fail(f"select_cohere k={k} d={dx}: values {tuple(vals.shape)}, "
                 "non-finite entries")
        return graph, vals, val_ms[0]

    for k in LARGE_KS:
        graph, vals, ms_v = run_large(Xg, k)
        err, ms_tp, ms_vp = large_k_slab(f"phase 11 k={k}", Xg, graph, vals,
                                         min(30001, n - LARGE_SLAB), k)
        # select_cohere ran the selection at this k: it is the warm-up
        reps = 3 if k < 4096 else 1
        ms_t, _ = time_ms(lambda: sel(Xg, k), reps, warm=False)
        row("topk_select", "src/repro_torch/csrc/pald_topk.cuh", k, ms_t,
            ms_tp, 0.0, 1, reps=reps)
        row("knn_values_features", features_source(k, d), k, ms_v, ms_vp,
            err, 1, reps=1, timed="its call inside the select_cohere run")
        del graph, vals

    # past REG_MAX_D features the values' features source is
    # pald_knn_wide.cu's and pald_knn_piece.cu's register tiles:
    # select_cohere on the mixture at n = 2100, k = 2048 and each of
    # D_WIDE, held to the plain versions on a slab
    n2, k = N_LARGE_CHUNK, K_LARGE_CHUNK
    for dw in D_WIDE:
        if not features_source(k, dw).endswith(("pald_knn_wide.cu",
                                                 "pald_knn_piece.cu")):
            fail(f"d={dw} would not take the register tiles past 16 "
                 "features")
        Xw = torch.as_tensor(make_mixture(n2, COMM_KNN, dw, SEED + 5)[0],
                             device=Xg.device)
        graph, vals, ms_v = run_large(Xw, k)
        err, _, ms_vp = large_k_slab(f"phase 11 d={dw} k={k}", Xw, graph,
                                     vals, 1000, k)
        row("knn_values_features", features_source(k, dw), k, ms_v, ms_vp,
            err, 1, nn=n2, dd=dw, tag=f",d={dw}", reps=1,
            timed="its call inside the select_cohere run")
        del Xw, graph, vals

    for dd in (d, *D_WIDE):
        width = pald_knn.feature_width(dd)
        print(f"phase 11: the large-k values' features source at d={dd}: "
              f"{pald_knn.features_entry(K_LARGE_CHUNK, dd)} "
              f"({features_source(K_LARGE_CHUNK, dd)}), register tiles at "
              f"width {width}"
              + (" in pieces of 32" if dd > 64 else ""))

    # the record at k = 256, 512 and 1024 (data for where LARGE_K should
    # sit): each shared-memory layout against the large-k variant on the
    # same operands, at 1024 also compared (the selection bitwise, the
    # values bitwise for the default family, an exact count)
    for k in RECORD_KS:
        ms_s, gs = time_ms(lambda: sel(Xg, k), 1)
        ms_vs, vs = time_ms(lambda: val(Xg, gs.distances, gs.indices), 1)
        with large_variants_everywhere():
            ms_l, gl = time_ms(lambda: sel(Xg, k), 1)
            ms_vl, vl = time_ms(lambda: val(Xg, gs.distances, gs.indices), 1)
        checked = "times only"
        if k == pald_topk.LARGE_K:
            compare("phase 11 k=1024 large-k selection", gl.indices,
                    gs.indices, True)
            compare("phase 11 k=1024 large-k values", vl, vs,
                    DEFAULT_TIES in EXACT_FAMILIES)
            checked = (f"selection bitwise, values ({DEFAULT_TIES}) "
                       + ("bitwise" if DEFAULT_TIES in EXACT_FAMILIES
                          else "within rtol 1e-5, atol 1e-6"))
        print(f"phase 11: k={k} n={n} (for the record; never routed "
              f"there): selection shared-memory lists {ms_s!r} ms, large-k "
              f"variant {ms_l!r} ms; values four rows a block {ms_vs!r} "
              f"ms, large-k variant {ms_vl!r} ms; {checked}; {card}")
        del gs, gl, vs, vl

    # the D source: cohesion(D, method="knn") on phase 3's D
    Xd, _ = clustered_points(N_MAIN, D_MAIN, SEED)
    D = distances_on_device(torch.as_tensor(Xd, device=Xg.device))
    k = K_LARGE_D
    reset_counts(dsrc, val, sel, pald_knn.knn_values_cuda)
    t0 = time.perf_counter()
    C = pald.cohesion(D, method="knn", k=k, normalize=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = (dsrc.launches, dsrc.large_launches)
    if launched != (1, 1) or val.launches or sel.launches:
        fail(f"cohesion(D, method='knn', k={k}) did not run the D source's "
             f"large-k variant alone, once: {launched}")
    g = knn.knn_from_distances(D, k)
    ms_d, vd = time_ms(lambda: dsrc(D, g.distances, g.indices), 1,
                       warm=False)
    compare(f"phase 11 cohesion(D, method='knn', k={k}) C", C,
            knn.scatter_dense(g, vd), True)
    r0 = 1000
    sl = slice(r0, r0 + LARGE_SLAB)
    ms_dp, vp = time_ms(lambda: pald_knn.knn_values_torch(
        g.distances[sl], knn.gather_tile_from_distances(D, g.indices[sl]),
        g.indices[sl], row_off=r0), 1)
    err = compare(f"phase 11 D source k={k} rows {r0}:{r0 + LARGE_SLAB}",
                  vd[sl], vp, False)
    print(f"phase 11: cohesion(D, method='knn', k={k}) n={N_MAIN}: "
          f"{secs:.3f} s wall (first call), the D source's large-k variant "
          f"once; C bitwise its scatter")
    traffic = gather_traffic(g.indices, k)
    print(f"phase 11: the D source's gather at n={N_MAIN} k={k}, a row, "
          f"modeled from the graph's indices (aligned rows, no cache reuse; "
          f"not a device count): the sweep {traffic['sweep_entries']} "
          f"entries in {traffic['sweep_sectors']!r} 32-byte sectors (mean); "
          f"two passes in the graph's order {traffic['two_pass_entries']} "
          f"in {traffic['two_pass_sectors']!r}")
    row("knn_values_distances", "src/repro_torch/csrc/pald_knn.cu", k, ms_d,
        ms_dp, err, 1, nn=N_MAIN, reps=1, kernel="knn_dist_sweep_kernel")
    del C, D, g, vd

    # a chunk of two items and the block entry at n = 2100, k = 2048
    n2, k = N_LARGE_CHUNK, K_LARGE_CHUNK
    Xb = torch.stack([torch.as_tensor(make_mixture(n2, COMM_KNN, D_KNN,
                                                   SEED + 3 + i)[0],
                                      device=Xg.device) for i in range(2)])
    Db = torch.stack([cdist_reference(x) for x in Xb])
    reset_counts(sel, val, dsrc)
    gb = sel(Xb, k)
    vb = val(Xb, gb.distances, gb.indices, ties="ignore")
    vdb = dsrc(Db, gb.distances, gb.indices, ties="ignore")
    counts = [(f.launches, f.large_launches) for f in (sel, val, dsrc)]
    if counts != [(1, 1)] * 3:
        fail(f"chunk of 2 at k={k}: launches {counts}")
    compare(f"chunk k={k} features vs D source", vb, vdb, True)
    for i in range(2):
        gi = sel(Xb[i], k)
        compare(f"chunk k={k} item {i} graph", gb.indices[i], gi.indices,
                True)
        compare(f"chunk k={k} item {i} values", vb[i],
                val(Xb[i], gi.distances, gi.indices, ties="ignore"), True)
        compare(f"chunk k={k} item {i} D values", vdb[i],
                dsrc(Db[i], gi.distances, gi.indices, ties="ignore"), True)
    X0, blk = Xb[0], pald_topk.topk_block_cuda
    reset_counts(blk)
    parts = [blk(X0, X0[a:e], k, col_off=a)
             for a, e in ((0, 1000), (1000, n2))]
    launched = (blk.launches, blk.large_launches)
    if launched != (2, 2):
        fail(f"block entry k={k}: launches {launched}")
    mv, mi = pald_topk.merge_pairs(
        torch.cat([p.distances for p in parts], 1),
        torch.cat([p.indices for p in parts], 1), k)
    compare(f"block entry k={k} merged indices", mi, gb.indices[0], True)
    compare(f"block entry k={k} merged distances", mv, gb.distances[0], True)
    # the block entry over all n2 candidates (the full call's work)
    ms_b, gbl = time_ms(lambda: blk(X0, X0, k), 3)
    compare(f"block entry k={k} whole", gbl.indices, gb.indices[0], True)
    ms_bp, bp = time_ms(lambda: pald_topk.topk_block_torch(
        X0[:LARGE_SLAB], X0, k), 1)
    compare(f"block entry k={k} rows 0:{LARGE_SLAB} vs plain", bp.indices,
            gb.indices[0, :LARGE_SLAB], True)
    row("topk_block", "src/repro_torch/csrc/pald_topk.cu", k, ms_b, ms_bp,
        0.0, launched[1], nn=n2, reps=3,
        entry="pald_topk_block_f32, all n candidates in one block; "
              "launches: the merge check's two blocks")
    print(f"phase 11: a chunk of 2 at n={n2}, k={k} (ignore): the selection "
          f"and the features and D sources one launch each, each item "
          f"bitwise alone, the sources bitwise each other; the block entry "
          f"on candidate blocks [0, 1000) and [1000, {n2}) (fewer than k "
          f"each), merged, bitwise the full call")
    return rows


# ---------------------------------------------------------------------------
# the tri schedule (phases 12-14)
# ---------------------------------------------------------------------------
def symmetric_tie_distances(rng, n, dev):
    """Symmetric float32 distances: multiples of 0.5 (exact ties), about
    3 % +inf pairs, an exactly-zero diagonal."""
    import torch

    A = rng.integers(1, 8, size=(n, n)).astype(np.float32) * 0.5
    A[rng.random((n, n)) < 0.03] = np.inf
    D = np.triu(A, 1)
    D = D + D.T
    np.fill_diagonal(D, 0.0)
    return torch.as_tensor(D, device=dev)


def phase_tri_vs_plain(dev) -> None:
    """Phase 12: the tri kernels against their plain versions, the dense
    kernels, and themselves across two calls."""
    import torch
    from repro_torch.kernels import ops, pald_cohesion_tri, pald_focus_tri
    from repro_torch.kernels.ref import weights_ref

    rng = np.random.default_rng(SEED + 12)
    checked = 0
    for n in (1, 2, 63, 64, 65, 257):
        D = symmetric_tie_distances(rng, n, dev)
        for w in functionals():
            tag = f"{w.name} n={n}"
            Uk = pald_focus_tri.focus_tri_cuda(D, ties=w)
            Up = pald_focus_tri.focus_tri_torch(D, ties=w)
            compare(f"focus_tri {tag}", Uk, Up, exact_focus(w))
            # one kernel: bitwise for every family, soft included
            Ud = ops.focus(D, impl="cuda", ties=w)
            compare(f"focus_tri vs dense kernel {tag}", Uk, Ud, True)
            W = weights_ref(Up)
            Ck = pald_cohesion_tri.cohesion_tri_cuda(D, W, ties=w)
            Cp = pald_cohesion_tri.cohesion_tri_torch(D, W, ties=w)
            compare(f"cohesion_tri {tag}", Ck, Cp, False)
            compare(f"cohesion_tri twice {tag}",
                    pald_cohesion_tri.cohesion_tri_cuda(D, W, ties=w), Ck,
                    True)
            Cd = ops.cohesion_from_weights(D, W, impl="cuda", ties=w)
            compare(f"cohesion_tri vs dense kernel {tag}", Ck, Cd, True)
            checked += 5
    torch.cuda.synchronize()
    print(f"phase 12: {checked} tri checks passed (U bitwise except soft "
          f"against the plain version, bitwise the dense kernel's for "
          f"every family; C within rtol "
          f"{RTOL}, atol {ATOL} of the plain version, bitwise the dense "
          f"kernel's and across two calls)")


def phase_tri_main_path(dev, n=N_MAIN, d=D_MAIN):
    """Phase 13: ``cohesion(D, method="kernel", schedule="tri")`` at full
    size on phase 3's D, through both tri kernels."""
    import torch
    from repro_torch.core import pald
    from repro_torch.kernels import (ops, pald_cohesion, pald_cohesion_tri,
                                     pald_focus, pald_focus_tri, pald_fused,
                                     pald_knn, pald_topk)

    X, labels = clustered_points(n, d, SEED)
    D = distances_on_device(torch.as_tensor(X, device=dev))

    def plain_called(*a, **k):
        fail("a plain torch version ran on the tri main path")

    patched = [(ops, "focus_tri_torch"), (ops, "cohesion_tri_torch"),
               (pald_focus_tri, "focus_tri_torch"),
               (pald_cohesion_tri, "cohesion_tri_torch"),
               (ops, "focus_general_torch"), (ops, "cohesion_general_torch"),
               (pald_focus, "focus_general_torch"),
               (pald_cohesion, "cohesion_general_torch")]
    saved = [getattr(m, a) for m, a in patched]
    counted = {"focus_tri": pald_focus_tri.focus_tri_cuda,
               "cohesion_tri": pald_cohesion_tri.cohesion_tri_cuda,
               "focus_general": pald_focus.focus_general_cuda,
               "cohesion_general": pald_cohesion.cohesion_general_cuda,
               "focus_fused": pald_fused.focus_fused_cuda,
               "cohesion_fused": pald_fused.cohesion_fused_cuda,
               "topk_select": pald_topk.topk_select_cuda,
               "knn_values": pald_knn.knn_values_cuda,
               "knn_values_features": pald_knn.knn_values_from_features_cuda,
               "knn_values_distances":
                   pald_knn.knn_values_from_distances_cuda}
    for m, a in patched:
        setattr(m, a, plain_called)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for f in counted.values():
            f.launches = f.grid_launches = 0
        pald_focus.reset_tile_counts()
        t0 = time.perf_counter()
        C = pald.cohesion(D, method="kernel", schedule="tri", ties="ignore")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {name: f.launches for name, f in counted.items()}
        GRIDS.update((name, counted[name].grid_launches)
                     for name in ("focus_tri", "cohesion_tri"))
        tiles = pald_focus.tile_counts(D.device)
        BLOCKS["focus_tri"] = tiles[0]
        peak_tri = torch.cuda.max_memory_allocated() - base
    finally:
        for (m, a), f in zip(patched, saved):
            setattr(m, a, f)
    print(f"phase 13: cohesion(D, method='kernel', schedule='tri', "
          f"ties='ignore') n={n} d={d}: {secs:.3f} s wall (first call), "
          f"launches {launches}, grid launches "
          f"{ {k: GRIDS[k] for k in ('focus_tri', 'cohesion_tri')} }")
    if GRIDS["cohesion_tri"] != 1:
        fail(f"cohesion_tri issued {GRIDS['cohesion_tri']} grids, not 1")
    focus_blocks_check(13, "focus_tri", tiles, n)
    if launches["focus_tri"] != 1 or launches["cohesion_tri"] != 1:
        fail(f"the tri kernels did not run once each: {launches}")
    if any(v for name, v in launches.items()
           if name not in ("focus_tri", "cohesion_tri")):
        fail(f"another kernel ran on the tri path: {launches}")
    if C.shape != (n, n) or C.dtype != torch.float32 or C.device != D.device:
        fail(f"C is {tuple(C.shape)} {C.dtype} on {C.device}")
    if not bool(torch.isfinite(C).all()):
        fail("C has non-finite values")
    mass = float(C.double().sum())
    if abs(mass - n / 2) > 1e-4 * n / 2:
        fail(f"mass {mass!r} != n/2 = {n / 2}")
    print(f"phase 13: mass sum(C) = {mass!r} (n/2 = {n / 2})")

    compare("C tri twice", pald.cohesion(D, method="kernel", schedule="tri",
                                         ties="ignore"), C, True)
    # default knobs: method="auto" resolves to "triplet" past n = 256, the
    # same schedule, which on the card runs the same two kernels
    info = pald.plan(D, ties="ignore").explain()
    for f in counted.values():
        f.launches = 0
    Ca = pald.cohesion(D, ties="ignore")
    auto = {name: f.launches for name, f in counted.items() if f.launches}
    print(f"phase 13: cohesion(D, ties='ignore') with default knobs: method "
          f"{info['method']!r} ({info['method_source']}), launches {auto}")
    if info["method"] != "triplet" or auto != {"focus_tri": 1,
                                               "cohesion_tri": 1}:
        fail("the default call did not run the tri kernels once each")
    compare("C default (triplet) vs tri", Ca, C, True)
    del Ca
    Ut = ops.focus(D, impl="cuda", schedule="tri", ties="ignore")
    compare(f"U tri vs dense kernel n={n}", Ut,
            ops.focus(D, impl="cuda", ties="ignore"), True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pald_focus.reset_tile_counts()
    Cd = pald.cohesion(D, method="kernel", ties="ignore")
    torch.cuda.synchronize()
    peak_dense = torch.cuda.max_memory_allocated() - base
    focus_blocks_check(13, "focus_general", pald_focus.tile_counts(D.device),
                       n)
    buf = 4 * n * n
    print(f"phase 13: peak device memory above the input: tri {peak_tri} B "
          f"({peak_tri / buf:.3f} n^2 float32 buffers), dense {peak_dense} B "
          f"({peak_dense / buf:.3f}); both hold U, W and W's bool mask while "
          f"W is built")
    compare(f"C tri vs dense n={n}", C, Cd, True)
    print("phase 13: C bitwise across two calls and bitwise the dense "
          "pipeline's; U bitwise the dense kernel's")
    del Cd

    U_slab, r0 = slab_check(13, C, D, "ignore")
    compare(f"U tri rows {r0}:{r0 + SLAB}", Ut[r0:r0 + SLAB], U_slab, True)
    communities_check(13, C, labels)
    return D, launches


def phase_tri_timing(D, launches, clock_mhz, reps=5):
    """Phase 14: the tri kernels and their plain versions at the main
    path's shapes, beside the dense kernels; both pipelines end to end;
    each family's tri kernels."""
    from repro_torch.core import pald
    from repro_torch.kernels import ops, pald_cohesion_tri, pald_focus_tri
    from repro_torch.kernels.ref import weights_ref

    n = D.shape[0]
    replaces = {"focus": "src/repro/kernels/pald_focus_tri.py:60",
                "cohesion": "src/repro/kernels/pald_cohesion_tri.py:121"}
    rows = []

    def timed(name, kernel, plain, dense):
        ms_k, out_k = time_ms(kernel, reps)
        ms_d, _ = time_ms(dense, reps)
        ms_p, out_p = time_ms(plain, 1, warm=False)  # phase 12 ran its ops
        b_ms, b_by = bound_ms(name, n, clock_mhz)
        cmp = (f", floor at the compare rate "
               f"{compare_bound_ms(name, n, clock_mhz)!r} ms")
        print(f"phase 14: {name}_tri n={n}: kernel {ms_k!r} ms, dense kernel "
              f"{ms_d!r} ms (tri/dense {ms_k / ms_d:.3f}), plain {ms_p!r} ms, "
              f"bound {b_ms!r} ms ({b_by}), kernel/bound {ms_k / b_ms:.3f}"
              f"{cmp}, library: none")
        rows.append({"name": f"{name}_tri", "route": "cuda",
                     "source": ("src/repro_torch/csrc/pald_focus.cu"
                                if name == "focus" else
                                "src/repro_torch/csrc/pald_cohesion_tri.cu"),
                     "replaces": replaces[name],
                     "launches": launches[f"{name}_tri"],
                     "grid_launches": GRIDS[f"{name}_tri"],
                     **({"blocks": BLOCKS["focus_tri"]}
                        if name == "focus" else {}),
                     "max_abs_err": None,
                     "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
        return out_k, out_p

    # the plain versions with 512-row blocks: fewer, larger launches
    Uk, Up = timed(
        "focus",
        lambda: pald_focus_tri.focus_tri_cuda(D, ties="ignore"),
        lambda: pald_focus_tri.focus_tri_torch(D, block=512, block_z=n,
                                               ties="ignore"),
        lambda: ops.focus(D, impl="cuda", ties="ignore"))
    rows[0]["max_abs_err"] = compare(f"focus_tri n={n}", Uk, Up, True)
    W = weights_ref(Uk)
    del Uk, Up
    Ck, Cp = timed(
        "cohesion",
        lambda: pald_cohesion_tri.cohesion_tri_cuda(D, W, ties="ignore"),
        lambda: pald_cohesion_tri.cohesion_tri_torch(D, W, block=512,
                                                     block_z=n,
                                                     ties="ignore"),
        lambda: ops.cohesion_from_weights(D, W, impl="cuda", ties="ignore"))
    rows[1]["max_abs_err"] = compare(f"cohesion_tri n={n}", Ck, Cp, False,
                                     rtol=RTOL_MAIN)
    del Ck, Cp, W

    # the two pipelines in turns: dense, tri, tri, dense
    ends = {"dense": [], "tri": []}
    for sched in ("dense", "tri", "tri", "dense"):
        ms, _ = time_ms(lambda: pald.cohesion(D, method="kernel",
                                              schedule=sched,
                                              ties="ignore"), 3)
        ends[sched].append(ms)
    print(f"phase 14: cohesion(D, method='kernel', ties='ignore') n={n} end "
          f"to end (median of 3, in turns dense, tri, tri, dense): dense "
          f"{ends['dense']} ms, tri {ends['tri']} ms")

    for w in functionals():
        ms_f, U = time_ms(lambda: pald_focus_tri.focus_tri_cuda(D, ties=w),
                          3)
        W = weights_ref(U)
        ms_c, _ = time_ms(lambda: pald_cohesion_tri.cohesion_tri_cuda(
            D, W, ties=w), 3)
        print(f"phase 14: {w.name} n={n}: focus_tri kernel {ms_f!r} ms, "
              f"cohesion_tri kernel {ms_c!r} ms (median of 3)")
        del U, W
    return rows


def profile_window(fn):
    """One call of ``fn`` under ``torch.profiler``, after a warm-up call
    that the profiler also sees but does not record (its schedule's warm-up
    step: without it the trace can miss the window's first kernels):
    (device busy share of the host's window, {kernel name: device ms},
    window ms, device events in the window), or None when the trace holds
    no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(p.events())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    spans, by_name = [], {}
    for e in traced:
        # device events: kernels, copies, fills; not the step's own range,
        # which the trace also puts on the device's timeline
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith("ProfilerStep")):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e3
    if not spans:
        return None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    return busy / window_us, by_name, window_us / 1e3, len(spans)


def phase_profile_and_ragged(D, n_ragged=8000, reps=3):
    """Phase 15: a profiler window over each kernel pipeline on phase 13's
    D, then both pipelines at a ragged n (timed in turns dense, tri, tri,
    dense; peak device memory of one call each)."""
    import torch
    from repro_torch.core import pald

    n = D.shape[0]
    for sched in ("dense", "tri"):
        got = profile_window(lambda: pald.cohesion(
            D, method="kernel", schedule=sched, ties="ignore"))
        if got is None:
            print(f"phase 15: {sched} n={n}: the profiler recorded no device "
                  f"event; the CUDA-event times of phase 14 stand")
            continue
        share, by_name, window_ms, _ = got
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"phase 15: {sched} n={n}: profiler window {window_ms:.3f} ms, "
              f"device busy {share:.4f} (idle {1 - share:.4f}); kernel ms "
              f"by name: " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
    X, _ = clustered_points(n_ragged, D_MAIN, SEED)
    Dr = distances_on_device(torch.as_tensor(X, device=D.device))
    ends = {"dense": [], "tri": []}
    for sched in ("dense", "tri", "tri", "dense"):
        ms, _ = time_ms(lambda: pald.cohesion(Dr, method="kernel",
                                              schedule=sched,
                                              ties="ignore"), reps)
        ends[sched].append(ms)
    peaks = {}
    buf = 4 * n_ragged * n_ragged
    for sched in ("dense", "tri"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        C = pald.cohesion(Dr, method="kernel", schedule=sched, ties="ignore")
        torch.cuda.synchronize()
        peaks[sched] = torch.cuda.max_memory_allocated() - base
        if not bool(torch.isfinite(C).all()):
            fail(f"n={n_ragged} {sched}: C has non-finite values")
        del C
    print(f"phase 15: cohesion(D, method='kernel', ties='ignore') "
          f"n={n_ragged} (padded to a multiple of 128) end to end (median "
          f"of {reps}, in turns dense, tri, tri, dense): dense "
          f"{ends['dense']} ms, tri {ends['tri']} ms; peak device memory "
          f"above the input: dense {peaks['dense']} B "
          f"({peaks['dense'] / buf:.3f} n^2), tri {peaks['tri']} B "
          f"({peaks['tri'] / buf:.3f} n^2)")


# phase 16: the OOM cell, items and size (2.25 n^2 float32 of state an item)
N_OOM, B_OOM = 4096, 8
# phase 17: the batched cells, (items, n)
CHUNK_CELLS = ((64, 256), (16, 1024))
# the fused chunks: the reference's run_batched cells
# (benchmarks/bench_variants.py), then the dense cells, each at d = 8 and
# 64; the k-NN chunks at k = 32, d = 8; the ragged, tie-heavy chunk
FUSED_CHUNK_CELLS = ((3, 128), (3, 256), (2, 512), (64, 256), (16, 1024))
FUSED_CHUNK_DS = (8, 64)
K_CHUNK, D_KNN_CHUNK = 32, 8
RAGGED_CHUNK = (5, 201)   # n % 4 != 0: unaligned per-item norms


def _pipeline_wrappers(sched):
    """The (focus, cohesion) wrappers of the kernel method's schedule."""
    from repro_torch.kernels import (pald_cohesion, pald_cohesion_tri,
                                     pald_focus, pald_focus_tri)

    if sched == "tri":
        return pald_focus_tri.focus_tri_cuda, pald_cohesion_tri.cohesion_tri_cuda
    return pald_focus.focus_general_cuda, pald_cohesion.cohesion_general_cuda


def _stack_distances(items, n, dev, seed):
    """(items, n, n) clustered distance matrices on the card."""
    import torch

    D = torch.empty((items, n, n), dtype=torch.float32, device=dev)
    for i in range(items):
        X, _ = clustered_points(n, D_MAIN, seed + i)
        D[i] = distances_on_device(torch.as_tensor(X, device=dev))
    return D


def phase_guard(dev, n=1024):
    """Phase 16: guarded execution on the card.  A fault-free fallback
    plan bitwise the raise plan with the kernels launched and no event;
    every CUDA entry point faulted, the plan keeps its kernels: no plain
    rung answers, the call ends in ``FallbackExhausted``; a real CUDA OOM
    rescued by halving ``batch``, bitwise; the chunked selection rung
    bitwise the CUDA selection at the k-NN example's size; k past the
    k-NN kernels' limit ends in ``FallbackExhausted`` too."""
    import warnings

    import torch
    from repro_torch.core import knn, pald, resilience
    from repro_torch.kernels import ops, pald_knn, pald_topk
    from repro_torch.testing import faults

    X, _ = clustered_points(n, D_MAIN, SEED + 16)
    D = distances_on_device(torch.as_tensor(X, device=dev))
    for sched in ("dense", "tri"):
        focus, coh = _pipeline_wrappers(sched)
        kw = dict(method="kernel", schedule=sched, ties="ignore")
        strict = pald.cohesion(D, **kw)
        f0, c0 = focus.launches, coh.launches
        p = pald.plan(D, on_error="fallback", **kw)
        C = p.execute(D)
        moved = (focus.launches - f0, coh.launches - c0)
        if moved != (1, 1) or p.explain()["degradations"]:
            fail(f"phase 16: {sched} fallback plan: launches {moved}, "
                 f"events {p.explain()['degradations']}")
        compare(f"phase 16 {sched} fallback plan", C, strict, True)
        p = pald.plan(D, on_error="fallback", **kw)
        try:
            with faults.fail_kernel(impl="cuda") as rule:
                p.execute(D)
        except resilience.FallbackExhausted as exc:
            exhausted = exc
        else:
            fail(f"phase 16: {sched} dead kernels answered off the kernels")
        labels = [st.label for st in resilience.chain_for(p)]
        if rule.trips != 1 or p.explain()["degradations"] or any(
                f"{lb}: FallbackUnavailable" not in str(exhausted)
                for lb in labels):
            fail(f"phase 16: {sched} dead kernels: trips {rule.trips}, "
                 f"events {p.explain()['degradations']}, {exhausted}")
        print(f"phase 16: {sched} n={n}: fallback plan bitwise the raise "
              f"plan, 0 events, launches {moved}; every CUDA entry point "
              f"faulted: FallbackExhausted, rungs {labels} unavailable on "
              f"the card, from {exhausted.__cause__!r}")
    del D, C, strict, exhausted

    # a real torch.cuda.OutOfMemoryError, rescued by halving batch
    Db = _stack_distances(B_OOM, N_OOM, dev, SEED + 160)
    kw = dict(method="kernel", ties="ignore")
    want = pald.plan(Db, batch=1, **kw).execute(Db)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    item = 4 * N_OOM * N_OOM
    total = torch.cuda.get_device_properties(dev).total_memory
    base = torch.cuda.memory_reserved(dev)
    print(f"phase 16: OOM cell: {torch.cuda.memory_allocated(dev)} B "
          f"allocated, {base} B reserved before the cap")
    # one chunk of 8 needs 18 items' bytes (U, W, W's mask), chunks of 4
    # 17 after the first (the output's 8 + 9), chunks of 2 12.5: the cap
    # leaves 4 items for what the failed attempts fragment
    allow = base + int(16.5 * item)
    p = pald.plan(Db, on_error="fallback", **kw)
    torch.cuda.set_per_process_memory_fraction(allow / total, dev)
    try:
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", resilience.DegradationWarning)
            got = p.execute(Db)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    except resilience.FallbackExhausted as exc:
        fail(f"phase 16: OOM cell exhausted ({exc}); events "
             f"{p.explain()['degradations']}")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    events = p.explain()["degradations"]
    if not events or any(e["cause"] != "oom" or "OutOfMemoryError"
                         not in e["error"] for e in events):
        fail(f"phase 16: OOM cell: events {events}")
    compare(f"phase 16 OOM rescue B={B_OOM} n={N_OOM}", got, want, True)
    print(f"phase 16: {B_OOM} items at n={N_OOM}, batch=None under a cap of "
          f"{allow} B ({(allow - base) / item:.1f} items above the "
          f"{base} B reserved): halved to batch "
          f"{[e['batch'] for e in events]} by torch.cuda.OutOfMemoryError, "
          f"C bitwise the per-item C, {wall:.1f} ms; first error: "
          f"{events[0]['error'][:120]}")
    del Db, want, got
    torch.cuda.empty_cache()

    # the chunked selection rung at the k-NN example's size
    Xm, _ = make_mixture(N_KNN, COMM_KNN, D_KNN, SEED)
    Xg = torch.as_tensor(Xm, device=dev)
    ms_k, g = time_ms(lambda: ops.topk_select(Xg, K_KNN, impl="cuda"), 3)
    ms_c, gc = time_ms(lambda: ops.topk_select(Xg, K_KNN, impl="chunked"), 1)
    compare("phase 16 chunked rung indices", gc.indices, g.indices, True)
    compare("phase 16 chunked rung distances", gc.distances, g.distances,
            True)
    print(f"phase 16: select='chunked' n={Xg.shape[0]} k={K_KNN}: graph "
          f"bitwise topk_select_cuda's; chunked {ms_c!r} ms, kernel "
          f"{ms_k!r} ms")
    del Xg, g, gc

    # k past 1024: the k-NN kernels' large-k variants, under either setting
    Xs, _ = make_mixture(2100, COMM_KNN, D_KNN, SEED + 1)
    Xs = torch.as_tensor(Xs, device=dev)
    k = 2 * pald_topk.LARGE_K
    wrappers = (pald_topk.topk_select_cuda,
                pald_knn.knn_values_from_features_cuda)
    Cs = {}
    for on_error in ("raise", "fallback"):
        reset_counts(*wrappers)
        p = pald.plan(Xs, kind="features", k=k, block=32, on_error=on_error,
                      normalize=False)
        with plain_forbidden(f"phase 16 k={k} {on_error}"):
            Cs[on_error] = p.execute(Xs)
        got = [(f.launches, f.large_launches) for f in wrappers]
        if got != [(1, 1), (1, 1)] or p.explain()["degradations"]:
            fail(f"phase 16: k={k} under on_error={on_error!r}: launches "
                 f"{got}, degradations {p.explain()['degradations']}")
    compare(f"phase 16 k={k} fallback plan vs raise plan", Cs["fallback"],
            Cs["raise"], True)
    graph, vals = ops.select_cohere(Xs, k=k)
    compare(f"phase 16 k={k} C", Cs["raise"], knn.scatter_dense(graph, vals),
            True)
    err, _, _ = large_k_slab(f"phase 16 k={k}", Xs, graph, vals, 1000, k)
    print(f"phase 16: from_features(X, k={k}) n={Xs.shape[0]}: 'raise' and "
          f"'fallback' answer on the large-k variants (one launch of each, "
          f"no degradation), C bitwise each other and select_cohere's "
          f"scatter; rows 1000:{1000 + LARGE_SLAB}: graph bitwise, values "
          f"max |err| {err!r} against the plain versions")
    torch.cuda.empty_cache()


def phase_chunks(dev, card, clock_mhz, reps=3):
    """Phase 17: batched chunks.  B small items through the kernel method,
    one item a launch (batch=1) against the whole batch in one chunk (one
    grid a pass): times (median of ``reps``, in turns) and C bitwise; then
    the same for the fused and both k-NN paths (one launch of each kernel a
    chunk), a ragged tie-heavy chunk through each, and the chunked kernels
    against their plain versions at B = 64, n = 256 (the kernels' rows)."""
    import torch
    from repro_torch.core import pald
    from repro_torch.kernels import pald_focus

    for items, n in CHUNK_CELLS:
        Db = _stack_distances(items, n, dev, SEED + 170)
        for sched in ("dense", "tri"):
            kw = dict(method="kernel", schedule=sched, ties="ignore")
            loop = pald.plan(Db, batch=1, **kw)
            chunk = pald.plan(Db, **kw)
            pald_focus.reset_tile_counts()
            focus, coh = _pipeline_wrappers(sched)
            f0, c0 = focus.launches, coh.launches
            C = chunk.execute(Db)
            blocks = pald_focus.tile_counts(dev)[0]
            if (focus.launches - f0, coh.launches - c0) != (1, 1) or \
                    blocks != items * pald_focus.focus_blocks(n, n, True):
                fail(f"phase 17: {sched} B={items} n={n}: launches "
                     f"{(focus.launches - f0, coh.launches - c0)}, focus "
                     f"blocks {blocks}")
            compare(f"phase 17 {sched} B={items} n={n}", C,
                    loop.execute(Db), True)
            t = {"loop": [], "chunk": []}
            for which in ("loop", "chunk", "chunk", "loop"):
                plan_ = loop if which == "loop" else chunk
                ms, _ = time_ms(lambda: plan_.execute(Db), reps)
                t[which].append(ms)
            print(f"phase 17: {sched} B={items} n={n}: one chunk (1 launch "
                  f"a pass, {blocks} focus blocks) {t['chunk']} ms, one "
                  f"item a launch {t['loop']} ms (medians of {reps}, in "
                  f"turns), loop/chunk "
                  f"{min(t['loop']) / min(t['chunk']):.2f}; C bitwise; "
                  f"{card}")
        del Db
    launches = phase_chunk_paths(dev, card, reps)
    return phase_chunk_kernels(dev, card, clock_mhz, launches)


def _chunk_wrappers(path):
    """The CUDA wrappers a chunk of ``path`` launches, once each."""
    from repro_torch.kernels import pald_fused, pald_knn, pald_topk

    return {"fused": (pald_fused.focus_fused_cuda,
                      pald_fused.cohesion_fused_cuda),
            "knn features": (pald_topk.topk_select_cuda,
                             pald_knn.knn_values_from_features_cuda),
            "knn distance": (pald_knn.knn_values_from_distances_cuda,)}[path]


def _chunk_plans(path, x, **kw):
    """(chunk, loop) plans of ``path`` on the stack ``x``: the whole batch
    in one chunk, and one item a launch (batch=1)."""
    from repro_torch.core import pald

    if path == "fused":
        kw = dict(kind="features", method="fused", **kw)
    elif path == "knn features":
        kw = dict(kind="features", k=K_CHUNK, **kw)
    else:
        kw = dict(method="knn", k=K_CHUNK, **kw)
    return pald.plan(x, **kw), pald.plan(x, batch=1, **kw)


def chunk_path(tag, path, x, card, reps=3, time_it=True, **kw):
    """One chunk of ``path`` on the stack ``x``: the wrappers' counts set to
    0, the chunk driven once and every kernel of the path launched exactly
    once (no item loop, no plain version), C bitwise the items one a
    launch; then chunk and loop timed in turns.  The launches by wrapper
    name."""
    import torch

    chunk, loop = _chunk_plans(path, x, **kw)
    wrappers = _chunk_wrappers(path)
    for w in wrappers:
        w.launches = 0
    C = chunk.execute(x)
    torch.cuda.synchronize()
    launched = {w.__name__: w.launches for w in wrappers}
    if set(launched.values()) != {1}:
        fail(f"phase 17: {tag}: launches {launched}, not one a kernel")
    if C.shape != (x.shape[0], x.shape[1], x.shape[1]):
        fail(f"phase 17: {tag}: C is {tuple(C.shape)}")
    compare(f"phase 17 {tag}", C, loop.execute(x), True)
    if not time_it:
        print(f"phase 17: {tag}: launches {launched}; C bitwise the items "
              "one a launch")
        return launched
    t = {"loop": [], "chunk": []}
    for which in ("loop", "chunk", "chunk", "loop"):
        plan_ = loop if which == "loop" else chunk
        ms, _ = time_ms(lambda: plan_.execute(x), reps)
        t[which].append(ms)
    print(f"phase 17: {tag}: one chunk (launches {launched}) {t['chunk']} "
          f"ms, one item a launch {t['loop']} ms (medians of {reps}, in "
          f"turns), loop/chunk {min(t['loop']) / min(t['chunk']):.2f}; C "
          f"bitwise; {card}")
    return launched


def _stack_points(items, n, d, dev, seed):
    """(items, n, d) clustered points on the card."""
    import torch

    return torch.as_tensor(np.stack([clustered_points(n, d, seed + i)[0]
                                     for i in range(items)]), device=dev)


def phase_chunk_paths(dev, card, reps=3):
    """Phase 17, the fused and k-NN paths: ``from_features(Xb,
    method="fused")`` at the reference's run_batched cells and the dense
    cells (d = 8 and 64), ``from_features(Xb, k=32)`` and
    ``cohesion(Db, method="knn", k=32)`` at the dense cells, each chunk
    against its item loop; then a ragged tie-heavy chunk through each path
    under split and ignore.  The launches of each wrapper in the chunks of
    the kernels' rows (B = 64, n = 256; fused at d = 64)."""
    import torch

    launches = {}
    for items, n in FUSED_CHUNK_CELLS:
        for d in FUSED_CHUNK_DS:
            Xb = _stack_points(items, n, d, dev, SEED + 171)
            got = chunk_path(f"fused B={items} n={n} d={d}", "fused", Xb,
                             card, reps)
            if (items, n, d) == CHUNK_CELLS[0] + (D_FUSED,):
                launches.update(got)
            del Xb
    for items, n in CHUNK_CELLS:
        Xb = _stack_points(items, n, D_KNN_CHUNK, dev, SEED + 172)
        got = chunk_path(f"knn features B={items} n={n} k={K_CHUNK} "
                         f"d={D_KNN_CHUNK}", "knn features", Xb, card, reps)
        Db = torch.stack([distances_on_device(x) for x in Xb])
        got.update(chunk_path(f"knn distance B={items} n={n} k={K_CHUNK}",
                              "knn distance", Db, card, reps))
        if (items, n) == CHUNK_CELLS[0]:
            launches.update(got)
        del Xb, Db
    items, n = RAGGED_CHUNK
    rng = np.random.default_rng(SEED + 173)
    Xb = torch.stack([fused_features(rng, n, 5, dev) for _ in range(items)])
    Db = torch.stack([distances_on_device(x) for x in Xb])
    for ties in ("split", "ignore"):
        for path, x in (("fused", Xb), ("knn features", Xb),
                        ("knn distance", Db)):
            chunk_path(f"{path} B={items} n={n} tie-heavy {ties}", path, x,
                       card, time_it=False, ties=ties)
    return launches


def phase_chunk_kernels(dev, card, clock_mhz, launches, reps=5):
    """Phase 17, the kernels' rows: each chunked kernel on a chunk of B =
    64 items at n = 256 (fused at d = 64, k-NN at k = 32, d = 8) against
    its plain version item by item, timed beside its bound (B times an
    item's) and the same kernel one item a launch; ``launches``: each
    wrapper's launches in phase 17's chunk of that cell."""
    import torch
    from repro_torch.core import knn as tknn
    from repro_torch.kernels import pald_fused, pald_knn, pald_topk
    from repro_torch.kernels.ref import weights_ref

    items, n = CHUNK_CELLS[0]
    rows = []

    def row(name, wrapper, src, replaces, chunk, plain, err, bound, loop):
        ms_k, _ = time_ms(chunk, reps)
        ms_p, _ = time_ms(plain, 1)
        ms_l, _ = time_ms(loop, reps)
        b_ms, b_by = bound
        print(f"phase 17: {name} B={items} n={n}: kernel {ms_k!r} ms a "
              f"chunk (one item a launch: {ms_l!r} ms), plain {ms_p!r} ms, "
              f"bound {b_ms!r} ms ({b_by}), kernel/bound {ms_k / b_ms:.3f}, "
              f"library: none; {card}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": launches[wrapper.__name__],
                     "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "chunk": [items, n], "item_loop_ms": ms_l})

    def scaled(bound):
        return items * bound[0], bound[1]

    d = D_FUSED
    Xb = _stack_points(items, n, d, dev, SEED + 174)
    fused = "src/repro_torch/csrc/pald_fused_chunk.cu"
    f, c = pald_fused.focus_fused_cuda, pald_fused.cohesion_fused_cuda
    Ub = f(Xb)
    Up = torch.stack([pald_fused.focus_fused_torch(x, block=256)
                      for x in Xb])
    Wb = weights_ref(Ub)
    Cb = c(Xb, Wb)
    Cp = torch.stack([pald_fused.cohesion_fused_torch(x, w, block=256)
                      for x, w in zip(Xb, Wb)])
    row("focus_fused_chunk", f, fused, "src/repro/kernels/pald_fused.py:71",
        lambda: f(Xb),
        lambda: [pald_fused.focus_fused_torch(x, block=256) for x in Xb],
        compare("phase 17 focus_fused chunk vs plain", Ub, Up, True),
        scaled(fused_bound_ms("focus", n, d, clock_mhz)),
        lambda: [f(x) for x in Xb])
    row("cohesion_fused_chunk", c, fused, "src/repro/kernels/pald_fused.py:144",
        lambda: c(Xb, Wb),
        lambda: [pald_fused.cohesion_fused_torch(x, w, block=256)
                 for x, w in zip(Xb, Wb)],
        compare("phase 17 cohesion_fused chunk vs plain", Cb, Cp, False),
        scaled(fused_bound_ms("cohesion", n, d, clock_mhz)),
        lambda: [c(x, w) for x, w in zip(Xb, Wb)])
    del Xb, Ub, Up, Wb, Cb, Cp

    k, d = K_CHUNK, D_KNN_CHUNK
    Xb = _stack_points(items, n, d, dev, SEED + 175)
    Db = torch.stack([distances_on_device(x) for x in Xb])
    sel = pald_topk.topk_select_cuda
    gb = sel(Xb, k)
    plain = [pald_topk.topk_select_torch(x, k) for x in Xb]
    compare("phase 17 topk_select chunk vs plain, indices", gb.indices,
            torch.stack([g.indices for g in plain]), True)
    row("topk_select_chunk", sel, "src/repro_torch/csrc/pald_topk_chunk.cu",
        "src/repro/kernels/pald_topk.py:181", lambda: sel(Xb, k),
        lambda: [pald_topk.topk_select_torch(x, k) for x in Xb],
        compare("phase 17 topk_select chunk vs plain, distances",
                gb.distances, torch.stack([g.distances for g in plain]),
                True),
        scaled(knn_bound_ms("topk_select", n, k, d, clock_mhz)),
        lambda: [sel(x, k) for x in Xb])
    dn, idx = gb.distances, gb.indices
    vf = pald_knn.knn_values_from_features_cuda
    row("knn_values_features_chunk", vf,
        "src/repro_torch/csrc/pald_knn.cu",
        "src/repro/kernels/pald_knn.py:74", lambda: vf(Xb, dn, idx),
        lambda: [pald_knn.knn_values_from_features_torch(x, a, i)
                 for x, a, i in zip(Xb, dn, idx)],
        compare("phase 17 knn_values features chunk vs plain",
                vf(Xb, dn, idx),
                torch.stack([pald_knn.knn_values_from_features_torch(x, a, i)
                             for x, a, i in zip(Xb, dn, idx)]), False),
        scaled(knn_bound_ms("knn_values_features", n, k, d, clock_mhz)),
        lambda: [vf(x, a, i) for x, a, i in zip(Xb, dn, idx)])
    gd = tknn.knn_from_distances(Db, k)
    dd, di = gd.distances, gd.indices
    vd = pald_knn.knn_values_from_distances_cuda
    row("knn_values_distances_chunk", vd,
        "src/repro_torch/csrc/pald_knn.cu",
        "src/repro/kernels/pald_knn.py:74", lambda: vd(Db, dd, di),
        lambda: [pald_knn.knn_values_from_distances_torch(D, a, i)
                 for D, a, i in zip(Db, dd, di)],
        compare("phase 17 knn_values D chunk vs plain", vd(Db, dd, di),
                torch.stack([pald_knn.knn_values_from_distances_torch(D, a, i)
                             for D, a, i in zip(Db, dd, di)]), False),
        scaled(knn_bound_ms("knn_values_distances", n, k, d, clock_mhz)),
        lambda: [vd(D, a.contiguous(), i.contiguous())
                 for D, a, i in zip(Db, dd, di)])
    return rows


# phase 18: the method crossover's sizes, and the pad sweep's n and blocks
METHOD_NS = (64, 128, 256, 512, 1024)
N_PAD, PAD_BLOCKS = 8000, (64, 128, 256, 512)
DEFAULT_NS = (256, 1024)


def phase_tuned(dev, card, iters=3):
    """Phase 18: tune on the card into the run's own cache, then plan the
    main path from it (see the module docstring)."""
    import torch
    from repro_torch.core import pald
    from repro_torch.testing import faults
    from repro_torch.tuning import autotune

    backend = autotune.backend_of(dev)
    if backend != torch.cuda.get_device_name(dev):
        fail(f"phase 18: the cache's backend {backend!r} is not the card's "
             f"name")
    rows = autotune.tune_methods(ns=METHOD_NS, device=dev, iters=iters,
                                 time_budget=30.0)
    for r in rows:
        if "skipped" in r or r.get("failed"):
            fail(f"phase 18: method crossover at n={r['n']}: {r}")
        print(f"phase 18: methods n={r['n']}: " + ", ".join(
            f"{m} {t * 1e3:.3f} ms" for m, t in r["timings"].items())
            + f" -> {r['method']} (median of {iters}; {card})")
    print("phase 18: crossover on " + backend + ": " + ", ".join(
        f"n={r['n']} {r['method']}" for r in rows))
    far = pald.plan(n=8192).explain()
    print(f"phase 18: pald.cohesion(D) at n=8192 would resolve to "
          f"method={far['method']!r} from {far['method_source']}"
          + ("" if far["method"] in ("triplet", "kernel") else
             " (plain torch: the default call would leave the kernels)"))

    X, _ = clustered_points(N_PAD, D_MAIN, SEED + 180)
    D = distances_on_device(torch.as_tensor(X, device=dev))
    for pass_ in ("pald", "pald_tri"):
        rec = autotune.tune(N_PAD, pass_, impl="cuda", device=dev,
                            blocks=PAD_BLOCKS, iters=iters, time_budget=20.0)
        for row in rec["grid"]:
            if "seconds" not in row:
                fail(f"phase 18: tune {pass_} n={N_PAD}: {row}")
            print(f"phase 18: pad sweep {pass_} n={N_PAD} block="
                  f"{row['block']} padded_n={row['padded_n']}: "
                  f"{row['seconds'] * 1e3:.3f} ms (median of {iters}, "
                  f"synchronized wall time; {card})")
        print(f"phase 18: {pass_} n={N_PAD}: best block {rec['block']} "
              f"({rec['seconds'] * 1e3:.3f} ms), cached under "
              f"{backend}|cuda|{N_PAD}|{pass_}")

    p = pald.plan(D, method="kernel", block="auto")
    want_src = f"cache:{backend}|cuda|{N_PAD}|pald"
    if p.block_source != want_src or p.impl != "cuda":
        fail(f"phase 18: block='auto' plan: block_source "
             f"{p.block_source!r}, impl {p.impl!r}; want {want_src!r}")
    def peak_run(plan_):
        """C of one call and its peak device memory above the input, in
        n^2 float32 buffers."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = plan_.execute(D)
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / (
            4 * N_PAD * N_PAD)

    C, peak = peak_run(p)
    compare(f"phase 18 block=auto ({p.block}) against an explicit plan",
            C, pald.plan(D, method="kernel", block=p.block).execute(D), True)
    C128, peak128 = peak_run(pald.plan(D, method="kernel", block=128))
    err = compare("phase 18 block=auto against block=128", C, C128, False)
    print(f"phase 18: plan(D, method='kernel', block='auto') n={N_PAD}: "
          f"block {p.block} (padded_n {p.padded_n}) from {p.block_source}; "
          f"C bitwise the explicit block={p.block} plan's, max |err| "
          f"{err!r} against block=128; peak device memory above the input "
          f"{peak:.3f} n^2 (block=128: {peak128:.3f} n^2)")
    del C
    ends = {"auto": [], 128: []}
    for blk in ("auto", 128, 128, "auto"):
        ms, _ = time_ms(lambda: pald.cohesion(D, method="kernel", block=blk),
                        iters)
        ends[blk].append(ms)
    print(f"phase 18: cohesion(D, method='kernel') n={N_PAD} end to end "
          f"(CUDA events, median of {iters}, in turns auto, 128, 128, "
          f"auto): block='auto' ({p.block}) {ends['auto']} ms, block=128 "
          f"{ends[128]} ms; {card}")

    for n in DEFAULT_NS:
        Xn, _ = clustered_points(n, D_MAIN, SEED + 181)
        Dn = distances_on_device(torch.as_tensor(Xn, device=dev))
        pn = pald.plan(Dn)
        want_src = f"cache:{backend}|-|{n}|method"
        if pn.method_source != want_src:
            fail(f"phase 18: default plan n={n}: method_source "
                 f"{pn.method_source!r}, want {want_src!r}")
        err = compare(f"phase 18 cohesion(D) n={n} ({pn.method})",
                      pn.execute(Dn), pald.cohesion(Dn, method="kernel"),
                      False)
        print(f"phase 18: pald.cohesion(D) n={n}: method {pn.method!r} from "
              f"{pn.method_source}; max |err| {err!r} against "
              f"method='kernel'")

    with faults.corrupt_tuning_cache() as path:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pc = pald.plan(D, method="kernel", block="auto")
        moved = [f for f in os.listdir(os.path.dirname(path))
                 if f.startswith(os.path.basename(path) + ".corrupt-")]
        if pc.block_source != "default" or pc.block != 128 or not moved:
            fail(f"phase 18: corrupt cache: block_source "
                 f"{pc.block_source!r}, block {pc.block}, moved {moved}")
        compare("phase 18 corrupt cache against a fresh plan",
                pc.execute(D), C128, True)
        print(f"phase 18: corrupt cache: plan block {pc.block} from "
              f"{pc.block_source!r}, C bitwise a fresh plan's; quarantined "
              f"to {moved[0]}; {len(caught)} warning(s): "
              f"{str(caught[0].message)[:80] if caught else ''}")
    if pald.plan(D, method="kernel", block="auto").block_source != \
            f"cache:{backend}|cuda|{N_PAD}|pald":
        fail("phase 18: the cache was not restored after the corruption")


# ---------------------------------------------------------------------------
# phases 19-23: distributed PaLD (core/distributed.py, distributed_knn.py)
# in local worlds of ranks that share the card (testing/world.py: gloo,
# host-staged; NCCL refuses two ranks on one device), and one NCCL rank
# ---------------------------------------------------------------------------
P_DIST = 4             # ranks sharing the card
N_SMALL_DIST = 2048    # the pod stream's and bfloat16 communication's n
N_RAGGED_DIST = 8190   # ring at a ragged n (padded to 8192)
N_FACADE = 8192        # the k-NN facade's dense C (the mixture's rows)
WORLD_DEADLINE = 600.0  # seconds any one call of a world may take

_RANK_INPUTS: dict = {}  # a rank's inputs, made once in each rank process


class _KernelClock:
    """CUDA events around every call of the kernel wrappers that
    ``(module, name)`` names (each name replaced for the ``with`` body by a
    timing wrapper; a name the wrapper's own module reads for its counter
    must not be replaced: replace a caller's reference to it, or wrap the
    tuple a ``(module, name)`` function returns with ``returns=True``):
    their device time."""

    def __init__(self, targets, returns=False):
        self.targets, self.saved, self.pairs = targets, [], []
        self.returns = returns

    def timed(self, fn):
        import torch

        def timed(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            self.pairs.append((s, e))
            return out

        return timed

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            if self.returns:
                setattr(mod, name, lambda *a, _fn=fn, **k: tuple(
                    self.timed(f) for f in _fn(*a, **k)))
            else:
                setattr(mod, name, self.timed(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def _rank_device():
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def _rank_D(n):
    """Phase 3's clustered distances at n (the same seed), on the card."""
    import torch

    if ("D", n) not in _RANK_INPUTS:
        X, _ = clustered_points(n, D_MAIN, SEED)
        _RANK_INPUTS[("D", n)] = distances_on_device(
            torch.as_tensor(X, device=_rank_device()))
    return _RANK_INPUTS[("D", n)]


def _rank_X(kind, n):
    """Phase 7's features (d = 64) or phase 10's mixture (d = 8)."""
    import torch

    if (kind, n) not in _RANK_INPUTS:
        X = (clustered_points(n, D_FUSED, SEED)[0] if kind == "fused"
             else make_mixture(n, COMM_KNN, D_KNN, SEED)[0])
        _RANK_INPUTS[(kind, n)] = torch.as_tensor(X, device=_rank_device())
    return _RANK_INPUTS[(kind, n)]


def _drop_inputs():
    _RANK_INPUTS.clear()


def _hold(tag, C, want, n, mass=True):
    """Rank 0's check of a distributed C against single-device."""
    import torch

    if not bool(torch.isfinite(C).all()):
        fail(f"{tag}: non-finite C")
    err = float((C.double() - want.double()).abs().max())
    if not torch.allclose(C, want, rtol=RTOL, atol=ATOL):
        fail(f"{tag}: max |err| {err!r} beyond rtol {RTOL}, atol {ATOL} of "
             "single-device")
    total = float(C.double().sum())
    if mass and abs(total - n / 2) > 1e-3 * n:
        fail(f"{tag}: mass {total!r} != n/2 = {n / 2}")
    return err, total


def _dense_counters():
    from repro_torch.kernels import ops, pald_cohesion, pald_focus

    foc = pald_focus.focus_general_cuda
    coh = pald_cohesion.cohesion_general_cuda
    foc.launches = coh.launches = 0
    return foc, coh, _KernelClock([(ops, "focus_general_cuda"),
                                   (ops, "cohesion_general_cuda")])


def rank_dense(mesh, n, strategy, *, comm_bf16=False, pod_stream=None,
               features=False, save=None, against=None):
    """A rank of phases 19 and 21: ``pald_distributed`` (or, with
    ``features``, ``pald_distributed_from_features`` at d = 64) at n on
    the card, timed (host clock, and each kernel call by CUDA events),
    its launches and staged bytes counted; rank 0 holds C to single-device
    ``cohesion(D, method="kernel")`` (``from_features(X,
    method="kernel")``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed, pald

    src = _rank_X("fused", n) if features else _rank_D(n)
    foc, coh, clock = _dense_counters()
    distributed.reset_staged_bytes()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    with clock:
        if features:
            C = distributed.pald_distributed_from_features(src, mesh,
                                                           strategy=strategy)
        else:
            C = distributed.pald_distributed(
                src, mesh, strategy=strategy, pod_stream=pod_stream,
                comm_dtype=torch.bfloat16 if comm_bf16 else None)
        torch.cuda.synchronize()
    out = {"rank": dist.get_rank(), "wall_s": time.perf_counter() - t0,
           "kernel_ms": clock.ms(), "focus": foc.launches,
           "cohesion": coh.launches, "staged": distributed.staged_bytes()}
    if foc.launches == 0 or coh.launches == 0:
        fail(f"rank {out['rank']}: {strategy}: a kernel was not launched "
             f"(focus {foc.launches}, cohesion {coh.launches})")
    if dist.get_rank() == 0:
        if features:
            want = pald.from_features(src, method="kernel")
        else:
            Dw = src.to(torch.bfloat16).float() if comm_bf16 else src
            want = pald.cohesion(Dw, method="kernel")
        out["max_abs_err"], out["mass"] = _hold(
            f"{strategy} n={n}", C, want, n, mass=not comm_bf16)
        Cn = C.cpu().numpy()
        if save:
            np.save(save, Cn)
        if against:
            prev = np.load(against)
            out["bitwise_prev"] = bool(np.array_equal(prev, Cn))
            out["err_prev"] = float(np.abs(prev.astype(np.float64)
                                           - Cn).max())
            if not np.allclose(Cn, prev, rtol=RTOL, atol=ATOL):
                fail(f"{strategy}: the NCCL rank's C is {out['err_prev']!r} "
                     "from the gloo world's")
    return out


def _print_ranks(phase, tag, outs, card):
    for o in outs:
        extra = ""
        if "max_abs_err" in o:
            extra = (f", C within rtol {RTOL}, atol {ATOL} of single-device "
                     f"(max |err| {o['max_abs_err']!r}"
                     + (f", mass {o['mass']!r})" if "mass" in o else ")"))
        if "bitwise_prev" in o:
            extra += (", C bitwise the gloo world's" if o["bitwise_prev"]
                      else f", C {o['err_prev']!r} from the gloo world's")
        print(f"phase {phase}: {tag} rank {o['rank']}: {o['wall_s']:.3f} s "
              f"wall, kernels {o['kernel_ms']:.3f} ms (CUDA events), "
              + (f"launches focus {o['focus']} cohesion {o['cohesion']}, "
                 if "focus" in o else "")
              + f"staged {o['staged']} B{extra} ({card})")


def _closed(world, phase):
    if world.exitcodes and any(c != 0 for c in world.exitcodes):
        fail(f"phase {phase}: a rank exited with {world.exitcodes}")


def phase_dense_distributed(card, tmp):
    """Phase 19: dense distributed PaLD on p = 4 ranks sharing the card
    (gloo, host-staged): allgather and ring on ("data",), 2d on (2, 2) at
    n = 8192 (phase 3's D); the pod stream on (2, 2, 2) with p = 8 and
    bfloat16 communication at n = 2048; ring at a ragged n = 8190; then
    one rank on NCCL, ring and allgather at n = 8192 against the gloo
    world's C.  Returns the focus and cohesion launches of the n = 8192
    runs, summed over ranks and strategies."""
    from repro_torch.testing.world import MeshSpec, World

    flat, grid = (MeshSpec((P_DIST,), ("data",)),
                  MeshSpec((2, 2), ("data", "model")))
    launches = {"focus": 0, "cohesion": 0}
    w = World(P_DIST, device="cuda", timeout=WORLD_DEADLINE)
    with w:
        for strategy, mesh in (("allgather", flat), ("ring", flat),
                               ("2d", grid)):
            t0 = time.perf_counter()
            outs = w.run(rank_dense, mesh, N_MAIN, strategy,
                         save=os.path.join(tmp, f"{strategy}.npy"))
            print(f"phase 19: {strategy} p={P_DIST} mesh {mesh.shape} at "
                  f"n={N_MAIN}: {time.perf_counter() - t0:.1f} s")
            _print_ranks(19, strategy, outs, card)
            for k in launches:
                launches[k] += sum(o[k] for o in outs)
        outs = w.run(rank_dense, grid, N_SMALL_DIST, "2d", comm_bf16=True)
        _print_ranks(19, f"2d bf16 comm n={N_SMALL_DIST} (vs single-device "
                         "on the bf16-cast D)", outs, card)
        outs = w.run(rank_dense, flat, N_RAGGED_DIST, "ring")
        _print_ranks(19, f"ring ragged n={N_RAGGED_DIST}", outs, card)
        w.run(_drop_inputs)
    _closed(w, 19)
    w = World(8, device="cuda", timeout=WORLD_DEADLINE)
    with w:
        outs = w.run(rank_dense, MeshSpec((2, 2, 2), ("pod", "data",
                                                      "model")),
                     N_SMALL_DIST, "2d", pod_stream=True)
        _print_ranks(19, f"2d pod stream p=8 (2, 2, 2) n={N_SMALL_DIST}",
                     outs, card)
    _closed(w, 19)
    w = World(1, device="cuda", backend="nccl", timeout=WORLD_DEADLINE)
    with w:
        for strategy in ("ring", "allgather"):
            outs = w.run(rank_dense, MeshSpec((1,), ("data",)), N_MAIN,
                         strategy,
                         against=os.path.join(tmp, f"{strategy}.npy"))
            _print_ranks(19, f"{strategy} one rank on NCCL", outs, card)
    _closed(w, 19)
    return launches


def rect_bound_ms(pass_, mx, my, mz, clock_mhz):
    """Least time of a rectangular pass (operands that are not one square
    matrix, as a shard's are): its bytes (each operand read once, the
    output written once; cohesion reads W too) over HBM bandwidth, and 3
    lane instructions for each (x, y, z) triple (focus: min, compare,
    add; cohesion: the same count per role as :func:`pass_ops`'s 6 per
    unordered pair; general operands have no symmetry to share) over the
    FP32 lanes."""
    if pass_ == "focus":
        nbytes = 4 * (mx * mz + my * mz + 2 * mx * my)
    else:
        nbytes = 4 * (mx * mz + my * mz + 2 * mx * my + mx * mz)
    ops = 3 * mx * my * mz
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (FP32_LANES * clock_mhz * 1e6)
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def phase_rect_kernels(dev, clock_mhz, card, launches, reps=3):
    """Phase 20: the focus kernel's rectangular entry and the cohesion
    kernel at a 1-D shard's shape, DXZ = DXY (2048, 8192) against DYZ
    (8192, 8192) (the allgather body's calls at n = 8192, p = 4), timed by
    CUDA events beside their bounds and their plain versions; U bitwise,
    C within rtol 1e-4 (a sum of up to n terms in another order)."""
    import torch
    from repro_torch.core.distributed import _weights_rows
    from repro_torch.kernels import pald_cohesion, pald_focus

    X, _ = clustered_points(N_MAIN, D_MAIN, SEED)
    D = distances_on_device(torch.as_tensor(X, device=dev))
    m = N_MAIN // P_DIST
    DXZ = D[:m].contiguous()
    rows = []
    ms, U = time_ms(lambda: pald_focus.focus_general_cuda(DXZ, D, DXZ), reps)
    t0 = time.perf_counter()
    Up = pald_focus.focus_general_torch(DXZ, D, DXZ)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = compare("phase 20: rectangular focus", U, Up, exact=True)
    del Up
    W = _weights_rows(U, 0, None)
    rows.append(("focus", ms, plain_ms, err, "U bitwise"))
    ms, C = time_ms(lambda: pald_cohesion.cohesion_general_cuda(
        DXZ, D, DXZ, W), reps)
    t0 = time.perf_counter()
    Cp = pald_cohesion.cohesion_general_torch(DXZ, D, DXZ, W)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = compare("phase 20: rectangular cohesion", C, Cp, exact=False,
                  rtol=RTOL_MAIN)
    rows.append(("cohesion", ms, plain_ms, err,
                 f"C within rtol {RTOL_MAIN}"))
    out = []
    for pass_, ms, plain_ms, err, held in rows:
        bound, by = rect_bound_ms(pass_, m, N_MAIN, N_MAIN, clock_mhz)
        print(f"phase 20: {pass_} rectangular ({m}, {N_MAIN}) x ({N_MAIN}, "
              f"{N_MAIN}): {ms:.3f} ms (median of {reps}), plain "
              f"{plain_ms:.1f} ms, bound {bound:.3f} ms ({by}), {held} "
              f"({card})")
        out.append({
            "name": f"{pass_}_general_rect", "route": "cuda",
            "source": f"src/repro_torch/csrc/pald_{pass_}.cu",
            "replaces": ("src/repro/kernels/pald_focus.py:55"
                         if pass_ == "focus" else
                         "src/repro/kernels/pald_cohesion.py:134"),
            "entry": ("rectangular (operands not one square matrix)"
                      if pass_ == "focus" else "a shard's rectangle")
            + ", phase 19's shard bodies",
            "launches": launches[pass_], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
    return out


def phase_features_distributed(card):
    """Phase 21: ``pald_distributed_from_features`` at n = 8192, d = 64,
    ring and allgather on p = 4 ranks sharing the card."""
    from repro_torch.testing.world import MeshSpec, World

    w = World(P_DIST, device="cuda", timeout=WORLD_DEADLINE)
    with w:
        for strategy in ("ring", "allgather"):
            t0 = time.perf_counter()
            outs = w.run(rank_dense, MeshSpec((P_DIST,), ("data",)), N_MAIN,
                         strategy, features=True)
            print(f"phase 21: {strategy} from features p={P_DIST} n={N_MAIN}"
                  f" d={D_FUSED}: {time.perf_counter() - t0:.1f} s")
            _print_ranks(21, strategy, outs, card)
    _closed(w, 21)


def _knn_counters():
    from repro_torch.core import distributed_knn
    from repro_torch.kernels import pald_knn, pald_topk

    fns = {"topk_block": pald_topk.topk_block_cuda,
           "values_features": pald_knn.knn_values_from_features_cuda,
           "values_neighbors": pald_knn.knn_values_from_neighbors_cuda}
    for f in fns.values():
        f.launches = 0
    # the shard bodies take their kernels from distributed_knn._kernels
    clock = _KernelClock([(distributed_knn, "_kernels")], returns=True)
    return fns, clock


def rank_knn(mesh, strategy, *, facade=False, on_error="raise"):
    """A rank of phases 22 and 23: ``pald_knn_sharded`` on the k-NN
    example's mixture (n = 50,000, k = 32, d = 8), or with ``facade``
    ``pald.from_features(X, method="knn", k=32, mesh=)`` at n = 8175;
    rank 0 holds the graph and values (C) bitwise single-device."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed, distributed_knn, pald
    from repro_torch.kernels import ops

    from repro_torch.core.resilience import DegradationWarning

    warnings.simplefilter("ignore", DegradationWarning)  # counted below
    X = _rank_X("knn", N_FACADE if facade else N_KNN)
    fns, clock = _knn_counters()
    distributed.reset_staged_bytes()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    with clock:
        if facade:
            p = pald.plan(X, kind="features", method="knn", k=K_KNN,
                          mesh=mesh, on_error=on_error)
            C = p.execute(X)
            info = p.explain()
        else:
            g, v = distributed_knn.pald_knn_sharded(X, mesh, k=K_KNN,
                                                    strategy=strategy,
                                                    on_error=on_error)
        torch.cuda.synchronize()
    out = {"rank": dist.get_rank(), "wall_s": time.perf_counter() - t0,
           "kernel_ms": clock.ms(), "staged": distributed.staged_bytes(),
           "launches": {k: f.launches for k, f in fns.items()}}
    if facade:
        out["mesh"] = (info["mesh"], info["mesh_axes"], info["strategy"],
                       info["shard_rows"],
                       info["comm_estimate"]["per_device_bytes"])
        out["degradations"] = [e["fallback"] for e in info["degradations"]]
    if dist.get_rank() == 0:
        if facade:
            want = pald.from_features(X, method="knn", k=K_KNN)
            if not torch.equal(C, want):
                fail("the mesh facade's C is not bitwise single-device")
        else:
            g1, v1 = ops.select_cohere(X, k=K_KNN, normalize=True)
            for what, a, b in (("indices", g.indices, g1.indices),
                               ("distances", g.distances, g1.distances),
                               ("values", v, v1)):
                if not torch.equal(a, b):
                    fail(f"{strategy}: sharded {what} not bitwise "
                         "single-device select_cohere")
        out["bitwise"] = True
    return out


def _print_knn(phase, tag, outs, card):
    for o in outs:
        la = ", ".join(f"{k} {v}" for k, v in o["launches"].items())
        print(f"phase {phase}: {tag} rank {o['rank']}: {o['wall_s']:.3f} s "
              f"wall, kernels {o['kernel_ms']:.3f} ms (CUDA events), "
              f"launches {la}, staged {o['staged']} B"
              + (", graph and values bitwise single-device"
                 if o.get("bitwise") else "") + f" ({card})")


def phase_knn_distributed(card):
    """Phase 22: the sharded k-NN pipeline at the k-NN example's size on
    p = 4 ranks sharing the card, each strategy (2d on (2, 2)), then the
    facade with ``mesh=``.  Returns the block entry's and the
    neighbor-row source's launches (summed over ranks)."""
    from repro_torch.testing.world import MeshSpec, World

    counts = {"topk_block": 0, "values_neighbors": 0, "values_features": 0}
    w = World(P_DIST, device="cuda", timeout=WORLD_DEADLINE)
    with w:
        for strategy, mesh in (("allgather", MeshSpec((P_DIST,), ("data",))),
                               ("ring", MeshSpec((P_DIST,), ("data",))),
                               ("2d", MeshSpec((2, 2), ("data", "model")))):
            t0 = time.perf_counter()
            outs = w.run(rank_knn, mesh, strategy)
            print(f"phase 22: {strategy} p={P_DIST} mesh {mesh.shape} "
                  f"n={N_KNN} k={K_KNN}: {time.perf_counter() - t0:.1f} s")
            _print_knn(22, strategy, outs, card)
            for o in outs:
                for k in counts:
                    counts[k] += o["launches"][k]
                if o["launches"]["topk_block"] == 0:
                    fail(f"phase 22: {strategy}: rank {o['rank']} launched "
                         "no selection")
                src = ("values_neighbors" if strategy == "ring"
                       else "values_features")
                if o["launches"][src] == 0:
                    fail(f"phase 22: {strategy}: rank {o['rank']} launched "
                         f"no {src}")
        outs = w.run(rank_knn, MeshSpec((2, 2), ("data", "model")), None,
                     facade=True)
        _print_knn(22, f"from_features(X, k={K_KNN}, mesh=) n="
                       f"{N_FACADE // COMM_KNN * COMM_KNN}", outs, card)
        for o in outs:
            if o["mesh"][0] != (2, 2) or o["mesh"][2] != "2d":
                fail(f"phase 22: explain() does not name the mesh: "
                     f"{o['mesh']}")
        print(f"phase 22: explain(): mesh {outs[0]['mesh'][0]} axes "
              f"{outs[0]['mesh'][1]} strategy {outs[0]['mesh'][2]} shard "
              f"rows {outs[0]['mesh'][3]} comm {outs[0]['mesh'][4]} B/rank")
    _closed(w, 22)
    return counts


def phase_guard_distributed(card):
    """Phase 23: a fault at ``distributed_knn.body`` armed in every rank:
    ``on_error="fallback"`` answers bitwise single-device (the module, and
    a mesh plan through its ``mesh:single-device`` rung); ``"raise"``
    raises in every rank; every call within its deadline."""
    from repro_torch.testing.world import MeshSpec, World, WorldError

    rule = [{"site": "distributed_knn.body"}]
    mesh = MeshSpec((2, 2), ("data", "model"))
    w = World(P_DIST, device="cuda", timeout=WORLD_DEADLINE)
    with w:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            outs = w.run(rank_knn, mesh, "2d", on_error="fallback",
                         faults=rule, deadline=300)
        _print_knn(23, "body fault, on_error='fallback'", outs, card)
        if any(o["launches"]["topk_block"] for o in outs):
            fail("phase 23: a faulted body still launched the block entry")
        outs = w.run(rank_knn, mesh, None, facade=True, on_error="fallback",
                     faults=rule, deadline=300)
        for o in outs:
            if o["degradations"] != ["mesh:single-device"]:
                fail(f"phase 23: rank {o['rank']} degraded "
                     f"{o['degradations']}")
        print("phase 23: mesh plan, body fault: every rank rescued by "
              "mesh:single-device, C bitwise single-device")
        try:
            w.run(rank_knn, mesh, "2d", faults=rule, deadline=300)
        except WorldError as exc:
            if sorted(exc.errors) != list(range(P_DIST)) or not all(
                    "injected fault" in e for e in exc.errors.values()):
                fail(f"phase 23: strict mode: {exc}")
            print(f"phase 23: on_error='raise': all {P_DIST} ranks raised "
                  "the injected fault")
        else:
            fail("phase 23: strict mode did not raise")
        outs = w.run(rank_knn, mesh, "2d", deadline=300)
        _print_knn(23, "after the faults, unfaulted", outs, card)
    _closed(w, 23)


def phase_distributed_kernels(dev, clock_mhz, card, counts, reps=3):
    """The block entry of the selection and the neighbor-row source of the
    values kernel at a p = 4 shard's shapes of phase 22 (rows 12,500 of
    the n = 50,000 mixture against every candidate; the shard's 12,500
    rows' neighbor rows), each against its plain version, timed by CUDA
    events beside its bound."""
    import torch
    from repro_torch.kernels import pald_knn, pald_topk

    X, _ = make_mixture(N_KNN, COMM_KNN, D_KNN, SEED)
    Xg = torch.as_tensor(X, device=dev)
    n, d = Xg.shape
    m = n // P_DIST
    rows = Xg[m:2 * m]
    ms, gk = time_ms(lambda: pald_topk.topk_block_cuda(
        rows, Xg, K_KNN, row_off=m, col_off=0), reps)
    t0 = time.perf_counter()
    gp = pald_topk.topk_block_torch(rows, Xg, K_KNN, row_off=m, col_off=0)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    compare("topk_block indices", gk.indices, gp.indices, exact=True)
    err = compare("topk_block distances", gk.distances, gp.distances,
                  exact=True)
    nbytes = 4 * (m * d + n * d + 2 * m * K_KNN)
    ops_ = m * n * (2 * d + 4) + m * n
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_ / (FP32_LANES * clock_mhz * 1e6)
    sel = {"name": "topk_block", "route": "cuda",
           "source": "src/repro_torch/csrc/pald_topk.cu",
           "replaces": "src/repro/kernels/pald_topk.py:181",
           "entry": "block (rows against a candidate block, global "
                    "indices), phase 22's shard bodies",
           "launches": counts["topk_block"], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_b, t_o),
           "bound_by": "operations" if t_o >= t_b else "bytes",
           "library_ms": None}
    print(f"phase 22: topk_block ({m} rows x {n} candidates, k={K_KNN}): "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{sel['bound_ms']:.3f} ms ({sel['bound_by']}), bitwise ({card})")
    dn, idx = gk.distances, gk.indices
    Xn = Xg[idx.long()].contiguous()
    ms, vk = time_ms(lambda: pald_knn.knn_values_from_neighbors_cuda(
        Xn, dn, idx, row_off=m), reps)
    t0 = time.perf_counter()
    vp = pald_knn.knn_values_from_neighbors_torch(Xn, dn, idx, row_off=m)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = compare("knn_values_neighbors", vk, vp, exact=False)
    vf = pald_knn.knn_values_from_features_cuda(Xg, dn, idx, row_off=m)
    compare("neighbor rows vs features source", vk, vf, exact=True)
    k = K_KNN
    nbytes = 4 * (m * k * d + 2 * m * k + m * (k + 1))
    ops_ = m * (k * (k - 1) // 2 * (2 * d + 4) + 7 * k * (k + 1))
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_ / (FP32_LANES * clock_mhz * 1e6)
    val = {"name": "knn_values_neighbors", "route": "cuda",
           "source": "src/repro_torch/csrc/pald_knn.cu",
           "replaces": "src/repro/kernels/pald_knn.py:74",
           "entry": "features source fed each row's (k, d) neighbor rows, "
                    "phase 22's ring bodies",
           "launches": counts["values_neighbors"], "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_b, t_o),
           "bound_by": "operations" if t_o >= t_b else "bytes",
           "library_ms": None}
    print(f"phase 22: knn_values_neighbors ({m} rows, k={k}, d={d}): "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{val['bound_ms']:.4f} ms ({val['bound_by']}), bitwise the "
          f"features source with the row offset ({card})")
    return [sel, val]


# phase 24: the LM serving path at the serve driver's defaults
LM_ARCH = "gemma2-2b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 32
# float32 prefill and decode logits against one cache-free forward: the
# same products summed in other orders (other matmul shapes)
LM_RTOL = LM_ATOL = 1e-3
LM_REPS = 5
# the other archs one card holds at full width and depth, with the path
# each adds: (arch, batch, prompt, tokens generated).  mamba2's prompt
# spans two SSD chunks of 256 (the forward over prompt + generated tokens
# then runs three chunks of 173); granite's batch x prompt fills eight
# MoE dispatch groups of 128 tokens.
LM_FULL = (("mamba2-780m", 2, 512, 8),
           ("granite-moe-1b-a400m", 4, 256, 8))


def _lm_inputs(cfg, gen, B, S, dev):
    """Token ids, or the frontend stub's float32 embeddings for the audio
    and vlm archs."""
    import torch
    from repro_torch.models.model import (audio_frontend_stub,
                                          vision_frontend_stub)

    if cfg.modality == "text":
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen, device=dev)}
    stub = (audio_frontend_stub if cfg.modality == "audio"
            else vision_frontend_stub)
    return {"embeds": stub(gen, B, S, cfg.d_model, torch.float32, dev)}


def lm_cache_gate(cfg, params, gen, B, S, G, dev):
    """float32 ``prefill`` and G - 1 ``decode_step``s (greedy tokens; the
    embedding archs take fresh stub embeddings) against one cache-free
    ``apply`` over the same inputs, at the same positions: (max |err|,
    max |logit|); fails beyond LM_RTOL / LM_ATOL."""
    import torch
    from repro_torch.models.model import Model

    model = Model(cfg)
    V = cfg.vocab_size
    caches = model.init_caches(B, S + G, dtype=torch.float32, device=dev)
    inp = _lm_inputs(cfg, gen, B, S, dev)
    key = next(iter(inp))
    logits, caches = model.prefill(params, inp, caches)
    steps, fed = [logits], []
    for i in range(1, G):
        nxt = (torch.argmax(logits[:, :V], -1)[:, None] if key == "tokens"
               else _lm_inputs(cfg, gen, B, 1, dev)["embeds"])
        fed.append(nxt)
        logits, caches = model.decode_step(params, nxt, caches, S + i - 1)
        steps.append(logits)
    with torch.no_grad():
        full, _ = model.apply(params, {key: torch.cat([inp[key]] + fed, 1)})
    got = torch.stack(steps, 1)[..., :V]
    want = full[:, S - 1:, :V]
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    if not torch.allclose(got, want, rtol=LM_RTOL, atol=LM_ATOL):
        fail(f"{cfg.name}: cached prefill/decode logits differ from the "
             f"cache-free forward by {err!r} (rtol {LM_RTOL}, atol "
             f"{LM_ATOL})")
    return err, scale


def lm_prompt_gate(cfg, params, gen, B, S, dev):
    """float32 ``prefill`` against one cache-free ``apply`` over the prompt
    alone: the same tokens in the same MoE dispatch groups, so the same
    tokens dropped at the config's capacity.  (max |err|, max |logit|);
    fails beyond LM_RTOL / LM_ATOL."""
    import torch
    from repro_torch.models.model import Model

    model = Model(cfg)
    V = cfg.vocab_size
    caches = model.init_caches(B, S + 1, dtype=torch.float32, device=dev)
    inp = _lm_inputs(cfg, gen, B, S, dev)
    got, _ = model.prefill(params, inp, caches)
    with torch.no_grad():
        full, _ = model.apply(params, inp)
    got, want = got[:, :V], full[:, -1, :V]
    err = float((got.double() - want.double()).abs().max())
    if not torch.allclose(got, want, rtol=LM_RTOL, atol=LM_ATOL):
        fail(f"{cfg.name}: prefill logits differ from the cache-free forward "
             f"over the prompt by {err!r} (rtol {LM_RTOL}, atol {LM_ATOL})")
    return err, float(want.abs().max())


def _bf16_serve_ok(cfg, tokens, steps):
    import torch

    if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        fail(f"{cfg.name}: a sampled token outside [0, {cfg.vocab_size})")
    if not all(bool(torch.isfinite(l[:, :cfg.vocab_size]).all())
               for l in steps):
        fail(f"{cfg.name}: non-finite bfloat16 logits")


def phase_lm_serve(dev, card, reps=LM_REPS):
    """Phase 24: gemma2-2b at full width and depth seeded on the card,
    held in float32 to its cache-free forward, then served in bfloat16
    (``launch.serve.generate``: the serve steps, batch 4, prompt 32, 32
    tokens, temperature 0.8) ``reps`` times, the first a warm-up: prefill
    ms, decode ms a step, tok/s, peak device memory beside the parameters'
    and caches' bytes, a profiler window over one decode step; then
    LM_FULL's archs at full width and depth (``phase_lm_full``); then the
    other seven archs' reduced configs, float32 gate and bfloat16 serve."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.launch import serve
    from repro_torch.models.model import Model, cast_floats
    from repro_torch.train import serve_step

    cfg = configs.get(LM_ARCH)
    B, S, G = LM_BATCH, LM_PROMPT, LM_GEN
    t0 = time.perf_counter()
    params = Model(cfg).init(SEED, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"phase 24: {cfg.name}, {cfg.n_layers} layers, d = {cfg.d_model}, "
          f"vocab {cfg.vocab_size}: {n_params} parameters (config count "
          f"{cfg.param_count()[0]}), float32, seeded on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    err, scale = lm_cache_gate(cfg, params, gen, B, S, G, dev)
    print(f"phase 24: float32 prefill of {B} x {S} and {G - 1} greedy decode "
          f"steps against one cache-free forward over the same {S + G - 1} "
          f"positions: max |err| {err!r} (logits up to {scale!r}; rtol "
          f"{LM_RTOL}, atol {LM_ATOL}) in {time.perf_counter() - t0:.1f} s")

    params = cast_floats(params, torch.bfloat16)   # the float32 copy goes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    c_bytes = sum(t.numel() * t.element_size() for c in Model(cfg).init_caches(
        B, S + G, device=dev) for t in c.values())
    rows = []
    for rep in range(reps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tokens, steps, t_pre, t_dec = serve.generate(
            cfg, params, gen, batch=B, prompt_len=S, gen_len=G,
            temperature=0.8)
        peak = torch.cuda.max_memory_allocated()
        _bf16_serve_ok(cfg, tokens, steps)
        del steps
        rows.append((t_pre * 1e3, t_dec * 1e3 / (G - 1),
                     (G - 1) * B / t_dec, peak))
        print(f"phase 24: bfloat16 serve run {rep}"
              f"{' (warm-up)' if rep == 0 else ''}: prefill {B} x {S} "
              f"{rows[-1][0]:.3f} ms, decode {rows[-1][1]:.3f} ms a step "
              f"({G - 1} steps), {rows[-1][2]:.1f} tok/s; peak device "
              f"memory {peak} B against parameters {p_bytes} B + caches "
              f"{c_bytes} B ({peak / (p_bytes + c_bytes):.4f}x); {card}")
    steady = rows[1:] or rows
    print(f"phase 24: {cfg.name} bfloat16 serve, median of runs 1-"
          f"{len(rows) - 1}: prefill "
          f"{statistics.median(r[0] for r in steady):.3f} ms, decode "
          f"{statistics.median(r[1] for r in steady):.3f} ms a step, "
          f"{statistics.median(r[2] for r in steady):.1f} tok/s; weight "
          f"bytes {p_bytes} over {HBM_BYTES_PER_S:.3g} B/s = "
          f"{p_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms a step at least; "
          f"{card}")

    model = Model(cfg)
    caches = model.init_caches(B, S + G, device=dev)
    pre = serve_step.make_prefill_step(cfg)
    dec = serve_step.make_decode_step(cfg)
    logits, caches = pre(params, _lm_inputs(cfg, gen, B, S, dev), caches)
    tok = torch.argmax(logits, -1)[:, None]
    got = profile_window(lambda: dec(params, tok, caches, S))
    if got is None:
        print("phase 24: the profiler recorded no device event in a decode "
              "step")
    else:
        share, by_name, window_ms, events = got
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"phase 24: profiler window of one decode step {window_ms:.3f} "
              f"ms, {events} device events, device busy {share:.4f} (idle "
              f"{1 - share:.4f}); kernel ms by name: "
              + "; ".join(f"{k[:50]} {v:.3f}" for k, v in top))
    del params, caches, logits
    torch.cuda.empty_cache()

    phase_lm_full(dev, card, gen)
    for arch in configs.ARCHS:
        if arch == LM_ARCH or arch in {a for a, *_ in LM_FULL}:
            continue
        rcfg = reduced(configs.get(arch))
        rparams = Model(rcfg).init(SEED, dev)
        err, scale = lm_cache_gate(rcfg, rparams, gen, 2, 8, 4, dev)
        tokens, steps, _, _ = serve.generate(
            rcfg, cast_floats(rparams, torch.bfloat16), gen, batch=2,
            prompt_len=8, gen_len=4, temperature=0.8)
        _bf16_serve_ok(rcfg, tokens, steps)
        print(f"phase 24: {rcfg.name}: float32 prefill + 3 decode steps "
              f"against the cache-free forward max |err| {err!r} (logits up "
              f"to {scale!r}); bfloat16 serve tokens in range, logits finite")


def phase_lm_full(dev, card, gen):
    """Phase 24, LM_FULL: each arch seeded on the card at full width and
    depth in float32 and held to its cache-free forward, then served once
    in bfloat16 (``launch.serve.generate``).  A MoE arch is held twice: at
    its capacity, prefill against the forward over the prompt alone
    (``lm_prompt_gate``: the same dispatch groups); prefill and decode
    against the forward over every position at a capacity that drops no
    token (``capacity_factor`` = experts / top-k), since the forward's
    groups hold other tokens than the prefill's and decode's."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import Model, cast_floats

    for arch, B, S, G in LM_FULL:
        cfg = configs.get(arch)
        t0 = time.perf_counter()
        params = Model(cfg).init(SEED, dev)
        n_params = sum(p.numel() for p in params.parameters())
        gate_cfg = cfg
        if cfg.moe is not None:
            err, scale = lm_prompt_gate(cfg, params, gen, B, S, dev)
            print(f"phase 24: {cfg.name}: float32 prefill of {B} x {S} at "
                  f"capacity factor {cfg.moe.capacity_factor} against the "
                  f"cache-free forward over the prompt: max |err| {err!r} "
                  f"(logits up to {scale!r})")
            gate_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        err, scale = lm_cache_gate(gate_cfg, params, gen, B, S, G, dev)
        print(f"phase 24: {cfg.name}, {cfg.n_layers} layers, d = "
              f"{cfg.d_model}, vocab {cfg.vocab_size}: {n_params} parameters "
              f"(config count {cfg.param_count()[0]}); float32 prefill of "
              f"{B} x {S} and {G - 1} greedy decode steps"
              + (f" (capacity factor {gate_cfg.moe.capacity_factor})"
                 if cfg.moe is not None else "")
              + f" against one cache-free forward over {S + G - 1} "
              f"positions: max |err| {err!r} (logits up to {scale!r}; rtol "
              f"{LM_RTOL}, atol {LM_ATOL}) in "
              f"{time.perf_counter() - t0:.1f} s")
        params = cast_floats(params, torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tokens, steps, t_pre, t_dec = serve.generate(
            cfg, params, gen, batch=B, prompt_len=S, gen_len=G,
            temperature=0.8)
        peak = torch.cuda.max_memory_allocated()
        _bf16_serve_ok(cfg, tokens, steps)
        print(f"phase 24: {cfg.name} bfloat16 serve (one run, the first): "
              f"prefill {B} x {S} {t_pre * 1e3:.3f} ms, decode "
              f"{t_dec * 1e3 / (G - 1):.3f} ms a step ({G - 1} steps), "
              f"{(G - 1) * B / t_dec:.1f} tok/s, peak device memory {peak} "
              f"B; tokens in range, logits finite; {card}")
        del params, tokens, steps
        torch.cuda.empty_cache()


# phase 25: the port's examples at their defaults, each a program of its own
# with the lines its output must hold; FRESH_DIR stands for a new empty
# directory (train_lm restores the latest checkpoint it finds in its
# --ckpt-dir, so a used one would train nothing)
FRESH_DIR = object()
EXAMPLES = (
    ("quickstart", (), ("all four methods agree",)),
    ("pald_knn_clusters", (), ("no strong tie ever crosses communities",)),
    ("pald_knn_clusters", ("--mesh", "4", "--strategy", "ring"),
     ("no strong tie ever crosses communities",)),
    ("pald_text_analysis", (), ("strong ties",)),
    ("serve_lm", ("--arch", "gemma2-2b", "--full"), ("[serve] gemma2-2b:",)),
    ("train_lm", ("--ckpt-dir", FRESH_DIR), ("step     0", "step   299",
                                             "strong ties")),
)
EXAMPLE_TIMEOUT_S = 300.0


def phase_examples(card):
    """Phase 25: ``python -m repro_torch.examples.<name>`` for each of
    EXAMPLES on the card: exit 0 and each of its lines; its output and wall
    time printed."""
    src = os.path.join(HERE, "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    for name, args, lines in EXAMPLES:
        fresh = tempfile.mkdtemp(prefix="chip_smoke_example_")
        cmd = [sys.executable, "-m", f"repro_torch.examples.{name}",
               *(fresh if a is FRESH_DIR else a for a in args)]
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                               env=env, timeout=EXAMPLE_TIMEOUT_S)
        finally:
            shutil.rmtree(fresh, ignore_errors=True)
        wall = time.perf_counter() - t0
        missing = [line for line in lines if line not in r.stdout]
        if r.returncode != 0 or missing:
            fail(f"{' '.join(cmd[1:])}: exit {r.returncode}, lines missing "
                 f"{missing!r}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        print(f"phase 25: {' '.join(cmd[2:])}: exit 0 in {wall:.1f} s; {card}")
        for out in r.stdout.strip().splitlines():
            print(f"phase 25:   {out}")


# phase 26: training on one device at launch.train's defaults
TRAIN_ARCH = "gemma2-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 5
TRAIN_LR = 3e-4
# the state's fixed bytes a weight: float32 master, m, v and gradient, and
# the bfloat16 compute copy
TRAIN_BYTES_PER_WEIGHT = 4 + 4 + 4 + 4 + 2
# remat "full" against "nothing": the same ops recomputed; a leaf's
# gradients within one bfloat16 rounding (2^-8) of its largest
REMAT_TOL = 2.0 ** -8
# four microbatches against one (tests/test_train.py:45-58): the loss
# within rtol 1e-5, the weights within 4 lr after one AdamW step (a step
# moves a weight by about lr whatever its gradient, so this gate cannot
# see the gradients); the grad norm within rtol 1e-2, and each leaf's
# float32 gradients within 2^-5 of its largest: each microbatch's bfloat16
# products round apart, while a sum that kept one microbatch or missed the
# division is off by the order of a leaf's largest gradient
MICRO_LOSS_RTOL = 1e-5
MICRO_ATOL = 4 * TRAIN_LR
MICRO_NORM_RTOL = 1e-2
MICRO_GRAD_TOL = 2.0 ** -5
# the other archs trained at full width and depth: (arch, batch, seq);
# mamba2's sequence spans two SSD chunks of 256
TRAIN_FULL = (("mamba2-780m", 2, 512), ("granite-moe-1b-a400m", 4, 256))


def _finite_metrics(tag, m):
    """A step's loss and grad norm finite; the grad norm is the root of the
    sum of every gradient's squares, so it is finite only when every
    gradient is."""
    if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm")):
        fail(f"{tag}: loss {m['loss']!r}, grad norm {m['grad_norm']!r}")


def _host_metrics(m):
    return {k: float(v) for k, v in m.items()}


def _is_matmul(kernel_name: str) -> bool:
    """cuBLAS / CUTLASS matrix-multiply kernels, by their names."""
    return any(s in kernel_name.lower() for s in (
        "gemm", "nvjet", "cutlass", "xmma", "cublas"))


def phase_train(dev, card):
    """Phase 26: gemma2-2b trained at full width and depth on the card
    through ``launch.train.run`` at the driver's defaults (batch 8 x seq
    128, SyntheticTokens seed 0, lr 3e-4, warmup 20, ``remat="full"`` from
    its config, one microbatch) for TRAIN_STEPS steps: step ms (median of
    steps 2-5), tok/s, peak device memory against the state's fixed bytes,
    a profiler window over one step, the forward + backward and the AdamW
    update timed apart (the update against its bytes); the gates: loss and
    grad norm finite at every step, the float32 gradients of remat
    "nothing" (within REMAT_TOL) and of four microbatches (within
    MICRO_GRAD_TOL) against remat "full" in one, with the peak memory of
    each, one step in four microbatches against one (loss, grad norm,
    weights), and the loss falling over 5 steps on one repeated batch
    (warmup 0); then TRAIN_FULL's archs, two steps each at full width and
    depth."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    cfg = configs.get(TRAIN_ARCH)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, records = train.run(cfg, steps=TRAIN_STEPS, batch=B, seq=S,
                               lr=TRAIN_LR, seed=SEED, device=dev)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in state["params"].parameters())
    fixed = TRAIN_BYTES_PER_WEIGHT * n_params
    for r in records:
        _finite_metrics(f"{cfg.name} step {r['step']}", r)
        print(f"phase 26: {cfg.name} step {r['step']}: loss {r['loss']!r}, "
              f"grad norm {r['grad_norm']!r}, lr {r['lr']!r}, "
              f"{r['seconds'] * 1e3:.3f} ms")
    step_s = statistics.median(r["seconds"] for r in records[1:])
    print(f"phase 26: {cfg.name}, {cfg.n_layers} layers, d = {cfg.d_model}, "
          f"vocab {cfg.vocab_size}: {n_params} parameters, float32 master "
          f"weights, AdamW, bfloat16 compute, remat {cfg.remat!r}, batch "
          f"{B} x seq {S}: step {step_s * 1e3:.3f} ms (median of steps 2-"
          f"{TRAIN_STEPS}), {B * S / step_s:.1f} tok/s; peak device memory "
          f"{peak} B against the fixed {TRAIN_BYTES_PER_WEIGHT} B a weight = "
          f"{fixed} B ({peak / fixed:.4f}x); {card}")

    opt = adamw.AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=20,
                            total_steps=TRAIN_STEPS)
    data = SyntheticTokens(cfg.vocab_size, S, B, seed=SEED, device=dev)
    step_fn = ts.make_train_step(cfg, opt)
    nxt = data.batch_at(TRAIN_STEPS)
    got = profile_window(lambda: step_fn(state, nxt))
    if got is None:
        print("phase 26: the profiler recorded no device event in a train "
              "step")
    else:
        share, by_name, window_ms, events = got
        mm = sum(v for k, v in by_name.items() if _is_matmul(k))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"phase 26: profiler window of one train step {window_ms:.3f} "
              f"ms, {events} device events, device busy {share:.4f} (idle "
              f"{1 - share:.4f}); device ms {sum(by_name.values()):.3f}, of "
              f"which matmul kernels {mm:.3f}; kernel ms by name: "
              + "; ".join(f"{k[:50]} {v:.3f}" for k, v in top) + f"; {card}")

    # the step in two halves, each ending in a synchronize: the forward and
    # backward, then the optimizer against its bytes (p, g, m, v read once,
    # p, m, v written once)
    loss_fn = ts.make_loss_fn(cfg)
    named = dict(state["params"].named_parameters())
    halves = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts.backward(loss_fn, state["params"], nxt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adamw.apply(opt, named, {k: p.grad for k, p in named.items()},
                    state["opt"], state["step"])
        torch.cuda.synchronize()
        halves.append((t1 - t0, time.perf_counter() - t1))
    for p in named.values():
        p.grad = None
    bwd_s = statistics.median(h[0] for h in halves)
    opt_s = statistics.median(h[1] for h in halves)
    opt_bytes = 28 * n_params
    print(f"phase 26: {cfg.name} forward + backward {bwd_s * 1e3:.3f} ms, "
          f"AdamW {opt_s * 1e3:.3f} ms (medians of 3) against its "
          f"{opt_bytes} B over {HBM_BYTES_PER_S:.3g} B/s = "
          f"{opt_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; {card}")

    # the float32 gradients on batch 0 under remat "full" in one
    # microbatch, then each other way held to them leaf by leaf as it is
    # made: four microbatches, and remat "nothing"
    batch = data.batch_at(0)
    params = state["params"]
    peaks = {}
    ref = None
    for remat, micro, tol in (("full", 1, None), ("full", 4, MICRO_GRAD_TOL),
                              ("nothing", 1, REMAT_TOL)):
        loss_fn = ts.make_loss_fn(dataclasses.replace(cfg, remat=remat))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts.backward(loss_fn, params, batch, micro)
        torch.cuda.synchronize()
        peaks[remat, micro] = torch.cuda.max_memory_allocated()
        got = [p.grad for p in params.parameters()]
        for p in params.parameters():
            p.grad = None
        if ref is None:
            ref = got
            continue
        worst, bitwise = 0.0, True
        for (name, _), a, b in zip(params.named_parameters(), got, ref):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            bitwise &= bool(torch.equal(a, b))
            worst = max(worst, err / scale if scale else err)
            if not torch.isfinite(a).all() or err > tol * scale:
                fail(f"{cfg.name}: {name}'s gradient under remat {remat!r} "
                     f"in {micro} microbatch(es) differs from remat 'full' in "
                     f"one by {err!r} (its largest {scale!r}, tolerance "
                     f"{tol} of it)")
        del got
        print(f"phase 26: {cfg.name} float32 gradients on batch 0, remat "
              f"{remat!r} in {micro} microbatch(es) against remat 'full' in "
              f"one: largest difference {worst!r} of a leaf's largest "
              f"gradient (tolerance {tol}){', bitwise' if bitwise else ''}; "
              f"peak device memory of the backward {peaks[remat, micro]} B "
              f"(remat 'full' in one: {peaks['full', 1]} B); {card}")
    del state, params, ref, named
    torch.cuda.empty_cache()

    opt = adamw.AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=0,
                            total_steps=TRAIN_STEPS)
    state = ts.init_state(cfg, SEED, dev)
    state, m4 = ts.make_train_step(cfg, opt, microbatches=4)(state, batch)
    m4, p4 = _host_metrics(m4), state["params"]
    del state
    torch.cuda.empty_cache()
    state = ts.init_state(cfg, SEED, dev)
    step1 = ts.make_train_step(cfg, opt)
    state, m1 = step1(state, batch)
    m1 = _host_metrics(m1)
    _finite_metrics(f"{cfg.name} microbatches=4", m4)
    rel = abs(m4["loss"] - m1["loss"]) / abs(m1["loss"])
    gn_rel = abs(m4["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(
        state["params"].parameters(), p4.parameters()))
    print(f"phase 26: {cfg.name} one step, 4 microbatches of {B // 4} against "
          f"one of {B}: loss {m4['loss']!r} against {m1['loss']!r} (rel "
          f"{rel!r}, tolerance {MICRO_LOSS_RTOL}), grad norm "
          f"{m4['grad_norm']!r} against {m1['grad_norm']!r} (rel {gn_rel!r}, "
          f"tolerance {MICRO_NORM_RTOL}), weights apart by at most {diff!r} "
          f"(tolerance {MICRO_ATOL} = 4 lr)")
    if rel > MICRO_LOSS_RTOL or gn_rel > MICRO_NORM_RTOL or diff > MICRO_ATOL:
        fail(f"{cfg.name}: 4 microbatches against 1: loss rel {rel!r}, "
             f"grad norm rel {gn_rel!r}, weights {diff!r}")
    del p4
    losses = [m1["loss"]]
    for _ in range(TRAIN_STEPS - 1):
        state, m = step1(state, batch)
        m = _host_metrics(m)
        _finite_metrics(f"{cfg.name} repeated batch", m)
        losses.append(m["loss"])
    print(f"phase 26: {cfg.name} {TRAIN_STEPS} steps on batch 0 repeated "
          f"(warmup 0, lr {TRAIN_LR}): losses {losses!r}")
    if not losses[-1] < losses[0]:
        fail(f"{cfg.name}: the loss did not fall over {TRAIN_STEPS} steps on "
             f"one batch: {losses!r}")
    del state
    torch.cuda.empty_cache()
    phase_train_full(dev, card)


def phase_train_full(dev, card):
    """Phase 26, TRAIN_FULL: each arch seeded on the card at full width and
    depth and trained two steps (the first a warm-up) through
    ``launch.train.run``: loss and grad norm finite at both (every gradient
    finite), every weight finite after, the second step's ms and the peak
    device memory."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import train

    for arch, B, S in TRAIN_FULL:
        cfg = configs.get(arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        state, records = train.run(cfg, steps=2, batch=B, seq=S, lr=TRAIN_LR,
                                   warmup=0, seed=SEED, device=dev)
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in state["params"].parameters())
        for r in records:
            _finite_metrics(f"{cfg.name} step {r['step']}", r)
        if not all(bool(torch.isfinite(p).all())
                   for p in state["params"].parameters()):
            fail(f"{cfg.name}: a weight is not finite after two steps")
        first, last = records
        print(f"phase 26: {cfg.name}, {cfg.n_layers} layers, d = "
              f"{cfg.d_model}: {n_params} parameters, batch {B} x seq {S}, "
              f"remat {cfg.remat!r}: two steps, losses finite (last "
              f"{last['loss']!r}), grad norms finite (last "
              f"{last['grad_norm']!r}), weights finite; step "
              f"{last['seconds'] * 1e3:.3f} ms (the first "
              f"{first['seconds'] * 1e3:.3f} ms), "
              f"{B * S / last['seconds']:.1f} tok/s, peak device memory "
              f"{peak} B ({held} B held before the init) against the fixed "
              f"{TRAIN_BYTES_PER_WEIGHT * n_params} B; {card}")
        del state
        torch.cuda.empty_cache()


# phase 27: training sharded over a mesh.  gemma2-2b at full width, its
# depth cut to 4 layers (2 repeats of the local/global pattern), on a
# (2, 2) mesh over (data, model) of ranks sharing the card
SHARD_ARCH, SHARD_LAYERS = "gemma2-2b", 4
SHARD_MESH = ((2, 2), ("data", "model"))
ZERO3_MESH = ((2, 2, 2), ("pod", "data", "model"))
SHARD_MORE_STEPS = 2        # on the repeated batch, after the gated step
# against the single-device step in as many microbatches as data ranks
# (the same rows per matmul): the loss within rtol 1e-6, each gradient
# block within one bfloat16 rounding of its leaf's largest; against one
# microbatch, phase 26's gates (MICRO_*)
SHARD_LOSS_RTOL = 1e-6
SHARD_GRAD_TOL = 2.0 ** -8
# step 3 resumed on (1, 2) against the uninterrupted (2, 2) world's: one
# data rank runs the rows of two
RESUME_LOSS_RTOL = 1e-3
SHARD_DRIVER_TIMEOUT_S = 300.0


def _shard_cfg(reduced_cfg=False, profile=None):
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import reduced

    cfg = configs.get(SHARD_ARCH)
    cfg = (reduced(cfg) if reduced_cfg
           else dataclasses.replace(cfg, n_layers=SHARD_LAYERS))
    return dataclasses.replace(cfg, sharding_profile=profile or
                               cfg.sharding_profile)


def _shard_opt():
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=0,
                             total_steps=TRAIN_STEPS)


def _save_leaves(directory, leaves) -> None:
    """Each tensor of ``leaves`` ({name: tensor}) as ``<name>.npy``."""
    os.makedirs(directory, exist_ok=True)
    for n, t in leaves.items():
        np.save(os.path.join(directory, f"{n}.npy"), t.detach().cpu().numpy())


def shard_single(cfg, dev, micro, B, S, ref_dir, save_init=False):
    """Phase 27 (a) on one device from the seeded weights, on batch 0:
    for each count in ``micro`` the loss and float32 gradients, then one
    step in one microbatch.  Writes the gradients (``g<count>/``), the
    step's weights (``step/``) and with ``save_init`` the seeded weights
    (``init/``) under ``ref_dir``, one ``.npy`` a leaf, where the ranks
    read their blocks; returns the losses, each leaf's largest |gradient|
    and the step's metrics.  The card is freed."""
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.train import train_step as ts

    state = ts.init_state(cfg, SEED, dev)
    params = state["params"]
    named = dict(params.named_parameters())
    if save_init:
        _save_leaves(os.path.join(ref_dir, "init"), named)
    batch = SyntheticTokens(cfg.vocab_size, S, B, seed=SEED,
                            device=dev).batch_at(0)
    out = {"n": sum(p.numel() for p in named.values()), "loss": {},
           "scale": {}}
    loss_fn = ts.make_loss_fn(cfg)
    for mb in micro:
        loss, _ = ts.backward(loss_fn, params, batch, mb)
        grads = {n: p.grad for n, p in named.items()}
        _save_leaves(os.path.join(ref_dir, f"g{mb}"), grads)
        out["loss"][mb] = float(loss)
        out["scale"][mb] = {n: float(g.abs().max()) for n, g in grads.items()}
        del grads
        for p in params.parameters():
            p.grad = None
    state, m = ts.make_train_step(cfg, _shard_opt())(state, batch)
    out["metrics"] = _host_metrics(m)
    _save_leaves(os.path.join(ref_dir, "step"),
                 dict(state["params"].named_parameters()))
    del state, params, named
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _block_slices(shape, sizes, coord, spec):
    """The index of the block of an array of ``shape`` under ``spec`` at
    mesh coordinates ``coord`` (``sizes``: {dimension: size}, in the mesh's
    order)."""
    index = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        q, i = 1, 0
        for a in sizes:
            if a in names:
                q, i = q * sizes[a], i * sizes[a] + int(coord[a])
        index.append(slice(i * (n // q), (i + 1) * (n // q)))
    return tuple(index)


def _rank_compare(blocks, ref_dir, layout, mesh):
    """In a rank: each block of ``blocks`` ({name: tensor}) against the
    block at this rank's mesh position of the leaf ``<name>.npy`` under
    ``ref_dir`` (memory-mapped: only that block is read).  Returns
    ({name: max |difference|}, every block bitwise?)."""
    import torch
    from repro_torch.launch.mesh import mesh_shape

    sizes = mesh_shape(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    errs, bitwise = {}, True
    for n, t in blocks.items():
        arr = np.load(os.path.join(ref_dir, f"{n}.npy"), mmap_mode="r")
        want = torch.from_numpy(np.array(
            arr[_block_slices(arr.shape, sizes, coord, layout[n])])).to(
                t.device)
        if want.shape != t.shape:
            raise AssertionError(f"{n}: block {tuple(t.shape)}, the "
                                 f"layout's {tuple(want.shape)}")
        errs[n] = float((t - want).abs().max()) if t.numel() else 0.0
        bitwise &= bool(torch.equal(t, want))
    return errs, bitwise


def rank_shard(mesh, cfg, B, S, ref_dir, micro, more_steps=0,
               ckpt_dir=None, check_init=False):
    """Phase 27 in a rank: from the seeded weights (with ``check_init``
    its blocks held to (a)'s), the sharded backward on batch 0 (its
    gradient blocks held to (a)'s in ``micro`` microbatches and in one)
    and the step (its weights held to (a)'s 1-microbatch step's);
    ``more_steps`` more on the repeated batch, timed (host clock to a
    synchronize) with the bytes staged a step; the peak device memory;
    with ``ckpt_dir`` a sharded save after them and one more step (the
    uninterrupted step to resume against)."""
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.runtime import elastic
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as ts

    dev = _rank_device()
    torch.cuda.reset_peak_memory_stats(dev)
    layout = ts.param_layout(cfg, mesh)
    state = ts.init_state(cfg, SEED, dev, mesh=mesh)
    out = {"rank": torch.distributed.get_rank(),
           "state_bytes": sum(t.numel() * t.element_size() for t in
                              checkpointer._flatten(state).values())}
    if check_init:
        out["init"] = _rank_compare(state["params"],
                                    os.path.join(ref_dir, "init"), layout,
                                    mesh)
    bspec = partition.batch_pspec(mesh, B)
    rows = SyntheticTokens(cfg.vocab_size, S, B, seed=SEED, device=dev,
                           mesh=mesh, batch_spec=bspec).batch_at(0)
    grads, _ = ts.sharded_backward(ts.make_loss_fn(cfg), cfg,
                                   state["params"], rows, mesh,
                                   batch_spec=bspec)
    for mb in (micro, 1):
        out[f"g{mb}"] = _rank_compare(grads, os.path.join(ref_dir, f"g{mb}"),
                                      layout, mesh)
    del grads
    step = ts.make_train_step(cfg, _shard_opt(), mesh=mesh, batch_spec=bspec)
    state, m = step(state, rows)
    out["metrics"] = [_host_metrics(m)]
    out["step"] = _rank_compare(state["params"],
                                os.path.join(ref_dir, "step"), layout, mesh)
    secs, staged = [], []
    for _ in range(more_steps):
        D.reset_staged_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, rows)
        m = _host_metrics(m)
        secs.append(time.perf_counter() - t0)
        staged.append(D.staged_bytes())
        out["metrics"].append(m)
    out["step_s"], out["staged"] = secs, staged
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    if ckpt_dir:
        t0 = time.perf_counter()
        checkpointer.save(ckpt_dir, more_steps, state,
                          elastic.state_shardings(cfg, mesh), mesh)
        out["save_s"] = time.perf_counter() - t0
        state, m = step(state, rows)
        out["next"] = _host_metrics(m)
    return out


def rank_resume(mesh, cfg, B, S, ckpt_dir):
    """Phase 27 (d) in a rank: the latest checkpoint restored onto this
    mesh; every restored block against its slice of the saved leaf read
    with numpy (bitwise), then one step on batch 0."""
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.runtime import elastic
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as ts

    dev = _rank_device()
    t0 = time.perf_counter()
    state, at, _ = elastic.resume(cfg, ckpt_dir, mesh=mesh, device=dev)
    load_s = time.perf_counter() - t0
    path = os.path.join(ckpt_dir, f"step_{at:08d}")
    manifest = checkpointer.read_manifest(path)
    specs = checkpointer._flatten(elastic.state_shardings(cfg, mesh))
    sizes = mesh_shape(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    bad = []
    for key, t in checkpointer._flatten(state).items():
        arr = np.load(os.path.join(path, manifest["leaves"][key]["file"]),
                      mmap_mode="r")
        want = np.array(
            arr[_block_slices(arr.shape, sizes, coord, specs.get(key, ()))])
        if not torch.equal(t.cpu(), torch.from_numpy(want)):
            bad.append(key)
    bspec = partition.batch_pspec(mesh, B)
    rows = SyntheticTokens(cfg.vocab_size, S, B, seed=SEED, device=dev,
                           mesh=mesh, batch_spec=bspec).batch_at(0)
    state, m = ts.make_train_step(cfg, _shard_opt(), mesh=mesh,
                                  batch_spec=bspec)(state, rows)
    return {"rank": torch.distributed.get_rank(), "restored": at,
            "bad": bad, "leaves": len(manifest["leaves"]), "load_s": load_s,
            "next": _host_metrics(m)}


def _worst(tag, outs, key, tol, scales=None):
    """The ranks' ``key`` comparisons (``_rank_compare``) within ``tol``
    (of each leaf's largest |value| with ``scales``): (worst error as a
    share of the leaf's largest, or absolute; every block bitwise?)."""
    worst, bitwise = 0.0, True
    for o in outs:
        errs, bits = o[key]
        bitwise &= bits
        for n, err in errs.items():
            scale = scales[n] if scales else 1.0
            if not np.isfinite(err) or err > tol * scale:
                fail(f"{tag}: rank {o['rank']}'s {n} off by {err!r} (limit "
                     f"{tol * scale!r})")
            worst = max(worst, err / scale if scale else err)
    return worst, bitwise


def _hold_step(tag, outs, single, micro, card):
    """(b)'s gates for a world's first sharded step (``outs``: the ranks'
    ``rank_shard`` results) against the single-device step (``single``:
    ``shard_single`` in 1 and ``micro`` microbatches)."""
    m = outs[0]["metrics"][0]
    if any(o["metrics"][0] != m for o in outs):
        fail(f"{tag}: the ranks' metrics differ: "
             f"{[o['metrics'][0] for o in outs]}")
    _finite_metrics(tag, m)
    many, one = single["loss"][micro], single["loss"][1]
    rel_many = abs(m["loss"] - many) / abs(many)
    rel_one = abs(m["loss"] - one) / abs(one)
    gn = single["metrics"]["grad_norm"]
    gn_rel = abs(m["grad_norm"] - gn) / gn
    g_many, bit_many = _worst(f"{tag} gradients vs {micro} microbatches",
                              outs, f"g{micro}", SHARD_GRAD_TOL,
                              single["scale"][micro])
    g_one, _ = _worst(f"{tag} gradients vs 1 microbatch", outs, "g1",
                      MICRO_GRAD_TOL, single["scale"][1])
    w_err, _ = _worst(f"{tag} weights vs 1 microbatch", outs, "step",
                      MICRO_ATOL)
    print(f"phase 27: {tag}: loss {m['loss']!r} against {micro} "
          f"microbatches' {many!r} (rel {rel_many!r}, tolerance "
          f"{SHARD_LOSS_RTOL}) and one's {one!r} (rel {rel_one!r}, "
          f"tolerance {MICRO_LOSS_RTOL}); grad norm {m['grad_norm']!r} "
          f"against one's {gn!r} (rel {gn_rel!r}, tolerance "
          f"{MICRO_NORM_RTOL}); float32 gradient blocks within {g_many!r} of "
          f"a leaf's largest of {micro} microbatches' (tolerance "
          f"{SHARD_GRAD_TOL}{', bitwise' if bit_many else ''}) and "
          f"{g_one!r} of one's (tolerance {MICRO_GRAD_TOL}); weights within "
          f"{w_err!r} of one microbatch's step (tolerance {MICRO_ATOL} = 4 "
          f"lr); {card}")
    if (rel_many > SHARD_LOSS_RTOL or rel_one > MICRO_LOSS_RTOL
            or gn_rel > MICRO_NORM_RTOL):
        fail(f"{tag}: loss rel {rel_many!r} / {rel_one!r}, grad norm rel "
             f"{gn_rel!r}")


def _layout_bytes(layout, shapes, mesh, per_weight=12) -> int:
    """A rank's bytes of the state under ``layout`` on ``mesh`` ((shape,
    axes)): ``per_weight`` bytes (float32 master, m and v) a weight of its
    blocks, and the 4-byte step counter."""
    sizes = dict(zip(mesh[1], mesh[0]))
    total = 4
    for k, spec in layout.items():
        q = math.prod(sizes[a] for e in spec if e for a in
                      ((e,) if isinstance(e, str) else e))
        total += per_weight * math.prod(shapes[k]) // q
    return total


def phase_sharded_train(dev, card):
    """Phase 27 (module docstring): (a) one device, (b) the (2, 2) world,
    (c) zero3 on (2, 2, 2), (d) the elastic resume, (e) the driver, (f)
    one NCCL rank."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import transformer
    from repro_torch.runtime import elastic
    from repro_torch.testing.world import World
    from repro_torch.train import train_step as ts

    B, S = TRAIN_BATCH, TRAIN_SEQ
    cfg = _shard_cfg()
    mesh = MeshSpec(*SHARD_MESH)
    p = math.prod(mesh.shape)
    q_data = dict(zip(mesh.axes, mesh.shape))["data"]
    layout = ts.param_layout(cfg, mesh)
    with torch.device("meta"):
        shapes = {k: tuple(t.shape) for k, t in
                  transformer.Transformer(cfg).named_parameters()}
    n = sum(math.prod(s) for s in shapes.values())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    ref, ckpt = os.path.join(tmp, "ref"), os.path.join(tmp, "ckpt")
    try:
        # (a) one device; the card freed before the world starts
        t0 = time.perf_counter()
        single = shard_single(cfg, dev, (1, q_data), B, S, ref)
        print(f"phase 27: (a) {cfg.name} at full width, {cfg.n_layers} of "
              f"its {configs.get(SHARD_ARCH).n_layers} layers (d = "
              f"{cfg.d_model}, vocab {cfg.vocab_size}): {n} parameters, "
              f"{cfg.sharding_profile}, batch {B} x seq {S}, remat "
              f"{cfg.remat!r}: one device, loss in 1 / {q_data} microbatches"
              f" {single['loss'][1]!r} / {single['loss'][q_data]!r}, the "
              f"1-microbatch step's grad norm "
              f"{single['metrics']['grad_norm']!r}; gradients and weights "
              f"written for the ranks; {time.perf_counter() - t0:.1f} s; "
              f"device memory held after: {torch.cuda.memory_allocated()} B")

        # (b) the (2, 2) world: the gated step, 2 more, a save, step 3
        t0 = time.perf_counter()
        w = World(p, device="cuda", timeout=WORLD_DEADLINE)
        with w:
            t_up = time.perf_counter() - t0
            outs = w.run(rank_shard, mesh, cfg, B, S, ref, q_data,
                         SHARD_MORE_STEPS, ckpt)
        _closed(w, 27)
        print(f"phase 27: (b) {p} ranks on mesh {mesh.shape} over "
              f"{mesh.axes} (gloo, staged through the host): world up in "
              f"{t_up:.1f} s, {time.perf_counter() - t0:.1f} s in all")
        _hold_step("(b) (2, 2)", outs, single, q_data, card)
        losses = [m["loss"] for m in outs[0]["metrics"]]
        for m in outs[0]["metrics"]:
            _finite_metrics("(b) repeated batch", m)
        print(f"phase 27: (b) {len(losses)} steps on batch 0 repeated "
              f"(warmup 0, lr {TRAIN_LR}): losses {losses!r}")
        if not all(b < a for a, b in zip(losses, losses[1:])):
            fail(f"(b): the loss did not fall on a repeated batch: "
                 f"{losses!r}")
        want = _layout_bytes(layout, shapes, SHARD_MESH)
        terms = want + 2 * n + 4 * max(math.prod(s) for s in shapes.values())
        for o in outs:
            if o["state_bytes"] != want:
                fail(f"(b): rank {o['rank']} holds {o['state_bytes']} B of "
                     f"state, the layout {want} B")
            print(f"phase 27: (b) rank {o['rank']}: state "
                  f"{o['state_bytes']} B = {o['state_bytes'] / (12 * n):.4f}"
                  f" of 12 B a weight (the layout's); step "
                  f"{statistics.median(o['step_s']) * 1e3:.3f} ms (median of "
                  f"{[round(s * 1e3, 3) for s in o['step_s']]}), staged "
                  f"{statistics.median(o['staged'])} B a step; peak device "
                  f"memory {o['peak']} B against state + gathered bfloat16 "
                  f"+ the largest float32 leaf = {terms} B "
                  f"({o['peak'] / terms:.4f}x); sharded save "
                  f"{o['save_s']:.1f} s; {card}")
        loss4 = outs[0]["next"]["loss"]
        _finite_metrics(f"(b) step {SHARD_MORE_STEPS + 1}", outs[0]["next"])

        # (f) one NCCL rank on (1, 1): (a)'s step bitwise
        nmesh = MeshSpec((1, 1), ("data", "model"))
        t0 = time.perf_counter()
        w = World(1, device="cuda", backend="nccl", timeout=WORLD_DEADLINE)
        with w:
            o = w.run(rank_shard, nmesh, cfg, B, S, ref, 1)[0]
        _closed(w, 27)
        same = o["metrics"][0] == single["metrics"]
        print(f"phase 27: (f) one NCCL rank on (1, 1): every gradient "
              f"bitwise (a)'s: {o['g1'][1]}, every weight after the step "
              f"bitwise: {o['step'][1]}; loss {o['metrics'][0]['loss']!r} "
              f"against {single['metrics']['loss']!r}, grad norm "
              f"{o['metrics'][0]['grad_norm']!r} against "
              f"{single['metrics']['grad_norm']!r}; "
              f"{time.perf_counter() - t0:.1f} s; {card}")
        if not (o["g1"][1] and o["step"][1] and same):
            fail(f"(f): not bitwise the single-device step: gradients "
                 f"{o['g1'][1]}, weights {o['step'][1]}, metrics "
                 f"{o['metrics'][0]} against {single['metrics']}")
        shutil.rmtree(ref, ignore_errors=True)

        # (c) zero3 on (2, 2, 2), reduced gemma2-2b
        zcfg = _shard_cfg(reduced_cfg=True, profile="zero3")
        zmesh = MeshSpec(*ZERO3_MESH)
        zq = math.prod(zmesh.shape[:2])
        zsingle = shard_single(zcfg, dev, (1, zq), B, S, ref, save_init=True)
        t0 = time.perf_counter()
        w = World(math.prod(zmesh.shape), device="cuda",
                  timeout=WORLD_DEADLINE)
        with w:
            zouts = w.run(rank_shard, zmesh, zcfg, B, S, ref, zq,
                          check_init=True)
        _closed(w, 27)
        _worst("(c) initial blocks", zouts, "init", 0.0)
        print(f"phase 27: (c) {zcfg.name} zero3 on {zmesh.shape} over "
              f"{zmesh.axes}, world of {math.prod(zmesh.shape)}: every "
              f"initial block bitwise the single-device weights' at its "
              f"mesh position; {time.perf_counter() - t0:.1f} s")
        _hold_step("(c) zero3 (2, 2, 2)", zouts, zsingle, zq, card)
        shutil.rmtree(ref, ignore_errors=True)

        # (d) resume the (b) checkpoint on choose_mesh(2, target_model=2)
        rmesh = elastic.choose_mesh(2, target_model=2)
        t0 = time.perf_counter()
        w = World(math.prod(rmesh.shape), device="cuda",
                  timeout=WORLD_DEADLINE)
        with w:
            routs = w.run(rank_resume, rmesh, cfg, B, S, ckpt)
        _closed(w, 27)
        for o in routs:
            _finite_metrics(f"(d) resumed step {SHARD_MORE_STEPS + 1}",
                            o["next"])
            if o["restored"] != SHARD_MORE_STEPS or o["bad"]:
                fail(f"(d): rank {o['rank']} restored step {o['restored']}, "
                     f"blocks not bitwise: {o['bad']}")
        rel = abs(routs[0]["next"]["loss"] - loss4) / abs(loss4)
        print(f"phase 27: (d) step {SHARD_MORE_STEPS} resumed on "
              f"choose_mesh(2, target_model=2) = {rmesh.shape} over "
              f"{rmesh.axes}: {routs[0]['leaves']} leaves, every block "
              f"bitwise its slice of the saved leaf (restore "
              f"{max(o['load_s'] for o in routs):.1f} s); step "
              f"{SHARD_MORE_STEPS + 1} loss "
              f"{routs[0]['next']['loss']!r} against the uninterrupted "
              f"world's {loss4!r} (rel {rel!r}, tolerance "
              f"{RESUME_LOSS_RTOL}); {time.perf_counter() - t0:.1f} s")
        if rel > RESUME_LOSS_RTOL:
            fail(f"(d): resumed step {SHARD_MORE_STEPS + 1} loss rel {rel!r}")
        shutil.rmtree(ckpt, ignore_errors=True)

        # (e) the driver in a fresh --ckpt-dir, then a restart
        fresh = os.path.join(tmp, "driver")
        src = os.path.join(HERE, "src")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            x for x in (src, os.environ.get("PYTHONPATH")) if x))
        for steps, line in ((6, "mesh={'data': 2, 'model': 2}"),
                            (8, "restored step 5")):
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   "--arch", "llama3.2-3b", "--smoke", "--mesh", "2x2",
                   "--steps", str(steps), "--ckpt-dir", fresh]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                               env=env, timeout=SHARD_DRIVER_TIMEOUT_S)
            if r.returncode != 0 or line not in r.stdout:
                fail(f"(e) {' '.join(cmd[2:])}: exit {r.returncode}, "
                     f"{line!r} missing\n{r.stdout[-3000:]}\n"
                     f"{r.stderr[-3000:]}")
            print(f"phase 27: (e) {' '.join(cmd[2:-1])} DIR: exit 0 in "
                  f"{time.perf_counter() - t0:.1f} s")
            for line in r.stdout.strip().splitlines():
                print(f"phase 27:   {line}")

    finally:
        shutil.rmtree(tmp, ignore_errors=True)

# phase 28: the dry run at the single pod's per-rank shapes
DRYRUN_CELLS = (("granite-moe-1b-a400m", "train_4k"),
                ("gemma2-2b", "prefill_32k"), ("gemma2-2b", "decode_32k"))
DRYRUN_PROBED = ("gemma2-2b", "decode_32k")
DRYRUN_PALD_N = 102400           # the reference's dryrun_pald default
DRYRUN_PALD = ("allgather", "ring", "2d")
DRYRUN_STRIP_ROWS = 16           # rows of U and C held to the plain versions
PEAK_RATIO_MAX = 2.0             # measured peak against the meta estimate


def _ratio_ok(tag, peak, estimate):
    ratio = peak / estimate
    print(f"phase 28: {tag}: peak {peak} B, meta estimate {estimate} B, "
          f"ratio {ratio:.4f}")
    if not 1.0 / PEAK_RATIO_MAX <= ratio <= PEAK_RATIO_MAX:
        fail(f"{tag}: measured peak {peak} B is not within "
             f"{PEAK_RATIO_MAX}x of the meta estimate {estimate} B")


def phase_dryrun(dev, card, clock_mhz):
    """Phase 28 (module docstring); returns the dense cells' launches of
    the rectangular focus and cohesion entries."""
    import torch
    from repro_torch.kernels import ops, pald_cohesion, pald_focus
    from repro_torch.launch import dryrun, dryrun_pald, selftest
    from repro_torch.tuning import hillclimb

    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    launches = {"focus": 0, "cohesion": 0}
    try:
        for arch, shape in DRYRUN_CELLS:
            t0 = time.perf_counter()
            cell = dryrun.run_cell(arch, shape, False, device=dev, reps=1,
                                   probe=(arch, shape) == DRYRUN_PROBED,
                                   verbose=False)
            tag = dryrun.cell_tag(arch, shape, False)
            with open(os.path.join(out, tag + ".json"), "w") as f:
                json.dump(cell, f, indent=1)
            if cell["status"] != "ok":
                fail(f"{tag}: status {cell['status']!r}")
            m, ma = cell["measured"], cell["memory_analysis"]
            if not (m.get("fits") and m.get("depth") == "full"):
                fail(f"{tag}: expected to fit the card at full depth: {m}")
            print(f"phase 28: {tag}: {cell['rows_per_rank']} rows a rank, "
                  f"{cell['microbatches']} microbatch(es); counted "
                  f"{cell['flops_per_rank']:.4g} flops, "
                  f"{cell['bytes_per_rank']:.4g} B accessed, arguments "
                  f"{ma['argument_size_in_bytes']} B + temporaries "
                  f"{ma['temp_size_in_bytes']} B in {cell['count_s']} s; "
                  f"roofline {cell['roofline']['bottleneck']} "
                  f"{cell['roofline']['bound_s'] * 1e3:.3f} ms; step "
                  f"{m['step_ms']:.3f} ms (median of {len(m['step_ms_reps'])},"
                  f" {m['step_ms_reps']}) ({card}; "
                  f"{time.perf_counter() - t0:.1f} s)")
            _ratio_ok(tag, m["peak_bytes"], m["peak_estimate_bytes"])
            if (arch, shape) == DRYRUN_PROBED:
                pr = m["probes"]
                for r, peak, est in zip((1, 2), pr["probe_peak_bytes"],
                                        pr["probe_peak_estimate_bytes"]):
                    _ratio_ok(f"{tag} at {r} repeat(s)", peak, est)
                print(f"phase 28: {tag}: probes {pr['probe_step_ms']} ms at "
                      f"1 and 2 repeats, {pr['per_repeat_ms']:.3f} ms a "
                      f"repeat, extrapolated to {pr['repeats']}: "
                      f"{pr['step_ms']:.3f} ms against {m['step_ms']:.3f} "
                      f"ms measured at full depth: error "
                      f"{100 * m['probe_error']:+.2f} %")

        @contextlib.contextmanager
        def no_plain():
            """The plain versions fail if called: around the timed kernel
            calls only, so the strip checks after them may run them."""
            def plain_called(*a, **k):
                fail("a plain torch version ran in the dense dry-run cells")

            patched = [(ops, "focus_general_torch"),
                       (ops, "cohesion_general_torch"),
                       (pald_focus, "focus_general_torch"),
                       (pald_cohesion, "cohesion_general_torch")]
            saved = [getattr(mod, a) for mod, a in patched]
            for mod, a in patched:
                setattr(mod, a, plain_called)
            try:
                yield
            finally:
                for (mod, a), fn in zip(patched, saved):
                    setattr(mod, a, fn)

        for strategy in DRYRUN_PALD:
            t0 = time.perf_counter()
            cell = dryrun_pald.run_cell(DRYRUN_PALD_N, False, strategy,
                                        device=dev, reps=1,
                                        check_rows=DRYRUN_STRIP_ROWS,
                                        guard=no_plain, verbose=False)
            if cell["status"] != "ok":
                fail(f"pald {strategy}: status {cell['status']!r}")
            m, terms = cell["measured"], cell["roofline"]
            if min(m["launches"].values()) < 1:
                fail(f"pald {strategy}: a kernel was not launched "
                     f"({m['launches']})")
            for k in launches:
                launches[k] += m["launches"][k]
            st = m["strip"]
            (fx, fy, fz), (cx, cy, cz) = (cell["kernel_calls"]["focus"],
                                          cell["kernel_calls"]["cohesion"])
            print(f"phase 28: pald {strategy}: the first {st['rows']} rows "
                  f"against the plain versions on the same operands: U "
                  f"({st['rows']} of {fx}) x {fy} x {fz} max |err| "
                  f"{st['focus_max_abs_err']!r} (bitwise: "
                  f"{st['focus_bitwise']}), C ({st['rows']} of {cx}) x {cy} "
                  f"x {cz} max |err| {st['cohesion_max_abs_err']!r} (rtol "
                  f"{st['rtol']}, atol {st['atol']}: {st['cohesion_within']})")
            if not (st["focus_bitwise"] and st["cohesion_within"]):
                fail(f"pald {strategy}: the kernels disagree with the plain "
                     f"versions on the strip: {st}")
            fb, fby = rect_bound_ms("focus", fx, fy, fz, clock_mhz)
            cb, cby = rect_bound_ms("cohesion", cx, cy, cz, clock_mhz)
            print(f"phase 28: pald {strategy}: a trip's kernels against "
                  f"their own bounds: focus {m['focus_ms']:.3f} / "
                  f"{fb:.3f} ms ({fby}), cohesion {m['cohesion_ms']:.3f}"
                  f" / {cb:.3f} ms ({cby})")
            print(f"phase 28: pald n={DRYRUN_PALD_N} {strategy} on "
                  f"16x16: a rank's block {cell['block']}, kernels "
                  f"{m['kernel_ms']:.2f} ms = {m['trips']} trip(s) x "
                  f"(focus {m['focus_ms']:.3f} + cohesion "
                  f"{m['cohesion_ms']:.3f}) ms, counted bound "
                  f"{terms['bound_s'] * 1e3:.2f} ms ({terms['bottleneck']}"
                  f"; compute {terms['compute_s'] * 1e3:.2f} ms at "
                  f"{dryrun_pald.PEAK_OPS:.3g} op/s, collectives "
                  f"{terms['collective_s'] * 1e3:.2f} ms), launches "
                  f"{m['launches']} ({card}; "
                  f"{time.perf_counter() - t0:.1f} s)")
            _ratio_ok(f"pald {strategy}", m["peak_bytes"],
                      m["peak_estimate_bytes"])

        t0 = time.perf_counter()
        base = dryrun.cell_tag(*DRYRUN_PROBED, False)
        hillclimb.main(["cell", "--arch", DRYRUN_PROBED[0], "--shape",
                        DRYRUN_PROBED[1], "--mesh", "single", "--device",
                        "meta", "--baseline-dir", out, "--set", "remat=dots",
                        "--save", "dots"])
        with open(os.path.join(out, base + "__dots.json")) as f:
            climbed = json.load(f)
        if climbed["status"] != "ok" or climbed["overrides"] != {
                "remat": "dots"}:
            fail(f"hillclimb cell: {climbed.get('status')!r}")
        print(f"phase 28: hillclimb cell --set remat=dots against {base}: "
              f"ok ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        selftest._counted_cell(str(dev))
        print(f"phase 28: self-test: counted production cell (full "
              f"internvl2-1b) ok ({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(out, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 29: user-registered weight functionals compiled into the kernels
# ---------------------------------------------------------------------------
N_USER_WHOLE = 1024    # the smooth functional held whole
USER_SLAB = 16         # rows of the smooth functional's U and C at n = 8192
RAGGED_USER = 8000     # the ignore clone at a ragged n
# the plain versions that no phase-29 path may run, by kernels module
PLAIN_VERSIONS = {
    "pald_focus": ("focus_general_torch",),
    "pald_cohesion": ("cohesion_general_torch",),
    "pald_focus_tri": ("focus_tri_torch",),
    "pald_cohesion_tri": ("cohesion_tri_torch",),
    "pald_fused": ("focus_fused_torch", "cohesion_fused_torch"),
    "pald_knn": ("knn_values_torch", "knn_values_from_features_torch",
                 "knn_values_from_distances_torch",
                 "knn_values_from_neighbors_torch"),
    "pald_topk": ("topk_select_torch",)}


_USERS = {}


def user_functionals():
    """Phase 29's functionals, one instance each for the run: clones of
    drop (``harsh``, the reference's own test functional), ignore and
    soft (their callables under a new name, no kernel id), and a smooth
    functional with ``exp``, a ``share`` and exact zeros on +inf."""
    if _USERS:
        return _USERS
    import torch
    from repro_torch.core import weights as tw

    def clone(base, name):
        w = tw.resolve_weight(base)
        return tw.WeightFunctional(
            name, w.focus, w.support, share=w.share,
            needs_index_tiebreak=w.needs_index_tiebreak,
            conserves_mass=w.conserves_mass, is_strict=w.is_strict)

    def focus(dxz, dyz, dxy):
        d = dxy - torch.minimum(dxz, dyz)
        f = 1.0 - torch.exp(-torch.maximum(d, torch.zeros_like(d)) * 3.0)
        return torch.where(torch.isnan(d), 0.0, f)

    def share(own, other):
        return torch.clamp(0.5 + (other - own) * 2.0, 0.0, 1.0)

    def support(own, other, pair, own_wins=None):
        res = share(own, other) * focus(own, other, pair)
        return torch.where(torch.isnan(res), 0.0, res)

    _USERS.update(drop=clone("drop", "harsh"),
                  ignore=clone("ignore", "ignore-clone"),
                  soft=clone("soft", "soft-clone"),
                  smooth=tw.WeightFunctional("smooth-exp", focus, support,
                                             share=share))
    return _USERS


class UserBuild:
    """Phase 29's kernel libraries, built by nvcc in a thread from phase 1
    on, beside the phases that run on the card: harsh's six sources first
    (one functional's nvcc seconds), then the other three functionals'
    eighteen at once.  The functionals are traced here, in the calling
    thread."""

    def __init__(self):
        import threading
        from repro_torch.core import weights as tw

        self.functors = {k: tw.kernel_spec(w).functor
                         for k, w in user_functionals().items()}
        self.result, self.error = {}, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        from repro_torch.kernels import _build

        try:
            t0 = time.perf_counter()
            one = _build.build_user(self.functors["drop"])
            t1 = time.perf_counter()
            rest = _build.build_user(*(f for k, f in self.functors.items()
                                       if k != "drop"))
            self.result = dict(one=one, one_s=t1 - t0, rest=rest,
                               rest_s=time.perf_counter() - t1)
        except BaseException as e:  # noqa: BLE001 - raised again in join
            self.error = e

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result


@contextlib.contextmanager
def no_plain_versions(tag):
    """Every plain version in PLAIN_VERSIONS (and its name in ``ops``)
    fails if called."""
    import importlib

    from repro_torch.kernels import ops

    def plain_called(*a, **k):
        fail(f"{tag}: a plain torch version ran")

    patched = []
    for mod_name, names in PLAIN_VERSIONS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        for name in names:
            for m in (mod, ops):
                if hasattr(m, name):
                    patched.append((m, name, getattr(m, name)))
    for m, name, _ in patched:
        setattr(m, name, plain_called)
    try:
        yield
    finally:
        for m, name, f in patched:
            setattr(m, name, f)


def user_path(tag, run, wrappers, once=False):
    """Drive ``run`` with the wrappers' counts set to 0 and every plain
    version failing; fails unless each wrapper launched (exactly once
    with ``once``).  Returns (the result, {wrapper: launches})."""
    import torch

    for w in wrappers:
        w.launches = 0
    with no_plain_versions(f"phase 29 {tag}"):
        out = run()
        torch.cuda.synchronize()
    launched = {w.__name__: w.launches for w in wrappers}
    if min(launched.values()) < 1 or (once and set(launched.values())
                                      != {1}):
        fail(f"phase 29: {tag}: launches {launched}")
    return out, launched


def user_slab(tag, C, D, w, rows, rtol, atol, U=None):
    """Rows r0:r0+rows of U (when given) and of C (normalized) against the
    plain versions through the rectangular forms with global offsets;
    returns (U's max |err|, C's max |err|)."""
    import torch
    from repro_torch.kernels import ops

    n = D.shape[0]
    r0 = min(3001, n - rows)
    sl = D[r0:r0 + rows]
    Up = ops.focus_general(sl, D, sl, impl="torch", ties=w)
    err_u = None
    if U is not None:
        err_u = compare(f"phase 29 {tag} U rows {r0}:{r0 + rows}",
                        U[r0:r0 + rows], Up, False, rtol=rtol, atol=atol)
    zero = Up == 0
    Wp = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, Up))
    diag = torch.arange(rows, device=D.device)
    Wp[diag, r0 + diag] = 0.0
    offs = (r0, 0) if w.needs_index_tiebreak else None
    Cp = ops.cohesion_general(sl, D, sl, Wp, impl="torch", ties=w,
                              xw_offsets=offs) / (n - 1)
    err_c = compare(f"phase 29 {tag} C rows {r0}:{r0 + rows}",
                    C[r0:r0 + rows], Cp, False, rtol=rtol, atol=atol)
    print(f"phase 29: {tag}: rows {r0}:{r0 + rows} against the plain "
          f"versions: U max |err| {err_u!r}, C max |err| {err_c!r} (rtol "
          f"{rtol}, atol {atol})")
    return err_u, err_c


def in_turns(tag, user_fn, builtin_fn, reps=2):
    """The user functional's kernel and the built-in's, timed in turns
    (user, built-in, built-in, user; CUDA events, median of ``reps`` after
    a warm-up); bitwise the same output.  Returns (user ms, built-in ms),
    the faster of each pair."""
    t = {"user": [], "builtin": []}
    outs = {}
    for which in ("user", "builtin", "builtin", "user"):
        ms, out = time_ms(user_fn if which == "user" else builtin_fn, reps)
        t[which].append(ms)
        outs[which] = out
    compare(f"phase 29 {tag} timed", outs["user"], outs["builtin"], True)
    del outs
    print(f"phase 29: {tag}: user functor {t['user']} ms, built-in "
          f"{t['builtin']} ms (in turns), user/built-in "
          f"{min(t['user']) / min(t['builtin']):.3f}")
    return min(t["user"]), min(t["builtin"])


def phase_user_functionals(dev, card, clock_mhz, build, kernels):
    """Phase 29 (module docstring); returns the user functors' rows of the
    kernels' JSON."""
    import torch
    from repro_torch.core import knn as tknn
    from repro_torch.core import pald, resilience
    from repro_torch.core import weights as tw
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import (_build, ops, pald_fused, pald_knn,
                                     pald_topk)
    from repro_torch.kernels.ref import weights_ref

    res = build.join()
    users = user_functionals()
    fun = build.functors
    for part, built, wall in (
            ("harsh's six sources", res["one"], res["one_s"]),
            ("the other three functionals' sources at once", res["rest"],
             res["rest_s"])):
        print(f"phase 29: {part}: {len(built)} built in {wall:.1f} s wall "
              "(beside phases 2-28 on the card)")
    for k, f in fun.items():
        print(f"phase 29: {users[k].name}: functor {f.struct}, libraries "
              f"{_build.user_status(f.key)}")
    plain = {r["name"]: r["plain_ms"] for r in kernels}
    rows = []

    def row(name, base, source, replaces, launches, err, ms, builtin_ms,
            plain_ms, plain_from, bound):
        b_ms, b_by = bound
        rows.append({"name": f"{name}[{users[base].name}]", "route": "cuda",
                     "source": source, "replaces": replaces,
                     "functor": "src/repro_torch/kernels/_functor.py",
                     "key": fun[base].key, "launches": launches,
                     "max_abs_err": err, "ms": ms, "builtin_ms": builtin_ms,
                     "plain_ms": plain_ms, "plain_from": plain_from,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        print(f"phase 29: {rows[-1]['name']}: {ms!r} ms (built-in "
              f"{builtin_ms!r}), plain {plain_ms!r} ms ({plain_from}), "
              f"bound {b_ms!r} ms ({b_by}), launches {launches}; {card}")

    # dense and tri at n = 8192 on phase 3's D
    X, _ = clustered_points(N_MAIN, D_MAIN, SEED)
    D = distances_on_device(torch.as_tensor(X, device=dev))
    n = D.shape[0]
    dense_launches = {}
    for base in ("drop", "ignore", "soft"):
        w = users[base]
        for sched in (("dense", "tri") if base != "soft" else ("dense",)):
            C, launched = user_path(
                f"{w.name} {sched} n={n}",
                lambda: pald.cohesion(D, method="kernel", schedule=sched,
                                      weight=w), _pipeline_wrappers(sched))
            compare(f"phase 29 {w.name} {sched} n={n}", C,
                    pald.cohesion(D, method="kernel", schedule=sched,
                                  weight=base), True)
            print(f"phase 29: cohesion(D, method='kernel', schedule="
                  f"{sched!r}, weight={w.name}) n={n}: launches {launched}; "
                  f"C bitwise {base}'s")
            dense_launches[(base, sched)] = launched
            if base == "ignore" and sched == "dense":
                err_u, err_c = user_slab(f"{w.name} dense", C, D, w, SLAB,
                                         RTOL_MAIN, ATOL,
                                         U=ops.focus(D, impl="cuda", ties=w))
            elif base == "ignore":  # the tri kernel's own C, no U exposed
                _, err_t = user_slab(f"{w.name} tri", C, D, w, SLAB,
                                     RTOL_MAIN, ATOL)
            del C
    times = {}
    for base in ("drop", "ignore", "soft"):
        w = users[base]
        f_ms = in_turns(f"focus {w.name} n={n}",
                        lambda: ops.focus(D, impl="cuda", ties=w),
                        lambda: ops.focus(D, impl="cuda", ties=base))
        W = weights_ref(ops.focus(D, impl="cuda", ties=base))
        c_ms = in_turns(f"cohesion {w.name} n={n}",
                        lambda: ops.cohesion_from_weights(D, W, impl="cuda",
                                                          ties=w),
                        lambda: ops.cohesion_from_weights(D, W, impl="cuda",
                                                          ties=base))
        times[base] = (f_ms, c_ms)
        if base == "ignore":
            t_ms = in_turns(f"cohesion_tri {w.name} n={n}",
                            lambda: ops.cohesion_from_weights(
                                D, W, impl="cuda", schedule="tri", ties=w),
                            lambda: ops.cohesion_from_weights(
                                D, W, impl="cuda", schedule="tri",
                                ties=base))
        del W
    lq = dense_launches[("ignore", "dense")]
    row("focus_general", "ignore", "src/repro_torch/csrc/pald_focus.cu",
        "src/repro/kernels/pald_focus.py:55", lq["focus_general_cuda"],
        err_u, *times["ignore"][0], plain["focus_general"],
        "phase 4: ignore's callables on the same D",
        bound_ms("focus", n, clock_mhz))
    row("cohesion_general", "ignore", "src/repro_torch/csrc/pald_cohesion.cu",
        "src/repro/kernels/pald_cohesion.py:134",
        lq["cohesion_general_cuda"], err_c, *times["ignore"][1],
        plain["cohesion_general"], "phase 4: ignore's callables on the same D",
        bound_ms("cohesion", n, clock_mhz))
    row("cohesion_tri", "ignore", "src/repro_torch/csrc/pald_cohesion_tri.cu",
        "src/repro/kernels/pald_cohesion_tri.py:121",
        dense_launches[("ignore", "tri")]["cohesion_tri_cuda"], err_t,
        *t_ms, plain["cohesion_tri"],
        "phase 14: ignore's callables on the same D",
        bound_ms("cohesion", n, clock_mhz))

    # the ignore clone at a ragged n (the engine pads it)
    Dr = D[:RAGGED_USER, :RAGGED_USER].contiguous()
    w = users["ignore"]
    C, launched = user_path(f"{w.name} n={RAGGED_USER}",
                            lambda: pald.cohesion(Dr, method="kernel",
                                                  weight=w),
                            _pipeline_wrappers("dense"))
    compare(f"phase 29 {w.name} n={RAGGED_USER}", C,
            pald.cohesion(Dr, method="kernel", weight="ignore"), True)
    print(f"phase 29: {w.name} n={RAGGED_USER}: launches {launched}; C "
          "bitwise ignore's")
    del C, Dr

    # the smooth functional: a 16-row slab at n = 8192, whole at n = 1024
    w = users["smooth"]
    C, launched = user_path(f"{w.name} n={n}",
                            lambda: pald.cohesion(D, method="kernel",
                                                  weight=w),
                            _pipeline_wrappers("dense"))
    user_slab(f"{w.name} n={n}", C, D, w, USER_SLAB, RTOL, ATOL,
              U=ops.focus(D, impl="cuda", ties=w))
    print(f"phase 29: {w.name} n={n}: launches {launched}")
    del C
    Xs, _ = clustered_points(N_USER_WHOLE, D_MAIN, SEED + 29)
    Xs = torch.as_tensor(Xs, device=dev)
    Ds = distances_on_device(Xs)
    for tag, run, wrappers in (
            ("dense", lambda **kw: pald.cohesion(Ds, method="kernel", **kw),
             _pipeline_wrappers("dense")),
            ("tri", lambda **kw: pald.cohesion(Ds, method="kernel",
                                               schedule="tri", **kw),
             _pipeline_wrappers("tri")),
            ("fused", lambda **kw: pald.from_features(Xs, method="fused",
                                                      **kw),
             _chunk_wrappers("fused")),
            ("knn features", lambda **kw: pald.from_features(
                Xs, k=K_KNN, **kw), _chunk_wrappers("knn features")),
            ("knn distance", lambda **kw: pald.cohesion(
                Ds, method="knn", k=K_KNN, **kw),
             _chunk_wrappers("knn distance"))):
        C, launched = user_path(f"{w.name} {tag} n={N_USER_WHOLE}",
                                lambda: run(weight=w), wrappers)
        err = compare(f"phase 29 {w.name} {tag} n={N_USER_WHOLE}", C,
                      run(weight=w, impl="torch"), False)
        print(f"phase 29: {w.name} {tag} n={N_USER_WHOLE}: launches "
              f"{launched}; C max |err| {err!r} against the plain versions "
              f"(rtol {RTOL}, atol {ATOL})")

    # the fused path at n = 8192, d = 64 (phase 7's X) with harsh
    X, _ = clustered_points(N_MAIN, D_FUSED, SEED)
    Xg = torch.as_tensor(X, device=dev)
    w = users["drop"]
    C, lf = user_path(f"{w.name} fused n={n} d={D_FUSED}",
                      lambda: pald.from_features(Xg, weight=w),
                      _chunk_wrappers("fused"))
    compare(f"phase 29 {w.name} fused n={n}", C,
            pald.from_features(Xg, weight="drop"), True)
    err_fu, err_fc = user_slab(f"{w.name} fused", C, cdist_reference(Xg), w,
                               SLAB, RTOL_MAIN, ATOL,
                               U=pald_fused.focus_fused_cuda(Xg, ties=w))
    del C
    f_ms = in_turns(f"focus_fused {w.name} n={n} d={D_FUSED}",
                    lambda: pald_fused.focus_fused_cuda(Xg, ties=w),
                    lambda: pald_fused.focus_fused_cuda(Xg, ties="drop"))
    W = weights_ref(pald_fused.focus_fused_cuda(Xg, ties="drop"))
    c_ms = in_turns(f"cohesion_fused {w.name} n={n} d={D_FUSED}",
                    lambda: pald_fused.cohesion_fused_cuda(Xg, W, ties=w),
                    lambda: pald_fused.cohesion_fused_cuda(Xg, W,
                                                           ties="drop"))
    del W
    for name, ms, err in (("focus", f_ms, err_fu), ("cohesion", c_ms, err_fc)):
        row(f"{name}_fused", "drop", "src/repro_torch/csrc/pald_fused.cu",
            {"focus": "src/repro/kernels/pald_fused.py:71",
             "cohesion": "src/repro/kernels/pald_fused.py:144"}[name],
            lf[f"{name}_fused_cuda"], err, *ms, plain[f"{name}_fused"],
            "phase 8: drop's callables on the same X",
            fused_bound_ms(name, n, D_FUSED, clock_mhz))
    del Xg

    # k-NN: select_cohere at n = 50,000, k = 32 (phase 10's mixture) with
    # harsh and the soft clone; the D source at n = 8192 with harsh
    Xk, _ = make_mixture(N_KNN, COMM_KNN, D_KNN, SEED)
    Xk = torch.as_tensor(Xk, device=dev)
    nk = Xk.shape[0]
    for base in ("drop", "soft"):
        w = users[base]
        (graph, vals), launched = user_path(
            f"select_cohere {w.name} n={nk}",
            lambda: ops.select_cohere(Xk, k=K_KNN, ties=w, normalize=True),
            _chunk_wrappers("knn features"))
        gb, vb = ops.select_cohere(Xk, k=K_KNN, ties=base, normalize=True)
        compare(f"phase 29 select_cohere {w.name} indices", graph.indices,
                gb.indices, True)
        compare(f"phase 29 select_cohere {w.name} values", vals, vb, True)
        err = knn_slab_check(f"phase 29 select_cohere {w.name}", Xk, graph,
                             vals, 30001, K_KNN, ties=w)
        dn, idx = graph.distances, graph.indices
        ms = in_turns(f"knn_values_features {w.name} n={nk} k={K_KNN}",
                      lambda: pald_knn.knn_values_from_features_cuda(
                          Xk, dn, idx, ties=w),
                      lambda: pald_knn.knn_values_from_features_cuda(
                          Xk, dn, idx, ties=base), reps=5)
        plain_ms, _ = time_ms(lambda: pald_knn.knn_values_from_features_torch(
            Xk, dn, idx, ties=w, block=4096), 1)
        row("knn_values_features", base, "src/repro_torch/csrc/pald_knn.cu",
            "src/repro/kernels/pald_knn.py:74",
            launched["knn_values_from_features_cuda"], err, *ms, plain_ms,
            "this phase, the same inputs",
            knn_bound_ms("knn_values_features", nk, K_KNN, D_KNN, clock_mhz))
        del graph, vals, gb, vb
    del Xk
    w = users["drop"]
    C, launched = user_path(f"{w.name} knn D n={n}",
                            lambda: pald.cohesion(D, method="knn", k=K_KNN,
                                                  weight=w),
                            _chunk_wrappers("knn distance"))
    compare(f"phase 29 {w.name} knn D n={n}", C,
            pald.cohesion(D, method="knn", k=K_KNN, weight="drop"), True)
    del C
    g = tknn.knn_from_distances(D, K_KNN)
    vk = pald_knn.knn_values_from_distances_cuda(D, g.distances, g.indices,
                                                 ties=w)
    vp = pald_knn.knn_values_from_distances_torch(D, g.distances, g.indices,
                                                  ties=w)
    err = compare(f"phase 29 knn D {w.name} vs plain", vk, vp, False)
    ms = in_turns(f"knn_values_distances {w.name} n={n} k={K_KNN}",
                  lambda: pald_knn.knn_values_from_distances_cuda(
                      D, g.distances, g.indices, ties=w),
                  lambda: pald_knn.knn_values_from_distances_cuda(
                      D, g.distances, g.indices, ties="drop"), reps=5)
    plain_ms, _ = time_ms(lambda: pald_knn.knn_values_from_distances_torch(
        D, g.distances, g.indices, ties=w, block=4096), 1)
    row("knn_values_distances", "drop", "src/repro_torch/csrc/pald_knn.cu",
        "src/repro/kernels/pald_knn.py:74",
        launched["knn_values_from_distances_cuda"], err, *ms, plain_ms,
        "this phase, the same inputs",
        knn_bound_ms("knn_values_distances", n, K_KNN, D_KNN, clock_mhz))
    del D, g, vk, vp

    # the values kernel's large-k variant with compiled functors: n = 2100,
    # k = 2048, the features and D sources; the ignore and soft clones
    # bitwise their built-ins, the smooth one on a slab against its plain
    # version
    nl, kl = N_LARGE_CHUNK, K_LARGE_CHUNK
    Xl = torch.as_tensor(make_mixture(nl, COMM_KNN, D_KNN, SEED + 29)[0],
                         device=dev)
    Dl = cdist_reference(Xl)
    gl = pald_topk.topk_select_cuda(Xl, kl)
    dn, idx = gl.distances, gl.indices
    sources = ((pald_knn.knn_values_from_features_cuda, Xl),
               (pald_knn.knn_values_from_distances_cuda, Dl))
    for base in ("ignore", "soft", "smooth"):
        u = users[base]
        for src, x in sources:
            before = src.large_launches
            v = src(x, dn, idx, ties=u)
            if src.large_launches != before + 1:
                fail(f"phase 29: {src.__name__} {u.name} k={kl} did not run "
                     "the large-k variant")
            if base != "smooth":
                compare(f"phase 29 {src.__name__} {u.name} k={kl}", v,
                        src(x, dn, idx, ties=base), True)
        if base == "smooth":
            r0 = 1000
            sl = slice(r0, r0 + LARGE_SLAB)
            err = compare(
                f"phase 29 {u.name} k={kl} rows {r0}:{r0 + LARGE_SLAB}",
                v[sl], pald_knn.knn_values_torch(
                    dn[sl], tknn.gather_tile_from_distances(Dl, idx[sl]),
                    idx[sl], ties=u, row_off=r0), False)
    print(f"phase 29: the values kernel's large-k variant at n={nl}, k={kl}:"
          f" the ignore and soft clones bitwise their built-ins (features "
          f"and D sources); {u.name} max |err| {err!r} on a {LARGE_SLAB}-row "
          f"slab against its plain version")
    del Xl, Dl, gl, dn, idx, v

    # phase 17's chunk cells with harsh: one launch of each kernel a chunk
    items, nc = CHUNK_CELLS[0]
    Db = _stack_distances(items, nc, dev, SEED + 290)
    Xb = _stack_points(items, nc, D_KNN_CHUNK, dev, SEED + 291)
    X3 = _stack_points(3, 128, D_MAIN, dev, SEED + 292)
    for tag, run, wrappers in (
            ("dense", lambda **kw: pald.cohesion(Db, method="kernel", **kw),
             _pipeline_wrappers("dense")),
            ("tri", lambda **kw: pald.cohesion(Db, method="kernel",
                                               schedule="tri", **kw),
             _pipeline_wrappers("tri")),
            ("fused", lambda **kw: pald.from_features(Xb, method="fused",
                                                      **kw),
             _chunk_wrappers("fused")),
            ("fused B=3 n=128", lambda **kw: pald.from_features(
                X3, method="fused", **kw), _chunk_wrappers("fused")),
            ("knn features", lambda **kw: pald.from_features(
                Xb, k=K_CHUNK, **kw), _chunk_wrappers("knn features")),
            ("knn distance", lambda **kw: pald.cohesion(
                Db, method="knn", k=K_CHUNK, **kw),
             _chunk_wrappers("knn distance"))):
        C, launched = user_path(f"{w.name} chunk {tag}",
                                lambda: run(weight=w), wrappers, once=True)
        compare(f"phase 29 {w.name} chunk {tag}", C, run(weight="drop"),
                True)
        print(f"phase 29: {w.name} chunk {tag} (B={C.shape[0]}, "
              f"n={C.shape[1]}): launches {launched}; C bitwise drop's")
    del Db, Xb, X3

    # what does not compile raises on the card, naming the op
    bad = tw.WeightFunctional("cosine-focus",
                              lambda a, b, c: torch.cos(a - c),
                              tw.DROP.support)
    try:
        pald.cohesion(Ds, method="kernel", weight=bad)
    except NotImplementedError as e:
        msg = str(e)
    else:
        fail("phase 29: an untraceable functional ran on the card")
    if "aten.cos" not in msg:
        fail(f"phase 29: the raise does not name the op: {msg}")
    try:
        pald.cohesion(Ds, method="kernel", weight=bad, on_error="fallback")
    except resilience.FallbackExhausted as e:
        cause = type(e.__cause__).__name__
    else:
        fail("phase 29: the guard ran an untraceable functional")
    print(f"phase 29: an untraceable functional on the card: "
          f"NotImplementedError ({msg[:160]}...); under on_error='fallback'"
          f": FallbackExhausted (from {cause})")
    info = pald.plan(Ds, method="kernel", weight=users["drop"]).explain()
    print(f"phase 29: explain()['weight_kernel'] of harsh: "
          f"{info['weight_kernel']}")
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available; this script runs only on "
              "the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 3
    sys.stdout.reconfigure(line_buffering=True)  # a cut run keeps its log
    # the run's own tuning cache: every phase plans on a cold cache, and
    # phase 18 tunes into it; removed at the end
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(cache_dir,
                                                        "blocktune.json")
    try:
        return run_phases()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run_phases() -> int:
    import torch

    start = time.perf_counter()
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm", "csv,noheader,nounits"))
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, max SM clock {clock_mhz} MHz")

    t0 = time.perf_counter()
    for symbol in _build.SIGNATURES:
        _build.load(symbol)
    print(f"phase 1: kernels built/loaded in {time.perf_counter() - t0:.1f} s")
    for source in ("pald_focus", "pald_cohesion", "pald_cohesion_tri"):
        for kernel, resources in _build.ptxas_report(source):
            print(f"phase 1: ptxas {source}: {kernel}: {resources}")
    # phase 29's libraries: nvcc in a thread beside phases 2-28
    user_build = UserBuild()

    t0 = time.perf_counter()
    phase_kernels_vs_plain(dev)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    D, launches, U_slab, r0 = phase_main_path(dev)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels = phase_timing(D, launches, U_slab, r0, clock_mhz)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense_families = phase_families(D)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")
    del D, U_slab
    t0 = time.perf_counter()
    phase_fused_vs_plain(dev)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    Xg, D, launches = phase_fused_main_path(dev)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += phase_fused_timing(Xg, D, launches, clock_mhz, dense_families)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")
    del Xg, D
    t0 = time.perf_counter()
    phase_knn_vs_plain(dev)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    Xk, graph, launches, _ = phase_knn_main_path(dev)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += phase_knn_timing(Xk, graph, launches, clock_mhz)
    kernels += phase_knn_large_k(Xk, clock_mhz, card)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    del Xk, graph
    t0 = time.perf_counter()
    phase_tri_vs_plain(dev)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    D, launches = phase_tri_main_path(dev)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += phase_tri_timing(D, launches, clock_mhz)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_profile_and_ragged(D)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    del D
    t0 = time.perf_counter()
    phase_guard(dev)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += phase_chunks(dev, card, clock_mhz)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_tuned(dev, card)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        t0 = time.perf_counter()
        rect_launches = phase_dense_distributed(card, tmp)
        print(f"phase 19: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    kernels += phase_rect_kernels(dev, clock_mhz, card, rect_launches)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_features_distributed(card)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = phase_knn_distributed(card)
    kernels += phase_distributed_kernels(dev, clock_mhz, card, counts)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_guard_distributed(card)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_lm_serve(dev, card)
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_examples(card)
    print(f"phase 25: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train(dev, card)
    print(f"phase 26: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_sharded_train(dev, card)
    print(f"phase 27: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dry = phase_dryrun(dev, card, clock_mhz)
    for k in kernels:
        if k["name"] in ("focus_general_rect", "cohesion_general_rect"):
            k["dryrun_launches"] = dry[k["name"].split("_")[0]]
    print(f"phase 28: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += phase_user_functionals(dev, card, clock_mhz, user_build,
                                      kernels)
    print(f"phase 29: {time.perf_counter() - t0:.1f} s")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all, the "
          f"build included")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke test of the PyTorch/H100 port (``tt_sketch_torch``).

Run from the repo root on a machine with one CUDA card::

    python3 chip_smoke.py [--phases 1,15]

``--phases`` runs the phases it names, with phase 1 and the phases they
need (6 needs 5 and 9; 12 needs 5, 6 and 9); the default is every phase,
and only a run of every phase prints the kernels line.  Phases (the first
failure raises and exits non-zero):

1. Build the CUDA libraries ``dual_project``, ``lazy_gaussian``,
   ``sparse_sign``, ``sparse_psi``, ``chain_step`` and ``segment_psi`` from
   ``tt_sketch_torch/csrc`` (nvcc,
   sm_90a, one process per source, all at once), print each ptxas report
   and the card's name and power limit; count in the built SASS the
   instructions per lazy-Gaussian sample (``lazy_gaussian`` kernel), which
   the sparse bounds use beside a fixed charge per draw of a sparse-sign
   column (``SIGN_DRAW_OPS``); census the ``sparse_sign`` kernels (the
   shared-memory instance's loops; each register instance free of local
   memory, one hash a draw, its instructions per draw); and per instance
   of the projection kernel its instructions, tensor-core products and
   shared-memory loads.
2. Hold ``dual_project`` against its plain PyTorch version, ``f32`` and
   ``bf16`` modes both at ``F32_TOL``, at the main-path shape, a ragged
   shape and a rank-split shape; check that two calls at the main shape
   give the same bits; print the U partials' bytes (asserted at most a
   quarter of X's); time kernel, plain version and the two-``torch.matmul``
   yardstick; bound it by bytes and by its TF32 tensor-core products.
3. The dense main path at full width (``bench.py``'s configuration): a
   rank-5 TT of logical shape (4864, 128, 128, 128), 1.02e10 f32 entries,
   streamed in 19 mode-0 slabs kept as their pivot-1 2-D view
   (32768, 16384) through ``slab_stream_sketch`` with TT-DRMs of rank
   32/64; recover with ``SketchedTensorTrain.to_tt()`` and check the error
   and the kernel's launch count; then time one resident slab streamed
   19 x 3 times.
4. ``stream_sketch`` on dense and TT input in float64 at a small shape:
   exact recovery and linearity of ``+``.
5. The sparse main paths at full size, each through ``stream_sketch`` in
   f32 at rank 10/20 with the library-default plans, recording the
   arguments of every kernel call: ``uber-synthetic`` with a
   ``SparseGaussianDRM`` pair (launches 3/2/1/1/2: rows, Ω, merged, Ψ,
   segment reductions) and
   with a ``SparseSignDRM`` pair (the same with ``sparse_sign_rows``);
   ``lbnl-synthetic`` with a Gaussian and with a sign pair (merged x 4,
   ``psi_window_direct`` x 1).  Per path: the launch counts, worked out
   from the plans and asserted; every Ψ/Ω against the same sketch with
   each kernel replaced by its plain version on the card; ``sample_error``
   of ``to_tt()`` (a guard for uber only: lbnl's scattered support has
   nothing to compress; with the sign pair each of seeds 0-4 against the
   float64 parity path of the same seed, and their median); median sketch
   time over fresh seeds (CUDA events); the recorded segment reductions
   (the package's, through ``psi_segment`` for a Ψ of at most 16384 values;
   its plain ``index_add_``; a one-hot ``torch.matmul`` written here as a
   yardstick) and slab combines replayed and timed; a profiler breakdown.
6. The sparse kernels against their plain versions: the 64-bit hash bit for
   bit; every kernel at every call phase 5 recorded (Gaussian and sign
   sides), at the calls of ragged sketches (nnz not a multiple of the
   chunk, odd ranks; Gaussian, sign and mixed pairs, sliced sign sides) and
   with flat indices above 2^63, and with Gaussian sides of 16 x 40 and
   30 x 40 (one thread group; passes over the range); the segment kernel
   also at ``SEGMENT_SHAPES``: uber's two segment shapes with their indices
   sorted or in runs of about 2,600 (an index outside the mode inside a
   run) and at random, each timed alone and back to back, a Ψ of the most
   values it takes (float32 and float64, held to 1e-12), without sides,
   with one row;
   the same bits from two calls of each ``sparse_psi.cu`` instance, of
   ``chain_step_t``, ``psi_segment`` and ``sparse_sign_rows`` at the
   recorded calls and of the segment kernel at every shape; time the
   recorded calls and
   their plain versions (the segment kernel's also against ``index_add_``
   of the outer products), and bound them (each time also over its bound);
   each recorded ``chain_step_t`` launch on its own line (mode, ``n``,
   ranks, where the core lives, ms alone and back to back, bound, the
   bytes of core rows gathered).
7. ``sparse_sign_rows`` against its plain version bit for bit
   (``torch.equal``), and the same bits from two calls: uber's shapes (in
   phase 6), a ragged N, fewer non-zeros than slots, rank slices, flats
   above 2^63, both sides of each rank bucket's edge (16, 17, 32, 33: the
   register instances and the shared-memory one) and ranks above 4096
   (the exact 128-bit swap product).
8. ``psi_window_direct``, both variants: at lbnl's recorded calls (in
   phase 6, one-sided), at the calls of a sketch of lbnl with its modes
   rolled so that the 868131-row mode is interior (two-sided; Gaussian
   and mixed sides), and at a small skewed shape with empty and
   multi-chunk windows with every combination of sides.
9. The sequential main paths on sparse input at full size, rank 10 (OTTS
   10/20) in f32 with the library-default plans, run after phase 5's paths
   on the same tensors and before phase 6: ``hmt_sketch`` of
   ``uber-synthetic`` with a ``SparseGaussianDRM`` (``chain_step_t`` x 3,
   ``psi_chunk_slabs_genright`` x 1, ``psi_chunk_slabs`` x 1,
   ``lazy_gaussian`` x 2, ``psi_segment`` x 2); ``orthogonal_sketch`` with
   a Gaussian pair (the same plus ``omega_fused`` x 3); ``hmt_sketch`` with
   the default ``TensorTrainDRM`` (``chain_step_t`` x 6, ``psi_chunk_slabs``
   x 2, ``psi_segment`` x 2); one
   untimed ``hmt_sketch`` of ``lbnl-synthetic`` (``psi_fused_slabs`` x 1,
   ``psi_chunk_slabs_genright`` x 3, ``chain_step_t`` x 4 with modes above
   4096 rows).  Per path: launch counts from the plans, asserted; the
   recovered TT against the same sketch with every kernel replaced by its
   plain version, at 10,000 nonzero and 10,000 random index tuples (a QR
   sits between the modes, so cores are not compared); the sample-error
   guard (HMT on uber: 0.45-0.60); median time over fresh seeds, host
   enqueue, busy share, the recorded segment reductions as in phase 5.
   Phase 6 then also checks, times and bounds the calls these paths
   recorded.
10. ``chain_step_t``, ``psi_chunk_slabs`` and ``psi_chunk_slabs_genright``
    against their plain versions at odd shapes: ragged nnz, ``n = 1``,
    ranks of 1, an index at ``n - 1``, the edges of ``chain_schedule``
    (a core at the block budget and one row above, each rank bucket's
    edge, ranks past the largest bucket: the generic instance), the first
    step bit for bit (at the budget, above it, a 9.6 MB core), bfloat16,
    indices outside the mode wherever the core lives; the chain step's
    cores of 24-4198 rows held in shared memory and read through the cache,
    timed (the measurement behind its budget); whole tiles of sentinels,
    a chunk whose every nonzero hits one row, every side combination, sign
    and sliced hashed sides, the shared-memory limit of given sides; both
    orientations of the half-fused Ψ through streaming sketches with a
    ``TensorTrainDRM`` on one side and a ``SparseGaussianDRM`` on the
    other; the same bits from two calls of ``psi_chunk_slabs`` and
    ``psi_chunk_slabs_genright``.
11. The projector diagnostics (``kernels/projector_diag.py``): ``t_only``
    and ``u_only`` (``f32`` and ``bf16``) and ``reduce_read`` against their
    plain versions at the main-path shape, a ragged shape, a rank-split
    shape (several launches) and a shape whose S is odd, the same bits from
    two calls at the main-path shape; their times, plain versions' and
    library calls' times and bounds at the main-path shape; ``reduce_read``
    and ``X.sum(dim=1, keepdim=True)`` in turns, alone, ten back to back and
    the host's enqueue time of one call; then ``run_projector_diag`` at
    the main-path shape with the launch counts set to 0 just before it and
    read just after, printing its nine tagged lines.
12. The other input formats and rank growth.  (a) ``uber-synthetic`` as
    a ``TensorSum`` of ``SUM_SHARDS`` contiguous nnz shards
    (``split(psi_plan=True)``, library-default plans; the host seconds of
    the split printed), STTA at 10/20 in f32 with a Gaussian and with a
    sign pair, each with the DRMs of the whole tensor's sketch of seed 0:
    every Ψ/Ω against the whole tensor's fused sketch (linearity, across
    two kernel routes) and against the same sum under ``plain_kernels()``;
    launch counts worked out from the shards' plans (per shard: Ω through
    ``omega_fused``, Ψ of a planned mode through ``psi_fused_slabs``, of
    an unplanned one through the segment reduction over generated rows);
    the sample-error guard (the sign sum held to the whole tensor's sketch
    with the same DRMs); median time, host enqueue and busy share beside
    phase 5's.  (b) ``hmt_sketch`` of that sum at rank 10 (Gaussian): one
    child chain per shard; recovered values at 10,000 nonzero and 10,000
    random index tuples against the whole tensor's HMT with the same DRM
    and against the sum under ``plain_kernels()`` (``SEQ_TOL``), the HMT
    guard, launch counts, median time.  (c) ``increase_rank`` of a
    Gaussian STTA sketch of uber from 10/20 to 15/30 (three new blocks,
    each a fused sketch with rank-sliced salts): every Ψ/Ω against a
    sketch from scratch with the grown DRMs, the old container as block
    (0, 0) bit for bit, launch counts, the growth's time against the
    sketch from scratch.  Every kernel call of (a)-(c) against its plain
    version, and each kernel's launches per path timed and bounded (they
    join ``by_path``).  (d) The paper's TT-sum workload: ten random
    rank-100 TTs of shape (1000,)^5 in f64 (2.25 GiB of cores, drawn on the
    card) with coefficients ``logspace(0, -10, 10)``: STTA 24/25, OTTS
    24/25 and HMT 24 with the default TT-DRMs; the STTA sketch against the
    sum of the summands' sketches (``TT_SUM_TOL``); relative errors from
    TT inner products (never densified; OTTS and HMT held to
    ``TT_SUM_ERROR_RANGE``); median times, and with the DRMs given.
    (e) CP (``cp_problem``: (10,)^5, CP rank 100; STTA/OTTS 30/60, HMT
    30), Tucker ((30,)^4, multilinear rank 5; 25/30, HMT 25) and
    ``tt_plus_sparse_problem`` with a ``DenseGaussianDRM`` pair (30/60,
    HMT 30), in f64 on the card and on
    the CPU in this process: recovered TTs within ``FORMAT_TOL`` of each
    other, the Tucker tensor recovered within ``TUCKER_EXACT_TOL``.
13. TT rounding, TT-SVD and sketched TT-GMRES (``solvers/``; no kernel of
    ours: ``einsum``s, QRs and SVDs).  (a) ``round_tt_sum`` of the TT-sum
    workload of phase 12 (d) at max_rank 24, pairwise, sketch and
    orth_sketch (seed 0): relative errors from TT inner products (pairwise
    and orth_sketch held to ``TT_SUM_ERROR_RANGE``, the STTA-based sketch
    to be finite); ``svdvals`` of the pairwise result (every unfolding's
    ``|S|_2`` is the TT's norm); the first two summands (rank 200) rounded
    at eps 1e-3, max_rank 50 by ``round`` and by ``round_masked`` then
    ``trim_to_ranks``, and on the CPU: the same ranks, tensors within
    ``ROUND_TOL``; each call's median ms, host enqueue and busy share.
    (b) ``tt_svd`` at ``TT_SVD_CASES`` (Hilbert tensors, the recompression
    experiment's sqrt tensor as sparse COO) on the card and on the CPU:
    dense tensors within ``TT_SVD_TOL``.  (c) ``tt_sum_gmres`` on the
    synthetic cookie problem at ``run_cookie``'s full setting ((60, 20, 20,
    20, 20), f64, preconditioned): sketch rounding at rank 50 and pairwise
    at rank 10, ``device_resident="auto"`` (True on the card), the seed
    of ``run_cookie``'s run 0; the final internal residual held to half the
    smallest and twice the largest of ``results/cookie.csv``'s runs 0-4,
    the densified true residual of the preconditioned system to
    ``COOKIE_TRUE_RESIDUAL``; iterations, seconds, step and final-round
    times, a short solve under the profiler (host against device per
    iteration), the host-device syncs of one iteration of each route; then
    the sketch solve at ``GMRES_PARITY_ITERS`` iterations on the card by
    both routes and on the CPU: histories and solutions within
    ``GMRES_TOL``.
14. The uniform engine, streaming sessions, checkpoints and profiling
    (no kernel of ours in (a); the sessions launch the sparse kernels).
    (a) ``run_dimension_scaling``'s full setting on the uniform engine:
    ``exp_decay_uniform_problem(8192, 30, 30, seed=179)`` in f64, STTA 30/60,
    HMT 30 and OTTS 30/60 with the ``"hash"`` DRM stream at run 0's seeds,
    each through its entry point and rounded to 10, and
    ``uniform_round_fixed`` at 10, 9 and 8: every error on the card's Gram
    route held to ``results/dimension_scaling.csv`` (``SCALING_TOL``),
    STTA's also on the exact route (``SCALING_EXACT_TOL``); stage times
    (``profiling.StageTimer``), the peak memory; at ``SCALING_COUNT_ORDER``
    STTA's sketch split into its hash DRMs, chains with Ψ/Ω and batched
    recovery (held to ``uniform_stream_sketch``), and the syncs, device
    operations and busy share of each stage; STTA at order 1024 and OTTS at
    256 (``SCALING_PARITY_ORDERS``) through their entry points on the card
    and on the CPU in this process (``SCALING_CARD_CPU_TOL``).  (b) uber in
    ``SESSION_SHARDS`` planned shards through ``StreamingSketchSession`` at
    10/20 in f32 with a ``SparseGaussianDRM`` pair (launch counts from the
    shards' plans) and with the default ``TensorTrainDRM``s (the launches
    printed): the uninterrupted stream, held to the same consumes under
    the plain versions within ``PSI_TOL``, and a crash after
    ``SESSION_CRASH_AFTER`` shards with a checkpoint every
    ``SESSION_CHECKPOINT_EVERY``, resumed; the resumed Ψ/Ω equal to the
    uninterrupted ones bit for bit (else a determinism probe and
    ``RESUME_TOL``), to the whole tensor's sketch with the same DRMs within
    ``PSI_TOL``, the sample error within ``SESSION_ERROR_TOL`` of the whole
    sketch's; the checkpoint loaded on the CPU equal to the card's copy; ms
    per consume, checkpoint write and resume, the checkpoint's bytes, a
    consume's host enqueue and busy share.  (c) ``profiling.trace`` of one consume names a kernel of ours;
    ``memory_stats()`` on the card.
    Its three TT-SVD rows share one LR orthogonalization
    (``uniform_orthogonalize`` once, then ``_truncate_fixed`` at 10, 9 and
    8).
15. The sharded sketches (``tt_sketch_torch.dist``) in one spawned world of
    ``SHARD_WORLD`` ranks (``chip_smoke_dist.run_rank``): over NCCL, one
    card each, on a machine with that many cards; else over gloo, every
    rank on cuda:0 (NCCL refuses two ranks on one device; the card is
    time-shared, so its times are no scaling numbers).  uber at full size
    on the meshes (4,) data and (1, 2, 2) data x left x right: every Ψ/Ω
    within ``SHARD_TOL`` of the single-device ``stream_sketch`` at the same
    seed, the sample error within ``SHARD_SAMPLE_TOL`` of its, every rank's
    launches those of ``PATH_LAUNCHES["uber gauss"]``; the world's time per
    sketch between barriers, each rank's time up to its ``all_reduce``, the
    ``all_reduce`` and its bytes, medians over fresh seeds of a sketcher
    prepared once; rank 0's kernel calls of one sketch against their plain
    versions, timed and bounded (they join ``by_path``).  The dense stream:
    ``DENSE_SHARD_SHAPE`` f32 from a TT of rank ``DENSE_SHARD_TT_RANK``,
    held once in shared host memory, each rank's slab one phase-3 slab and
    one ``dual_project`` launch: against ``dense_stream_sketch_bisect``
    over the whole X (``SHARD_TOL``), recovery within
    ``DENSE_RECOVERY_TOL``.  The TT sum of phase 12 (d), its stacked cores
    in shared host memory, summands padded to 12 over 4 ranks: within
    ``TT_SUM_TOL`` of ``stream_sketch`` of the ``TensorSum`` with the same
    TT-DRMs.  Then a one-rank NCCL world on cuda:0 in this process: uber
    within ``NCCL_ONE_RANK_TOL`` of the single-device sketch, and whether
    it is bit for bit.
16. The experiment harness (``tt_sketch_torch.experiments``).  (a)
    ``run_frostt`` through the ported driver at full size in float32:
    ``FROSTT_NAMES`` at ranks ``FROSTT_RANKS``, run 0, STTA r/2r and HMT r
    with ``SparseGaussianDRM``s and the driver's plans (threshold 16), 18
    rows, each held to ``results/frostt.csv``'s float32 row of its seed
    (``FROSTT_RECORD_TOL``), its error, ``time_taken`` and kernel launches
    printed (counts set to 0 just before each row and read just after; a
    row that launches no kernel fails); the ``FROSTT_RECORDED`` rows (nips
    at rank 20) against the same rows under ``plain_kernels()``
    (``FROSTT_PLAIN_TOL``), and their kernel calls against their plain
    versions, timed and bounded (they join ``by_path`` as "frostt nips
    ...").  (b) ``python -m tt_sketch_torch.experiments list`` and ``all
    --quick --no-progress`` as subprocesses (a non-zero exit fails): the
    quick FROSTT rows (float64, rank 5, seeds 5063/5064) held to the
    record's float64 rows (``FROSTT_F64_TOL``), every other quick row to the
    port's CPU rows in ``QUICK_CPU_DIR`` (``QUICK_RTOL``).
17. Print the ``{"kernels": [...]}`` line (a sparse kernel's figures are
    those of the first main path that launches it; ``by_path`` has them for
    every path, phase 12's, 15's and 16's among them, with each rank's
    launches for phase 15; the diagnostics' launches are those of their
    run), then the device line last.

Requires CUDA; exits non-zero without it.
"""
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

F32_TOL = 2e-5   # relative Frobenius: fp32 sums of 16384/32768 terms in another order
BF16_TOL = 1e-2  # chain_step_t on bfloat16 operands: its output rounded to bf16 once, the einsum's at each step
ROWS_TOL = 2e-6  # absolute: FMA-contracted erfinv polynomial vs separate ops, a few f32 ulps at |g| <= 5.5
PSI_TOL = 2e-5   # relative Frobenius: fp32 sums over up to 3.3M nnz in another order
SEG_F64_TOL = 1e-12  # relative Frobenius: psi_segment in float64, the same sums in another order
SAMPLE_ERROR_LIMIT = 1.0  # sample_error(to_tt()) of a FROSTT-uber sketch at rank 10/20
PARITY_ERROR_TOL = 1e-3   # absolute: an f32 kernel sketch's sample error vs the f64 parity path's, same seed
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # H100 SXM data sheet, fp32 outside the tensor cores
H100_TF32_FLOP_PER_S = 495e12   # H100 SXM data sheet, TF32 tensor cores, dense
# Lane instructions per second of the CUDA cores: the fp32 peak counts an
# FMA as two flops; integer instructions share the same dispatch slots.
H100_LANE_OPS_PER_S = H100_FP32_FLOP_PER_S / 2
#: instructions charged per draw of a sparse-sign column in the sparse
#: bounds (one hash, its swap position and the swap): one trip of the
#: shuffle pass of the shared-memory column kernel (``sparse_sign_kernel``,
#: from its loop head to its back branch in ``cuobjdump -sass``, sm_90a),
#: counted before the register instances existed.  Fixed, so that a leaner
#: kernel does not lower its own bound; phase 1 prints today's counts.
SIGN_DRAW_OPS = 44
SEQ_TOL = 2e-4   # max abs over 20,000 recovered values / largest value: two f32 sweeps whose sums differ in order, through a QR per mode
CHAIN_ULPS = 8   # chain_step_t: max abs err in ulps (2^-23) of the largest output; sums of at most 20 f32 products in another order
HMT_ERROR_RANGE = (0.45, 0.60)  # sample_error of an HMT sketch of FROSTT-uber at rank 10
SUM_SHARDS = 4   # phase 12: uber as a TensorSum of contiguous nnz shards
TT_SUM_SHAPE, TT_SUM_RANK, TT_SUM_TERMS = (1000,) * 5, 100, 10  # the paper's TT-sum workload
#: OTTS and HMT at rank 24 leave all but about 0.2 % of the TT sum's norm
#: (``results/timings_vs_error.csv``: 0.99809-0.99863 over ten runs);
#: STTA at 24/25 is not bounded (the same file: 467-1713), only finite
TT_SUM_ERROR_RANGE = (0.99, 1.0)
TT_SUM_TOL = 1e-10   # relative Frobenius: an f64 STTA sketch of a sum vs the sum of its summands' sketches (the same products added in another order)
FORMAT_TOL = 1e-10   # relative: an f64 recovered TT on the card vs on the CPU (the same sketch summed in another order, through QRs and pseudo-inverses)
TUCKER_EXACT_TOL = 1e-8  # relative error of a Tucker tensor recovered at sketch ranks above its TT ranks
SHARD_WORLD = 4  # phase 15: ranks of the sharded world
DENSE_SHARD_SHAPE, DENSE_SHARD_TT_RANK = (1024, 128, 128, 128), 32  # phase 15: one phase-3 slab per rank
SHARD_TOL = 3e-5  # max|diff|/max|ref| per part: a sharded f32 sketch vs the single-device one (tests/test_dist.py:166's bound)
SHARD_SAMPLE_TOL = 1e-4  # absolute: a sharded uber sketch's sample error vs the single-device sketch's
NCCL_ONE_RANK_TOL = 1e-6  # relative Frobenius: a one-rank NCCL world's sketch vs the single-device one (the same kernels and plans)
DENSE_RECOVERY_TOL = 1e-3  # relative error of the sharded dense stream's to_tt(), as phase 3's guard
LIBRARIES = ("dual_project", "lazy_gaussian", "sparse_sign", "sparse_psi",
             "chain_step", "segment_psi")
SPARSE_KERNELS = ("lazy_gaussian", "sparse_sign_rows", "omega_fused",
                  "psi_omega_merged_slabs", "psi_fused_slabs",
                  "psi_window_direct", "chain_step_t", "psi_chunk_slabs",
                  "psi_chunk_slabs_genright", "psi_segment")
RECORDED = SPARSE_KERNELS + ("_psi_sparse_segment", "_psi_from_slabs")
#: launches of one sketch per main path (the plans give the same counts:
#: ``expected_launches``); kernels not named launch 0 times
PATH_LAUNCHES = {
    "uber gauss": {"lazy_gaussian": 3, "omega_fused": 2,
                   "psi_omega_merged_slabs": 1, "psi_fused_slabs": 1,
                   "psi_segment": 2},
    "uber sign": {"sparse_sign_rows": 3, "omega_fused": 2,
                  "psi_omega_merged_slabs": 1, "psi_fused_slabs": 1,
                  "psi_segment": 2},
    "lbnl gauss": {"psi_omega_merged_slabs": 4, "psi_window_direct": 1},
    "lbnl sign": {"psi_omega_merged_slabs": 4, "psi_window_direct": 1},
    "uber hmt gauss": {"chain_step_t": 3, "psi_chunk_slabs_genright": 1,
                       "psi_chunk_slabs": 1, "lazy_gaussian": 2,
                       "psi_segment": 2},
    "uber otts gauss": {"chain_step_t": 3, "psi_chunk_slabs_genright": 1,
                        "psi_chunk_slabs": 1, "lazy_gaussian": 2,
                        "omega_fused": 3, "psi_segment": 2},
    "uber hmt tt": {"chain_step_t": 6, "psi_chunk_slabs": 2,
                    "psi_segment": 2},
    "lbnl hmt gauss": {"chain_step_t": 4, "psi_fused_slabs": 1,
                       "psi_chunk_slabs_genright": 3},
    # phase 12: uber as a sum of SUM_SHARDS planned shards, each sketched
    # mode by mode (no merged kernel), and the three new blocks of a rank
    # growth, each a whole-tensor fused sketch with rank-sliced salts
    "uber sum gauss": {"lazy_gaussian": 12, "omega_fused": 12,
                       "psi_fused_slabs": 8, "psi_segment": 8},
    "uber sum sign": {"sparse_sign_rows": 12, "omega_fused": 12,
                      "psi_fused_slabs": 8, "psi_segment": 8},
    "uber sum hmt gauss": {"chain_step_t": 12,
                           "psi_chunk_slabs_genright": 4,
                           "psi_chunk_slabs": 4, "lazy_gaussian": 8,
                           "psi_segment": 8},
    "uber grow gauss": {"lazy_gaussian": 9, "omega_fused": 6,
                        "psi_omega_merged_slabs": 3, "psi_fused_slabs": 3,
                        "psi_segment": 6},
}
#: the sequential main paths: (method, right DRM)
SEQ_PATHS = {"uber hmt gauss": ("hmt", "gauss"),
             "uber otts gauss": ("otts", "gauss"),
             "uber hmt tt": ("hmt", "tt"),
             "lbnl hmt gauss": ("hmt", "gauss")}
REPLACES = {
    "lazy_gaussian": "tt_sketch_tpu/kernels/pallas_rng.py:191",
    "sparse_sign_rows": "tt_sketch_tpu/kernels/pallas_rng.py:357",
    "omega_fused": "tt_sketch_tpu/kernels/pallas_psi.py:396",
    "psi_omega_merged_slabs": "tt_sketch_tpu/kernels/pallas_psi.py:498",
    "psi_fused_slabs": "tt_sketch_tpu/kernels/pallas_psi.py:270",
    "psi_window_direct": "tt_sketch_tpu/kernels/pallas_psi.py:666",
    "chain_step_t": "tt_sketch_tpu/kernels/pallas_chain.py:82",
    "psi_chunk_slabs": "tt_sketch_tpu/kernels/pallas_psi.py:70",
    "psi_chunk_slabs_genright": "tt_sketch_tpu/kernels/pallas_psi.py:795",
    # not a Pallas kernel: the one-hot segment reduction the JAX package
    # takes on a TPU
    "psi_segment": "tt_sketch_tpu/kernels/sketch_kernels.py:401",
}
SOURCES = {
    "lazy_gaussian": "tt_sketch_torch/csrc/lazy_gaussian.cu",
    "sparse_sign_rows": "tt_sketch_torch/csrc/sparse_sign.cu",
    "omega_fused": "tt_sketch_torch/csrc/sparse_psi.cu",
    "psi_omega_merged_slabs": "tt_sketch_torch/csrc/sparse_psi.cu",
    "psi_fused_slabs": "tt_sketch_torch/csrc/sparse_psi.cu",
    "psi_window_direct": "tt_sketch_torch/csrc/sparse_psi.cu",
    "chain_step_t": "tt_sketch_torch/csrc/chain_step.cu",
    "psi_chunk_slabs": "tt_sketch_torch/csrc/sparse_psi.cu",
    "psi_chunk_slabs_genright": "tt_sketch_torch/csrc/sparse_psi.cu",
    "psi_segment": "tt_sketch_torch/csrc/segment_psi.cu",
}
GAUSS = ("g",)

MAIN = (32768, 16384, 32, 64)   # (P, S, r, rho) of one slab's pivot-1 view
SHAPES = {"main": MAIN, "ragged": (1000, 3000, 7, 13),
          "rank_split": (777, 5000, 40, 100)}
#: the projector diagnostics (``kernels/projector_diag.py``): their TPU
#: kernels and the shapes they are checked at (S odd: unvectorized loads)
DIAG_KERNELS = ("t_only", "u_only", "reduce_read")
DIAG_REPLACES = {"t_only": "scripts/bench_projector_diag.py:36",
                 "u_only": "scripts/bench_projector_diag.py:74",
                 "reduce_read": "scripts/bench_projector_diag.py:97"}
DIAG_SHAPES = dict(SHAPES, odd=(333, 1001, 5, 9))
#: the tags of ``run_projector_diag`` each kernel's JSON entry carries
DIAG_TAGS = {"dual_project": ("dual-f32", "dual-bf16"),
             "t_only": ("T-f32", "T-bf16", "lib-T"),
             "u_only": ("U-f32", "U-bf16", "lib-U"),
             "reduce_read": ("read-roofline",)}
DIAG_REPS = 8


def _rel(a, b):
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def time_ms(fn, reps=7, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_build():
    from tt_sketch_torch.kernels import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_libraries(LIBRARIES)
    for name in LIBRARIES:
        cuda_build.load_library(name)
    print(f"# phase 1: {', '.join(LIBRARIES)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in LIBRARIES:
        if name in cuda_build.build_info:
            secs, log = cuda_build.build_info[name]
            print(f"# nvcc {name} {secs:.2f} s:")
            for line in log.splitlines():
                print(f"#   {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return smi


def _operands(P, S, r, rho, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((P, S), generator=g, device="cuda", dtype=torch.float32)
    R = torch.randn((S, rho), generator=g, device="cuda", dtype=torch.float32)
    L = torch.randn((P, r), generator=g, device="cuda", dtype=torch.float32)
    return X, R, L


def u_partial_bytes(P, S, r):
    """Bytes of the U partials of one launch: (G, r, s_pad) f32 written by
    the projection kernel and read back by its reduction, each way."""
    from tt_sketch_torch.kernels.dual_project import _library

    lib = _library()
    G = -(-P // lib.tt_dual_project_row_block())
    col_tile = lib.tt_dual_project_col_tile()
    return 4 * G * r * (-(-S // col_tile) * col_tile)


def phase_kernel_check():
    """Kernel vs plain version at every shape and mode, the same bits from
    two calls at the main-path shape; returns the measurements there."""
    import torch

    from tt_sketch_torch.kernels.dual_project import (
        dual_project,
        dual_project_reference,
    )

    # bf16 at F32_TOL too: kernel and plain version round the same operands
    # to bf16 and accumulate in fp32, so a kernel that skipped the rounding
    # (about 2e-3 away) fails
    main = {}
    for seed, (label, (P, S, r, rho)) in enumerate(SHAPES.items()):
        X, R, L = _operands(P, S, r, rho, seed)
        for compute, tol in (("f32", F32_TOL), ("bf16", F32_TOL)):
            T, U = dual_project(X, R, L, compute=compute)
            T0, U0 = dual_project_reference(X, R, L, compute=compute)
            torch.cuda.synchronize()
            rel = max(_rel(T, T0), _rel(U, U0))
            abs_err = max(float((T - T0).abs().max()),
                          float((U - U0).abs().max()))
            print(f"# phase 2: {label} P={P} S={S} r={r} rho={rho} "
                  f"{compute}: rel err {rel:.3e} (tol {tol:g}), "
                  f"max abs err {abs_err:.3e}")
            if not rel <= tol:
                raise AssertionError(
                    f"dual_project {compute} disagrees with its plain version "
                    f"at {label}: rel err {rel:.3e} > {tol:g}"
                )
            if label == "main":
                main[compute] = {"rel_err": rel, "max_abs_err": abs_err}
                T2, U2 = dual_project(X, R, L, compute=compute)
                same = torch.equal(T, T2) and torch.equal(U, U2)
                print(f"# phase 2: main {compute}: a second call gives the "
                      f"same bits: {same}")
                if not same:
                    raise AssertionError(f"dual_project {compute} is not "
                                         f"deterministic")
                del T2, U2
            del T, U, T0, U0
        if label == "main":
            part = u_partial_bytes(P, S, r)
            xbytes = 4 * P * S
            main["u_partial_bytes"] = 2 * part
            print(f"# phase 2: U partials at the main shape: {part} bytes "
                  f"written + {part} read = {2 * part} = "
                  f"{2 * part / xbytes:.3f} x X's {xbytes} bytes")
            if not 2 * part <= xbytes / 4:
                raise AssertionError("the U partials move more than a "
                                     "quarter of X's bytes")
            for compute in ("f32", "bf16"):
                main[compute]["ms"] = time_ms(
                    lambda: dual_project(X, R, L, compute=compute))
                main[compute]["plain_ms"] = time_ms(
                    lambda: dual_project_reference(X, R, L, compute=compute))
            main["library_ms"] = time_ms(
                lambda: (torch.matmul(X, R), torch.matmul(L.T, X)))
            print(f"# phase 2: main timings (ms): kernel f32 "
                  f"{main['f32']['ms']:.3f}, kernel bf16 "
                  f"{main['bf16']['ms']:.3f}, plain f32 "
                  f"{main['f32']['plain_ms']:.3f}, plain bf16 "
                  f"{main['bf16']['plain_ms']:.3f}, two torch.matmul "
                  f"{main['library_ms']:.3f}; bound f32 "
                  + ", bf16 ".join("{:.3f} by {}".format(*bound_ms(
                      P, S, r, rho, c)[:2]) for c in ("f32", "bf16")))
        del X, R, L
        torch.cuda.empty_cache()
    return main


def phase_main_path():
    """bench.py's configuration through the port's slab stream."""
    import torch

    from tt_sketch_torch import TensorTrain, TensorTrainDRM
    from tt_sketch_torch.engine.sketch import SketchedTensorTrain
    from tt_sketch_torch.formats.tt_ops import tt_to_dense
    from tt_sketch_torch.kernels.dense_engine import (
        dense_stream_sketch_bisect,
        prefix_chain_tensor,
        slab_stream_sketch,
        suffix_chain_tensor,
    )
    from tt_sketch_torch.kernels.dual_project import (
        dual_project,
        dual_project_reference,
    )

    f32 = torch.float32
    slab_shape = (256, 128, 128, 128)
    n_slabs = 19
    shape = (slab_shape[0] * n_slabs,) + slab_shape[1:]
    pivot = 1
    slab2d = (slab_shape[0] * slab_shape[1], slab_shape[2] * slab_shape[3])
    data = TensorTrain.random(shape, 5, seed=0, dtype=f32)
    ld = TensorTrainDRM(32, shape=shape, transpose=False, seed=1, dtype=f32)
    rd = TensorTrainDRM(64, shape=shape, transpose=True, seed=2, dtype=f32)
    s0 = slab_shape[0]

    def slab_fn(i):
        cores = [data.cores[0][:, i * s0:(i + 1) * s0, :]] + data.cores[1:]
        return tt_to_dense(cores).reshape(slab2d).contiguous()

    torch.cuda.synchronize()
    dual_project.launches = 0
    t0 = time.perf_counter()
    container = slab_stream_sketch(
        slab_fn, n_slabs, shape, ld.cores, rd.cores, engine="bisect",
        projector="auto", pivot=pivot,
    )
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = dual_project.launches
    rec = SketchedTensorTrain(container, ld, rd).to_tt()
    err = rec.error(data, relative=True)
    n_entries = float(np.prod(shape))
    print(f"# phase 3: {n_entries:.3e} entries ({n_entries * 4 / 1e9:.1f} GB "
          f"f32) in {n_slabs} slabs of {slab2d}: sketched in {stream_s:.2f} s "
          f"(slabs made from the TT on the card included); dual_project "
          f"launches {launches}; to_tt relative error {err:.3e}")
    if launches != n_slabs:
        raise AssertionError(
            f"dual_project launched {launches} times, expected {n_slabs}")
    if not err <= 1e-3:
        raise AssertionError(f"recovery error {err:.3e} > 1e-3")
    for P in container.Psi_cores:
        if not bool(torch.isfinite(P).all()):
            raise AssertionError("non-finite Psi core")

    # Throughput: one resident slab streamed 19 x 3 times (bench.py:92-105).
    slab = slab_fn(0)
    core0 = ld.cores[0]
    left_rest = list(ld.cores[1:])

    def sketch_slab(i, projector="auto"):
        cores = [core0[:, i * s0:(i + 1) * s0, :]] + left_rest
        return dense_stream_sketch_bisect(
            slab, cores, rd.cores, pivot=pivot, projector=projector,
            shape=slab_shape,
        )

    reps = 3
    sketch_slab(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t_host = time.perf_counter()
    for _ in range(reps):
        for i in range(n_slabs):
            sketch_slab(i)
    enqueue_ms = (time.perf_counter() - t_host) * 1e3 / (reps * n_slabs)
    end.record()
    end.synchronize()
    per_rep_s = start.elapsed_time(end) / 1e3 / reps
    ms_per_slab = per_rep_s / n_slabs * 1e3
    gbps = n_entries * 4 / per_rep_s / 1e9
    entries_per_s = n_entries / per_rep_s
    # Where one slab's time goes: the slab step alone, the projection kernel
    # alone on the same operands, and the slab step with two torch.matmul
    # projections instead of the kernel.
    cores3 = [core0[:, 3 * s0:4 * s0, :]] + left_rest
    L2 = prefix_chain_tensor(cores3, pivot + 1).reshape(slab2d[0], -1).contiguous()
    R2 = suffix_chain_tensor(rd.cores, 2).reshape(slab2d[1], -1).contiguous()
    T, U = dual_project(slab, R2, L2)
    T0, U0 = dual_project_reference(slab, R2, L2)
    slab_rel = max(_rel(T, T0), _rel(U, U0))
    print(f"# phase 3: dual_project on a main-path slab vs plain version: "
          f"rel err {slab_rel:.3e} (tol {F32_TOL:g})")
    if not slab_rel <= F32_TOL:
        raise AssertionError(f"dual_project on a slab: rel err {slab_rel:.3e}")
    del T, U, T0, U0
    slab_ms = time_ms(lambda: sketch_slab(3))
    kernel_ms = time_ms(lambda: dual_project(slab, R2, L2))
    matmul_slab_ms = time_ms(lambda: sketch_slab(3, "matmul"))
    print(f"# phase 3: stream {ms_per_slab:.3f} ms/slab, {gbps:.2f} GB/s, "
          f"{entries_per_s:.4e} entries/s; host enqueue {enqueue_ms:.3f} "
          f"ms/slab")
    print(f"# phase 3: one slab {slab_ms:.3f} ms = dual_project "
          f"{kernel_ms:.3f} ms + rest {slab_ms - kernel_ms:.3f} ms; the slab "
          f"with projector='matmul' {matmul_slab_ms:.3f} ms")
    return {"launches": launches, "rel_err": err, "ms_per_slab": ms_per_slab,
            "gbps": gbps, "entries_per_s": entries_per_s,
            "slab_ms": slab_ms, "stream_s": stream_s}


def phase_stream_sketch():
    import torch

    from tt_sketch_torch import DenseTensor, TensorTrain, stream_sketch

    shape = (8, 5, 6, 7)
    tt = TensorTrain.random(shape, 3, seed=0)
    X = DenseTensor(tt.to_dense())
    err_dense = stream_sketch(X, 4, 7, seed=0).to_tt().error(X, relative=True)
    err_tt = stream_sketch(tt, 4, 7, seed=0).to_tt().error(tt, relative=True)
    X2 = DenseTensor(TensorTrain.random(shape, 3, seed=5).to_dense())
    summed = stream_sketch(X, 4, 7, seed=3) + X2
    direct = stream_sketch(DenseTensor(X.data + X2.data), 4, 7, seed=3)
    lin = max(
        float((a - b).abs().max())
        for a, b in zip(summed.Psi_cores + summed.Omega_mats,
                        direct.Psi_cores + direct.Omega_mats)
    )
    print(f"# phase 4: stream_sketch f64 on {X.data.device}: dense error "
          f"{err_dense:.3e}, TT error {err_tt:.3e}, linearity {lin:.3e}")
    if not (err_dense <= 1e-9 and err_tt <= 1e-9):
        raise AssertionError("stream_sketch recovery error above 1e-9")
    if not lin <= 1e-10:
        raise AssertionError(f"sk + more differs from the sum's sketch: {lin}")
    if X.data.device.type != "cuda" or X.data.dtype != torch.float64:
        raise AssertionError("phase 4 did not run in float64 on the card")


# -- sparse slices -------------------------------------------------------------

def _kernel_fns():
    from tt_sketch_torch.kernels import chain_step as CS
    from tt_sketch_torch.kernels import lazy_gaussian as LG
    from tt_sketch_torch.kernels import segment_psi as SG
    from tt_sketch_torch.kernels import sparse_psi as SP
    from tt_sketch_torch.kernels import sparse_sign as SS

    return {
        "lazy_gaussian": (LG.lazy_gaussian, LG.lazy_gaussian_reference),
        "sparse_sign_rows": (SS.sparse_sign_rows,
                             SS.sparse_sign_rows_reference),
        "omega_fused": (SP.omega_fused, SP.omega_fused_reference),
        "psi_omega_merged_slabs": (SP.psi_omega_merged_slabs,
                                   SP.psi_omega_merged_slabs_reference),
        "psi_fused_slabs": (SP.psi_fused_slabs,
                            SP.psi_fused_slabs_reference),
        "psi_window_direct": (SP.psi_window_direct,
                              SP.psi_window_direct_reference),
        "chain_step_t": (CS.chain_step_t, CS.chain_step_t_reference),
        "psi_chunk_slabs": (SP.psi_chunk_slabs,
                            SP.psi_chunk_slabs_reference),
        "psi_chunk_slabs_genright": (SP.psi_chunk_slabs_genright,
                                     SP.psi_chunk_slabs_genright_reference),
        "psi_segment": (SG.psi_segment, SG.psi_segment_reference),
    }


def _call_sites(name):
    """The modules whose name ``name`` the sketches call: the Ψ/Ω functions
    of ``sketch_kernels``; the DRMs that generate their own rows; the TT
    chain, which alone calls the chain kernel."""
    from tt_sketch_torch.drm import (
        sparse_gaussian_drm,
        sparse_sign_drm,
        tensor_train_drm,
    )
    from tt_sketch_torch.kernels import sketch_kernels as K

    return {"lazy_gaussian": (K, sparse_gaussian_drm),
            "sparse_sign_rows": (K, sparse_sign_drm),
            "chain_step_t": (tensor_train_drm,)}.get(name, (K,))


@contextlib.contextmanager
def _patched(mapping):
    """Replace the names of ``mapping`` by its functions, in every module
    that calls them (``_call_sites``), for the duration of the block."""
    saved = [(mod, name, getattr(mod, name)) for name in mapping
             for mod in _call_sites(name)]
    for mod, name, _ in saved:
        setattr(mod, name, mapping[name])
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_kernels():
    """Route the sparse sketches through every kernel's plain version (on
    the same device) instead of the kernel."""
    return _patched({name: plain for name, (_, plain)
                     in _kernel_fns().items()})


def recording(calls):
    """Record into ``calls`` (name -> list of argument tuples) every call
    a sparse sketch makes to the kernels, to the segment reduction and to
    the slab combine; each call runs as it would."""
    def recorder(name, fn):
        def call(*args):
            calls.setdefault(name, []).append(args)
            return fn(*args)
        return call

    return _patched({name: recorder(name, getattr(_call_sites(name)[0], name))
                     for name in RECORDED})


def _sass(library, kernel):
    """The instructions ``[(address, text)]`` of ``kernel`` in the built
    ``library`` (``cuobjdump -sass``), with helpers ``op(text)`` (the
    opcode, past a predicate) and ``target(text)`` (the index of a branch's
    destination)."""
    import re
    from pathlib import Path

    from tt_sketch_torch.kernels import cuda_build

    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(cuda_build._target(library))],
        capture_output=True, text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ")
                if kernel in f.splitlines()[0])
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body)]
    at = {a: i for i, (a, _) in enumerate(ins)}

    def op(t):
        return t.split()[1] if t.startswith("@") else t.split()[0]

    def target(t):
        return at[int(t.split("0x")[-1], 16)]

    return ins, op, target


def sass_ops_per_sample():
    """Instructions the built ``lazy_gaussian`` kernel issues per DRM
    sample, counted in its SASS (``cuobjdump -sass``): one walk of the
    sample loop from its head to its back branch that skips the erfinv
    tail block (the one computing sqrtf, ``MUFU.RSQ``; ~0.3 % of samples),
    divided by the stores it passed.  The count includes the loop's own
    bookkeeping and the store."""
    ins, op, target = _sass("lazy_gaussian", "lazy_gaussian_kernel")

    def stores(lo, hi):
        return sum(op(t).startswith("STG") for _, t in ins[lo:hi])

    loops = [(i, target(t)) for i, (_, t) in enumerate(ins)
             if op(t) == "BRA" and target(t) < i]
    back, head = max(loops, key=lambda bh: stores(bh[1], bh[0] + 1))
    i, n, n_st = head, 0, 0
    while True:
        n += 1
        n_st += stores(i, i + 1)
        t = ins[i][1]
        if i == back:
            break
        if op(t) == "BRA":
            j = target(t)
            if j <= i:
                raise AssertionError(f"unexpected back branch in the sample "
                                     f"loop at {ins[i][0]:#x}")
            if not t.startswith("@") or any(
                    op(u) == "MUFU.RSQ" for _, u in ins[i + 1:j]):
                i = j
                continue
        i += 1
    if n_st == 0:
        raise AssertionError("no store in the lazy_gaussian sample loop")
    print(f"# phase 1: lazy_gaussian SASS: {n} instructions for {n_st} "
          f"samples per loop trip on the common path = {n / n_st:g} per "
          f"sample")
    return n / n_st


def _sign_loops():
    """The loops of the shared-memory sign kernel (``sparse_sign_kernel``),
    kept rolled (``#pragma unroll 1``), as ``[(kind, instructions per
    trip)]``: the loop that stores to global memory is the output loop, the
    one that reads global memory the per-block salt copy, the two that
    multiply (the 64-bit hash) the sign pass and the longer shuffle pass,
    the remaining one zeroes the empty slots."""
    ins, op, target = _sass("sparse_sign", "sparse_sign_kernel")
    loops = sorted((target(t), i) for i, (_, t) in enumerate(ins)
                   if op(t) == "BRA" and target(t) < i)
    out = []
    for head, back in loops:
        ops = [op(t) for _, t in ins[head:back + 1]]
        if any(o.startswith("STG") for o in ops):
            kind = "out"
        elif any(o.startswith("LDG") for o in ops):
            kind = "salt copy"
        elif sum(o.startswith("IMAD") for o in ops) >= 4:
            kind = "hash"
        else:
            kind = "slot"
        out.append((kind, len(ops)))
    return out


def sass_sign_ops():
    """The charge per draw of a sparse-sign column in the sparse bounds,
    ``SIGN_DRAW_OPS``, with phase 1's census of the built ``sparse_sign``
    kernels beside it (diagnostics; they do not move the bound).

    The shared-memory instance (ranks above 32): its loops, with its
    shuffle pass (the longer hashing loop, one hash, the swap position and
    the swap), the trip the charge was counted on.  Each register instance
    ``sparse_sign_regs<RB>`` (ranks up to RB = 16, 32; unrolled, so counted
    statically): asserted to use no local memory (no ``LDL``/``STL``) and to
    hash each draw once (the 64-bit multiplies, ``IMAD.WIDE.U32``, from the
    salt barrier to the first output store: two a hash, asserted fewer
    than three a draw); its instructions per draw are those of that
    stretch, both passes at nnz = RB, over RB."""
    loops = _sign_loops()
    print(f"# phase 1: sparse_sign SASS, shared-memory instance, loops "
          f"(kind, instructions per trip): "
          f"{', '.join(f'{k} {n}' for k, n in loops)}")
    hashing = [n for k, n in loops if k == "hash"]
    if len(hashing) != 2:
        raise AssertionError(f"sparse_sign SASS: expected two hashing loops "
                             f"(sign pass, shuffle pass) in the shared-memory "
                             f"instance, found {loops}")
    for rb in (16, 32):
        ins, op, _ = _sass("sparse_sign", f"sparse_sign_regsILi{rb}E")
        ops = [op(t) for _, t in ins]
        local = [o for o in ops if o.startswith(("LDL", "STL"))]
        if local:
            raise AssertionError(f"sparse_sign_regs<{rb}> uses local memory: "
                                 f"{local[:4]}")
        bar = next(i for i, o in enumerate(ops) if o.startswith("BAR"))
        first_st = next(i for i, o in enumerate(ops) if o.startswith("STG"))
        passes = ops[bar + 1:first_st]
        wide = sum(o == "IMAD.WIDE.U32" for o in passes)
        if wide >= 3 * rb:
            raise AssertionError(f"sparse_sign_regs<{rb}>: {wide} 64-bit "
                                 f"multiplies for {rb} draws: more than one "
                                 f"hash a draw")
        stores = sum(o.startswith("STG") for o in ops)
        print(f"# phase 1: sparse_sign SASS, register instance RB={rb}: "
              f"{len(ops)} instructions, no local memory, {wide} "
              f"IMAD.WIDE.U32 in the passes ({wide / (2 * rb):.2f} hashes a "
              f"draw), "
              f"{len(passes) / rb:.1f} instructions per draw (both passes at "
              f"nnz = {rb}), {stores} output stores "
              f"({(len(ops) - first_st) / rb:.1f} instructions a slot from "
              f"the first store on)")
    print(f"# phase 1: sparse_sign: the bounds charge {SIGN_DRAW_OPS} "
          f"instructions per draw (fixed; the shared-memory instance's "
          f"shuffle trip is {max(hashing)} today, its sign pass's second "
          f"hash {min(hashing)})")
    return SIGN_DRAW_OPS


def sass_projection_census():
    """Per instance of the projection kernel (``dual_project_kernel<BF16,
    WANT_T, WANT_U>``), its SASS instructions, tensor-core products (HMMA)
    and shared-memory loads, counted statically in the built library: the
    loops over a column tile are unrolled, so the ratio is the
    instructions a warp issues per product."""
    census = {}
    for bf16 in (0, 1):
        for want_t, want_u, label in ((1, 1, "dual"), (1, 0, "T"),
                                      (0, 1, "U")):
            ins, op, _ = _sass("dual_project", f"dual_project_kernelILb{bf16}"
                                               f"ELb{want_t}ELb{want_u}E")
            ops = [op(t) for _, t in ins]
            hmma = sum(o.startswith("HMMA") for o in ops)
            lds = sum(o.startswith("LDS") for o in ops)
            tag = f"{label}-{'bf16' if bf16 else 'f32'}"
            census[tag] = {"instructions": len(ops), "hmma": hmma,
                           "shared_loads": lds}
            print(f"# phase 1: dual_project SASS {tag}: {len(ops)} "
                  f"instructions, {hmma} HMMA, {lds} shared-memory loads "
                  f"({len(ops) / max(hmma, 1):.2f} instructions per HMMA)")
    return census


def _side_cost(flat, salts, spec, ops):
    """(rows, salts, instructions per nnz to generate them) of one side of
    a fused kernel; a missing side is one row of ones."""
    if flat is None:
        return 1, 0, 0
    if spec[0] == "s":
        _, _, nnz, _, r_out = spec
        return r_out, nnz, ops["sign_draw"] * nnz
    return salts.shape[0], salts.shape[0], ops["gauss"] * salts.shape[0]


def sparse_bound(name, args, ops):
    """(bound ms, bound_by) of one kernel call: each input read once, each
    output written once, over 3.35 TB/s; the generators' instructions
    (``ops``: counted in the built SASS) per hashed Gaussian sample or per
    draw of a sign column (one hash, its swap position and the swap; empty
    slots and the copy to the output cost bytes only) plus one multiply per weighted row and one FMA per contracted product,
    over the CUDA cores' lane-instruction rate.  A window plan's pads are
    read (bytes) but hash and contract nothing (operations)."""
    if name == "lazy_gaussian":
        flat, salts = args
        N, R = flat.shape[0], salts.shape[0]
        nbytes = 8 * N + 8 * R + 4 * R * N
        n_ops = ops["gauss"] * R * N
    elif name == "sparse_sign_rows":
        flat, salts, rank, nnz, rank_min, rank_max = args
        N, R = flat.shape[0], rank_max - rank_min
        nbytes = 8 * N + 8 * nnz + 4 * R * N
        n_ops = ops["sign_draw"] * nnz * N
    elif name == "chain_step_t":
        # state read, index read, output written, the core read once; one
        # FMA per (i, k) and nonzero
        state, core, idx = args
        r1, n, r2 = core.shape
        N = idx.shape[0]
        nbytes = (4 * (0 if state is None else r1) * N + 8 * N + 4 * r2 * N
                  + 4 * r1 * n * r2)
        n_ops = (0 if state is None else r1 * r2) * N
    elif name in ("psi_chunk_slabs", "psi_chunk_slabs_genright"):
        # given rows are read (4 bytes each) and not hashed; a missing side
        # costs nothing
        if name == "psi_chunk_slabs":
            loc, se, sl, sr, nc, span, chunk = args
            r2, s2, g2 = (1, 0, 0) if sr is None else (sr.shape[0], 0, 0)
            right_bytes = 0 if sr is None else 4 * r2 * se.shape[0]
        else:
            loc, se, sl, rflat, rsalts, nc, span, chunk, rspec = args
            r2, s2, g2 = _side_cost(rflat, rsalts, rspec, ops)
            right_bytes = 8 * se.shape[0] + 8 * s2
        N = se.shape[0]
        r1 = 1 if sl is None else sl.shape[0]
        nbytes = (4 * loc.shape[0] + 4 * N
                  + (0 if sl is None else 4 * r1 * N) + right_bytes
                  + 4 * nc * span * r1 * r2)
        n_ops = (g2 + r1 + r1 * r2) * N
    elif name == "psi_segment":
        # indices, entries and given rows read, Ψ written; per nonzero one
        # multiply per weighted left row and one FMA per rank pair
        left, right, ent, idx, n_mu = args
        N = ent.shape[0]
        r1 = 1 if left is None else left.shape[0]
        r2 = 1 if right is None else right.shape[0]
        nbytes = (8 * N + 4 * N + 4 * (0 if left is None else r1) * N
                  + 4 * (0 if right is None else r2) * N + 4 * n_mu * r1 * r2)
        n_ops = ((0 if left is None else r1) + r1 * r2) * N
    elif name == "omega_fused":
        e, lflat, rflat, lsalts, rsalts, lspec, rspec = args
        N = e.shape[0]
        r1, s1, g1 = _side_cost(lflat, lsalts, lspec, ops)
        r2, s2, g2 = _side_cost(rflat, rsalts, rspec, ops)
        nbytes = 20 * N + 8 * (s1 + s2) + 4 * r1 * r2
        n_ops = (g1 + g2 + r1 + r1 * r2) * N
    else:
        oflat = osalts = ospec = None
        n_out = None
        if name == "psi_fused_slabs":
            (loc, se, lflat, rflat, lsalts, rsalts, nc, span, chunk, lspec,
             rspec) = args
        elif name == "psi_omega_merged_slabs":
            (loc, se, lflat, rflat, oflat, lsalts, rsalts, osalts, nc, span,
             chunk, lspec, rspec, ospec) = args
        else:
            (win, first, loc, se, lflat, rflat, lsalts, rsalts, nc, span,
             chunk, nw, lspec, rspec) = args
            n_out = nw * span
        n_read = se.shape[0]
        # the nnz that hash and contract: a window plan's pads do not
        N = n_read if n_out is None else int((loc < span).sum())
        r1, s1, g1 = _side_cost(lflat, lsalts, lspec, ops)
        r2, s2, g2 = _side_cost(rflat, rsalts, rspec, ops)
        n_flat = (lflat is not None) + (rflat is not None)
        nbytes = (4 * loc.shape[0] + 4 * n_read + 8 * n_flat * n_read
                  + 8 * (s1 + s2)
                  + 4 * (nc * span if n_out is None else n_out) * r1 * r2)
        if n_out is not None:
            nbytes += 8 * nc
        n_ops = (g1 + g2 + r1 + r1 * r2) * N
        if oflat is not None:
            r1o, so, go = _side_cost(oflat, osalts, ospec, ops)
            nbytes += 8 * n_read + 8 * so + 4 * r1o * r2
            n_ops += (go + r1o + r1o * r2) * N
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_LANE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _compare(name, label, got, ref, phase=6):
    """(max abs err, rel err) of a kernel's outputs against its plain
    version's; raises past the tolerance.  Sparse-sign rows must be equal
    bit for bit."""
    import torch

    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    rel = max(_rel(g, r) for g, r in zip(got, ref))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    if name == "sparse_sign_rows":
        ok = all(torch.equal(g, r) for g, r in zip(got, ref))
        tol = "bit for bit"
    elif name == "lazy_gaussian":
        ok, tol = abs_err <= ROWS_TOL, f"abs tol {ROWS_TOL:g}"
    elif name == "chain_step_t":
        ulp = max(float(r.abs().max()) for r in ref) * 2.0 ** -23
        ok = abs_err <= CHAIN_ULPS * ulp
        tol = (f"{abs_err / ulp if ulp else 0.0:.2f} ulps of the largest "
               f"value, tol {CHAIN_ULPS}")
    elif name == "psi_segment" and got[0].dtype == torch.float64:
        ok, tol = rel <= SEG_F64_TOL, f"rel tol {SEG_F64_TOL:g}"
    else:
        ok, tol = rel <= PSI_TOL, f"rel tol {PSI_TOL:g}"
    print(f"# phase {phase}: {name} {label}: max abs err {abs_err:.3e}, rel "
          f"err {rel:.3e} ({tol}), finite {finite}")
    if not (ok and finite):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{label}")
    return abs_err, rel


def _check(name, label, args, phase=6):
    """One kernel call against its plain version on the same operands."""
    import torch

    kern, plain = _kernel_fns()[name]
    got = _as_tuple(kern(*args))
    ref = _as_tuple(plain(*args))
    torch.cuda.synchronize()
    return _compare(name, label, got, ref, phase)


#: the kernels that are instances of csrc/sparse_psi.cu's block program
SPARSE_PSI_INSTANCES = ("psi_omega_merged_slabs", "omega_fused",
                        "psi_fused_slabs", "psi_window_direct",
                        "psi_chunk_slabs", "psi_chunk_slabs_genright")


def _same_bits(name, label, args, phase=6):
    """Two calls of a kernel on the same operands give the same bits (no
    atomics: each output is summed by one thread, or in a fixed order)."""
    import torch

    kern = _kernel_fns()[name][0]
    a, b = _as_tuple(kern(*args)), _as_tuple(kern(*args))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"# phase {phase}: {name} {label}: two calls give the same bits: "
          f"{same}")
    if not same:
        raise AssertionError(f"{name} gives other bits on a second call at "
                             f"{label}")


def _high_flats(args, offset):
    """The same call with every flat index stream shifted by ``offset``
    (mod 2^64), which puts them above 2^63."""
    import torch

    def shift(a):
        if isinstance(a, torch.Tensor) and a.dtype == torch.int64 \
                and a.ndim == 1 and a.shape[0] > 1 << 16:
            return a + offset
        return a

    return tuple(shift(a) for a in args)


def _ragged_case(ltype, rtype):
    """A small tensor whose nnz is not a multiple of the chunk, with a
    chunk that is not a multiple of the kernels' tile, odd ranks, and one
    unplanned mode (so the row generators and all three slab kernels
    run)."""
    import torch

    from tt_sketch_torch.formats import SparseTensor

    rng = np.random.default_rng(3)
    shape = (13, 7, 150, 101)
    nnz = 40_009
    idx = np.stack([rng.integers(0, n, nnz) for n in shape])
    ent = rng.standard_normal(nnz).astype(np.float32)
    t = SparseTensor(shape, idx, ent, device="cuda").with_psi_plan(
        indices=idx, entries=ent, threshold=10, chunk=1000)
    ldrm = ltype(7, shape, transpose=False, seed=11, dtype=torch.float32,
                 device="cuda")
    rdrm = rtype(13, shape, transpose=True, seed=12, dtype=torch.float32,
                 device="cuda")
    return t, ldrm, rdrm


def phase_sparse_kernels(paths, ops):
    """Each sparse kernel against its plain version at the calls the main
    paths made (``paths``: label -> measurements with the recorded
    ``calls``), at ragged sketches' calls and with flat indices above 2^63;
    times and bounds of the main paths' calls."""
    import torch

    from tt_sketch_torch import (
        SparseGaussianDRM,
        SparseSignDRM,
        stream_sketch,
    )
    from tt_sketch_torch.kernels.lazy_gaussian import hash_bits
    from tt_sketch_torch.rng.hash_rng import drm_salts, hash_int, hash_int_np

    # the bare 64-bit hash, bit for bit, including values above 2^63
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randint(-(1 << 62), 1 << 62, (1 << 20,), generator=g,
                      device="cuda", dtype=torch.int64) * 2 + 1
    x[:4] = torch.tensor([0, -1, 30787972, -(1 << 63)], device="cuda")
    hb = hash_bits(x)
    same_dev = bool((hb == hash_int(x)).all())
    xs = x[:4096].cpu().numpy()
    same_host = bool((hb[:4096].cpu().numpy().view(np.uint64)
                      == hash_int_np(xs.view(np.uint64))).all())
    print(f"# phase 6: hash64 kernel vs plain int64 hash on the card: "
          f"{'equal' if same_dev else 'DIFFERENT'} over {x.shape[0]} "
          f"values; vs numpy uint64 on the host: "
          f"{'equal' if same_host else 'DIFFERENT'}")
    if not (same_dev and same_host):
        raise AssertionError("the 64-bit hash kernel disagrees bit for bit")

    cases = [(label, m["calls"]) for label, m in paths.items()]
    ragged = {}
    for tag, lt, rt in (("gauss", SparseGaussianDRM, SparseGaussianDRM),
                        ("sign", SparseSignDRM, SparseSignDRM),
                        ("sign x gauss", SparseSignDRM, SparseGaussianDRM),
                        ("gauss x sign", SparseGaussianDRM, SparseSignDRM)):
        rt_, rl, rr = _ragged_case(lt, rt)
        calls = {}
        with recording(calls):
            stream_sketch(rt_, rl.rank, rr.rank, left_drm=rl, right_drm=rr,
                          dtype=torch.float32)
        ragged[tag] = (rt_, rl, rr)
        cases.append((f"ragged {tag}", calls))
    for label in ("uber gauss", "uber sign", "lbnl sign"):
        # the segment reduction takes mode indices, not flat ones
        high = {n: [_high_flats(a, -(1 << 63) + 12345)
                    for a in paths[label]["calls"].get(n, [])]
                for n in SPARSE_KERNELS if n != "psi_segment"}
        cases.append((f"{label} flats>2^63", high))
    # the u24 = 2^24-1 input: salt + flat == 30787972 hashes to the top
    # quantile (the extreme is finite only if x is formed in int32)
    salts = paths["uber gauss"]["calls"]["lazy_gaussian"][0][1]
    top = torch.full((1,), 30787972, dtype=torch.int64, device="cuda") - \
        salts[:1]
    cases.append(("u24=2^24-1", {"lazy_gaussian": [(top, salts[:1])]}))

    worst = {}
    for label, calls in cases:
        for name in SPARSE_KERNELS:
            for i, args in enumerate(calls.get(name, [])):
                a, r = _check(name, f"{label} call {i}", args)
                if label in paths:
                    m = worst.setdefault((name, label), [0.0, 0.0])
                    m[0], m[1] = max(m[0], a), max(m[1], r)
                    if name in SPARSE_PSI_INSTANCES[:4] + (
                            "chain_step_t", "psi_segment",
                            "sparse_sign_rows"):
                        _same_bits(name, f"{label} call {i}", args)

    # the variants no sketch above launches: Ψ with both sides and without
    # a left side, merged without a left side, each with Gaussian, sign,
    # mixed and sliced-sign sides
    rt_, rl, rr = ragged["gauss"]
    p = rt_.psi_plan[2]
    d = len(rt_.shape)
    g7, g13, g7o = rl.salts(1), rr.salts(d - 2 - 2), rl.salts(2)
    s7 = (("s", 7, 7, 0, 7), drm_salts(0, 7, 21, device="cuda"))
    s13 = (("s", 13, 5, 0, 13), drm_salts(0, 5, 22, device="cuda"))
    s5of9 = (("s", 9, 4, 3, 5), drm_salts(0, 4, 23, device="cuda"))
    geom = (p.n_chunks, p.span, p.chunk)
    for tag, (ls, lsalt), (rs, rsalt), (os_, osalt) in (
            ("gauss", (GAUSS, g7), (GAUSS, g13), (GAUSS, g7o)),
            ("sign", s7, s13, s5of9),
            ("sign x gauss", s5of9, (GAUSS, g13), s7),
            ("gauss x sign", (GAUSS, g7), s5of9, (GAUSS, g7o))):
        extra = [
            ("psi_fused_slabs", (p.local_idx, p.sorted_entries, p.flat_left,
                                 p.flat_right, lsalt, rsalt, *geom, ls, rs)),
            ("psi_fused_slabs", (p.local_idx, p.sorted_entries, None,
                                 p.flat_right, None, rsalt, *geom, GAUSS,
                                 rs)),
            ("psi_fused_slabs", (p.local_idx, p.sorted_entries, p.flat_left,
                                 None, lsalt, None, *geom, ls, GAUSS)),
            ("psi_omega_merged_slabs", (
                p.local_idx, p.sorted_entries, p.flat_left, p.flat_right,
                p.flat_left_om, lsalt, rsalt, osalt, *geom, ls, rs, os_)),
            ("psi_omega_merged_slabs", (
                p.local_idx, p.sorted_entries, None, p.flat_right,
                p.flat_left_om, None, rsalt, osalt, *geom, GAUSS, rs, os_)),
            ("omega_fused", (p.sorted_entries, p.flat_left_om, p.flat_right,
                             osalt, rsalt, os_, rs)),
        ]
        for name, args in extra:
            _check(name, f"ragged variant {tag}", args)

    # more micro-tiles than half the block's threads (one thread group),
    # and more than the block's threads (passes over the range)
    for r1_, r2_ in ((16, 40), (30, 40)):
        gl_, gr_, go_ = (drm_salts(0, r, sd, device="cuda")
                         for r, sd in ((r1_, 26), (r2_, 27), (r1_, 28)))
        label = f"gauss {r1_} x {r2_}"
        for name, args in (
                ("psi_omega_merged_slabs", (
                    p.local_idx, p.sorted_entries, p.flat_left, p.flat_right,
                    p.flat_left_om, gl_, gr_, go_, *geom, GAUSS, GAUSS,
                    GAUSS)),
                ("psi_fused_slabs", (p.local_idx, p.sorted_entries,
                                     p.flat_left, p.flat_right, gl_, gr_,
                                     *geom)),
                ("omega_fused", (p.sorted_entries, p.flat_left_om,
                                 p.flat_right, go_, gr_))):
            _check(name, label, args)
            _same_bits(name, label, args)

    # the rank limit of sign sides: the most rows a block's shared memory
    # holds run and agree; one more raises before the launch
    def wide(rank):
        return (p.local_idx, p.sorted_entries, p.flat_left, p.flat_right,
                drm_salts(0, rank, 24, device="cuda"),
                drm_salts(0, 433, 25, device="cuda"), *geom,
                ("s", rank, rank, 0, 3), ("s", 433, 433, 430, 3))

    _check("psi_fused_slabs", "sign sides of rank 433 + 433", wide(433))

    try:
        _kernel_fns()["psi_fused_slabs"][0](*wide(434))
    except ValueError as exc:
        print(f"# phase 6: sign sides of rank 434 + 433 raise: {exc}")
    else:
        raise AssertionError("sign sides past the shared-memory limit did "
                             "not raise")

    return path_figures(paths, worst, ops)


def path_figures(paths, worst, ops, phase=6):
    """Each kernel's launches of one sketch, per main path that launches
    it: their time, their plain versions' time and their bound, beside the
    worst errors ``worst[(name, label)]`` of their checks."""
    fns = _kernel_fns()
    res = {}
    for name in SPARSE_KERNELS:
        kern, plain = fns[name]
        res[name] = {}
        for label in paths:
            calls = paths[label]["calls"].get(name, [])
            if not calls:
                continue
            ms = time_ms(lambda: [kern(*a) for a in calls])
            plain_ms = time_ms(lambda: [plain(*a) for a in calls], reps=3,
                               warmup=1)
            bounds = [sparse_bound(name, a, ops) for a in calls]
            b_ms, b_by = sum(b for b, _ in bounds), max(bounds)[1]
            abs_err, rel_err = worst[(name, label)]
            res[name][label] = {
                "launches": len(calls), "max_abs_err": abs_err,
                "max_rel_err": rel_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by}
            lib = ""
            if name == "psi_segment":
                lib_ms = segment_library_ms(calls)
                res[name][label]["library_ms"] = lib_ms
                lib = (f", library index_add_ over the outer products "
                       f"{lib_ms:.3f} ms")
            print(f"# phase {phase}: {name}: {len(calls)} launch(es) of one "
                  f"{label} sketch in {ms:.3f} ms (bound {b_ms:.3f} ms by "
                  f"{b_by}; {ms / b_ms:.2f}x the bound), plain version "
                  f"{plain_ms:.3f} ms{lib}")
            if name == "chain_step_t":
                res[name][label]["per_launch"] = chain_launches(
                    label, calls, paths[label]["shape"], ops, phase)
    return res


def segment_case(n_mu, r1, r2, nnz, runs=None, dtype="float32", seed=9):
    """Operands of ``psi_segment`` on the card: Gaussian sides (``None``:
    absent) and entries, and indices drawn at random (``runs`` None),
    sorted (``runs="sorted"``: equal runs in increasing row order) or in
    runs of ``runs`` nonzeros on average (2/3 to 4/3 of it) over rows drawn
    at random."""
    import torch

    dtype = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rows(r):
        return None if r is None else torch.randn(
            (r, nnz), generator=g, device="cuda", dtype=dtype)

    if runs is None:
        idx = torch.randint(0, n_mu, (nnz,), generator=g, device="cuda")
    elif runs == "sorted":
        idx = torch.arange(nnz, device="cuda") * n_mu // nnz
    else:
        lengths = torch.randint(2 * runs // 3, 4 * runs // 3 + 1,
                                (nnz // runs + 2,), generator=g,
                                device="cuda")
        rows_ = torch.randint(0, n_mu, lengths.shape, generator=g,
                              device="cuda")
        idx = torch.repeat_interleave(rows_, lengths)[:nnz]
    return (rows(r1), rows(r2),
            torch.randn(nnz, generator=g, device="cuda", dtype=dtype),
            idx, n_mu)


#: ``psi_segment`` at shapes no sketch gives it: (label, segment_case
#: arguments, timed).  uber's two segment shapes (3,309,696 nonzeros) with
#: their indices in runs and at random; a Ψ of the most values the kernel
#: takes (float32 and float64: two tiles of bins); no sides; one row;
#: runs that cross the blocks' ranges with an index outside the mode in
#: one of them
SEGMENT_SHAPES = (
    ("183 rows x 20, sorted", (183, None, 20, 3_309_696, "sorted"), True),
    ("183 rows x 20, random", (183, None, 20, 3_309_696), True),
    ("24 rows x 10 x 20, runs of 2600", (24, 10, 20, 3_309_696, 2600), True),
    ("24 rows x 10 x 20, random", (24, 10, 20, 3_309_696), True),
    ("81 rows x 10 x 20", (81, 10, 20, 300_001), False),
    ("81 rows x 10 x 20, runs of 5000", (81, 10, 20, 300_001, 5000), False),
    ("512 rows x 4 x 8, float64", (512, 4, 8, 100_003, None, "float64"),
     False),
    ("24 rows x 4 x 8, float64, runs of 700",
     (24, 4, 8, 100_002, 700, "float64"), False),
    ("183 rows, no sides", (183, None, None, 50_001), False),
    ("one row x 3 x 5", (1, 3, 5, 1000), False),
    ("7 rows x 16 x 40, runs of 3000", (7, 16, 40, 200_000, 3000), False),
)


def phase_segment_shapes():
    """``psi_segment`` against its plain version at ``SEGMENT_SHAPES``, with
    an index outside the mode inside a run of the run-structured cases;
    the same bits from a second call; the timed cases' ms alone and ten
    back to back, beside their bound."""
    import torch

    res = {}
    for label, case, timed in SEGMENT_SHAPES:
        args = segment_case(*case)
        if len(case) > 4 and case[4] is not None:
            idx = args[3]
            idx[idx.shape[0] // 3] = case[0]  # outside [0, n_mu): dropped
            idx[idx.shape[0] // 2] = -1
        _check("psi_segment", label, args)
        _same_bits("psi_segment", label, args)
        if not timed:
            continue
        kern = _kernel_fns()["psi_segment"][0]
        one = time_ms(lambda: kern(*args))
        b2b = time_ms(lambda: [kern(*args) for _ in range(10)]) / 10
        bound = sparse_bound("psi_segment", args, {})[0]
        res[label] = {"ms": one, "b2b_ms": b2b, "bound_ms": bound}
        print(f"# phase 6: psi_segment {label}: {one:.3f} ms alone, "
              f"{b2b:.3f} ms back to back (bound {bound:.3f} ms by bytes; "
              f"{b2b / bound:.2f}x)")
        del args
        torch.cuda.empty_cache()
    return res


def chain_launches(label, calls, shape, ops, phase=6):
    """Each recorded ``chain_step_t`` launch of one sketch on its own
    line: the mode (found by its size), ``n``, the ranks, where the core
    lives (``chain_schedule``), its time alone (the card waits for the
    host's wrapper, as in a sketch) and over ten calls back to back (the
    kernels' time), its bound and both ratios, and the bytes of core rows
    the kernel gathers (a row of the padded layout per nonzero inside the
    mode)."""
    from tt_sketch_torch.kernels.chain_step import chain_schedule

    kern = _kernel_fns()["chain_step_t"][0]
    out = []
    for i, args in enumerate(calls):
        state, core, idx = args
        r1, n, r2 = core.shape
        sched = chain_schedule(n, r1, r2, state is None)
        ms = time_ms(lambda: kern(*args))
        b2b = time_ms(lambda: [kern(*args) for _ in range(10)]) / 10
        b_ms, b_by = sparse_bound("chain_step_t", args, ops)
        inside = int(((idx >= 0) & (idx < n)).sum())
        gathered = 4 * sched.row * inside
        mode = shape.index(n) if shape.count(n) == 1 else "?"
        print(f"# phase {phase}: chain_step_t {label} call {i}: mode {mode}, "
              f"n {n}, ranks {'-' if state is None else r1} -> {r2}, core in "
              f"{sched.place}: {ms:.3f} ms alone, {b2b:.3f} ms back to back, "
              f"bound {b_ms:.3f} ms by {b_by} ({ms / b_ms:.2f}x, "
              f"{b2b / b_ms:.2f}x), {gathered / 1e6:.1f} MB of core rows "
              f"gathered")
        out.append({"call": i, "mode": mode, "n": n, "r1": r1, "r2": r2,
                    "first": state is None, "place": sched.place,
                    "ms": ms, "back_to_back_ms": b2b, "bound_ms": b_ms,
                    "gathered_bytes": gathered})
    return out


def sign_row_cases():
    """``[(label, args)]``: ``sparse_sign_rows`` at the shapes no sketch
    gives it: odd N, fewer non-zeros than slots, rank slices, flats above
    2^63, both sides of each rank bucket's edge (16 | 17, 32 | 33: the
    register instances and the shared-memory one) and ranks above 4096."""
    import torch

    from tt_sketch_torch.rng.hash_rng import drm_salts

    g = torch.Generator(device="cuda").manual_seed(9)

    def flats(n, high=False):
        f = torch.randint(0, 1 << 62, (n,), generator=g, device="cuda",
                          dtype=torch.int64)
        return f - (1 << 63) if high else f  # bit patterns above 2^63

    cases = [
        ("ragged N=100003, rank 10", flats(100_003), 10, 10, 0, 10),
        ("3 non-zeros over 20 slots", flats(70_001), 20, 3, 0, 20),
        ("slice [5, 13) of 20", flats(70_001), 20, 20, 5, 13),
        ("slice [9, 17) of 17, 4 non-zeros", flats(33_333), 17, 4, 9, 17),
        ("flats above 2^63", flats(70_001, high=True), 10, 10, 0, 10),
        ("rank 5000 > 4096, 3 non-zeros", flats(4_099), 5000, 3, 0, 5000),
        ("rank 5500 > 4096, 40 non-zeros, slice", flats(2_051), 5500, 40,
         4090, 4130),
        ("one column, rank 1", flats(1), 1, 1, 0, 1),
    ]
    for rank in (16, 17, 32, 33):
        cases += [
            (f"rank {rank}", flats(65_537), rank, rank, 0, rank),
            (f"rank {rank}, {rank // 2} non-zeros", flats(65_539), rank,
             rank // 2, 0, rank),
            (f"rank {rank}, slice [{rank - 9}, {rank}), {rank - 2} "
             f"non-zeros, flats above 2^63", flats(50_021, high=True), rank,
             rank - 2, rank - 9, rank),
        ]
    return [(label, (flat, drm_salts(0, nnz, 1000 + seed, device="cuda"),
                     rank, nnz, lo, hi))
            for seed, (label, flat, rank, nnz, lo, hi) in enumerate(cases)]


def phase_sign_rows():
    """``sparse_sign_rows`` against its plain version bit for bit at
    ``sign_row_cases``, and the same bits from two calls of each."""
    for label, args in sign_row_cases():
        _check("sparse_sign_rows", label, args, phase=7)
        _same_bits("sparse_sign_rows", label, args, phase=7)


def load_lbnl_host():
    """lbnl-synthetic's host arrays ``(shape, indices, entries)``."""
    with np.load("data/lbnl-synthetic.npz") as data:
        return (tuple(int(s) for s in data["shape"]), data["indices"],
                data["entries"].astype(np.float32))


def phase_window_kernel():
    """``psi_window_direct`` where no main path reaches it: the two-sided
    variant at lbnl's scale (modes rolled so that the 868131-row mode is
    interior), and every combination of sides at a small skewed shape with
    empty and multi-chunk windows."""
    import torch

    from tt_sketch_torch import (
        SparseGaussianDRM,
        SparseSignDRM,
        stream_sketch,
    )
    from tt_sketch_torch.formats import SparseTensor
    from tt_sketch_torch.kernels.sparse_plan import (
        WindowPlan,
        build_window_plan,
    )
    from tt_sketch_torch.rng.hash_rng import drm_salts

    # 1. lbnl with the giant mode interior: modes (3, 4, 0, 1, 2)
    shape, idx, ent = load_lbnl_host()
    order = (3, 4, 0, 1, 2)
    shape = tuple(shape[m] for m in order)
    idx = np.ascontiguousarray(idx[list(order)])
    t = SparseTensor(shape, idx, ent, device="cuda").with_psi_plan(
        indices=idx, entries=ent)
    if not isinstance(t.psi_plan[1], WindowPlan):
        raise AssertionError(f"rolled lbnl plans {t.psi_plan}")
    for tag, lt, rt in (("gauss", SparseGaussianDRM, SparseGaussianDRM),
                        ("sign x gauss", SparseSignDRM, SparseGaussianDRM)):
        calls = {}
        with recording(calls):
            stream_sketch(t, 10, 20, seed=3, left_drm_type=lt,
                          right_drm_type=rt, dtype=torch.float32)
        (args,) = calls["psi_window_direct"]
        if args[4] is None or args[5] is None:
            raise AssertionError("the rolled sketch's window call is not "
                                 "two-sided")
        _check("psi_window_direct",
               f"lbnl rolled to {shape}, two-sided, {tag}", args, phase=8)
    del t, calls, args
    torch.cuda.empty_cache()

    # 2. a small skewed mode: hot rows (windows of several chunks), a gap
    # (empty windows), span 32, chunk 128
    rng = np.random.default_rng(23)
    shape, nnz, mu = (11, 9, 3000, 25), 60_007, 2
    idx = np.stack([rng.integers(0, s, nnz) for s in shape])
    idx[mu] = np.where(rng.random(nnz) < 0.5, rng.integers(0, 40, nnz),
                       rng.integers(2500, 3000, nnz))
    ent = rng.standard_normal(nnz).astype(np.float32)
    p = build_window_plan(idx[mu], shape[mu], span=32, chunk=128,
                          full_indices=idx, mu=mu, shape=shape, entries=ent,
                          device="cuda")
    per_window = np.bincount(p.chunk_window.cpu().numpy(),
                             minlength=p.n_windows)
    occupied = np.unique(idx[mu] // p.span).shape[0]
    print(f"# phase 8: skewed mode of {shape[mu]} rows, {nnz} nnz: {p}, "
          f"{p.n_windows - occupied} empty windows, longest window "
          f"{per_window.max()} chunks")
    if not (per_window.max() > 1 and occupied < p.n_windows):
        raise AssertionError("the skewed case lacks empty or multi-chunk "
                             "windows")
    sides = {
        "gauss": (GAUSS, lambda s: drm_salts(0, 7, s, device="cuda")),
        "sign": (("s", 9, 9, 0, 9),
                 lambda s: drm_salts(0, 9, s, device="cuda")),
        "sign few": (("s", 13, 3, 0, 13),
                     lambda s: drm_salts(0, 3, s, device="cuda")),
        "sign slice": (("s", 9, 4, 3, 5),
                       lambda s: drm_salts(0, 4, s, device="cuda")),
    }
    geom = (p.n_chunks, p.span, p.chunk, p.n_windows)
    streams = (p.chunk_window, p.chunk_first, p.local_idx, p.sorted_entries)
    for ln, (ls, lsalt) in sides.items():
        for rn, (rs, rsalt) in sides.items():
            _check("psi_window_direct", f"skewed, {ln} x {rn}",
                   (*streams, p.flat_left, p.flat_right, lsalt(1), rsalt(2),
                    *geom, ls, rs), phase=8)
    for n, (sp, salt) in sides.items():
        _check("psi_window_direct", f"skewed, no left x {n}",
               (*streams, None, p.flat_right, None, salt(2), *geom, GAUSS,
                sp), phase=8)
        _check("psi_window_direct", f"skewed, {n} x no right",
               (*streams, p.flat_left, None, salt(1), None, *geom, sp,
                GAUSS), phase=8)


def profile_window(run, n=3):
    """``run(0)`` untimed, then ``run(1..n)`` under ``torch.profiler``
    between two CUDA events: ``(device_us, window_us, rows, host)`` with
    the device-side events by device time (kernels, copies, memsets; an
    operator's CPU event repeats the time of the kernels it launched) and
    the host's operators by self CPU time (under the profiler, which slows
    the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for s in range(n):
            run(s + 1)
        end.record()
        end.synchronize()
    window_us = start.elapsed_time(end) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted(((device_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and device_us(e) > 0), reverse=True)
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if not str(e.device_type).endswith("CUDA")), reverse=True)
    return sum(r[0] for r in rows), window_us, rows, host


def print_profile(phase, n, unit, busy_us, window_us, rows, host):
    """Print ``profile_window``'s figures per ``unit`` (a name of what
    ``run`` does: "sketch", "solve")."""
    units = {"sketch": "sketches"}.get(unit, unit + "s")
    print(f"# phase {phase}: profiler over {n} {units}: device busy "
          f"{busy_us / 1e3:.3f} ms of a {window_us / 1e3:.3f} ms window "
          f"({100 * busy_us / window_us:.1f} % busy); per {unit}, by "
          f"device time:")
    for us, count, key in rows[:10]:
        print(f"#   {us / 1e3 / n:9.3f} ms  {count // n:4d} x  {key[:90]}")
    host_us = sum(r[0] for r in host)
    print(f"# phase {phase}: host time in operators {host_us / 1e3 / n:.3f} "
          f"ms per {unit} under the profiler; by self CPU time:")
    for us, count, key in host[:6]:
        print(f"#   {us / 1e3 / n:9.3f} ms  {count // n:4d} x  {key[:90]}")


def profile_sketch(run, n=3, phase=5):
    """Device time by kernel over ``n`` sketches (``torch.profiler``) and
    the device's busy share of the window (kernel time over the CUDA-event
    time of the window; one stream, so kernels do not overlap)."""
    busy_us, window_us, rows, host = profile_window(run, n)
    print_profile(phase, n, "sketch", busy_us, window_us, rows, host)
    return busy_us / window_us


def _outer(left, right, entries):
    """(nnz, r1 * r2) outer products of the weighted left rows and the
    right rows."""
    w = entries[None, :] if left is None else left * entries
    outer = w.T[:, :, None] * (1 if right is None else right.T[:, None, :])
    return outer.reshape(outer.shape[0], -1)


def segment_library_ms(calls):
    """The library call of the segment reduction: ``index_add_`` of the
    outer products, made beforehand and not timed, into the (n_mu, r1 * r2)
    rows of each recorded call."""
    import torch

    outs = [(_outer(left, right, ent), idx, n_mu)
            for left, right, ent, idx, n_mu in calls]
    ms = time_ms(lambda: [
        torch.zeros((n_mu, o.shape[1]), device="cuda").index_add_(0, idx, o)
        for o, idx, n_mu in outs])
    del outs
    torch.cuda.empty_cache()
    return ms


def segment_onehot(left, right, entries, indices_mu, n_mu):
    """The segment reduction of ``sketch_kernels._psi_sparse_segment`` as a
    one-hot ``torch.matmul`` per chunk of nonzeros: the form the JAX package
    takes on a TPU.  A yardstick timed beside the package's; the port never
    calls it."""
    import torch

    from tt_sketch_torch.kernels import segment_psi as SG

    r1 = left.shape[0] if left is not None else 1
    r2 = right.shape[0] if right is not None else 1
    psi = torch.zeros((n_mu, r1 * r2), dtype=entries.dtype,
                      device=entries.device)
    iota = torch.arange(n_mu, dtype=indices_mu.dtype,
                        device=indices_mu.device)
    for k0 in range(0, entries.shape[0], SG._REF_CHUNK):
        sl = slice(k0, k0 + SG._REF_CHUNK)
        outer = _outer(None if left is None else left[:, sl],
                       None if right is None else right[:, sl], entries[sl])
        onehot = (iota[:, None] == indices_mu[sl][None, :]).to(psi.dtype)
        psi += onehot @ outer
    return psi.reshape(n_mu, r1, r2).permute(1, 0, 2)


def replay_segments(segs, tag):
    """Time the recorded segment reductions ``segs`` through the package
    (``psi_segment``'s kernel for a Ψ of at most 16384 values), through the
    plain ``index_add_`` (``psi_segment_reference``) and through the
    one-hot yardstick, after holding the last two to the first; returns
    ``(package ms, index_add_ ms, one-hot ms)``."""
    from tt_sketch_torch.kernels import segment_psi as SG
    from tt_sketch_torch.kernels import sketch_kernels as K

    if not segs:
        return 0.0, 0.0, 0.0
    worst = max(max(_rel(SG.psi_segment_reference(*a).permute(1, 0, 2), ref),
                    _rel(segment_onehot(*a), ref))
                for a in segs for ref in (K._psi_sparse_segment(*a),))
    seg_ms = time_ms(lambda: [K._psi_sparse_segment(*a) for a in segs])
    add_ms = time_ms(lambda: [SG.psi_segment_reference(*a) for a in segs])
    onehot_ms = time_ms(lambda: [segment_onehot(*a) for a in segs])
    print(f"{tag} segment reductions ({len(segs)} modes, rows "
          f"{[a[4] for a in segs]}): package {seg_ms:.3f} ms, index_add_ "
          f"{add_ms:.3f} ms, one-hot torch.matmul yardstick {onehot_ms:.3f} "
          f"ms (the last two agree with the first to rel err {worst:.3e}, "
          f"tol {PSI_TOL:g})")
    if not worst <= PSI_TOL:
        raise AssertionError(f"{tag} index_add_ or the one-hot yardstick "
                             f"disagrees with the segment reduction: "
                             f"{worst:.3e}")
    return seg_ms, add_ms, onehot_ms


def load_sparse(name):
    """A committed FROSTT stand-in with its default plans, on the card in
    f32."""
    import torch

    from tt_sketch_torch.data.frostt import load_frostt
    from tt_sketch_torch.kernels.sparse_plan import WindowPlan

    t0 = time.perf_counter()
    tensor = load_frostt(name, psi_plan=True,
                         device="cuda").astype(torch.float32)
    torch.cuda.synchronize()
    print(f"# {name} {tensor.shape}, {tensor.nnz} nnz, plans "
          f"{tensor.psi_plan}, loaded, planned and moved to the card in "
          f"{time.perf_counter() - t0:.2f} s")
    for mu, p in enumerate(tensor.psi_plan):
        if isinstance(p, WindowPlan):
            per_window = np.bincount(p.chunk_window.cpu().numpy(),
                                     minlength=p.n_windows)
            filled = int((p.local_idx < p.span).sum())
            print(f"#   mode {mu} window plan: {p.n_windows} windows, "
                  f"{p.n_chunks} chunks; chunks per window: longest "
                  f"{per_window.max()}, median {np.median(per_window):g}; "
                  f"{filled} of {p.n_chunks * p.chunk} slots filled")
    return tensor


def _hash_rows(drm, k):
    """Rows of generator step ``k`` of a hash-family DRM."""
    spec = drm.side_spec(k)
    return spec[4] if spec[0] == "s" else drm.salts(k).shape[0]


def _segment_kernel(n_mu, r1, r2):
    """1 if the segment reduction of a Ψ of (r1, n_mu, r2) launches
    ``psi_segment``'s kernel, else 0 (it scatters with ``index_add_``)."""
    from tt_sketch_torch.kernels.segment_psi import MAX_CELLS

    return int(n_mu * r1 * r2 <= MAX_CELLS)


def expected_launches(tensor, ldrm, rdrm, whole=True):
    """Kernel launches of one fused sketch, worked out from the tensor's
    plans: a plan with the inclusive prefix merges Ψ and Ω, a window plan
    takes the window kernel, any other plan the Ψ slab kernel; a mode
    without a plan generates its rows; Ω of modes not merged takes the Ω
    kernel; a mode without a plan takes the segment reduction, through its
    kernel for a Ψ of at most 16384 values.  ``whole=False``: the tensor is
    a summand of a ``TensorSum``, sketched mode by mode as the JAX
    package's dispatch sketches one (no merged kernel: every Ω through the
    Ω kernel)."""
    from tt_sketch_torch.kernels.sparse_plan import WindowPlan

    d = len(tensor.shape)
    n = dict.fromkeys(SPARSE_KERNELS, 0)
    rows = {"g": "lazy_gaussian", "s": "sparse_sign_rows"}
    for mu, p in enumerate(tensor.psi_plan):
        if p is None:
            if mu > 0:
                n[rows[ldrm.side_spec(mu - 1)[0]]] += 1
            if mu < d - 1:
                n[rows[rdrm.side_spec(d - 2 - mu)[0]]] += 1
            n["psi_segment"] += _segment_kernel(
                tensor.shape[mu], _hash_rows(ldrm, mu - 1) if mu > 0 else 1,
                _hash_rows(rdrm, d - 2 - mu) if mu < d - 1 else 1)
        elif isinstance(p, WindowPlan):
            n["psi_window_direct"] += 1
        elif whole and mu < d - 1 and p.flat_left_om is not None:
            n["psi_omega_merged_slabs"] += 1
        else:
            n["psi_fused_slabs"] += 1
    n["omega_fused"] = d - 1 - n["psi_omega_merged_slabs"]
    return n


def _sum_of_launches(counts):
    """Per-kernel sums of launch-count dicts (a sum's shards, a growth's
    blocks)."""
    n = dict.fromkeys(SPARSE_KERNELS, 0)
    for c in counts:
        for k, v in c.items():
            n[k] += v
    return n


def _assert_launches(tag, label, launches, planned):
    """The counted launches must equal ``PATH_LAUNCHES[label]`` and those
    worked out from the plans."""
    want = dict.fromkeys(SPARSE_KERNELS, 0) | PATH_LAUNCHES[label]
    print(f"{tag} kernel launches in one sketch: "
          f"{ {k: v for k, v in launches.items() if v} }")
    if not launches == want == planned:
        raise AssertionError(f"{label}: launch counts {launches}, expected "
                             f"{want}, from the plans {planned}")


def _counted(run):
    """``run()`` with every kernel's count set to 0 just before and read
    just after, its kernel, segment-reduction and slab-combine calls
    recorded; returns ``(result, launches, calls)``."""
    import torch

    fns = _kernel_fns()
    calls = {}
    torch.cuda.synchronize()
    for kern, _ in fns.values():
        kern.launches = 0
    with recording(calls):
        out = run()
    torch.cuda.synchronize()
    return out, {name: fns[name][0].launches for name in SPARSE_KERNELS}, calls


def _worst_parts(tag, what, ours, ref, tol):
    """The worst relative Frobenius error of the parts ``ours`` against
    ``ref`` (shapes equal, every value finite); raises past ``tol``."""
    import torch

    worst = 0.0
    for i, (a, b) in enumerate(zip(ours, ref)):
        if a.shape != b.shape or not (bool(torch.isfinite(a).all())
                                      and bool(torch.isfinite(b).all())):
            raise AssertionError(f"{tag} part {i}: shape or non-finite")
        worst = max(worst, _rel(a, b))
    print(f"{tag} {what}: worst rel err {worst:.3e} (tol {tol:g})")
    if not worst <= tol:
        raise AssertionError(f"{tag} {what}: {worst:.3e} > {tol:g}")
    return worst


def _median_sketch_ms(run, groups=3, inner=3):
    """Median over ``groups`` of the mean CUDA-event time of ``inner`` runs
    with fresh seeds, after one untimed run; the host's enqueue time of one
    more run (no synchronization inside it)."""
    import torch

    run(1)
    torch.cuda.synchronize()
    times = []
    for i in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for j in range(inner):
            run(100 + inner * i + j)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    run(7)
    enqueue_ms = (time.perf_counter() - t_host) * 1e3
    torch.cuda.synchronize()
    return float(np.median(times)), times, enqueue_ms


def phase_sparse_main(label, tensor, drm_type, guard=None, groups=3,
                      inner=3):
    """One sparse main path: ``tensor`` through ``stream_sketch`` with a
    ``drm_type`` pair and the sparse kernels; returns the measurements and
    the arguments of every kernel, segment-reduction and slab-combine call
    of the counted sketch.

    ``guard`` says what holds ``sample_error(to_tt())``: ``"limit"`` holds
    the counted sketch's to ``SAMPLE_ERROR_LIMIT``; ``"parity"`` holds the
    error of each of seeds 0-4 to that of the float64 parity-path sketch of
    the same seed, which runs none of the kernels (a sign pair's error
    spreads between seeds and passes 1 for some, by the DRM and not by the
    kernels: STTA is not a projection), and the median of the five to
    ``SAMPLE_ERROR_LIMIT``; None prints the error only."""
    import torch

    from tt_sketch_torch import stream_sketch
    from tt_sketch_torch.data.frostt import sample_error
    from tt_sketch_torch.kernels import sketch_kernels as K

    kw = dict(left_drm_type=drm_type, right_drm_type=drm_type,
              dtype=torch.float32)
    tag = f"# phase 5 [{label}]:"

    (sk, ldrm, rdrm), launches, calls = _counted(lambda: stream_sketch(
        tensor, 10, 20, seed=0, return_drm=True, **kw))
    _assert_launches(tag, label, launches,
                     expected_launches(tensor, ldrm, rdrm))
    with plain_kernels():
        ref = stream_sketch(tensor, 10, 20, left_drm=ldrm, right_drm=rdrm,
                            **kw)
    worst = _worst_parts(tag, "every Psi/Omega vs the plain-version sketch "
                         "on the card", sk.Psi_cores + sk.Omega_mats,
                         ref.Psi_cores + ref.Omega_mats, PSI_TOL)
    del ref
    def run(seed):
        return stream_sketch(tensor, 10, 20, seed=seed, **kw)

    err = sample_error(sk.to_tt(), tensor)
    if guard is None:
        print(f"{tag} sample_error(to_tt()) = {err:.4f} (printed, no guard: "
              f"scattered support)")
    elif guard == "limit":
        print(f"{tag} sample_error(to_tt()) = {err:.4f} (limit "
              f"{SAMPLE_ERROR_LIMIT})")
        if not err <= SAMPLE_ERROR_LIMIT:
            raise AssertionError(f"sample error {err:.4f} > "
                                 f"{SAMPLE_ERROR_LIMIT}")
    else:
        errs = [err] + [sample_error(run(s).to_tt(), tensor)
                        for s in range(1, 5)]
        t64 = tensor.astype(torch.float64)
        parity = [sample_error(stream_sketch(
            t64, 10, 20, seed=s, left_drm_type=drm_type,
            right_drm_type=drm_type).to_tt(), t64) for s in range(5)]
        del t64
        print(f"{tag} sample_error(to_tt()) over seeds 0-4: "
              f"{', '.join(f'{e:.4f}' for e in errs)}; through the float64 "
              f"parity path, no kernel: "
              f"{', '.join(f'{e:.4f}' for e in parity)} (each pair within "
              f"{PARITY_ERROR_TOL:g}); median {np.median(errs):.4f} (limit "
              f"{SAMPLE_ERROR_LIMIT})")
        for s, (e, q) in enumerate(zip(errs, parity)):
            if not abs(e - q) <= PARITY_ERROR_TOL:
                raise AssertionError(f"seed {s}: sample error {e:.4f} "
                                     f"differs from the parity path's "
                                     f"{q:.4f}")
        if not np.median(errs) <= SAMPLE_ERROR_LIMIT:
            raise AssertionError(f"median sample error {np.median(errs):.4f}"
                                 f" > {SAMPLE_ERROR_LIMIT}")

    med, times, enqueue_ms = _median_sketch_ms(run, groups, inner)
    with plain_kernels():
        plain_ms = time_ms(lambda: run(3), reps=3, warmup=1)
    # the parts outside the kernels, replayed from the counted sketch: the
    # segment reductions of unplanned modes, the slab combines of planned
    # ones
    segs = calls.get("_psi_sparse_segment", [])
    combs = calls.get("_psi_from_slabs", [])
    seg_ms, add_ms, onehot_ms = replay_segments(segs, tag)
    comb_ms = time_ms(lambda: [K._psi_from_slabs(*a) for a in combs])
    busy = profile_sketch(lambda s: run(200 + s))
    nnz_per_s = tensor.nnz / (med / 1e3)
    print(f"{tag} sketch median {med:.3f} ms over fresh seeds "
          f"({', '.join(f'{t:.3f}' for t in times)}), "
          f"sparse_stta_nnz_per_s {nnz_per_s:.6e}; host enqueue of one "
          f"sketch {enqueue_ms:.3f} ms; plain-version sketch {plain_ms:.3f} "
          f"ms; segment reductions ({len(segs)} modes) {seg_ms:.3f} ms; "
          f"slab combines ({len(combs)} modes) {comb_ms:.3f} ms; device "
          f"busy {100 * busy:.1f} %")
    return {"launches": launches, "busy": busy, "ms": med, "times": times,
            "nnz_per_s": nnz_per_s, "sample_error": err, "worst_rel": worst,
            "plain_ms": plain_ms, "enqueue_ms": enqueue_ms, "seg_ms": seg_ms,
            "index_add_ms": add_ms, "onehot_ms": onehot_ms,
            "comb_ms": comb_ms, "calls": calls}


def _seq_sketch(method, tensor, drm, seed=None, drms=None):
    """One sequential sketch at rank 10 (OTTS: 10/20) in f32 through the
    entry points; returns ``(tt, drms)``.  ``drms`` given: sketch with
    those DRMs instead of fresh ones from ``seed``."""
    import torch

    from tt_sketch_torch import (
        SparseGaussianDRM,
        hmt_sketch,
        orthogonal_sketch,
    )

    drm_type = {"gauss": SparseGaussianDRM, "tt": None}[drm]
    f32 = torch.float32
    if method == "hmt":
        if drms is not None:
            return hmt_sketch(tensor, 10, drm=drms[0]), drms
        tt, rdrm = hmt_sketch(tensor, 10, seed=seed, drm_type=drm_type,
                              dtype=f32, return_drm=True)
        return tt, (rdrm,)
    if drms is not None:
        return orthogonal_sketch(tensor, 10, 20, left_drm=drms[0],
                                 right_drm=drms[1]), drms
    tt, ldrm, rdrm = orthogonal_sketch(
        tensor, 10, 20, seed=seed, left_drm_type=drm_type,
        right_drm_type=drm_type, dtype=f32, return_drm=True)
    return tt, (ldrm, rdrm)


def expected_seq_launches(tensor, method, rdrm):
    """Kernel launches of one HMT sketch, or of one OTTS sketch with a
    hash-family pair, worked out from the plans.  The chain advances once
    per mode after the first (and a TT-DRM runs the same chain for its own
    rows).  Ψ_μ's left side is the chain, so: a ``ModePlan`` takes the
    fused kernel at μ = 0 and the half-fused one at an interior mode when
    the right DRM hashes, else the grouped kernel; a ``WindowPlan`` the
    window kernel at μ = 0 with a hash DRM and the segment reduction
    otherwise; a mode that takes the segment reduction (through its kernel
    for a Ψ of at most 16384 values; the chain on the left has the
    sketch's rank, 10 on every path here) has a hash DRM generate its right
    rows.  OTTS adds one fused Ω per mode."""
    from tt_sketch_torch.kernels.sparse_plan import ModePlan, WindowPlan

    d = len(tensor.shape)
    n = dict.fromkeys(SPARSE_KERNELS, 0)
    hashes = hasattr(rdrm, "side_spec")
    rows = {"g": "lazy_gaussian", "s": "sparse_sign_rows"}
    n["chain_step_t"] = (d - 1) * (1 if hashes else 2)
    for mu, p in enumerate(tensor.psi_plan):
        right_hashed = hashes and mu < d - 1
        if isinstance(p, ModePlan):
            n["psi_fused_slabs" if right_hashed and mu == 0
              else "psi_chunk_slabs_genright" if right_hashed
              else "psi_chunk_slabs"] += 1
        elif isinstance(p, WindowPlan) and right_hashed and mu == 0:
            n["psi_window_direct"] += 1
        else:
            r2 = (1 if mu == d - 1 else _hash_rows(rdrm, d - 2 - mu)
                  if hashes else rdrm.rank[d - 2 - mu])
            n["psi_segment"] += _segment_kernel(
                tensor.shape[mu], 10 if mu > 0 else 1, r2)
            if right_hashed:
                n[rows[rdrm.side_spec(d - 2 - mu)[0]]] += 1
    if method == "otts":
        if not hashes:
            raise AssertionError("OTTS launch counts: hash-family pairs only")
        n["omega_fused"] = d - 1
    return n


def _recovered_values(tt, tensor, n=10_000, seed=0):
    """The TT's values at ``n`` of the tensor's nonzeros and ``n`` random
    index tuples: what a sequential sketch's per-core gauge leaves alone."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pick = torch.randint(0, tensor.nnz, (n,), generator=g, device="cuda")
    rand = torch.stack([torch.randint(0, s, (n,), generator=g, device="cuda")
                        for s in tensor.shape])
    return tt.gather(torch.cat([tensor.indices[:, pick], rand], dim=1))


def phase_seq_main(label, tensor, timed=True, groups=3, inner=3):
    """One sequential main path (``SEQ_PATHS[label]``): ``hmt_sketch`` or
    ``orthogonal_sketch`` of ``tensor`` at rank 10 (10/20) in f32 through
    the kernels.  Launch counts asserted against ``PATH_LAUNCHES`` and the
    plans; the recovered TT against the same sketch under
    ``plain_kernels()`` at 20,000 index tuples; on uber the sample-error
    guard; with ``timed``, the median sketch time over fresh seeds, the
    host's enqueue time and the device's busy share."""
    import torch

    from tt_sketch_torch.data.frostt import sample_error
    from tt_sketch_torch.kernels import sketch_kernels as K

    method, drm = SEQ_PATHS[label]
    tag = f"# phase 9 [{label}]:"

    (tt, drms), launches, calls = _counted(
        lambda: _seq_sketch(method, tensor, drm, seed=0))
    _assert_launches(tag, label, launches,
                     expected_seq_launches(tensor, method, drms[-1]))
    with plain_kernels():
        ref, _ = _seq_sketch(method, tensor, drm, drms=drms)
    torch.cuda.synchronize()
    a, b = _recovered_values(tt, tensor), _recovered_values(ref, tensor)
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise AssertionError(f"{label}: non-finite recovered values")
    worst = float((a - b).abs().max() / b.abs().max())
    print(f"{tag} recovered TT vs the plain-version sketch at 10,000 nonzero "
          f"and 10,000 random index tuples: max abs diff / largest value "
          f"{worst:.3e} (tol {SEQ_TOL:g})")
    if not worst <= SEQ_TOL:
        raise AssertionError(f"{label} disagrees with its plain-version "
                             f"sketch: {worst:.3e}")
    del ref
    err = sample_error(tt, tensor)
    out = {"launches": launches, "calls": calls, "sample_error": err,
           "worst_rel": worst, "shape": tuple(tensor.shape)}
    if label.startswith("uber") and method == "hmt":
        lo, hi = HMT_ERROR_RANGE
        print(f"{tag} sample_error = {err:.4f} (guard {lo}-{hi})")
        if not lo <= err <= hi:
            raise AssertionError(f"{label}: sample error {err:.4f} outside "
                                 f"{lo}-{hi}")
    elif label.startswith("uber"):
        print(f"{tag} sample_error = {err:.4f} (limit {SAMPLE_ERROR_LIMIT})")
        if not err <= SAMPLE_ERROR_LIMIT:
            raise AssertionError(f"{label}: sample error {err:.4f} > "
                                 f"{SAMPLE_ERROR_LIMIT}")
    else:
        print(f"{tag} sample_error = {err:.4f} (printed, no guard: "
              f"scattered support)")
    if not timed:
        return out

    def run(seed):
        return _seq_sketch(method, tensor, drm, seed=seed)[0]

    med, times, enqueue_ms = _median_sketch_ms(run, groups, inner)
    with plain_kernels():
        plain_ms = time_ms(lambda: run(3), reps=3, warmup=1)
    # the same sketch with its DRMs given: what making them costs
    given_ms = time_ms(lambda: _seq_sketch(method, tensor, drm, drms=drms))
    segs = calls.get("_psi_sparse_segment", [])
    combs = calls.get("_psi_from_slabs", [])
    seg_ms, add_ms, onehot_ms = replay_segments(segs, tag)
    comb_ms = time_ms(lambda: [K._psi_from_slabs(*a) for a in combs])
    busy = profile_sketch(lambda s: run(200 + s), phase=9)
    nnz_per_s = tensor.nnz / (med / 1e3)
    print(f"{tag} sketch median {med:.3f} ms over fresh seeds "
          f"({', '.join(f'{t:.3f}' for t in times)}), {nnz_per_s:.6e} nnz/s; "
          f"host enqueue of one sketch {enqueue_ms:.3f} ms; with the DRMs "
          f"given {given_ms:.3f} ms; plain-version "
          f"sketch {plain_ms:.3f} ms; segment reductions ({len(segs)} modes) "
          f"{seg_ms:.3f} ms; slab combines ({len(combs)} modes) "
          f"{comb_ms:.3f} ms; device busy {100 * busy:.1f} %")
    out.update(ms=med, times=times, nnz_per_s=nnz_per_s, busy=busy,
               plain_ms=plain_ms, enqueue_ms=enqueue_ms, given_ms=given_ms,
               seg_ms=seg_ms, index_add_ms=add_ms, onehot_ms=onehot_ms,
               comb_ms=comb_ms)
    return out


def phase_seq_kernels():
    """``chain_step_t``, ``psi_chunk_slabs`` and ``psi_chunk_slabs_genright``
    against their plain versions at the shapes no main path gives them, and
    the half-fused Ψ in both orientations through streaming sketches with a
    mixed pair."""
    import torch

    from tt_sketch_torch import (
        SparseGaussianDRM,
        TensorTrainDRM,
        stream_sketch,
    )
    from tt_sketch_torch.kernels import chain_step as CS
    from tt_sketch_torch.rng.hash_rng import drm_salts

    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(17)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=f32)

    def randint(n, size):
        return torch.randint(0, n, (size,), generator=g, device="cuda")

    # -- chain_step_t: odd shapes, the edges of the launch decisions (the
    # block budget, each rank bucket) and ranks past the largest bucket
    # (the generic instance)
    at_budget = CS.BLOCK_BUDGET // (4 * 100)
    chain_cases = [
        ("ragged nnz 100003, n 37, ranks 7 -> 11", 100_003, 37, 7, 11),
        ("n = 1", 5_001, 1, 5, 6),
        ("ranks 1 -> 1", 4_097, 50, 1, 1),
        ("ranks 20 -> 1", 70_001, 300, 20, 1),
        ("ranks 1 -> 20, one nonzero", 1, 9, 1, 20),
        ("ranks 9 -> 17", 33_333, 64, 9, 17),
        ("core of 1140 x 10 x 10", 250_007, 1140, 10, 10),
        ("core of 5000 x 20 x 20", 120_001, 5000, 20, 20),
        (f"core at the block budget, n {at_budget}", 200_003, at_budget, 10,
         10),
        ("one row above the block budget", 200_003, at_budget + 1, 10, 10),
        ("ranks 4 -> 4 (smallest buckets)", 50_001, 70, 4, 4),
        ("ranks 5 -> 5 (one past them)", 50_001, 70, 5, 5),
        ("ranks 8 -> 12", 50_001, 70, 8, 12),
        ("ranks 16 -> 13", 50_001, 70, 16, 13),
        ("ranks 17 -> 16", 50_001, 70, 17, 16),
        ("ranks 32 -> 32 (largest buckets)", 50_001, 70, 32, 32),
        ("ranks 33 -> 3 (generic)", 50_001, 70, 33, 3),
        ("ranks 3 -> 33 (generic)", 50_001, 70, 3, 33),
        ("ranks 1 -> 32", 50_001, 70, 1, 32),
        ("ranks 1 -> 33 (generic)", 50_001, 70, 1, 33),
        ("ranks 100 -> 40 (generic, fewer staged columns)", 20_001, 30, 100,
         40),
    ]
    for label, nnz, n, r1, r2 in chain_cases:
        core, state, idx = randn(r1, n, r2), randn(r1, nnz), randint(n, nnz)
        sched = CS.chain_schedule(n, r1, r2, False)
        idx[: min(nnz, 3)] = n - 1  # the last row of the core
        _check("chain_step_t", f"{label}, core in {sched.place}",
               (state, core, idx), phase=10)
        if r1 == 1:
            a, b = (fn(None, core, idx)
                    for fn in _kernel_fns()["chain_step_t"])
            torch.cuda.synchronize()
            first = CS.chain_schedule(n, 1, r2, True)
            print(f"# phase 10: chain_step_t {label}, first step (core in "
                  f"{first.place}): "
                  f"{'equal' if torch.equal(a, b) else 'DIFFERENT'} bit for "
                  f"bit")
            if not torch.equal(a, b):
                raise AssertionError("chain_step_t first step is a gather "
                                     "and must be exact")
    # the first step with a core at the block budget and one row above
    at_first = CS.BLOCK_BUDGET // (4 * 12)
    for n in (at_first, at_first + 1, 200_000):
        core, idx = randn(1, n, 10), randint(n, 300_001)
        a, b = (fn(None, core, idx) for fn in _kernel_fns()["chain_step_t"])
        torch.cuda.synchronize()
        place = CS.chain_schedule(n, 1, 10, True).place
        print(f"# phase 10: chain_step_t first step, n {n} (core in "
              f"{place}): {'equal' if torch.equal(a, b) else 'DIFFERENT'} "
              f"bit for bit")
        if not torch.equal(a, b):
            raise AssertionError(f"chain_step_t first step (n {n}) is not "
                                 f"exact")
    core, state, idx = randn(1, 183, 10), None, randint(183, 300_001)
    a, b = (fn(state, core, idx) for fn in _kernel_fns()["chain_step_t"])
    if not torch.equal(a, b):
        raise AssertionError("chain_step_t first step (n 183) is not exact")
    core = randn(6, 40, 9).to(torch.bfloat16)
    state, idx = randn(6, 9_999).to(torch.bfloat16), randint(40, 9_999)
    a, b = (fn(state, core, idx) for fn in _kernel_fns()["chain_step_t"])
    rel = _rel(a.float(), b.float())
    print(f"# phase 10: chain_step_t bfloat16 operands (f32 arithmetic, "
          f"rounded once) vs the plain bfloat16 einsum: rel err {rel:.3e} "
          f"(tol {BF16_TOL:g})")
    if not (a.dtype == torch.bfloat16 and rel <= BF16_TOL):
        raise AssertionError("chain_step_t bfloat16")
    # an index outside the mode gives a zero column, wherever the core
    # lives and on the generic instance, with a state and on the first step
    for r1, n, r2 in ((6, 40, 9), (20, 5000, 20), (33, 70, 3), (1, 40, 9),
                      (1, 200_000, 9), (1, 70, 33)):
        out_of_range = randint(n, 1_000)
        out_of_range[::7] = n
        out_of_range[3] = -1
        out_of_range[5] = -(1 << 40)
        first = r1 == 1
        z = _kernel_fns()["chain_step_t"][0](
            None if first else randn(r1, 1_000), randn(r1, n, r2),
            out_of_range)
        torch.cuda.synchronize()
        bad = (out_of_range < 0) | (out_of_range >= n)
        sched = CS.chain_schedule(n, r1, r2, first)
        if not (bool((z[:, bad] == 0).all())
                and bool(torch.isfinite(z).all())):
            raise AssertionError(f"chain_step_t: an index outside the mode "
                                 f"must give a zero column ({r1}, {n}, {r2})")
        print(f"# phase 10: chain_step_t ({r1}, {n}, {r2}){' first' * first}"
              f", core in {sched.place}: {int(bad.sum())} indices outside "
              f"[0, {n}) give zero columns")
    chain_placements(randn, randint)

    # -- the slab kernels over given rows, on the ragged tensor's plan
    t, _, _ = _ragged_case(SparseGaussianDRM, SparseGaussianDRM)
    p = t.psi_plan[2]
    nnz = t.nnz
    geom = (p.n_chunks, p.span, p.chunk)
    se = p.sorted_entries
    sl7, sr13, one = randn(7, nnz), randn(13, nnz), randn(1, nnz)
    g13 = (drm_salts(0, 13, 31, device="cuda"), GAUSS)
    s13 = (drm_salts(0, 5, 32, device="cuda"), ("s", 13, 5, 0, 13))
    s5of9 = (drm_salts(0, 4, 33, device="cuda"), ("s", 9, 4, 3, 5))
    g1 = (drm_salts(0, 1, 34, device="cuda"), GAUSS)
    # whole tiles of sentinels inside the stream, and a chunk (the second)
    # whose every nonzero hits one row
    loc_holes = p.local_idx.clone()
    loc_holes[128:320] = p.span
    loc_holes[p.chunk: 2 * p.chunk] = 3
    for tag, loc in (("ragged plan", p.local_idx),
                     ("sentinel tiles and a one-row chunk", loc_holes)):
        for what, sl, sr in (("7 x 13", sl7, sr13), ("7 x none", sl7, None),
                             ("none x 13", None, sr13), ("1 x 1", one, one),
                             ("1 x none", one, None)):
            _check("psi_chunk_slabs", f"{tag}, {what}",
                   (loc, se, sl, sr, *geom), phase=10)
        _same_bits("psi_chunk_slabs", f"{tag}, 7 x 13",
                   (loc, se, sl7, sr13, *geom), phase=10)
        for what, sl, (salts, spec) in (
                ("7 x gauss 13", sl7, g13), ("7 x sign 13", sl7, s13),
                ("7 x sign slice 5 of 9", sl7, s5of9),
                ("none x gauss 13", None, g13), ("1 x gauss 1", one, g1)):
            _check("psi_chunk_slabs_genright", f"{tag}, {what}",
                   (loc, se, sl, p.flat_right, salts, *geom, spec), phase=10)
        _same_bits("psi_chunk_slabs_genright", f"{tag}, 7 x sign 13",
                   (loc, se, sl7, p.flat_right, s13[0], *geom, s13[1]),
                   phase=10)
    every = p.local_idx.clone()
    every[:] = p.span
    z = _kernel_fns()["psi_chunk_slabs"][0](every, se, sl7, sr13, *geom)
    torch.cuda.synchronize()
    if not bool((z == 0).all()):
        raise AssertionError("psi_chunk_slabs: sentinels must add nothing")
    print("# phase 10: psi_chunk_slabs with every local row the sentinel: "
          "all slabs zero")
    # the shared-memory limit holds given sides too
    try:
        _kernel_fns()["psi_chunk_slabs"][0](
            p.local_idx, se, randn(893, nnz), one, *geom)
    except ValueError as exc:
        print(f"# phase 10: given sides of 893 + 1 rows raise: {exc}")
    else:
        raise AssertionError("given sides past the shared-memory limit did "
                             "not raise")
    _check("psi_chunk_slabs", "given sides of 892 + 1 rows (the most a "
           "block holds)", (p.local_idx, se, randn(892, nnz), one, *geom),
           phase=10)

    # -- both orientations of the half-fused Ψ: streaming with a mixed pair
    shape = t.shape
    for tag, lt, rt in (("TT-DRM x gauss", TensorTrainDRM, SparseGaussianDRM),
                        ("gauss x TT-DRM", SparseGaussianDRM, TensorTrainDRM)):
        ldrm = lt(7, shape, transpose=False, seed=41, dtype=f32,
                  device="cuda")
        rdrm = rt(13, shape, transpose=True, seed=42, dtype=f32,
                  device="cuda")
        calls = {}
        with recording(calls):
            sk = stream_sketch(t, ldrm.rank, rdrm.rank, left_drm=ldrm,
                               right_drm=rdrm)
        with plain_kernels():
            ref = stream_sketch(t, ldrm.rank, rdrm.rank, left_drm=ldrm,
                                right_drm=rdrm)
        torch.cuda.synchronize()
        n_gen = len(calls.get("psi_chunk_slabs_genright", []))
        if n_gen == 0:
            raise AssertionError(f"{tag}: no half-fused Ψ call")
        for name in ("chain_step_t", "psi_chunk_slabs_genright",
                     "psi_chunk_slabs", "psi_fused_slabs", "lazy_gaussian"):
            for i, args in enumerate(calls.get(name, [])):
                _check(name, f"streaming {tag} call {i}", args, phase=10)
                if name in SPARSE_PSI_INSTANCES:
                    _same_bits(name, f"streaming {tag} call {i}", args,
                               phase=10)
        worst = max(_rel(a, b) for a, b in zip(
            sk.Psi_cores + sk.Omega_mats, ref.Psi_cores + ref.Omega_mats))
        print(f"# phase 10: streaming {tag} on the ragged tensor: {n_gen} "
              f"half-fused Ψ call(s); every Psi/Omega vs the plain-version "
              f"sketch: worst rel err {worst:.3e} (tol {PSI_TOL:g})")
        if not worst <= PSI_TOL:
            raise AssertionError(f"streaming {tag} disagrees with its plain "
                                 f"version")


#: (r1, n, r2, first) of the cores phase 10 times in both places: uber's
#: and lbnl's recorded cores and the sizes between (ranks 10/10: 400 bytes
#: a row; first steps: 48)
CHAIN_PLACEMENTS = ((10, 24, 10, False), (10, 100, 10, False),
                    (10, 140, 10, False), (10, 200, 10, False),
                    (10, 400, 10, False), (10, 560, 10, False),
                    (10, 1140, 10, False), (10, 4198, 10, False),
                    (1, 183, 10, True), (1, 1605, 10, True),
                    (1, 4000, 10, True))


def chain_placements(randn, randint, nnz=3_309_696):
    """``chain_step_t`` over uber's nnz with each core of
    ``CHAIN_PLACEMENTS`` held in each block's shared memory (where it
    fits) and read through the cache, checked against the plain version and
    timed (ten calls back to back: the kernels' time, not the host's): the
    measurement behind ``BLOCK_BUDGET``."""
    import torch

    from tt_sketch_torch.kernels import chain_step as CS

    out = {}
    state = randn(10, nnz)
    for r1, n, r2, first in CHAIN_PLACEMENTS:
        core, idx = randn(r1, n, r2), randint(n, nnz)
        st = None if first else state
        ref = CS.chain_step_t_reference(st, core, idx)
        sched = CS.chain_schedule(n, r1, r2, first)
        held = 4 * n * sched.stride
        for sched in (sched._replace(place="block", smem_bytes=held),
                      sched._replace(place="cache", smem_bytes=0)):
            if sched.smem_bytes > 232448:  # more than a block can hold
                continue
            got = CS._launch(st, core, idx, sched)
            torch.cuda.synchronize()
            label = f"({r1}, {n}, {r2}){' first' * first}, core in " \
                    f"{sched.place}"
            _compare("chain_step_t", label, (got,), (ref,), phase=10)
            ms = time_ms(lambda: [CS._launch(st, core, idx, sched)
                                  for _ in range(10)]) / 10
            out[(r1, n, r2, first, sched.place)] = ms
            print(f"# phase 10: chain_step_t placement {label} "
                  f"({sched.smem_bytes} bytes a block), {nnz} nnz: "
                  f"{ms:.3f} ms")
    return out


def _bound(nbytes, n_ops, ops_per_s):
    """(bound ms, bound_by, bytes ms, operations ms)."""
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), t_bytes, t_ops


#: TF32 tensor-core products per flop of the projection kernel: 3xTF32 in
#: f32 mode (big·big + big·small + small·big), one pass in bf16 mode
TF32_PASSES = {"f32": 3, "bf16": 1}


def bound_ms(P, S, r, rho, compute="f32"):
    """``dual_project``'s bound: X, R and L read once, T and U written once,
    against its tensor-core products at the TF32 rate."""
    return _bound(4 * (P * S + S * rho + P * r + P * rho + r * S),
                  TF32_PASSES[compute] * 2 * P * S * (r + rho),
                  H100_TF32_FLOP_PER_S)


def diag_bound(name, P, S, r, rho, compute="f32"):
    """The bound of one projector diagnostic: X read once, the small
    operands read and the output written once; the products as
    ``bound_ms`` counts them (X stays f32 in memory in both modes);
    ``reduce_read``'s adds as lane instructions."""
    if name == "reduce_read":
        return _bound(4 * (P * S + P), P * S, H100_LANE_OPS_PER_S)
    passes = TF32_PASSES[compute]
    if name == "t_only":
        return _bound(4 * (P * S + S * rho + P * rho),
                      passes * 2 * P * S * rho, H100_TF32_FLOP_PER_S)
    return _bound(4 * (P * S + P * r + r * S), passes * 2 * P * S * r,
                  H100_TF32_FLOP_PER_S)


def read_turns(X):
    """``reduce_read`` and ``X.sum(dim=1, keepdim=True)`` timed in turns
    (kernel, library, library, kernel, twice): alone (one call, the card
    waiting for the host's wrapper), ten back to back (the card's time) and
    the host's time to enqueue one call.  Returns per function the lists of
    each."""
    import torch

    from tt_sketch_torch.kernels import projector_diag as PD

    fns = {"reduce_read": lambda: PD.reduce_read(X),
           "X.sum": lambda: X.sum(dim=1, keepdim=True)}
    res = {name: {"alone": [], "b2b": [], "host": []} for name in fns}
    for name in ("reduce_read", "X.sum", "X.sum", "reduce_read") * 2:
        fn, m = fns[name], res[name]
        m["alone"].append(time_ms(fn))
        m["b2b"].append(time_ms(lambda: [fn() for _ in range(10)]) / 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        m["host"].append((time.perf_counter() - t0) / 10 * 1e3)
        torch.cuda.synchronize()
    for name, m in res.items():
        print(f"# phase 11: {name} at the main-path shape, in turns: alone "
              + "/".join(f"{x:.3f}" for x in m["alone"]) + " ms; back to "
              "back " + "/".join(f"{x:.3f}" for x in m["b2b"]) + " ms; host "
              "enqueue " + "/".join(f"{x:.4f}" for x in m["host"]) + " ms")
    return res


def phase_projector_diag():
    """``t_only``, ``u_only`` and ``reduce_read`` against their plain
    versions at every shape of ``DIAG_SHAPES`` (launch counts of the rank
    split asserted), their timings and bounds at the main-path shape, then
    ``run_projector_diag`` there: the diagnostics' own path, with the
    launch counts set to 0 just before it and read just after."""
    import torch

    from tt_sketch_torch.kernels import dual_project as DP
    from tt_sketch_torch.kernels import projector_diag as PD

    fns = {"t_only": (PD.t_only, PD.t_only_reference),
           "u_only": (PD.u_only, PD.u_only_reference),
           "reduce_read": (PD.reduce_read, PD.reduce_read_reference)}
    modes = {"t_only": ("f32", "bf16"), "u_only": ("f32", "bf16"),
             "reduce_read": ("f32",)}
    # bf16 at F32_TOL too: kernel and plain version round the same operands
    # to bf16 and accumulate in fp32, so a kernel that skipped the rounding
    # (about 2e-3 away) fails
    tol = {"f32": F32_TOL, "bf16": F32_TOL}
    res = {name: {} for name in DIAG_KERNELS}
    for seed, (label, (P, S, r, rho)) in enumerate(DIAG_SHAPES.items()):
        X, R, L = _operands(P, S, r, rho, 100 + seed)
        args = {"t_only": (X, R), "u_only": (X, L), "reduce_read": (X,)}
        split = {"t_only": -(-rho // 64), "u_only": -(-r // 32),
                 "reduce_read": 1}
        for name in DIAG_KERNELS:
            kern, plain = fns[name]
            for compute in modes[name]:
                kw = {} if name == "reduce_read" else {"compute": compute}
                before = kern.launches
                got = kern(*args[name], **kw)
                ref = plain(*args[name], **kw)
                torch.cuda.synchronize()
                launched = kern.launches - before
                rel = _rel(got, ref)
                abs_err = float((got - ref).abs().max())
                print(f"# phase 11: {name} {label} P={P} S={S} r={r} "
                      f"rho={rho} {compute}: rel err {rel:.3e} (tol "
                      f"{tol[compute]:g}), max abs err {abs_err:.3e}, "
                      f"{launched} launch(es)")
                if not (rel <= tol[compute] and got.shape == ref.shape
                        and bool(torch.isfinite(got).all())):
                    raise AssertionError(f"{name} {compute} disagrees with "
                                         f"its plain version at {label}")
                if launched != split[name]:
                    raise AssertionError(f"{name} at {label}: {launched} "
                                         f"launches, expected {split[name]}")
                if label == "main":
                    res[name][compute] = {"max_abs_err": abs_err,
                                          "rel_err": rel}
                    same = torch.equal(got, kern(*args[name], **kw))
                    print(f"# phase 11: {name} main {compute}: a second "
                          f"call gives the same bits: {same}")
                    if not same:
                        raise AssertionError(f"{name} {compute} is not "
                                             f"deterministic")
        if label != "main":
            del X, R, L
            torch.cuda.empty_cache()
            continue
        library = {"t_only": lambda: torch.matmul(X, R),
                   "u_only": lambda: torch.matmul(L.T, X),
                   "reduce_read": lambda: X.sum(dim=1, keepdim=True)}
        for name in DIAG_KERNELS:
            kern, plain = fns[name]
            for compute in modes[name]:
                kw = {} if name == "reduce_read" else {"compute": compute}
                m = res[name][compute]
                m["ms"] = time_ms(lambda: kern(*args[name], **kw))
                m["plain_ms"] = time_ms(lambda: plain(*args[name], **kw))
                m["bound_ms"], m["bound_by"], _, _ = diag_bound(
                    name, P, S, r, rho, compute)
            res[name]["library_ms"] = time_ms(library[name])
            print(f"# phase 11: {name} at the main-path shape: "
                  + "; ".join(f"{c} {m['ms']:.3f} ms (bound "
                              f"{m['bound_ms']:.3f} ms by {m['bound_by']}, "
                              f"plain version {m['plain_ms']:.3f} ms)"
                              for c, m in ((c, res[name][c])
                                           for c in modes[name]))
                  + f"; library call {res[name]['library_ms']:.3f} ms")

        res["reduce_read"]["turns"] = read_turns(X)

        # the diagnostics' own path
        torch.cuda.synchronize()
        for name in DIAG_KERNELS:
            fns[name][0].launches = 0
        DP.dual_project.launches = 0
        diag = PD.run_projector_diag(X, R, L, reps=DIAG_REPS)
        torch.cuda.synchronize()
        launches = {name: fns[name][0].launches for name in DIAG_KERNELS}
        launches["dual_project"] = DP.dual_project.launches
        calls = DIAG_REPS + 1  # one untimed call per tag, then the timed
        want = {"t_only": 2 * calls, "u_only": 2 * calls,
                "reduce_read": calls, "dual_project": 2 * calls}
        print(f"# phase 11: launches in run_projector_diag: {launches}")
        if launches != want:
            raise AssertionError(f"diagnostic launches {launches}, expected "
                                 f"{want}")
        for tag in PD.TAGS:
            out = diag[tag]["out"]
            for o in (out if isinstance(out, tuple) else (out,)):
                if not bool(torch.isfinite(o).all()):
                    raise AssertionError(f"[{tag}] non-finite output")
        for name in DIAG_KERNELS:
            res[name]["launches"] = launches[name]
        ms = {tag: diag[tag]["ms"] for tag in PD.TAGS}
        floor = ms["read-roofline"]
        b_read = diag_bound("reduce_read", P, S, r, rho)[0]
        print(f"# phase 11: read floor {floor:.3f} ms against the data "
              f"sheet's {b_read:.3f} ms ({b_read / floor * 100:.1f} % of "
              f"3.35 TB/s); dual-f32 {ms['dual-f32']:.3f} ms = "
              f"{ms['dual-f32'] / floor:.2f} x the read floor; T-f32 "
              f"{ms['T-f32']:.3f} + U-f32 {ms['U-f32']:.3f} = "
              f"{ms['T-f32'] + ms['U-f32']:.3f} ms unfused; the slower half "
              f"is {'T' if ms['T-f32'] >= ms['U-f32'] else 'U'}; lib-T + "
              f"lib-U {ms['lib-T'] + ms['lib-U']:.3f} ms")
        res["diag"] = {tag: {"ms": diag[tag]["ms"], "gbps": diag[tag]["gbps"]}
                       for tag in PD.TAGS}
        del X, R, L, diag
        torch.cuda.empty_cache()
    return res


# -- phase 12: sums, rank growth, CP, Tucker and dense Gaussian DRMs ----------

def split_uber(uber):
    """``uber.split(SUM_SHARDS, psi_plan=True)`` with the library-default
    plans; returns the sum and the host seconds its plans took."""
    import torch

    t0 = time.perf_counter()
    shards = uber.split(SUM_SHARDS, psi_plan=True)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    print(f"# phase 12: uber split into {SUM_SHARDS} shards of "
          f"{[t.nnz for t in shards.tensors]} nnz, plans "
          f"{shards.tensors[0].psi_plan}, built in {plan_s:.2f} s on the "
          f"host (split and plans together)")
    return shards, plan_s


def phase_sum_main(label, uber, shards, drm_type, whole):
    """(a) STTA of the sum of planned shards at rank 10/20 in f32 with the
    DRMs of phase 5's whole-tensor sketch of seed 0: every Ψ/Ω against the
    whole tensor's and against the same sum under ``plain_kernels()``;
    launch counts from the shards' plans; the sample-error guard; the
    median time, host enqueue and busy share beside ``whole``'s (phase
    5)."""
    import torch

    from tt_sketch_torch import stream_sketch
    from tt_sketch_torch.data.frostt import sample_error

    tag = f"# phase 12 [{label}]:"
    kw = dict(left_drm_type=drm_type, right_drm_type=drm_type,
              dtype=torch.float32)
    ref, ldrm, rdrm = stream_sketch(uber, 10, 20, seed=0, return_drm=True,
                                    **kw)
    sk, launches, calls = _counted(lambda: stream_sketch(
        shards, 10, 20, left_drm=ldrm, right_drm=rdrm))
    planned = _sum_of_launches(expected_launches(t, ldrm, rdrm, whole=False)
                               for t in shards.tensors)
    _assert_launches(tag, label, launches, planned)
    parts = sk.Psi_cores + sk.Omega_mats
    lin = _worst_parts(tag, "every Psi/Omega of the sum vs the whole "
                       "tensor's fused sketch (linearity)", parts,
                       ref.Psi_cores + ref.Omega_mats, PSI_TOL)
    with plain_kernels():
        plain = stream_sketch(shards, 10, 20, left_drm=ldrm, right_drm=rdrm)
    worst = _worst_parts(tag, "every Psi/Omega vs the same sum under the "
                         "plain versions on the card", parts,
                         plain.Psi_cores + plain.Omega_mats, PSI_TOL)
    del plain
    err = sample_error(sk.to_tt(), uber)
    err_whole = sample_error(ref.to_tt(), uber)
    if label == "uber sum gauss":
        print(f"{tag} sample_error(to_tt()) = {err:.4f} (limit "
              f"{SAMPLE_ERROR_LIMIT}; the whole tensor's {err_whole:.4f})")
        ok = err <= SAMPLE_ERROR_LIMIT
    else:
        # a sign pair's error spreads between seeds (phase 5 holds each
        # seed to the float64 parity path): the sum is held to the whole
        # tensor's sketch with the same DRMs
        print(f"{tag} sample_error(to_tt()) = {err:.4f}, the whole "
              f"tensor's with the same DRMs {err_whole:.4f} (within "
              f"{PARITY_ERROR_TOL:g})")
        ok = abs(err - err_whole) <= PARITY_ERROR_TOL
    if not ok:
        raise AssertionError(f"{label}: sample error {err:.4f}")

    def run(seed):
        return stream_sketch(shards, 10, 20, seed=seed, **kw)

    med, times, enqueue_ms = _median_sketch_ms(run)
    busy = profile_sketch(lambda s: run(200 + s), phase=12)
    print(f"{tag} sketch median {med:.3f} ms over fresh seeds "
          f"({', '.join(f'{t:.3f}' for t in times)}), "
          f"{uber.nnz / (med / 1e3):.6e} nnz/s; host enqueue {enqueue_ms:.3f} "
          f"ms; device busy {100 * busy:.1f} %; the whole tensor (phase 5): "
          f"{whole['ms']:.3f} ms, host enqueue {whole['enqueue_ms']:.3f} ms, "
          f"busy {100 * whole['busy']:.1f} %")
    return {"launches": launches, "calls": calls, "shape": uber.shape,
            "linearity_rel": lin, "worst_rel": worst, "sample_error": err,
            "ms": med, "times": times, "enqueue_ms": enqueue_ms,
            "busy": busy, "nnz_per_s": uber.nnz / (med / 1e3)}


def phase_sum_hmt(uber, shards):
    """(b) ``hmt_sketch`` of the sum at rank 10 with a Gaussian DRM: one
    child chain per shard; recovered values against the whole tensor's HMT
    with the same DRM and against the sum under ``plain_kernels()``; the
    HMT guard; launch counts from the shards' plans; the median time."""
    import torch

    from tt_sketch_torch import SparseGaussianDRM, hmt_sketch
    from tt_sketch_torch.data.frostt import sample_error

    label = "uber sum hmt gauss"
    tag = f"# phase 12 [{label}]:"
    tt, launches, calls = _counted(lambda: hmt_sketch(
        shards, 10, seed=0, drm_type=SparseGaussianDRM, dtype=torch.float32,
        return_drm=True))
    tt, rdrm = tt
    planned = _sum_of_launches(expected_seq_launches(t, "hmt", rdrm)
                               for t in shards.tensors)
    _assert_launches(tag, label, launches, planned)
    vals = _recovered_values(tt, uber)
    whole = hmt_sketch(uber, 10, drm=rdrm)
    with plain_kernels():
        plain = hmt_sketch(shards, 10, drm=rdrm)
    worst = {}
    for what, other in (("the whole tensor's HMT", whole),
                        ("the sum under the plain versions", plain)):
        b = _recovered_values(other, uber)
        if not (bool(torch.isfinite(vals).all())
                and bool(torch.isfinite(b).all())):
            raise AssertionError(f"{label}: non-finite recovered values")
        worst[what] = float((vals - b).abs().max() / b.abs().max())
        print(f"{tag} recovered TT vs {what} at 10,000 nonzero and 10,000 "
              f"random index tuples: max abs diff / largest value "
              f"{worst[what]:.3e} (tol {SEQ_TOL:g})")
        if not worst[what] <= SEQ_TOL:
            raise AssertionError(f"{label} disagrees with {what}: "
                                 f"{worst[what]:.3e}")
    del whole, plain
    err = sample_error(tt, uber)
    lo, hi = HMT_ERROR_RANGE
    print(f"{tag} sample_error = {err:.4f} (guard {lo}-{hi})")
    if not lo <= err <= hi:
        raise AssertionError(f"{label}: sample error {err:.4f}")
    med, times, enqueue_ms = _median_sketch_ms(lambda s: hmt_sketch(
        shards, 10, seed=s, drm_type=SparseGaussianDRM, dtype=torch.float32))
    print(f"{tag} sketch median {med:.3f} ms over fresh seeds "
          f"({', '.join(f'{t:.3f}' for t in times)}); host enqueue "
          f"{enqueue_ms:.3f} ms")
    return {"launches": launches, "calls": calls, "shape": uber.shape,
            "worst_rel": max(worst.values()), "sample_error": err,
            "ms": med, "times": times, "enqueue_ms": enqueue_ms}


def phase_grow(uber):
    """(c) ``increase_rank`` of a Gaussian STTA sketch of uber from 10/20
    to 15/30: the three new blocks through the fused kernels with
    rank-sliced salts; every Ψ/Ω against a sketch from scratch with the
    grown DRMs; the old container as block (0, 0); the growth's time
    against the sketch from scratch."""
    import torch

    from tt_sketch_torch import SparseGaussianDRM, stream_sketch

    label = "uber grow gauss"
    tag = f"# phase 12 [{label}]:"
    small = stream_sketch(uber, 10, 20, seed=0,
                          left_drm_type=SparseGaussianDRM,
                          right_drm_type=SparseGaussianDRM,
                          dtype=torch.float32)
    big, launches, calls = _counted(lambda: small.increase_rank(uber, 15,
                                                                30))
    d = len(uber.shape)
    left = [(0,) * (d - 1), small.left_rank, (15,) * (d - 1)]
    right = [(0,) * (d - 1), small.right_rank, (30,) * (d - 1)]
    planned = _sum_of_launches(
        expected_launches(uber, big.left_drm.slice(left[i], left[i + 1]),
                          big.right_drm.slice(right[j], right[j + 1]))
        for i in range(2) for j in range(2) if (i, j) != (0, 0))
    _assert_launches(tag, label, launches, planned)
    scratch = stream_sketch(uber, 15, 30, left_drm=big.left_drm,
                            right_drm=big.right_drm)
    worst = _worst_parts(tag, "every Psi/Omega of the grown sketch vs a "
                         "sketch from scratch with the grown DRMs",
                         big.Psi_cores + big.Omega_mats,
                         scratch.Psi_cores + scratch.Omega_mats, PSI_TOL)
    kept = all(torch.equal(P[: Q.shape[0], :, : Q.shape[2]], Q)
               for P, Q in zip(big.Psi_cores, small.Psi_cores)) and all(
        torch.equal(O[: Q.shape[0], : Q.shape[1]], Q)
        for O, Q in zip(big.Omega_mats, small.Omega_mats))
    print(f"{tag} the old container is block (0, 0) of the grown one, bit "
          f"for bit: {kept}")
    if not kept:
        raise AssertionError(f"{label}: the old container is not block "
                             f"(0, 0)")
    grow_ms = time_ms(lambda: small.increase_rank(uber, 15, 30))
    scratch_ms = time_ms(lambda: stream_sketch(
        uber, 15, 30, left_drm=big.left_drm, right_drm=big.right_drm))
    print(f"{tag} growth 10/20 -> 15/30 {grow_ms:.3f} ms (three blocks), a "
          f"sketch from scratch at 15/30 {scratch_ms:.3f} ms")
    return {"launches": launches, "calls": calls, "shape": uber.shape,
            "worst_rel": worst, "grow_ms": grow_ms,
            "scratch_ms": scratch_ms}


def tt_sum_problem():
    """The paper's TT-sum workload on the card: ``tt_sketch_torch.
    experiments.problems.timings_vs_error_problem`` (``TT_SUM_TERMS``
    random TTs of rank ``TT_SUM_RANK`` and shape ``TT_SUM_SHAPE`` in
    float64, coefficients ``logspace(0, -10, TT_SUM_TERMS)``, seed 179): the
    JAX package's cores, drawn with numpy on the host and uploaded."""
    from tt_sketch_torch.experiments import problems

    return problems.timings_vs_error_problem(
        n_dims=len(TT_SUM_SHAPE), dim=TT_SUM_SHAPE[0], tt_rank=TT_SUM_RANK,
        num_tts=TT_SUM_TERMS, device="cuda")


def tt_sum_rel_error(tt, X, b2):
    """Relative error of the TT ``tt`` against the sum ``X`` (``b2`` is
    ``|X|^2``) from TT inner products, never densified."""
    a2, ab = tt.norm() ** 2, tt.dot(X)
    return float(np.sqrt(max(a2 + b2 - 2.0 * ab, 0.0)) / np.sqrt(b2))


def phase_tt_sum():
    """(d) STTA at 24/25, OTTS at 24/25 and HMT at 24 of the TT-sum
    workload with the default TT-DRMs: linearity of the STTA sketch, the
    relative error of each from TT inner products (never densified), the
    median time of each."""
    import torch

    from tt_sketch_torch import hmt_sketch, orthogonal_sketch, stream_sketch

    tag = "# phase 12 [tt-sum]:"
    t0 = time.perf_counter()
    X = tt_sum_problem()
    torch.cuda.synchronize()
    gib = sum(c.numel() for t in X.tensors for c in t.cores) * 8 / 2 ** 30
    print(f"{tag} {X}, {TT_SUM_TERMS} TTs of rank {TT_SUM_RANK}, "
          f"{gib:.2f} GiB of f64 cores, drawn on the host and uploaded in "
          f"{time.perf_counter() - t0:.2f} s")
    sk, ldrm, rdrm = stream_sketch(X, 24, 25, seed=0, return_drm=True)
    parts = [stream_sketch(t, 24, 25, left_drm=ldrm, right_drm=rdrm).sketch_
             for t in X.tensors]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    lin = _worst_parts(tag, "STTA sketch of the sum vs the sum of the "
                       "summands' sketches (same DRMs)",
                       sk.Psi_cores + sk.Omega_mats,
                       total.Psi_cores + total.Omega_mats, TT_SUM_TOL)
    t0 = time.perf_counter()
    b2 = X.norm() ** 2
    gram_s = time.perf_counter() - t0

    runs = {"STTA 24/25": lambda s: stream_sketch(X, 24, 25, seed=s),
            "OTTS 24/25": lambda s: orthogonal_sketch(X, 24, 25, seed=s),
            "HMT 24": lambda s: hmt_sketch(X, 24, seed=s)}
    # the same sketches with their DRMs given: what drawing them costs
    _, oleft, oright = orthogonal_sketch(X, 24, 25, seed=0, return_drm=True)
    _, hdrm = hmt_sketch(X, 24, seed=0, return_drm=True)
    given = {"STTA 24/25": lambda: stream_sketch(X, 24, 25, left_drm=ldrm,
                                                 right_drm=rdrm),
             "OTTS 24/25": lambda: orthogonal_sketch(
                 X, 24, 25, left_drm=oleft, right_drm=oright),
             "HMT 24": lambda: hmt_sketch(X, 24, drm=hdrm)}
    out = {"linearity_rel": lin, "gib": gib, "gram_s": gram_s}
    for name, run in runs.items():
        tt = run(0)
        tt = tt.to_tt() if hasattr(tt, "to_tt") else tt
        if not all(bool(torch.isfinite(c).all()) for c in tt.cores):
            raise AssertionError(f"tt-sum {name}: non-finite cores")
        err = tt_sum_rel_error(tt, X, b2)
        med, times, enqueue_ms = _median_sketch_ms(run, groups=3, inner=1)
        given_ms = time_ms(given[name], reps=3, warmup=1)
        lo, hi = (TT_SUM_ERROR_RANGE if not name.startswith("STTA")
                  else (0.0, np.inf))
        print(f"{tag} {name}: relative error {err:.6e} (TT inner products; "
              f"guard {lo:g}-{hi:g}), sketch median {med:.3f} ms "
              f"({', '.join(f'{t:.3f}' for t in times)}), host enqueue "
              f"{enqueue_ms:.3f} ms, with the DRMs given {given_ms:.3f} ms")
        if not lo <= err <= hi:
            raise AssertionError(f"tt-sum {name}: relative error {err}")
        out[name] = {"rel_error": err, "ms": med, "times": times,
                     "enqueue_ms": enqueue_ms, "given_ms": given_ms}
    print(f"{tag} |X|^2 from {TT_SUM_TERMS ** 2} TT inner products in "
          f"{gram_s:.3f} s")
    return out


def _to(t, device):
    """The same tensor with its arrays on ``device``."""
    from tt_sketch_torch.formats import (
        CPTensor,
        SparseTensor,
        TensorSum,
        TensorTrain,
        TuckerTensor,
    )

    if isinstance(t, TensorSum):
        return TensorSum([_to(x, device) for x in t.tensors])
    if isinstance(t, SparseTensor):
        return SparseTensor(t.shape, t.indices, t.entries, device=device)
    if isinstance(t, TuckerTensor):
        return TuckerTensor([U.to(device) for U in t.factors],
                            t.core.to(device))
    cls = CPTensor if isinstance(t, CPTensor) else TensorTrain
    return cls([c.to(device) for c in t.cores])


def phase_formats():
    """(e) CP (``cp_problem``, STTA 30/60), Tucker ((30,)^4, multilinear
    rank 5, STTA 25/30) and ``tt_plus_sparse_problem`` with a
    ``DenseGaussianDRM`` pair (STTA 30/60) in float64: STTA, OTTS and HMT
    on the card and on the CPU in this process, the recovered TTs within
    ``FORMAT_TOL`` of each other; the Tucker tensor recovered exactly."""
    import torch

    from tt_sketch_torch import (
        DenseGaussianDRM,
        TensorTrain,
        TuckerTensor,
        hmt_sketch,
        orthogonal_sketch,
        stream_sketch,
    )

    from tt_sketch_torch.experiments import problems

    tucker = TuckerTensor.random((30,) * 4, 5, seed=179, device="cpu")
    cases = (("cp", problems.cp_problem(device="cpu"), (30, 60), None),
             ("tucker", tucker, (25, 30), None),
             ("tt+sparse dense-gauss",
              problems.tt_plus_sparse_problem(device="cpu"), (30, 60),
              DenseGaussianDRM))
    out = {}
    for name, host, (lr, rr), drm in cases:
        card = _to(host, "cuda")
        kw = dict(left_drm_type=drm, right_drm_type=drm)
        methods = {
            f"STTA {lr}/{rr}": lambda t, dev: stream_sketch(
                t, lr, rr, seed=3, device=dev, **kw).to_tt(),
            f"OTTS {lr}/{rr}": lambda t, dev: orthogonal_sketch(
                t, lr, rr, seed=3, device=dev, **kw),
            f"HMT {lr}": lambda t, dev: hmt_sketch(
                t, lr, seed=3, drm_type=drm, device=dev)}
        for method, run in methods.items():
            t0 = time.perf_counter()
            on_card = run(card, "cuda")
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            on_host = run(host, "cpu")
            host_s = time.perf_counter() - t0
            moved = TensorTrain([c.cpu() for c in on_card.cores])
            diff = moved.error(on_host, relative=True)
            err = on_host.error(host, relative=True)
            print(f"# phase 12 [{name}]: {method}: recovered TT on the card "
                  f"vs on the CPU, relative {diff:.3e} (tol {FORMAT_TOL:g}); "
                  f"relative error of the recovery {err:.3e}; card "
                  f"{card_s * 1e3:.3f} ms, CPU {host_s * 1e3:.3f} ms (one "
                  f"call each, host clock)")
            if not diff <= FORMAT_TOL:
                raise AssertionError(f"{name} {method}: card and CPU differ "
                                     f"by {diff:.3e}")
            if name == "tucker" and not err <= TUCKER_EXACT_TOL:
                raise AssertionError(f"tucker {method}: recovery error "
                                     f"{err:.3e} > {TUCKER_EXACT_TOL:g}")
            out[f"{name} {method}"] = {"card_vs_cpu": diff, "error": err,
                                       "card_ms": card_s * 1e3,
                                       "cpu_ms": host_s * 1e3}
    return out


def phase_sums_and_formats(uber, paths, ops, skern):
    """Phase 12: (a)-(c) on uber, their kernels' calls against the plain
    versions and their figures added to ``skern`` (``by_path``); (d) the
    TT-sum workload; (e) CP, Tucker and dense Gaussian DRMs."""
    from tt_sketch_torch import SparseGaussianDRM, SparseSignDRM

    t0 = time.perf_counter()
    shards, plan_s = split_uber(uber)
    new = {}
    for label, drm_type, whole in (
            ("uber sum gauss", SparseGaussianDRM, paths["uber gauss"]),
            ("uber sum sign", SparseSignDRM, paths["uber sign"])):
        new[label] = phase_sum_main(label, uber, shards, drm_type, whole)
    new["uber sum hmt gauss"] = phase_sum_hmt(uber, shards)
    new["uber grow gauss"] = phase_grow(uber)
    del shards
    worst = {}
    for label, m in new.items():
        for name in SPARSE_KERNELS:
            for i, args in enumerate(m["calls"].get(name, [])):
                a, r = _check(name, f"{label} call {i}", args, phase=12)
                w = worst.setdefault((name, label), [0.0, 0.0])
                w[0], w[1] = max(w[0], a), max(w[1], r)
    for name, by_path in path_figures(new, worst, ops, phase=12).items():
        skern[name].update(by_path)
    tt_sum = phase_tt_sum()
    formats = phase_formats()
    print(f"# phase 12: {time.perf_counter() - t0:.1f} s (the shards' plans "
          f"{plan_s:.2f} s)")
    return new, tt_sum, formats


#: results/cookie.csv: the JAX package's cookie record (``run_cookie``, five
#: runs of each solve at full size); phase 13 holds each solve's final
#: internal residual to half the smallest and twice the largest of its runs
COOKIE_CSV = "results/cookie.csv"
#: ``run_cookie``'s full setting, the arguments of ``drivers.problems_cookie``
COOKIE = dict(num_coeffs=20, n=60)
#: rounding -> (max_rank, maxiter) of the two solves
COOKIE_SOLVES = {"sketch": (50, 50), "pairwise": (10, 50)}
#: the true residual of the preconditioned system, densified, as
#: ``tests/test_solvers.py::test_gmres_cookie`` bounds it
COOKIE_TRUE_RESIDUAL = {"sketch": 0.6, "pairwise": 0.3}
GMRES_PARITY_ITERS = 8   # the sketch solve on the card (both routes) and on the CPU
GMRES_PROFILE_ITERS = 4  # iterations of the profiled solve
GMRES_TOL = 1e-7   # rtol of residual histories, relative error of solutions: card vs CPU, f64 sketch rounding through SVDs and pseudo-inverses, 8 iterations
ROUND_TOL = 1e-10  # relative: the same f64 rounding by two routes, or on the card and on the CPU (TT arithmetic, never densified)
SVDVALS_TOL = 1e-10  # relative: |S_mu|_2 of every unfolding against |TT|
TT_SVD_TOL = 1e-12   # relative: a TT-SVD's dense tensor on the card vs on the CPU
#: TT-SVD at the experiments' sizes: (name, order, size, rank, bound).  The
#: JAX test's bounds (tests/test_solvers.py::test_tt_svd_hilbert) are for
#: (4,)^5, where rank 8 is exact; at (5,)^7 rank 8 leaves 1.35e-9 (the
#: port on the CPU), so 1e-8 there.  sqrt: the recompression record.
TT_SVD_CASES = (("hilbert", 5, 4, 5, 1e-4), ("hilbert", 5, 4, 8, 1e-12),
                ("hilbert", 7, 5, 5, 1e-4), ("hilbert", 7, 5, 8, 1e-8),
                ("sqrt", 5, 10, 10, None))
#: results/recompression.csv, the TT-SVD row: sqrt_problem() at rank 10
SQRT_TT_SVD_ERROR = 2.767404636802036e-09


def cookie_records(rounding, max_rank):
    """The final internal residuals of runs 0-4 of one solve in
    ``COOKIE_CSV`` and the seed of run 0 (``_seed_for(max_rank, 0, 12)``
    of ``drivers.py``)."""
    import csv

    with open(COOKIE_CSV) as f:
        rows = sorted((r for r in csv.DictReader(f)
                       if r["name"] == f"GMRES-{rounding}"
                       and float(r["max_rank"]) == max_rank
                       and float(r["run"]) < 5),
                      key=lambda r: float(r["run"]))
    seed = _seed_for(max_rank, 0, 12)
    if [float(r["run"]) for r in rows] != [0, 1, 2, 3, 4] or int(
            float(rows[0]["seed"])) != seed:
        raise AssertionError(f"{COOKIE_CSV}: no runs 0-4 of GMRES-{rounding} "
                             f"at rank {max_rank} with seed {seed}")
    return [float(r["error"]) for r in rows], seed


def count_syncs(fn):
    """The host-device synchronizations ``fn()`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _finite(tag, tt):
    import torch

    if not all(bool(torch.isfinite(c).all()) for c in tt.cores):
        raise AssertionError(f"{tag}: non-finite cores")


def _timed_call(tag, what, run):
    """Median ms, host enqueue ms and busy share of ``run(seed)`` with the
    helpers of phases 5, 9 and 12; prints one line."""
    med, times, enqueue_ms = _median_sketch_ms(run, groups=3, inner=1)
    busy_us, window_us, _, _ = profile_window(run, n=1)
    print(f"{tag} {what}: median {med:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times)}), host enqueue "
          f"{enqueue_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms of "
          f"{window_us / 1e3:.3f} ({100 * busy_us / window_us:.1f} %)")
    return {"ms": med, "times": times, "enqueue_ms": enqueue_ms,
            "busy": busy_us / window_us, "device_ms": busy_us / 1e3}


def phase_rounding():
    """(a) ``round_tt_sum`` of the TT-sum workload at max_rank 24 by the
    pairwise, sketch and orth_sketch modes (relative errors from TT inner
    products), ``svdvals`` of the pairwise result, and the first two
    summands rounded at eps 1e-3, max_rank 50 by the host-read and the
    masked sweeps, on the card and on the CPU."""
    import torch

    from tt_sketch_torch import round_tt_sum

    tag = "# phase 13 [rounding]:"
    X = tt_sum_problem()
    b2 = X.norm() ** 2
    out = {}
    for method in ("pairwise", "sketch", "orth_sketch"):
        def run(seed, method=method):
            return round_tt_sum(X, 24, method=method, seed=seed)

        tt = run(0)
        _finite(f"round_tt_sum {method}", tt)
        err = tt_sum_rel_error(tt, X, b2)
        lo, hi = (0.0, np.inf) if method == "sketch" else TT_SUM_ERROR_RANGE
        print(f"{tag} round_tt_sum {method} at 24: ranks {tt.rank}, relative "
              f"error {err:.6e} (TT inner products; guard {lo:g}-{hi:g})")
        if not lo <= err <= hi:
            raise AssertionError(f"round_tt_sum {method}: error {err}")
        out[method] = {"rel_error": err,
                       **_timed_call(tag, f"round_tt_sum {method}", run)}
        if method == "pairwise":
            norm = tt.norm()
            svs = tt.svdvals()
            worst = max(abs(float(np.linalg.norm(s)) - norm) / norm
                        for s in svs)
            print(f"{tag} svdvals of the pairwise result: {len(svs)} "
                  f"unfoldings, worst | |S|_2 - |TT| | / |TT| {worst:.3e} "
                  f"(tol {SVDVALS_TOL:g})")
            if not worst <= SVDVALS_TOL:
                raise AssertionError(f"svdvals: {worst:.3e}")
            out["svdvals_worst"] = worst
    two = X.tensors[0].add(X.tensors[1])
    del X
    host = two.round(eps=1e-3, max_rank=50)
    masked, eff = two.round_masked(eps=1e-3, max_rank=50)
    trimmed = masked.trim_to_ranks(eff)
    diff = trimmed.error(host, relative=True)
    t0 = time.perf_counter()
    on_cpu = _to(two, "cpu").round(eps=1e-3, max_rank=50)
    cpu_s = time.perf_counter() - t0
    cpu_diff = _to(host, "cpu").error(on_cpu, relative=True)
    print(f"{tag} two summands (ranks {two.rank}) at eps 1e-3, max_rank 50: "
          f"host-read ranks {host.rank}, masked ranks {tuple(eff.tolist())} "
          f"(static {masked.rank}), trimmed vs host-read {diff:.3e}; CPU "
          f"ranks {on_cpu.rank}, card vs CPU {cpu_diff:.3e} (tol "
          f"{ROUND_TOL:g}; CPU {cpu_s:.2f} s, host clock)")
    if not (tuple(eff.tolist()) == host.rank == on_cpu.rank
            and diff <= ROUND_TOL and cpu_diff <= ROUND_TOL):
        raise AssertionError("eps rounding: routes or devices differ")
    out["eps"] = {
        "ranks": host.rank, "trimmed_vs_host": diff, "card_vs_cpu": cpu_diff,
        "cpu_s": cpu_s,
        "round": _timed_call(tag, "round(eps=1e-3, max_rank=50)",
                             lambda s: two.round(eps=1e-3, max_rank=50)),
        "round_masked": _timed_call(
            tag, "round_masked(eps=1e-3, max_rank=50) + trim_to_ranks",
            lambda s: two.round_masked(eps=1e-3, max_rank=50)[0]
            .trim_to_ranks(eff)),
    }
    del two, host, masked, trimmed
    torch.cuda.empty_cache()
    return out


def phase_tt_svd():
    """(b) ``tt_svd`` at the experiments' sizes (``TT_SVD_CASES``) on the
    card and on the CPU in this process: dense tensors within
    ``TT_SVD_TOL``, the errors under their bounds."""
    import torch

    from tt_sketch_torch import hilbert_tensor, sqrt_tensor, tt_svd
    from tt_sketch_torch.formats import DenseTensor

    tag = "# phase 13 [tt-svd]:"
    out = {}
    for name, order, size, rank, bound in TT_SVD_CASES:
        def make(dev):
            if name == "hilbert":
                return DenseTensor(hilbert_tensor(order, size, device=dev))
            # sqrt_problem(): the dense tensor as sparse COO
            return DenseTensor(sqrt_tensor((size,) * order,
                                           device=dev)).to_sparse()

        card_t, host_t = make("cuda"), make("cpu")
        card, host = tt_svd(card_t, rank), tt_svd(host_t, rank)
        a, b = card.to_dense().cpu(), host.to_dense()
        diff = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        err = card.error(card_t, relative=True)
        ms = time_ms(lambda: tt_svd(card_t, rank), reps=3, warmup=1)
        label = f"{name} ({size},)^{order} rank {rank}"
        print(f"{tag} {label}: ranks {card.rank}, relative error {err:.3e}"
              f" (bound {bound if bound else SQRT_TT_SVD_ERROR}), card vs "
              f"CPU {diff:.3e} (tol {TT_SVD_TOL:g}), {ms:.3f} ms on the card")
        if bound is None:
            ok = abs(err - SQRT_TT_SVD_ERROR) <= 1e-3 * SQRT_TT_SVD_ERROR
        else:
            ok = err < bound
        if not (ok and diff <= TT_SVD_TOL and card.rank == host.rank):
            raise AssertionError(f"tt_svd {label}: error {err:.3e}, card vs "
                                 f"CPU {diff:.3e}")
        out[label] = {"rel_error": err, "card_vs_cpu": diff, "ms": ms}
    return out


def phase_gmres():
    """(c) Sketched and pairwise TT-GMRES on the synthetic cookie problem at
    ``run_cookie``'s full setting with ``device_resident="auto"`` (True on
    the card): the final internal residual against the JAX package's record,
    the densified true residual, times, a profiled short solve, the syncs
    of one iteration of each route; then the sketch solve at
    ``GMRES_PARITY_ITERS`` iterations on the card by both routes and on the
    CPU."""
    import torch

    from tt_sketch_torch import tt_sum_gmres
    from tt_sketch_torch.experiments.drivers import problems_cookie
    from tt_sketch_torch.formats import TensorSum

    tag = "# phase 13 [gmres]:"
    A, b, pre = problems_cookie(**COOKIE, device="cuda")
    print(f"{tag} cookie problem {A.in_shape}, {len(A.linear_maps)} maps, "
          f"float64, preconditioned, tolerance 1e-6")
    out = {}
    for rounding, (max_rank, maxiter) in COOKIE_SOLVES.items():
        records, seed = cookie_records(rounding, max_rank)
        lo, hi = 0.5 * min(records), 2.0 * max(records)
        kw = dict(max_rank=max_rank, precond=pre, tolerance=1e-6,
                  rounding_method=rounding, seed=seed)
        label = f"{rounding} at rank {max_rank}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, hist = tt_sum_gmres(A, b, maxiter=maxiter, **kw)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        _finite(f"gmres {label}", x)
        final = hist["residual_norm"][-1]
        b_pr = pre(b)
        Ax_pr = TensorSum([pre(t) for t in A(x).tensors])
        true = float(torch.linalg.norm((b_pr + Ax_pr * (-1.0)).to_dense())
                     / torch.linalg.norm(b_pr.to_dense()))
        del b_pr, Ax_pr
        steps = hist["step_time"][1:]
        print(f"{tag} {label}, maxiter {maxiter}, seed {seed}: "
              f"{len(hist['residual_norm']) - 1} iterations, {total_s:.3f} s "
              f"total (history {hist['total_time']:.3f} s), step median "
              f"{1e3 * float(np.median(steps)):.3f} ms, final round "
              f"{1e3 * hist['final_round_time']:.3f} ms, ranks {x.rank}; "
              f"final internal residual {final:.6e} (guard {lo:.3e}-"
              f"{hi:.3e}; {COOKIE_CSV} runs 0-4: "
              f"{', '.join(f'{r:.4e}' for r in records)}); true residual of "
              f"the preconditioned system {true:.4e} (bound "
              f"{COOKIE_TRUE_RESIDUAL[rounding]})")
        if not (lo <= final <= hi and true < COOKIE_TRUE_RESIDUAL[rounding]):
            raise AssertionError(f"gmres {label}: residual {final:.3e}, "
                                 f"true {true:.3e}")
        busy_us, window_us, rows, host = profile_window(
            lambda s: tt_sum_gmres(A, b, maxiter=GMRES_PROFILE_ITERS, **kw),
            n=1)
        print(f"{tag} {label}: a {GMRES_PROFILE_ITERS}-iteration solve under "
              f"the profiler, per iteration: window {window_us / 1e3 / GMRES_PROFILE_ITERS:.3f} "
              f"ms (host), device busy {busy_us / 1e3 / GMRES_PROFILE_ITERS:.3f}"
              f" ms ({100 * busy_us / window_us:.1f} %)")
        print_profile(13, 1, "solve", busy_us, window_us, rows, host)
        syncs = {}
        for dr in (True, False):
            one, two = (count_syncs(lambda m=m: tt_sum_gmres(
                A, b, maxiter=m, device_resident=dr, **kw)) for m in (1, 2))
            syncs["device-resident" if dr else "eager"] = two - one
        print(f"{tag} {label}: host-device syncs of one iteration "
              f"(set_sync_debug_mode, a 2-iteration solve less a 1-iteration"
              f" one): {syncs}")
        out[label] = {"iterations": len(hist["residual_norm"]) - 1,
                      "total_s": total_s, "final_residual": final,
                      "records": records, "true_residual": true,
                      "step_ms": 1e3 * float(np.median(steps)),
                      "final_round_ms": 1e3 * hist["final_round_time"],
                      "busy": busy_us / window_us,
                      "iter_device_ms": busy_us / 1e3 / GMRES_PROFILE_ITERS,
                      "iter_window_ms": window_us / 1e3 / GMRES_PROFILE_ITERS,
                      "syncs": syncs}
    # where the syncs come from: one QR and one SVD at a pairwise round's
    # shapes, the SVD with torch's default CUDA solver and with gesvdj
    rng = torch.Generator(device="cuda").manual_seed(0)
    attrib = {}
    for shape in ((20, 400), (400, 20), (50, 1000)):
        M = torch.randn(shape, generator=rng, device="cuda",
                        dtype=torch.float64)
        for what, fn in (
                ("qr", lambda: torch.linalg.qr(M)),
                ("svd", lambda: torch.linalg.svd(M, full_matrices=False)),
                ("svd gesvdj", lambda: torch.linalg.svd(
                    M, full_matrices=False, driver="gesvdj"))):
            attrib[f"{what} {shape}"] = count_syncs(fn)
    print(f"{tag} host-device syncs of one call: {attrib}")
    out["syncs_per_call"] = attrib
    max_rank, _ = COOKIE_SOLVES["sketch"]
    _, seed = cookie_records("sketch", max_rank)
    kw = dict(max_rank=max_rank, tolerance=1e-6, rounding_method="sketch",
              seed=seed, maxiter=GMRES_PARITY_ITERS)
    A_h, b_h, pre_h = problems_cookie(**COOKIE, device="cpu")
    runs = {"card, device-resident": lambda: tt_sum_gmres(
                A, b, precond=pre, device_resident=True, **kw),
            "card, eager": lambda: tt_sum_gmres(
                A, b, precond=pre, device_resident=False, **kw),
            "cpu": lambda: tt_sum_gmres(A_h, b_h, precond=pre_h, **kw)}
    got = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        x, hist = run()
        torch.cuda.synchronize()
        got[name] = (_to(x, "cpu"), np.asarray(hist["residual_norm"]),
                     time.perf_counter() - t0)
    x_ref, res_ref, _ = got["cpu"]
    parity = {}
    for name, (x, res, secs) in got.items():
        hist_rel = float(np.max(np.abs(res / res_ref - 1.0)))
        sol_rel = x.error(x_ref, relative=True)
        print(f"{tag} sketch at rank {max_rank}, {GMRES_PARITY_ITERS} "
              f"iterations, {name}: {secs:.3f} s, final residual "
              f"{res[-1]:.6e}; against the CPU: history {hist_rel:.3e}, "
              f"solution {sol_rel:.3e} (tol {GMRES_TOL:g})")
        if not (res.shape == res_ref.shape and hist_rel <= GMRES_TOL
                and sol_rel <= GMRES_TOL):
            raise AssertionError(f"gmres {name} differs from the CPU")
        parity[name] = {"s": secs, "history_rel": hist_rel,
                        "solution_rel": sol_rel}
    out["parity"] = parity
    return out


def phase_rounding_and_solvers():
    """Phase 13: (a) rounding at the TT-sum size, (b) TT-SVD, (c)
    TT-GMRES on the cookie problem."""
    t0 = time.perf_counter()
    out = {"rounding": phase_rounding(), "tt_svd": phase_tt_svd(),
           "gmres": phase_gmres()}
    print(f"# phase 13: {time.perf_counter() - t0:.1f} s")
    return out


#: phase 14 (a): ``run_dimension_scaling``'s full setting
#: (``tt_sketch_tpu/experiments/drivers.py:140-188``) and its record
SCALING_CSV = "results/dimension_scaling.csv"
SCALING = dict(order=8192, dim=30, rank=30, recomp=10, seed=179)
#: the orders of the card-against-CPU check, each method through its entry
#: point: STTA at 1024; OTTS at 256, because at 1024 its CPU run alone
#: takes 18 s of the script's time (NVIDIA H100 80GB HBM3 host, 700 W)
SCALING_PARITY_ORDERS = {"STTA": 1024, "OTTS": 256}
#: the order at which STTA's syncs, device operations and busy share are
#: counted stage by stage (per mode they do not depend on the order; the
#: profiler's own cost grows with the operations it records)
SCALING_COUNT_ORDER = 128
#: (method, extra) of ``drivers._seed_for(order, run, extra)``
SCALING_SEEDS = {"STTA": 4, "HMT": 5, "TT-SVD": 6, "OTTS": 7}
SCALING_TOL = 1e-3        # relative: an error on the card's Gram route vs results/dimension_scaling.csv (the Gram identity's cancellation at errors near 8.6e-6)
SCALING_EXACT_TOL = 1e-6  # relative: STTA's error on the exact route vs the record
SCALING_CARD_CPU_TOL = 1e-10  # relative, exact route: an f64 rounded TT on the card vs on the CPU (the same DRM bits, QRs and SVDs in another library)
#: phase 14 (b): uber streamed through sessions
SESSION_SHARDS = 16
SESSION_CHECKPOINT_EVERY = 4
SESSION_CRASH_AFTER = 6
SESSION_ERROR_TOL = 1e-4  # absolute: a session's sample error vs the whole sketch's with the same DRMs
RESUME_TOL = 1e-6  # relative Frobenius: a resumed Psi/Omega vs the uninterrupted one where a launch on the path sums in no fixed order
#: names of the port's own CUDA kernels, as a trace shows them
PORT_KERNEL_NAMES = ("lazy_gaussian_kernel", "sparse_sign_kernel",
                     "sparse_psi_kernel", "chain_step_kernel",
                     "segment_reduce_kernel", "segment_run_kernel",
                     "dual_project_kernel", "reduce_read_kernel",
                     "reduce_u_kernel")


def _seed_for(rank, run, extra):
    """The drivers' seed rule (``tt_sketch_torch.experiments.drivers``)."""
    from tt_sketch_torch.experiments.drivers import _seed_for as rule

    return rule(rank, run, extra)


def scaling_records(order):
    """The JAX package's record of ``run_dimension_scaling`` at ``order``,
    run 0: the three sketches with the hash stream rounded to 10 and TT-SVD
    at 10, 9 and 8, as ``{(name, rank): error}``; the seeds checked against
    ``_seed_for``."""
    import csv

    with open(SCALING_CSV) as f:
        rows = [r for r in csv.DictReader(f)
                if float(r["order"]) == order and float(r["run"]) == 0
                and not r["protocol"]]
    out = {}
    for r in rows:
        if r["name"] == "TT-SVD":
            key = ("TT-SVD", int(float(r["rank"])))
        elif (r["drm_stream"] == "hash"
              and float(r["recompression_rank"]) == SCALING["recomp"]):
            key = (r["name"], SCALING["recomp"])
        else:
            continue
        if int(float(r["seed"])) != _seed_for(order, 0,
                                               SCALING_SEEDS[key[0]]):
            raise AssertionError(f"{SCALING_CSV}: {key} has seed {r['seed']}")
        out[key] = float(r["error"])
    recomp = SCALING["recomp"]
    want = {(m, recomp) for m in ("STTA", "HMT", "OTTS")} | {
        ("TT-SVD", k) for k in (recomp, recomp - 1, recomp - 2)}
    if set(out) != want:
        raise AssertionError(f"{SCALING_CSV}: order {order} run 0 has "
                             f"{sorted(out)}, expected {sorted(want)}")
    return out


def _stta_in_stages(tt, seed, timer):
    """``uniform_stream_sketch(tt, 30, 60, seed, drm_stream="hash")`` from
    the entry point's own pieces, each stage timed: the hash DRMs, the
    chains with Ψ/Ω, the batched recovery."""
    from tt_sketch_torch.engine.uniform import (
        _drm_pair,
        _recovery_direction,
        _stacked_input,
        uniform_assemble,
        uniform_stream_sketch_stacked,
        unstack_tt,
    )

    rank = SCALING["rank"]
    X, dtype, d, n = _stacked_input(tt, None)
    timer.start("STTA sketch: hash DRMs")
    Y, Z = _drm_pair(d, n, rank, 2 * rank, seed, dtype, "hash", X[0].device)
    timer.stop("STTA sketch: hash DRMs", (Y, Z))
    timer.start("STTA sketch: chains, Psi, Omega")
    psis, om = uniform_stream_sketch_stacked(X, Y, Z)
    timer.stop("STTA sketch: chains, Psi, Omega", (psis, om))
    del X, Y, Z
    timer.start("STTA sketch: batched lstsq")
    rec = uniform_assemble(psis, om, _recovery_direction(rank, 2 * rank))
    timer.stop("STTA sketch: batched lstsq", rec)
    return unstack_tt(*rec)


def _scaling_sketch(name, tt, order):
    """One sketch of ``run_dimension_scaling`` (``tasks.py:140-222``)
    through the port's entry points."""
    from tt_sketch_torch.engine.uniform import (
        uniform_hmt_sketch,
        uniform_orthogonal_sketch,
        uniform_stream_sketch,
    )

    rank, dim = SCALING["rank"], SCALING["dim"]
    seed = _seed_for(order, 0, SCALING_SEEDS[name])
    if name == "STTA":
        return uniform_stream_sketch(tt, rank, 2 * rank, seed=seed,
                                     drm_stream="hash")[0]
    if name == "HMT":
        return uniform_hmt_sketch(tt, rank, seed=seed, drm_stream="hash")
    return uniform_orthogonal_sketch(tt, min(rank, dim), 2 * rank, seed=seed,
                                     drm_stream="hash")


def _scaling_row(name, stacked, order, timer):
    """A row of the order-scaling record (STTA, HMT, OTTS): sketch through
    the entry point, round to the record's 10, relative error by the
    device's route; each stage timed by ``timer``.  Returns ``(rounded,
    error)``."""
    from tt_sketch_torch.engine.uniform import (
        stack_tt,
        uniform_rel_error,
        uniform_round_fixed,
        unstack_tt,
    )

    rank = SCALING["recomp"]
    timer.start(f"{name} sketch")
    rec = _scaling_sketch(name, unstack_tt(*stacked), order)
    timer.stop(f"{name} sketch", rec)
    src = stack_tt(rec)
    del rec
    label = f"{name} round to {rank}"
    timer.start(label)
    out = uniform_round_fixed(*src, max_rank=rank)
    timer.stop(label, out)
    del src
    timer.start(f"{name} error")
    err = uniform_rel_error(out, stacked)
    timer.stop(f"{name} error")
    return out, err


def _uniform_counts(tag, order):
    """STTA at ``order`` stage by stage: the sketch split into its own
    stages (``_stta_in_stages``, held to ``uniform_stream_sketch`` with the
    same seed), then its syncs (``set_sync_debug_mode``), device operations
    (the profiler), busy share and seconds per stage, printed per mode and
    scaled to the full order."""
    from tt_sketch_torch import profiling
    from tt_sketch_torch.experiments.problems import (
        exp_decay_uniform_problem,
    )
    from tt_sketch_torch.engine.uniform import (
        _rel_error_exact,
        stack_tt,
        uniform_rel_error,
        uniform_round_fixed,
        uniform_stream_sketch,
        unstack_tt,
    )

    dim, rank = SCALING["dim"], SCALING["rank"]
    seed = _seed_for(order, 0, SCALING_SEEDS["STTA"])
    stacked = exp_decay_uniform_problem(order, dim, rank,
                                        SCALING["seed"], device="cuda")
    timer = profiling.StageTimer()
    staged = _stta_in_stages(unstack_tt(*stacked), seed, timer)
    whole = uniform_stream_sketch(unstack_tt(*stacked), rank, 2 * rank,
                                  seed=seed, drm_stream="hash")[0]
    diff = _rel_error_exact(stack_tt(staged), stack_tt(whole))
    print(f"{tag} STTA at order {order} in stages vs uniform_stream_sketch:"
          f" {diff:.3e} (exact route on the card; tol {ROUND_TOL:g})")
    if not diff <= ROUND_TOL:
        raise AssertionError(f"STTA in stages vs the entry point {diff:.3e}")
    modes, full = order - 2, SCALING["order"] - 2
    for stage, secs in timer.summary().items():
        print(f"{tag} {stage}: {1e3 * secs['total_s'] / modes:.4f} ms per "
              f"mode, about {secs['total_s'] / modes * full:.2f} s at order "
              f"{SCALING['order']} (host clock, device finished)")
    held = {}

    def sketch():
        held["rec"] = _stta_in_stages(unstack_tt(*stacked), seed,
                                      profiling.StageTimer())

    stages = {
        "sketch": sketch,
        "round": lambda: held.__setitem__("out", uniform_round_fixed(
            *stack_tt(held["rec"]), max_rank=SCALING["recomp"])),
        "error": lambda: uniform_rel_error(held["out"], stacked),
    }
    counts = {}
    for stage, fn in stages.items():
        counts[stage] = {"syncs": count_syncs(fn)}
        busy_us, window_us, rows, _ = profile_window(lambda s: fn(), n=1)
        counts[stage].update(ops=sum(r[1] for r in rows),
                             busy=busy_us / window_us,
                             window_ms=window_us / 1e3)
    for stage, c in counts.items():
        print(f"{tag} STTA {stage} at order {order}: {c['syncs']} host-device"
              f" syncs ({c['syncs'] / modes:.2f} per mode, about "
              f"{c['syncs'] / modes * full:.0f} at order {SCALING['order']}),"
              f" {c['ops']} device operations ({c['ops'] / modes:.2f} per "
              f"mode), window {c['window_ms']:.1f} ms, device busy "
              f"{100 * c['busy']:.1f} %")
    counts["sketch stages"] = timer.summary()
    return counts


def phase_order_scaling():
    """(a) The order-scaling experiment at ``run_dimension_scaling``'s full
    setting on the uniform engine, each sketch through its entry point:
    STTA 30/60, HMT 30 and OTTS 30/60 with the hash DRM stream, rounded to
    10, and TT-SVD at 10, 9 and 8, their errors held to
    ``results/dimension_scaling.csv``; STTA's error also on the exact
    route; the peak memory; STTA's sketch in its stages, and its syncs,
    launches and busy share per stage, at ``SCALING_COUNT_ORDER``; STTA and
    OTTS through their entry points at ``SCALING_PARITY_ORDERS`` on the
    card and on the CPU."""
    import torch

    from tt_sketch_torch import profiling
    from tt_sketch_torch.experiments.problems import (
        exp_decay_uniform_problem,
    )
    from tt_sketch_torch.engine.uniform import (
        _rel_error_exact,
        _truncate_fixed,
        uniform_orthogonalize,
        uniform_rel_error,
    )

    tag = "# phase 14 [order scaling]:"
    order, dim, rank = SCALING["order"], SCALING["dim"], SCALING["rank"]
    records = scaling_records(order)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = profiling.memory_stats()["allocated_bytes.all.current"]
    timer = profiling.StageTimer()
    timer.start("problem")
    stacked = exp_decay_uniform_problem(order, dim, rank,
                                        SCALING["seed"], device="cuda")
    timer.stop("problem", stacked)
    print(f"{tag} exp_decay_uniform_problem({order}, {dim}, {rank}, seed="
          f"{SCALING['seed']}), float64, interior {tuple(stacked[1].shape)}:"
          f" {timer.total('problem'):.2f} s (numpy on the host, one upload "
          f"per piece)")
    out = {"records": {f"{k[0]} {k[1]}": v for k, v in records.items()}}
    for name in ("STTA", "HMT", "OTTS"):
        t0 = time.perf_counter()
        rounded, err = _scaling_row(name, stacked, order, timer)
        secs = time.perf_counter() - t0
        ref = records[(name, SCALING["recomp"])]
        rel = abs(err - ref) / ref
        row = {"error": err, "record": ref, "rel": rel, "s": secs}
        print(f"{tag} {name} at order {order}: error {err:.15e} (Gram "
              f"route; record {ref:.15e}, rel {rel:.2e}, tol "
              f"{SCALING_TOL:g}), {secs:.2f} s")
        if not (np.isfinite(err) and rel <= SCALING_TOL):
            raise AssertionError(f"{name} error {err} vs record {ref}")
        if name == "STTA":
            timer.start("STTA exact error")
            exact = _rel_error_exact(rounded, stacked)
            timer.stop("STTA exact error")
            exact_rel = abs(exact - ref) / ref
            row.update(exact=exact, exact_rel=exact_rel)
            print(f"{tag} STTA on the exact route: {exact:.15e} (record "
                  f"{ref:.15e}, rel {exact_rel:.2e}, tol "
                  f"{SCALING_EXACT_TOL:g}); the Gram route's {err:.15e}")
            if not exact_rel <= SCALING_EXACT_TOL:
                raise AssertionError(f"STTA exact error {exact}")
        del rounded
        out[name] = row
    recomp = SCALING["recomp"]
    # the three TT-SVD rows share one LR orthogonalization; each runs its
    # own truncation sweep (uniform_round_fixed = the two in a row)
    timer.start("TT-SVD orthogonalize")
    orth = uniform_orthogonalize(*stacked)
    timer.stop("TT-SVD orthogonalize", orth)
    orth_s = timer.total("TT-SVD orthogonalize")
    print(f"{tag} TT-SVD: one LR orthogonalization for the three rows in "
          f"{orth_s:.2f} s")
    for k in (recomp, recomp - 1, recomp - 2):
        t0 = time.perf_counter()
        label = f"TT-SVD truncate to {k}"
        timer.start(label)
        rounded = _truncate_fixed(*orth, max_rank=k)
        timer.stop(label, rounded)
        timer.start("TT-SVD error")
        err = uniform_rel_error(rounded, stacked)
        timer.stop("TT-SVD error")
        del rounded
        secs = time.perf_counter() - t0
        ref = records[("TT-SVD", k)]
        rel = abs(err - ref) / ref
        print(f"{tag} TT-SVD at {k}: error {err:.15e} (record {ref:.15e}, "
              f"rel {rel:.2e}, tol {SCALING_TOL:g}), {secs:.2f} s")
        if not rel <= SCALING_TOL:
            raise AssertionError(f"TT-SVD at {k}: error {err} vs {ref}")
        out[f"TT-SVD {k}"] = {"error": err, "record": ref, "rel": rel,
                              "s": secs, "shared_orthogonalize_s": orth_s}
    del orth
    torch.cuda.synchronize()
    stats = profiling.memory_stats()
    out["peak_bytes"] = stats["allocated_bytes.all.peak"] - live
    out["reserved_peak_bytes"] = stats["reserved_bytes.all.peak"]
    print(f"{tag} stages (StageTimer, host clock with the device finished):")
    for line in timer.report().splitlines():
        print(f"#   {line}")
    print(f"{tag} peak memory of the order-{order} runs: "
          f"{out['peak_bytes'] / 2 ** 30:.2f} GiB allocated above the "
          f"{live / 2 ** 30:.2f} GiB live before them, "
          f"{out['reserved_peak_bytes'] / 2 ** 30:.2f} GiB reserved in all "
          f"(profiling.memory_stats)")
    out["stages"] = timer.summary()
    del stacked
    torch.cuda.empty_cache()

    out["counts"] = _uniform_counts(tag, SCALING_COUNT_ORDER)
    print(f"{tag} card vs CPU: STTA at order {SCALING_PARITY_ORDERS['STTA']}"
          f" as set; OTTS at {SCALING_PARITY_ORDERS['OTTS']}, not 1024, to "
          f"keep the phase's time (its CPU run alone takes about 18 s at "
          f"1024)")
    parity = {}
    for name, small in SCALING_PARITY_ORDERS.items():
        t0 = time.perf_counter()
        host = exp_decay_uniform_problem(small, dim, rank,
                                         SCALING["seed"], device="cpu")
        card = tuple(x.to("cuda") for x in host)
        print(f"{tag} order {small}: the problem made on the host in "
              f"{time.perf_counter() - t0:.2f} s and copied to the card")
        t0 = time.perf_counter()
        a, err_card = _scaling_row(name, card, small, profiling.StageTimer())
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b, err_cpu = _scaling_row(name, host, small, profiling.StageTimer())
        cpu_s = time.perf_counter() - t0
        diff = uniform_rel_error(tuple(x.cpu() for x in a), b)
        print(f"{tag} {name} at order {small} through its entry point, card "
              f"vs CPU: rounded TTs differ by {diff:.3e} (exact route on the "
              f"CPU; tol {SCALING_CARD_CPU_TOL:g}); errors {err_card:.6e} "
              f"(card, Gram) and {err_cpu:.6e} (CPU, exact); {card_s:.2f} s "
              f"on the card, {cpu_s:.2f} s on the CPU")
        if not diff <= SCALING_CARD_CPU_TOL:
            raise AssertionError(f"{name} at order {small}: card vs CPU "
                                 f"{diff:.3e}")
        parity[name] = {"order": small, "rel": diff, "card_s": card_s,
                        "cpu_s": cpu_s}
        del card, host
    out["card_vs_cpu"] = parity
    torch.cuda.empty_cache()
    print(f"{tag} {time.perf_counter() - t_phase:.1f} s")
    return out


def _parts(sk):
    return list(sk.Psi_cores) + list(sk.Omega_mats)


def _same_parts(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(_parts(a), _parts(b),
                                                  strict=True))


def session_path(label, uber, shards, drm_type, workdir):
    """One session type on uber's shards: the uninterrupted stream (launch
    counts, ms per consume) held to the same consumes under the plain
    versions, a crash after ``SESSION_CRASH_AFTER`` shards
    with a checkpoint every ``SESSION_CHECKPOINT_EVERY`` and its resume,
    held to the uninterrupted stream and to the whole tensor's sketch with
    the same DRMs; checkpoint and resume times, the checkpoint's bytes; a
    consume's host enqueue and busy share."""
    import torch

    from tt_sketch_torch import (
        StageTimer,
        StreamingSketchSession,
        load_sketch,
        save_sketch,
        stream_sketch,
    )
    from tt_sketch_torch.data.frostt import sample_error

    tag = f"# phase 14 [session {label}]:"
    t_path = time.perf_counter()
    kw = dict(left_drm_type=drm_type, right_drm_type=drm_type,
              dtype=torch.float32)

    def new(**extra):
        return StreamingSketchSession(uber.shape, 10, 20, seed=0, **kw,
                                      **extra)

    timer = StageTimer()
    s1 = new()
    snap = {}

    def feed():
        for i, piece in enumerate(shards):
            timer.start("consume")
            s1.consume(piece)
            timer.stop("consume", s1.result())
            if i + 1 == SESSION_CHECKPOINT_EVERY:
                snap["checkpointed"] = s1.result()
        return s1.result()

    full, launches, _ = _counted(feed)
    ran = {k: v for k, v in launches.items() if v}
    ldrm, rdrm = full.left_drm, full.right_drm
    if drm_type is not None:
        planned = _sum_of_launches(expected_launches(t, ldrm, rdrm)
                                   for t in shards)
        if launches != planned:
            raise AssertionError(f"{label}: launches {launches}, from the "
                                 f"plans {planned}")
    if not ran:
        raise AssertionError(f"{label}: no kernel of ours launched")
    consume_ms = [1e3 * t for t in timer.times["consume"]]
    print(f"{tag} {len(shards)} shards consumed, kernel launches "
          f"{ran}{' (as the plans give)' if drm_type else ''}; ms per "
          f"consume: median {np.median(consume_ms):.3f} (first "
          f"{consume_ms[0]:.3f}, max {max(consume_ms):.3f}; host clock, "
          f"device finished)")
    with plain_kernels():
        ref = new()
        for piece in shards:
            ref.consume(piece)
        plain = ref.result()
    if (plain.left_drm.seed, plain.right_drm.seed) != (ldrm.seed, rdrm.seed):
        raise AssertionError(f"{label}: the plain session's DRMs differ")
    worst_plain = _worst_parts(tag, "every Psi/Omega of the uninterrupted "
                               "stream vs the same consumes under the plain "
                               "versions on the card", _parts(full),
                               _parts(plain), PSI_TOL)
    del ref, plain

    ck = workdir / f"{label}.npz"
    s2 = new(checkpoint_path=ck, checkpoint_every=SESSION_CHECKPOINT_EVERY)
    for piece in shards[:SESSION_CRASH_AFTER]:
        s2.consume(piece)
    del s2   # the crash: the checkpoint after shard 4 is all that is left
    timer.start("resume")
    s3 = StreamingSketchSession.resume(ck)
    timer.stop("resume", s3.result())
    if s3.n_consumed != SESSION_CHECKPOINT_EVERY:
        raise AssertionError(f"{label}: resumed at {s3.n_consumed}")
    resumed_at = s3.result()
    on_cpu = load_sketch(ck, device="cpu")
    if not (all(torch.equal(x.cpu(), y) for x, y in zip(
            _parts(resumed_at), _parts(on_cpu), strict=True))
            and _same_parts(resumed_at, snap["checkpointed"])):
        raise AssertionError(f"{label}: the checkpoint on the CPU, on the "
                             f"card and the stream after "
                             f"{SESSION_CHECKPOINT_EVERY} shards differ")
    for piece in shards[s3.n_consumed:]:
        s3.consume(piece)
    resumed = s3.result()
    bits = _same_parts(resumed, full)
    worst = max(_rel(x, y) for x, y in zip(_parts(resumed), _parts(full)))
    print(f"{tag} crash after {SESSION_CRASH_AFTER} shards, resumed at "
          f"{SESSION_CHECKPOINT_EVERY} (load_sketch(device='cpu') of the "
          f"checkpoint equal bit for bit to the card's copy and to the "
          f"stream after {SESSION_CHECKPOINT_EVERY} shards); resumed vs "
          f"uninterrupted: {'bit for bit' if bits else 'NOT bit for bit'}, "
          f"worst rel {worst:.3e}")
    if not bits:
        again = stream_sketch(shards[0], 10, 20, left_drm=ldrm,
                              right_drm=rdrm)
        once = stream_sketch(shards[0], 10, 20, left_drm=ldrm,
                             right_drm=rdrm)
        print(f"{tag} one shard sketched twice gives the same bits: "
              f"{_same_parts(again, once)}; held to {RESUME_TOL:g}")
        if not worst <= RESUME_TOL:
            raise AssertionError(f"{label}: resumed vs uninterrupted "
                                 f"{worst:.3e}")
    whole = stream_sketch(uber, 10, 20, left_drm=ldrm, right_drm=rdrm)
    lin = _worst_parts(tag, "every Psi/Omega of the resumed stream vs the "
                       "whole tensor's sketch with the same DRMs",
                       _parts(resumed), _parts(whole), PSI_TOL)
    err = sample_error(resumed.to_tt(), uber)
    err_whole = sample_error(whole.to_tt(), uber)
    print(f"{tag} sample_error(to_tt()): resumed {err:.6f}, whole tensor "
          f"{err_whole:.6f} (within {SESSION_ERROR_TOL:g})")
    if not abs(err - err_whole) <= SESSION_ERROR_TOL:
        raise AssertionError(f"{label}: sample error {err} vs {err_whole}")
    nbytes = ck.stat().st_size
    extra = {"kind": "streaming_session", "n_consumed": len(shards)}
    probe = workdir / f"{label}-probe.npz"
    for _ in range(3):
        timer.start("checkpoint write")
        save_sketch(probe, resumed, extra=extra)
        timer.stop("checkpoint write")
        timer.start("resume (again)")
        back = StreamingSketchSession.resume(probe)
        timer.stop("resume (again)", back.result())
    med = {k: 1e3 * float(np.median(v)) for k, v in timer.times.items()}
    print(f"{tag} checkpoint of {nbytes} bytes; ms per checkpoint write "
          f"{med['checkpoint write']:.3f}, per resume {med['resume']:.3f} "
          f"(first), {med['resume (again)']:.3f} (median of 3); host clock")
    sess = new()
    sess.consume(shards[0])
    timed = _timed_call(tag, "consume of one shard",
                        lambda s: sess.consume(shards[s % len(shards)]))
    print(f"{tag} {time.perf_counter() - t_path:.1f} s")
    return {"launches": ran, "consume_ms": float(np.median(consume_ms)),
            "consume_times_ms": consume_ms, "bit_for_bit": bits,
            "resumed_vs_uninterrupted": worst, "linearity_rel": lin,
            "plain_rel": worst_plain,
            "sample_error": err, "whole_sample_error": err_whole,
            "checkpoint_bytes": nbytes,
            "checkpoint_ms": med["checkpoint write"],
            "resume_ms": med["resume"], "resume_again_ms":
            med["resume (again)"], "consume": timed}


def phase_sessions_and_profiling(uber):
    """(b) uber streamed in ``SESSION_SHARDS`` planned shards through a
    session with a Gaussian pair and one with the default TT-DRMs; (c) a
    trace of one consume and the allocator's statistics."""
    import json as _json
    import shutil
    from pathlib import Path

    import torch

    from tt_sketch_torch import SparseGaussianDRM, StreamingSketchSession
    from tt_sketch_torch import profiling

    workdir = Path(__file__).resolve().parent / "build" / "phase14"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    t0 = time.perf_counter()
    shards = uber.split(SESSION_SHARDS, psi_plan=True).tensors
    torch.cuda.synchronize()
    print(f"# phase 14: uber split into {SESSION_SHARDS} planned shards of "
          f"{shards[0].nnz}-{shards[-1].nnz} nnz in "
          f"{time.perf_counter() - t0:.2f} s on the host; plans "
          f"{shards[0].psi_plan}")
    out = {label: session_path(label, uber, shards, drm_type, workdir)
           for label, drm_type in (("gauss", SparseGaussianDRM),
                                   ("tt", None))}

    tag = "# phase 14 [profiling]:"
    sess = StreamingSketchSession(uber.shape, 10, 20, seed=0,
                                  left_drm_type=SparseGaussianDRM,
                                  right_drm_type=SparseGaussianDRM,
                                  dtype=torch.float32)
    sess.consume(shards[0])
    trace_dir = workdir / "trace"
    with profiling.trace(str(trace_dir)):
        sess.consume(shards[1])
        torch.cuda.synchronize()
    files = sorted(trace_dir.glob("*.json"))
    if len(files) != 1:
        raise AssertionError(f"trace wrote {files}")
    events = _json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    ours = sorted({k for k in kernels
                   if any(n in k for n in PORT_KERNEL_NAMES)})
    print(f"{tag} profiling.trace of one consume wrote {files[0].name} "
          f"({files[0].stat().st_size} bytes, {len(events)} events, "
          f"{len(kernels)} kernels), ours: "
          f"{[k[:60] for k in ours]}")
    if not ours:
        raise AssertionError("the trace names no kernel of ours")
    stats = profiling.memory_stats()
    if not stats or not all(isinstance(v, int) for v in stats.values()):
        raise AssertionError("memory_stats() on the card")
    print(f"{tag} memory_stats(): {len(stats)} integer stats, peak "
          f"{stats['allocated_bytes.all.peak'] / 2 ** 30:.3f} GiB allocated "
          f"since the order-scaling runs' reset")
    out["trace"] = {"file_bytes": files[0].stat().st_size,
                    "our_kernels": ours}
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def phase_uniform_and_sessions(uber):
    """Phase 14: (a) the order-scaling record on the uniform engine, (b)
    streaming sessions with checkpoints on uber, (c) profiling."""
    t0 = time.perf_counter()
    out = {"scaling": phase_order_scaling(),
           **phase_sessions_and_profiling(uber)}
    print(f"# phase 14: {time.perf_counter() - t0:.1f} s")
    return out


def _shared(t):
    """A copy of ``t`` in shared host memory (handed to the ranks, not
    copied per rank)."""
    import torch

    host = torch.empty(t.shape, dtype=t.dtype).share_memory_()
    host.copy_(t)
    return host


def _max_rel(ours, ref):
    """The worst ``max|a - b| / max|b|`` over the parts."""
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(ours, ref))


def _loaded(sketches, key, device="cuda"):
    """The Ψ and Ω of ``key`` that rank 0 saved, on ``device``."""
    import torch

    psi, om = [], []
    while f"{key}/psi{len(psi)}" in sketches:
        psi.append(torch.from_numpy(sketches[f"{key}/psi{len(psi)}"]))
    while f"{key}/omega{len(om)}" in sketches:
        om.append(torch.from_numpy(sketches[f"{key}/omega{len(om)}"]))
    return [t.to(device) for t in psi], [t.to(device) for t in om]


def _nccl_one_rank(uber_host, single):
    """The port's NCCL code path in a world of one rank on cuda:0, held to
    the single-device sketch."""
    import torch
    import torch.distributed as dist

    from tt_sketch_torch.dist import (
        global_mesh,
        initialize_multihost,
        sharded_sparse_stream_sketch,
    )

    initialize_multihost(f"localhost:{_free_port()}", 1, 0, backend="nccl")
    try:
        backend = dist.get_backend()
        sk = sharded_sparse_stream_sketch(
            uber_host, 10, 20, seed=0, mesh=global_mesh(("data",)),
            dtype=torch.float32)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    ours = sk.Psi_cores + sk.Omega_mats
    ref = single.Psi_cores + single.Omega_mats
    rel = max(_rel(a, b) for a, b in zip(ours, ref))
    bits = all(torch.equal(a, b) for a, b in zip(ours, ref))
    print(f"# phase 15 [nccl 1 rank]: backend {backend}, uber through "
          f"sharded_sparse_stream_sketch on a mesh of one rank: worst rel err "
          f"{rel:.3e} against the single-device sketch (tol "
          f"{NCCL_ONE_RANK_TOL:g}); bit for bit: {bits}")
    if not rel <= NCCL_ONE_RANK_TOL:
        raise AssertionError(f"one-rank NCCL world: {rel:.3e}")
    return {"backend": backend, "rel": rel, "bit_for_bit": bits}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sharded(ops, uber=None):
    """Phase 15: the sharded sketches in a world of ``SHARD_WORLD`` ranks
    (``chip_smoke_dist.run_rank``), each guard held here against the
    single-device sketch; then the one-rank NCCL world."""
    import json as _json
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    import torch.multiprocessing as mp

    import chip_smoke_dist as CD
    from tt_sketch_torch import SparseGaussianDRM, TensorTrain, stream_sketch
    from tt_sketch_torch.data.frostt import load_frostt, sample_error
    from tt_sketch_torch.dist.sharded import _ranks, _seeds
    from tt_sketch_torch.drm import TensorTrainDRM
    from tt_sketch_torch.engine.sketch import SketchedTensorTrain
    from tt_sketch_torch.engine.sketch_container import SketchContainer
    from tt_sketch_torch.kernels.dense_engine import (
        dense_stream_sketch_bisect,
    )

    tag = "# phase 15 [sharded]:"
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= SHARD_WORLD else "gloo"
    where = ("one card each" if backend == "nccl" else
             f"all on cuda:0 ({n_cards} card(s); NCCL refuses two ranks on "
             f"one device): the card is time-shared, so no time here is a "
             f"scaling number")
    world = f"{SHARD_WORLD} ranks over {backend}, {where}"
    print(f"{tag} world: {world}")

    t0 = time.perf_counter()
    dense_tt = TensorTrain.random(DENSE_SHARD_SHAPE, DENSE_SHARD_TT_RANK,
                                  seed=179, dtype=torch.float32,
                                  device="cuda")
    X_card = dense_tt.to_dense()
    X = _shared(X_card)
    tts = tt_sum_problem()
    stacked = [_shared(torch.stack([t.cores[mu] for t in tts.tensors]))
               for mu in range(len(TT_SUM_SHAPE))]
    torch.cuda.synchronize()
    print(f"{tag} inputs in shared host memory in "
          f"{time.perf_counter() - t0:.2f} s: dense X {DENSE_SHARD_SHAPE} "
          f"f32 ({X.numel() * 4 / 1e9:.2f} GB) from a TT of rank "
          f"{DENSE_SHARD_TT_RANK}; the TT sum's stacked cores "
          f"({sum(c.numel() for c in stacked) * 8 / 2 ** 30:.2f} GiB f64)")

    out_dir = Path(tempfile.mkdtemp(
        dir=Path(__file__).resolve().parent / "build"))
    cfg = {"world": SHARD_WORLD, "backend": backend, "port": _free_port(),
           "out": str(out_dir), "ops": ops, "tt_sum_shape": TT_SUM_SHAPE}
    t0 = time.perf_counter()
    mp.spawn(CD.run_rank, args=(cfg, X, stacked), nprocs=SHARD_WORLD,
             join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [_json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(SHARD_WORLD)]
    with np.load(out_dir / "sketches.npz") as f:
        sketches = dict(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    del X, stacked
    print(f"{tag} the world ran in {spawn_s:.1f} s (spawn, join and every "
          f"path; rank 0 joined and loaded uber in "
          f"{ranks[0]['join_s']:.1f} s); ranks on "
          f"{[(r['backend'], r['device']) for r in ranks]}")
    out = {"world": world, "spawn_s": spawn_s, "paths": {}}

    # uber on each mesh against the single-device sketch at the same seed
    if uber is None:
        uber = load_sparse("uber-synthetic")
    single = stream_sketch(uber, 10, 20, seed=CD.SEED,
                           left_drm_type=SparseGaussianDRM,
                           right_drm_type=SparseGaussianDRM,
                           dtype=torch.float32)
    single_err = sample_error(single.to_tt(), uber)
    want = dict.fromkeys(SPARSE_KERNELS, 0) | PATH_LAUNCHES["uber gauss"]
    for label in CD.UBER_MESHES:
        psi, om = _loaded(sketches, f"uber {label}")
        worst = _max_rel(psi + om, single.Psi_cores + single.Omega_mats)
        sk = SketchedTensorTrain(SketchContainer(psi, om), single.left_drm,
                                 single.right_drm)
        err = sample_error(sk.to_tt(), uber)
        per_rank = [r[f"uber {label}"] for r in ranks]
        launches = [{k: v for k, v in r["launches"].items() if v}
                    for r in per_rank]
        print(f"{tag} uber on mesh {label}: worst max|diff|/max|ref| "
              f"{worst:.3e} against the single-device stream_sketch (tol "
              f"{SHARD_TOL:g}); sample error {err:.6f}, single-device "
              f"{single_err:.6f} (tol {SHARD_SAMPLE_TOL:g}); launches per "
              f"rank {launches}")
        if not worst <= SHARD_TOL:
            raise AssertionError(f"uber {label}: {worst:.3e}")
        if not abs(err - single_err) <= SHARD_SAMPLE_TOL:
            raise AssertionError(f"uber {label}: sample error {err}")
        for r, n in enumerate(launches):
            if dict.fromkeys(SPARSE_KERNELS, 0) | n != want:
                raise AssertionError(f"uber {label} rank {r}: launches {n}")
        for r, p in enumerate(per_rank):
            print(f"{tag} uber {label} rank {r}: entry point {p['entry_s']:.2f}"
                  f" s (plans included), sketcher prepared in "
                  f"{p['prep_s']:.2f} s; median over "
                  f"{len(CD.TIMED_SEEDS) - 1} fresh seeds: world "
                  f"{p['world_ms']:.3f} ms, this rank up to its all_reduce "
                  f"{p['rank_ms']:.3f} ms, all_reduce {p['all_reduce_ms']:.3f}"
                  f" ms of {p['all_reduce_bytes']} bytes")
        out["paths"][f"uber {label}"] = {
            "worst_rel": worst, "sample_error": err,
            "single_sample_error": single_err, "per_rank": per_rank}
    out["figures"] = {label: ranks[0][f"uber {label}"]["figures"]
                      for label in CD.UBER_MESHES}

    # the dense stream against the bisect engine over the whole X
    shape = DENSE_SHARD_SHAPE
    left, right = _ranks(*CD.DENSE_RANKS, shape)
    lseed, rseed = _seeds(CD.SEED, len(shape))
    ldrm = TensorTrainDRM(left, shape, False, seed=lseed,
                          dtype=torch.float32)
    rdrm = TensorTrainDRM(right, shape, True, seed=rseed,
                          dtype=torch.float32)
    ref_psi, ref_om = dense_stream_sketch_bisect(
        X_card, ldrm.cores, rdrm.cores, projector="matmul")
    del X_card
    psi, om = _loaded(sketches, "dense")
    worst = _max_rel(psi + om, ref_psi + ref_om)
    rec = SketchedTensorTrain(SketchContainer(psi, om), ldrm, rdrm).to_tt()
    rec_err = rec.error(dense_tt, relative=True)
    dense = [r["dense"] for r in ranks]
    print(f"{tag} dense {shape} f32, TT-DRMs {CD.DENSE_RANKS}, slabs of "
          f"{shape[0] // SHARD_WORLD}: worst max|diff|/max|ref| {worst:.3e} "
          f"against dense_stream_sketch_bisect over the whole X (two "
          f"torch.matmul; tol {SHARD_TOL:g}); recovery error {rec_err:.3e} "
          f"(tol {DENSE_RECOVERY_TOL:g}); launches per rank "
          f"{[p['launches'] for p in dense]}")
    for r, p in enumerate(dense):
        print(f"{tag} dense rank {r}: world "
              f"{', '.join(f'{t:.1f}' for t in p['world_ms'])} ms, this rank "
              f"up to its all_reduce (its slab's upload included) "
              f"{', '.join(f'{t:.1f}' for t in p['rank_ms'])} ms, all_reduce"
              f" {', '.join(f'{t:.3f}' for t in p['all_reduce_ms'])} ms of "
              f"{p['all_reduce_bytes']} bytes")
    if not (worst <= SHARD_TOL and rec_err <= DENSE_RECOVERY_TOL):
        raise AssertionError(f"dense: {worst:.3e}, recovery {rec_err:.3e}")
    if any(p["launches"] != {"dual_project": 1} for p in dense):
        raise AssertionError("dense: a rank's slab is not one dual_project")
    out["paths"]["dense"] = {"worst_rel": worst, "recovery_error": rec_err,
                             "per_rank": dense}
    del ref_psi, ref_om, dense_tt
    torch.cuda.empty_cache()

    # the TT sum against stream_sketch of the TensorSum, the same TT-DRMs
    left, right = _ranks(*CD.TT_SUM_RANKS, TT_SUM_SHAPE)
    lseed, rseed = _seeds(CD.SEED, len(TT_SUM_SHAPE))
    ldrm = TensorTrainDRM(left, TT_SUM_SHAPE, False, seed=lseed)
    rdrm = TensorTrainDRM(right, TT_SUM_SHAPE, True, seed=rseed)
    ref = stream_sketch(tts, *CD.TT_SUM_RANKS, left_drm=ldrm,
                        right_drm=rdrm)
    psi, om = _loaded(sketches, "tt_sum")
    rel = max(_rel(a, b) for a, b in zip(psi + om,
                                         ref.Psi_cores + ref.Omega_mats))
    tsum = [r["tt_sum"] for r in ranks]
    print(f"{tag} TT sum: {TT_SUM_TERMS} summands padded to "
          f"{-(-TT_SUM_TERMS // SHARD_WORLD) * SHARD_WORLD} over "
          f"{SHARD_WORLD} ranks, STTA {CD.TT_SUM_RANKS} f64: worst rel err "
          f"{rel:.3e} against stream_sketch of the TensorSum with the same "
          f"TT-DRMs (tol {TT_SUM_TOL:g}); world "
          f"{[round(t, 1) for t in tsum[0]['world_ms']]} ms, ranks up to "
          f"their all_reduce {[round(p['rank_ms'][-1], 1) for p in tsum]} "
          f"ms, all_reduce {[round(p['all_reduce_ms'][-1], 3) for p in tsum]}"
          f" ms of {tsum[0]['all_reduce_bytes']} bytes")
    if not rel <= TT_SUM_TOL:
        raise AssertionError(f"tt sum: {rel:.3e}")
    out["paths"]["tt_sum"] = {"rel": rel, "per_rank": tsum}
    del tts, ref

    out["nccl_one_rank"] = _nccl_one_rank(
        load_frostt("uber-synthetic", device="cpu").astype(torch.float32),
        single)
    out["s"] = time.perf_counter() - t_phase
    print(f"# phase 15: {out['s']:.1f} s")
    return out


FROSTT_CSV = "results/frostt.csv"
#: phase 16 (a): ``run_frostt`` at full size in float32 on these stand-ins
#: at these ranks, run 0 (18 rows: STTA r/2r and HMT r)
FROSTT_NAMES = ("uber-synthetic", "nips-synthetic", "lbnl-synthetic")
FROSTT_RANKS = (5, 10, 20)
#: the nips rows whose kernel calls are recorded and held to their plain
#: versions (planned modes of 17 and 24 rows at the driver's threshold 16)
FROSTT_RECORDED = ("nips-synthetic", 20)
FROSTT_RECORD_TOL = 5e-3  # relative: a float32 row vs results/frostt.csv's float32 row of the same seed (the f32 and f64 rows of one seed differ by 1.7e-3 on uber STTA at rank 5)
FROSTT_F64_TOL = 1e-6     # relative: a quick float64 row vs the record's float64 row of the same seed
FROSTT_PLAIN_TOL = 1e-4   # absolute: a row's sample error vs the same row under plain_kernels() (float32 sums in another order), as SESSION_ERROR_TOL
#: phase 16 (b): ``all --quick`` on the card against the port's CPU rows
#: (``tests/data/torch_quick_cpu``, made by the same CLI with ``--platform
#: cpu``): error within QUICK_RTOL relative plus QUICK_ATOL (float64;
#: cuBLAS/cuSOLVER against LAPACK, through pseudo-inverses, QRs and SVDs;
#: below 1e-10 both are exact recovery), an error from a Gram identity
#: within QUICK_GRAM_ATOL (the square root of a difference that cancels to
#: rounding noise: the timings' TT inner products, and the uniform engine's
#: ``uniform_rel_error``, exact on the CPU and Gram on the card, which
#: reads 0.0 for a TT-SVD row of 2.0e-10), the cookie's GMRES residuals (8
#: iterations) within GMRES_TOL and its final roundings' true residuals
#: within QUICK_RTOL
QUICK_CPU_DIR = "tests/data/torch_quick_cpu"
QUICK_RTOL, QUICK_ATOL, QUICK_GRAM_ATOL = 1e-6, 1e-10, 1e-6


def frostt_records(f64):
    """``results/frostt.csv``'s rows of one dtype as ``{(dataset, name,
    rank, seed): error}`` (the float32 rows, or the float64 ones)."""
    from tt_sketch_torch.experiments.runner import Experiment

    return {_frostt_key(r): r["error"] for r in Experiment(FROSTT_CSV).data
            if (r["dtype"] is None) == f64}


def _frostt_key(row):
    rank = row["left_rank"] if row["name"] == "STTA" else row["rank"]
    return row["dataset"], row["name"], int(rank), int(row["seed"])


def _label(dataset, name, rank):
    return f"frostt {dataset.split('-')[0]} {name.lower()} {rank}"


@contextlib.contextmanager
def _counting_tasks(rows, kept):
    """Wrap the FROSTT driver's two tasks: each row's kernel counts set to
    0 just before it and read just after (into ``rows``), the calls of the
    ``FROSTT_RECORDED`` rows recorded (into ``kept``, with the task, the
    tensor and its arguments)."""
    import torch

    from tt_sketch_torch.experiments import tasks

    fns = _kernel_fns()

    def wrap(task):
        def run(tensor, **kw):
            rank = kw.get("left_rank") or kw["rank"]
            name = "STTA" if "left_rank" in kw else "HMT"
            record = (kw["dataset"], rank) == FROSTT_RECORDED
            calls = {}
            torch.cuda.synchronize()
            for kern, _ in fns.values():
                kern.launches = 0
            with recording(calls) if record else contextlib.nullcontext():
                res = task(tensor, **kw)
            torch.cuda.synchronize()
            rows.append({"key": (kw["dataset"], name, rank, kw["seed"]),
                         "launches": {n: fns[n][0].launches
                                      for n in SPARSE_KERNELS}})
            if record:
                kept[_label(kw["dataset"], name, rank)] = {
                    "task": task, "tensor": tensor, "kw": kw,
                    "calls": calls, "error": res["error"]}
            return res
        return run

    saved = {n: getattr(tasks, n) for n in ("experiment_stream_sketch",
                                             "experiment_hmt_sketch")}
    for n, task in saved.items():
        setattr(tasks, n, wrap(task))
    try:
        yield
    finally:
        for n, task in saved.items():
            setattr(tasks, n, task)


def phase_frostt_driver(ops, smi, workdir):
    """(a) ``run_frostt`` through the ported driver at full size in float32
    (``FROSTT_NAMES`` at ``FROSTT_RANKS``, run 0): every row held to the
    record's float32 row of its seed, each row's kernel launches counted,
    the ``FROSTT_RECORDED`` rows held to the same rows under
    ``plain_kernels()`` and their kernel calls to their plain versions
    (timed and bounded; they join ``by_path``)."""
    from tt_sketch_torch.experiments import drivers

    tag = "# phase 16 [frostt driver]:"
    rows, kept = [], {}
    t0 = time.perf_counter()
    with _counting_tasks(rows, kept):
        exp = drivers.run_frostt(
            out=str(workdir), names=list(FROSTT_NAMES),
            ranks=list(FROSTT_RANKS), n_runs=1, dtype="float32",
            progress=False)
    driver_s = time.perf_counter() - t0
    want = len(FROSTT_NAMES) * len(FROSTT_RANKS) * 2
    if len(exp.data) != want or len(rows) != want:
        raise AssertionError(f"frostt driver: {len(exp.data)} rows, "
                             f"{len(rows)} counted, expected {want}")
    records = frostt_records(f64=False)
    records64 = frostt_records(f64=True)
    launches = {r["key"]: r["launches"] for r in rows}
    worst = 0.0
    out_rows = []
    for r in exp.data:
        key = _frostt_key(r)
        if r["dtype"] != "float32" or key not in records:
            raise AssertionError(f"frostt driver: no float32 record for "
                                 f"{key} (dtype {r['dtype']})")
        rel = abs(r["error"] - records[key]) / abs(records[key])
        worst = max(worst, rel)
        n = {k: v for k, v in launches[key].items() if v}
        rel64 = abs(r["error"] - records64[key]) / abs(records64[key])
        print(f"{tag} {key[0]} {key[1]} rank {key[2]} seed {key[3]}: sample "
              f"error {r['error']:.9f} (record {records[key]:.9f}, rel "
              f"{rel:.2e}, tol {FROSTT_RECORD_TOL:g}; the float64 record "
              f"{records64[key]:.9f}, rel {rel64:.2e}), time_taken "
              f"{r['time_taken']:.4f} s on {smi}; launches {n}")
        if not rel <= FROSTT_RECORD_TOL:
            raise AssertionError(f"frostt driver {key}: {r['error']} vs the "
                                 f"record's {records[key]}")
        if not n:
            raise AssertionError(f"frostt driver {key}: no kernel launched")
        out_rows.append({"key": list(key), "error": r["error"],
                         "record": records[key], "rel": rel,
                         "rel_f64_record": rel64,
                         "time_taken": r["time_taken"], "launches": n})
    print(f"{tag} {want} rows in {driver_s:.1f} s (loads, plans at "
          f"threshold 16, sketches, errors); worst rel vs the record "
          f"{worst:.2e}")

    paths, bad = {}, {}
    for label, k in kept.items():
        with plain_kernels():
            plain = k["task"](k["tensor"], **k["kw"])["error"]
        diff = abs(k["error"] - plain)
        print(f"{tag} {label}: sample error {k['error']:.6f}, under the "
              f"plain versions {plain:.6f} (diff {diff:.2e}, tol "
              f"{FROSTT_PLAIN_TOL:g})")
        if not diff <= FROSTT_PLAIN_TOL:
            raise AssertionError(f"{label}: kernels {k['error']} vs plain "
                                 f"{plain}")
        for name in SPARSE_KERNELS:
            for i, args in enumerate(k["calls"].get(name, [])):
                a, rel = _check(name, f"{label} call {i}", args, phase=16)
                w = bad.setdefault((name, label), [0.0, 0.0])
                w[0], w[1] = max(w[0], a), max(w[1], rel)
        paths[label] = {"calls": k["calls"], "shape": k["tensor"].shape}
    figures = path_figures(paths, bad, ops, phase=16)
    kept.clear()
    return {"rows": out_rows, "worst_rel": worst, "s": driver_s,
            "figures": {name: f for name, f in figures.items() if f}}


def _quick_cells_match(ours, ref, gram):
    """Whether a quick row on the card matches the CPU row (the note of
    ``QUICK_RTOL``; ``gram``: the card's error is a Gram identity's);
    returns (ok, the errors' difference)."""
    diff = abs(ours["error"] - ref["error"])
    if gram or ref.get("error_func") == "fast_error_func":
        ok = diff <= QUICK_GRAM_ATOL
    elif str(ref["name"]).startswith("GMRES"):
        ok = diff <= GMRES_TOL * abs(ref["error"])
        for col in ref:
            if col.startswith("final_true_error"):
                x = np.asarray(json.loads(ours[col]))
                y = np.asarray(json.loads(ref[col]))
                ok &= bool(np.all(np.abs(x - y)
                                  <= QUICK_RTOL * np.abs(y)))
    else:
        ok = diff <= QUICK_RTOL * abs(ref["error"]) + QUICK_ATOL
    return ok, diff


def phase_cli(workdir):
    """(b) ``python -m tt_sketch_torch.experiments list`` and ``all --quick
    --no-progress`` as subprocesses on the card: a non-zero exit fails; the
    quick FROSTT rows (float64, rank 5, seeds 5063/5064) held to the
    record's float64 rows (``FROSTT_F64_TOL``), every other quick row to
    the port's CPU rows (``QUICK_CPU_DIR``)."""
    from pathlib import Path

    from tt_sketch_torch.experiments.drivers import available_experiments
    from tt_sketch_torch.experiments.runner import Experiment

    tag = "# phase 16 [cli]:"
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "tt_sketch_torch.experiments"]
    t0 = time.perf_counter()
    listed = subprocess.run(cmd + ["list"], cwd=root, capture_output=True,
                            text=True, timeout=300)
    list_s = time.perf_counter() - t0
    if listed.returncode != 0 or (listed.stdout.split()
                                  != available_experiments()):
        raise AssertionError(f"experiments list: exit {listed.returncode}, "
                             f"{listed.stdout!r} {listed.stderr[-2000:]}")
    print(f"{tag} list: exit 0, {len(listed.stdout.split())} experiments "
          f"in {list_s:.1f} s")
    t0 = time.perf_counter()
    quick = subprocess.run(cmd + ["all", "--quick", "--no-progress", "--out",
                                  str(workdir)], cwd=root,
                           capture_output=True, text=True, timeout=900)
    quick_s = time.perf_counter() - t0
    for line in quick.stdout.splitlines():
        print(f"{tag}   {line}")
    if quick.returncode != 0:
        raise AssertionError(f"experiments all --quick: exit "
                             f"{quick.returncode}: {quick.stderr[-4000:]}")
    print(f"{tag} all --quick: exit 0 in {quick_s:.1f} s")

    records = frostt_records(f64=True)
    frostt = Experiment(str(workdir / "frostt.csv")).data
    worst_f64 = 0.0
    for r in frostt:
        key = _frostt_key(r)
        rel = abs(r["error"] - records[key]) / abs(records[key])
        worst_f64 = max(worst_f64, rel)
        print(f"{tag} quick frostt {key}: float64 sample error "
              f"{r['error']:.9f}, record {records[key]:.9f} (rel {rel:.2e}, "
              f"tol {FROSTT_F64_TOL:g}), {r['time_taken']:.3f} s")
        if r["dtype"] is not None or not rel <= FROSTT_F64_TOL:
            raise AssertionError(f"quick frostt {key}: {r['error']} vs "
                                 f"{records[key]}")
    if len(frostt) != 6:
        raise AssertionError(f"quick frostt: {len(frostt)} rows, expected 6")

    worst = {}
    for path in sorted(Path(QUICK_CPU_DIR).glob("*.csv")):
        ref = Experiment(str(path))
        ours = Experiment(str(workdir / path.name))
        keys = [c for c in ref.columns if c not in ("error", "time_taken")
                and not c.startswith(("final_true_error",
                                      "final_round_time"))]
        if ours.columns != ref.columns or len(ours.data) != len(ref.data):
            raise AssertionError(f"quick {path.name}: columns or rows differ")
        for a, b in zip(ours.data, ref.data):
            if any(a.get(c) != b.get(c) for c in keys):
                raise AssertionError(f"quick {path.name}: row {a} against "
                                     f"{b}")
            ok, diff = _quick_cells_match(a, b,
                                          path.stem == "dimension_scaling")
            worst[path.stem] = max(worst.get(path.stem, 0.0), diff)
            if not ok:
                raise AssertionError(f"quick {path.name}: card {a} against "
                                     f"the CPU's {b}")
        print(f"{tag} quick {path.stem}: {len(ref.data)} rows match the "
              f"CPU's (largest error difference {worst[path.stem]:.2e})")
    return {"list_s": list_s, "quick_s": quick_s, "frostt_f64_rel": worst_f64,
            "quick_worst": worst}


def phase_experiments(ops, smi):
    """Phase 16: the experiment harness on the card: (a) the FROSTT driver
    at full size, (b) the CLI."""
    import shutil
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(dir=build))
    try:
        out = phase_frostt_driver(ops, smi, workdir / "frostt")
        out["cli"] = phase_cli(workdir / "quick")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"# phase 16: {out['phase_s']:.1f} s")
    return out


#: phases that need another phase's results: 6 checks the calls that 5
#: and 9 recorded; 12 adds its figures to 6's and compares with 5's paths
PHASE_NEEDS = {6: {5, 9}, 12: {5, 6, 9}}
ALL_PHASES = frozenset(range(1, 17))


def selected_phases(argv):
    """The phases ``--phases`` names (default: every phase), with those
    they need; phase 1 (the build) always runs."""
    import argparse

    parser = argparse.ArgumentParser(description="Chip smoke test of the "
                                     "PyTorch/H100 port.")
    parser.add_argument(
        "--phases", default=None,
        help="comma-separated phase numbers, e.g. 1,15 (default: all; the "
             "kernels JSON line is printed only when every phase runs)")
    args = parser.parse_args(argv)
    if args.phases is None:
        return set(ALL_PHASES)
    chosen = {int(x) for x in args.phases.split(",") if x.strip()}
    if not chosen <= ALL_PHASES:
        parser.error(f"no phase {sorted(chosen - ALL_PHASES)}")
    chosen.add(1)
    for phase, needs in PHASE_NEEDS.items():
        if phase in chosen:
            chosen |= needs
    return chosen


def main(argv=None):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    phases = selected_phases(sys.argv[1:] if argv is None else argv)
    run = phases.__contains__
    import tt_sketch_torch  # noqa: F401  (fails outside a checkout)
    from tt_sketch_torch import SparseGaussianDRM, SparseSignDRM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    print(f"# phases {sorted(phases)}")

    smi = phase_build()
    ops = {"gauss": sass_ops_per_sample(), "sign_draw": sass_sign_ops()}
    census = sass_projection_census()
    kern = phase_kernel_check() if run(2) else None
    path = phase_main_path() if run(3) else None
    if run(4):
        phase_stream_sketch()
    paths = {}
    uber = (load_sparse("uber-synthetic") if phases & {5, 9, 12, 14, 15}
            else None)
    if run(5):
        paths["uber gauss"] = phase_sparse_main("uber gauss", uber,
                                                SparseGaussianDRM, "limit")
        paths["uber sign"] = phase_sparse_main("uber sign", uber,
                                               SparseSignDRM, "parity")
    if run(9):
        for label in ("uber hmt gauss", "uber otts gauss", "uber hmt tt"):
            paths[label] = phase_seq_main(label, uber)
    if run(5) or run(9):
        lbnl = load_sparse("lbnl-synthetic")
        if run(5):
            paths["lbnl gauss"] = phase_sparse_main("lbnl gauss", lbnl,
                                                    SparseGaussianDRM)
            paths["lbnl sign"] = phase_sparse_main("lbnl sign", lbnl,
                                                   SparseSignDRM)
        if run(9):
            paths["lbnl hmt gauss"] = phase_seq_main("lbnl hmt gauss", lbnl,
                                                     timed=False)
        del lbnl
    if run(6):
        skern = phase_sparse_kernels(paths, ops)
        seg_shapes = phase_segment_shapes()
    if run(7):
        phase_sign_rows()
    if run(8):
        phase_window_kernel()
    if run(10):
        phase_seq_kernels()
    diag = phase_projector_diag() if run(11) else None
    if run(12):
        sums, tt_sum, formats = phase_sums_and_formats(uber, paths, ops,
                                                       skern)
    solvers = phase_rounding_and_solvers() if run(13) else None
    uniform = phase_uniform_and_sessions(uber) if run(14) else None
    sharded = phase_sharded(ops, uber) if run(15) else None
    del uber
    experiments = phase_experiments(ops, smi) if run(16) else None
    if phases != ALL_PHASES:
        print(f"# phases {sorted(phases)} ran; the kernels line needs every "
              f"phase")
        print(f"# total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps(_device_line()))
        return

    b_ms, b_by, b_bytes, b_ops = bound_ms(*MAIN)
    bf16_bound = bound_ms(*MAIN, compute="bf16")
    entry = {
        "name": "dual_project",
        "route": "cuda",
        "source": "tt_sketch_torch/csrc/dual_project.cu",
        "replaces": "tt_sketch_tpu/kernels/pallas_project.py:74",
        "launches": path["launches"],
        "max_abs_err": kern["f32"]["max_abs_err"],
        "max_rel_err": kern["f32"]["rel_err"],
        "ms": kern["f32"]["ms"],
        "plain_ms": kern["f32"]["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": kern["library_ms"],
        "bound_bytes_ms": b_bytes,
        "bound_ops_ms": b_ops,
        "bf16_ms": kern["bf16"]["ms"],
        "bf16_plain_ms": kern["bf16"]["plain_ms"],
        "bf16_bound_ms": bf16_bound[0],
        "bf16_bound_by": bf16_bound[1],
        "bf16_max_rel_err": kern["bf16"]["rel_err"],
        "u_partial_bytes": kern["u_partial_bytes"],
        "shape": dict(zip(("P", "S", "r", "rho"), MAIN)),
        "diag": {t: diag["diag"][t] for t in DIAG_TAGS["dual_project"]},
        "sass": census,
        "card": smi,
    }
    entry["by_path"] = {"dense sharded": {
        "launches": sharded["paths"]["dense"]["per_rank"][0]["launches"][
            "dual_project"],
        "per_rank_launches": [p["launches"]["dual_project"] for p in
                              sharded["paths"]["dense"]["per_rank"]],
        "world": sharded["world"]}}
    for label, figures in sharded["figures"].items():
        per_rank = sharded["paths"][f"uber {label}"]["per_rank"]
        for name, fig in figures.items():
            skern[name][f"uber sharded {label} gauss"] = fig | {
                "per_rank_launches": [p["launches"].get(name, 0)
                                      for p in per_rank],
                "world": sharded["world"]}
    for name, figures in experiments["figures"].items():
        skern[name].update(figures)
    entries = [entry]
    for name in SPARSE_KERNELS:
        # the kernel's figures on the first main path that launches it;
        # by_path holds the same keys for every path that does
        label, m = next(iter(skern[name].items()))
        if paths[label]["launches"][name] != m["launches"]:
            raise AssertionError(f"{name}: {m['launches']} recorded calls, "
                                 f"{paths[label]['launches'][name]} counted")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "library_ms": None,
            **m,
            "bound_ops": ops,
            "shape": f"the {label} main path, rank 10/20; ms, plain_ms and "
                     f"bound_ms cover its {m['launches']} launch(es) of one "
                     f"sketch",
            "by_path": skern[name],
            **({"odd_shapes": seg_shapes} if name == "psi_segment" else {}),
            "card": smi,
        })
    for name in DIAG_KERNELS:
        d = diag[name]
        f32 = d["f32"]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "tt_sketch_torch/csrc/dual_project.cu",
            "replaces": DIAG_REPLACES[name],
            "launches": d["launches"],
            "max_abs_err": f32["max_abs_err"],
            "max_rel_err": f32["rel_err"],
            "ms": f32["ms"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"],
            "library_ms": d["library_ms"],
            **({} if "bf16" not in d else {
                "bf16_ms": d["bf16"]["ms"],
                "bf16_plain_ms": d["bf16"]["plain_ms"],
                "bf16_bound_ms": d["bf16"]["bound_ms"],
                "bf16_max_rel_err": d["bf16"]["rel_err"]}),
            "shape": dict(zip(("P", "S", "r", "rho"), MAIN)),
            "diag": {t: diag["diag"][t] for t in DIAG_TAGS[name]},
            **({"turns": d["turns"]} if "turns" in d else {}),
            "card": smi,
        })
    for name, ms, lib, what in (
            ("dual_project", kern["f32"]["ms"], kern["library_ms"],
             "two torch.matmul"),
            ("t_only", diag["t_only"]["f32"]["ms"],
             diag["t_only"]["library_ms"], "lib-T"),
            ("u_only", diag["u_only"]["f32"]["ms"],
             diag["u_only"]["library_ms"], "lib-U")):
        print(f"# {name} f32 at the main shape: {ms:.3f} ms against "
              f"{lib:.3f} ms for {what} ({lib / ms:.2f}x)")
    print(f"# dense main path: {path['gbps']:.2f} GB/s, "
          f"{path['ms_per_slab']:.3f} ms/slab, recovery error "
          f"{path['rel_err']:.3e}")
    for label, p in paths.items():
        if "ms" not in p:
            print(f"# sparse main path {label}: untimed, sample error "
                  f"{p['sample_error']:.4f}")
            continue
        metric = ("nnz_per_s" if label in SEQ_PATHS
                  else "sparse_stta_nnz_per_s")
        print(f"# sparse main path {label}: {p['ms']:.3f} ms per sketch, "
              f"{metric} {p['nnz_per_s']:.6e}, sample error "
              f"{p['sample_error']:.4f}, device busy {100 * p['busy']:.1f} %")
    for label, p in sums.items():
        if "ms" in p:
            print(f"# phase 12 path {label}: {p['ms']:.3f} ms per sketch, "
                  f"sample error {p['sample_error']:.4f}")
        else:
            print(f"# phase 12 path {label}: growth {p['grow_ms']:.3f} ms, "
                  f"from scratch {p['scratch_ms']:.3f} ms")
    print(f"# tt-sum: " + "; ".join(
        f"{k} {v['ms']:.3f} ms, error {v['rel_error']:.6e}"
        for k, v in tt_sum.items() if isinstance(v, dict)))
    print(f"# formats: worst card vs CPU "
          f"{max(v['card_vs_cpu'] for v in formats.values()):.3e}")
    rnd = solvers["rounding"]
    print("# rounding at 24: " + "; ".join(
        f"{k} {rnd[k]['ms']:.3f} ms, error {rnd[k]['rel_error']:.6e}"
        for k in ("pairwise", "sketch", "orth_sketch")))
    for label, g in solvers["gmres"].items():
        if "iterations" in g:
            print(f"# gmres {label}: {g['iterations']} iterations, "
                  f"{g['total_s']:.3f} s, residual {g['final_residual']:.4e}"
                  f", busy {100 * g['busy']:.1f} %")
    sc = uniform["scaling"]
    print("# order scaling at 8192 (Gram route): " + "; ".join(
        f"{k} {sc[k]['s']:.2f} s, error {sc[k]['error']:.6e}"
        for k in ("STTA", "HMT", "OTTS", "TT-SVD 10", "TT-SVD 9",
                  "TT-SVD 8")) + f"; peak {sc['peak_bytes'] / 2 ** 30:.2f} GiB")
    for label in ("gauss", "tt"):
        u = uniform[label]
        print(f"# session {label}: {u['consume_ms']:.3f} ms per consume, "
              f"checkpoint {u['checkpoint_ms']:.3f} ms, resume "
              f"{u['resume_ms']:.3f} ms, {u['checkpoint_bytes']} bytes, "
              f"resumed {'bit for bit' if u['bit_for_bit'] else 'within 1e-6'}"
              f", sample error {u['sample_error']:.4f}")
    for label, p in sharded["paths"].items():
        ms = (f"world {p['per_rank'][0]['world_ms']:.3f} ms"
              if label.startswith("uber") else
              f"world {p['per_rank'][0]['world_ms'][-1]:.1f} ms")
        print(f"# sharded {label} ({sharded['world']}): {ms}, "
              f"{', '.join(f'{k} {v:.3e}' for k, v in p.items() if k in ('worst_rel', 'rel', 'recovery_error'))}")
    print(f"# nccl one rank: rel {sharded['nccl_one_rank']['rel']:.3e}, bit "
          f"for bit {sharded['nccl_one_rank']['bit_for_bit']}")
    cli = experiments["cli"]
    print(f"# frostt driver: {len(experiments['rows'])} float32 rows in "
          f"{experiments['s']:.1f} s, worst rel vs the record "
          f"{experiments['worst_rel']:.2e}; cli all --quick "
          f"{cli['quick_s']:.1f} s, quick frostt vs the float64 record "
          f"{cli['frostt_f64_rel']:.2e}")
    print(f"# total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps(_device_line()))


def _device_line():
    import torch

    return {"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}


if __name__ == "__main__":
    main()

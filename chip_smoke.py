"""Smoke run of the PyTorch port (``posendf_torch``) on one CUDA card.

Drives the pose prior's main path (in fp32 and in bf16), the training path
and the serving path (the int8 forward, ``torch.export`` artifacts) through
their hand-written CUDA kernels on the full-width trained field
``docs/quality/ckpt_l8_best.msgpack``, the data-manufacturing path (kNN
labelling) against a 1,048,576-pose corpus, the bf16 / int8 tensor-core
probe, the experiments path (motion denoising, interpolation) and partial
completion and image fitting, with the port's two examples:

  1. device: requires CUDA; prints the card's name and power limit
  2. build: compiles ``posendf_torch/csrc/field_kernels.cu``,
     ``train_kernels.cu``, ``knn_kernels.cu`` and ``int8_kernels.cu`` with
     nvcc, one process each, from four threads at once (timed), and logs
     the ``-Xptxas -v`` lines of the field kernel's six instances (three
     activations, each on the 3xTF32 and the bf16 ``wgmma`` route:
     registers, spills, shared memory); here and in phases 7, 11 and 14 a
     wgmma kernel whose products ptxas serializes fails the run, but for the
     kNN bound engine's (``SERIALIZED_KNOWN``; PERF.md section 7)
  3. load: ``posendf_torch.load_field(ckpt, device="cuda")``
  4. kernel vs plain on the card, at B = 4096 and a ragged B = 1000
     (every tile split across a cluster of two CTAs):
     ``distance_fused`` vs ``distance``, ``distance_and_grad_fused`` vs
     ``distance_and_grad``, 5 steps of ``project(fused=True)`` vs
     ``fused=False``, and each kernel vs its plain PyTorch version; each of
     the three entry points on a strided view (``poses[::2]``) and on a
     permuted-then-viewed tensor against the contiguous result, to the bit
     (``distance_fused``'s gradient through the copy too); the forward and
     value-and-grad kernels of a seeded softplus and a seeded relu field at
     the trained widths against their plain versions, and the value-and-grad
     on their poses reversed, to the bit; the same for a seeded 32-joint
     softplus field of 8 features (the encoder walks at a run-time width,
     the poses read from device memory); the three kernels at the main
     path's 10,000 poses (132 tiles a CTA each, then 25 split across
     clusters) and at 8,449 (one split) against their plain versions, g and
     the step's poses with the kink rule (below)
  5. against the JAX package: d, g and a 10-step projection of 256 probes
     vs ``tests/data/torch_port_l8_expected.npz``
  6. main path: ``distance_fused``, ``distance_and_grad_fused`` and a
     200-step ``project(fused=True)`` of 10,000 random poses, with the
     kernels' launch counts set to 0 before and read after; then times
     (CUDA events, after warm-up) of the 200-step projection and of each
     kernel beside its plain version and its library yardstick, the DFNet's
     products alone as one ``torch.matmul`` a layer (the input-gradient
     products too for the value-and-grad and the projection step), in the
     same rounds; the forward at 10,000 and at 131,072 poses (the latter in
     the ``kernels`` line); the launches by the cluster size of their split
     tiles (``fused_model.SPLIT_LAUNCHES``: 1 none, 2 the launch plan split
     the last wave's tiles) and the plan at 10,000 poses; the value-and-grad
     and projection-step launches by the derivative state they keep
     (``fused_model.STATE_LAUNCHES``: "bits" on this lrelu field, "slope"
     on a softplus one)
 4b. the bf16 route (the trained field loaded with
     ``compute_dtype="bfloat16"``): at B = 4096 and the ragged B = 4159
     (65 CTAs, an odd count) and 1000 the bf16 forward, value-and-grad and
     projection-step kernels, and 5 steps of ``project(fused=True)``,
     against their bf16 plain versions; the three entry points on a strided
     and a permuted view (4159 poses) against the contiguous result, to the
     bit; the three kernels on the poses in reverse order (the ragged tail
     CTA's poses then in the first CTA) against the result reversed, to the
     bit; the forward and value-and-grad of seeded softplus and relu bf16
     fields at the trained widths (softplus keeps its fp32 slope
     sigmoid(beta z), lrelu and relu a bit a unit) against their plain
     versions, and the three kernels on their poses reversed; the 32-joint field of
     phase 4 in bf16; the derivative-state
     scratch of each activation (a bit a unit: at most 1/32 of softplus's
     floats).
     Each held by ``fused_model.bf16_hold`` (below), which
     also asserts that the bf16 kernel's result is beyond the bar from the
     fp32 kernel's on most poses: a route that ran fp32 fails
 5b. against the JAX package: the bf16 kernels' d, g and a 10-step
     projection of 256 probes, and the bf16 module path's d, vs
     ``tests/data/torch_port_bf16_expected.npz`` (the fp32 values of
     ``torch_port_l8_expected.npz``, the same probes, give the gap)
 6b. main path, bf16: ``distance_fused`` of 131,072 poses,
     ``distance_and_grad_fused`` of 10,000 and a 200-step
     ``project(fused=True)`` of 10,000, the launch counts set to 0 before
     and read after (1, 1, 200); the forward, the value-and-grad and one
     projection step of those 10,000 poses (157 CTAs, more than one wave)
     held to their plain versions, and the three kernels on the poses in
     reverse order against the result reversed, to the bit;
     then times of the 200-step projection and of each bf16 kernel beside
     its plain version and its library yardstick, the DFNet's products as
     bf16 ``torch.matmul`` (in the same rounds), and its bound (the products
     in one bf16 pass); the three join the ``kernels`` line
  7. train kernels vs plain on the card, at B = M = 4096 and a ragged
     B = 1000, M = 700, with nvcc's ``-Xptxas -v`` lines of the tile kernel
     and the reduction (both 3xTF32 ``wgmma``): the tile kernel and the
     reduction each against its plain version on the same inputs (the
     reduction's largest error logged beside its bar), ``fused_train_grads``
     against ``manual_train_grads`` (every loss term and gradient leaf), two
     calls bitwise equal; the tile kernel alone against ``branch_ref`` at
     B = M in {1, 63, 65, 129} (cutting its 64-pose CTAs); the tile kernel's
     relu instance on the trained weights with relu activations, the same
     checks at B = M = 4096 and B = 1000, M = 700, and the tile alone at
     B = M = 63 and 129; the same checks on the lrelu twin of the wide
     encoder field (32 joints of 8 features: the tile's walks at the
     run-time width, ``fused_train.TILE_WALK_LAUNCHES`` read); the encoder kernel
     (its ``-Xptxas -v`` lines logged) against its plain version at B = 1,
     63, 65, 129, 1,000 and 131,072 (cutting its 64-pose CTAs), and at 1,000
     and 131,072 on poses one float into their buffer against the aligned
     result, to the bit
  8. against the JAX package: the gradient at 2,048 + 2,048 poses and three
     fused Adam steps vs ``tests/data/torch_port_train_expected.npz``; the
     relu field's gradient vs ``torch_port_relu_train_expected.npz``
  9. main path, training: a synthetic dataset, ``Trainer(device="cuda")`` at
     the amass widths and learning rate with ``fused_grads`` and
     ``live_head``, batch 4 x 5000, matched-head init,
     ``fit`` for one epoch of 11 steps, the checkpoint reloaded with
     ``load_field``, then 2 autodiff steps with ``strenc.fused``; the train
     and encoder kernels' launch counts set to 0 before and read after, the
     tile's by walk width too (every one the compiled width)
 10. at the main path's batch of 20,000 + 20,000 poses: the checks of phase 7
     on it, for the trained field and for the relu field (the trained
     weights under relu, 0 on nearly every pose of the synthetic manifold:
     its manifold loss sum is near 0 and held by the loss sums' floor,
     below), and the encoder kernel
     vs its plain version on both its halves;
     then times: the fused step vs the autodiff step, ``fused_train_grads`` vs
     ``manual_train_grads``, the weights' pack (``fused_model.pack_tc``, part
     of every fused step) alone, each train kernel vs its plain version and
     its library yardstick (the tile: the DFNet's products of its five
     traversals as ``torch.matmul``; the reduction: ``torch.matmul`` per
     layer), and the encoder kernel vs its plain version at 131,072
 11. the kNN kernel vs its plain version ``knn_topk_ref`` on the card, every
     engine (exact ``vpu`` and ``mxu_bf16``, one bf16 ``wgmma`` step a joint
     as a filter, and the ``mxu_fast`` bound on bf16 ``wgmma``, with their
     ``-Xptxas -v`` lines, a serialized ``wgmma`` failing the run, and their
     corpus packs held to ``pack_joint_ref`` and ``pack_bound_ref`` to the
     byte), at
     Q in {1000, 4096} x N in {20,000 (ragged), 65,536} x k in {1, 5, 8, 16,
     32}, unweighted and joint-weighted, tie-aware; a corpus of duplicated
     rows (the same indices, lowest first); two calls and split counts
     S = default, 1, 7 bitwise equal; ``fused_geodesic_topk_fast`` vs its
     plain composition
 12. against the JAX package: exact top-k, the kernel's engines,
     ``fused_geodesic_topk_fast``, ``probe_fast_safety`` and a
     ``label_sequence`` on a 16,384-pose corpus vs
     ``tests/data/torch_port_knn_expected.npz``
 13. main path, labelling: a sampled directory of 64 x 16,384 synthetic
     poses (1,048,576, 352 MB of fp32 on the card); ``label_split`` labels
     one sequence (shard 0 of 64, 10,000 queries, k = 5) with
     ``precision="auto"``, "highest", "fast" and "default", the kNN launch
     counts set to 0 before and read after and the plain version refused
     meanwhile; 'auto' equal to the labels of the engine that
     ``resolve_knn_precision`` picks, to the byte; ``probe_fast_safety`` on the whole corpus; the exact labels
     held to plain ``geodesic_topk``, the fast ones to the exact (every
     rank within 1e-6, top-5 overlap 1); then times at Q = 4,096,
     N = 1,048,576, k = 5, where every engine's kernel output is held to its
     plain version's (and the main path's exact and bf16 labels of those
     queries too), and the bound engine's to the ``torch.matmul`` yardstick;
     each engine's corpus pack alone; the bounds of both tensor-core routes
     and of the CUDA-core route the exact and bf16 engines had before
 14. the int8 kernel vs its plain version on the card: the trained field
     quantized on 4,096 numpy-seeded poses (``Field.quantize_int8``),
     nvcc's ``-Xptxas -v`` lines of the three wgmma kernels (registers, spills,
     shared memory), ``QuantizedField.distance`` held to ``distance_ref`` at
     B = 1, 63, 65, 129, 1,000, 4,096 and 131,072 (cutting the kernel's
     64-pose CTAs), and on a strided and a permuted view to the bit; the int8 field held to the fp32 field at
     131,072 poses with the bars of ``tests/test_fused_int8.py:190-201``
     (MAE < 0.03 std, Pearson > 0.998, Spearman > 0.995)
 15. against the JAX package (``tests/data/torch_port_int8_expected.npz``):
     the kernel on JAX's own qparams (carried over by
     ``qparams_from_numpy``) vs ``reference_int8_forward`` and the Pallas
     kernel in interpret mode; the port's ``quantize_posendf`` on the card vs
     JAX's on the same calibration poses; the probe kernels vs JAX's chains
 16. main path, serving: ``load_field`` -> ``quantize_int8`` -> ``save`` ->
     ``QuantizedField.load(device="cuda")`` (the same bits) -> ``distance``
     of 131,072 poses, the int8 launch count set to 0 before and read after
     and the plain version refused meanwhile; ``cli export --int8
     --quantized`` and ``cli export --what forward`` on the card, both
     artifacts reloaded with ``load_artifact`` and held at two batch sizes
     to ``distance_ref`` / ``distance``; then times: the int8 kernel vs its
     plain version, vs the fp32 ``posendf_forward`` kernel in the same
     rounds, and the int8 products alone as ``torch._int_mm``
 17. the probe kernels (both ``wgmma``; the int8 chain's ``-Xptxas -v``
     lines in phase 14's) vs their plain versions at (1, 512), (1,000, 512)
     and (131,072, 512), 1 and 8 layers; ``python -m
     posendf_torch.ops.int8_probe``'s run (its launch counts set to 0 before
     and read after); times of both chains against their products as library
     calls (``torch.matmul`` on bf16, ``torch._int_mm``; the int8 chain with
     its requantization as library calls too), rates and shares of the dense
     peaks, and the int8 / bf16 ratio
 18. the experiments path (motion denoising; no kernel of its own): against
     the JAX package (``tests/data/torch_port_denoise_expected.npz``, the
     128-vertex synthetic body) a 2 x 5 ``MotionDenoiser`` solve of one
     60-frame clip (its pose and every step's terms), ``estimate_clip_noise``
     given JAX's probe noise and one ``interpolate`` path, at the CPU test's
     bars; then on a synthetic body of SMPL's 6,890 vertices (its Jtr with
     smplx's 21 landmarks) ``run_sweep`` of ``synthesize_grid``'s
     ``DEFAULT_GRID`` (4 levels x 2 clips x 60 frames, the trained field's
     manifold), 10 x 5 steps batched (``SWEEP_DEPTH``; the 500-step horizon
     against JAX is phase 21's), with the reference and the adaptive
     schedule: every v2v finite, every clip's final pose_pr below its
     input's mean field distance; the sigma-0.1 level again serially, each
     clip's pose held to its batched solve (atol 2e-5) and the v2v table
     (rtol 1e-3, atol 1e-4), the bars of ``tests/test_experiments.py``;
     that level's first clip solved again with ``strenc.fused`` (the
     ``posendf_encoder`` count set to 0 before and at least 50 after; the
     final pose and terms held to its serial module-path solve's); the
     2 x 4-step horizon of both comparisons at the tight bars (pose atol
     2e-5); times: ms a solve step on both paths (the serial solves and the
     fused one), the device kernels and busy time of a step
     (``torch.profiler``), each sweep's wall seconds and ``lbs_forward`` of
     60 frames alone

 19. partial completion and image fitting (the kNN kernel with zero joint
     weights, row 6; the encoder kernel with ``strenc.fused``, row 4):
     against the JAX package (``tests/data/torch_port_partial_expected.npz``,
     the 128-vertex body) the 2 x 5 anchor and inpaint solves of a 60-frame
     clip whose left arm is corrupted (pose and every step's terms), the
     retrieval's neighbours and completion against a 16,384-pose corpus, and
     a 2 x 5 three-stage fit of two keypoint sets given JAX's stage-2 draw,
     at the CPU tests' bars; then a 1,048,576-pose corpus of the L8 field's
     manifold, made on the card, searched by a 120-frame clip whose left arm
     is corrupted, the occluded joints' weights 0: every engine against
     ``knn_topk_ref`` (the exact and bf16 engines' indices all equal,
     distances within KNN_ATOL x W) and the exact one against plain
     ``ops/knn.geodesic_topk`` (index sets equal, distances within 1e-6);
     ``complete_by_retrieval`` on the main path, the kNN launch counts set
     to 0 before and read after, its visible joints to the bit and the
     occluded-joint error lowered; the anchor and inpaint solves (10 x 10
     steps) of the clip at 6,890 vertices on the module path and with
     ``strenc.fused`` (the encoder count set to 0 before each fused solve
     and at least 100 after; under inpaint every observed dof keeps its
     input's bits); ``ImageFitter.optimize`` (10 x 10 steps a stage, the
     45-joint table) of 1 and 8 keypoint sets rendered from the clip through
     a camera rotated ~17 degrees, stage 1's torso error below its start;
     ``examples/torch_end_to_end.py`` and ``examples/torch_serving.py`` (the
     trained field, ``--int8``) as subprocesses, which must exit 0; times of
     the search, the completion, a solve step on each path and each fit
     stage
 20. multi-device (``posendf_torch/parallel``; no kernel of its own: the
     train kernels, row 5, the kNN kernel, row 6, the projection step, row
     3, and the encoder's, row 4, run on each rank): (a) a process group of
     one rank on the card (NCCL, ``tcp://localhost``): 3 fused sharded
     train steps at the main path's 20,000 + 20,000 poses, the labelling
     of 10,000 queries against a 1,048,576-pose corpus, a 2 x 5-step
     frame-sharded denoise of the 60-frame golden clip at 6,890 vertices
     with ``strenc.fused`` and a sharded 20-step projection of 10,000
     poses, each held to its unsharded run to the bit (a group of one rank
     runs every collective, and every share is the whole); then
     ``torchrun --standalone --nproc-per-node 1 examples/torch_multichip.py``,
     whose stage 4 must lower the mean distance.
     (b) two gloo ranks on the one card (NCCL refuses two ranks on one
     GPU; gloo reads tensors as host memory, so every operation stages
     through the host), spawned after the kernels are built: the same
     paths against the one-rank results, the labels to the bit, the train
     steps' losses within TERM_RTOL and the first step's gradient within
     LEAF_TOL x max|leaf| (a mean of two 10,000-row means against one
     20,000-row mean: fp32 sums in another order), the weights after three
     Adam steps within 2 x 3 lr and 99% within lr / 20 (Adam's normalized
     step turns a tiny gradient's rounding into up to 2 lr), the denoise at
     the 2 x 5 horizon's bars (pose SOLVE_POSE_ATOL, history
     SOLVE_HIST_RTOL), the projection at PROJ_RTOL / PROJ_ATOL. Every call
     timed with CUDA events after a warm-up run of the paths; the launches
     of rows 3-6 counted (0 before, read after) in both, and added to the
     ``kernels`` line
 21. the quality loops (``scripts/torch_*quality*.py``, driven through
     their stage functions; the train kernels, row 5, the kNN kernel, row
     6, the forward kernel, row 1): (a) training from random weights at the
     run of record's shapes: a 131,072-pose corpus of the L8 manifold,
     65,536 labelled queries (exact engine), he-matched init, then 10 fused
     steps, each against autodiff (``training_loss`` under autograd) at the
     same weights and batch (two runs, one fused and one autodiff, part by
     some 300 lr within 500 steps, so the steps are held at shared weights):
     the terms at phase 10's bars (TERM_RTOL / TERM_ROW_ATOL against fp32
     autodiff) and every gradient leaf at phase 10's LEAF_TOL x max|leaf|
     of fp32 autodiff, over the rows that sit clear of every kink. At
     65,536 + 65,536 rows near the he-matched init the gradient's sums
     cancel, and a row whose L1 residual, head ReLU or any lrelu unit lies
     within rounding of its kink takes it on the side its sums round to:
     one such row moves a small leaf by its whole share (on an H100 the two
     fp32 gradients came out 1.4e-4 x max|leaf| apart in ``dfnet.w2``, and
     one L1 residual of 65,536 on the other side put the fused gradient
     2.28e-4 from float64 in relative L2 where fp32 autodiff's was 3.1e-5).
     So each step's rows are first run through the network in float64
     (``q21_forward``), and a row is left out of both branches on every side
     (fused, fp32 and float64 autodiff) where a unit's |z|, or the L1
     residual, is within Q21_KINK_NEAR = 3e-6 of the scale its fp32 sum
     rounds with, |x| @ |W| + |b| (``q21_margin``; some 7% of the rows).
     The kernel's and fp32 torch.matmul's hidden pre-activations came out
     at most 6.4e-7 and 9.0e-7 of that scale from float64 (the manifold
     rows' scratch keeps x_l = act(z_{l-1}); H100), so the bar has 3.3x
     room, and the phase fails if a kept row's observable kink (the L1
     sign, the head, a manifold hidden unit) falls on the other side than
     in float64. The log splits each step's distance from float64 autodiff
     into the tile's share (the reduction's sums taken in float64 over the
     tile kernel's own scratch, ``q21_reduce64``) and the reduction's, and
     counts the kinks the kernel took on the other side over the whole
     batch. Then 1,000 fused steps of 65,536 +
     65,536 poses in two chunks with the validation gate: every step's
     terms finite, the last chunk's mean total below the first step's, the
     held-out correlation above its value at init, live fraction above 0,
     and exactly 1,000 tile and 1,000 reduce launches (set to 0 before);
     (b) ``--load-ckpt`` of the L8 field at ``same_clips_reference.json``'s
     settings (2,048 queries), the grid cut to sigma 0.05 and 0.5, one clip
     each, with the prior ablation, against the JAX script's run on the CPU
     (``tests/data/torch_port_quality_expected.npz``, made by
     ``scripts/make_torch_port_quality_golden.py``): the field's MAE within
     1e-4 relative, its correlation and clean / noisy means within 1e-5,
     each row's input v2v and prior at input within rtol 1e-5, the clips'
     2 x 4-step solves at the tight bars (pose 2e-5, metrics rtol 1e-3), and
     the 500-step rows' v2v with and without the prior at the metric bar
     (rtol 1e-3, atol 1e-4) or twice JAX's own spread under a one-ulp
     change of the clip, the larger (the golden's ``ulp_spread``: on the
     CPU the port's prior-off 500-step v2v came out 1.84e-2 cm, 0.24%, from
     JAX's while the 2 x 4-step solves stayed within 5e-6 of JAX's poses:
     rounding, not a fault); (c) the three closed loops, one seed and one
     pair, clip or batch each, on the L8 field (the partial solves and the
     fit cut in depth): each result's keys those of the JAX script's record
     in ``docs/quality/`` (plus ``device`` and ``card``), every value
     finite, and the metrics the JAX records improve moving the same way:
     the projection lowers the true 5-NN distance of noisy paths, the
     retrieval the occluded joints' error, and the prior-off fit keeps the
     lower 2D residual. Its launches of rows 1, 5 and 6 join the
     ``kernels`` line

A 500-step denoise solve is sensitive to rounding: the reference schedule's
self-weighted prior (1e7 L^2) and the trained head's zero region turn sums
taken in another order into another path. On an H100 (700 W) two such
solves ended 1.2e-2, 1.7e-2 (serial vs batched, the level's v2v 7.0e-4 cm
apart) and 2.2e-2 (the encoder kernel vs its plain version, the final
terms within 3.1e-5 of each other) apart in their largest pose dof,
while the same comparisons at 2 x 4 steps stayed within 5.4e-6. So phase
18 holds the short horizon at the bars of ``tests/test_experiments.py``
(pose 2e-5; metrics rtol 1e-3, atol 1e-4) and the 500-step solves' v2v at
that metric bar, their final terms at rtol 5e-3 and their poses at 0.1.
Phase 18 now runs 10 x 5 steps; the 500-step horizon is held in phase 21
(b), against the JAX script itself.

Kernel and plain times are medians over rounds of plain, kernel, kernel,
plain, each round a mean over a few calls (one call of the kNN plain
versions at 1,048,576 poses); the log gives their ranges.

Tolerances: d and g ``atol=1e-5``; projection ``rtol=1e-4, atol=1e-5`` (those
of ``tests/test_fused_grad.py``: fp32 sums of up to 1024 terms taken in
another order); the encoder ``atol=1e-6``. Training gradients: loss terms
``rtol=1e-5``, with a floor for a sum of small non-negative per-row terms:
``atol = n x 1e-7`` for a sum of n terms (1e-7 for a mean), the 3xTF32
products being some 1e-7 from exact a row (below). The relu field's
manifold loss sum over the 20,000 synthetic rows, 0.46 and near 0 a row,
came out 1.7e-5 from float64 in the tile (8.5e-10 a row, 3.6e-5 of the
sum) against a floor of 2e-3 (measured on an H100); each gradient leaf ``atol = 1e-4 x max|leaf|``, five times the
CPU bar of ``tests/test_train_grad.py`` (2e-5), because each leaf here is a
sum over up to 40,000 poses taken in another order, and an L1 or ReLU kink
(a pose whose d lies within rounding of its label or of 0) flips one pose's
term; measured up to 7.4e-6 x max|leaf| on an H100 at 20,000 + 20,000. Adam's steps move a weight by
about lr wherever |g| is well above eps, and by a fraction of lr decided by
the sums' order where g is near 0: after the steps every sampled weight is
within 2 x steps x lr of JAX's and 99% within lr / 20. TF32 is off for matrix
products and convolutions, so the plain path runs true fp32.

kNN: the exact and bf16 engines compute each operation rounded on its own,
in the plain version's order, so their distances are expected to be its bits;
they are held to 1e-6 (x sum_j w_j when weighted) and to 1e-6 against JAX
(fp32 sums in another order). On the tensor cores their values only filter
(``csrc/knn_kernels.cu`` derives the margin): every distance that enters a
list is the plain arithmetic's, so the bars stay. The bound engine's 84-term sums differ in
order from the plain version's matrix products: 1e-5. Indices must match
wherever a rank lies more than the bar from its neighbours. bf16 operands
move a distance by at most (2^-8 + 2^-18) x sum_j w_j (``tests/
test_torch_fused_knn.py`` derives it). The bound engine against one fp32
product of the same rows (the ``torch.matmul`` yardstick): with x = hi + L,
|L| <= 2^-8 |x| and |L - lo| <= 2^-16 |x| (bf16 keeps 8 significant bits),
q c - (hi hi' + hi lo' + lo hi') is at most 3 x 2^-16 |q c| a product; the
weights sit in the corpus rows, so the 84 terms sum to at most
sum_j w_j |q_j| |c_j| = 1 for unit joints, and the bar is 3 x 2^-16 plus
the sums' 1e-5. A sorted list of values each moved by at most e moves by at
most e rank by rank, so the top-k values are held to it too. On the tensor
cores (bf16 ``wgmma``) the products stay exact and only the accumulation
differs (a few units in the last place); those sums only filter, and each
value that enters a list is recomputed in FMA chains over K in order, as
the earlier CUDA-core engine computed it, so BOUND_ATOL bounds the same
arithmetic as before.

The training reduction runs in 3xTF32 on the tensor cores: each product
keeps ~21 significant bits (at most ~3 x 2^-22 of |x x'| lost;
``tests/test_torch_tc_split.py`` derives it), and its accumulators are
added to fp32 totals every 128 rows, so the leaf bar stays LEAF_TOL. The
tile kernel runs the DFNet's products as the field kernels do (below), and
its rows and leaves keep the bars of the CUDA-core kernel it replaced
(``tests/test_torch_train_tc.py`` holds a model of that arithmetic to them
on the CPU). The
field kernels run every DFNet product the same way (A split in registers, B
split once per field, each 32 of K summed in a fresh accumulator and added
in fp32), and keep the bars of d, g and the projection as they were
(``tests/test_torch_field_tc.py`` holds a model of that arithmetic to them
on the CPU). One thing the fp32 plain version cannot settle: the trained
lrelu field has units whose pre-activation sits within 1e-8 of the kink for
some poses, and there act' is 1 or 0.01 as the sums' rounding falls. Where
a pose's g (or, in phase 4, its 5-step projection) is beyond the bar from
the fp32 plain result, it is held instead to the same plain computation in
float64, and passes only if the fp32 plain result is itself beyond the bar
from that (``assert_rows_close``; the log names such poses): a pose with a
unit at z = -1.2e-8 where cuBLAS's fp32 sums take the other slope is 3.5e-5
off in g, and the kernel 6e-8 from float64 (measured on an H100). The other
way round, the kernel's 3xTF32 sums are some 1e-7 from exact where fp32's
are some 1e-8, so a unit within that of its kink may take the other slope
in the kernel; with lrelu that moves g by 0.99 of a unit's term, with relu
by all of it: a seeded relu field at the trained widths, weights doubled,
has one pose in 1,000 off by 1.9e-4 in g (measured on an H100, and by the
CPU model of ``tests/test_torch_field_tc.py``). So phase 4's softplus and
relu fields' g passes a pose beyond the bar also where a DFNet
pre-activation of it (float64) lies within KINK_NEAR = 1e-6 of 0, for at
most 1% of the poses; the log names them.

bf16 (phases 4b-6b): the kernel and its plain version round the same
operands to bf16, but sum in other orders, so a value within a few fp32
units of a bf16 rounding tie (or of a kink) rounds to neighbouring values
on the two sides, and that pose moves by up to the order of the
bf16-vs-fp32 gap. No per-pose bar admits that and stays tight, so
``fused_model.bf16_hold`` holds shares and means: a pose is off beyond the
fp32 bars (D_ATOL, G_ATOL, the projection's; one projection step's poses
BF16_STEP_ATOL = 1e-6, since one step moves them by only some 3e-5 between
bf16 and fp32); at most 45% of the poses may be off, while at least 80%
are that far between the bf16 and the fp32 kernel (asserted, with each
atol at most half the gap's median pose); the mean pose error is at most
0.2 of the gap's, and the largest error at most twice the largest gap
(the readings each bar sits between, sound and with one rounding left
out, are in ``fused_model``'s comment). This replaces the per-pose kink
allowance (KINK_NEAR, KINK_SHARE) for bf16: the tie poses are many more
than the 1% of kinks (measured on an H100: 0.4-3.2% of the trained
field's poses beyond the bars, 12.8% of a seeded softplus field's g). A
fault in one CTA alone stays under those shares, so each bf16 kernel also
runs on the poses reversed, the ragged tail's and the second wave's poses
then in other CTAs, and must give the result reversed, to the bit.

int8 serving: every int8 layer's sums are exact integers in the kernel and
in the plain version alike (|acc| <= K 127^2 < 2^24), so their d can differ
only through the fp32 part before the window: the encoder and layer 0 sum
in another order (the kernel's FMA chains against cuBLAS), which moves a
layer-1 input x by a few 1e-7. That moves nothing downstream unless
x inv_sa lies that close to a rounding boundary n + 1/2, where the
requantized level moves by one. One level of input channel i changes layer
1's pre-activation j by wq_ij dq_j ~ sa_i w_ij: 1/127 of the channel's
calibration maximum times the weight, and
layers 2-6 carry that on: up to a few 1e-4 in d, far above the fp32 part's
1e-6. No fixed bar both admits that and stays tight, so the bar of such a
pose is the plain d itself with the level moved: a pose off by more than
1e-5 passes only if its layer-1 inputs lie within 3e-5 of a boundary and
the plain d with those levels on the other side is within 1e-5 of the
kernel's (``fused_int8.hold_to_ref``); the log counts those poses. The
port's quantization on the card against JAX's on the CPU: window, floored
channels, w_absmax and the fp32 layers equal; dq within rtol 1e-6; the
activation scales within 1e-6 of the layer's largest (a calibration maximum
is a sum whose rounding is relative to its terms, so a nearly dead
channel's scale moves by more than 1e-6 of itself; the log counts them);
wq equal but for at most 1e-4 of the entries, one level apart (a folded
weight on a rounding boundary). The artifacts run the plain paths' own
operations: 1e-6. Probes: int8 bitwise (s = 1/64, every sum an exact
integer); bf16 after one layer each element within one bf16 spacing plus
both fp32 sums' worst-case rounding, 2 K 2^-24 sum_k |x_k w_k|
(``int8_probe.bf16_layer_excess``: where a sum cancels, its rounding is
relative to the terms and not to the small result), each of the 8 layers
alone on the plain chain's input. Over 8 layers such differences feed
forward and grow, and the share of elements more than one spacing apart is
held under 10%: measured 6.58% against the plain version (131,072 rows) and
6.95% against JAX's chain (256 rows) on an H100, where the tensor cores'
fp32 accumulation rounds otherwise than IEEE adds (one layer differs from
the plain version in 0.028% of its elements, against 0.011% between two
IEEE fp32 orders, the plain version and JAX's on the CPU, which end 2.5%
apart after 8 layers); a wrong layer puts most elements off.

Bounds (``bound_ms``): the larger of the operations over the fp32 CUDA-core
peak (67 TFLOP/s, an FMA counted as two) and the bytes (each input read
once, each output written once) over the memory rate (3.35 TB/s) of an H100
SXM, counted from this run's shapes. The field kernels' and the training
reduction's products count at their route's peak: three TF32 passes
(3xTF32) at the dense TF32 tensor-core peak (494.7 TFLOP/s), or, on the
field kernels' bf16 route, one pass at the bf16 peak (989 TFLOP/s, the
hidden layers' weights read as bf16); the field
kernels' encoder walks, output layer and epilogues (two operations an
activation) and the reduction's slot sums at the fp32 peak. The kNN exact and bf16 engines, the
unweighted distance the main path times, on the tensor-core route: the
products each engine needs at the bf16 tensor-core peak (989 TFLOP/s), the
exact engine's three split products hi.hi' + lo.hi' + hi.lo', 3 x 2 x 84 a
pair, the bf16 engine's one, 2 x 84 (the zero slots of a k16 group are not
counted); the epilogue's one FFMA a joint, 2 x 21 a pair, at the fp32 peak;
the fp32 queries and corpus read once; the larger of the three. The
CUDA-core route they had before (logged beside it, not in the JSON line):
per joint and pair 4 products and 3 sums for <q_j, c_j> and one sum of |.|
into the pair's total (abs is an operand modifier), 8; per pair
1 - total / 21, one FMA, 2; so 8 x 21 + 2 = 170 a pair at the fp32 peak
(the top-k selection's comparisons are not counted). The kNN bound engine's
operations count at the bf16 tensor-core peak (989 TFLOP/s): three passes of
its K = 84 product. The int8 forward: its int8 products at the int8
tensor-core peak (1,979 TOPS) plus its fp32 multiply-adds (the encoder,
layers 0, 5 and 6) at 67 TFLOP/s, against the poses in, d out and the
weights once; the probe chains: 2 x rows x 512^2 x 8 operations at the bf16
(989 TFLOP/s) or int8 peak, against x, w and the output once.

Any failure raises, so the script exits nonzero and prints no result. The
second-to-last line is a JSON object describing the kernels, the last line is
``{"ok": true, "device": {...}}``. Usage, from the repository root::

    python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CKPT = "docs/quality/ckpt_l8_best.msgpack"
EXPECTED = "tests/data/torch_port_l8_expected.npz"
TRAIN_EXPECTED = "tests/data/torch_port_train_expected.npz"
RELU_TRAIN_EXPECTED = "tests/data/torch_port_relu_train_expected.npz"
BF16_EXPECTED = "tests/data/torch_port_bf16_expected.npz"
D_ATOL = 1e-5
G_ATOL = 1e-5
PROJ_RTOL, PROJ_ATOL = 1e-4, 1e-5
ENC_ATOL = 1e-6
KINK_NEAR, KINK_SHARE = 1e-6, 0.01   # a unit this near its kink may take the other slope; docstring
BF16_STEP_ATOL = 1e-6   # one bf16 projection step's poses (docstring: bf16)
TERM_RTOL = 1e-5
TERM_ROW_ATOL = 1e-7   # a loss sum's floor, x its summands (a mean's: x 1); docstring
LEAF_TOL = 1e-4      # x max|leaf|; the reason is in the module docstring
MAIN_BATCH, MAIN_STEPS = 10_000, 200
SERVE_BATCH = 131_072
TRAIN_FILES, TRAIN_PTS = 4, 5000       # the reference batch: 4 files x 5000 poses
TILE_BATCHES = (1, 63, 65, 129)        # cut the tile kernel's 64-pose CTAs
ENC_BATCHES = (1, 63, 65, 129, 1000, 131_072)   # cut the encoder kernel's 64-pose CTAs
SEED = 0
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: fp32 CUDA cores, HBM3
PEAK_BF16 = 989e12                       # H100 SXM: bf16 tensor cores, dense
PEAK_TF32 = 494.7e12                     # H100 SXM: TF32 tensor cores, dense
KNN_EXPECTED = "tests/data/torch_port_knn_expected.npz"
KNN_ATOL = 1e-6       # distances: exact and bf16 engines (x W when weighted); reason in the docstring
BOUND_ATOL = 1e-5     # the bound engine: fp32 sums of 84 products in another order
BF16_BAR = 2.0 ** -8 + 2.0 ** -18      # x sum_j w_j: how far bf16 operands move a distance
YARD_BAR = 3 * 2.0 ** -16 + BOUND_ATOL  # the 3-pass bf16 split vs one fp32 product; docstring
KNN_PAIR_OPS = 8 * 21 + 2              # fp32 operations of the distance a pair; docstring
KNN_TC_OPS = {"vpu": 3 * 2 * 84,         # bf16 tensor-core operations a pair the engine needs:
              "mxu_bf16": 2 * 84}        # three split products (exact), one (bf16)
KNN_FFMA_OPS = 2 * 21                    # fp32 operations a pair of the epilogue: an FFMA a joint
CORPUS_FILES, CORPUS_ROWS = 64, 16_384   # the main path's corpus: 1,048,576 poses
KNN_Q, KNN_K = 4096, 5
PEAK_INT8 = 1979e12                      # H100 SXM: int8 tensor cores, dense
INT8_EXPECTED = "tests/data/torch_port_int8_expected.npz"
INT8_CALIB = 4096
INT8_ATOL = 1e-5      # int8 d; poses with a level on a rounding boundary: docstring
WQ_FLIP_SHARE = 1e-4  # quantization on the card vs JAX's: wq entries one level apart
BF16_CHAIN_SHARE = 0.10  # probe bf16, 8 layers: elements more than one spacing apart; docstring
EXPORT_ATOL = 1e-6
INT8_BATCHES = (1, 63, 65, 129, 1000, 4096, SERVE_BATCH)  # cut the 64-pose tile
PROBE_ROWS = (1, 1000, SERVE_BATCH)   # 1 and 1,000 cut the int8 chain's 192-row CTAs
WGMMA_KERNELS = {"field": ("field_kernel",),                             # by library
                 "int8": ("int8_forward_kernel", "probe_bf16_kernel", "probe_int8_kernel"),
                 "train": ("train_tile_kernel", "train_reduce_kernel"),
                 "knn": ("knn_bound_kernel", "knn_pack_kernel", "knn_joint_kernel",
                         "knn_pack_joint_kernel")}
# wgmma kernels whose products ptxas serializes (C7518: "program dependence
# on compiler-inserted WG.DP in divergent path"; its cost is an open
# question, PERF.md section 7); any other fails the run, the training
# reduction's included
SERIALIZED_KNOWN = ("knn_bound_kernel",)
DENOISE_EXPECTED = "tests/data/torch_port_denoise_expected.npz"
SMPL_VERTICES = 6890                     # SMPL's mesh: the skinning as large as a real solve's
GRID_FAMILY_SEED, GRID_LATENTS, GRID_FREQ = 123, 8, (0.5, 1.2)   # the L8 field's manifold
SOLVE_POSE_ATOL, SOLVE_HIST_RTOL = 5e-5, 1e-4   # the 2 x 5 solve vs JAX, the CPU test's bars
NOISE_D_ATOL, NOISE_S_ATOL = 1e-6, 1e-4         # estimate_clip_noise vs JAX, the CPU test's
LONG_SOLVE_POSE_ATOL, LONG_SOLVE_TERM_RTOL = 0.1, 5e-3   # two 500-step solves: docstring
SWEEP_DEPTH = (10, 5)    # phase 18's solves: iterations x steps (the 500-step horizon: phase 21)
PARTIAL_EXPECTED = "tests/data/torch_port_partial_expected.npz"
PARTIAL_OCC = (12, 15, 17, 19)           # the left arm: l_collar, l_shoulder, l_elbow, l_wrist
PARTIAL_FRAMES, PARTIAL_CORPUS, PARTIAL_K = 120, 1 << 20, 5   # cli partial's --max-frames
FIT_POSE_ATOL = 5e-5                     # the 2 x 5 fit vs JAX, the CPU test's bar
FIT_ROT = (0.2, -0.15, 0.1)              # the keypoints' camera: ~17 degrees, 10 m away
REDUCE_FP32_ERR = 7.4e-6  # x max|leaf|: the fp32 CUDA-core reduction it replaced, whole gradient (docstring)


def log(*args) -> None:
    print(*args, flush=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach() - b.detach()).abs().max())


def assert_close(name: str, got: torch.Tensor, want: torch.Tensor, *, rtol: float = 0.0,
                 atol: float) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values off, max |err| "
                             f"{float(err.max()):.3e} (rtol={rtol}, atol={atol})")
    log(f"  ok {name}: max |err| {float(err.max()):.3e}")
    return float(err.max())


def assert_rows_close(name: str, got: torch.Tensor, want: torch.Tensor, exact: torch.Tensor, *,
                      rtol: float = 0.0, atol: float, kink=None) -> float:
    """A kernel's result held pose by pose (rows of the first dimension) to
    an fp32 plain result ``want``, within ``atol + rtol |want|``. A pose
    beyond it passes only where ``want`` itself is beyond that bar from
    ``exact``, the same plain computation in float64 (the fp32 version took
    an activation's kink on the other side; docstring), and ``got`` is within
    it of ``exact``; or, with ``kink`` (each pose's smallest |pre-activation|
    of the DFNet in float64), where a unit lies within KINK_NEAR of its kink
    (the kernel took it on the other side), for at most KINK_SHARE of the
    poses. Returns the largest error of a pose against the reference it is
    held to, those last poses left out."""
    got, want, exact = (t.detach().double().cpu() for t in (got, want, exact))
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite values")
    rows = got.shape[0]

    def off_by(a, b):   # each row's largest excess over the bar, and error
        err = (a - b).abs().reshape(rows, -1)
        bar = atol + rtol * b.abs().reshape(rows, -1)
        return (err - bar).amax(1), err.amax(1)

    over, err = off_by(got, want)
    over_k, err_k = off_by(got, exact)
    over_p, err_p = off_by(want, exact)
    off = over > 0
    plain_off = off & (over_p > 0) & (over_k <= 0)
    at_kink = off & ~plain_off & (kink.double().cpu() < KINK_NEAR if kink is not None else False)
    bad = off & ~plain_off & ~at_kink
    if int(at_kink.sum()) > KINK_SHARE * rows:
        raise AssertionError(f"{name}: {int(at_kink.sum())} of {rows} poses at a kink")
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} poses off, max |err| "
                             f"{float(err[bad].max()):.3e} (rtol={rtol}, atol={atol}; against "
                             f"float64 {float(err_k[bad].max()):.3e})")
    held = torch.where(plain_off, err_k, err)[~at_kink]
    note = ""
    if bool(plain_off.any()):
        note = (f"; pose(s) {plain_off.nonzero().flatten().tolist()}: the fp32 plain result is "
                f"{float(err_p[plain_off].max()):.3e} from its float64 evaluation, the kernel's "
                f"{float(err_k[plain_off].max()):.3e}, held to the float64 one")
    if bool(at_kink.any()):
        note += (f"; pose(s) {at_kink.nonzero().flatten().tolist()} with a unit within "
                 f"{KINK_NEAR} of its kink (smallest |z| {float(kink[at_kink].max()):.3e}): "
                 f"{float(err[at_kink].max()):.3e} off")
    log(f"  ok {name}: max |err| {float(held.max()):.3e}{note}")
    return float(held.max())


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up
    call unless ``warm`` is false."""
    if warm:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
    """(least milliseconds, what bounds them) for work of ``flops`` operations
    at ``peak`` operations a second, moving ``nbytes`` bytes."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def golden_inputs(seed: int, rows: int):
    """The poses and labels of ``scripts/make_torch_port_train_golden.py``
    (its ``make_inputs``): per-joint unit quaternions from a normal draw,
    labels |N(0, 0.1^2)|."""
    rng = np.random.default_rng(seed)

    def unit(n):
        q = rng.normal(size=(n, 21, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    pose = unit(rows)
    dist = (np.abs(rng.normal(size=rows)) * 0.1).astype(np.float32)
    return pose, dist, unit(rows)


def assert_leaves(name: str, got: dict, want: dict, tol: float = LEAF_TOL) -> float:
    """Every gradient leaf within ``tol`` x its max |value|; returns the
    largest error relative to that scale."""
    worst = 0.0
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[k].detach() - w.detach()).abs().max())
        if not bool(torch.isfinite(got[k]).all()) or err > tol * scale:
            raise AssertionError(f"{name} {k}: max |err| {err:.3e} > {tol} x {scale:.3e}")
        worst = max(worst, err / scale)
    log(f"  ok {name}: largest error {worst:.3e} x max|leaf|")
    return worst


def interleaved_ms(name: str, kernel, plain, reps: int, rounds: int = 5, plain_reps=None,
                   library=None, card: str = ""):
    """(kernel ms, plain ms): the medians of ``rounds`` rounds that each time
    ``reps`` calls (``plain_reps`` of the plain version) of plain, kernel,
    kernel, plain, after one warm-up call of each. With ``library``, a third
    call timed after each kernel run of the round, and (kernel, plain,
    library) ms. Logs the medians with their ranges (and ``card``)."""
    plain_reps = reps if plain_reps is None else plain_reps
    kernel()
    plain()
    if library is not None:
        library()
    torch.cuda.synchronize()
    ks, ps, ls = [], [], []
    for _ in range(rounds):
        ps.append(cuda_ms(plain, plain_reps, warm=False))
        for _ in range(2):
            ks.append(cuda_ms(kernel, reps, warm=False))
            if library is not None:
                ls.append(cuda_ms(library, reps, warm=False))
        ps.append(cuda_ms(plain, plain_reps, warm=False))
    k, p = statistics.median(ks), statistics.median(ps)
    lib = f", library {statistics.median(ls):.4f} ms ({min(ls):.4f}-{max(ls):.4f})" if ls else ""
    log(f"  time {name}: kernel {k:.4f} ms ({min(ks):.4f}-{max(ks):.4f}), plain {p:.4f} ms "
        f"({min(ps):.4f}-{max(ps):.4f}){lib}; medians (ranges) of {2 * rounds} x {reps} and "
        f"{2 * rounds} x {plain_reps} calls" + (f"  [{card}]" if card else ""))
    return (k, p, statistics.median(ls)) if ls else (k, p)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> None:
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    import posendf_torch
    from posendf_torch import _build
    from posendf_torch.models import PoseNDF
    from posendf_torch.ops import fused_grad, fused_model
    from posendf_torch.projection import project, random_poses

    # ---- 2. build ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:   # one nvcc per source, all at once
        list(pool.map(_build.library, _build.SOURCES))
    log(f"build: {len(_build.SOURCES)} sources, {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        info = _build.build_info(name)
        log(f"  {info['path']} compiled={info['built']} nvcc {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("    " + line.strip())
    log_ptxas("field")   # the three field kernels (3xTF32 wgmma): registers, spills, shared memory

    # ---- 3. load ----
    field = posendf_torch.load_field(CKPT, device="cuda")
    w = field.weights()
    smem = _build.library().posendf_smem_bytes()
    tc = w.tc_packed()
    log(f"load: {CKPT}, {sum(p.numel() for p in field.module.parameters())} parameters, "
        f"{w.activation}, padded widths {tc.widths}, {tc.nfwd} + {tc.nbwd} weight slabs of 32 KB "
        f"(forward + backward), {smem} bytes of shared memory per CTA")
    gen = torch.Generator().manual_seed(SEED)
    errs = {"fwd": 0.0, "vag": 0.0, "proj": 0.0}
    # the plain versions in float64, for poses where the fp32 ones meet a kink (docstring)
    field64 = posendf_torch.Field(copy.deepcopy(field.module).double())
    w64 = field64.weights()

    # ---- 4. kernel vs plain on the card ----
    for B in (4096, 1000):
        q = random_poses(gen, B, device="cuda")
        log(f"kernel vs plain, B = {B}, plan {fused_model.plan_launch(q, w)._asdict()}")
        with torch.no_grad():
            d_k = field.distance_fused(q)
            assert_close("distance_fused vs distance", d_k, field.distance(q), atol=D_ATOL)
            errs["fwd"] = max(errs["fwd"], assert_close(
                "forward kernel vs fused_posendf_forward_ref", d_k,
                fused_model.fused_posendf_forward_ref(q, w), atol=D_ATOL))
            d_k, g_k = field.distance_and_grad_fused(q)
            d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w)
            _, g_64 = fused_grad.fused_distance_and_grad_ref(q.double(), w64)
        d_m, g_m = field.distance_and_grad(q)
        assert_close("distance_and_grad_fused d vs distance_and_grad", d_k, d_m, atol=D_ATOL)
        assert_rows_close("distance_and_grad_fused g vs distance_and_grad", g_k, g_m, g_64,
                          atol=G_ATOL)
        errs["vag"] = max(errs["vag"],
                          assert_close("value-and-grad kernel d vs ref", d_k, d_p, atol=D_ATOL),
                          assert_rows_close("value-and-grad kernel g vs ref", g_k, g_p, g_64,
                                            atol=G_ATOL))
        o_k, h_k = project(field, q, steps=5, fused=True)
        o_m, h_m = project(field, q, steps=5, fused=False)
        o_64, h_64 = project(field64, q.double(), steps=5, fused=False)
        assert_rows_close("project(fused=True) poses vs fused=False", o_k, o_m, o_64,
                          rtol=PROJ_RTOL, atol=PROJ_ATOL)
        assert_rows_close("project(fused=True) history vs fused=False", h_k.t(), h_m.t(),
                          h_64.t(), rtol=PROJ_RTOL, atol=PROJ_ATOL)
        with torch.no_grad():
            s_k = fused_grad.project_step(q, w)
            s_p = fused_grad.project_step_ref(q, w)
        errs["proj"] = max(errs["proj"],
                           assert_close("projection-step kernel d vs ref", s_k[0], s_p[0],
                                        atol=D_ATOL),
                           assert_close("projection-step kernel q vs ref", s_k[1], s_p[1],
                                        rtol=PROJ_RTOL, atol=PROJ_ATOL))

    # launches that split only their last wave's tiles: the main path's 10,000 poses (132
    # tiles a CTA each, then 25 split) and 8,449 (132, then one); g and the step's poses
    # with the kink rule of the seeded fields below (docstring: at this many poses of the
    # trained lrelu field a unit within the 3xTF32 sums' error of its kink turns up)
    for B in (MAIN_BATCH, 8449):
        q = random_poses(gen, B, device="cuda")
        log(f"kernel vs plain, B = {B}, plan {fused_model.plan_launch(q, w)._asdict()}")
        x64 = q.double() / (q.double() ** 2).sum(1, keepdim=True).clamp_min(1e-24).sqrt()
        _, (_, _, zs) = fused_model.field_forward_ref(x64, w64, keep=True)
        kink = torch.cat(zs, 1).abs().amin(1)
        with torch.no_grad():
            d_k = fused_model.fused_posendf_forward(q, w)
            d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w)
            _, g_64 = fused_grad.fused_distance_and_grad_ref(q.double(), w64)
            errs["fwd"] = max(errs["fwd"], assert_close(
                "forward kernel vs fused_posendf_forward_ref", d_k,
                fused_model.fused_posendf_forward_ref(q, w), atol=D_ATOL))
            d_k, g_k = fused_grad.fused_distance_and_grad(q, w)
            s_k = fused_grad.project_step(q, w)
            s_p = fused_grad.project_step_ref(q, w)
            s_64 = fused_grad.project_step_ref(q.double(), w64)
        errs["vag"] = max(errs["vag"],
                          assert_close("value-and-grad kernel d vs ref", d_k, d_p, atol=D_ATOL),
                          assert_rows_close("value-and-grad kernel g vs ref", g_k, g_p, g_64,
                                            atol=G_ATOL, kink=kink))
        errs["proj"] = max(errs["proj"],
                           assert_close("projection-step kernel d vs ref", s_k[0], s_p[0],
                                        atol=D_ATOL),
                           assert_rows_close("projection-step kernel q vs ref", s_k[1], s_p[1],
                                             s_64[1], rtol=PROJ_RTOL, atol=PROJ_ATOL, kink=kink))
        del zs, x64

    # strided and permuted poses: copied for the kernels, as JAX takes any array
    q = random_poses(gen, 4096, device="cuda")
    with torch.no_grad():
        hold_strided("distance_fused", field.distance_fused, q)
    hold_strided("distance_and_grad_fused", field.distance_and_grad_fused, q)
    hold_strided("project(fused=True), 5 steps", lambda p: project(field, p, steps=5, fused=True),
                 q)
    grads = []
    for view in (lambda x: x.transpose(0, 1).contiguous().transpose(0, 1)[::2], lambda x: x[::2]):
        x = q.clone().requires_grad_(True)
        field.distance_fused(view(x)).sum().backward()
        grads.append(x.grad)
    if not torch.equal(grads[0], grads[1]):
        raise AssertionError("distance_fused's gradient through a strided view differs")
    log("  ok distance_fused's gradient through the copy of a strided view: the same bits")

    # a zero pose in the batch: finite d, and g = gx / 1e-12 as in JAX
    q = random_poses(gen, 1000, device="cuda")
    q[7] = 0.0
    with torch.no_grad():
        d_k, g_k = field.distance_and_grad_fused(q)
        d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w)
    assert_close("zero pose in the batch: d vs ref", d_k, d_p, atol=D_ATOL)
    assert_close("zero pose in the batch: g vs ref", g_k, g_p, rtol=1e-4, atol=G_ATOL)

    # the kernel's other activations: seeded fields at the trained widths
    gen_act = torch.Generator().manual_seed(SEED + 1)
    for act in ("softplus", "relu"):
        module = PoseNDF(activation=act, generator=torch.Generator().manual_seed(3)).cuda()
        with torch.no_grad():
            for param in module.dfnet.parameters():
                param.mul_(2.0)
        w_act = fused_model.FieldWeights.from_module(module)
        w_act64 = fused_model.FieldWeights.from_module(copy.deepcopy(module).double())
        q = random_poses(gen_act, 1000, device="cuda")
        with torch.no_grad():
            d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w_act)
            _, g_64 = fused_grad.fused_distance_and_grad_ref(q.double(), w_act64)
            x64 = q.double() / (q.double() ** 2).sum(1, keepdim=True).clamp_min(1e-24).sqrt()
            _, (_, _, zs) = fused_model.field_forward_ref(x64, w_act64, keep=True)
            assert_close(f"{act} field: forward kernel vs ref",
                         fused_model.fused_posendf_forward(q, w_act), d_p, atol=D_ATOL)
            d_k, g_k = fused_grad.fused_distance_and_grad(q, w_act)
        assert_close(f"{act} field: value-and-grad kernel d vs ref", d_k, d_p, atol=D_ATOL)
        assert_rows_close(f"{act} field: value-and-grad kernel g vs ref", g_k, g_p, g_64,
                          atol=G_ATOL, kink=torch.cat(zs, 1).abs().amin(1))
        with torch.no_grad():   # each act's derivative state (a bit a unit, or fp32), any CTA
            hold_reversed(f"{act} field: value-and-grad kernel, B = 1000",
                          lambda p: fused_grad.fused_distance_and_grad(p, w_act), q)
    # the encoder walks at a feature width other than 6 and poses past the ring's space
    module = wide_encoder_field("float32")
    w_wide = fused_model.FieldWeights.from_module(module)
    w_wide64 = fused_model.FieldWeights.from_module(copy.deepcopy(module).double())
    q = torch.nn.functional.normalize(torch.randn((1000, 32, 4), generator=gen_act).cuda(), dim=-1)
    with torch.no_grad():
        d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w_wide)
        _, g_64 = fused_grad.fused_distance_and_grad_ref(q.double(), w_wide64)
        d_k, g_k = fused_grad.fused_distance_and_grad(q, w_wide)
        assert_close("32-joint F=8 field: forward kernel vs ref",
                     fused_model.fused_posendf_forward(q, w_wide), d_p, atol=D_ATOL)
        assert_close("32-joint F=8 field: value-and-grad kernel d vs ref", d_k, d_p, atol=D_ATOL)
        assert_rows_close("32-joint F=8 field: value-and-grad kernel g vs ref", g_k, g_p, g_64,
                          atol=G_ATOL)
        hold_reversed("32-joint F=8 field: value-and-grad kernel, B = 1000",
                      lambda p: fused_grad.fused_distance_and_grad(p, w_wide), q)

    # ---- 5. against the JAX package ----
    ref = np.load(EXPECTED)
    probes = torch.from_numpy(ref["probes"]).cuda()
    log(f"vs the JAX package ({EXPECTED}, {probes.shape[0]} probes)")
    with torch.no_grad():
        assert_close("distance_fused vs JAX d", field.distance_fused(probes),
                     torch.from_numpy(ref["dist"]), atol=D_ATOL)
        d_k, g_k = field.distance_and_grad_fused(probes)
    assert_close("distance_and_grad_fused d vs JAX", d_k, torch.from_numpy(ref["dist"]),
                 atol=D_ATOL)
    assert_close("distance_and_grad_fused g vs JAX", g_k, torch.from_numpy(ref["grad"]),
                 atol=G_ATOL)
    steps = ref["proj_hist"].shape[0]
    o_k, h_k = project(field, probes, steps=steps, fused=True)
    assert_close(f"project(fused=True) {steps}-step poses vs JAX", o_k,
                 torch.from_numpy(ref["proj_out"]), rtol=PROJ_RTOL, atol=PROJ_ATOL)
    assert_close(f"project(fused=True) {steps}-step history vs JAX", h_k,
                 torch.from_numpy(ref["proj_hist"]), rtol=PROJ_RTOL, atol=PROJ_ATOL)

    # ---- 6. main path ----
    poses = random_poses(gen, MAIN_BATCH, device="cuda")
    fused_model.LAUNCHES = fused_grad.VAG_LAUNCHES = fused_grad.PROJ_LAUNCHES = 0
    fused_model.SPLIT_LAUNCHES.update(dict.fromkeys(fused_model.SPLIT_LAUNCHES, 0))
    fused_model.STATE_LAUNCHES.update(dict.fromkeys(fused_model.STATE_LAUNCHES, 0))
    t0 = time.perf_counter()
    with torch.no_grad():
        d_serve = field.distance_fused(poses)
    d_solve, g_solve = field.distance_and_grad_fused(poses)
    out, hist = project(field, poses, steps=MAIN_STEPS, fused=True)
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    launches = {"fwd": fused_model.LAUNCHES, "vag": fused_grad.VAG_LAUNCHES,
                "proj": fused_grad.PROJ_LAUNCHES}
    split, state = dict(fused_model.SPLIT_LAUNCHES), dict(fused_model.STATE_LAUNCHES)
    log(f"main path: {MAIN_BATCH} poses, {MAIN_STEPS} fused steps, launches {launches}, "
        f"first run {wall_first:.3f} s; by cluster size (1: no split tile) {split}, the plan "
        f"{fused_model.plan_launch(poses, w)._asdict()}; by derivative state {state}")
    if sum(split.values()) != sum(launches.values()):
        raise AssertionError(f"split launches {split} do not count the launches {launches}")
    want = {"bits": 0, "slope": 0, fused_model.state_kind(w): launches["vag"] + launches["proj"]}
    if state != want:
        raise AssertionError(f"launches by derivative state {state}, not {want}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path launched no {name} kernel")
    for name, t, shape in (("d", d_serve, (MAIN_BATCH, 1)), ("d", d_solve, (MAIN_BATCH, 1)),
                           ("g", g_solve, (MAIN_BATCH, 21, 4)), ("poses", out, (MAIN_BATCH, 21, 4)),
                           ("history", hist, (MAIN_STEPS, MAIN_BATCH))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"main path {name}: shape {tuple(t.shape)} or non-finite")
    m0, m1 = float(hist[0].mean()), float(hist[-1].mean())
    log(f"  mean distance {m0:.6f} -> {m1:.6f}")
    if not m1 < m0:
        raise AssertionError(f"projection did not lower the mean distance ({m0} -> {m1})")
    norms = out.norm(dim=-1)
    if float((norms - 1).abs().max()) > 1e-5:
        raise AssertionError("projected quaternions are not unit")

    proj_fused_ms = cuda_ms(lambda: project(field, poses, steps=MAIN_STEPS, fused=True), 3)
    proj_plain_ms = cuda_ms(lambda: project(field, poses, steps=MAIN_STEPS, fused=False), 1)
    log(f"{MAIN_STEPS}-step projection of {MAIN_BATCH} poses: fused {proj_fused_ms:.3f} ms "
        f"(the fp32 CUDA-core kernel it replaced: 731.490 ms in PERF.md), module path "
        f"{proj_plain_ms:.3f} ms  "
        f"[{card}]")

    # ---- per-kernel times at the main path's shapes ----
    # library yardstick: the DFNet's products alone, torch.matmul per layer (TF32 off)
    serve = random_poses(gen, SERVE_BATCH, device="cuda")
    lib_fwd = {n: dfnet_products(w, n, backward=False) for n in (MAIN_BATCH, SERVE_BATCH)}
    lib_vag = dfnet_products(w, MAIN_BATCH, backward=True)
    with torch.no_grad():
        fwd_ms, fwd_plain_ms, fwd_lib_ms = interleaved_ms(
            f"forward B={MAIN_BATCH}", lambda: field.distance_fused(poses),
            lambda: fused_model.fused_posendf_forward_ref(poses, w), 20,
            library=lib_fwd[MAIN_BATCH])
        fwd_big_ms, fwd_big_plain_ms, fwd_big_lib_ms = interleaved_ms(
            f"forward B={SERVE_BATCH}", lambda: field.distance_fused(serve),
            lambda: fused_model.fused_posendf_forward_ref(serve, w), 5,
            library=lib_fwd[SERVE_BATCH])
        vag_ms, vag_plain_ms, vag_lib_ms = interleaved_ms(
            f"value-and-grad B={MAIN_BATCH}", lambda: field.distance_and_grad_fused(poses),
            lambda: fused_grad.fused_distance_and_grad_ref(poses, w), 20, library=lib_vag)
        proj_ms, proj_plain_ms_step, proj_lib_ms = interleaved_ms(
            f"projection step B={MAIN_BATCH}", lambda: fused_grad.project_step(poses, w),
            lambda: fused_grad.project_step_ref(poses, w), 20, library=lib_vag)
        fwd_mod_ms = cuda_ms(lambda: field.distance(poses), 20)
    vag_mod_ms = cuda_ms(lambda: field.distance_and_grad(poses), 20)
    log(f"forward B={MAIN_BATCH}: kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, "
        f"module {fwd_mod_ms:.4f} ms, products alone {fwd_lib_ms:.4f} ms  [{card}]")
    log(f"forward B={SERVE_BATCH}: kernel {fwd_big_ms:.4f} ms "
        f"({SERVE_BATCH / fwd_big_ms * 1e3:.4g} evals/s), plain {fwd_big_plain_ms:.4f} ms "
        f"({SERVE_BATCH / fwd_big_plain_ms * 1e3:.4g} evals/s), products alone "
        f"{fwd_big_lib_ms:.4f} ms  [{card}]")
    log(f"value-and-grad B={MAIN_BATCH}: kernel {vag_ms:.4f} ms, plain {vag_plain_ms:.4f} ms, "
        f"module {vag_mod_ms:.4f} ms, products alone {vag_lib_ms:.4f} ms  [{card}]")
    log(f"projection step B={MAIN_BATCH}: kernel {proj_ms:.4f} ms, plain "
        f"{proj_plain_ms_step:.4f} ms, products alone {proj_lib_ms:.4f} ms  [{card}]")

    bf16 = bf16_phases(field, card)
    train = train_phases(field, card)
    knn = knn_phases(card)
    serving = serving_phases(field, card)
    experiments_phase(card)
    partial = partial_phase(card)
    multi = multidevice_phase(card)
    quality = quality_phase(card)

    # bounds of the field kernels at the main path's shapes: 3xTF32 products
    fwd_bound = field_bound(w, MAIN_BATCH, backward=False)
    big_bound = field_bound(w, SERVE_BATCH, backward=False)
    vag_bound = field_bound(w, MAIN_BATCH, backward=True)
    log(f"bounds (the DFNet's products as three TF32 passes at {PEAK_TF32 / 1e12} TFLOP/s, the "
        f"rest at {PEAK_FLOPS / 1e12}): forward {fwd_bound[0]:.4f} ms at {MAIN_BATCH} and "
        f"{big_bound[0]:.4f} ms at {SERVE_BATCH}, value-and-grad and projection step "
        f"{vag_bound[0]:.4f} ms at {MAIN_BATCH} (bound by {big_bound[1]}, {vag_bound[1]})")
    src = "posendf_torch/csrc/field_kernels.cu"
    kernels = [
        {"name": "posendf_forward", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_model.py:38", "launches": launches["fwd"],
         "max_abs_err": errs["fwd"], "ms": fwd_big_ms, "plain_ms": fwd_big_plain_ms,
         "bound_ms": big_bound[0], "bound_by": big_bound[1], "library_ms": fwd_big_lib_ms},
        {"name": "posendf_value_and_grad", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_grad.py:229", "launches": launches["vag"],
         "max_abs_err": errs["vag"], "ms": vag_ms, "plain_ms": vag_plain_ms,
         "bound_ms": vag_bound[0], "bound_by": vag_bound[1], "library_ms": vag_lib_ms},
        {"name": "posendf_project_step", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_grad.py:245", "launches": launches["proj"],
         "max_abs_err": errs["proj"], "ms": proj_ms, "plain_ms": proj_plain_ms_step,
         "bound_ms": vag_bound[0], "bound_by": vag_bound[1], "library_ms": proj_lib_ms},
    ] + bf16 + train + knn + serving
    # the partial-completion path's launches: the retrieval's exact search
    # (row 6) and the fused-encoder solves (row 4)
    for row in kernels:
        if row["name"] == "posendf_encoder":
            row["launches"] += partial["enc"]
        elif row["name"].endswith("(vpu)"):
            row["launches"] += partial["vpu"]
    # the multi-device phase's: rows 3-6 on every rank
    for row in kernels:
        key = {"posendf_project_step": "proj", "posendf_train_tile": "tile",
               "posendf_train_reduce": "reduce", "posendf_encoder": "enc"}.get(row["name"])
        if key is None and row["name"].endswith("(vpu)"):
            key = "vpu"
        if key is not None:
            row["launches"] += multi[key]
    # the quality loops': rows 1, 5 and 6
    for row in kernels:
        key = {"posendf_forward": "fwd", "posendf_train_tile": "tile",
               "posendf_train_reduce": "reduce"}.get(row["name"])
        if key is None and row["name"].endswith("(vpu)"):
            key = "vpu"
        if key is not None:
            row["launches"] += quality[key]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


def bf16_phases(field, card: str) -> list:
    """Phases 4b-6b, the field kernels' bf16 route; returns its JSON entries.
    The trained field loaded with ``compute_dtype="bfloat16"``; each bf16
    result held to its reference by ``fused_model.bf16_hold`` (module
    docstring), the bf16-vs-fp32 gap taken against the fp32 kernels on the
    same poses."""
    import posendf_torch
    from posendf_torch import _build
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.models import PoseNDF
    from posendf_torch.ops import fused_grad, fused_model
    from posendf_torch.projection import project, random_poses

    cfg = PoseNDFConfig()
    cfg.dfnet.compute_dtype = "bfloat16"
    f16 = posendf_torch.load_field(CKPT, config=cfg, device="cuda")
    w16, w32 = f16.weights(), field.weights()
    tc = w16.tc_packed()
    log(f"bf16 route: {CKPT} with compute_dtype='bfloat16', {tc.nfwd} + {tc.nbwd} bf16 weight "
        f"slabs of {2 * fused_model.BF16_SLAB // 1024} KB (forward + backward)")
    gen = torch.Generator().manual_seed(SEED + 20)
    errs = {"fwd": 0.0, "vag": 0.0, "proj": 0.0}

    def hold(name, got, want, fp32, **bars) -> float:
        st = fused_model.bf16_hold(name, got, want, fp32, **bars)
        log(f"  ok {name}: {st['off']:.4f} of the poses beyond the bar (bf16 vs fp32: "
            f"{st['gap_off']:.4f}), mean pose error {st['mean']:.3e} (bf16 vs fp32: "
            f"{st['gap_mean']:.3e}, ratio {st['mean'] / st['gap_mean']:.4f}), max "
            f"{st['max']:.3e} (bf16 vs fp32: {st['gap_max']:.3e}, ratio "
            f"{st['max'] / st['gap_max']:.4f})")
        return st["max"]

    def plain_project(q, w, steps):
        """The plain projection: ``project_step_ref`` ``steps`` times."""
        hist = []
        for _ in range(steps):
            d, q = fused_grad.project_step_ref(q, w)
            hist.append(d[:, 0])
        return q, torch.stack(hist)

    # ---- 4 (bf16). the bf16 kernels vs their plain versions on the card ----
    for B in (4096, 4159, 1000):
        log(f"bf16 kernels vs plain, B = {B}")
        q = random_poses(gen, B, device="cuda")
        with torch.no_grad():
            d_k, d_32 = f16.distance_fused(q), field.distance_fused(q)
            errs["fwd"] = max(errs["fwd"], hold(
                "bf16 forward kernel vs fused_posendf_forward_ref", d_k,
                fused_model.fused_posendf_forward_ref(q, w16), d_32, atol=D_ATOL))
            d_k, g_k = f16.distance_and_grad_fused(q)
            d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w16)
            d_32, g_32 = field.distance_and_grad_fused(q)
            errs["vag"] = max(errs["vag"],
                              hold("bf16 value-and-grad kernel d vs ref", d_k, d_p, d_32,
                                   atol=D_ATOL),
                              hold("bf16 value-and-grad kernel g vs ref", g_k, g_p, g_32,
                                   atol=G_ATOL))
            o_k, h_k = project(f16, q, steps=5, fused=True)
            o_32, h_32 = project(field, q, steps=5, fused=True)
            o_p, h_p = plain_project(q, w16, 5)
            s_k, s_p = fused_grad.project_step(q, w16), fused_grad.project_step_ref(q, w16)
            s_32 = fused_grad.project_step(q, w32)
            errs["proj"] = max(
                errs["proj"],
                hold("bf16 project(fused=True), 5 steps, poses vs the plain steps", o_k, o_p, o_32,
                     rtol=PROJ_RTOL, atol=PROJ_ATOL),
                hold("bf16 project(fused=True), 5 steps, history vs the plain steps", h_k.t(),
                     h_p.t(), h_32.t(), rtol=PROJ_RTOL, atol=PROJ_ATOL),
                hold("bf16 projection-step kernel d vs ref", s_k[0], s_p[0], s_32[0],
                     atol=D_ATOL),
                hold("bf16 projection-step kernel q vs ref", s_k[1], s_p[1], s_32[1],
                     atol=BF16_STEP_ATOL))
            hold_reversed(f"bf16 forward kernel, B = {B}", f16.distance_fused, q)
            hold_reversed(f"bf16 value-and-grad kernel, B = {B}", f16.distance_and_grad_fused, q)
            hold_reversed(f"bf16 projection-step kernel, B = {B}",
                          lambda p: fused_grad.project_step(p, w16), q)
    q = random_poses(gen, 2 * 4159, device="cuda")
    with torch.no_grad():
        hold_strided("bf16 distance_fused", f16.distance_fused, q)
        hold_strided("bf16 distance_and_grad_fused", f16.distance_and_grad_fused, q)
        hold_strided("bf16 project(fused=True), 5 steps",
                     lambda p: project(f16, p, steps=5, fused=True), q)
    # the bf16 instances of the other activations: seeded fields at the trained widths
    for act in ("softplus", "relu"):
        mods = [PoseNDF(activation=act, compute_dtype=cd,
                        generator=torch.Generator().manual_seed(3)).cuda()
                for cd in ("bfloat16", "float32")]
        with torch.no_grad():
            for m in mods:
                for param in m.dfnet.parameters():
                    param.mul_(2.0)
        wa16, wa32 = (fused_model.FieldWeights.from_module(m) for m in mods)
        q = random_poses(gen, 1000, device="cuda")
        with torch.no_grad():
            d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, wa16)
            d_32, g_32 = fused_grad.fused_distance_and_grad(q, wa32)
            hold(f"{act} field: bf16 forward kernel vs ref",
                 fused_model.fused_posendf_forward(q, wa16), d_p, d_32, atol=D_ATOL)
            d_k, g_k = fused_grad.fused_distance_and_grad(q, wa16)
            hold(f"{act} field: bf16 value-and-grad kernel d vs ref", d_k, d_p, d_32, atol=D_ATOL)
            hold(f"{act} field: bf16 value-and-grad kernel g vs ref", g_k, g_p, g_32, atol=G_ATOL)
            for what, fn in (("forward", lambda p: fused_model.fused_posendf_forward(p, wa16)),
                             ("value-and-grad", lambda p: fused_grad.fused_distance_and_grad(p, wa16)),
                             ("projection-step", lambda p: fused_grad.project_step(p, wa16))):
                hold_reversed(f"{act} field: bf16 {what} kernel, B = 1000", fn, q)
    # the encoder walks at a feature width other than 6 and poses past the ring's space
    wa16, wa32 = (fused_model.FieldWeights.from_module(wide_encoder_field(cd))
                  for cd in ("bfloat16", "float32"))
    q = torch.nn.functional.normalize(torch.randn((1000, 32, 4), generator=gen).cuda(), dim=-1)
    with torch.no_grad():
        d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, wa16)
        d_32, g_32 = fused_grad.fused_distance_and_grad(q, wa32)
        d_k, g_k = fused_grad.fused_distance_and_grad(q, wa16)
        hold("32-joint F=8 field: bf16 value-and-grad kernel d vs ref", d_k, d_p, d_32, atol=D_ATOL)
        hold("32-joint F=8 field: bf16 value-and-grad kernel g vs ref", g_k, g_p, g_32, atol=G_ATOL)
        hold_reversed("32-joint F=8 field: bf16 value-and-grad kernel, B = 1000",
                      lambda p: fused_grad.fused_distance_and_grad(p, wa16), q)
    # the derivative state the value-and-grad and projection-step kernels keep, a launch
    lib = _build.library()
    scratch = {act: lib.posendf_field_scratch_floats(MAIN_BATCH, w16.num_joints, w16.feature_size,
                                                    tc.zsum, _build.ACT_CODES[act])
               for act in ("lrelu", "relu", "softplus")}
    if not scratch["lrelu"] == scratch["relu"] <= scratch["softplus"] // 32:
        raise AssertionError(f"derivative-state scratch at B = {MAIN_BATCH}: {scratch} floats")
    log(f"  derivative state in device memory at B = {MAIN_BATCH}: {4 * scratch['lrelu']} bytes for "
        f"lrelu and relu (a bit a unit; the encoder's in shared memory), {4 * scratch['softplus']} "
        f"for softplus (its fp32 slope sigmoid(beta z) a unit)")

    # ---- 5 (bf16). against the JAX package ----
    ref, ref32 = np.load(BF16_EXPECTED), np.load(EXPECTED)
    if not np.array_equal(ref["probes"], ref32["probes"]):
        raise AssertionError(f"{BF16_EXPECTED} and {EXPECTED} hold other probes")
    probes = torch.from_numpy(ref["probes"]).cuda()
    t = {k: torch.from_numpy(ref[k]) for k in ref.files}
    t32 = {k: torch.from_numpy(ref32[k]) for k in ref32.files}
    steps = t["proj_hist"].shape[0]
    log(f"bf16 vs the JAX package ({BF16_EXPECTED}, {probes.shape[0]} probes; the gap against "
        f"{EXPECTED})")
    with torch.no_grad():
        hold("bf16 distance_fused vs JAX", f16.distance_fused(probes), t["fwd_dist"], t32["dist"],
             atol=D_ATOL)
        d_k, g_k = f16.distance_and_grad_fused(probes)
        o_k, h_k = project(f16, probes, steps=steps, fused=True)
        d_m = f16.distance(probes)
    hold("bf16 distance_and_grad_fused d vs JAX", d_k, t["vag_dist"], t32["dist"], atol=D_ATOL)
    hold("bf16 distance_and_grad_fused g vs JAX", g_k, t["vag_grad"], t32["grad"], atol=G_ATOL)
    hold(f"bf16 project(fused=True) {steps}-step poses vs JAX", o_k, t["proj_out"],
         t32["proj_out"], rtol=PROJ_RTOL, atol=PROJ_ATOL)
    hold(f"bf16 project(fused=True) {steps}-step history vs JAX", h_k.t(), t["proj_hist"].t(),
         t32["proj_hist"].t(), rtol=PROJ_RTOL, atol=PROJ_ATOL)
    hold("bf16 module path d vs JAX", d_m, t["module_dist"], t32["dist"], atol=D_ATOL)

    # ---- 6 (bf16). main path: the bf16 field's forward, value-and-grad, projection ----
    serve = random_poses(gen, SERVE_BATCH, device="cuda")
    poses = random_poses(gen, MAIN_BATCH, device="cuda")
    fused_model.LAUNCHES = fused_grad.VAG_LAUNCHES = fused_grad.PROJ_LAUNCHES = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        d_serve = f16.distance_fused(serve)
    d_solve, g_solve = f16.distance_and_grad_fused(poses)
    out, hist = project(f16, poses, steps=MAIN_STEPS, fused=True)
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    launches = {"fwd": fused_model.LAUNCHES, "vag": fused_grad.VAG_LAUNCHES,
                "proj": fused_grad.PROJ_LAUNCHES}
    log(f"main path, bf16: {SERVE_BATCH}-pose forward, {MAIN_BATCH}-pose value-and-grad and "
        f"{MAIN_STEPS} fused steps, launches {launches}, first run {wall_first:.3f} s")
    if launches != {"fwd": 1, "vag": 1, "proj": MAIN_STEPS}:
        raise AssertionError(f"the bf16 main path's launches {launches}")
    for name, x, shape in (("d", d_serve, (SERVE_BATCH, 1)), ("d", d_solve, (MAIN_BATCH, 1)),
                           ("g", g_solve, (MAIN_BATCH, 21, 4)),
                           ("poses", out, (MAIN_BATCH, 21, 4)),
                           ("history", hist, (MAIN_STEPS, MAIN_BATCH))):
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"bf16 main path {name}: shape {tuple(x.shape)} or non-finite")
    with torch.no_grad():
        errs["fwd"] = max(errs["fwd"], hold(
            f"bf16 forward B={SERVE_BATCH} vs ref", d_serve,
            fused_model.fused_posendf_forward_ref(serve, w16), field.distance_fused(serve),
            atol=D_ATOL))
        d_p, g_p = fused_grad.fused_distance_and_grad_ref(poses, w16)
        d_32, g_32 = field.distance_and_grad_fused(poses)
        errs["vag"] = max(errs["vag"],
                          hold(f"bf16 value-and-grad B={MAIN_BATCH} d vs ref", d_solve, d_p, d_32,
                               atol=D_ATOL),
                          hold(f"bf16 value-and-grad B={MAIN_BATCH} g vs ref", g_solve, g_p, g_32,
                               atol=G_ATOL))
        s_k, s_p = fused_grad.project_step(poses, w16), fused_grad.project_step_ref(poses, w16)
        s_32 = fused_grad.project_step(poses, w32)
        errs["proj"] = max(errs["proj"],
                           hold(f"bf16 projection step B={MAIN_BATCH} d vs ref", s_k[0], s_p[0],
                                s_32[0], atol=D_ATOL),
                           hold(f"bf16 projection step B={MAIN_BATCH} q vs ref", s_k[1], s_p[1],
                                s_32[1], atol=BF16_STEP_ATOL))
        del d_p, g_p, d_32, g_32, s_k, s_p, s_32
        hold_reversed(f"bf16 forward kernel, B = {MAIN_BATCH}", f16.distance_fused, poses)
        hold_reversed(f"bf16 value-and-grad kernel, B = {MAIN_BATCH}",
                      f16.distance_and_grad_fused, poses)
        hold_reversed(f"bf16 projection-step kernel, B = {MAIN_BATCH}",
                      lambda p: fused_grad.project_step(p, w16), poses)
    m0, m1 = float(hist[0].mean()), float(hist[-1].mean())
    log(f"  mean distance {m0:.6f} -> {m1:.6f}")
    if not m1 < m0:
        raise AssertionError(f"the bf16 projection did not lower the mean distance ({m0} -> {m1})")
    if float((out.norm(dim=-1) - 1).abs().max()) > 1e-5:
        raise AssertionError("bf16 projected quaternions are not unit")

    # times: kernel vs plain and the DFNet's products as bf16 torch.matmul, same rounds
    proj_ms = cuda_ms(lambda: project(f16, poses, steps=MAIN_STEPS, fused=True), 3)
    with torch.no_grad():
        fwd_ms, fwd_plain_ms, fwd_lib_ms = interleaved_ms(
            f"bf16 forward B={SERVE_BATCH}", lambda: f16.distance_fused(serve),
            lambda: fused_model.fused_posendf_forward_ref(serve, w16), 5,
            library=dfnet_products(w16, SERVE_BATCH, backward=False, dtype=torch.bfloat16),
            card=card)
        lib_vag = dfnet_products(w16, MAIN_BATCH, backward=True, dtype=torch.bfloat16)
        vag_ms, vag_plain_ms, vag_lib_ms = interleaved_ms(
            f"bf16 value-and-grad B={MAIN_BATCH}", lambda: f16.distance_and_grad_fused(poses),
            lambda: fused_grad.fused_distance_and_grad_ref(poses, w16), 20, library=lib_vag,
            card=card)
        step_ms, step_plain_ms, step_lib_ms = interleaved_ms(
            f"bf16 projection step B={MAIN_BATCH}", lambda: fused_grad.project_step(poses, w16),
            lambda: fused_grad.project_step_ref(poses, w16), 20, library=lib_vag, card=card)
    fwd_bound = field_bound(w16, SERVE_BATCH, backward=False, bf16=True)
    vag_bound = field_bound(w16, MAIN_BATCH, backward=True, bf16=True)
    log(f"bf16: {MAIN_STEPS}-step projection of {MAIN_BATCH} poses {proj_ms:.3f} ms; forward "
        f"B={SERVE_BATCH} {fwd_ms:.4f} ms ({SERVE_BATCH / fwd_ms * 1e3:.4g} evals/s), bound "
        f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}); value-and-grad {vag_ms:.4f} ms and projection "
        f"step {step_ms:.4f} ms at {MAIN_BATCH}, bound {vag_bound[0]:.4f} ms ({vag_bound[1]}; "
        f"the DFNet's products in one bf16 pass at {PEAK_BF16 / 1e12} TFLOP/s, the rest at "
        f"{PEAK_FLOPS / 1e12})  [{card}]")
    src = "posendf_torch/csrc/field_kernels.cu"
    return [
        {"name": "posendf_forward_bf16", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_model.py:38", "launches": launches["fwd"],
         "max_abs_err": errs["fwd"], "ms": fwd_ms, "plain_ms": fwd_plain_ms,
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": fwd_lib_ms},
        {"name": "posendf_value_and_grad_bf16", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_grad.py:229", "launches": launches["vag"],
         "max_abs_err": errs["vag"], "ms": vag_ms, "plain_ms": vag_plain_ms,
         "bound_ms": vag_bound[0], "bound_by": vag_bound[1], "library_ms": vag_lib_ms},
        {"name": "posendf_project_step_bf16", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_grad.py:245", "launches": launches["proj"],
         "max_abs_err": errs["proj"], "ms": step_ms, "plain_ms": step_plain_ms,
         "bound_ms": vag_bound[0], "bound_by": vag_bound[1], "library_ms": step_lib_ms},
    ]


def wide_encoder_field(compute_dtype: str, activation: str = "softplus"):
    """A seeded softplus field whose encoder the field kernels walk with the
    feature width at run time and the poses read from device memory (32
    joints of 8 features: its rows and poses do not both fit the ring's
    space): a binary tree of joints, DFNet (200, 300), weights doubled.
    ``activation="lrelu"``: its twin for the train tile kernel (which takes
    no softplus), whose walks it runs at the run-time width, at the widest
    rows the ring's space holds beside gx."""
    from posendf_torch.models import PoseNDF

    parents = (-1,) + tuple((j - 1) // 2 for j in range(1, 32))
    module = PoseNDF(num_joints=32, parents=parents, feature_size=8, dfnet_dims=(200, 300),
                     activation=activation, compute_dtype=compute_dtype,
                     generator=torch.Generator().manual_seed(4)).cuda()
    with torch.no_grad():
        for param in module.dfnet.parameters():
            param.mul_(2.0)
    return module


def traversal_flops(w) -> int:
    """Operations of one pass of one pose through the network: two per
    multiply-add of the encoder's and the DFNet's weights."""
    E, F = 4 + w.feature_size, w.feature_size
    return 2 * (w.num_joints * (E * E + E * F) + sum(wl.numel() for wl, _ in w.layers))


def dfnet_products(w, rows: int, backward: bool, dtype=torch.float32):
    """The library yardstick of the field kernels: the DFNet's products alone,
    one ``torch.matmul`` a layer on ``rows`` rows (fp32, TF32 off; or bf16
    operands and product with ``dtype=torch.bfloat16``), each on inputs made
    once; with ``backward`` also the input-gradient products g W^T. Returns
    the call."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    mats = [wl.detach().to(dtype) for wl, _ in w.layers]
    xs = [torch.randn(rows, m.shape[0], device="cuda", generator=gen).to(dtype) for m in mats]
    gs = [torch.randn(rows, m.shape[1], device="cuda", generator=gen).to(dtype) for m in mats]

    def run():
        for x, m in zip(xs, mats):
            torch.matmul(x, m)
        if backward:
            for g, m in zip(gs, mats):
                torch.matmul(g, m.t())
    return run


def field_bound(w, rows: int, backward: bool, bf16: bool = False):
    """(ms, what bounds it) of a field kernel over ``rows`` poses: the
    DFNet's hidden products as three TF32 passes at the TF32 tensor-core
    peak (``bf16``: one pass at the bf16 peak); the encoder (its walk and,
    with ``backward``, its reverse walk), the output layer and two
    operations an activation of the epilogues (bias and act, or act' and its
    product) at the fp32 peak; the poses in, d (and g or the next poses) out
    and the parameters once (the hidden products' weights in bf16 with
    ``bf16``)."""
    E, F, J = 4 + w.feature_size, w.feature_size, w.num_joints
    passes = 2 if backward else 1
    tc_macs = sum(wl.numel() for wl, _ in w.layers[:-1])
    hidden = sum(wl.shape[1] for wl, _ in w.layers[:-1])
    cuda_ops = passes * (2 * J * (E * E + E * F) + 2 * w.layers[-1][0].numel() + 2 * hidden)
    tc_time = (2 * tc_macs * passes * rows / PEAK_BF16 if bf16
               else 3 * 2 * tc_macs * passes * rows / PEAK_TF32)
    t_ops = (tc_time + cuda_ops * rows / PEAK_FLOPS) * 1e3
    param_bytes = 4 * sum(t.numel() for t in w.tensors()) - (2 * tc_macs if bf16 else 0)
    nbytes = 4 * rows * (J * 4 * (2 if backward else 1) + 1) + param_bytes
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def train_phases(field, card: str) -> list:
    """Phases 7-10; returns the train and encoder kernels' JSON entries."""
    import copy
    import tempfile

    from posendf_torch import _build, load_field
    from posendf_torch.data.pipeline import TrainingBatcher
    from posendf_torch.data.splits import AMASS_SPLITS
    from posendf_torch.data.synthetic import write_synthetic_dataset
    from posendf_torch.field import Field
    from posendf_torch.models.encoder import structure_encoder_apply
    from posendf_torch.ops import fused_encoder, fused_train
    from posendf_torch.ops.fused_model import FieldWeights, pack_tc
    from posendf_torch.ops.train_grad import manual_train_grads
    from posendf_torch.projection import random_poses
    from posendf_torch.training.trainer import Trainer, make_optimizer, make_train_step

    module = field.module
    w = field.weights()
    gen = torch.Generator().manual_seed(SEED + 1)
    errs = {"tile": 0.0, "reduce": 0.0, "reduce_rel": 0.0, "enc": 0.0}
    # the tile kernel's relu instance: the trained weights with relu activations
    from posendf_torch.config import PoseNDFConfig

    relu_cfg = PoseNDFConfig()
    relu_cfg.dfnet.act = relu_cfg.strenc.act = "relu"
    relu = load_field(CKPT, config=relu_cfg, device="cuda")

    def batch_on_card(rows_n, rows_m, seed):
        pose, dist, man = golden_inputs(seed, max(rows_n, rows_m))
        return (torch.from_numpy(pose[:rows_n]).cuda(), torch.from_numpy(dist[:rows_n]).cuda(),
                torch.from_numpy(man[:rows_m]).cuda())

    def check_tile(pose, dist, man, kw, f=field):
        """The tile kernel against ``branch_ref`` on the same inputs (of field
        ``f``): both branches' rows (and encoder and loss slots) and the plain
        rows through the same (plain) reduction, every leaf and the loss sums.
        Returns the kernel's outputs and their plain reduction."""
        w = f.weights()
        kw_n, kw_m = fused_train.branch_args(w, pose, dist, man, **kw)
        tiles = fused_train.launch_tiles(w, pose, dist, man, kw_n, kw_m)
        rows_k = [t.branch_rows(w) for t in tiles]
        with torch.no_grad():
            plain = (fused_train.branch_ref(w, pose, dist, **kw_n),
                     fused_train.branch_ref(w, man, torch.zeros_like(man[:, 0, 0]), **kw_m))
            g_pp, l_pp = fused_train.reduce_ref(w, *plain)
            del plain
            g_kp, l_kp = fused_train.reduce_ref(w, *rows_k)
        del rows_k
        ctas = [t.enc_slot.shape[0] for t in tiles]
        assert_leaves(f"tile kernel vs branch_ref, {ctas[0]} + {ctas[1]} CTAs (plain reduction "
                      "of both)", g_kp, g_pp)
        B, J, M = pose.shape[0], pose.shape[1], man.shape[0]
        for i, (k, rows) in enumerate((("dist", B), ("eikonal", B * J), ("man_loss", M))):
            assert_close(f"tile kernel loss sum {k} vs branch_ref", l_kp[i], l_pp[i],
                         rtol=TERM_RTOL, atol=rows * TERM_ROW_ATOL)
        errs["tile"] = max(errs["tile"], max(float((g_kp[k] - g_pp[k]).abs().max()) for k in g_pp))
        return tiles, g_kp, l_kp

    def check_train_kernels(pose, dist, man, kw, f=field) -> None:
        """The tile kernel and the reduction each against its plain version on
        the same inputs, ``fused_train_grads`` against ``manual_train_grads``
        (every loss term and gradient leaf), and two calls bitwise equal;
        field ``f``."""
        w, m = f.weights(), f.module
        tiles, g_kp, l_kp = check_tile(pose, dist, man, kw, f)
        flat, l_kk = fused_train.launch_reduce(w, *tiles)
        del tiles
        g_kk, off = {}, 0
        for k, v in g_kp.items():            # the flat layout: encoder, then per layer W, b
            g_kk[k] = flat[off:off + v.numel()].view(v.shape)
            off += v.numel()
        # the reduction: the kernel's rows through both reductions
        rel = assert_leaves("reduce kernel vs reduce_ref (same rows)", g_kk, g_kp)
        errs["reduce_rel"] = max(errs["reduce_rel"], rel)
        log(f"  reduction (3xTF32 wgmma): largest error {rel:.3e} x max|leaf|, bar {LEAF_TOL}; "
            f"the fp32 CUDA-core reduction it replaced: up to {REDUCE_FP32_ERR} (whole gradient)")
        assert_close("reduce kernel loss sums vs reduce_ref", l_kk, l_kp, rtol=1e-6, atol=0.0)
        errs["reduce"] = max(errs["reduce"],
                             max(float((g_kk[k] - g_kp[k]).abs().max()) for k in g_kp))
        # the whole gradient against manual_train_grads, and a repeat
        t_k, te_k, g_k = fused_train.fused_train_grads(w, pose, dist, man, **kw)
        t_r, te_r, g_r = fused_train.fused_train_grads(w, pose, dist, man, **kw)
        if not (torch.equal(t_k, t_r) and all(torch.equal(g_k[k], g_r[k]) for k in g_k)):
            raise AssertionError("two calls of fused_train_grads differ")
        log("  ok two calls of fused_train_grads: the same bits")
        del t_r, te_r, g_r
        t_m, te_m, g_m = manual_train_grads(dict(m.state_dict()), pose, dist, man,
                                            parents=m.parents, activation=m.activation, **kw)
        for k in te_m:
            assert_close(f"term {k} vs manual_train_grads", te_k[k], te_m[k], rtol=TERM_RTOL,
                         atol=TERM_ROW_ATOL)
        assert_leaves("fused_train_grads vs manual_train_grads", g_k, g_m)

    def check_encoder(q, misaligned: bool = False) -> None:
        """The encoder kernel against its plain version; with ``misaligned``,
        also on a copy of q that starts one float into its buffer, to the
        bit."""
        e = module.enc

        def kernel(x):
            return fused_encoder.fused_structure_encoder(x, e.w1, e.b1, e.w2, e.b2,
                                                         parents=module.parents,
                                                         activation=module.activation)

        with torch.no_grad():
            got = kernel(q)
            want = structure_encoder_apply(q, e.w1, e.b1, e.w2, e.b2, parents=module.parents,
                                           activation=module.activation)
            errs["enc"] = max(errs["enc"], assert_close(
                f"encoder kernel vs plain, B = {q.shape[0]}", got, want, atol=ENC_ATOL))
            if misaligned:
                buf = torch.empty(q.numel() + 1, device=q.device)
                shifted = buf[1:].view(q.shape).copy_(q)
                if shifted.data_ptr() % 16 == 0 or not shifted.is_contiguous():
                    raise AssertionError("the shifted poses are not a misaligned contiguous copy")
                if not torch.equal(kernel(shifted), got):
                    raise AssertionError(f"encoder kernel on poses one float into their buffer, "
                                         f"B = {q.shape[0]}: not the aligned result")
                log(f"  ok encoder kernel on poses one float into their buffer, B = "
                    f"{q.shape[0]}: the aligned result, to the bit")

    # ---- 7. train kernels vs plain on the card ----
    log_ptxas("train")
    sd = dict(module.state_dict())
    for (B, M), loss_type in (((4096, 4096), "l1"), ((1000, 700), "l2")):
        log(f"train kernels vs plain, B = {B}, M = {M}, {loss_type}")
        pose, dist, man = batch_on_card(B, M, SEED + 7 + B)
        check_train_kernels(pose, dist, man, dict(loss_type=loss_type, weight_dist=0.7,
                                                  weight_man=1.3, weight_eikonal=0.9))
    for B in TILE_BATCHES:
        log(f"tile kernel vs branch_ref, B = M = {B}")
        check_tile(*batch_on_card(B, B, SEED + 7 + B),
                   dict(loss_type="l1", weight_dist=0.7, weight_man=1.3, weight_eikonal=0.9))
    # the relu instance (train_tile_kernel<relu>), at the same bars
    for (B, M), loss_type in (((4096, 4096), "l1"), ((1000, 700), "l2")):
        log(f"train kernels vs plain, the relu field, B = {B}, M = {M}, {loss_type}")
        check_train_kernels(*batch_on_card(B, M, SEED + 9 + B),
                            dict(loss_type=loss_type, weight_dist=0.7, weight_man=1.3,
                                 weight_eikonal=0.9), relu)
    for B in (63, 129):
        log(f"tile kernel vs branch_ref, the relu field, B = M = {B}")
        check_tile(*batch_on_card(B, B, SEED + 9 + B),
                   dict(loss_type="l1", weight_dist=0.7, weight_man=1.3, weight_eikonal=0.9), relu)
    # the walks at the run-time feature width: the lrelu twin of the wide
    # encoder field (32 joints of 8 features, its rows the widest)
    wide = Field(wide_encoder_field("float32", activation="lrelu"))
    walks = dict(fused_train.TILE_WALK_LAUNCHES)
    for (B, M), loss_type in (((4096, 4096), "l1"), ((1000, 700), "l2")):
        log(f"train kernels vs plain, the 32-joint 8-feature lrelu field, B = {B}, M = {M}, "
            f"{loss_type}")
        q_n, q_m = (random_poses(gen, n, device="cuda", num_joints=32) for n in (B, M))
        dist = torch.rand(B, generator=gen).cuda() * 0.5
        check_train_kernels(q_n, dist, q_m, dict(loss_type=loss_type, weight_dist=0.7,
                                                 weight_man=1.3, weight_eikonal=0.9), wide)
    walks = {k: fused_train.TILE_WALK_LAUNCHES[k] - v for k, v in walks.items()}
    log(f"  tile launches by walk width on the 32-joint field: {walks}")
    if walks["compiled"] != 0 or walks["runtime"] <= 0:
        raise AssertionError(f"the 8-feature field's tiles took other walks: {walks}")
    del wide
    # the instances of this field's feature width (one an activation)
    for line in ptxas_lines(_build.build_info("train")["log"],
                            (f"encoder_kernelILi{w.feature_size}E",)):
        log("  nvcc -Xptxas -v: " + line)
    for B in ENC_BATCHES:
        check_encoder(random_poses(gen, B, device="cuda"), misaligned=B in (1000, SERVE_BATCH))

    # ---- 8. against the JAX package ----
    ref = np.load(TRAIN_EXPECTED)
    seed, rows, steps = int(ref["seed"]), int(ref["rows"]), int(ref["steps"])
    log(f"train kernels vs the JAX package ({TRAIN_EXPECTED}, {rows} + {rows} poses)")
    pose, dist, man = batch_on_card(rows, rows, seed)
    total, terms, grads = fused_train.fused_train_grads(w, pose, dist, man)
    assert_close("total vs JAX", total, torch.tensor(float(ref["grad_total"])), rtol=TERM_RTOL,
                 atol=0.0)
    for k in terms:
        assert_close(f"term {k} vs JAX", terms[k], torch.tensor(float(ref[f"grad_term_{k}"])),
                     rtol=TERM_RTOL, atol=0.0)
    check_summaries("gradient", "grad", grads, ref)
    ref_r = np.load(RELU_TRAIN_EXPECTED)
    log(f"the relu field vs the JAX package ({RELU_TRAIN_EXPECTED}, {rows} + {rows} poses)")
    pose_r, dist_r, man_r = batch_on_card(int(ref_r["rows"]), int(ref_r["rows"]),
                                          int(ref_r["seed"]))
    total, terms, grads = fused_train.fused_train_grads(relu.weights(), pose_r, dist_r, man_r)
    assert_close("relu total vs JAX", total, torch.tensor(float(ref_r["grad_total"])),
                 rtol=TERM_RTOL, atol=0.0)
    for k in terms:
        assert_close(f"relu term {k} vs JAX", terms[k],
                     torch.tensor(float(ref_r[f"grad_term_{k}"])), rtol=TERM_RTOL, atol=0.0)
    check_summaries("relu gradient", "grad", grads, ref_r)
    trained = load_field(CKPT, device="cuda").module
    lr = float(ref["lr"])
    step = make_train_step(trained, make_optimizer(trained.parameters(), lr,
                                                   float(ref["weight_decay"])),
                           loss_type="l1", weights={"dist": 1.0, "man_loss": 1.0, "eikonal": 1.0},
                           fused=True)
    for s_ in range(steps):
        b_pose, b_dist, b_man = batch_on_card(rows, rows, seed + 1 + s_)
        m = step({"pose": b_pose, "dist": b_dist, "man_poses": b_man})
        for i, k in enumerate(("total", "dist", "man_loss", "eikonal")):
            assert_close(f"step {s_} {k} vs JAX", m[k], torch.tensor(ref["step_terms"][s_, i]),
                         rtol=TERM_RTOL, atol=0.0)
    worst = 0.0
    for k, v in trained.state_dict().items():
        a = v.double().reshape(-1).cpu()
        err = np.abs(a[torch.from_numpy(ref[f"idx_{k}"]).long()].numpy() - ref[f"param_at_{k}"])
        if not (err.max() <= 2 * steps * lr and np.mean(err > lr / 20) <= 0.01):
            raise AssertionError(f"weights after {steps} steps, {k}: max |err| {err.max():.3e}, "
                                 f"{np.mean(err > lr / 20):.4f} of them above lr / 20")
        worst = max(worst, float(err.max()))
    log(f"  ok weights after {steps} fused Adam steps vs JAX: max |err| {worst:.3e} "
        f"(lr {lr})")

    # ---- 9. main path: training ----
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        labeled, amass = write_synthetic_dataset(
            os.path.join(tmp, "data"), subsets=AMASS_SPLITS["train"], seqs_per_subset=4,
            poses_per_seq=128, queries_per_seq=64, seed=SEED)
        from posendf_torch.config import PoseNDFConfig

        cfg = PoseNDFConfig()
        cfg.data.data_dir, cfg.data.amass_dir = labeled, amass
        cfg.experiment.root_dir = os.path.join(tmp, "runs")
        cfg.dfnet.live_head = True
        cfg.train.fused_grads = True
        cfg.train.batch_size, cfg.train.num_pts = TRAIN_FILES, TRAIN_PTS
        batcher = TrainingBatcher(labeled, amass, batch_size=TRAIN_FILES, num_pts=TRAIN_PTS,
                                  seed=SEED)
        log(f"main path, training: {len(batcher.labeled)} labelled files, {len(batcher)} steps "
            f"of {TRAIN_FILES} x {TRAIN_PTS} poses; data made in "
            f"{time.perf_counter() - t0:.1f} s")
        fused_train.TILE_LAUNCHES = fused_train.REDUCE_LAUNCHES = fused_encoder.LAUNCHES = 0
        fused_train.TILE_WALK_LAUNCHES.update(compiled=0, runtime=0)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device="cuda")
        stats = trainer.matched_head_init(batcher.sample_batch())
        before = {k: v.clone() for k, v in trainer.module.state_dict().items()}
        trainer.fit(batcher, epochs=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        rec = [json.loads(x) for x in open(os.path.join(trainer.exp_dir, "metrics.jsonl"))][-1]
        # strenc.fused: autodiff steps through the encoder kernel
        cfg2 = copy.deepcopy(cfg)
        cfg2.strenc.fused, cfg2.train.fused_grads = True, False
        cfg2.experiment.root_dir = os.path.join(tmp, "runs_enc")
        enc_trainer = Trainer(cfg2, device="cuda")
        enc_metrics = [enc_trainer.train_step(batcher.sample_batch()) for _ in range(2)]
        torch.cuda.synchronize()
        launches = {"tile": fused_train.TILE_LAUNCHES, "reduce": fused_train.REDUCE_LAUNCHES,
                    "enc": fused_encoder.LAUNCHES}
        walks = dict(fused_train.TILE_WALK_LAUNCHES)
        log(f"  matched-head init {stats}")
        log(f"  1 epoch, {len(batcher)} fused steps in {fit_s:.3f} s (first run, build and "
            f"data included): {rec}  [{card}]")
        log(f"  launches {launches}, tile walks {walks}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"the training path launched no {name} kernel")
        if walks != {"compiled": launches["tile"], "runtime": 0}:
            raise AssertionError(f"the SMPL field's tiles took the run-time walk: {walks}")
        if launches["reduce"] != len(batcher) or launches["tile"] != len(batcher):
            raise AssertionError(f"expected {len(batcher)} fused steps, launches {launches}")
        for k in ("train/total", "train/dist", "train/man_loss", "train/eikonal"):
            if not np.isfinite(rec[k]):
                raise AssertionError(f"training gave a non-finite {k}")
        for m in enc_metrics:
            if not all(bool(torch.isfinite(v)) for v in m.values()):
                raise AssertionError("an autodiff step with strenc.fused gave a non-finite loss")
        moved = sum(int((v != before[k]).sum()) for k, v in trainer.module.state_dict().items())
        if moved == 0:
            raise AssertionError("training did not move the weights")
        log(f"  {moved} weights moved; strenc.fused autodiff losses "
            f"{[round(float(m['total']), 6) for m in enc_metrics]}")
        reloaded = load_field(trainer.store.directory, config=cfg, device="cuda")
        q = random_poses(gen, 1000, device="cuda")
        with torch.no_grad():
            assert_close("reloaded checkpoint d vs the trained module", reloaded.distance(q),
                         trainer.module(q), atol=1e-6)
        batch = {k: torch.from_numpy(v).cuda() for k, v in batcher.sample_batch().items()}
        with torch.no_grad():
            live = (float((trainer.module(batch["pose"]) > 0).float().mean()),
                    float((trainer.module(batch["man_poses"], False) > 0).float().mean()))
        log(f"  after training, d > 0 on {live[0]:.4f} of the noisy poses and {live[1]:.4f} of "
            "the manifold poses of a batch")
        if live[0] == 0.0:
            raise AssertionError("the trained field is 0 on every noisy pose")

    # ---- 10. checks and times at the main path's batch, 20,000 + 20,000 poses ----
    pose, dist, man = batch["pose"], batch["dist"], batch["man_poses"]
    B, M = pose.shape[0], man.shape[0]
    kw = dict(loss_type="l1", weight_dist=1.0, weight_man=1.0, weight_eikonal=1.0)
    log(f"train kernels vs plain at the main path's batch, B = {B}, M = {M}")
    check_train_kernels(pose, dist, man, kw)
    log(f"train kernels vs plain at the main path's batch, the relu field, B = {B}, M = {M}")
    check_train_kernels(pose, dist, man, kw, relu)
    check_encoder(pose)
    check_encoder(man)

    timed = copy.deepcopy(module)
    opt = make_optimizer(timed.parameters(), 1e-9)
    weights = {"dist": 1.0, "man_loss": 1.0, "eikonal": 1.0}
    step_f = make_train_step(timed, opt, loss_type="l1", weights=weights, fused=True)
    step_a = make_train_step(timed, opt, loss_type="l1", weights=weights, fused=False)
    b = {"pose": pose, "dist": dist, "man_poses": man}
    fused_step_ms, auto_step_ms = interleaved_ms("train step: fused vs autodiff",
                                                 lambda: step_f(b), lambda: step_a(b), 3,
                                                 card=card)
    with torch.no_grad():   # the weights' slabs: packed anew inside every fused step
        pack_ms = cuda_ms(lambda: pack_tc(FieldWeights.from_module(timed)), 20)
    grads_ms, manual_ms = interleaved_ms(
        "gradient: fused_train_grads vs manual_train_grads",
        lambda: fused_train.fused_train_grads(w, pose, dist, man, **kw),
        lambda: manual_train_grads(sd, pose, dist, man, parents=module.parents,
                                   activation=module.activation, **kw), 3)
    kw_n, kw_m = fused_train.branch_args(w, pose, dist, man, **kw)
    zeros = torch.zeros_like(man[:, 0, 0])
    tiles = []

    def tile_kernel():
        tiles[:] = fused_train.launch_tiles(w, pose, dist, man, kw_n, kw_m)

    def tile_plain():
        with torch.no_grad():
            fused_train.branch_ref(w, pose, dist, **kw_n)
            fused_train.branch_ref(w, man, zeros, **kw_m)

    # library yardstick: the DFNet's products of the tile's traversals as torch.matmul
    # (forward, pullback, forward on the noisy rows; forward, pullback on the manifold rows)
    tile_products = [dfnet_products(w, B, backward=True), dfnet_products(w, B, backward=False),
                     dfnet_products(w, M, backward=True)]

    def tile_library():
        for run in tile_products:
            run()

    tile_ms, tile_plain_ms, tile_lib_ms = interleaved_ms(
        "tile kernel, both branches", tile_kernel, tile_plain, 3, library=tile_library,
        card=card)
    rows = [t.branch_rows(w) for t in tiles]
    stacked = [(torch.cat([torch.cat([rows[0].a[l], rows[1].a[l]]),
                           torch.cat([rows[0].dd, rows[1].dd])[:, None]], dim=1),
                torch.cat([rows[0].c[l], rows[1].c[l]])) for l in range(len(w.layers))]

    def library():
        for a, c in stacked:
            torch.matmul(a.T, c)

    with torch.no_grad():
        reduce_ms, reduce_plain_ms = interleaved_ms(
            "reduction", lambda: fused_train.launch_reduce(w, *tiles),
            lambda: fused_train.reduce_ref(w, *rows), 5)
        library_ms = cuda_ms(library, 5)
        serve = random_poses(gen, SERVE_BATCH, device="cuda")
        e = module.enc
        enc_ms, enc_plain_ms = interleaved_ms(
            f"encoder B={SERVE_BATCH}",
            lambda: fused_encoder.fused_structure_encoder(serve, e.w1, e.b1, e.w2, e.b2,
                                                          parents=module.parents),
            lambda: structure_encoder_apply(serve, e.w1, e.b1, e.w2, e.b2,
                                            parents=module.parents), 20)
    log(f"train step, {B} + {M} poses: fused {fused_step_ms:.4f} ms (of it the weights' pack "
        f"{pack_ms:.4f} ms), autodiff {auto_step_ms:.4f} ms; gradient alone: fused_train_grads "
        f"{grads_ms:.4f} ms, manual_train_grads {manual_ms:.4f} ms  [{card}]")
    log(f"  tile kernel (both branches) {tile_ms:.4f} ms, plain {tile_plain_ms:.4f} ms, its "
        f"products as torch.matmul {tile_lib_ms:.4f} ms; reduction {reduce_ms:.4f} ms, plain "
        f"{reduce_plain_ms:.4f} ms, torch.matmul per layer {library_ms:.4f} ms  [{card}]")
    log(f"encoder B={SERVE_BATCH}: kernel {enc_ms:.4f} ms, plain {enc_plain_ms:.4f} ms  [{card}]")

    flop = traversal_flops(w)
    ins = sum(wl.shape[0] for wl, _ in w.layers)
    outs = sum(wl.shape[1] for wl, _ in w.layers)
    nenc = sum(v.numel() for v in w.enc.values())
    nparam = sum(p.numel() for p in module.parameters())
    slots = (tiles[0].enc_slot.shape[0] + tiles[1].enc_slot.shape[0]) * (nenc + 2)
    scratch = (B + M) * (ins + outs + 1)
    # the tile kernel: 3 traversals a noisy pose, 2 a manifold one; the DFNet's hidden
    # products as three TF32 passes at the TF32 peak, the rest (encoder, output layer)
    # at the fp32 peak; the poses, labels and parameters in, the scratch and slots out
    trav = 3 * B + 2 * M
    tc_flop = 2 * sum(wl.numel() for wl, _ in w.layers[:-1])
    tile_bytes = 4 * ((B + M) * 84 + B + nparam + scratch + slots)
    t_ops = (3 * tc_flop * trav / PEAK_TF32 + (flop - tc_flop) * trav / PEAK_FLOPS) * 1e3
    t_bytes = tile_bytes / PEAK_BYTES * 1e3
    tile_bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    tile_fp32 = bound(trav * flop, tile_bytes)   # every operation at the fp32 CUDA-core peak
    log(f"bounds: tile kernel {tile_bound[0]:.4f} ms ({tile_bound[1]}: 3 x {tc_flop * trav:.4g} "
        f"TF32 operations at {PEAK_TF32 / 1e12} TFLOP/s and {(flop - tc_flop) * trav:.4g} fp32 "
        f"ones; {t_bytes:.4f} ms for the bytes); the same work at the fp32 CUDA-core peak "
        f"{tile_fp32[0]:.4f} ms; the kernel {tile_ms:.4f} ms, {tile_ms / tile_bound[0]:.2f}x its "
        f"bound, {tile_ms / tile_lib_ms:.3f}x its products as torch.matmul  [{card}]")
    # three TF32 passes of the products on the tensor cores, the slot sums on the CUDA cores
    reduce_flops = 2 * (B + M) * sum((wl.shape[0] + 1) * wl.shape[1] for wl, _ in w.layers)
    t_ops = (3 * reduce_flops / PEAK_TF32 + 2 * slots / PEAK_FLOPS) * 1e3
    t_bytes = 4 * (scratch + slots + nparam + 3) / PEAK_BYTES * 1e3
    reduce_bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log(f"bounds: reduction {reduce_bound[0]:.4f} ms ({reduce_bound[1]}: 3 x {reduce_flops:.4g} "
        f"TF32 operations at {PEAK_TF32 / 1e12} TFLOP/s; {t_bytes:.4f} ms to read the "
        f"{4 * scratch / 1e6:.1f} MB of scratch once); largest error of the reduction "
        f"{errs['reduce_rel']:.3e} x max|leaf| (bar {LEAF_TOL})  [{card}]")
    E = 4 + w.feature_size
    enc_bound = bound(SERVE_BATCH * 2 * w.num_joints * (E * E + E * w.feature_size),
                      4 * (SERVE_BATCH * 21 * (4 + w.feature_size) + nenc))
    src = "posendf_torch/csrc/train_kernels.cu"
    return [
        {"name": "posendf_encoder", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_encoder.py:46", "launches": launches["enc"],
         "max_abs_err": errs["enc"], "ms": enc_ms, "plain_ms": enc_plain_ms,
         "bound_ms": enc_bound[0], "bound_by": enc_bound[1], "library_ms": None},
        {"name": "posendf_train_tile", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_train.py:78", "launches": launches["tile"],
         "max_abs_err": errs["tile"], "ms": tile_ms, "plain_ms": tile_plain_ms,
         "bound_ms": tile_bound[0], "bound_by": tile_bound[1], "library_ms": tile_lib_ms},
        {"name": "posendf_train_reduce", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_train.py:78", "launches": launches["reduce"],
         "max_abs_err": errs["reduce"], "ms": reduce_ms, "plain_ms": reduce_plain_ms,
         "bound_ms": reduce_bound[0], "bound_by": reduce_bound[1], "library_ms": library_ms},
    ]


def check_summaries(what: str, prefix: str, leaves: dict, ref) -> None:
    """Each leaf's sum (to LEAF_TOL x sum|leaf|), L2 norm (rtol LEAF_TOL) and
    sampled values (LEAF_TOL x max|leaf|) against the JAX-made file."""
    worst = 0.0
    for k, v in leaves.items():
        a = v.detach().double().reshape(-1).cpu()
        scale = float(ref[f"{prefix}_max_{k}"])
        errs = (abs(float(a.sum()) - float(ref[f"{prefix}_sum_{k}"]))
                / float(ref[f"{prefix}_abssum_{k}"]),
                abs(float(a.norm()) - float(ref[f"{prefix}_norm_{k}"]))
                / float(ref[f"{prefix}_norm_{k}"]),
                float(np.abs(a[torch.from_numpy(ref[f"idx_{k}"]).long()].numpy()
                             - ref[f"{prefix}_at_{k}"]).max()) / scale)
        if max(errs) > LEAF_TOL:
            raise AssertionError(f"{what} {k} vs JAX: sum, norm, samples off by {errs}")
        worst = max(worst, *errs)
    log(f"  ok {what} vs JAX: largest relative error {worst:.3e}")


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def apart_ranks(d_ref, atol: float, d_next=None) -> np.ndarray:
    """Where the reference's sorted distance lies more than ``atol`` from
    both neighbouring ranks (``d_next``: its next distance after the last
    rank; without it the last rank never counts as apart)."""
    d_ref = _np(d_ref)
    nxt = np.zeros((len(d_ref), 1)) if d_next is None else _np(d_next).reshape(-1, 1)
    gap_prev = np.diff(d_ref, axis=1, prepend=-np.inf)
    gap_next = np.diff(np.concatenate([d_ref, nxt], axis=1), axis=1)
    if d_next is None:
        gap_next[:, -1] = 0.0
    return (gap_prev > atol) & (gap_next > atol)


def check_topk(name: str, d, i, d_ref, i_ref, atol: float, d_next=None,
               exact_idx: bool = False) -> float:
    """Tie-aware top-k comparison: distances within ``atol`` rank by rank,
    indices equal wherever the ranks are apart (:func:`apart_ranks`), or
    everywhere with ``exact_idx``. Returns the largest distance error."""
    d, i, d_ref, i_ref = (_np(x) for x in (d, i, d_ref, i_ref))
    if d.shape != d_ref.shape or not np.isfinite(d).all():
        raise AssertionError(f"{name}: shape {d.shape} vs {d_ref.shape}, or non-finite")
    err = float(np.abs(d - d_ref).max())
    if err > atol:
        raise AssertionError(f"{name}: max |err| {err:.3e} > {atol}")
    sure = np.ones(d.shape, bool) if exact_idx else apart_ranks(d_ref, atol, d_next)
    bad = int((i[sure] != i_ref[sure]).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} indices differ where the ranks are apart")
    return err


def knn_golden_inputs(seed: int, n_corpus: int, n_queries: int, latents: int):
    """The corpus and queries of ``scripts/make_torch_port_knn_golden.py``
    (its ``make_inputs``), through the port's byte-identical copies of the
    synthetic manifold and the query sampler."""
    from posendf_torch.data.prepare import NoiseSpec, sample_noisy_queries
    from posendf_torch.data.synthetic import manifold_family, synthetic_manifold_poses

    rng = np.random.default_rng(seed)
    family = manifold_family(rng, latents=latents)
    corpus = synthetic_manifold_poses(rng, n_corpus, family=family)
    return corpus, sample_noisy_queries(corpus, n_queries, NoiseSpec(), rng)


def knn_phases(card: str) -> list:
    """Phases 11-13; returns the kNN kernel's JSON entries, one per engine."""
    import tempfile

    from posendf_torch.data import prepare
    from posendf_torch.data.synthetic import manifold_family, synthetic_manifold_poses
    from posendf_torch.ops import fused_knn
    from posendf_torch.ops.knn import geodesic_rerank, geodesic_topk
    from posendf_torch.quat import JOINT_WEIGHTS

    from posendf_torch import _build

    engines = list(fused_knn.ENGINES)
    w_np = JOINT_WEIGHTS.numpy()
    w_sum = float(w_np.sum())
    errs = dict.fromkeys(engines, 0.0)
    rng = np.random.default_rng(SEED + 11)

    def unit(n):
        q = rng.normal(size=(n, 21, 4)).astype(np.float32)
        return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True)).cuda()

    def plain(q, c, k, engine, weights=None):
        qf, cf, wj, wt = fused_knn.kernel_operands(q, c, weights, engine)
        return fused_knn.knn_topk_ref(qf, cf, k, weights=wj, w_total=wt, dot_impl=engine)

    def atol_of(engine, weights):
        return BOUND_ATOL if engine == "mxu_fast" else KNN_ATOL * (1.0 if weights is None else w_sum)

    # ---- 11. the kNN kernel vs its plain version on the card ----
    log_ptxas("knn")
    lib = _build.library("knn")
    for N in (20_000, 65_536):     # the bound engine's corpus pack, to the byte
        _, cf, _, _ = fused_knn.kernel_operands(unit(8), unit(N), None, "mxu_fast")
        packed = torch.empty(lib.posendf_knn_bound_bytes(N), dtype=torch.uint8, device="cuda")
        cmax = torch.zeros(1, device="cuda")
        _build.check(lib.posendf_knn_pack(cf.data_ptr(), N, packed.data_ptr(), cmax.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream),
                     "posendf_knn_pack", "knn")
        if not torch.equal(packed, fused_knn.pack_bound_ref(cf)):
            raise AssertionError(f"posendf_knn_pack vs pack_bound_ref, N = {N}: other bytes")
        assert_close(f"posendf_knn_pack's largest row norm, N = {N}", cmax,
                     cf.norm(dim=1).max()[None], rtol=1e-6, atol=0.0)
    log("  ok posendf_knn_pack vs pack_bound_ref at N = 20,000 and 65,536: the same bytes")
    for N in (20_000, 65_536):     # the exact and bf16 engines' corpus pack, to the byte
        _, cf, _, _ = fused_knn.kernel_operands(unit(8), unit(N), None, "vpu")
        packed = torch.empty(lib.posendf_knn_joint_bytes(N), dtype=torch.uint8, device="cuda")
        cmax = torch.zeros(21, device="cuda")
        _build.check(lib.posendf_knn_pack_joint(cf.data_ptr(), N, packed.data_ptr(),
                                                cmax.data_ptr(),
                                                torch.cuda.current_stream().cuda_stream),
                     "posendf_knn_pack_joint", "knn")
        want, want_max = fused_knn.pack_joint_ref(cf)
        if not torch.equal(packed, want):
            raise AssertionError(f"posendf_knn_pack_joint vs pack_joint_ref, N = {N}: other bytes")
        assert_close(f"posendf_knn_pack_joint's largest norm a joint, N = {N}", cmax, want_max,
                     rtol=1e-6, atol=0.0)
    log("  ok posendf_knn_pack_joint vs pack_joint_ref at N = 20,000 and 65,536: the same bytes")
    for Q in (1000, KNN_Q):
        for N in (20_000, 65_536):
            q, c = unit(Q), unit(N)
            for weights in (None, w_np):
                for engine in engines:
                    d_p, i_p = plain(q, c, 33, engine, weights)
                    for k in (1, 5, 8, 16, 32):
                        d_k, i_k = fused_knn.fused_geodesic_topk(q, c, k, weights=weights,
                                                                 dot_impl=engine)
                        errs[engine] = max(errs[engine], check_topk(
                            f"{engine} Q={Q} N={N} k={k}", d_k, i_k, d_p[:, :k], i_p[:, :k],
                            atol_of(engine, weights), d_p[:, k]))
            log(f"  ok kNN kernel vs knn_topk_ref, Q = {Q}, N = {N}, unweighted and weighted, "
                f"k in 1, 5, 8, 16, 32: max |err| {errs}")
    log(f"  the bound engine (bf16 wgmma): largest error {errs['mxu_fast']:.3e}, bar {BOUND_ATOL}")
    base = unit(10_000)
    c = torch.cat([base, base])              # row j + 10,000 duplicates row j
    q = torch.cat([base[:500], unit(500)])
    for engine in engines:
        d_k, i_k = fused_knn.fused_geodesic_topk(q, c, 8, dot_impl=engine)
        d_p, i_p = plain(q, c, 8, engine)
        check_topk(f"{engine} duplicated rows", d_k, i_k, d_p, i_p, atol_of(engine, None),
                   exact_idx=engine != "mxu_fast")
        want = torch.stack([torch.arange(500), torch.arange(500) + 10_000], dim=1)
        if not torch.equal(i_k[:500, :2].cpu(), want):
            raise AssertionError(f"{engine}: a query's two copies in the corpus are not "
                                 "its first two neighbours, lowest index first")
    log("  ok duplicated rows: the kernel's indices are the plain version's, and each "
        "query's two copies come first, lowest index first")
    q, c = unit(KNN_Q), unit(65_536)
    for engine in engines:
        qf, cf, wj, wt = fused_knn.kernel_operands(q, c, None, engine)
        runs = [fused_knn.fused_geodesic_topk(q, c, KNN_K, dot_impl=engine) for _ in range(2)]
        runs += [fused_knn._launch(qf, cf, KNN_K, wj, wt, engine, S) for S in (1, 7)]
        if not all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0])):
            raise AssertionError(f"{engine}: two calls or two split counts differ")
    log("  ok two calls, and split counts S = default, 1 and 7: the same bits")
    for weights in (None, w_np):
        d_k, i_k = fused_knn.fused_geodesic_topk_fast(q, c, KNN_K, weights=weights)
        _, cand = plain(q, c, 10, "mxu_fast", weights)
        wt = None if weights is None else torch.from_numpy(weights).cuda()
        d_p, i_p = geodesic_rerank(q, c, cand, KNN_K, wt)
        check_topk("fused_geodesic_topk_fast vs its plain composition", d_k, i_k, d_p, i_p,
                   atol_of("vpu", weights), exact_idx=True)
    log("  ok fused_geodesic_topk_fast vs knn_topk_ref's prescreen + geodesic_rerank")

    # ---- 12. against the JAX package ----
    ref = np.load(KNN_EXPECTED)
    seed = int(ref["seed"])
    corpus_np, queries_np = knn_golden_inputs(seed, int(ref["n_corpus"]), int(ref["n_queries"]),
                                              int(ref["latents"]))
    q, c = torch.from_numpy(queries_np).cuda(), torch.from_numpy(corpus_np).cuda()
    k = int(ref["k"])
    log(f"kNN vs the JAX package ({KNN_EXPECTED}, {len(q)} queries x {len(c)} poses, k = {k})")
    wt = torch.from_numpy(w_np).cuda()
    checks = [
        ("plain geodesic_topk vs JAX geodesic_topk", geodesic_topk(q, c, k), "geo", KNN_ATOL),
        ("plain geodesic_topk weighted vs JAX", geodesic_topk(q, c, k, weights=wt), "geo_w",
         KNN_ATOL * w_sum),
        ("vpu kernel vs JAX's kernel (interpret)", fused_knn.fused_geodesic_topk(q, c, k), "vpu",
         KNN_ATOL),
        ("vpu kernel vs JAX geodesic_topk", fused_knn.fused_geodesic_topk(q, c, k), "geo",
         KNN_ATOL),
        ("vpu kernel weighted vs JAX geodesic_topk weighted",
         fused_knn.fused_geodesic_topk(q, c, k, weights=w_np), "geo_w", KNN_ATOL * w_sum),
        ("mxu_fast kernel (the bound) vs JAX's kernel (interpret)",
         fused_knn.fused_geodesic_topk(q, c, k, dot_impl="mxu_fast"), "mxu_fast", BOUND_ATOL),
        ("fused_geodesic_topk_fast vs JAX", fused_knn.fused_geodesic_topk_fast(q, c, k), "fast",
         KNN_ATOL),
    ]
    for name, (d, i), key, atol in checks:
        err = check_topk(name, d, i, ref[f"{key}_d"], ref[f"{key}_i"], atol)
        log(f"  ok {name}: max |err| {err:.3e}")
    d, _ = fused_knn.fused_geodesic_topk(q, c, k, dot_impl="mxu_bf16")
    err = float(np.abs(d.cpu().numpy() - ref["vpu_d"]).max())
    if err > BF16_BAR + KNN_ATOL:
        raise AssertionError(f"mxu_bf16 kernel vs JAX's exact distances: {err:.3e}")
    log(f"  ok mxu_bf16 kernel vs JAX's exact distances: max |err| {err:.3e} "
        f"(bar {BF16_BAR + KNN_ATOL:.3e})")
    stats = prepare.probe_fast_safety(corpus_np, np.random.default_rng(seed + 1), device="cuda")
    for key, v in stats.items():
        want = ref[f"probe_{key}"]
        ok = (abs(v - float(want)) <= KNN_ATOL if key.startswith("label_mae")
              else v == want.item())
        if not ok:
            raise AssertionError(f"probe_fast_safety {key}: {v} vs JAX {want}")
    log(f"  ok probe_fast_safety on the card vs JAX: {stats}")
    labels = prepare.label_sequence(corpus_np[:512], c, num_queries=int(ref["label_queries"]),
                                    k=k, rng=np.random.default_rng(seed + 2),
                                    precision="highest")
    if float(labels["pose"].astype(np.float64).sum()) != float(ref["label_pose_sum"]):
        raise AssertionError("label_sequence drew other queries than JAX")
    assert_close("label_sequence(precision='highest') dist on the card vs JAX",
                 torch.from_numpy(labels["dist"]), torch.from_numpy(ref["label_dist"]),
                 atol=KNN_ATOL)

    # ---- 13. main path: labelling against a 1,048,576-pose corpus ----
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sampled = os.path.join(tmp, "sampled")
        os.makedirs(os.path.join(sampled, "ACCAD"))
        g = np.random.default_rng(SEED + 13)
        family = manifold_family(g, latents=8)
        for f in range(CORPUS_FILES):
            np.savez(os.path.join(sampled, "ACCAD", f"seq{f:02d}.npz"),
                     pose=synthetic_manifold_poses(g, CORPUS_ROWS, family=family))
        log(f"main path, labelling: {CORPUS_FILES} sampled files x {CORPUS_ROWS} poses, made in "
            f"{time.perf_counter() - t0:.1f} s")

        def refuse(*args, **kwargs):
            raise AssertionError("the main path called the kNN kernel's plain version")

        for e in engines:
            fused_knn.LAUNCHES[e] = 0
        saved_ref, fused_knn.knn_topk_ref = fused_knn.knn_topk_ref, refuse
        walls, out = {}, {}
        for prec in ("auto", "highest", "fast", "default"):
            t0 = time.perf_counter()
            files = prepare.label_split(sampled, os.path.join(tmp, f"labeled_{prec}"), ["ACCAD"],
                                        num_queries=100, runs=100, k=KNN_K, precision=prec,
                                        shard=(0, CORPUS_FILES), device="cuda")
            torch.cuda.synchronize()
            walls[prec] = time.perf_counter() - t0
            if len(files) != 1:
                raise AssertionError(f"label_split labelled {len(files)} sequences, not 1")
            with np.load(files[0]) as z:
                out[prec] = {key: z[key] for key in z.files}
        fused_knn.knn_topk_ref = saved_ref
        launches = dict(fused_knn.LAUNCHES)
        t0 = time.perf_counter()
        corpus_np, _ = prepare.build_corpus(sampled, ["ACCAD"])
        read_s = time.perf_counter() - t0
        picked, _ = prepare.resolve_knn_precision(     # label_split's own call
            "auto", corpus_np, k=KNN_K, rng=np.random.default_rng([0, 9999]), device="cuda",
            verbose=False)
        n_q = len(out["auto"]["pose"])
        log(f"  label_split, {n_q} queries x {CORPUS_FILES * CORPUS_ROWS} poses: wall "
            + ", ".join(f"{p} {walls[p]:.3f} s ({n_q / walls[p]:.1f} queries/s)" for p in walls)
            + f"; kNN launches {launches}  [{card}]")
        for e, n in launches.items():
            if n <= 0:
                raise AssertionError(f"the labelling path launched no {e} kNN kernel")
        exact, fast, bf16 = out["highest"], out["fast"], out["default"]
        if any(out["auto"][key].tobytes() != out[picked][key].tobytes() for key in exact):
            raise AssertionError(f"'auto' on the card gave other labels than {picked!r}, the "
                                 "engine resolve_knn_precision picks")
        for o in (fast, bf16):
            if o["pose"].tobytes() != exact["pose"].tobytes():
                raise AssertionError("the labelling runs drew other queries")
        for name, o in (("exact", exact), ("fast", fast), ("bf16", bf16)):
            if o["dist"].shape != (n_q, KNN_K) or not np.isfinite(o["dist"]).all() \
                    or o["nn_pose"].shape != (n_q, KNN_K, 21, 4):
                raise AssertionError(f"{name} labels: bad shape or non-finite")
        log(f"  ok 'auto' gave the labels of {picked!r}, the engine resolve_knn_precision picks "
            f"(prepare.FAST_ENGINE_BACKENDS {sorted(prepare.FAST_ENGINE_BACKENDS)}), to the byte")
    t0 = time.perf_counter()
    corpus = torch.from_numpy(corpus_np).cuda()
    torch.cuda.synchronize()
    log(f"  of a label_split's wall: reading the {CORPUS_FILES} files {read_s:.3f} s, the "
        f"corpus to the card {time.perf_counter() - t0:.3f} s")
    stats = prepare.probe_fast_safety(corpus_np, np.random.default_rng(SEED + 14), device="cuda")
    if not stats["safe"]:
        raise AssertionError(f"probe_fast_safety finds 'fast' unsafe on the pose corpus: {stats}")
    log(f"  ok probe_fast_safety on the whole corpus (is 'fast' exact on it): {stats}")
    q_all = torch.from_numpy(exact["pose"]).cuda()
    d_p, i_p = geodesic_topk(q_all[:256], corpus, KNN_K + 1)
    d_p, i_p, d_next = _np(d_p[:, :KNN_K]), _np(i_p[:, :KNN_K]), _np(d_p[:, KNN_K])
    err = float(np.abs(exact["dist"][:256] - d_p).max())
    sure = apart_ranks(d_p, KNN_ATOL, d_next)
    if err > KNN_ATOL or not np.array_equal(exact["nn_pose"][:256][sure], corpus_np[i_p][sure]):
        raise AssertionError(f"exact labels vs plain geodesic_topk: max |err| {err:.3e}, or "
                             "other neighbours where the ranks are apart")
    log(f"  ok exact labels vs plain geodesic_topk on the first 256 queries against the whole "
        f"corpus: max |err| {err:.3e}, the same neighbours on {sure.mean():.4f} of the ranks "
        f"(the rest lie within {KNN_ATOL} of a neighbouring rank)")

    def rows(nn):
        return [set(x.tobytes() for x in r) for r in nn]

    overlap = float(np.mean([len(a & b) / KNN_K for a, b in zip(rows(fast["nn_pose"]),
                                                                 rows(exact["nn_pose"]))]))
    gap = np.abs(fast["dist"] - exact["dist"])
    if float(gap.max()) > KNN_ATOL or overlap != 1.0:
        raise AssertionError(f"'fast' labels vs the exact ones: max |err| {float(gap.max()):.3e}, "
                             f"top-{KNN_K} overlap {overlap}")
    err_bf16 = float(np.abs(bf16["dist"] - exact["dist"]).max())
    if err_bf16 > BF16_BAR + KNN_ATOL:
        raise AssertionError(f"bf16 labels off the exact ones by {err_bf16:.3e}")
    log(f"  ok fast labels vs exact, every query: max |err| {float(gap.max()):.3e} (bar "
        f"{KNN_ATOL}), top-{KNN_K} overlap {overlap:.6f}, label MAE {float(gap.mean()):.3e}; "
        f"bf16 labels within {err_bf16:.3e} of the exact ones (bar {BF16_BAR + KNN_ATOL:.3e})")

    # times at Q = 4096, N = 1,048,576, k = 5; every engine's kernel held to
    # its plain version on the same inputs, the main path's first batch
    q = q_all[:KNN_Q]
    Q, N = q.shape[0], corpus.shape[0]
    log(f"kNN times, Q = {Q}, N = {N}, k = {KNN_K}")
    times, got = {}, {}
    for e in engines:
        def kernel(e=e):
            got[e] = fused_knn.fused_geodesic_topk(q, corpus, KNN_K, dot_impl=e)

        def plain_call(e=e):
            got[e, "plain"] = plain(q, corpus, KNN_K, e)

        times[e] = interleaved_ms(f"kNN {e} (pack, top-k, merge) vs knn_topk_ref", kernel, plain_call,
                                  3, rounds=1, plain_reps=1)
        d_p, i_p = got[e, "plain"]
        d_next = plain(q, corpus, KNN_K + 1, e)[0][:, KNN_K]
        err = check_topk(f"{e} at Q = {Q}, N = {N}", *got[e], d_p, i_p, atol_of(e, None), d_next)
        errs[e] = max(errs[e], err)
        msg = f"  ok {e} kernel vs knn_topk_ref at Q = {Q}, N = {N}, k = {KNN_K}: max |err| {err:.3e}"
        label = {"vpu": exact, "mxu_bf16": bf16}.get(e)
        if label is not None:
            # the labels of the main path's first batch, which are these queries
            d_p, i_p, d_next = _np(d_p), _np(i_p), _np(d_next)
            err = float(np.abs(label["dist"][:Q] - d_p).max())
            sure = apart_ranks(d_p, KNN_ATOL, d_next)
            if err > KNN_ATOL or not np.array_equal(label["nn_pose"][:Q][sure],
                                                    corpus_np[i_p][sure]):
                raise AssertionError(f"{e} labels of the first {Q} queries vs knn_topk_ref: "
                                     f"max |err| {err:.3e}, or other neighbours where the "
                                     "ranks are apart")
            msg += f"; the main path's labels of these queries too: max |err| {err:.3e}"
        log(msg)
    fast_ms = cuda_ms(lambda: fused_knn.fused_geodesic_topk_fast(q, corpus, KNN_K), 3)
    log(f"  the exact engine {times['vpu'][0]:.4f} ms vs fused_geodesic_topk_fast (the bound "
        f"prescreen + exact rerank, the same labels) {fast_ms:.4f} ms: the "
        f"{'exact engine' if times['vpu'][0] < fast_ms else 'prescreen + rerank'} is the faster "
        f"(prepare.FAST_ENGINE_BACKENDS {sorted(prepare.FAST_ENGINE_BACKENDS)})  [{card}]")
    geo_ms = cuda_ms(lambda: geodesic_topk(q, corpus, KNN_K), 1)
    qf, cf, _, _ = fused_knn.kernel_operands(q, corpus, None, "mxu_fast")
    chunk = 65_536
    lib = {}

    def library():
        ds, idx = [], []
        for s0 in range(0, N, chunk):
            v, i = torch.topk(1.0 - torch.matmul(qf, cf[s0:s0 + chunk].T), KNN_K, dim=1,
                              largest=False)
            ds.append(v)
            idx.append(i + s0)
        v, i = torch.topk(torch.cat(ds, dim=1), KNN_K, dim=1, largest=False)
        lib["d"] = v

    lib_ms = cuda_ms(library, 3)
    packed = torch.empty(_build.library("knn").posendf_knn_bound_bytes(N), dtype=torch.uint8,
                         device="cuda")
    cmax = torch.zeros(1, device="cuda")
    pack_ms = cuda_ms(lambda: _build.library("knn").posendf_knn_pack(
        cf.data_ptr(), N, packed.data_ptr(), cmax.data_ptr(),
        torch.cuda.current_stream().cuda_stream), 5)
    del packed
    knn_lib = _build.library("knn")
    joint_bytes = knn_lib.posendf_knn_joint_bytes(N)
    packed = torch.empty(joint_bytes, dtype=torch.uint8, device="cuda")
    cmax = torch.zeros(21, device="cuda")
    joint_pack_ms = cuda_ms(lambda: knn_lib.posendf_knn_pack_joint(
        corpus.data_ptr(), N, packed.data_ptr(), cmax.data_ptr(),
        torch.cuda.current_stream().cuda_stream), 5)
    del packed
    lib_err = float((lib["d"] - got["mxu_fast"][0]).abs().max())
    if lib_err > YARD_BAR:
        raise AssertionError(f"the bound engine's values vs one fp32 product's: {lib_err:.3e} "
                             f"> {YARD_BAR:.3e}")
    log(f"  fused_geodesic_topk_fast (prescreen + rerank) {fast_ms:.4f} ms; plain "
        f"geodesic_topk {geo_ms:.4f} ms; the bound's top-k by torch.matmul + torch.topk over "
        f"{chunk}-row chunks {lib_ms:.4f} ms (ok: its values within {lib_err:.3e} of the "
        f"kernel's, bar {YARD_BAR:.3e}); of the bound engine's call, the corpus pack "
        f"{pack_ms:.4f} ms; of the exact and bf16 engines' calls, the corpus pack "
        f"(posendf_knn_pack_joint, {joint_bytes} bytes) {joint_pack_ms:.4f} ms  [{card}]")

    nbytes = 4 * (Q * 84 + N * 84 + 21) + Q * KNN_K * (4 + 8)
    core_bound = bound(KNN_PAIR_OPS * Q * N, nbytes)      # the CUDA-core route they had before
    # the tensor-core route: the products each engine needs at the bf16 peak,
    # an FFMA a joint and pair at the fp32 peak, the fp32 operands read once
    tc_bound = {e: bound(KNN_TC_OPS[e] * Q * N, nbytes, PEAK_BF16) for e in KNN_TC_OPS}
    ffma_bound = bound(KNN_FFMA_OPS * Q * N, nbytes)
    joint_bound = {e: max(tc_bound[e], ffma_bound) for e in KNN_TC_OPS}
    bound_bound = bound(3 * 2 * 84 * Q * N, nbytes, PEAK_BF16)
    log(f"bounds: exact engine {joint_bound['vpu'][0]:.4f} ms ({joint_bound['vpu'][1]}), bf16 "
        f"engine {joint_bound['mxu_bf16'][0]:.4f} ms ({joint_bound['mxu_bf16'][1]}): their "
        f"products on the bf16 tensor cores {KNN_TC_OPS['vpu']} / {KNN_TC_OPS['mxu_bf16']} "
        f"operations a pair {tc_bound['vpu'][0]:.4f} / {tc_bound['mxu_bf16'][0]:.4f} ms, "
        f"{KNN_FFMA_OPS // 2} FFMA a pair {KNN_FFMA_OPS * Q * N / PEAK_FLOPS * 1e3:.4f} ms, the "
        f"fp32 operands {nbytes / PEAK_BYTES * 1e3:.4f} ms; the CUDA-core route they had before "
        f"{core_bound[0]:.4f} ms ({core_bound[1]}, {KNN_PAIR_OPS} operations a pair on the fp32 "
        f"CUDA cores); bound engine {bound_bound[0]:.4f} ms ({bound_bound[1]}, 3 bf16 passes of "
        f"the K = 84 product on the tensor cores); reading the fp32 corpus once "
        f"{N * 84 * 4 / PEAK_BYTES * 1e3:.4f} ms")
    src = "posendf_torch/csrc/knn_kernels.cu"
    rows_out = []
    for e in engines:
        b = bound_bound if e == "mxu_fast" else joint_bound[e]
        launched = ("posendf_knn_pack + posendf_knn_bound" if e == "mxu_fast"
                    else "posendf_knn_pack_joint + posendf_knn_joint")
        row = {"name": f"{launched} + posendf_knn_merge ({e})", "route": "cuda",
               "source": src, "replaces": "posendf_tpu/ops/fused_knn.py:68",
               "launches": launches[e], "max_abs_err": errs[e], "ms": times[e][0],
               "plain_ms": times[e][1], "bound_ms": b[0], "bound_by": b[1],
               "library_ms": lib_ms if e == "mxu_fast" else None}
        if e == "mxu_fast":
            row["library"] = f"torch.matmul + torch.topk per {chunk}-row chunk, one torch.topk"
            row["pack_ms"] = pack_ms
        else:
            row["pack_ms"] = joint_pack_ms
        rows_out.append(row)
    return rows_out


def unit_poses(seed: int, n: int) -> np.ndarray:
    """Per-joint unit quaternions from a normal draw, as
    ``scripts/make_torch_port_int8_golden.py`` makes its calibration and
    probe poses."""
    q = np.random.default_rng(seed).normal(size=(n, 21, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def ptxas_lines(log_text: str, kernels) -> list:
    """nvcc's ``-Xptxas -v`` lines (registers, spills, shared memory) of the
    named kernels: each entry's lines up to the next entry."""
    out, keep = [], False
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in kernels)
        if keep:
            out.append(line.strip())
    return out


def log_ptxas(name: str) -> None:
    """Log nvcc's ``-Xptxas -v`` lines of library ``name``'s wgmma kernels;
    fail where ptxas serialized the wgmma of one not in SERIALIZED_KNOWN."""
    from posendf_torch import _build

    text = _build.build_info(name)["log"]
    for line in ptxas_lines(text, WGMMA_KERNELS[name]):
        log("  nvcc -Xptxas -v: " + line)
    serial = [line.strip() for line in text.splitlines()
              if "serialized" in line and any(k in line for k in WGMMA_KERNELS[name])]
    for line in serial:
        log("  nvcc -Xptxas -v: " + line)
    new = [line for line in serial if not any(k in line for k in SERIALIZED_KNOWN)]
    if new:
        raise AssertionError(f"ptxas serialized the wgmma of {name}'s kernels: {new}")
    if serial:
        log(f"  known: ptxas serializes the wgmma of {', '.join(SERIALIZED_KNOWN)} "
            "(PERF.md section 7); no other kernel's")


def hold_strided(name: str, fn, q: torch.Tensor) -> None:
    """``fn`` on a strided view (every other pose) and on a permuted-then-
    viewed copy of ``q`` gives, to the bit, what it gives on the contiguous
    poses."""
    views = {"poses[::2]": (q[::2], q[::2].contiguous()),
             "permuted": (q.transpose(0, 1).contiguous().transpose(0, 1), q)}
    for what, (view, dense) in views.items():
        if view.is_contiguous():
            raise AssertionError(f"{what} is contiguous: not a strided check")
        got, want = fn(view), fn(dense)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} on {what}: not the contiguous result")
    log(f"  ok {name} on poses[::2] and a permuted view: the contiguous result, to the bit")


def hold_reversed(name: str, fn, q: torch.Tensor) -> None:
    """``fn`` on the poses in reverse order gives, to the bit, its result
    on ``q`` reversed: each pose's arithmetic does not depend on its CTA,
    so a fault that a CTA (the ragged tail's, or a later wave's) alone
    makes shows even where a statistical hold admits it."""
    got, want = fn(q.flip(0)), fn(q)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if not torch.equal(a, b.flip(0)):
            raise AssertionError(f"{name} on the poses reversed: not the result reversed")
    log(f"  ok {name} on the {q.shape[0]} poses reversed: the result reversed, to the bit")


def hold_int8(name: str, qfield, pose: torch.Tensor, d: torch.Tensor, d_ref) -> float:
    """The int8 kernel's d against a plain d of the same poses
    (``fused_int8.hold_to_ref``: INT8_ATOL, or the plain d with the first
    int8 layer's boundary levels moved); returns the largest |err| of all
    poses, the moved ones included."""
    from posendf_torch.ops import fused_int8

    d_ref = torch.as_tensor(d_ref).to(d.device)
    m = qfield.module
    r = fused_int8.hold_to_ref(d, d_ref, pose, qfield.qparams, parents=m.parents,
                               activation=m.activation, beta=m.beta, atol=INT8_ATOL)
    err = max_err(d.float(), d_ref.float())
    log(f"  ok {name}: max |err| {r['max_abs_err']:.3e} on {d.shape[0] - r['one_level']} poses; "
        f"{r['one_level']} poses held to the plain d with a boundary level moved (their "
        f"|err| up to {r['one_level_max']:.3e})")
    return err


def check_qparams(name: str, port: dict, ref: dict, max_flip_share: float) -> None:
    """The port's quantization against a reference tree of the same weights
    and poses: window and floored channels equal, fp32 layers and w_absmax
    to the bit, dq within rtol 1e-6, the activation scales sa = 1/inv_sa
    within 1e-6 x the layer's largest (the count beyond rtol 1e-6 logged),
    wq equal but for at most ``max_flip_share`` of its entries, each one
    level apart."""
    if tuple(port["window"]) != tuple(ref["window"]):
        raise AssertionError(f"{name}: window {port['window']} vs {ref['window']}")
    if list(port["report"]["floored_channels"]) != list(ref["report"]["floored_channels"]):
        raise AssertionError(f"{name}: floored channels differ")
    if list(port["report"]["w_absmax"]) != [float(v) for v in ref["report"]["w_absmax"]]:
        raise AssertionError(f"{name}: w_absmax differs")
    flips = entries = sa_rel = 0
    for l, (lp, lr) in enumerate(zip(port["layers"], ref["layers"])):
        if "w" in lr:
            if not np.array_equal(lp["w"], lr["w"]) or not np.array_equal(lp["b"], lr["b"]):
                raise AssertionError(f"{name}: fp32 layer {l} differs")
            continue
        dq_err = np.abs(lp["dq"] / lr["dq"] - 1).max()
        sa_p, sa_r = 1.0 / lp["inv_sa"].astype(np.float64), 1.0 / lr["inv_sa"].astype(np.float64)
        diff = np.abs(lp["wq"].astype(int) - lr["wq"].astype(int))
        if dq_err > 1e-6 or np.abs(sa_p - sa_r).max() > 1e-6 * sa_r.max() or diff.max() > 1:
            raise AssertionError(f"{name} layer {l}: dq rel {dq_err:.3e}, sa "
                                 f"{np.abs(sa_p - sa_r).max() / sa_r.max():.3e} of the largest, "
                                 f"wq up to {diff.max()} levels apart")
        sa_rel += int((np.abs(sa_p / sa_r - 1) > 1e-6).sum())
        flips += int(diff.sum())
        entries += diff.size
    if flips > max_flip_share * entries:
        raise AssertionError(f"{name}: {flips} of {entries} wq entries one level apart")
    log(f"  ok {name}: window {tuple(port['window'])}, floored channels "
        f"{list(port['report']['floored_channels'])}; {flips} of {entries} wq entries one level "
        f"apart; {sa_rel} activation scales beyond rtol 1e-6 (within 1e-6 x the layer's largest)")


def serving_phases(field, card: str) -> list:
    """Phases 14-17; returns the int8 kernel's and the probe kernels' JSON
    entries."""
    import tempfile

    from posendf_torch import _build, cli, load_field
    from posendf_torch.export import load_artifact
    from posendf_torch.field import QuantizedField
    from posendf_torch.ops import fused_int8, int8_probe

    serve = torch.from_numpy(unit_poses(SEED + 40, SERVE_BATCH)).cuda()

    # ---- 14. the int8 kernel vs its plain version on the card ----
    qfield = field.quantize_int8(torch.from_numpy(unit_poses(SEED + 41, INT8_CALIB)).cuda())
    rep = qfield.qparams["report"]
    pk = fused_int8.packed(qfield.qparams, field.module.parents)
    smem = _build.library("int8").posendf_int8_smem_bytes(*pk.x_bytes, pk.maxn)
    log(f"int8 kernel vs plain: {CKPT} quantized on {INT8_CALIB} poses on the card, window "
        f"{qfield.qparams['window']}, floored channels {rep['floored_channels']}, {smem} bytes "
        f"of shared memory per CTA")
    log_ptxas("int8")
    int8_err = 0.0
    for B in INT8_BATCHES:
        p = serve[:B] if B == SERVE_BATCH else torch.from_numpy(unit_poses(SEED + 42 + B, B)).cuda()
        int8_err = max(int8_err, hold_int8(f"distance (kernel) vs distance_ref, B = {B}", qfield,
                                           p, qfield.distance(p), qfield.distance_ref(p)))
    hold_strided("QuantizedField.distance", qfield.distance, serve[:4096])
    with torch.no_grad():
        d32 = field.distance(serve).double().cpu().numpy().ravel()
    d8 = qfield.distance(serve).double().cpu().numpy().ravel()
    mae, std = float(np.mean(np.abs(d8 - d32))), float(np.std(d32))
    pearson = float(np.corrcoef(d8, d32)[0, 1])
    spearman = float(np.corrcoef(*(np.argsort(np.argsort(v)).astype(np.float64)
                                   for v in (d8, d32)))[0, 1])
    if not (mae < 0.03 * std and pearson > 0.998 and spearman > 0.995):
        raise AssertionError(f"int8 vs fp32 field: MAE {mae:.3e} (std {std:.3e}), Pearson "
                             f"{pearson:.6f}, Spearman {spearman:.6f}")
    log(f"  ok int8 kernel vs the fp32 field at {SERVE_BATCH} poses: MAE {mae:.4e} = "
        f"{mae / std:.4f} std (bar 0.03), Pearson {pearson:.6f} (bar 0.998), Spearman "
        f"{spearman:.6f} (bar 0.995)")

    # ---- 15. against the JAX package ----
    ref = np.load(INT8_EXPECTED)
    jq = fused_int8.qparams_from_numpy({k[3:]: ref[k] for k in ref.files if k.startswith("qp/")},
                                       "cuda")
    jfield = QuantizedField(field.module, jq)
    probes = torch.from_numpy(ref["probes"]).cuda()
    log(f"int8 vs the JAX package ({INT8_EXPECTED}, {probes.shape[0]} probes)")
    d = jfield.distance(probes)
    int8_err = max(int8_err, hold_int8("kernel on JAX's qparams vs reference_int8_forward",
                                       jfield, probes, d, torch.from_numpy(ref["d_ref"])),
                   hold_int8("kernel on JAX's qparams vs JAX's kernel (interpret)", jfield,
                             probes, d, torch.from_numpy(ref["d_kernel"])))
    own = field.quantize_int8(torch.from_numpy(unit_poses(int(ref["seed"]), int(ref["calib"]))).cuda())
    check_qparams("quantize_posendf on the card vs JAX's", fused_int8.qparams_to_numpy(own.qparams),
                  fused_int8.qparams_to_numpy(jq), WQ_FLIP_SHARE)
    rows, layers = int(ref["probe_b"]), int(ref["probe_layers"])
    g = np.random.default_rng(int(ref["probe_seed"]))      # probe_chain_inputs of the script
    xb = torch.from_numpy(g.normal(size=(rows, 512)).astype(np.float32)).cuda().bfloat16()
    wb = torch.from_numpy((g.normal(size=(layers, 512, 512)) * 0.05).astype(np.float32))
    wb = wb.cuda().bfloat16()
    xi = torch.from_numpy(g.integers(-127, 128, size=(rows, 512)).astype(np.int8)).cuda()
    wi = torch.from_numpy(g.integers(-127, 128, size=(layers, 512, 512)).astype(np.int8)).cuda()
    si = torch.full((1, layers), 1.0 / 64.0, device="cuda")
    if not torch.equal(int8_probe.run_int8(xi, wi, si, layers).cpu(),
                       torch.from_numpy(ref["int8_out"].astype(np.float32))):
        raise AssertionError("probe_int8_chain vs JAX's int8 chain: not bitwise equal")
    jb = torch.from_numpy(ref["bf16_out"].view(np.int16).copy()).view(torch.bfloat16)
    share = float((int8_probe.bf16_ulps(int8_probe.run_bf16(xb, wb, layers).cpu(), jb) > 1)
                  .float().mean())
    if share >= BF16_CHAIN_SHARE:
        raise AssertionError(f"probe_bf16_chain vs JAX: {share:.4%} of elements more than one "
                             f"bf16 spacing apart")
    log(f"  ok probe chains vs JAX's ({rows} x 512, {layers} layers): int8 bitwise; bf16 "
        f"{share:.4%} of elements more than one spacing apart (bar {BF16_CHAIN_SHARE:.0%})")

    # ---- 16. main path: serving ----
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "field.int8.msgpack")
        t0 = time.perf_counter()
        f32 = load_field(CKPT, device="cuda")
        qf = f32.quantize_int8(torch.from_numpy(unit_poses(SEED + 41, INT8_CALIB)).cuda())
        qf.save(path)
        loaded = QuantizedField.load(path, device="cuda")
        for a, b in zip(fused_int8._tensors(loaded.qparams), fused_int8._tensors(qf.qparams)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("QuantizedField.save then load changed the quantized field")
        if loaded.qparams["window"] != qf.qparams["window"] or \
                loaded.qparams["report"] != qf.qparams["report"]:
            raise AssertionError("QuantizedField.save then load changed the window or report")

        def refuse(*args, **kwargs):
            raise AssertionError("the serving path called the int8 kernel's plain version")

        saved = fused_int8.fused_posendf_forward_int8_ref, fused_int8.int8_layers_ref
        fused_int8.fused_posendf_forward_int8_ref = fused_int8.int8_layers_ref = refuse
        fused_int8.LAUNCHES = 0
        try:
            d_main = loaded.distance(serve)
            torch.cuda.synchronize()
        finally:
            fused_int8.fused_posendf_forward_int8_ref, fused_int8.int8_layers_ref = saved
        int8_launches = fused_int8.LAUNCHES
        wall = time.perf_counter() - t0
        log(f"main path, serving: load_field -> quantize_int8 ({INT8_CALIB} poses) -> save -> "
            f"QuantizedField.load (the same bits) -> distance of {SERVE_BATCH} poses in "
            f"{wall:.3f} s (first run); int8 launches {int8_launches}")
        if int8_launches <= 0:
            raise AssertionError("the serving path launched no int8 kernel")
        if tuple(d_main.shape) != (SERVE_BATCH, 1) or not bool(torch.isfinite(d_main).all()):
            raise AssertionError("serving d: bad shape or non-finite")
        int8_err = max(int8_err, hold_int8("the main path's d vs distance_ref", loaded, serve,
                                           d_main, loaded.distance_ref(serve)))
        art8, art32 = os.path.join(tmp, "model.int8.pt2"), os.path.join(tmp, "model.pt2")
        t0 = time.perf_counter()
        cli.main(["export", "--device", "cuda", "--out", art8, "--int8", "--quantized", path])
        cli.main(["export", "--device", "cuda", "--ckpt", CKPT, "--out", art32,
                  "--what", "forward"])
        export_s = time.perf_counter() - t0
        served8, served32 = load_artifact(art8).module(), load_artifact(art32).module()
        for B in (4096, 1000):
            p = serve[:B]
            with torch.no_grad():
                assert_close(f"int8 artifact vs distance_ref, B = {B}", served8(p),
                             loaded.distance_ref(p), atol=EXPORT_ATOL)
                assert_close(f"fp32 artifact vs distance, B = {B}", served32(p),
                             f32.distance(p), atol=EXPORT_ATOL)
        log(f"  cli export --int8 --quantized and --what forward: {export_s:.3f} s, artifacts "
            f"{os.path.getsize(art8)} and {os.path.getsize(art32)} bytes")

    with torch.no_grad():
        int8_ms, int8_plain_ms = interleaved_ms(
            f"int8 forward B={SERVE_BATCH}", lambda: qfield.distance(serve),
            lambda: qfield.distance_ref(serve), 5)
        int8_ms2, fp32_ms = interleaved_ms(
            f"int8 forward vs the fp32 posendf_forward kernel, B={SERVE_BATCH}",
            lambda: qfield.distance(serve), lambda: field.distance_fused(serve), 5)
    qlayers = [lyr for lyr in qfield.qparams["layers"] if "wq" in lyr]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    xq = [torch.randint(-127, 128, (SERVE_BATCH, lyr["wq"].shape[0]), generator=gen,
                        device="cuda", dtype=torch.int8) for lyr in qlayers]
    int_mm_ms = cuda_ms(lambda: [torch._int_mm(x, lyr["wq"]) for x, lyr in zip(xq, qlayers)], 10)
    log(f"int8 forward B={SERVE_BATCH}: kernel {int8_ms:.4f} ms ({SERVE_BATCH / int8_ms * 1e3:.4g} "
        f"evals/s), plain {int8_plain_ms:.4f} ms; the fp32 kernel {fp32_ms:.4f} ms against "
        f"{int8_ms2:.4f} ms in the same rounds: int8 / fp32 speed {fp32_ms / int8_ms2:.3f}x; "
        f"the {len(qlayers)} int8 products alone as torch._int_mm {int_mm_ms:.4f} ms  [{card}]")

    # ---- 17. the probe kernels ----
    xb, wb, xi, wi, si = int8_probe.probe_inputs(rows=SERVE_BATCH, seed=SEED + 44)
    probe_err = {"bf16": 0.0, "int8": 0.0}
    # a row's result does not depend on the rows beside it: below 1,000 rows
    # (too few elements for the chain's share bar) the bf16 chain is held to
    # its own result at the full batch, to the bit
    full_bf16 = {n: int8_probe.run_bf16(xb, wb, n) for n in (1, int8_probe.LAYERS)}
    for rows in PROBE_ROWS:
        log(f"probe kernels vs plain at ({rows}, 512), both on wgmma")
        # one layer at a time, each fed the plain chain's input: the bf16 layer bar
        x_in, worst, differ = xb[:rows], 0.0, []
        for l in range(int8_probe.LAYERS):
            ob = int8_probe.run_bf16(x_in, wb[l:l + 1], 1)
            rb = int8_probe.run_bf16_ref(x_in, wb[l:l + 1], 1)
            excess = float(int8_probe.bf16_layer_excess(ob, rb, x_in, wb[l]).max())
            if excess > 1:
                raise AssertionError(f"probe_bf16_chain, {rows} rows, layer {l} alone: "
                                     f"{excess:.3f} of the bar")
            worst = max(worst, excess)
            differ.append(float((ob != rb).float().mean()))
            probe_err["bf16"] = max(probe_err["bf16"], max_err(ob.float(), rb.float()))
            x_in = rb
        log(f"  ok bf16, each of the {int8_probe.LAYERS} layers alone on the plain chain's input: "
            f"the largest difference {worst:.3f} of its bar (one spacing + both sums' rounding), "
            f"max |err| {probe_err['bf16']:.3e}; elements that differ, layer by layer: "
            + ", ".join(f"{v:.4%}" for v in differ))
        for layers in (1, int8_probe.LAYERS):
            oi = int8_probe.run_int8(xi[:rows], wi, si, layers)
            if not torch.equal(oi, int8_probe.run_int8_ref(xi[:rows], wi, si, layers)):
                raise AssertionError(f"probe_int8_chain, {rows} rows, {layers} layers: not "
                                     f"bitwise equal")
            ob = int8_probe.run_bf16(xb[:rows], wb, layers)
            if rows < 1000:
                if not torch.equal(ob, full_bf16[layers][:rows]):
                    raise AssertionError(f"probe_bf16_chain, {rows} rows, {layers} layers: not "
                                         f"the full batch's first rows, bitwise")
                log(f"  ok {layers} layer(s): int8 bitwise; bf16 chain the full batch's first "
                    f"{rows} row(s), bitwise")
                continue
            rb = int8_probe.run_bf16_ref(xb[:rows], wb, layers)
            ulps = int8_probe.bf16_ulps(ob, rb)
            share = float((ulps > 1).float().mean())
            log(f"  ok {layers} layer(s): int8 bitwise; bf16 chain "
                f"{float((ulps > 0).float().mean()):.4%} of elements differ, {share:.4%} by more "
                f"than one spacing (bar {BF16_CHAIN_SHARE:.0%}), max |err| "
                f"{max_err(ob.float(), rb.float()):.3e}")
            if share >= BF16_CHAIN_SHARE:
                raise AssertionError(f"probe_bf16_chain, {rows} rows, {layers} layers: "
                                     f"{share:.4%} of elements more than one spacing apart")
            del oi, ob, rb, ulps
    for k in int8_probe.LAUNCHES:
        int8_probe.LAUNCHES[k] = 0
    log("python -m posendf_torch.ops.int8_probe:")
    int8_probe.main()
    probe_launches = dict(int8_probe.LAUNCHES)
    log(f"  probe launches {probe_launches}")
    for k, n in probe_launches.items():
        if n <= 0:
            raise AssertionError(f"the probe launched no {k} kernel")
    bf16_ms, bf16_plain_ms = interleaved_ms("probe bf16 chain", lambda: int8_probe.run_bf16(xb, wb),
                                            lambda: int8_probe.run_bf16_ref(xb, wb), 5)
    i8_ms, i8_plain_ms = interleaved_ms("probe int8 chain", lambda: int8_probe.run_int8(xi, wi, si),
                                        lambda: int8_probe.run_int8_ref(xi, wi, si), 5)
    def library_bf16():                      # one torch.matmul (cuBLAS) a layer
        x = xb
        for l in range(int8_probe.LAYERS):
            x = torch.matmul(x, wb[l])

    def library_int8():                      # torch._int_mm and requantization a layer
        x = xi
        for l in range(int8_probe.LAYERS):
            f = torch._int_mm(x, wi[l]).float() * si[0, l]
            x = torch.clamp(torch.round(f), -127.0, 127.0).to(torch.int8)

    def library_int8_products():             # the 8 products alone, torch._int_mm each
        for l in range(int8_probe.LAYERS):
            torch._int_mm(xi, wi[l])

    bf16_lib_ms = cuda_ms(library_bf16, 10)
    i8_chain_ms = cuda_ms(library_int8, 10)
    i8_lib_ms = cuda_ms(library_int8_products, 10)
    ops = 2.0 * SERVE_BATCH * 512 * 512 * int8_probe.LAYERS
    for name, t, lib, peak in (("bf16", bf16_ms, bf16_lib_ms, PEAK_BF16),
                               ("int8", i8_ms, i8_lib_ms, PEAK_INT8)):
        log(f"probe {name}: kernel {t:.4f} ms, {ops / t / 1e9:.1f} T{'FLOP' if name == 'bf16' else 'OP'}"
            f"/s = {ops / t * 1e3 / peak:.2%} of the dense peak; its products as a library call "
            f"a layer {lib:.4f} ms, {ops / lib / 1e9:.1f} T/s  [{card}]")
    log(f"probe int8 with requantization as library calls (torch._int_mm, scale, round, clamp, "
        f"cast a layer) {i8_chain_ms:.4f} ms  [{card}]")
    log(f"probe int8 / bf16 speed: kernels {bf16_ms / i8_ms:.3f}x (both on wgmma), products as "
        f"library calls {bf16_lib_ms / i8_lib_ms:.3f}x  [{card}]")

    # bounds
    enc, qp_layers = qfield.qparams["enc"], qfield.qparams["layers"]
    int8_macs = sum(lyr["wq"].numel() for lyr in qp_layers if "wq" in lyr)
    f32_macs = (enc["w1"].numel() + enc["w2"].numel()
                + sum(lyr["w"].numel() for lyr in qp_layers if "w" in lyr))
    wbytes = sum(t.numel() * t.element_size() for t in fused_int8._tensors(qfield.qparams))
    t_ops = (2 * int8_macs * SERVE_BATCH / PEAK_INT8 + 2 * f32_macs * SERVE_BATCH / PEAK_FLOPS) * 1e3
    t_bytes = (4 * SERVE_BATCH * (21 * 4 + 1) + wbytes) / PEAK_BYTES * 1e3
    int8_bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    n_l, rows_b = int8_probe.LAYERS, SERVE_BATCH * 512
    bf16_bound = bound(ops, 2 * (2 * rows_b + n_l * 512 * 512), PEAK_BF16)
    i8_bound = bound(ops, rows_b + n_l * 512 * 512 + 4 * n_l + 4 * rows_b, PEAK_INT8)
    log(f"bounds: int8 forward {int8_bound[0]:.4f} ms ({int8_bound[1]}: {int8_macs} int8 and "
        f"{f32_macs} fp32 multiply-adds a pose); probe bf16 {bf16_bound[0]:.4f} ms, int8 "
        f"{i8_bound[0]:.4f} ms ({bf16_bound[1]})")
    src = "posendf_torch/csrc/int8_kernels.cu"
    return [
        {"name": "posendf_forward_int8", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_int8.py:181", "launches": int8_launches,
         "max_abs_err": int8_err, "ms": int8_ms, "plain_ms": int8_plain_ms,
         "bound_ms": int8_bound[0], "bound_by": int8_bound[1], "library_ms": int_mm_ms,
         "library": f"the {len(qlayers)} int8 products alone, torch._int_mm each"},
        {"name": "probe_bf16_chain", "route": "cuda", "source": src,
         "replaces": "scripts/int8_probe.py:33", "launches": probe_launches["bf16"],
         "max_abs_err": probe_err["bf16"], "ms": bf16_ms, "plain_ms": bf16_plain_ms,
         "bound_ms": bf16_bound[0], "bound_by": bf16_bound[1], "library_ms": bf16_lib_ms,
         "library": "torch.matmul on bf16 a layer"},
        {"name": "probe_int8_chain", "route": "cuda", "source": src,
         "replaces": "scripts/int8_probe.py:41", "launches": probe_launches["int8"],
         "max_abs_err": probe_err["int8"], "ms": i8_ms, "plain_ms": i8_plain_ms,
         "bound_ms": i8_bound[0], "bound_by": i8_bound[1], "library_ms": i8_lib_ms,
         "library": "the 8 int8 products alone, torch._int_mm each (no requantization)"},
    ]


def denoise_histories(den, noisy, iterations: int, steps_per_iter: int):
    """(final pose (T, 69), history {term: (steps,)}) of one clip's solve,
    through the denoiser's solver (the history ``optimize`` does not return)."""
    init = den.body_model(pose_body=noisy)
    pose, hist = den._solve(init.body_pose[None], {"betas": init.betas,
                                                   "init_joints": init.Jtr[None]},
                            iterations, steps_per_iter)
    return pose[0], {k: v[:, 0] for k, v in hist.items()}


def experiments_phase(card: str) -> None:
    """Phase 18, the motion-denoising path (no kernel of its own; the
    structure encoder's, row 4, when ``strenc.fused`` is set). Raises on any
    failure."""
    import tempfile

    from posendf_torch import load_field
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.data.synthetic import manifold_family
    from posendf_torch.experiments import denoise
    from posendf_torch.experiments.denoise_benchmark import (DEFAULT_GRID, run_sweep,
                                                             synthesize_grid)
    from posendf_torch.experiments.interpolate import interpolate
    from posendf_torch.ops import fused_encoder
    from posendf_torch.quat import axis_angle_to_quaternion
    from posendf_torch.smpl import BodyModel, lbs, synthetic_model

    class Recording(denoise.MotionDenoiser):
        """Keeps each solve's (input, final pose, metrics), and each serial
        solve's milliseconds (CUDA events around the call)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.solves, self.ms = [], []

        def optimize(self, noisy, *a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pose, m = super().optimize(noisy, *a, **kw)
            end.record()
            end.synchronize()
            self.ms.append(start.elapsed_time(end))
            self.solves.append((np.asarray(noisy)[None], pose[None], m))
            return pose, m

        def optimize_many(self, noisy, *a, **kw):
            pose, m = super().optimize_many(noisy, *a, **kw)
            self.solves.append((np.asarray(noisy), pose, m))
            return pose, m

    t_phase = time.perf_counter()
    steps = SWEEP_DEPTH[0] * SWEEP_DEPTH[1]
    field = load_field(CKPT, device="cuda")
    body = BodyModel(model=synthetic_model(num_vertices=SMPL_VERTICES), device="cuda")
    ref = np.load(DENOISE_EXPECTED)
    log(f"experiments: {CKPT}, a synthetic body of {SMPL_VERTICES} vertices (Jtr "
        f"{tuple(body(pose_body=ref['noisy']).Jtr.shape[1:])})")

    # ---- against the JAX package, on the golden's 128-vertex body ----
    pose, hist = denoise_histories(denoise.MotionDenoiser(field, BodyModel(device="cuda")),
                                   ref["noisy"], 2, 5)
    assert_close("2 x 5 denoise solve of 60 frames: pose vs JAX", pose,
                 torch.from_numpy(ref["solve_pose"]), atol=SOLVE_POSE_ATOL)
    for k in ("pose_pr", "temp", "data", "total"):
        assert_close(f"2 x 5 denoise solve: {k} history vs JAX", hist[k],
                     torch.from_numpy(ref[f"hist_{k}"]), rtol=SOLVE_HIST_RTOL, atol=1e-7)
    q = axis_angle_to_quaternion(torch.from_numpy(ref["noisy"][:, :63]).reshape(60, 21, 3))
    stats = denoise.estimate_clip_noise(field, q, probe_noise=ref["probe_noise"])
    for k, want in zip(("s", "s_field", "s_temporal", "d_input", "d_floor", "d_probe"),
                       ref["noise_stats"]):
        assert_close(f"estimate_clip_noise {k} vs JAX", torch.tensor([stats[k]]),
                     torch.tensor([want]), atol=NOISE_S_ATOL if k[0] == "s" else NOISE_D_ATOL)
    path, dist = interpolate(field, ref["interp_a"], ref["interp_b"], num_steps=10,
                             projection_steps=10)
    assert_close("interpolate path vs JAX", path, torch.from_numpy(ref["interp_path"]),
                 atol=PROJ_ATOL)
    assert_close("interpolate distances vs JAX", dist, torch.from_numpy(ref["interp_dist"]),
                 atol=D_ATOL)

    # ---- the sweep: 4 levels x 2 clips x 60 frames, SWEEP_DEPTH steps, batched ----
    family = manifold_family(np.random.default_rng(GRID_FAMILY_SEED), 21,
                             latents=GRID_LATENTS, freq_range=GRID_FREQ)
    with tempfile.TemporaryDirectory() as tmp:
        root = synthesize_grid(tmp, DEFAULT_GRID, seqs_per_level=2, family=family)
        sweeps = {}
        for specs in ("reference", "adaptive"):
            den = Recording(field, body, specs=specs)
            t0 = time.perf_counter()
            table = run_sweep(den, root, iterations=SWEEP_DEPTH[0],
                              steps_per_iter=SWEEP_DEPTH[1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sweeps[specs] = (den, table)
            if len(table) != len(DEFAULT_GRID) or len(den.solves) != len(DEFAULT_GRID):
                raise AssertionError(f"sweep {specs}: levels {sorted(table)}, "
                                     f"{len(den.solves)} solves")
            for level, v2v in table.items():
                if v2v.shape != (2,) or not np.isfinite(v2v).all():
                    raise AssertionError(f"sweep {specs} {level}: v2v {v2v}")
            for noisy, _, m in den.solves:
                C, T = noisy.shape[:2]
                with torch.no_grad():
                    q = axis_angle_to_quaternion(
                        torch.from_numpy(noisy[..., :63]).cuda().reshape(C * T, 21, 3))
                    d_in = field.distance(q).reshape(C, T).mean(1).cpu().numpy()
                if not (m["final_pose_pr"] < d_in).all():
                    raise AssertionError(f"sweep {specs}: final pose_pr {m['final_pose_pr']} "
                                         f"not below the inputs' mean distance {d_in}")
            log(f"  ok sweep {specs}: {len(den.solves)} batched solves of 2 clips, every final "
                f"pose_pr below its input's mean field distance; v2v cm "
                + ", ".join(f"{k} {np.round(v, 4).tolist()}" for k, v in table.items())
                + f"; wall {wall:.3f} s  [{card}]")
        # one level serially: each clip alone against its batched solve
        level = "noise_0.1_60"
        serial_den = Recording(field, body, specs="reference")
        serial = run_sweep(serial_den, root, grid_names=[level], iterations=SWEEP_DEPTH[0],
                           steps_per_iter=SWEEP_DEPTH[1], batch_clips=False)
        noisy, gt = (np.stack([denoise._load_pose_file(os.path.join(root, level, q, f))
                               for q in sorted(os.listdir(os.path.join(root, level)))])
                     for f in ("observations.npz", "gt_results.npz"))
    batched = [(n, p) for n, p, _ in sweeps["reference"][0].solves]
    for c, (noisy_c, pose_c, _) in enumerate(serial_den.solves):
        want = next(p[c] for n, p in batched if np.array_equal(n[c], noisy_c[0]))
        assert_close(f"{level} clip {c}: {steps}-step serial solve vs batched, pose", pose_c[0],
                     want, atol=LONG_SOLVE_POSE_ATOL)
    assert_close(f"{level}: {steps}-step serial v2v vs batched", torch.from_numpy(serial[level]),
                 torch.from_numpy(sweeps["reference"][1][level]), rtol=1e-3, atol=1e-4)
    # the horizon of tests/test_experiments.py's serial-vs-batched test (2 x 4 steps), its bars
    den = denoise.MotionDenoiser(field, body)
    many_pose, many_m = den.optimize_many(noisy, gt, iterations=2, steps_per_iter=4)
    for c in range(len(noisy)):
        pose_c, m_c = den.optimize(noisy[c], gt[c], iterations=2, steps_per_iter=4)
        assert_close(f"{level} clip {c}: 2 x 4-step serial solve vs batched, pose", pose_c,
                     many_pose[c], atol=2e-5)
        for k in ("v2v_cm", "v2v_input_cm", "final_pose_pr"):
            assert_close(f"{level} clip {c}: 2 x 4-step serial vs batched, {k}",
                         torch.tensor([m_c[k]]), torch.tensor([many_m[k][c]]), rtol=1e-3,
                         atol=1e-4)

    # ---- the structure encoder's kernel on the solve's path ----
    cfg = PoseNDFConfig()
    cfg.strenc.fused = True
    fused_field = load_field(CKPT, config=cfg, device="cuda")
    short = {name: denoise_histories(denoise.MotionDenoiser(f, body), ref["noisy"], 2, 4)
             for name, f in (("module path", field), ("fused encoder", fused_field))}
    assert_close("2 x 4-step solve, fused encoder vs module path: pose",
                 short["fused encoder"][0], short["module path"][0], atol=2e-5)
    # clip 0 of the level again, SWEEP_DEPTH steps with strenc.fused, against its serial solve
    fused_den = Recording(fused_field, body, specs="reference")
    fused_encoder.LAUNCHES = 0
    pose_f, m_f = fused_den.optimize(noisy[0], gt[0], iterations=SWEEP_DEPTH[0],
                                     steps_per_iter=SWEEP_DEPTH[1])
    launches = fused_encoder.LAUNCHES
    log(f"  {steps}-step solve of 60 frames at {SMPL_VERTICES} vertices with strenc.fused: "
        f"posendf_encoder launched {launches} times")
    if launches < steps:
        raise AssertionError(f"posendf_encoder launched {launches} times in a {steps}-step solve")
    pose_m, m_m = serial_den.solves[0][1][0], serial_den.solves[0][2]
    assert_close(f"{level} clip 0, {steps} steps: fused encoder vs module path, pose", pose_f,
                 pose_m, atol=LONG_SOLVE_POSE_ATOL)
    for k in ("final_pose_pr", "final_temp", "v2v_cm"):
        assert_close(f"{level} clip 0, {steps} steps: fused encoder vs module path, {k}",
                     torch.tensor([m_f[k]]), torch.tensor([m_m[k]]), rtol=LONG_SOLVE_TERM_RTOL,
                     atol=1e-6)
    step_ms = statistics.median(serial_den.ms) / steps
    for name, ms in (("module path", step_ms), ("fused encoder", fused_den.ms[0] / steps)):
        log(f"time denoise solve, {name}: {ms:.4f} ms a step (a {steps}-step solve of 60 frames at "
            f"{SMPL_VERTICES} vertices, its metrics' body-model passes included; CUDA events "
            f"around the call)  [{card}]")

    # ---- where a step's time goes: module-path steps under the profiler ----
    from torch.profiler import ProfilerActivity, profile

    den = denoise.MotionDenoiser(field, body)
    steps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        denoise_histories(den, ref["noisy"], 1, steps)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels:
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
        log(f"  {steps} module-path steps under torch.profiler: {len(kernels) / steps:.0f} device "
            f"kernels a step, busy {busy_ms:.4f} ms a step: {100 * (1 - busy_ms / step_ms):.1f}% "
            f"of the unprofiled {step_ms:.4f} ms step idle ({wall_ms:.4f} ms a step under the "
            f"profiler)  [{card}]")
    else:
        log("  torch.profiler recorded no device kernel: device busy share not measured")

    # ---- lbs_forward alone ----
    pb = torch.from_numpy(ref["noisy"]).cuda()
    betas, orient = torch.zeros((60, 10), device="cuda"), torch.zeros((60, 3), device="cuda")
    with torch.no_grad():
        ms = cuda_ms(lambda: lbs.lbs_forward(body.model, betas, orient, pb), 50)
    log(f"time lbs_forward, 60 frames, {SMPL_VERTICES} vertices: {ms:.4f} ms (mean of 50 calls "
        f"after one)  [{card}]")
    log(f"experiments phase: {time.perf_counter() - t_phase:.1f} s")


def manifold_corpus_cuda(family, n: int, seed: int) -> torch.Tensor:
    """(n, 21, 4) poses of ``data/synthetic.py``'s manifold ``family`` (its
    8-latent form), the latents drawn with numpy from ``seed`` and the poses
    made on the card in float64 (``_poses_from_latents``' formula), then
    rounded to float32: a 1,048,576-pose corpus without the host's seconds."""
    axes, freq, phase, weights = (torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                                  device="cuda") for a in family)
    z = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 2 * np.pi, size=(n, freq.shape[1]))).cuda()
    angle = torch.sum(weights * torch.sin(freq * z[:, None, :] + phase), dim=-1)   # (n, J)
    half = 0.5 * angle
    q = torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axes], dim=-1)
    return q.to(torch.float32)


def partial_phase(card: str) -> dict:
    """Phase 19, partial-observation completion and image fitting (the kNN
    kernel with zero joint weights, row 6; the encoder kernel with
    ``strenc.fused``, row 4). Returns the launches its main path adds to
    the ``kernels`` line: ``{"vpu": the retrieval's kNN launches, "enc":
    the fused solves' encoder launches}``. Raises on any failure."""
    import tempfile

    from posendf_torch import load_field
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.data.synthetic import manifold_family, synthetic_motion_sequence
    from posendf_torch.experiments import camera, fit_image, partial
    from posendf_torch.ops import fused_encoder, fused_knn
    from posendf_torch.ops.knn import geodesic_topk
    from posendf_torch.quat import axis_angle_to_matrix, quaternion_to_axis_angle
    from posendf_torch.smpl import BodyModel, synthetic_model

    sys.path.insert(0, "scripts")
    try:
        from make_torch_port_partial_golden import FIT_METRICS, K, WINDOW, make_inputs
    finally:
        sys.path.pop(0)
    t_phase = time.perf_counter()
    occ = list(PARTIAL_OCC)
    field = load_field(CKPT, device="cuda")
    body128 = BodyModel(device="cuda")
    body = BodyModel(model=synthetic_model(num_vertices=SMPL_VERTICES), device="cuda")
    ref = np.load(PARTIAL_EXPECTED)
    log(f"partial completion and image fitting: {CKPT}, bodies of 128 and {SMPL_VERTICES} "
        f"vertices (Jtr {tuple(body(pose_body=np.zeros((1, 69))).Jtr.shape[1:])})")

    # ---- against the JAX package, on the golden's 128-vertex body ----
    for mode in ("anchor", "inpaint"):
        comp = partial.PartialCompleter(field, body128,
                                        specs=partial.INPAINT_SPECS if mode == "inpaint" else None)
        init = body128(pose_body=ref["pose"])
        aux = {"betas": init.betas, "init_joints": init.Jtr[None],
               "data_joint_mask": torch.from_numpy(partial.observation_mask(body128, occ)).cuda()}
        if mode == "inpaint":
            aux["param_mask"] = torch.from_numpy(partial.dof_mask(occ)).cuda().expand(60, 69)[None]
        pose, hist = comp._solve(init.body_pose[None], aux, 2, 5)
        bar = max(SOLVE_POSE_ATOL, 2 * float(ref[f"{mode}_ulp_spread"]))
        assert_close(f"2 x 5 {mode} solve of 60 frames: pose vs JAX (atol: 5e-5 or twice JAX's "
                     f"one-ulp spread)", pose[0], torch.from_numpy(ref[f"{mode}_pose"]), atol=bar)
        for k, v in hist.items():
            assert_close(f"2 x 5 {mode} solve: {k} history vs JAX", v[:, 0],
                         torch.from_numpy(ref[f"{mode}_hist_{k}"]), rtol=SOLVE_HIST_RTOL,
                         atol=1e-7)
    clean, bad, corpus = make_inputs()
    w, _ = partial.retrieval_weights(occ)
    d, idx = fused_knn.fused_geodesic_topk(torch.from_numpy(bad).cuda(),
                                           torch.from_numpy(corpus).cuda(), K, weights=w)
    if not np.array_equal(idx.cpu().numpy(), ref["retrieval_idx"]):
        raise AssertionError("the golden retrieval's neighbours differ from JAX's")
    assert_close("the golden retrieval's distances vs JAX", d,
                 torch.from_numpy(ref["retrieval_dist"]), atol=KNN_ATOL)
    done = partial.complete_by_retrieval(torch.from_numpy(corpus).cuda(), bad, occ, k=K,
                                         temporal_window=WINDOW)
    assert_close("the golden complete_by_retrieval vs JAX", torch.from_numpy(done),
                 torch.from_numpy(ref["retrieval_out"]), atol=KNN_ATOL)

    class GoldenDraw(fit_image.ImageFitter):
        def _stage2_pose(self, B):
            return torch.from_numpy(ref["stage2_draw"][:B]).cuda()

    got, got_m = GoldenDraw(field, body128).optimize(ref["keypoints"], iterations=2,
                                                     steps_per_iter=5, center=ref["center"])
    for k, v in got.items():
        assert_close(f"2 x 5 fit: {k} vs JAX", v, torch.from_numpy(ref[f"fit_{k}"]),
                     atol=FIT_POSE_ATOL)
    for k, want in zip(FIT_METRICS, ref["fit_metrics"]):
        assert_close(f"2 x 5 fit: {k} vs JAX", torch.tensor([got_m[k]]), torch.tensor([want]),
                     rtol=1e-4, atol=1e-12)

    # ---- the zero-weight search: 120 frames x 1,048,576 poses ----
    family = manifold_family(np.random.default_rng(GRID_FAMILY_SEED), 21,
                             latents=GRID_LATENTS, freq_range=GRID_FREQ)
    t0 = time.perf_counter()
    corpus = manifold_corpus_cuda(family, PARTIAL_CORPUS, SEED + 19)
    torch.cuda.synchronize()
    from posendf_torch.data.synthetic import _poses_from_latents

    z = np.random.default_rng(SEED + 19).uniform(0, 2 * np.pi, size=(4096, GRID_LATENTS))
    assert_close("the corpus made on the card vs data/synthetic.py's formula, 4,096 rows",
                 corpus[:4096], torch.from_numpy(_poses_from_latents(family, z)), atol=1e-6)
    rng = np.random.default_rng(SEED + 20)
    clean = synthetic_motion_sequence(rng, PARTIAL_FRAMES, family=family)
    bad = clean.copy()
    bad[:, occ] += 0.5 * rng.standard_normal((PARTIAL_FRAMES, len(occ), 4)).astype(np.float32)
    bad[:, occ] /= np.linalg.norm(bad[:, occ], axis=-1, keepdims=True)
    q = torch.from_numpy(bad).cuda()
    log(f"  corpus of {PARTIAL_CORPUS} poses made on the card in "
        f"{time.perf_counter() - t0:.3f} s; a {PARTIAL_FRAMES}-frame clip, joints {occ} "
        f"corrupted; weights 0 there and 1 elsewhere over their norm (W = {float(w.sum()):.6f})")
    w_sum = float(w.sum())
    for engine in ("vpu", "mxu_bf16", "mxu_fast"):
        d_k, i_k = fused_knn.fused_geodesic_topk(q, corpus, PARTIAL_K, weights=w, dot_impl=engine)
        qf, cf, wj, wt = fused_knn.kernel_operands(q, corpus, w, engine)
        d_p, i_p = fused_knn.knn_topk_ref(qf, cf, PARTIAL_K, weights=wj, w_total=wt,
                                          dot_impl=engine)
        # the exact and bf16 engines: the plain arithmetic's bits, so every index
        name = f"zero-weight search ({engine}) vs knn_topk_ref, {PARTIAL_FRAMES} x {PARTIAL_CORPUS}"
        err = check_topk(name, d_k, i_k, d_p, i_p,
                         BOUND_ATOL if engine == "mxu_fast" else KNN_ATOL * w_sum,
                         exact_idx=engine != "mxu_fast")
        log(f"  ok {name}: max |err| {err:.3e}, indices equal"
            + (" where the ranks are apart" if engine == "mxu_fast" else ""))
    d_k, i_k = fused_knn.fused_geodesic_topk(q, corpus, PARTIAL_K, weights=w)
    d_x, i_x = geodesic_topk(q, corpus, PARTIAL_K, weights=torch.from_numpy(w).cuda())
    if not torch.equal(torch.sort(i_k, 1)[0], torch.sort(i_x, 1)[0]):
        raise AssertionError("the zero-weight search's index sets differ from geodesic_topk's")
    assert_close("zero-weight search distances vs ops/knn.geodesic_topk", d_k, d_x, atol=1e-6)

    # ---- main path, retrieval: complete_by_retrieval through the kernel ----
    fused_knn.LAUNCHES = dict.fromkeys(fused_knn.ENGINES, 0)
    done = partial.complete_by_retrieval(corpus, bad, occ, k=PARTIAL_K)
    torch.cuda.synchronize()
    knn_launches = dict(fused_knn.LAUNCHES)
    log(f"main path, retrieval: complete_by_retrieval of {PARTIAL_FRAMES} frames against "
        f"{PARTIAL_CORPUS} poses, kNN launches {knn_launches}")
    if knn_launches["vpu"] <= 0:
        raise AssertionError("the retrieval launched no kNN kernel")
    vis = [j for j in range(21) if j not in occ]
    if not np.array_equal(done[:, vis], bad[:, vis]):
        raise AssertionError("the retrieval changed a visible joint")

    def occ_err(x):
        return float(np.mean(1.0 - np.abs(np.sum(x[:, occ] * clean[:, occ], -1))))

    log(f"  occluded-joint geodesic error {occ_err(bad):.5f} -> {occ_err(done):.5f}; visible "
        f"joints to the bit")
    if not occ_err(done) < occ_err(bad):
        raise AssertionError("the retrieval did not lower the occluded-joint error")
    search_ms = cuda_ms(lambda: fused_knn.fused_geodesic_topk(q, corpus, PARTIAL_K, weights=w), 10)
    qf, cf, wj, wt = fused_knn.kernel_operands(q, corpus, w, "vpu")
    plain_ms = cuda_ms(lambda: fused_knn.knn_topk_ref(qf, cf, PARTIAL_K, weights=wj, w_total=wt),
                       1, warm=False)
    complete_ms = cuda_ms(lambda: partial.complete_by_retrieval(corpus, bad, occ, k=PARTIAL_K),
                          10)
    log(f"time retrieval search, {PARTIAL_FRAMES} x {PARTIAL_CORPUS}, k = {PARTIAL_K} (pack + "
        f"top-k + merge): {search_ms:.4f} ms (mean of 10 after one), its plain version "
        f"knn_topk_ref {plain_ms:.4f} ms (one call); the whole complete_by_retrieval "
        f"{complete_ms:.4f} ms  [{card}]")

    # ---- the anchor and inpaint solves: one 120-frame clip, 10 x 10 steps ----
    pose = np.zeros((PARTIAL_FRAMES, 69), np.float32)
    pose[:, :63] = quaternion_to_axis_angle(torch.from_numpy(bad)).reshape(-1, 63).numpy()
    cfg = PoseNDFConfig()
    cfg.strenc.fused = True
    fused_field = load_field(CKPT, config=cfg, device="cuda")
    occ_dofs = partial.dof_mask(occ).astype(bool)
    solves, step_ms, enc_launches = {}, {}, 0
    for mode in ("anchor", "inpaint"):
        specs = partial.INPAINT_SPECS if mode == "inpaint" else None
        for path, f in (("module path", field), ("fused encoder", fused_field)):
            comp = partial.PartialCompleter(f, body, specs=specs)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            fused_encoder.LAUNCHES = 0
            start.record()
            out, m = comp.optimize(pose, occluded_joints=occ, mode=mode)
            end.record()
            end.synchronize()
            if path == "fused encoder":
                log(f"  {mode}, fused encoder: posendf_encoder launched {fused_encoder.LAUNCHES} "
                    f"times in 100 steps")
                if fused_encoder.LAUNCHES < 100:
                    raise AssertionError(f"{mode}: posendf_encoder launched "
                                         f"{fused_encoder.LAUNCHES} times in a 100-step solve")
                enc_launches += fused_encoder.LAUNCHES
            step_ms[(mode, path)] = start.elapsed_time(end) / 100
            if not bool(torch.isfinite(out).all()) or not all(np.isfinite(list(m.values()))):
                raise AssertionError(f"{mode} solve, {path}: non-finite pose or metrics {m}")
            if mode == "inpaint" and not np.array_equal(out.cpu().numpy()[:, ~occ_dofs],
                                                        pose[:, ~occ_dofs]):
                raise AssertionError(f"inpaint, {path}: an observed dof moved")
            solves[(mode, path)] = (out, m)
        log(f"  ok {mode}: 10 x 10 steps of {PARTIAL_FRAMES} frames on both paths, finite"
            + ("; every observed dof kept its input's bits" if mode == "inpaint" else ""))
        assert_close(f"{mode}, 100 steps: fused encoder vs module path, pose",
                     solves[(mode, "fused encoder")][0], solves[(mode, "module path")][0],
                     atol=LONG_SOLVE_POSE_ATOL)
        for k in ("final_pose_pr", "final_temp"):
            assert_close(f"{mode}, 100 steps: fused encoder vs module path, {k}",
                         torch.tensor([solves[(mode, "fused encoder")][1][k]]),
                         torch.tensor([solves[(mode, "module path")][1][k]]),
                         rtol=LONG_SOLVE_TERM_RTOL, atol=1e-6)
    for (mode, path), ms in step_ms.items():
        log(f"time partial solve, {mode}, {path}: {ms:.4f} ms a step (a 10 x 10-step solve of "
            f"{PARTIAL_FRAMES} frames at {SMPL_VERTICES} vertices, its metrics included; CUDA "
            f"events around the call)  [{card}]")

    # ---- the fitter: B = 1 and 8 keypoint sets, 10 x 10 steps a stage ----
    class TimedFitter(fit_image.ImageFitter):
        """Times each stage's solve (CUDA events around the call)."""

        def _get_solvers(self, B, iterations, steps_per_iter):
            def timed(i, solve):
                def run(p, aux):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = solve(p, aux)
                    end.record()
                    end.synchronize()
                    self.stage_ms[i] = start.elapsed_time(end)
                    return out
                return run

            self.stage_ms = {}
            return tuple(timed(i, f) for i, f in
                         enumerate(super()._get_solvers(B, iterations, steps_per_iter), 1))

    frames = np.linspace(0, PARTIAL_FRAMES - 1, 8).astype(int)
    gt_pose = np.zeros((8, 69), np.float32)
    gt_pose[:, :63] = quaternion_to_axis_angle(
        torch.from_numpy(clean[frames])).reshape(8, 63).numpy()
    cam = {"rotation": axis_angle_to_matrix(
        torch.tensor([FIT_ROT], device="cuda")).repeat(8, 1, 1),
           "translation": torch.tensor([[0.0, 0.0, 10.0]], device="cuda").repeat(8, 1)}
    center = torch.tensor([[512.0, 384.0]], device="cuda").repeat(8, 1)
    fitter = TimedFitter(field, body)
    with torch.no_grad():
        jtr = body(pose_body=gt_pose).Jtr
        xy = camera.project_points(cam, fitter._mapped_joints(jtr), 5000.0, center)
    keypoints = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1).cpu().numpy()
    for B in (1, 8):
        result, m = fitter.optimize(keypoints[:B], center=center[0].cpu().numpy())
        with torch.no_grad():
            start_err = float(fitter._stage1_terms(
                {"translation": torch.tensor([[0.0, 0.0, 10.0]], device="cuda").repeat(B, 1),
                 "global_orient": torch.zeros((B, 3), device="cuda"),
                 "cam_rot": torch.zeros((B, 3), device="cuda")},
                {"center": center[:B], "gt_xy": torch.from_numpy(keypoints[:B, :, :2]).cuda()}
            )["data"])
        for k, v in result.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"fit, B = {B}: non-finite {k}")
        if not m["stage1_final_data"] < start_err:
            raise AssertionError(f"fit, B = {B}: stage 1's torso error {m['stage1_final_data']} "
                                 f"not below its start {start_err}")
        rot_err = float((result["camera_rotation"] - cam["rotation"][:B]).abs().max())
        log(f"  ok fit, B = {B}, 10 x 10 steps a stage, the 45-joint table: stage 1's torso "
            f"error {start_err:.3f} -> {m['stage1_final_data']:.6f} px^2, the camera's rotation "
            f"{rot_err:.3e} from the true one; metrics "
            + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
        log(f"time fit, B = {B}: stages " + ", ".join(
            f"{i} {ms:.3f} ms ({ms / 100:.4f} ms a step)" for i, ms in fitter.stage_ms.items())
            + f"  [{card}]")

    # ---- the examples, as a user runs them ----
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in (("torch_end_to_end.py", ["--epochs", "2", "--workdir", tmp]),
                           ("torch_serving.py", ["--ckpt", CKPT, "--int8"])):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, os.path.join("examples", name), *argv],
                                 capture_output=True, text=True, timeout=300)
            lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
            for ln in lines[-8:]:
                log(f"    {name}: {ln}")
            if run.returncode != 0:
                log(run.stderr[-3000:])
                raise AssertionError(f"examples/{name} exited {run.returncode}")
            log(f"  ok examples/{name} {' '.join(argv[:2])}: exit 0 in "
                f"{time.perf_counter() - t0:.1f} s")
    log(f"partial phase: {time.perf_counter() - t_phase:.1f} s")
    return {"vpu": knn_launches["vpu"], "enc": enc_launches}


P20_STEPS, P20_QUERIES, P20_LR, P20_PROJ_STEPS = 3, 10_000, 1e-4, 20
P20_COUNTS = ("proj", "tile", "reduce", "vpu", "enc")


def p20_counts(reset: bool = False) -> dict:
    """The launch counts of rows 3-6 (set to 0 first with ``reset``)."""
    from posendf_torch.ops import fused_encoder, fused_grad, fused_knn, fused_train

    if reset:
        fused_grad.PROJ_LAUNCHES = fused_train.TILE_LAUNCHES = fused_train.REDUCE_LAUNCHES = 0
        fused_encoder.LAUNCHES = 0
        fused_knn.LAUNCHES["vpu"] = 0
    return {"proj": fused_grad.PROJ_LAUNCHES, "tile": fused_train.TILE_LAUNCHES,
            "reduce": fused_train.REDUCE_LAUNCHES, "vpu": fused_knn.LAUNCHES["vpu"],
            "enc": fused_encoder.LAUNCHES}


def p20_corpus() -> torch.Tensor:
    """The 1,048,576-pose corpus of the L8 field's manifold, made on the card."""
    from posendf_torch.data.synthetic import manifold_family

    family = manifold_family(np.random.default_rng(GRID_FAMILY_SEED), 21, latents=GRID_LATENTS,
                             freq_range=GRID_FREQ)
    return manifold_corpus_cuda(family, PARTIAL_CORPUS, SEED + 20)


def p20_paths(mesh, corpus: torch.Tensor):
    """The four paths of phase 20 on ``mesh`` (None: unsharded): (results
    on the host, milliseconds of each call by CUDA events)."""
    from posendf_torch import load_field, project
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.data.prepare import label_sequence
    from posendf_torch.experiments.denoise import MotionDenoiser
    from posendf_torch.parallel import gather_rows, shard_batch
    from posendf_torch.projection import random_poses
    from posendf_torch.smpl import BodyModel, synthetic_model
    from posendf_torch.training.trainer import make_optimizer, make_train_step

    res, ms = {}, {}

    def timed(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        ms[name] = start.elapsed_time(end)
        return out

    # fused data-parallel train steps on the trained field
    module = load_field(CKPT, device="cuda").module
    step = make_train_step(module, make_optimizer(module.parameters(), P20_LR), loss_type="l1",
                           weights={"dist": 1.0, "man_loss": 1.0, "eikonal": 1.0}, fused=True,
                           mesh=mesh)
    metrics = []
    for i in range(P20_STEPS):
        b = {k: torch.from_numpy(v).cuda() for k, v in
             zip(("pose", "dist", "man_poses"), golden_inputs(SEED + 20 + i, TRAIN_FILES * TRAIN_PTS))}
        m = timed(f"train step {i}", lambda: step(b))
        metrics.append(torch.stack([m[k] for k in ("total", "dist", "man_loss", "eikonal")]))
        if i == 0:
            res["grads0"] = {n: p.grad.detach().cpu().clone() for n, p in module.named_parameters()}
    res["train_metrics"] = torch.stack(metrics).cpu()
    res["params"] = {n: p.detach().cpu().clone() for n, p in module.named_parameters()}
    # queries sharded against the corpus on the card
    clean = corpus[:256].cpu().numpy()
    lab = timed("labelling", lambda: label_sequence(
        clean, corpus, num_queries=P20_QUERIES, k=KNN_K, rng=np.random.default_rng(SEED),
        mesh=mesh))
    res.update(label_pose=lab["pose"], label_dist=lab["dist"], label_nn=lab["nn_pose"])
    # the frame-sharded denoise at SMPL's 6,890 vertices (the halo moves a
    # frame of them), the encoder kernel on the solve's path
    cfg = PoseNDFConfig()
    cfg.strenc.fused = True
    body = BodyModel(model=synthetic_model(num_vertices=SMPL_VERTICES), device="cuda")
    den = MotionDenoiser(load_field(CKPT, config=cfg, device="cuda"), body)
    noisy = np.load(DENOISE_EXPECTED)["noisy"]
    pose, m = timed("denoise", lambda: den.optimize(noisy, iterations=2, steps_per_iter=5,
                                                    mesh=mesh))
    res["den_pose"], res["den_metrics"] = pose.cpu(), m
    # each rank's share of the poses through the projection-step kernel
    field = load_field(CKPT, device="cuda")
    poses = random_poses(torch.Generator().manual_seed(SEED + 20), MAIN_BATCH, device="cuda")
    mine = shard_batch(mesh, poses, even=True)
    out, hist = timed("projection", lambda: project(field, mine, steps=P20_PROJ_STEPS,
                                                    fused=True))
    res["proj_out"] = gather_rows(mesh, out).cpu()
    res["proj_hist"] = gather_rows(mesh, hist.T.contiguous()).T.cpu()
    return res, ms


def p20_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One of phase 20 (b)'s gloo ranks on the one card: the paths, its
    results (rank 0) and its launch counts saved to ``out_dir``."""
    from posendf_torch.parallel import init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                     device="cuda", backend="gloo", timeout_s=300)
    mesh = make_mesh(("data",), device="cuda")
    corpus = p20_corpus()
    p20_paths(mesh, corpus)   # warm-up: the libraries' loads, gloo's connections
    p20_counts(reset=True)
    res, ms = p20_paths(mesh, corpus)
    torch.cuda.synchronize()
    res["counts"], res["ms"] = p20_counts(), ms
    torch.save(res if rank == 0 else {"counts": res["counts"], "ms": ms},
               os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multidevice_phase(card: str) -> dict:
    """Phase 20, multi-device execution (see the module docstring). Returns
    the launches of rows 3-6 it made, by ``P20_COUNTS``. Raises on any
    failure."""
    import tempfile

    import torch.multiprocessing as mp

    from posendf_torch.parallel import all_reduce_sum, init_distributed, make_mesh

    t_phase = time.perf_counter()
    corpus = p20_corpus()
    total = dict.fromkeys(P20_COUNTS, 0)

    # ---- (a) NCCL, a group of one rank on the card ----
    want, _ = p20_paths(None, corpus)           # also the warm-up of every path
    init_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                     device="cuda")
    mesh = make_mesh(("data",), device="cuda")
    log(f"multi-device (a): {mesh.backend} group of {mesh.size} rank on {mesh.device}")
    all_reduce_sum(mesh, torch.ones(1, device="cuda"))   # the communicator's set-up
    p20_counts(reset=True)
    got, ms = p20_paths(mesh, corpus)
    torch.cuda.synchronize()
    counts = p20_counts()
    torch.distributed.destroy_process_group()
    again, plain_ms = p20_paths(None, corpus)   # timed after the sharded run
    for k in ("train_metrics", "label_dist", "den_pose", "proj_out"):
        if not torch.equal(torch.as_tensor(np.asarray(again[k])),
                           torch.as_tensor(np.asarray(want[k]))):
            raise AssertionError(f"two unsharded runs differ in {k}")
    log(f"  launches of the sharded paths {counts}")
    for k, n in counts.items():
        if n <= 0:
            raise AssertionError(f"the sharded paths launched no {k} kernel")
        total[k] += n
    for k in ("train_metrics", "label_dist", "label_pose", "label_nn", "den_pose", "proj_out",
              "proj_hist"):
        a, b = (torch.as_tensor(np.asarray(got[k])), torch.as_tensor(np.asarray(want[k])))
        if not torch.equal(a, b):
            raise AssertionError(f"one-rank NCCL {k} is not the unsharded one: max |err| "
                                 f"{max_err(a.double(), b.double()):.3e}")
    for part in ("grads0", "params"):
        for n, v in want[part].items():
            if not torch.equal(got[part][n], v):
                raise AssertionError(f"one-rank NCCL {part} {n} is not the unsharded one")
    if got["den_metrics"] != want["den_metrics"]:
        raise AssertionError(f"one-rank NCCL denoise metrics {got['den_metrics']} != "
                             f"{want['den_metrics']}")
    log("  ok one rank on NCCL: train metrics, gradient and weights, labels, denoise pose and "
        "metrics, projection, each the unsharded run's to the bit")
    for name in ms:
        log(f"  time {name}: sharded (one NCCL rank) {ms[name]:.3f} ms, unsharded "
            f"{plain_ms[name]:.3f} ms (one call each after a warm-up run, CUDA events)  "
            f"[{card}]")
    t0 = time.perf_counter()
    run = subprocess.run(["torchrun", "--standalone", "--nproc-per-node", "1",
                          os.path.join("examples", "torch_multichip.py"), "--epochs", "5"],
                         capture_output=True, text=True, timeout=400)
    for ln in [x for x in run.stdout.splitlines() if x.strip()][-8:]:
        log(f"    torch_multichip.py: {ln}")
    if run.returncode != 0 or "== done" not in run.stdout:
        log(run.stderr[-3000:])
        raise AssertionError(f"examples/torch_multichip.py under torchrun exited "
                             f"{run.returncode}")
    fall = re.search(r"mean distance ([0-9.eE+-]+) -> ([0-9.eE+-]+)", run.stdout)
    if fall is None or not float(fall.group(2)) < float(fall.group(1)):
        raise AssertionError("examples/torch_multichip.py: stage 4's projection did not lower "
                             "the mean distance")
    log(f"  ok torchrun --standalone --nproc-per-node 1 examples/torch_multichip.py: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- (b) two gloo ranks on the one card ----
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(p20_rank, args=(2, free_port(), tmp), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 600
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError("phase 20's two gloo ranks did not finish in 600 s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    log(f"multi-device (b): two gloo ranks on one card, {time.perf_counter() - t0:.1f} s with "
        f"their start")
    got = ranks[0]
    for r in ranks:
        log(f"  rank launches {r['counts']}")
        for k, n in r["counts"].items():
            if n <= 0:
                raise AssertionError(f"a gloo rank launched no {k} kernel")
            total[k] += n
    for name in got["ms"]:
        log(f"  time {name}: two gloo ranks {got['ms'][name]:.3f} / {ranks[1]['ms'][name]:.3f} ms, "
            f"one NCCL rank {ms[name]:.3f} ms (one call each after a warm-up run, CUDA "
            f"events)  [{card}]")
    for k in ("label_pose", "label_dist", "label_nn"):
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"two gloo ranks: {k} is not the one-rank labelling")
    log(f"  ok two ranks: {len(got['label_pose'])} labels to the bit")
    assert_close("two ranks: train step losses", got["train_metrics"], want["train_metrics"],
                 rtol=TERM_RTOL, atol=0.0)
    assert_leaves("two ranks: first step's gradient", got["grads0"], want["grads0"])
    worst = 0.0
    for n, v in want["params"].items():
        err = (got["params"][n] - v).abs()
        worst = max(worst, float(err.max()))
        if float(err.max()) > 2 * P20_STEPS * P20_LR or float((err <= P20_LR / 20).float().mean()) < 0.99:
            raise AssertionError(f"two ranks: weights {n} after {P20_STEPS} steps: max |err| "
                                 f"{float(err.max()):.3e}")
    log(f"  ok two ranks: weights after {P20_STEPS} steps, largest difference {worst:.3e} "
        f"(lr {P20_LR})")
    assert_close("two ranks: 2 x 5 denoise pose", got["den_pose"], want["den_pose"],
                 atol=SOLVE_POSE_ATOL)
    for k, v in want["den_metrics"].items():
        assert_close(f"two ranks: denoise {k}", torch.tensor([got["den_metrics"][k]]),
                     torch.tensor([v]), rtol=SOLVE_HIST_RTOL, atol=1e-7)
    assert_close("two ranks: projection", got["proj_out"], want["proj_out"], rtol=PROJ_RTOL,
                 atol=PROJ_ATOL)
    assert_close("two ranks: projection history", got["proj_hist"], want["proj_hist"],
                 atol=D_ATOL)
    log(f"multi-device phase: {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


QUALITY_EXPECTED = "tests/data/torch_port_quality_expected.npz"
Q21_STEPS = 1000     # phase 21 (a): steps of the run of record's recipe (qg.RUN_OF_RECORD)
Q21_CHECK_STEPS = 10                 # fused vs autodiff steps from the same weights and batches
Q21_KINK_NEAR = 3e-6     # a row this near a kink (x its sum's scale) is left out on every side
Q21_FIELD_RTOL, Q21_FIELD_ATOL = 1e-4, 1e-5   # (b): the MAE (relative); corr and means (absolute)
Q21_INPUT_RTOL = 1e-5                # (b): a row's input v2v and prior at input
Q21_DEPTHS = {"partial": {"anchor": (2, 5), "inpaint": (2, 5)}, "fit": (5, 5)}   # (c)


def load_script(name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join("scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def q21_counts(reset: bool = False) -> dict:
    """The launch counts of rows 1, 5 and 6 (set to 0 first with ``reset``)."""
    from posendf_torch.ops import fused_knn, fused_model, fused_train

    if reset:
        fused_model.LAUNCHES = fused_train.TILE_LAUNCHES = fused_train.REDUCE_LAUNCHES = 0
        fused_knn.LAUNCHES["vpu"] = 0
    return {"fwd": fused_model.LAUNCHES, "tile": fused_train.TILE_LAUNCHES,
            "reduce": fused_train.REDUCE_LAUNCHES, "vpu": fused_knn.LAUNCHES["vpu"]}


def check_keys(name: str, got: dict, want: dict, extra=()) -> None:
    """``got``'s keys are ``want``'s (a JAX record's) and ``extra``."""
    if set(got) != set(want) | set(extra):
        raise AssertionError(f"{name}: keys {sorted(set(got) ^ set(want))} differ from the JAX "
                             "record's")


def check_finite(name: str, tree) -> None:
    vals = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, (float, np.floating)):
            vals.append(float(x))

    walk(tree)
    if not np.isfinite(vals).all():
        raise AssertionError(f"{name}: a non-finite value")


def q21_forward(w, q: torch.Tensor, normalize: bool):
    """The DFNet's forward in ``w``'s dtype: each group's pre-activations z
    (the encoder's hidden and feature units joint by joint, then each
    layer's) and the scale |x| @ |W| + |b| that the rounding of its sum
    grows with."""
    act = torch.relu if w.activation == "relu" else (lambda z: torch.where(z >= 0, z, 0.01 * z))
    R, J, F = q.shape[0], w.num_joints, w.feature_size
    zs, ss = [], []

    def unit(x, wt, b):
        zs.append(x @ wt + b)
        ss.append(x.abs() @ wt.abs() + b.abs())
        return act(zs[-1])

    # the reference's joint-axis normalization (over dim 1, as ``fused_train.branch_ref``)
    x = q / torch.sqrt(torch.clamp_min((q * q).sum(1, keepdim=True), 1e-24)) if normalize else q
    feat = [None] * J
    for j in range(J):
        p = w.parents[j]
        inp = torch.cat([x[:, j], q.new_zeros((R, F)) if p < 0 else feat[p]], dim=-1)
        h = unit(inp, w.enc["w1"][j], w.enc["b1"][j])
        feat[j] = unit(h, w.enc["w2"][j], w.enc["b2"][j])
    x = torch.cat(feat, dim=-1)
    for wl, bl in w.layers:
        x = unit(x, wl, bl)
    return zs, ss


def q21_margin(zs, ss, gt=None) -> torch.Tensor:
    """Each row's nearest kink relative to its sum's scale: the smallest
    |z| / scale over the units (the last is the head's ReLU) and, with
    labels ``gt``, the L1 residual |relu(z) - gt| / (the head's scale + |gt|)."""
    m = torch.stack([(z.abs() / s.clamp_min(1e-300)).amin(1) for z, s in zip(zs, ss)]).amin(0)
    if gt is not None:
        r = torch.relu(zs[-1][:, 0]) - gt
        m = torch.minimum(m, r.abs() / (ss[-1][:, 0] + gt.abs()))
    return m


def q21_reduce64(w, noisy, man) -> dict:
    """What the reduction computes, in float64 from the tile kernel's own
    outputs (its scratch rows, cotangents and per-CTA encoder slots)."""
    rows_n = noisy.branch_rows(w)
    rows_m = dataclasses.replace(man, eikonal=True).branch_rows(w)   # the raw x_l
    ddn, ddm = noisy.dd.double(), man.dd.double()
    flat = noisy.enc_slot.double().sum(0) + man.enc_slot.double().sum(0)
    grads, off = {}, 0
    for k in ("w1", "b1", "w2", "b2"):
        n = w.enc[k].numel()
        grads[f"enc.{k}"] = flat[off:off + n].view(w.enc[k].shape)
        off += n
    for l in range(len(w.layers)):
        cn, cm = rows_n.c[l].double(), rows_m.c[l].double()
        grads[f"dfnet.w{l}"] = (rows_n.a[l].double().T @ cn
                                + (ddm[:, None] * rows_m.a[l].double()).T @ cm)
        grads[f"dfnet.b{l}"] = ddn @ cn + ddm @ cm
    return grads


def leaf_errs(got: dict, ref: dict) -> dict:
    """Each leaf's largest error relative to its max |value| in ``ref``."""
    return {k: float((got[k].double() - r).abs().max() / r.abs().max().clamp_min(1e-300))
            for k, r in ref.items()}


def q21_grad_check(module, data, cfg, args, sz, card, tau: float = Q21_KINK_NEAR,
                   steps: int = Q21_CHECK_STEPS, strict: bool = True) -> dict:
    """Phase 21 (a)'s check: ``steps`` fused steps, each against autodiff at
    the same weights and batch, the rows near a kink left out (docstring).
    Returns the worst readings; raises (with ``strict``) on a failure."""
    from posendf_torch.losses import training_loss
    from posendf_torch.ops import fused_train
    from posendf_torch.ops.fused_model import FieldWeights, aligned_contiguous
    from posendf_torch.training.trainer import make_optimizer, make_train_step

    qg = load_script("torch_quality_grid")
    dev = data["q_pose"].device
    checked = copy.deepcopy(module)
    kw = dict(loss_type=cfg.train.loss_type, weight_dist=1.0, weight_man=1.0,
              weight_eikonal=args.w_eikonal)
    step = make_train_step(checked, make_optimizer(checked.parameters(), sz["LR"],
                                                   cfg.train.weight_decay),
                           loss_type=kw["loss_type"],
                           weights={"dist": 1.0, "man_loss": 1.0, "eikonal": args.w_eikonal},
                           fused=True)
    gen = qg.make_generator(SEED, 99, dev)
    names = [n for n, _ in checked.named_parameters()]
    relu = checked.activation == "relu"

    def autodiff(m, b):
        loss, terms = training_loss(m, b["pose"], b["dist"], b["man_poses"], **kw)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        return dict(terms, total=loss), dict(zip(names, grads))

    def tiles(w, b):
        kw_n, kw_m = fused_train.branch_args(w, b["pose"], b["dist"], b["man_poses"], **kw)
        return fused_train.launch_tiles(w, aligned_contiguous(b["pose"]), b["dist"],
                                        aligned_contiguous(b["man_poses"]), kw_n, kw_m)

    def pos(z):
        return z > 0 if relu else z >= 0

    def flips(w, b, noisy, man, z_n, z_m, gt64):
        """Rows where the tile kernel took an observable kink on the other side
        than float64: the L1 residual's sign (its dd), the head's ReLU (c of
        the head on the noisy rows, dd on the manifold rows) and, on the
        manifold rows, whose scratch keeps x_l = act(z_{l-1}), every DFNet
        hidden unit."""
        rows_m = dataclasses.replace(man, eikonal=True).branch_rows(w)
        rows_n = noisy.branch_rows(w)
        L = len(w.layers)
        r64 = torch.relu(z_n[-1][:, 0]) - gt64
        f = {"l1": (noisy.dd > 0) != (r64 > 0),
             "head": torch.cat([(rows_n.c[L - 1][:, 0] > 0) != (z_n[-1][:, 0] > 0),
                                (man.dd != 0) != (z_m[-1][:, 0] > 0)]),
             "units": torch.zeros(man.rows, dtype=torch.bool, device=dev)}
        for l in range(1, L):
            z64 = z_m[len(z_m) - L + l - 1]
            f["units"] |= (pos(rows_m.a[l]) != pos(z64)).any(1)
        return {k: int(v.sum()) for k, v in f.items()}

    worst = {"fused_vs_fp32": 0.0, "fused": 0.0, "fp32": 0.0, "tile": 0.0, "reduce": 0.0,
             "dropped": 0, "flips_full": {"l1": 0, "head": 0, "units": 0}, "err_s": 0.0,
             "err_s_fp32": 0.0}
    for i in range(steps):
        idx = torch.randint(0, sz["Q"], (sz["BATCH"],), generator=gen, device=dev)
        midx = torch.randint(0, sz["N"], (sz["BATCH"],), generator=gen, device=dev)
        b = {"pose": data["q_pose"][idx], "dist": data["q_dist"][idx],
             "man_poses": data["corpus"][midx]}
        m64 = copy.deepcopy(checked).double()
        with torch.no_grad():
            w64, w = FieldWeights.from_module(m64), FieldWeights.from_module(checked)
            gt64 = b["dist"].double()
            z_n, s_n = q21_forward(w64, b["pose"].double(), True)
            z_m, s_m = q21_forward(w64, b["man_poses"].double(), False)
            keep_n = q21_margin(z_n, s_n, gt64) >= tau
            keep_m = q21_margin(z_m, s_m) >= tau
            # the whole batch: the kinks the kernel took on the other side, and how far its
            # and fp32 torch.matmul's hidden pre-activations (manifold rows) sit from float64
            noisy, man = tiles(w, b)
            full = flips(w, b, noisy, man, z_n, z_m, gt64)
            L = len(w.layers)
            rows_m = dataclasses.replace(man, eikonal=True).branch_rows(w)
            z32, _ = q21_forward(w, b["man_poses"], False)
            err_k = err_a = 0.0
            for l in range(1, L):
                j = len(z_m) - L + l - 1
                x = rows_m.a[l].double()
                zk = torch.where(x >= 0, x, 100.0 * x) if not relu else x
                live = zk > 0 if relu else torch.ones_like(zk, dtype=torch.bool)
                err_k = max(err_k, float(((zk - z_m[j]).abs() / s_m[j])[live].max()))
                err_a = max(err_a, float(((z32[j].double() - z_m[j]).abs() / s_m[j]).max()))
            del noisy, man, rows_m, z32, z_n, s_n, z_m, s_m
        kept = {"pose": b["pose"][keep_n], "dist": b["dist"][keep_n],
                "man_poses": b["man_poses"][keep_m]}
        _, want64 = autodiff(m64, {k: v.double() for k, v in kept.items()})
        want_terms, want = autodiff(checked, kept)
        with torch.no_grad():
            z_n, _ = q21_forward(w64, kept["pose"].double(), True)
            z_m, _ = q21_forward(w64, kept["man_poses"].double(), False)
            noisy, man = tiles(w, kept)
            left = flips(w, kept, noisy, man, z_n, z_m, kept["dist"].double())
            red64 = q21_reduce64(w, noisy, man)
            del noisy, man, z_n, z_m
        got_terms = step(kept)   # the fused step: its terms and gradient at the same weights
        got = {n: p.grad for n, p in checked.named_parameters()}
        for k in got_terms:
            assert_close(f"quality (a) step {i}: fused {k} vs autodiff", got_terms[k],
                         want_terms[k].detach(), rtol=TERM_RTOL, atol=TERM_ROW_ATOL)
        e = {"fused_vs_fp32": leaf_errs(got, {k: v.double() for k, v in want.items()}),
             "fused": leaf_errs(got, want64), "fp32": leaf_errs(want, want64),
             "tile": leaf_errs(red64, want64), "reduce": leaf_errs(got, red64)}
        top = {k: max(v.items(), key=lambda kv: kv[1]) for k, v in e.items()}
        dropped = (sz["BATCH"] - len(kept["pose"]), sz["BATCH"] - len(kept["man_poses"]))
        log(f"  quality (a) step {i}: rows within {tau:g} of a kink left out: {dropped[0]} "
            f"noisy, {dropped[1]} manifold of {sz['BATCH']} each; in the whole batch the "
            f"kernel took kinks on the other side than float64 on {full} rows; hidden "
            f"pre-activations' largest |z - z64| / scale: kernel {err_k:.3e}, fp32 "
            f"torch.matmul {err_a:.3e}; kept rows' kinks on the other side: {left}")
        log("    largest leaf error x max|leaf|: " + ", ".join(
            f"{k} {v:.3e} ({n})" for k, (n, v) in top.items()))
        finite = all(bool(torch.isfinite(g).all()) for g in got.values())
        if strict and (not finite or any(left.values())
                       or top["fused_vs_fp32"][1] > LEAF_TOL):
            raise AssertionError(
                f"quality (a) step {i}: finite {finite}; kept rows' kinks on the other side "
                f"{left}; fused vs fp32 autodiff {top['fused_vs_fp32'][1]:.3e} x max|leaf| in "
                f"{top['fused_vs_fp32'][0]} (bar {LEAF_TOL})")
        for k, (_, v) in top.items():
            worst[k] = max(worst[k], v)
        worst["dropped"] = max(worst["dropped"], *dropped)
        worst["err_s"], worst["err_s_fp32"] = max(worst["err_s"], err_k), max(
            worst["err_s_fp32"], err_a)
        for k in full:
            worst["flips_full"][k] += full[k]
        del m64, w64, w, want64, want, want_terms, red64, got
    log(f"  ok {steps} fused steps of {sz['BATCH']} + {sz['BATCH']} less the rows within "
        f"{tau:g} of a kink (at most {worst['dropped']} a branch), each against autodiff at its "
        f"weights: terms within rtol {TERM_RTOL}, every leaf within {worst['fused_vs_fp32']:.3e} "
        f"x max|leaf| of fp32 autodiff (bar {LEAF_TOL}); from float64: fused "
        f"{worst['fused']:.3e}, fp32 autodiff {worst['fp32']:.3e}, of which the tile "
        f"{worst['tile']:.3e} and the reduction {worst['reduce']:.3e}; over the whole batches "
        f"the kernel took {worst['flips_full']} kinks on the other side than float64 "
        f"(hidden |z - z64| / scale up to {worst['err_s']:.3e}, fp32 torch.matmul "
        f"{worst['err_s_fp32']:.3e})  [{card}]")
    return worst


def quality_phase(card: str) -> dict:
    """Phase 21, the quality loops (rows 1, 5 and 6 on the drivers' paths).
    Returns the launches its paths add to the ``kernels`` line. Raises on
    any failure."""
    from posendf_torch.field import Field
    from posendf_torch.smpl import BodyModel

    t_phase = time.perf_counter()
    qg = load_script("torch_quality_grid")
    dev = torch.device("cuda")
    total = dict.fromkeys(("fwd", "tile", "reduce", "vpu"), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # ---- (a) training from random weights at the run of record's shapes ----
    args = qg.parse_args(qg.RUN_OF_RECORD + ["--steps", str(Q21_STEPS)])
    sz = qg.sizes(args)
    family = qg.gentle_family(123, *args.freq, args.latents)
    q21_counts(reset=True)
    t0 = time.perf_counter()
    data = qg.manufacture(args, family, sz["N"], sz["Q"], dev)
    torch.cuda.synchronize()
    label_s = time.perf_counter() - t0
    log(f"quality (a): labelled {sz['Q']} + {len(data['h_pose'])} queries against {sz['N']} "
        f"poses in {label_s:.3f} s (exact engine, host sampling included)  [{card}]")
    cfg, module = qg.build_module(args, dev)
    qg.init_params(args, module, data["q_pose"], data["q_dist"])
    field = Field(module)
    corr0 = qg.held_corr(qg.field_values(field, data["h_pose"], True), data["h_dist"])

    q21_grad_check(module, data, cfg, args, sz, card)
    add(q21_counts())

    q21_counts(reset=True)
    tr = qg.train(args, module, cfg, data, sz["STEPS"], sz["BATCH"], sz["LR"], True, True)
    torch.cuda.synchronize()
    train_counts = q21_counts()
    add(train_counts)
    traj = np.concatenate([np.stack([c[k] for k in sorted(c)], 1) for c in tr["chunks"]])
    if traj.shape != (sz["STEPS"], 4) or not np.isfinite(traj).all():
        raise AssertionError(f"quality (a): terms {traj.shape}, finite {np.isfinite(traj).all()}")
    first, last = float(tr["chunks"][0]["total"][0]), float(tr["chunks"][-1]["total"].mean())
    fq = qg.field_quality(field, data["h_pose"], data["h_dist"], data["corpus_np"], True)
    best = tr["best"]
    log(f"  {sz['STEPS']} fused steps in {tr['train_s']:.3f} s ({1e3 * tr['train_s'] / sz['STEPS']:.3f}"
        f" ms a step, the gate's two evaluations and the first chunk's builds included); total "
        f"{first:.5f} -> last chunk's mean {last:.5f}; held-out corr {corr0:.4f} at init -> best "
        f"{best['corr']:.4f} @ step {best['step']}, final {fq['corr']:.4f}, live "
        f"{fq['live_frac']:.4f}, MAE {fq['mae']:.5f}; launches {train_counts}  [{card}]")
    if not last < first:
        raise AssertionError(f"quality (a): the last chunk's mean total {last} is not below the "
                             f"first step's {first}")
    if not best["corr"] > corr0:
        raise AssertionError(f"quality (a): held-out corr {best['corr']} not above init's {corr0}")
    if not fq["live_frac"] > 0:
        raise AssertionError("quality (a): the trained field is 0 on every held-out pose")
    if train_counts["tile"] != sz["STEPS"] or train_counts["reduce"] != sz["STEPS"]:
        raise AssertionError(f"quality (a): {sz['STEPS']} steps, launches {train_counts}")
    del data, tr, module, field

    # ---- (b) the L8 field against the JAX script's run ----
    ref = np.load(QUALITY_EXPECTED)
    args = qg.parse_args(["--preset", "full", "--corpus", str(int(ref["corpus"])), "--queries",
                          str(int(ref["queries"])), "--latents", str(int(ref["latents"])),
                          "--freq", *map(str, ref["freq"]), "--load-ckpt", CKPT, "--sigmas",
                          *map(str, ref["sigmas"]), "--clips", "1", "--ablate-prior"])
    sz = qg.sizes(args)
    family = qg.gentle_family(123, *args.freq, args.latents)
    q21_counts(reset=True)
    data = qg.manufacture(args, family, sz["N"], sz["Q"], dev)
    cfg, module = qg.build_module(args, dev)
    qg.load_ckpt(CKPT, module)
    field = Field(module)
    fq = qg.field_quality(field, data["h_pose"], data["h_dist"], data["corpus_np"], True)
    want = dict(zip(("mae", "corr", "live_frac", "clean_mean", "noisy_mean"), ref["field"]))
    assert_close("quality (b): field_mae vs JAX", torch.tensor([fq["mae"]]),
                 torch.tensor([want["mae"]]), rtol=Q21_FIELD_RTOL, atol=0.0)
    for k in ("corr", "live_frac", "clean_mean", "noisy_mean"):
        assert_close(f"quality (b): field {k} vs JAX", torch.tensor([fq[k]]),
                     torch.tensor([want[k]]), atol=Q21_FIELD_ATOL)
    log(f"  ok quality (b): field quality vs the JAX script's run {fq}")
    body = BodyModel(device=dev)
    rng = qg.make_rng(args.seed, 7)
    dens = qg.make_denoisers(field, body, "reference", ablate=True)
    for i, sigma in enumerate(ref["sigmas"]):
        gt, noisy = qg.eval_clip(rng, family, args.frames, float(sigma))
        assert_close(f"quality (b) sigma {sigma}: clip vs JAX's", torch.from_numpy(noisy),
                     torch.from_numpy(ref["noisy"][i]), atol=1e-6)
        for j, (den, tag) in enumerate(zip(dens, ("prior on", "prior off"))):
            pose, m = den.optimize(noisy, gt, iterations=int(ref["short"][0]),
                                   steps_per_iter=int(ref["short"][1]))
            assert_close(f"quality (b) sigma {sigma}, {tag}: 2 x 4-step pose vs JAX", pose,
                         torch.from_numpy(ref["short_pose"][i, j]), atol=2e-5)
            for k, w in zip(("v2v_cm", "v2v_input_cm", "final_pose_pr"),
                            ref["short_metrics"][i, j]):
                assert_close(f"quality (b) sigma {sigma}, {tag}: 2 x 4-step {k} vs JAX",
                             torch.tensor([m[k]]), torch.tensor([w]), rtol=1e-3, atol=1e-4)
    t0 = time.perf_counter()
    rows = qg.run_grid(field, body, family, args, *qg.GRID_SCHEDULE)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    add(q21_counts())
    keys = ("v2v_input_cm", "v2v_out_cm", "prior_at_input", "final_pose_pr",
            "v2v_out_noprior_cm", "improvement_pct")
    for i, (row, want_row) in enumerate(zip(rows, ref["rows"])):
        w = dict(zip(keys, want_row))
        log(f"  sigma {row['sigma']}: v2v {row['v2v_input_cm']:.6f} -> {row['v2v_out_cm']:.6f} "
            f"(JAX {w['v2v_out_cm']:.6f}), no prior {row['v2v_out_noprior_cm']:.6f} (JAX "
            f"{w['v2v_out_noprior_cm']:.6f})")
        for k in ("v2v_input_cm", "prior_at_input"):
            assert_close(f"quality (b) sigma {row['sigma']}: {k} vs JAX", torch.tensor([row[k]]),
                         torch.tensor([w[k]]), rtol=Q21_INPUT_RTOL, atol=0.0)
        for k, spread in zip(("v2v_out_cm", "v2v_out_noprior_cm"), ref["ulp_spread"][i]):
            # the metric bar, or twice JAX's own one-ulp spread where that is larger (docstring)
            bar = max(1e-4 + 1e-3 * abs(w[k]), 2 * float(spread))
            assert_close(f"quality (b) sigma {row['sigma']}: 500-step {k} vs JAX (JAX's one-ulp "
                         f"spread {float(spread):.3e})", torch.tensor([row[k]]),
                         torch.tensor([w[k]]), atol=bar)
    n_solves = 2 * len(rows)
    steps = qg.GRID_SCHEDULE[0] * qg.GRID_SCHEDULE[1]
    log(f"  ok quality (b): the grid's {n_solves} solves of {steps} steps in {grid_s:.3f} s "
        f"({1e3 * grid_s / (n_solves * steps):.4f} ms a step)  [{card}]")
    del data

    # ---- (c) the closed loops, one seed and one pair, clip or batch each ----
    runs = {"interp": (load_script("torch_interp_quality"), ["--seeds", "1", "--pairs", "1"],
                       {}, "docs/quality/interp_closed_loop_l8.json"),
            "partial": (load_script("torch_partial_quality"), ["--seeds", "1", "--clips", "1"],
                        {"schedules": Q21_DEPTHS["partial"]},
                        "docs/quality/partial_closed_loop.json"),
            "fit": (load_script("torch_fit_image_quality"),
                    ["--seeds", "1", "--iterations", str(Q21_DEPTHS["fit"][0]),
                     "--steps-per-iter", str(Q21_DEPTHS["fit"][1])], {},
                    "docs/quality/fit_image_closed_loop.json")}
    for name, (mod, argv, kw, record) in runs.items():
        q21_counts(reset=True)
        t0 = time.perf_counter()
        res = mod.main(argv, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add(q21_counts())
        jax_rec = json.load(open(record))
        check_keys(f"quality (c) {name}", res, jax_rec, ("device", "card"))
        check_finite(f"quality (c) {name}", res)
        if name == "interp":
            check_keys("quality (c) interp rows", res["rows"][0], jax_rec["rows"][0])
            s = res["summary"]["noisy"]
            ok = s["true_proj_mean"] < s["true_raw_mean"]
            what = f"noisy paths' true 5-NN {s['true_raw_mean']:.5f} -> {s['true_proj_mean']:.5f}"
        elif name == "partial":
            check_keys("quality (c) partial rows", res["rows"][0], jax_rec["rows"][0])
            ok = all(r["occ_retrieval"] < r["occ_in"] for r in res["rows"])
            what = "occluded-joint error, input -> retrieval: " + ", ".join(
                f"{r['condition']} {r['occ_in']:.3f} -> {r['occ_retrieval']:.3f}"
                for r in res["rows"])
        else:
            check_keys("quality (c) fit runs", res["runs"][0], jax_rec["runs"][0])
            on = {r["condition"]: r["stage2_px_residual"] for r in res["runs"] if r["prior"] == "on"}
            off = {r["condition"]: r["stage2_px_residual"] for r in res["runs"]
                   if r["prior"] == "off"}
            ok = all(off[c] < on[c] for c in on)
            what = "2D residual, prior on / off: " + ", ".join(
                f"{c} {on[c]:.3f} / {off[c]:.3f}" for c in on)
        log(f"  {'ok' if ok else 'FAILED'} quality (c) {name}: {what}; {wall:.3f} s  [{card}]")
        if not ok:
            raise AssertionError(f"quality (c) {name}: the metric moved against the JAX record")
    log(f"quality phase: {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    main()

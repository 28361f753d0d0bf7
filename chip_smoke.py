#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nif_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Print the card's name and power limit; build the CUDA kernels from
   ``nif_tpu_torch/csrc`` (one nvcc per source, all started together) and
   print each build's registers and spills.
2. Hold K1 (the grouped ShapeNet forward) against its plain PyTorch version
   over the six chain configs of the JAX package's kernel tests at G=3,
   P=256, and the flagship chain at G=32, P=32768, in float32 and bfloat16:
   bfloat16 sine chains through the tensor-core body ``k1_variant`` routes
   them to (the wgmma body of ``shapenet_fwd_wgmma.cu`` at widths 64 and
   128 with so <= 4, the ``mma.sync`` body of ``shapenet_fwd_tc.cu`` else),
   float32 and vanilla chains through the CUDA-core one
   (``shapenet_fwd.cu``, one body with K5's CUDA-core reverse body), each
   checked by its launch counters and its geometry's ``body``; the routed
   bodies also on the padded, narrow and wide shapes of K2's
   (``K2_TC_EXTRA``, P = 200) and on the NIF-linear trunk's 128 output
   columns (the ``mma.sync`` body); the CUDA-core kernel on
   ``SIMT_FWD_EXTRA`` (si 5-7, so 2-3, widths 24-1024; P = 200) in float32
   and in bfloat16, which the tensor-core bodies refuse there; the wgmma and
   the ``mma.sync`` bodies each on the CASES chains the wgmma body takes
   (P = 200) and at the flagship shape, against plain K1 and against each
   other; at the flagship shape in bfloat16 the CUDA-core kernel on the same
   inputs too; two flagship runs of the routed body in each dtype, and of
   the ``mma.sync`` body, must give bitwise-equal results; the ``mma.sync``
   body on the deep plain chain of seven hidden matrices (``K1_DEEP_CHAIN``)
   at each seed of ``tests/data/k1_deep_chain_bf16.npz`` (the reference's
   output), within the largest distance the reference sits from plain K1
   over those seeds.
2b. Hold K2 (forward + weighted MSE + backward) against plain K2 over the
   same configs, with and without point weights: bfloat16 sine chains
   through the tensor-core body ``k2_variant`` routes them to (the wgmma
   body of ``shapenet_bwd_wgmma.cu`` at widths 64 and 128, the ``mma.sync``
   body of ``shapenet_bwd_tc.cu`` else), float32 and vanilla chains through
   the CUDA-core one (``shapenet_bwd.cu``), each checked by its launch
   counters; the ``mma.sync`` body also on the padded, narrow and wide
   shapes of K8's (``K2_TC_EXTRA``, P = 200); the wgmma and the ``mma.sync``
   bodies each on the CASES chains the wgmma body takes (P = 200, weighted
   and not) and at the flagship shape, their losses within TC_LOSS_REL of
   each other; at the flagship shape in bfloat16 the CUDA-core kernel on the
   same inputs, and the CUDA-core kernel in float32; two bfloat16 flagship
   runs of each tensor-core body, and two float32 ones, must give
   bitwise-equal results.
2c. Hold K3 (the backward of K1) against plain K3 over the same configs,
   each call one launch of the kernel ``k3_variant`` picks (bfloat16 sine
   chains a tensor-core body, as K2's; float32 and vanilla chains the
   CUDA-core one; float32 within 5e-6 of max|plain|), the ``mma.sync`` body
   also on ``K2_TC_EXTRA`` (P = 200), both tensor-core bodies on the CASES
   chains the wgmma body takes (P = 200), and at the flagship shape (G=32)
   in bfloat16 (each tensor-core body, and the CUDA-core one on the same
   inputs; two runs of each tensor-core body must give the same bits and
   agree with the CUDA-core one within BF16_REL) and float32, where two
   runs must give the same bits;
   differentiate ``apply_grouped`` on the card through K1 + K3 and through
   the eager path, and compare the ParameterNet gradients, under the
   flagship's bfloat16 policy (one tensor-core K1 and one tensor-core K3)
   and under the float32 policy (the CUDA-core K1 and the float32 K3).
3. Serve the flagship NIFMultiScale (``nif_tpu_torch.utils.bench``, random
   weights from a seed) through ``serving.predict_grouped``: a full request, a
   ragged one (point padding) and a 70-snapshot one (chunking). Check shapes,
   finiteness, agreement with the plain K1 and the eager path, and that the
   routed tensor-core K1 (the wgmma body) launched once per chunk served;
   then one full request of
   the same model under the float32 policy (one launch of the CUDA-core K1,
   its geometry's body "simt").
3b. Train the flagship: ``GroupedTrainer.step`` with Adam at G=32, P=32768
   (one launch of the routed tensor-core K2 body per step, the first step's
   loss and gradients against plain K2 and autograd through the
   ParameterNet); the ``mma.sync`` body's own path: one step of bench.py's
   w256_d2 chain (width 256, which the wgmma body refuses) and one
   ``apply_grouped`` backward of it, one ``mma.sync`` K2 and K3 launch; one
   step of the flagship under the float32 policy (one launch of the
   CUDA-core K2, none of a tensor-core one), then a short ``fit`` on a
   smooth traveling wave (60 launches of the routed body) whose last epoch
   loss must be below its first.
4. Time the bfloat16 routed K1, the wgmma and the ``mma.sync`` K1 in turns
   on the same inputs (tc, wgmma, wgmma, tc), the CUDA-core K1 on the same
   bfloat16 inputs and in float32, their plain versions and the end-to-end
   ``apply_grouped`` and ``predict_grouped`` with CUDA events, and compute
   K1's bounds on this card; then the float32 policy's ``apply_grouped``
   (mean of 20) and ``predict_grouped`` from host arrays (mean of 5), each on
   the device clock and on the host clock.
4b. Time the flagship train step and its stages, the bfloat16 routed K2,
   the CUDA-core K2 on the same bfloat16 inputs and in float32, the
   bfloat16 routed K3, the CUDA-core K3 on the same inputs and in float32,
   with their plain versions, the wgmma and the ``mma.sync`` K2 and K3 in
   turns on the same inputs (tc, wgmma, wgmma, tc), and compute their bounds
   on this card; then the float32 policy's train step (the CUDA-core K2), mean of 10
   on the device clock and on the host clock, and its stages; a
   ``step_report`` line for each of the two steps (points/s, TFLOP/s and
   ``mfu`` against the published bf16 tensor-core or f32 peak).

Phases of the Sobolev slice:

2d. Hold K5 (the fused Jacobian) against plain K5 over the same configs and
   one more with so >= si (the forward-tangent body), in float32 and
   bfloat16: bfloat16 sine chains through the tensor-core kernels (the
   reverse body, so < si, of ``shapenet_fwd_wgmma.cu`` where its geometry
   takes the chain, else of ``shapenet_fwd_tc.cu``; the tangent body,
   so >= si, of ``shapenet_jac_tc.cu``, K6's forward half), the rest
   through the CUDA-core ones (the reverse body of ``shapenet_fwd.cu``,
   beside the CUDA-core K1, and the tangent body of ``shapenet_jac.cu``,
   the CUDA-core K6's forward half, or at si > 4 the first port's
   "stacked" body), each checked by its launch counter and its geometry's
   ``body``; the tangent body also on ``TANGENT_EXTRA`` (tutorial 8's
   1 -> 1 chain of width 30, si = so = 2 on a resblock chain, si = so = 4
   at widths 16 and 192, a vanilla chain, which bf16 runs on the CUDA-core
   body, and si = so = 5 on the stacked body; P = 200) in both dtypes; the
   ``mma.sync`` reverse body, by name, also on ``JAC_REV_TC`` (si = 3 with
   so = 2 on a resblock chain, si = 4 at width 16, widths 40 and 192; P =
   200); the wgmma and the ``mma.sync`` reverse bodies each on the chains
   the wgmma body takes (P = 200) and at the flagship shape, against plain
   K5 and against each other; the
   CUDA-core reverse body on ``SIMT_FWD_EXTRA`` (2-3 sweeps) in both
   dtypes; at the flagship shape, and at si = so = 3 of the flagship widths
   (the tangent body's timed shape), in bfloat16 the tensor-core kernel and
   the CUDA-core one on the same inputs, and the CUDA-core one in float32
   (G=32); two runs at each of the two shapes in each dtype (and of the
   ``mma.sync`` reverse body by name) must give bitwise-equal results.
2e. Hold K6 (the fused Sobolev train pass) against plain K6 over the same
   configs, weighted or not, with value and Jacobian masks on the
   multi-output configs: bfloat16 sine chains through the tensor-core
   kernel (``shapenet_jac_tc.cu``), float32 and vanilla chains through the
   CUDA-core one (``shapenet_jac.cu``), each checked by its launch counter;
   the tensor-core kernel also on the padded, narrow and wide shapes of
   K8's (``HESS_TC_EXTRA``, P = 200); at the flagship shape in bfloat16 the
   tensor-core kernel and the CUDA-core one on the same inputs, and at the
   flagship width at G=8 in float32; two bfloat16 flagship runs must give
   bitwise-equal results.
3c. Sobolev-train the flagship: ``sobolev_value_and_grad`` at step 0
   against plain K6 + autograd, five ``GroupedTrainer.step(...,
   target_jac=...)`` at G=32, P=32768 (five launches of the tensor-core K6,
   none of the CUDA-core one, no K2), one step of the same model under the
   float32 policy (one of the CUDA-core K6, none of the tensor-core one), a
   short Sobolev ``fit`` on the traveling wave with its analytic Jacobian
   (60 tensor-core launches) that must lower both terms, and
   ``evaluate_sobolev`` (one launch of the routed tensor-core K5, the wgmma
   reverse body, per chunk; under the float32 policy one CUDA-core K5
   launch per chunk, its geometry's body "simt"); then one chunk of
   ``evaluate_sobolev`` on a flagship-width chain of two resblocks, which
   the wgmma body refuses: one launch of the ``mma.sync`` reverse body.
3f. Evaluate tutorial 8's model (``examples/08_sobolev_training.py``:
   SIREN 1 -> 1, width 30, two hidden layers, omega_0 = 30; random weights
   from a seed) through ``GroupedTrainer.evaluate_sobolev`` with Jacobian
   targets at G=32, P=32768: under the bfloat16 policy one launch of the
   tensor-core tangent body for the one chunk and nothing else, under
   float32 one launch of the CUDA-core one; each model's grouped ``(y,
   jac)`` against plain K5. Then tutorial 3's NIF-linear model
   (``examples/03_multi_scale_linear_nif.py``), whose effective chain is
   si = so = 2: ``output_and_jacobian_grouped`` at G=8, P=4096 in both
   policies through the kernel ``k5_variant`` picks, against plain K5.
4c. Time the flagship Sobolev step, the bfloat16 routed K5 and K6, the
   wgmma and the ``mma.sync`` K5 reverse bodies in turns on the same inputs
   (tc, wgmma, wgmma, tc), the CUDA-core K5 and K6 on the same bfloat16
   inputs and in float32, with
   their plain versions, and compute their bounds on this card; the float32
   policy's Jacobian ``evaluate_sobolev`` at G=32, P=32768 from host arrays
   (one launch of the CUDA-core K5), mean of 3 on the device clock and on
   the host clock; K5's tangent body at si = so = 3 of the flagship widths
   (G=32, P=32768): bfloat16 on the tensor cores, the CUDA-core body on the
   same inputs, float32 on the CUDA cores, with plain versions and bounds;
   and tutorial 8's ``evaluate_sobolev`` under both policies, mean of 5 on
   the device clock and on the host clock, beside the tangent body alone on
   its weights and coordinates.

Phases of the Hessian slice:

2f. Hold K7 (the fused Hessian evaluation) against plain K7 over the SIREN
   configs (the Hessian kernels take sine chains only): bfloat16 through the
   tensor-core body ``k7_variant`` routes the chain to (the wgmma body,
   ``shapenet_hess_wgmma.cu``, at si = 3 and widths 64 and 128; else the
   ``mma.sync`` body, ``shapenet_hess_tc.cu``), float32 through the
   CUDA-core one (``shapenet_hess.cu``), each checked by its launch counters;
   the ``mma.sync`` body by name on the shapes of ``HESS_TC_EXTRA`` and the
   wgmma body by name on those of ``HESS_WG`` (P = 200); at the flagship
   width at G=8 (plain K7's f32 stacked tensors of ten streams take 1.3 GB
   each there) both bf16 bodies, the CUDA-core one on the same bfloat16
   inputs, and the CUDA-core one in float32; the float32 one also at G=32,
   P=32768 (the shape phase 4d times, its plain version in chunks of 8
   groups); two runs of each body at G=32 must give bitwise-equal results,
   and the two bf16 bodies must agree there.
2g. Hold K8 (the fused Hessian train pass) against plain K8 likewise, with
   value, Jacobian and Hessian masks on the multi-output configs: bfloat16
   through the routed body, float32 through the CUDA-core one, each checked
   by its launch counters; the ``mma.sync`` body by name on padded and
   narrow shapes (widths 24, 40, 256, 512; si = 1, 2, 4; resblock chains;
   P = 200, a ragged last tile), which take each of its geometries; the
   wgmma body by name on ``HESS_WG`` unweighted, weighted, and weighted and
   masked; the flagship width at G=8 on both bf16 bodies and in float32,
   and in float32 at G=32, P=32768, unweighted and weighted (plain K8 in
   chunks of 8 groups); two runs of each body at G=32, P=32768 must give
   bitwise-equal results, and the two bf16 bodies must agree there.
3d. Hessian-train the flagship (``flagship_hessian_step``): step 0's terms
   and gradients against plain K8 (in chunks of 8 groups: each group's
   d_wb is its own) + autograd, five steps (five launches of the routed
   bf16 K8, no K6, no K2), one step of the same model under the float32
   policy (one of the CUDA-core K8, none of a tensor-core one), a short
   Hessian ``fit`` on the traveling wave with its analytic Jacobian and
   Hessian that must lower the Hessian term of ``evaluate_sobolev``, which
   launches the routed bf16 K7 once per chunk (the float32 policy's
   ``evaluate_sobolev``: the CUDA-core K7 once per chunk); the ``mma.sync``
   K7 and K8's own path: one Hessian step and one evaluation of a
   flagship-width model of two inputs (si = 2, which the wgmma body has no
   instance for), then those two kernels against plain K7 and K8 at that
   path's shape (G=8, P=4096; K8 unweighted and weighted).
4d. Time the flagship Hessian step and its stages, the bfloat16 K7 and K8
   as routed and their wgmma and ``mma.sync`` bodies in turns (wgmma,
   mma.sync, mma.sync, wgmma), the CUDA-core K7 and K8 on the same bfloat16
   inputs and in float32 (G=32, P=32768), and their plain versions over the
   same inputs in chunks of 8 groups, and compute their bounds on this
   card; the ``mma.sync`` K7 and K8 (the kernels line's ``shapenet_fwd_hess``
   and ``shapenet_hessian_grads``) and their plain versions at their own
   path's shape (si = 2, G=8, P=4096), with their bounds there; then the
   float32 policy's Hessian step (the CUDA-core K8), mean of 3 on the
   device clock and on the host clock, and its stages.

Phases of the NIF-linear slice:

2h. Hold K4 (the fused NIF-linear train pass) against plain K4 on the SIREN
   configs of ``CASES`` as trunks with so * K outputs (so = 1, 2, 3; plain
   and resblock), weighted or not: bfloat16 through the tensor-core kernel
   (``shapenet_linear_tc.cu``), float32 through the CUDA-core one
   (``shapenet_linear.cu``), each checked by its launch counter; then on the
   flagship NIF-linear trunk at G=32, P=32768 in both dtypes, where two
   bfloat16 runs must give bitwise-equal results.
3e. Serve and train the JAX bench's NIF-linear model
   (``flagship_linear_step``): ``apply_grouped(fused=True)`` (one K1 launch)
   against plain K1 and the eager trunk; ``predict_shared_mesh`` against
   ``apply_grouped`` on a repeated mesh; step 0's loss and grads against
   plain K4 + autograd through the ParameterNet; five ``GroupedTrainer.step``
   (five launches of the tensor-core K4, no K2), and two steps of the same
   model under the float32 policy (two of the CUDA-core K4, none of the
   tensor-core one); a 30-epoch ``fit`` on the traveling wave that
   must lower the loss; one Sobolev step (one launch of the tensor-core K6
   on the effective chain, its terms and grads against plain K6 + autograd)
   and an
   ``evaluate_sobolev`` that launches K5 once per chunk (the kernels
   ``k1_variant`` and ``k5_variant`` pick for the trunk and the effective
   chain).
4e. Time the NIF-linear step, the bfloat16 tensor-core K4, the float32
   CUDA-core K4, plain K4 and the eager step (autograd over the eager trunk +
   Adam), and compute both K4 bounds on this card.

Phases of the resident slice:

3g. Train the flagship resident (``GroupedTrainer.fit_resident``): a
   traveling wave of G=64 x P=65536 (x 50.3 MB, u 16.8 MB of float32) staged
   on the card, steps of the flagship shape [32, 32768] drawn there. In both
   policies, three epochs (6 steps) through the CUDA graph against a loop of
   ``GroupedTrainer.step`` on a copy of the model over the same batches
   (re-drawn from the seed by ``ResidentData``, run after the fit and
   outside its counts): the same losses and parameters bit for bit with a
   capturable Adam (the whole step captured), with a plain Adam
   (``opt.step()`` after each replay) and with a ``LearningRateScheduler``
   over a capturable Adam and a capturable AdamW with weight decay (one
   capture: the whole-step graph reads the learning rate from a device
   tensor). Each ``fit_resident`` call runs alone under
   ``torch.profiler`` with the launch counts reset just before it: its K2
   wrapper launches once in the eager first step and once a capture, and
   the trace counts one K2 a step (the tensor-core kernel in bf16, the
   CUDA-core one in float32) and no K1, K3, K6 or K8. Resident Sobolev and
   Hessian fits (random targets, G=16 x P=32768, [8, 16384] batches, 6
   steps) count one K6 or K8 a step in both policies. Tutorial 8's
   ``main_trainer`` and ``main_hessian`` at their own shapes (G=10, 256
   points, full batch, 300 epochs) lower the loss through one K6 or K8 a
   step. A residual resident fit (``resample_every=2``, 4 epochs) launches
   K1 once per 4M-point chunk at each refresh, and 50000 residual draws of
   one group follow its probabilities (chi-square over 100 equal-mass bins,
   p > 1e-3). The point-wise ``Trainer`` with tutorial 1's model on
   ``TravelingWave`` (1500 epochs of batch 512) halves its loss.
4f. Time the resident MSE step over 50 steps in one chunk in both policies
   and both graph forms (CUDA events around the replays, the host clock of
   the whole call, the capture; a ``step_report`` line for the whole-step
   graph of each policy), the device's busy share over 10 replays,
   the kernels a replay and the sampler alone; beside them
   ``GroupedTrainer.step`` synchronized and ``fit`` from host arrays at the
   same batch shape, with ``fit``'s host stages; the resident Sobolev and
   Hessian steps (10 steps each); and tutorial 8's resident Sobolev step
   (G=10 x 256, full batch, a step an epoch) in both graph forms, with and
   without a learning-rate schedule.

Phases of the optimizer and streaming slice:

3h. L-BFGS fine-tuning (``optimizers.GroupedLBFGS``) of the flagship at
   G=32 x P=32768 in both policies, 10 iterations: every objective
   evaluation launches one K2 (the tensor-core one in bf16), counted around
   the call alone, and the accepted losses do not rise; the objective in 4
   chunks of 8 groups equals the in-memory one at the start (value rel 1e-5,
   gradient 5e-5 of max|g|: the sums' order; under the bf16 policy, whose
   ParameterNet backward rounds each gradient product to bf16, BF16_REL). Tutorial 8's model at its own
   shape (G=10 x 256) fits its Sobolev (one K6 an evaluation) and Hessian
   (one K8) objectives in both policies; a ``dtype="float64"`` fit of the
   flagship at G=4 launches no kernel and ``cast_parameters`` restores
   float32; tutorial 1's point-wise ``LBFGS`` (200 iterations, float32 and
   float64) lowers the MSE.
3i. Streamed grouped training: a ``GroupedDataset`` of G=64 x P=65536 (x
   50.3 MB, u 16.8 MB) in two shards under a temporary directory, the native
   reader built, ``iter_batches(32, 32768)`` for 2 epochs through
   ``prefetch_to_device`` into ``GroupedTrainer.step``: one K2 a step, each
   loss bit for bit that of the step on the same batch as host arrays.
4g. Times: each L-BFGS fit's ms an iteration (CUDA events and the host
   clock), objective evaluations and host reads an iteration, and
   ``torch.profiler`` over 5 iterations of the flagship MSE and tutorial 8's
   Sobolev fits (busy share, kernels and host time an iteration); the
   streamed step with and without ``prefetch_to_device`` (20 steps a run,
   two runs each in turns, host clock) and the device's busy share over 10
   prefetched steps (``torch.profiler``);
   one flagship ``GroupedTrainer.step`` under ``torch.optim.Adam``,
   ``adabelief_full``, ``lion``, a centralized capturable ``adam`` and a
   capturable ``adam`` on ``warmup_linear_decay`` (CUDA events, mean of 5),
   the form ``graph_form`` picks for each, and a 5-step ``fit_resident``
   under each against the eager loop, bit for bit.

Phases of the compression and export slice (after 4g):

3j. The int8 ROM decode of the JAX bench's NIF-linear model (SIREN trunk
   3 -> 128 x 2 -> 128, so = 1, K = 128; ``mlp_hyper`` ParameterNet; random
   weights from a seed) at G=256 snapshots onto one mesh of P=32768 points,
   in both policies: ``quantize_shared_mesh`` (q_phi 4.2 MB), the
   ``torch._int_mm`` product bit for bit its float64 version, the decode
   within 1e-6 of max of the float64 product of its dequantized operands,
   within rel-L2 1e-2 of the float32 fixed-mesh decode and of
   ``apply_shared_mesh`` and within 1.1x what int8 rounding predicts;
   ``predict_shared_mesh(int8_pack=...)`` and the loaded ``shared_mesh_int8``
   artifact bit for bit the decode; no hand-written kernel launched. Times:
   the float32 decode (``phi`` precomputed), the int8 decode and the
   artifact (CUDA events, mean of 50, and device time a call).
3k. ``export_apply``/``load_exported`` on the card: the flagship's
   ``grouped`` artifact at G=32 x P=32768 in both policies holds one call of
   K1's registered op; a call launches K1 once (the tensor-core one in
   bf16), a ``torch.profiler`` trace of one call holds one K1 kernel and no
   other fused pass, and the output is ``apply_grouped``'s bit for bit
   (times beside it); the ``pointwise`` (4096 rows) and NIF-linear
   ``shared_mesh`` artifacts round-trip bit for bit.
3l. ``MagnitudePruning(adam, 0.5, begin 0, end 4, every 2)``: six flagship
   ``GroupedTrainer.step`` (six tensor-core K2) leave every prunable tensor
   at most its kept count (sparsity >= 0.5 within one entry a tensor), the
   masks frozen after step 4 and the pruned entries exactly 0; a 5-step
   ``fit_resident`` (the ``forward_backward`` form) equals its eager loop
   bit for bit.
3m. The command line (``nif_tpu_torch.cli.main``) at the flagship's width:
   a grouped dataset directory (64 groups x 32768 points), ``train`` at
   ``--group-batch 32 --point-batch 32768`` (one tensor-core K2 a step, the
   loss finite and falling), ``eval`` (one K1 a chunk; its JSON equal to
   ``evaluate_metrics`` on the restored checkpoint) and ``export
   --serving-layout grouped`` (the loaded artifact bit for bit
   ``apply_grouped``).
3n. Two ranks on the one card over gloo (``parallel.launch.run_ranks``,
   each rank a process with a timeout): data-parallel
   ``GroupedTrainer.step`` x5 at G=32 x P=32768 (16 groups a rank) against
   the one-process step, parameters equal across ranks bit for bit; the
   row-parallel head on a ('data', 'model') = (1, 2) mesh against data
   parallelism; ZeRO-1 on the point-wise ``Trainer`` against the replicated
   one; the meshed evaluation against the unmeshed; host-clock step times.
3o. NCCL at world size 1 (its own process): meshed ``step`` and
   ``fit_resident`` bit for bit the unmeshed, the resident step a CUDA
   graph holding the gradient ``all_reduce`` (one NCCL kernel a step in
   the trace); with two cards, 3n's data-parallel check over NCCL.
3p. The tutorials on the card (``nif_tpu_torch/examples``): tutorial 13 at
   ``--paper`` (G=64 x P=262144, width 128, latent 128, mixed_bfloat16) for
   3 epochs, under ``torch.profiler``: one tensor-core K2 a resident step,
   the loss falling, the held-out ``apply_grouped`` one tensor-core K1, the
   finer decode ``[8, 524288, 1]``, its points/s line beside the card, a
   ``step_report`` line of the replayed step;
   ``entry()`` through ``torch.export`` and ``torch.compile`` (K1 as its
   registered op); then at ``tests/test_examples.py``'s budgets and
   thresholds tutorial 8's grouped, trainer and Hessian runs (the CUDA-core
   K6 and K8, one a step), tutorial 5's grouped stream (the CUDA-core K2),
   tutorial 1 (L-BFGS on the card) and tutorial 10 (the export artifact).
   3n also holds ``GroupedLBFGS`` on the row-parallel head against one
   unsplit process (3 iterations, losses within 1e-3, one K2 an evaluation
   on each rank).

Every bound is ``nif_tpu_torch.utils.roofline``'s (``kernel_cost``,
``kernel_bound_ms`` against ``card_peaks``), and every ``step_report`` line
its ``step_report``. The last line is ``{"ok": true, "device": {...}}``; the
line before it is the ``{"kernels": [...]}`` record, and before that the
card's name and power limit and the run's wall-clock seconds. Exits non-zero
without CUDA or without the package beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# bf16 bounds on a kernel against its plain version: two bf16 ulps of the
# largest entry (an f32 last-bit difference in a sum can flip the bf16
# rounding of one activation, derivative or dz), and a relative loss bound.
BF16_REL = 2.0 ** -6
BF16_LOSS_REL = 1e-3
# ... and of the tensor-core K6 against plain K6 on the terms: each product
# is exact, only the order of the f32 sums differs.
TC_LOSS_REL = 1e-4

# The chain configs of tests/test_pallas_kernel.py (variant, ShapeNetConfig args).
CASES = [
    ("siren", (3, 1, 128, 2, "sine", False, 30.0)),
    ("siren", (2, 2, 64, 1, "sine", True, 10.0)),
    ("siren", (1, 1, 16, 3, "sine", False, 5.0)),
    ("vanilla", (2, 3, 32, 2, "swish")),
    ("vanilla", (1, 1, 16, 1, "tanh")),
    ("vanilla", (2, 1, 64, 2, "relu")),
]
# K5 takes its forward-tangent body where so >= si; of CASES only the
# so=si ones do, so one more SIREN config with so > si.
JAC_EXTRA = [("siren", (2, 3, 64, 2, "sine", False, 30.0))]
# K5's tangent body (so >= si) beyond CASES + JAC_EXTRA: tutorial 8's chain
# (1 -> 1, width 30; examples/08_sobolev_training.py), si = so = 2 on a
# resblock chain, si = so = 4 at widths 16 and 192, a vanilla chain (bf16:
# the CUDA-core body) and si = so = 5 (the stacked body in both dtypes);
# each run at P = 200 (a ragged last tile). (variant, args, bf16 body)
TANGENT_EXTRA = [
    ("siren", (1, 1, 30, 2, "sine", False, 30.0), "tc"),
    ("siren", (2, 2, 64, 2, "sine", True, 10.0), "tc"),
    ("siren", (4, 4, 16, 2, "sine", False, 30.0), "tc"),
    ("siren", (4, 4, 192, 1, "sine", False, 30.0), "tc"),
    ("vanilla", (2, 3, 48, 2, "swish"), "simt"),
    ("siren", (5, 5, 32, 1, "sine", False, 30.0), "stacked"),
]
# The tangent body's timed shape (PERF.md's K5 tangent rows): si = so = 3 at
# the flagship widths.
TANGENT_SHAPE = (3, 3, 128, 2, "sine", False, 30.0)
# Tutorial 8's model (examples/08_sobolev_training.py, _CFG_S and _CFG_P).
TUTORIAL8_S = {"connectivity": "full", "input_dim": 1, "output_dim": 1, "units": 30,
               "nlayers": 2, "weight_init_factor": 0.01, "omega_0": 30.0,
               "activation": "sine", "use_resblock": False}
TUTORIAL8_P = {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
               "activation": "swish", "use_resblock": False, "omega_0": 30.0}
# Tutorial 1's model (examples/01_simple_1d_wave.py).
TUTORIAL1_S = {"input_dim": 1, "output_dim": 1, "units": 30, "nlayers": 2,
               "activation": "swish"}
TUTORIAL1_P = {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
               "activation": "swish"}
# Tutorial 3's NIF-linear model (examples/03_multi_scale_linear_nif.py): its
# effective chain for the derivative kernels is si = so = 2, width 30.
TUTORIAL3_S = {"connectivity": "last_layer", "input_dim": 2, "output_dim": 2, "units": 30,
               "nlayers": 2, "weight_init_factor": 0.01, "omega_0": 30.0,
               "activation": "sine", "use_resblock": False}
TUTORIAL3_P = {"input_dim": 1, "latent_dim": 10, "units": 30, "nlayers": 2,
               "activation": "swish", "use_resblock": False, "omega_0": 30.0}
# The Hessian kernels (K7, K8) take sine chains only.
HESS_CASES = [c for c in CASES if c[0] == "siren"] + JAC_EXTRA
# Shapes the tensor-core K8 pads, tiles raggedly or lays out otherwise: widths
# 24 and 40 (zero-padded to 16), si = 1, 2 and 4, resblock chains, and widths
# 256 and 512, whose S planes go to the global scratch and whose W is read
# from global memory (ShapeNetConfig args; each run at P = 200).
HESS_TC_EXTRA = [
    (3, 1, 24, 2, "sine", False, 30.0),
    (2, 2, 40, 2, "sine", True, 10.0),
    (1, 1, 64, 2, "sine", False, 30.0),
    (4, 1, 128, 2, "sine", False, 30.0),
    (3, 1, 128, 2, "sine", True, 30.0),
    (3, 1, 256, 2, "sine", True, 30.0),
    (1, 1, 512, 1, "sine", False, 30.0),
]
# ... and those of the tensor-core K2, whose two working planes of 128 rows
# exceed shared memory at width 512: width 384 (three column blocks a warp)
# takes that case's place.
K2_TC_EXTRA = HESS_TC_EXTRA[:-1] + [(1, 1, 384, 1, "sine", False, 30.0)]
# The chains the wgmma K7/K8 body takes (si = 3, widths 64 and 128, so <= 4):
# the flagship, a resblock at width 128, width 64 with so = 3, a resblock at
# width 64 with four hidden matrices and so = 4 (ShapeNetConfig args; each
# run at P = 200, a ragged last 16-point tile)
HESS_WG = [
    (3, 1, 128, 2, "sine", False, 30.0),
    (3, 2, 128, 1, "sine", True, 30.0),
    (3, 3, 64, 2, "sine", False, 30.0),
    (3, 4, 64, 2, "sine", True, 10.0),
]
# Reverse-body shapes (so < si) of the tensor-core K5: si = 3 with so = 2 on
# a resblock chain, si = 4 with so = 1 at width 16, a width that is no
# multiple of 16 (40), and width 192 (two column blocks a warp, W read from
# global memory); each run at P = 200 (a ragged last tile).
JAC_REV_TC = [
    (3, 2, 64, 1, "sine", True, 10.0),
    (4, 1, 16, 2, "sine", False, 30.0),
    (3, 1, 40, 2, "sine", False, 30.0),
    (3, 1, 192, 1, "sine", False, 30.0),
]
# Shapes of the CUDA-core K1 and K5 reverse body (one body, shapenet_fwd.cu)
# beyond CASES: so = 2-3 reverse sweeps, si 5-7 (x tiles of round4(si)
# columns), widths 24-1024 (the five register tiles of stack_simt.cuh),
# plain, resblock and vanilla chains; each run at P = 200 (a ragged last
# tile) in float32, and in bfloat16, whose tensor-core kernels refuse every
# one of them (si > 4, vanilla chains, K1 above width 800, K5 above 208).
SIMT_FWD_EXTRA = [
    ("siren", (5, 2, 24, 2, "sine", False, 30.0)),
    ("siren", (6, 3, 40, 2, "sine", True, 10.0)),
    ("siren", (7, 2, 256, 2, "sine", True, 30.0)),
    ("siren", (5, 3, 1024, 1, "sine", False, 30.0)),
    ("vanilla", (6, 2, 128, 2, "swish")),
    ("vanilla", (7, 3, 512, 1, "tanh")),
]
# K4's trunks: the SIREN configs of CASES with a bottleneck of so * K outputs,
# so in {1, 2, 3}, resblock and plain, so * K within the kernel's width:
# (si, so, K, units, nlayers, resblock, omega_0).
LINEAR_CASES = [
    (3, 1, 128, 128, 2, False, 30.0),
    (2, 2, 32, 64, 1, True, 10.0),
    (1, 3, 8, 16, 3, False, 5.0),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def chain_data(torch, cfg, G, P, dtype, seed):
    """SIREN-regime weights (0.3/omega_0 keeps omega*z bounded) and N(0,1)
    coordinates, made with numpy from a seed, on the card in ``dtype``."""
    from nif_tpu_torch.config import shapenet_param_count

    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, cfg.input_dim))
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)  # noqa: E731
    return to(wb), to(x)


def side_data(torch, cfg, G, P, seed):
    """Targets, point weights and an output cotangent, float32 on the card."""
    rng = np.random.default_rng(seed + 1000)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    return (to(rng.standard_normal((G, P, cfg.output_dim))), to(rng.uniform(0.5, 1.5, (G, P))),
            to(rng.standard_normal((G, P, cfg.output_dim)) * 0.1))


def describe(cfg, variant, G, P, dtype) -> str:
    return (f"{variant:7s} si={cfg.input_dim} so={cfg.output_dim} n={cfg.units} "
            f"l={cfg.nlayers} res={cfg.use_resblock} G={G} P={P} {str(dtype):14s}")


def max_diff(torch, out, ref, what: str):
    """(max|out - ref|, max|ref|) in f32; raises on a non-finite output."""
    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{what}: non-finite output")
    return float((o - r).abs().max()), float(r.abs().max())


def host_ms(torch, fn, reps: int) -> float:
    """Mean host-clock ms of ``fn()`` over ``reps`` calls, each ending in a
    synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / reps * 1e3


def check_k1(torch, cfg, variant, G, P, dtype, seed, simt=False, kernel=None) -> float:
    """Kernel vs plain version on one input; returns max |kernel - plain|.
    The launch must take the kernel ``k1_variant`` picks (``simt``: the
    CUDA-core kernel on the same inputs, through its private launcher;
    ``kernel``: the body named, "wgmma", "tc" or "simt", likewise).

    Tolerances: float32 rtol 2e-4, atol 1e-5 (the JAX package's kernel-test
    bound; both sides sum in f32, in different orders). bfloat16 max|d| <=
    1e-2 * max|plain| (about 2.5 bf16 ulps): a last-bit difference in an f32
    sum can flip the bf16 rounding of an activation before the next matmul."""
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_shapenet import (
        _shapenet_fwd_on, k1_geometry, k1_variant, shapenet_fwd_cuda,
        shapenet_grouped_fused_reference)

    wb, x = chain_data(torch, cfg, G, P, dtype, seed)
    named = "simt" if simt else kernel
    kernel = named or k1_variant(dtype, cfg, variant)
    geo = k1_geometry(cfg, variant, G, P, dtype, kernel=kernel)
    before = dict(_build.LAUNCHES)
    if named is None:
        out = shapenet_fwd_cuda(wb, x, cfg, variant)
    else:
        out = _shapenet_fwd_on(named, wb, x, cfg, variant)
    ref = shapenet_grouped_fused_reference(wb, x, cfg, variant)
    torch.cuda.synchronize()
    what = f"K1 {describe(cfg, variant, G, P, dtype)}"
    got, want = _body_launches("shapenet_fwd", before, kernel)
    if got != want or geo["body"] != kernel:
        raise AssertionError(f"{what}: launched {got}, not one {kernel} K1 (geometry {geo})")
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"K1 {variant} {cfg}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
    err, scale = max_diff(torch, out, ref, f"K1 {variant} {cfg} {dtype}")
    if dtype == torch.float32:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-4, atol=1e-5)
    elif err > 1e-2 * scale:
        raise AssertionError(f"K1 {variant} {cfg} bf16: max|d| {err} > 1e-2 * {scale}")
    log(f"{what} max|d|={err:.3e} max|plain|={scale:.3e} ({err / scale:.2e} of it); "
        f"{describe_geometry(geo)}")
    return err


def describe_geometry(geo) -> str:
    """A K1 or K5 geometry in a few words: its body, tiles and grid."""
    grid = (f"{geo['blocks']} blocks ({geo['blocks_per_sm']} an SM)" if "blocks" in geo
            else f"{geo['splits']} splits")
    return (f"{geo['body']} body, {geo['tile']}-point tiles, {grid}, planes in "
            f"{geo['residuals']} memory, {geo['smem_bytes']} B of shared memory")


def _body_launches(base, before, body, n=1):
    """``{counter: launches since before}`` of K1 (``base``
    "shapenet_fwd"), K2 ("shapenet_mse_grads"), K3 ("shapenet_bwd"), K5
    ("shapenet_fwd_jac"), K7 ("shapenet_fwd_hess") or K8
    ("shapenet_hessian_grads") beside what ``n`` launches on ``body``
    ("wgmma", "tc" or "simt"; K5's tangent body counts as "tc") add."""
    from nif_tpu_torch.ops import _build

    names = (base, base + "_tc", base + "_wg")
    got = {k: _build.LAUNCHES[k] - before[k] for k in names}
    want = {base: n, base + "_tc": n * (body == "tc"), base + "_wg": n * (body == "wgmma")}
    return got, want


def check_k1_bodies(torch, cfg, G, P, seed) -> dict:
    """The wgmma and the mma.sync K1 on the same bf16 inputs: each against
    plain K1 (``check_k1``), and against each other within 1e-2 of the
    mma.sync body's max|out| (each product is exact in both; only the order
    of the f32 sums differs, and an f32 last bit can flip a bf16 rounding).
    Returns ``{body: max |out - plain|}``."""
    from nif_tpu_torch.ops.fused_shapenet import _shapenet_fwd_on

    errs = {body: check_k1(torch, cfg, "siren", G, P, torch.bfloat16, seed, kernel=body)
            for body in ("wgmma", "tc")}
    wb, x = chain_data(torch, cfg, G, P, torch.bfloat16, seed)
    outs = [_shapenet_fwd_on(body, wb, x, cfg, "siren") for body in ("wgmma", "tc")]
    err, scale = max_diff(torch, outs[0], outs[1], "K1 wgmma vs mma.sync")
    log(f"K1 {describe(cfg, 'siren', G, P, torch.bfloat16)}: the wgmma body against the "
        f"mma.sync body's max|d| {err:.3e} ({err / scale:.2e} of its max|out|)")
    if err > 1e-2 * scale:
        raise AssertionError(f"the wgmma and mma.sync K1 differ by {err} > 1e-2 * {scale}")
    return errs


# The reference's bf16 K1 on the deep plain chain (nif_tpu, interpret mode;
# tests/test_torch_k1_deep_chain.py regenerates and pins it)
K1_DEEP_FIXTURE = "tests/data/k1_deep_chain_bf16.npz"
K1_DEEP_CHAIN = (3, 1, 128, 7, "sine", False, 30.0)


def check_k1_deep_chain(torch) -> None:
    """The mma.sync K1 (the wgmma body refuses seven hidden matrices) on the
    deep plain chain at the fixture's G and P, a call for each of its seeds:
    at every seed within the largest distance the reference itself sits
    from plain K1 over the fixture's seeds (a seed's gap is one draw of the
    chain's bf16 scatter, so the chain's bound is the reference's worst
    reading). Logs every seed's figures (the kernel's distance from the
    reference's output too), their medians, and plain K1 with its products
    on the tensor cores (cuBLAS TF32, exact on bf16 operands) beside them."""
    from nif_tpu_torch.config import ShapeNetConfig
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_shapenet import (
        k1_variant, shapenet_fwd_cuda, shapenet_grouped_fused_reference)

    cfg = ShapeNetConfig(*K1_DEEP_CHAIN)
    if k1_variant(torch.bfloat16, cfg, "siren") != "tc":
        raise AssertionError(f"K1 does not route {cfg} to the mma.sync body")
    with np.load(K1_DEEP_FIXTURE) as z:
        seeds, G, P = [int(v) for v in z["seeds"]], int(z["G"]), int(z["P"])
        refs = torch.from_numpy(z["out_bits"].view(np.int16)).view(torch.bfloat16).cuda()
    rows = []
    for seed, ref in zip(seeds, refs):
        wb, x = chain_data(torch, cfg, G, P, torch.bfloat16, seed)
        before = dict(_build.LAUNCHES)
        out = shapenet_fwd_cuda(wb, x, cfg, "siren")
        got, want = _body_launches("shapenet_fwd", before, "tc")
        if got != want:
            raise AssertionError(f"the deep chain's K1 launched {got}, not one mma.sync K1")
        plain = shapenet_grouped_fused_reference(wb, x, cfg, "siren")
        was, torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32, True
        try:
            tf32 = shapenet_grouped_fused_reference(wb, x, cfg, "siren")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
        scale = float(plain.float().abs().max())
        rows.append([max_diff(torch, a, b, f"K1 deep chain seed {seed}")[0] / scale
                     for a, b in ((out, plain), (ref, plain), (out, ref), (tf32, plain))])
    rows = np.array(rows)
    bound = float(rows[:, 1].max())
    log(f"K1 deep plain chain {K1_DEEP_CHAIN} G={G} P={P} (mma.sync body), of max|plain|, a "
        f"seed each (seed: kernel vs plain / the reference vs plain / kernel vs the reference / "
        f"plain with cuBLAS TF32 products vs plain): "
        + "; ".join(f"{s}: {a:.4e} / {b:.4e} / {c:.4e} / {d:.4e}"
                    for s, (a, b, c, d) in zip(seeds, rows))
        + f"; medians {' / '.join(f'{v:.4e}' for v in np.median(rows, 0))}; largest "
        f"{' / '.join(f'{v:.4e}' for v in rows.max(0))}; bound (the reference's largest) "
        f"{bound:.4e}")
    if rows[:, 0].max() > bound:
        raise AssertionError("the deep chain's K1 departs from plain K1 further than the "
                             "reference's own largest gap")


def check_k2(torch, cfg, variant, G, P, dtype, weighted, seed, kernel=None,
             f32_bound=5e-6) -> float:
    """K2 vs plain K2; returns max |d_wb - plain d_wb|. The call launches one
    K2 on ``kernel`` ("wgmma", "tc" or "simt", through the private launcher
    that names it) or, by default, on the body ``k2_variant`` routes the
    chain to: a bfloat16 sine chain one of the tensor-core bodies, a float32
    or vanilla one the CUDA-core kernel.

    float32: loss rel 1e-5 and max|d| <= f32_bound max|plain| for d_wb (by
    default 5e-6, the JAX kernel test's bound at its shapes). bfloat16: loss
    rel BF16_LOSS_REL and max|d| <= BF16_REL max|plain|."""
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_shapenet import (
        _shapenet_mse_grads_on, k2_geometry, shapenet_mse_grads_cuda,
        shapenet_mse_grads_reference)

    wb, x = chain_data(torch, cfg, G, P, dtype, seed)
    tgt, w, _ = side_data(torch, cfg, G, P, seed)
    w = w if weighted else None
    geo = k2_geometry(cfg, variant, G, P, dtype, kernel=kernel)
    before = dict(_build.LAUNCHES)
    if kernel is None:
        loss, d_wb = shapenet_mse_grads_cuda(wb, x, tgt, cfg, variant, w)
    else:
        loss, d_wb = _shapenet_mse_grads_on(kernel, wb, x, tgt, cfg, variant, w)
    l_ref, g_ref = shapenet_mse_grads_reference(wb, x, tgt, cfg, variant, w)
    torch.cuda.synchronize()
    what = (f"K2 {describe(cfg, variant, G, P, dtype)} weighted={weighted} "
            f"({geo['kernel']} body{'' if kernel is None else ', named'})")
    tensor_cores = dtype == torch.bfloat16 and variant == "siren" and kernel != "simt"
    got, want = _body_launches("shapenet_mse_grads", before, geo["kernel"])
    if got != want or tensor_cores != (geo["kernel"] != "simt"):
        raise AssertionError(f"{what}: launched {got}, not {want}")
    if d_wb.dtype != wb.dtype or d_wb.shape != g_ref.shape or loss.dtype != torch.float32:
        raise AssertionError(f"{what}: {d_wb.shape}/{d_wb.dtype} vs {g_ref.shape}/{g_ref.dtype}")
    err, scale = max_diff(torch, d_wb, g_ref, what)
    l_rel = abs(float(loss) - float(l_ref)) / max(abs(float(l_ref)), 1e-30)
    bound, l_bound = (f32_bound, 1e-5) if dtype == torch.float32 else (BF16_REL, BF16_LOSS_REL)
    log(f"{what} loss {float(loss):.6e} (rel {l_rel:.2e}) d_wb max|d|={err:.3e} "
        f"max|plain|={scale:.3e} ({err / scale:.2e} of it); residuals in {geo['residuals']} "
        f"memory, {geo['splits']} splits of {geo['tile']}-point tiles")
    if not np.isfinite(float(loss)) or l_rel > l_bound or err > bound * scale:
        raise AssertionError(f"{what}: loss rel {l_rel} (bound {l_bound}), d_wb max|d| "
                             f"{err} > {bound} * {scale}")
    return err


def _wg_takes(torch, cfg, k3=False) -> bool:
    """Whether the wgmma K2 (``k3``: K3) body's geometry takes a bf16 sine
    chain (at G = 3, P = 200; its layout does not depend on G or P)."""
    from nif_tpu_torch.ops.fused_shapenet import _wg_status

    return _wg_status("backward" if k3 else "train", cfg, "siren", 3, 200)[0] == 0


def check_k2_bodies(torch, cfg, G, P, weighted, seed) -> dict:
    """The wgmma and the mma.sync K2 on the same bf16 inputs: each against
    plain K2 (``check_k2``), and their losses within TC_LOSS_REL of each
    other (each product is exact in both; only the order of the f32 sums
    differs). Returns ``{body: max |d_wb - plain d_wb|}``."""
    from nif_tpu_torch.ops.fused_shapenet import _shapenet_mse_grads_on

    errs = {body: check_k2(torch, cfg, "siren", G, P, torch.bfloat16, weighted, seed,
                           kernel=body) for body in ("wgmma", "tc")}
    wb, x = chain_data(torch, cfg, G, P, torch.bfloat16, seed)
    tgt, w, _ = side_data(torch, cfg, G, P, seed)
    w = w if weighted else None
    losses = [float(_shapenet_mse_grads_on(body, wb, x, tgt, cfg, "siren", w)[0])
              for body in ("wgmma", "tc")]
    rel = abs(losses[0] - losses[1]) / max(abs(losses[1]), 1e-30)
    log(f"K2 {describe(cfg, 'siren', G, P, torch.bfloat16)} weighted={weighted}: the wgmma "
        f"body's loss {losses[0]:.8e} against the mma.sync body's {losses[1]:.8e}, rel {rel:.2e}")
    if rel > TC_LOSS_REL:
        raise AssertionError(f"the wgmma and mma.sync K2 losses differ by {rel} > {TC_LOSS_REL}")
    return errs


def check_k3(torch, cfg, variant, G, P, dtype, seed, f32_bound=5e-6, kernel=None) -> float:
    """K3 vs plain K3 on d_wb and dx; returns max |d_wb - plain d_wb|. Each
    call must launch one K3 on ``kernel`` ("wgmma", "tc" or "simt", through
    the private launcher that names it) or, by default, the body
    ``k3_variant`` routes the chain to.

    float32: max|d| <= f32_bound max|plain| for d_wb and dx (by default
    5e-6, K2's bound at these shapes; 5e-5, the JAX package's bound for its
    fused backward, at the flagship's scale); bfloat16: BF16_REL."""
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_shapenet import (
        _shapenet_bwd_on, k3_geometry, shapenet_bwd_cuda, shapenet_fused_bwd_reference)

    wb, x = chain_data(torch, cfg, G, P, dtype, seed)
    g = side_data(torch, cfg, G, P, seed)[2].to(dtype)
    body = k3_geometry(cfg, variant, G, P, dtype, kernel=kernel)["kernel"]
    before = dict(_build.LAUNCHES)
    if kernel is None:
        d_wb, dx = shapenet_bwd_cuda(wb, x, g, cfg, variant)
    else:
        d_wb, dx = _shapenet_bwd_on(kernel, wb, x, g, cfg, variant)
    r_wb, r_dx = shapenet_fused_bwd_reference(wb, x, g, cfg, variant)
    torch.cuda.synchronize()
    what = f"K3 {describe(cfg, variant, G, P, dtype)} ({body})"
    got, want = _body_launches("shapenet_bwd", before, body)
    if got != want:
        raise AssertionError(f"{what}: launched {got}, not one {body} K3")
    if d_wb.dtype != wb.dtype or dx.dtype != x.dtype or dx.shape != x.shape:
        raise AssertionError(f"{what}: d_wb {d_wb.dtype}, dx {dx.shape}/{dx.dtype}")
    err, scale = max_diff(torch, d_wb, r_wb, what + " d_wb")
    e_dx, s_dx = max_diff(torch, dx, r_dx, what + " dx")
    bound = f32_bound if dtype == torch.float32 else BF16_REL
    log(f"{what} d_wb max|d|={err:.3e} ({err / scale:.2e} of max|plain|), dx max|d|="
        f"{e_dx:.3e} ({e_dx / s_dx:.2e} of max|plain|)")
    if err > bound * scale or e_dx > bound * s_dx:
        raise AssertionError(f"{what}: beyond {bound} of max|plain|")
    return err


def check_k5(torch, cfg, variant, G, P, dtype, seed, simt=False, body=None,
             kernel=None) -> float:
    """K5 vs plain K5 on y and jac; returns the larger max|d| of the two.
    The launch must take the kernel ``k5_variant`` picks (``simt``: the
    CUDA-core kernel on the same inputs, through its private launcher;
    ``kernel``: the body named, "wgmma", "tc" or "simt", likewise) and the
    body its geometry names: ``body`` where given, else the kernel's
    ("wgmma", "tc", or "simt"; the tangent body on the CUDA cores at si > 4,
    the first port's "stacked" one).

    float32: max|d| <= 2e-4 max|plain| + 1e-5 (K1's bound; both sum in f32
    in other orders); bfloat16: BF16_REL of max|plain| (the sweeps round
    each dz, the tangents each stacked input, to bf16)."""
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_derivatives import (
        _geometry, _shapenet_fwd_jac_on, k5_variant, shapenet_fwd_jac_cuda,
        shapenet_fwd_jac_reference)

    wb, x = chain_data(torch, cfg, G, P, dtype, seed)
    named = "simt" if simt else kernel
    kernel = named or k5_variant(dtype, cfg, variant)
    mode = "reverse" if cfg.output_dim < cfg.input_dim else "tangent"
    geo = _geometry(mode, cfg, variant, G, P, dtype, kernel=kernel)
    if body is None:
        body = "stacked" if kernel == "simt" and mode == "tangent" and cfg.input_dim > 4 else kernel
    before = dict(_build.LAUNCHES)
    if named is None:
        y, jac = shapenet_fwd_jac_cuda(wb, x, cfg, variant)
    else:
        y, jac = _shapenet_fwd_jac_on(named, wb, x, cfg, variant)
    y_ref, jac_ref = shapenet_fwd_jac_reference(wb, x, cfg, variant)
    torch.cuda.synchronize()
    what = f"K5 ({mode}) {describe(cfg, variant, G, P, dtype)}"
    got, want = _body_launches("shapenet_fwd_jac", before, kernel)
    if got != want or geo["body"] != body:
        raise AssertionError(f"{what}: launched {got}, not one {kernel} K5 on the {body} body "
                             f"(geometry {geo})")
    if y.dtype != dtype or jac.shape != (G, P, cfg.output_dim, cfg.input_dim):
        raise AssertionError(f"{what}: y {y.dtype}, jac {jac.shape}/{jac.dtype}")
    worst, rels = 0.0, []
    for name, out, ref in (("y", y, y_ref), ("jac", jac, jac_ref)):
        err, scale = max_diff(torch, out, ref, f"{what} {name}")
        bound = 2e-4 * scale + 1e-5 if dtype == torch.float32 else BF16_REL * scale
        if err > bound:
            raise AssertionError(f"{what}: {name} max|d| {err} > {bound}")
        worst = max(worst, err)
        rels.append(f"{name} {err / max(scale, 1e-30):.2e}")
    log(f"{what} y/jac agree; max|d| of max|plain|: {', '.join(rels)}; {kernel} kernel, "
        f"{describe_geometry(geo)}")
    return worst


def check_k5_bodies(torch, cfg, G, P, seed) -> dict:
    """The wgmma and the mma.sync K5 reverse body on the same bf16 inputs:
    each against plain K5 (``check_k5``), and y and jac against each other
    within BF16_REL of the mma.sync body's max|out|. Returns ``{body: the
    larger max|d| against plain}``."""
    from nif_tpu_torch.ops.fused_derivatives import _shapenet_fwd_jac_on

    errs = {body: check_k5(torch, cfg, "siren", G, P, torch.bfloat16, seed, kernel=body)
            for body in ("wgmma", "tc")}
    wb, x = chain_data(torch, cfg, G, P, torch.bfloat16, seed)
    outs = [_shapenet_fwd_jac_on(body, wb, x, cfg, "siren") for body in ("wgmma", "tc")]
    for i, name in enumerate(("y", "jac")):
        err, scale = max_diff(torch, outs[0][i], outs[1][i], f"K5 wgmma vs mma.sync {name}")
        log(f"K5 {describe(cfg, 'siren', G, P, torch.bfloat16)}: the wgmma body's {name} "
            f"against the mma.sync body's max|d| {err:.3e} ({err / scale:.2e} of its max|out|)")
        if err > BF16_REL * scale:
            raise AssertionError(f"the wgmma and mma.sync K5 {name} differ by {err} > "
                                 f"{BF16_REL} * {scale}")
    return errs


def check_k6(torch, cfg, variant, G, P, dtype, weighted, masked, seed, simt=False,
             chunk=None) -> float:
    """K6 vs plain K6; returns max |d_wb - plain d_wb|. A bfloat16 call on a
    sine chain must launch the tensor-core kernel (``simt``: the CUDA-core
    kernel on the same inputs, through its private launcher), a float32 or
    vanilla one the CUDA-core kernel.

    float32: both terms rel 1e-5, d_wb max|d| <= 5e-5 max|plain| (the fused
    backward's bound: the stacked backward sums (1 + si) times the rows);
    bfloat16: terms rel TC_LOSS_REL on the tensor-core kernel and
    BF16_LOSS_REL on the CUDA-core one, d_wb BF16_REL. ``chunk``: plain K6
    in chunks of that many groups (:func:`plain_k6_chunked`)."""
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_derivatives import (
        _geometry, _shapenet_sobolev_grads_simt, shapenet_sobolev_grads_cuda,
        shapenet_sobolev_grads_reference)

    wb, x = chain_data(torch, cfg, G, P, dtype, seed)
    tgt, w, jt = sobolev_data(torch, cfg, G, P, seed)
    si, so = cfg.input_dim, cfg.output_dim
    kw = dict(w_value=0.7, w_jac=1.3, weight=w if weighted else None)
    if masked:
        kw.update(y_mask=np.eye(1, so, dtype=np.float32)[0],
                  jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32))
    before = dict(_build.LAUNCHES)
    launch = _shapenet_sobolev_grads_simt if simt else shapenet_sobolev_grads_cuda
    lv, lj, d_wb = launch(wb, x, tgt, jt, cfg, variant, **kw)
    if chunk:
        (rv, rj), r_wb = plain_k6_chunked(torch, wb, x, tgt, jt, cfg, chunk, **kw)
    else:
        rv, rj, r_wb = shapenet_sobolev_grads_reference(wb, x, tgt, jt, cfg, variant, **kw)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16 and variant == "siren" and not simt)
    what = (f"K6 {describe(cfg, variant, G, P, dtype)} weighted={weighted} masked={masked}"
            f"{' (CUDA-core kernel)' if simt else ''}")
    if (_build.LAUNCHES["shapenet_sobolev_grads"] != before["shapenet_sobolev_grads"] + 1
            or _build.LAUNCHES["shapenet_sobolev_grads_tc"]
            != before["shapenet_sobolev_grads_tc"] + tc):
        raise AssertionError(f"{what}: launched {_build.LAUNCHES} after {before}")
    if d_wb.dtype != wb.dtype or d_wb.shape != r_wb.shape:
        raise AssertionError(f"{what}: {d_wb.shape}/{d_wb.dtype} vs {r_wb.shape}")
    err, scale = max_diff(torch, d_wb, r_wb, what)
    rels = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-30) for a, b in ((lv, rv), (lj, rj))]
    bound, l_bound = ((5e-5, 1e-5) if dtype == torch.float32 else
                      (BF16_REL, TC_LOSS_REL if tc else BF16_LOSS_REL))
    geo = _geometry("sobolev", cfg, variant, G, P, dtype, kernel="simt" if simt else None)
    log(f"{what} value {float(lv):.6e} jac {float(lj):.6e} (rel {rels[0]:.2e}, {rels[1]:.2e}) "
        f"d_wb max|d|={err:.3e} ({err / scale:.2e} of max|plain|); {geo['kernel']} kernel, "
        f"{geo['tile']}-point tiles, residuals in {geo['residuals']} memory, weights from "
        f"{geo['weights']} memory, {geo['splits']} splits")
    if (not all(np.isfinite([float(lv), float(lj)])) or max(rels) > l_bound
            or err > bound * scale):
        raise AssertionError(f"{what}: term rel {rels} (bound {l_bound}), d_wb max|d| {err} > "
                             f"{bound} * {scale}")
    return err


def plain_k6_chunked(torch, wb, x, tgt, jt, cfg, chunk=8, **kw):
    """Plain K6 over [G, P] in chunks of ``chunk`` groups (as
    :func:`plain_k8_chunked`): each group's d_wb is its own, scaled by chunk
    / G to the whole batch's mean, and the terms are the means of the
    chunks'; point weights ``weight`` [G, P] are cut with the groups."""
    from nif_tpu_torch.ops.fused_derivatives import shapenet_sobolev_grads_reference

    G = x.shape[0]
    w = kw.pop("weight", None)
    parts = [shapenet_sobolev_grads_reference(wb[s:s + chunk], x[s:s + chunk],
                                              tgt[s:s + chunk], jt[s:s + chunk], cfg, "siren",
                                              weight=None if w is None else w[s:s + chunk], **kw)
             for s in range(0, G, chunk)]
    terms = [sum(p[i] for p in parts) / len(parts) for i in range(2)]
    return terms, torch.cat([p[2] for p in parts]) * (chunk / G)


def check_k7(torch, cfg, variant, G, P, dtype, seed, simt=False, chunk=None, body=None) -> float:
    """K7 vs plain K7 on y, jac and hess; returns the largest max|d| of the
    three. A bfloat16 call must launch the tensor-core body ``k7_variant``
    routes the chain to (``body``: that body by name; ``simt``: the
    CUDA-core kernel on the same inputs, through its private launcher), a
    float32 one the CUDA-core kernel. The Hessian must be exactly symmetric.
    Bounds as K5's: float32 max|d| <= 2e-4 max|plain| + 1e-5, bfloat16
    BF16_REL of max|plain|. ``chunk``: plain K7 in chunks of that many
    groups (a flagship batch's stacked tensors would not fit the card)."""
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_hessian import (
        _shapenet_fwd_hess_on, hessian_geometry, k7_variant, shapenet_fwd_hess_reference)

    body = "simt" if simt else (body or k7_variant(dtype, cfg, variant))
    wb, x = chain_data(torch, cfg, G, P, dtype, seed)
    before = dict(_build.LAUNCHES)
    outs = _shapenet_fwd_hess_on(body, wb, x, cfg, variant)
    if chunk:
        refs = [torch.cat(parts) for parts in zip(*plain_k7_chunked(torch, wb, x, cfg, chunk))]
    else:
        refs = shapenet_fwd_hess_reference(wb, x, cfg, variant)
    torch.cuda.synchronize()
    what = f"K7 {describe(cfg, variant, G, P, dtype)} ({body} body)"
    got, want = _body_launches("shapenet_fwd_hess", before, body)
    if got != want:
        raise AssertionError(f"{what}: launched {got}, not {want}")
    si, so = cfg.input_dim, cfg.output_dim
    if outs[2].shape != (G, P, so, si, si) or any(o.dtype != dtype for o in outs):
        raise AssertionError(f"{what}: hess {outs[2].shape}/{outs[2].dtype}")
    if not torch.equal(outs[2], outs[2].transpose(-1, -2)):
        raise AssertionError(f"{what}: the Hessian is not exactly symmetric")
    worst, rels = 0.0, []
    for name, out, ref in zip(("y", "jac", "hess"), outs, refs):
        err, scale = max_diff(torch, out, ref, f"{what} {name}")
        bound = 2e-4 * scale + 1e-5 if dtype == torch.float32 else BF16_REL * scale
        if err > bound:
            raise AssertionError(f"{what}: {name} max|d| {err} > {bound}")
        worst = max(worst, err)
        rels.append(f"{name} {err / max(scale, 1e-30):.2e}")
    geo = hessian_geometry("eval", cfg, variant, G, P, dtype, kernel=body)
    log(f"{what} y/jac/hess agree, hess symmetric; max|d| of max|plain|: {', '.join(rels)}; "
        f"{geo['kernel']} kernel, {geo['tile']}-point tiles, weights from {geo['weights']} "
        f"memory, {geo['splits']} splits")
    return worst


def hessian_data(torch, cfg, G, P, seed):
    """Value targets, point weights, flat Jacobian and flat unique-pair
    Hessian targets, float32 on the card."""
    rng = np.random.default_rng(seed + 3000)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    si, so = cfg.input_dim, cfg.output_dim
    return (to(rng.standard_normal((G, P, so))), to(rng.uniform(0.5, 1.5, (G, P))),
            to(rng.standard_normal((G, P, si * so))),
            to(rng.standard_normal((G, P, si * (si + 1) // 2 * so))))


def check_k8(torch, cfg, variant, G, P, dtype, weighted, masked, seed, chunk=None,
             body=None) -> float:
    """K8 vs plain K8; returns max |d_wb - plain d_wb|. A bfloat16 call must
    launch the tensor-core body ``k8_variant`` routes the chain to (``body``:
    that body by name), a float32 one the CUDA-core kernel.

    float32: the three terms rel 1e-5, d_wb max|d| <= 1e-4 max|plain| (the
    JAX package's bound for its fused Hessian train pass: the backward sums
    ten times the rows at si = 3); bfloat16: terms rel BF16_LOSS_REL, d_wb
    BF16_REL. ``chunk``: plain K8 in chunks of that many groups
    (:func:`plain_k8_chunked`)."""
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_hessian import (
        _shapenet_hessian_grads_on, hessian_geometry, k8_variant, shapenet_hessian_grads_reference)

    body = body or k8_variant(dtype, cfg, variant)
    wb, x = chain_data(torch, cfg, G, P, dtype, seed)
    tgt, w, jt, ht = hessian_data(torch, cfg, G, P, seed)
    si, so = cfg.input_dim, cfg.output_dim
    kw = dict(w_value=0.7, w_jac=1.3, w_hess=0.4, weight=w if weighted else None)
    if masked:
        kw.update(y_mask=np.eye(1, so, dtype=np.float32)[0],
                  jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32),
                  hess_mask=(np.arange(si * (si + 1) // 2 * so) % 3 != 1).astype(np.float32))
    before = dict(_build.LAUNCHES)
    *terms, d_wb = _shapenet_hessian_grads_on(body, wb, x, tgt, jt, ht, cfg, variant, **kw)
    if chunk:
        refs, r_wb = plain_k8_chunked(torch, wb, x, tgt, jt, ht, cfg, chunk, **kw)
    else:
        *refs, r_wb = shapenet_hessian_grads_reference(wb, x, tgt, jt, ht, cfg, variant, **kw)
    torch.cuda.synchronize()
    what = (f"K8 {describe(cfg, variant, G, P, dtype)} weighted={weighted} masked={masked} "
            f"({body} body)")
    got, want = _body_launches("shapenet_hessian_grads", before, body)
    if got != want:
        raise AssertionError(f"{what}: launched {got}, not {want}")
    if d_wb.dtype != wb.dtype or d_wb.shape != r_wb.shape:
        raise AssertionError(f"{what}: {d_wb.shape}/{d_wb.dtype} vs {r_wb.shape}")
    err, scale = max_diff(torch, d_wb, r_wb, what)
    rels = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-30) for a, b in zip(terms, refs)]
    bound, l_bound = (1e-4, 1e-5) if dtype == torch.float32 else (BF16_REL, BF16_LOSS_REL)
    geo = hessian_geometry("train", cfg, variant, G, P, dtype, kernel=body)
    log(f"{what} terms {[f'{float(v):.6e}' for v in terms]} (rel "
        f"{', '.join(f'{r:.2e}' for r in rels)}) d_wb max|d|={err:.3e} ({err / scale:.2e} of "
        f"max|plain|); {geo['kernel']} kernel, {geo['tile']}-point tiles, residuals in "
        f"{geo['residuals']} memory, weights from {geo['weights']} memory, {geo['splits']} "
        f"splits")
    if (not all(np.isfinite([float(v) for v in terms])) or max(rels) > l_bound
            or err > bound * scale):
        raise AssertionError(f"{what}: term rel {rels} (bound {l_bound}), d_wb max|d| {err} > "
                             f"{bound} * {scale}")
    return err


def plain_k8_chunked(torch, wb, x, tgt, jt, ht, cfg, chunk=8, **kw):
    """Plain K8 over [G, P] in chunks of ``chunk`` groups (its f32 stacked
    tensors of a whole flagship batch would not fit the card): each group's
    d_wb is its own, scaled by chunk / G to the whole batch's mean, and the
    terms are the means of the chunks' (equal chunks); point weights
    ``weight`` [G, P] are cut with the groups."""
    from nif_tpu_torch.ops.fused_hessian import shapenet_hessian_grads_reference

    G = x.shape[0]
    w = kw.pop("weight", None)
    parts = [shapenet_hessian_grads_reference(wb[s:s + chunk], x[s:s + chunk],
                                              tgt[s:s + chunk], jt[s:s + chunk],
                                              ht[s:s + chunk], cfg, "siren",
                                              weight=None if w is None else w[s:s + chunk], **kw)
             for s in range(0, G, chunk)]
    terms = [sum(p[i] for p in parts) / len(parts) for i in range(3)]
    return terms, torch.cat([p[3] for p in parts]) * (chunk / G)


def plain_k7_chunked(torch, wb, x, cfg, chunk=8):
    """Plain K7 over [G, P] in chunks of ``chunk`` groups."""
    from nif_tpu_torch.ops.fused_hessian import shapenet_fwd_hess_reference

    return [shapenet_fwd_hess_reference(wb[s:s + chunk], x[s:s + chunk], cfg, "siren")
            for s in range(0, x.shape[0], chunk)]


def hessian_step_stages(torch, trainer, state, batch):
    """The flagship Hessian step's stages, each timed alone with CUDA events
    (ms): the input casts, the ParameterNet forward, the Hessian target
    preparation, K8's wrapper, the ParameterNet backward and the Adam
    update (as ``scripts/port_train_profile.py --hessian`` splits it)."""
    from nif_tpu_torch.ops.fused_hessian import shapenet_hessian_grads
    from nif_tpu_torch.utils.bench import cuda_ms

    model = trainer.model
    t, x, u, jt, ht = batch
    G, P = x.shape[:2]
    params = [p for _, p in model.param_items()]
    tc, xc = model._compute(t), model._compute(x)
    wb, _ = model.pnet(tc)
    ht_flat = model._hessian_targets(ht, G, P, 3, 1, np.arange(1), np.arange(3), True, None)[0]
    jt_flat = jt.transpose(2, 3).reshape(G, P, 3)  # column k*so + j
    kernel = lambda: shapenet_hessian_grads(  # noqa: E731
        wb, xc, u, jt_flat, ht_flat, model.cfg_shape_net, "siren", w_jac=trainer.w_jac,
        w_hess=trainer.w_hess)
    d_wb = kernel()[3]
    grads = torch.autograd.grad(wb, params, d_wb, retain_graph=True)

    def adam():
        for p, g in zip(params, grads):
            p.grad = g
        state.opt_state.step()

    stages = {
        "cast t, x": lambda: (model._compute(t), model._compute(x)),
        "ParameterNet forward": lambda: model.pnet(tc),
        "Hessian targets": lambda: model._hessian_targets(ht, G, P, 3, 1, np.arange(1),
                                                          np.arange(3), True, None),
        "K8 wrapper": kernel,
        "ParameterNet backward": lambda: torch.autograd.grad(wb, params, d_wb,
                                                             retain_graph=True),
        "Adam update": adam,
    }
    return {k: cuda_ms(f, reps=3, warmup=1) for k, f in stages.items()}


def sobolev_step_stages(torch, trainer, state, batch):
    """The flagship Sobolev step's stages, each timed alone with CUDA events
    (ms): the input casts, the ParameterNet forward, K6's wrapper, the
    ParameterNet backward and the Adam update (as
    ``scripts/port_train_profile.py --sobolev`` splits it)."""
    from nif_tpu_torch.ops.fused_derivatives import shapenet_sobolev_grads
    from nif_tpu_torch.utils.bench import cuda_ms

    model = trainer.model
    t, x, u, jt = batch
    G, P = x.shape[:2]
    params = [p for _, p in model.param_items()]
    tc, xc = model._compute(t), model._compute(x)
    wb, _ = model.pnet(tc)
    jt_flat = jt.transpose(2, 3).reshape(G, P, 3)  # column k*so + j
    kernel = lambda: shapenet_sobolev_grads(  # noqa: E731
        wb, xc, u, jt_flat, model.cfg_shape_net, "siren", w_value=trainer.w_value,
        w_jac=trainer.w_jac)
    d_wb = kernel()[2]
    grads = torch.autograd.grad(wb, params, d_wb, retain_graph=True)

    def adam():
        for p, g in zip(params, grads):
            p.grad = g
        state.opt_state.step()

    stages = {
        "cast t, x": lambda: (model._compute(t), model._compute(x)),
        "ParameterNet forward": lambda: model.pnet(tc),
        "K6 wrapper": kernel,
        "ParameterNet backward": lambda: torch.autograd.grad(wb, params, d_wb,
                                                             retain_graph=True),
        "Adam update": adam,
    }
    return {k: cuda_ms(f, reps=5, warmup=1) for k, f in stages.items()}


def linear_step_stages(torch, trainer, state, batch):
    """The flagship NIF-linear step's stages, each timed alone with CUDA
    events (ms): the input casts, the ParameterNet forward (t -> a), K4's
    wrapper, the ParameterNet backward (d_a -> grads) and the Adam update
    (as ``scripts/port_train_profile.py --linear`` splits it)."""
    from nif_tpu_torch.ops.fused_linear import niflinear_mse_grads
    from nif_tpu_torch.utils.bench import cuda_ms

    model = trainer.model
    t, x, u = batch
    params = [p for _, p in model.param_items()]
    tc, xc = model._compute(t), model._compute(x)
    a, _ = model.pnet(tc)
    ws, bs = model._trunk_lists()
    ws, bs = [w.detach().to(xc.dtype) for w in ws], [b.detach().to(xc.dtype) for b in bs]
    bias = model.snet.bias.detach().to(xc.dtype)
    kernel = lambda: niflinear_mse_grads(  # noqa: E731
        ws, bs, a, bias, xc, u, model._trunk_cfg, model.so_dim)
    d_a = kernel()[3]
    pnet = list(model.pnet.params.parameters())
    grads = torch.autograd.grad(a, pnet, d_a, retain_graph=True)
    grads = grads + tuple(torch.zeros_like(p) for p in params[len(pnet):])

    def adam():
        for p, g in zip(params, grads):
            p.grad = g
        state.opt_state.step()

    stages = {
        "cast t, x": lambda: (model._compute(t), model._compute(x)),
        "ParameterNet forward": lambda: model.pnet(tc),
        "K4 wrapper": kernel,
        "ParameterNet backward": lambda: torch.autograd.grad(a, pnet, d_a, retain_graph=True),
        "Adam update": adam,
    }
    return {k: cuda_ms(f, reps=10, warmup=2) for k, f in stages.items()}


def mse_step_stages(torch, trainer, state, batch):
    """The flagship MSE step's stages, each timed alone with CUDA events
    (ms): the input casts, the ParameterNet forward, K2's wrapper, the
    ParameterNet backward and the Adam update (as
    ``scripts/port_train_profile.py`` splits it)."""
    from nif_tpu_torch.ops.fused_shapenet import shapenet_mse_grads
    from nif_tpu_torch.utils.bench import cuda_ms

    model = trainer.model
    t, x, u = batch
    params = [p for _, p in model.param_items()]
    tc, xc = model._compute(t), model._compute(x)
    wb, _ = model.pnet(tc)
    kernel = lambda: shapenet_mse_grads(wb, xc, u, model.cfg_shape_net, "siren")  # noqa: E731
    d_wb = kernel()[1]
    grads = torch.autograd.grad(wb, params, d_wb, retain_graph=True)

    def adam():
        for p, g in zip(params, grads):
            p.grad = g
        state.opt_state.step()

    stages = {
        "cast t, x": lambda: (model._compute(t), model._compute(x)),
        "ParameterNet forward": lambda: model.pnet(tc),
        "K2 wrapper": kernel,
        "ParameterNet backward": lambda: torch.autograd.grad(wb, params, d_wb,
                                                             retain_graph=True),
        "Adam update": adam,
    }
    return {k: cuda_ms(f, reps=10, warmup=2) for k, f in stages.items()}


def linear_data(torch, case, G, P, dtype, seed):
    """K4's inputs from a LINEAR_CASES entry: the trunk config, so, the
    chain-order weights and biases (SIREN-regime, 0.3/omega_0), a [G, K],
    bias [so] and x in ``dtype``, targets and point weights in float32, made
    with numpy from a seed, on the card."""
    from nif_tpu_torch.config import ShapeNetConfig

    si, so, K, n, l, res, om = case
    cfg = ShapeNetConfig(si, so * K, n, l, "sine", res, om)
    n_mats = 2 * l if res else l
    rng = np.random.default_rng(seed + 4000)
    to = lambda a, dt=dtype: torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)  # noqa: E731
    ws = [to(rng.standard_normal(s) * (0.3 / om))
          for s in [(si, n)] + [(n, n)] * n_mats + [(n, so * K)]]
    bs = [to(rng.standard_normal(s) * (0.3 / om)) for s in [(n,)] * (n_mats + 1) + [(so * K,)]]
    return (cfg, so, ws, bs, to(rng.standard_normal((G, K)) * 0.5),
            to(rng.standard_normal(so) * 0.1), to(rng.standard_normal((G, P, si))),
            to(rng.standard_normal((G, P, so)), torch.float32),
            to(rng.uniform(0.5, 1.5, (G, P)), torch.float32))


def k4_outputs(out):
    """K4's ``(loss, d_ws, d_bs, d_a, d_bias)`` as one flat list."""
    return [out[0], *out[1], *out[2], out[3], out[4]]


def check_k4(torch, case, G, P, dtype, weighted, seed) -> float:
    """K4 vs plain K4; returns the largest max|d| over its gradients. A
    bfloat16 call must launch the tensor-core kernel, a float32 one the
    CUDA-core kernel only.

    float32: loss rel 1e-5 and every gradient max|d| <= 5e-5 of its
    max|plain| (the JAX package's bound for its fused NIF-linear kernel: the
    trunk grads sum over every group); bfloat16: loss rel BF16_LOSS_REL and
    BF16_REL of max|plain|."""
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_linear import (
        linear_geometry, niflinear_mse_grads_cuda, niflinear_mse_grads_reference)

    cfg, so, ws, bs, a, bias, x, tgt, w = linear_data(torch, case, G, P, dtype, seed)
    w = w if weighted else None
    before = dict(_build.LAUNCHES)
    outs = k4_outputs(niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt, cfg, so, w))
    tc = _build.LAUNCHES["niflinear_mse_grads_tc"] - before["niflinear_mse_grads_tc"]
    if (_build.LAUNCHES["niflinear_mse_grads"] - before["niflinear_mse_grads"] != 1
            or tc != (dtype == torch.bfloat16)):
        raise AssertionError(f"K4 in {dtype} launched {_build.LAUNCHES} (before {before})")
    refs = k4_outputs(niflinear_mse_grads_reference(ws, bs, a, bias, x, tgt, cfg, so, w))
    torch.cuda.synchronize()
    what = (f"K4 si={cfg.input_dim} so={so} K={cfg.output_dim // so} n={cfg.units} "
            f"l={cfg.nlayers} res={cfg.use_resblock} G={G} P={P} {str(dtype):14s} "
            f"weighted={weighted}")
    bound, l_bound = (5e-5, 1e-5) if dtype == torch.float32 else (BF16_REL, BF16_LOSS_REL)
    l_rel = abs(float(outs[0]) - float(refs[0])) / max(abs(float(refs[0])), 1e-30)
    worst, worst_rel = 0.0, 0.0
    for out, ref in zip(outs[1:], refs[1:]):
        if out.dtype != torch.float32 or out.shape != ref.shape:
            raise AssertionError(f"{what}: {out.shape}/{out.dtype} vs {ref.shape}")
        err, scale = max_diff(torch, out, ref, what)
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / max(scale, 1e-30))
        if err > bound * scale + 1e-12:
            raise AssertionError(f"{what}: a gradient's max|d| {err} > {bound} * {scale}")
    geo = linear_geometry(cfg, so, G, P, dtype)
    grid = f"{geo['blocks']} blocks" if "blocks" in geo else f"{geo['splits']} splits"
    log(f"{what} loss {float(outs[0]):.6e} (rel {l_rel:.2e}) grads worst max|d|={worst:.3e} "
        f"({worst_rel:.2e} of max|plain|); {geo['variant']} kernel, residuals in "
        f"{geo['residuals']} memory, {grid} of {geo['tile']}-point tiles")
    if not np.isfinite(float(outs[0])) or l_rel > l_bound:
        raise AssertionError(f"{what}: loss rel {l_rel} (bound {l_bound})")
    return worst


def kernel_bound(kernel, cfg, G, P, peaks, f32=False, **kw):
    """(bound ms, bound_by, products GFLOP) of ``kernel`` ("K1" ... "K8") at
    this shape, from ``nif_tpu_torch.utils.roofline``'s count."""
    from nif_tpu_torch.utils.roofline import kernel_bound_ms, kernel_cost

    cost = kernel_cost(kernel, cfg, G, P, f32=f32, **kw)
    return (*kernel_bound_ms(cost, peaks, f32), cost["products"] / 1e9)


def log_step_report(what, model, G, P, step_ms, f32, smi):
    """One ``nif_tpu_torch.utils.roofline.step_report`` line of a measured
    step of ``model`` at G x P points: points/s, TFLOP/s and ``mfu`` against
    the card's published bf16 tensor-core peak (``f32``: its f32 peak), with
    the card's name and power limit."""
    from nif_tpu_torch.utils.roofline import card_peaks, step_report

    peak = card_peaks()[1 if f32 else 0] / 1e12
    r = step_report(model.cfg_shape_net, model.cfg_parameter_net, G, P, step_ms / 1e3,
                    peak_tflops=peak)
    log(f"step_report {what} (G={G} P={P}, {step_ms:.4f} ms a step on the device clock): "
        f"{r['points_per_sec']:.4e} points/s, {r['tflops_per_sec']:.4f} TFLOP/s, mfu "
        f"{r['mfu']:.4f} of the published {peak:.0f} TFLOP/s "
        f"{'f32' if f32 else 'bf16 tensor-core'} peak (ParameterNet "
        f"{r['pnet_fraction']:.4f} of the FLOPs; card {smi})")


def sobolev_data(torch, cfg, G, P, seed):
    """Value targets, point weights and flat Jacobian targets, float32 on the card."""
    rng = np.random.default_rng(seed + 2000)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    si, so = cfg.input_dim, cfg.output_dim
    return (to(rng.standard_normal((G, P, so))), to(rng.uniform(0.5, 1.5, (G, P))),
            to(rng.standard_normal((G, P, si * so))))


def build_all(names):
    """Build every kernel source at once, one nvcc each; returns seconds
    per name. Raises the first build failure."""
    from nif_tpu_torch.ops import _build

    secs, errors = {}, []

    def one(name):
        t0 = time.perf_counter()
        try:
            _build.build(name)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    for name in names:
        log(f"build {name}: {secs[name]:.1f} s")
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    return secs


def bf16_body_counter(base: str, cfg=None) -> str:
    """The launch counter of the bf16 body that K1 (``base``
    "shapenet_fwd"), K2 ("shapenet_mse_grads"), K3 ("shapenet_bwd") or K5
    ("shapenet_fwd_jac"), K7 ("shapenet_fwd_hess") or K8
    ("shapenet_hessian_grads") takes for ``cfg``, by default a flagship-width
    sine chain, which every model this script serves, trains or
    differentiates in bf16 is: ``base + "_wg"`` on the wgmma body, ``base +
    "_tc"`` on the ``mma.sync`` body (K5's tangent body too), as
    ``k1_variant``, ``k2_variant``, ``k3_variant``, ``k5_variant``,
    ``k7_variant`` or ``k8_variant`` route it (they ask the built
    libraries)."""
    import torch

    from nif_tpu_torch.config import ShapeNetConfig
    from nif_tpu_torch.ops.fused_derivatives import k5_variant
    from nif_tpu_torch.ops.fused_hessian import k7_variant, k8_variant
    from nif_tpu_torch.ops.fused_shapenet import k1_variant, k2_variant, k3_variant
    from nif_tpu_torch.utils.bench import FLAGSHIP_SHAPE

    pick = {"shapenet_fwd": k1_variant, "shapenet_mse_grads": k2_variant,
            "shapenet_bwd": k3_variant, "shapenet_fwd_jac": k5_variant,
            "shapenet_fwd_hess": k7_variant, "shapenet_hessian_grads": k8_variant}[base]
    cfg = cfg or ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    body = pick(torch.bfloat16, cfg, "siren")
    return base + {"wgmma": "_wg", "tc": "_tc"}[body]


def tutorial8_data(G, P, seed):
    """Host arrays of tutorial 8's shapes: parameters t [G, 1], coordinates
    x [G, P, 1] in [-1, 1], values u [G, P, 1] and Jacobian targets
    [G, P, 1, 1] of a traveling wave u = sin(pi (x - t))."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 1, (G, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 1)).astype(np.float32)
    a = np.pi * (x - t[:, None, :])
    return t, x, np.sin(a).astype(np.float32), (np.pi * np.cos(a))[..., None].astype(np.float32)


def traveling_wave(G, P, seed):
    """A smooth field u = sin(pi (x0 - t/2)) cos(pi x1 / 2) on x in [-1, 1]^3
    at G times t in [0, 1] (t is the first of the 4 parameters)."""
    rng = np.random.default_rng(seed)
    ts = np.linspace(0.0, 1.0, G)
    t = np.stack([ts, np.zeros(G), np.zeros(G), np.zeros(G)], 1).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)
    u = np.sin(np.pi * (x[..., :1] - 0.5 * ts[:, None, None])) * np.cos(0.5 * np.pi * x[..., 1:2])
    return t, x, u.astype(np.float32)


def wave_jacobian(t, x):
    """d u / d x of :func:`traveling_wave`, ``[G, P, 1, 3]``."""
    a = np.pi * (x[..., 0] - 0.5 * t[:, None, 0])
    b = 0.5 * np.pi * x[..., 1]
    jac = np.stack([np.pi * np.cos(a) * np.cos(b), -0.5 * np.pi * np.sin(a) * np.sin(b),
                    np.zeros_like(a)], axis=-1)
    return jac[:, :, None, :].astype(np.float32)


def wave_hessian(t, x):
    """d2 u / dx2 of :func:`traveling_wave`, ``[G, P, 1, 3, 3]``."""
    a = np.pi * (x[..., 0] - 0.5 * t[:, None, 0])
    b = 0.5 * np.pi * x[..., 1]
    h = np.zeros(x.shape[:2] + (3, 3))
    h[..., 0, 0] = -np.pi ** 2 * np.sin(a) * np.cos(b)
    h[..., 0, 1] = h[..., 1, 0] = -0.5 * np.pi ** 2 * np.cos(a) * np.sin(b)
    h[..., 1, 1] = -0.25 * np.pi ** 2 * np.sin(a) * np.cos(b)
    return h[:, :, None].astype(np.float32)


# The resident dataset of phases 3g and 4f: the flagship's inputs at G=64
# groups of P=65536 points (x 50.3 MB and u 16.8 MB of float32), trained at
# the flagship step shape, 32 groups of 32768 points, drawn on the device.
RESIDENT_G, RESIDENT_P = 64, 65536
RESIDENT_GB, RESIDENT_PB = 32, 32768
# The main kernels of each fused pass as a torch.profiler trace names them,
# (tensor-core bodies, CUDA-core); the CUDA-core K3 shares K2's CUDA-core
# kernel, so a CUDA-core K2 count above the replays would be a K3.
PASS_KERNELS = {
    "K1": (("fwd_tc_kernel", "fwd_wg_kernel"), "fwd_simt_kernel"),
    "K2": (("mse_tc_kernel", "mse_wg_kernel"), "simt_train_kernel"),
    "K3": (("bwd_tc_kernel", "bwd_wg_kernel"), None),
    "K6": (("sob_tc_kernel",), "sob_simt_kernel"),
    "K8": (("hess_tc_kernel", "hess_wg_kernel"), "hess_simt_kernel"),
}


def device_kernels(prof):
    """``[(name, count, device us)]`` of the device kernels in a
    ``torch.profiler`` trace: a CPU op's self device time repeats its
    kernels', and a user annotation spans them, so both are left out."""
    return [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def device_ms(torch, fn, n: int):
    """``fn()`` ``n`` times under ``torch.profiler``: ``(device ms a call,
    kernels a call)``, summed over the device kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    return sum(us for _, _, us in kernels) / n / 1e3, sum(c for _, c, _ in kernels) / n


def kernel_count(kernels, name: str) -> int:
    """Launches of the kernel called ``name`` (the whole identifier: K7's
    fwd_hess_tc_kernel is no hess_tc_kernel) among ``device_kernels``."""
    import re

    pattern = re.compile(r"(^|[^A-Za-z0-9_])" + name + r"([^A-Za-z0-9_]|$)")
    return sum(c for k, c, _ in kernels if pattern.search(k))


def pass_counts(kernels):
    """``{"K1": (tc, simt), ...}``: launches of each pass's tensor-core
    kernels (the wgmma and mma.sync bodies together) and its CUDA-core one."""
    return {p: (sum(kernel_count(kernels, n) for n in tcs),
                kernel_count(kernels, simt) if simt else 0)
            for p, (tcs, simt) in PASS_KERNELS.items()}


def profiled_fit(torch, trainer, state, *args, **kw):
    """One ``trainer.fit_resident(state, *args, **kw)`` call alone under
    ``torch.profiler``, the launch counts reset just before it and read just
    after: ``(state, device kernels, wrapper launch counts)``."""
    from nif_tpu_torch.ops import _build

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _build.reset_launches()
        state = trainer.fit_resident(state, *args, **kw)
        launches = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
    return state, device_kernels(prof), launches


def check_resident_launches(what, history, kernels, launches, pass_name, wrapper, steps, tc):
    """A ``profiled_fit`` call went through ``pass_name``'s kernel once a
    step (the tensor-core one when ``tc``) and through no other fused pass,
    and its wrapper launched once in the eager first step and once a
    capture (``history["resident_capture_ms"]`` lists the captures).
    Returns the pass counts."""
    counts = pass_counts(kernels)
    captures = len(history["resident_capture_ms"])
    others = {p: c for p, c in counts.items() if p != pass_name}
    if (counts[pass_name] != ((steps, 0) if tc else (0, steps))
            or any(sum(c) for c in others.values())
            or launches[wrapper] != 1 + captures):
        raise AssertionError(f"{what}: {steps} resident steps launched {counts} in the trace, "
                             f"{wrapper} {launches[wrapper]} times with {captures} captures")
    return counts


def profile_replays(torch, trainer, state, data, n):
    """Phase 4f's measure of the replays alone: the resident loop's eager
    first step and its capture (with one replay), then ``n`` replays under
    ``torch.profiler``: ``(kernels, busy share of the window, window ms)``,
    the window timed by CUDA events and the busy time summed over the device
    kernels."""
    from nif_tpu_torch.training.resident import ResidentLoop

    loop = ResidentLoop(trainer, state.opt_state, data, n + 2)
    loop.run(1)
    loop.run(1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        a.record()
        loop.run(n)
        b.record()
        torch.cuda.synchronize()
    losses = loop.losses(0, n + 2)
    loop.close()
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"resident losses {losses}")
    kernels = device_kernels(prof)
    window_ms = a.elapsed_time(b)
    return kernels, sum(us for _, _, us in kernels) / (window_ms * 1e3), window_ms


def resident_trainer(torch, policy, seed, capturable=True, adamw=False, **weights):
    """The flagship model (random weights from ``seed``) under a
    ``GroupedTrainer`` with Adam (``adamw``: AdamW with weight decay 1e-2) at
    the bench's lr: ``(trainer, state)``."""
    import nif_tpu_torch
    from nif_tpu_torch.training import GroupedTrainer
    from nif_tpu_torch.utils.bench import FLAGSHIP_PNET, FLAGSHIP_SHAPE, FLAGSHIP_TRAIN_LR

    model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, policy, device="cuda",
                                        seed=seed)
    if adamw:
        make = lambda p: torch.optim.AdamW(  # noqa: E731
            p, lr=FLAGSHIP_TRAIN_LR, weight_decay=1e-2, capturable=capturable)
    else:
        make = lambda p: torch.optim.Adam(  # noqa: E731
            p, lr=FLAGSHIP_TRAIN_LR, capturable=capturable)
    trainer = GroupedTrainer(model, make, **weights)
    return trainer, trainer.init(seed)


def resident_matches_eager(torch, policy, data_np, capturable, schedule=None, adamw=False,
                           epochs=3):
    """``fit_resident`` (the CUDA graph, alone under ``profiled_fit``)
    against a loop of ``GroupedTrainer.step`` on a copy of the model over
    the same batches, re-drawn from the same seed after the fit: ``(same
    losses, same parameters and learning rates, history, eager losses,
    kernels, launches)``, each "same" bit for bit."""
    from nif_tpu_torch.training import LearningRateScheduler
    from nif_tpu_torch.training.resident import ResidentData

    t, x, u = data_np
    seed = 11
    trainer, state = resident_trainer(torch, policy, 5, capturable, adamw)
    callbacks = [LearningRateScheduler(schedule)] if schedule else []
    state, kernels, launches = profiled_fit(
        torch, trainer, state, t, x, u, epochs=epochs, group_batch=RESIDENT_GB,
        point_batch=RESIDENT_PB, seed=seed, callbacks=callbacks)
    ref, rstate = resident_trainer(torch, policy, 5, capturable, adamw)
    data = ResidentData(t, x, u, group_batch=RESIDENT_GB, point_batch=RESIDENT_PB, seed=seed,
                        device="cuda")
    spe = RESIDENT_G // RESIDENT_GB
    eager = []
    for e in range(epochs):
        losses = []
        for _ in range(spe):
            rstate, loss = ref.step(rstate, **data.batch())
            losses.append(loss)
        eager.append(float(np.mean(torch.stack(losses).double().cpu().numpy())))
        if schedule:
            for g in rstate.opt_state.param_groups:
                g["lr"] = schedule(e, float(g["lr"]))
    # the parameters, and each param group's learning rate given back as
    # the float the schedule wrote
    lrs = [g["lr"] for g in state.opt_state.param_groups]
    same_params = (all(torch.equal(a, b) for a, b in
                       zip(trainer.model.parameters(), ref.model.parameters()))
                   and all(type(v) is float for v in lrs)
                   and lrs == [g["lr"] for g in rstate.opt_state.param_groups])
    return (trainer.history["loss"] == eager, same_params, trainer.history, eager, kernels,
            launches)


def tutorial8_problem(G=10, n_xg=256):
    """Tutorial 8's grouped problem (``examples/08_sobolev_training.py``,
    ``_grouped_problem`` and ``main_hessian``), from the port's demo data:
    the K=400 packet at G times on n_xg points, normalized, with its
    analytic du/dx and d2u/dx2 chained through both normalizations."""
    from nif_tpu_torch.demo import TravelingWaveHighFreq
    from nif_tpu_torch.demo.datasets import traveling_wave_d2udx2, traveling_wave_dudx

    tw = TravelingWaveHighFreq(n_t=G, n_x=n_xg)
    data = np.asarray(tw.data, np.float32)
    t = data[::n_xg, 0:1]
    x = data[:, 1:2].reshape(G, n_xg, 1)
    u = data[:, 2:3].reshape(G, n_xg, 1)
    lo = tw.n_p + tw.n_x
    t_raw, x_raw = tw.data_raw[:, 0], tw.data_raw[:, 1]
    tj = (traveling_wave_dudx(t_raw, x_raw, tw.wavenumber) * tw.std[1] / tw.std[lo]).reshape(
        G, n_xg, 1, 1).astype(np.float32)
    th = (traveling_wave_d2udx2(t_raw, x_raw, tw.wavenumber) * tw.std[1] ** 2
          / tw.std[lo]).reshape(G, n_xg, 1, 1, 1).astype(np.float32)
    return t, x, u, tj, th


def random_targets(G, P, seed):
    """Random Jacobian targets ``[G, P, 1, 3]`` and symmetric Hessian
    targets ``[G, P, 1, 3, 3]`` (the bench's), float32."""
    rng = np.random.default_rng(seed)
    jac = rng.standard_normal((G, P, 1, 3)).astype(np.float32)
    h = rng.standard_normal((G, P, 1, 3, 3)).astype(np.float32)
    return jac, 0.5 * (h + h.transpose(0, 1, 2, 4, 3))


def equal_mass_chi2(draws, probs, n_bins=100):
    """Chi-square p-value of ``draws`` (point indices) against ``probs``
    over the row's points, in ``n_bins`` bins of about equal mass (each
    point in the bin of its CDF midpoint)."""
    from scipy.stats import chi2

    cdf = np.cumsum(probs)
    bins = np.minimum((n_bins * (cdf - 0.5 * probs) / cdf[-1]).astype(np.int64), n_bins - 1)
    expected = np.bincount(bins, weights=probs / cdf[-1], minlength=n_bins) * len(draws)
    observed = np.bincount(bins[draws], minlength=n_bins)
    keep = expected > 0
    stat = float(np.sum((observed[keep] - expected[keep]) ** 2 / expected[keep]))
    return float(chi2.sf(stat, int(keep.sum()) - 1)), stat


def phase_resident(torch, log):
    """Phase 3g: ``GroupedTrainer.fit_resident`` on the card. Returns the
    resident dataset for phase 4f."""
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.training import Trainer
    from nif_tpu_torch.training.resident import ResidentData
    from nif_tpu_torch.utils.bench import FLAGSHIP_POLICY
    import nif_tpu_torch

    data_np = traveling_wave(RESIDENT_G, RESIDENT_P, seed=21)
    log(f"resident dataset: G={RESIDENT_G} P={RESIDENT_P}, x {data_np[1].nbytes / 1e6:.1f} MB, "
        f"u {data_np[2].nbytes / 1e6:.1f} MB of float32; step shape [{RESIDENT_GB}, "
        f"{RESIDENT_PB}] drawn on the device")
    halve = lambda epoch, lr: lr * 0.5  # noqa: E731
    steps = 3 * (RESIDENT_G // RESIDENT_GB)
    for policy in (FLAGSHIP_POLICY, "float32"):
        tc = policy == FLAGSHIP_POLICY
        # (a) the whole step captured; (b) opt.step() after each replay, and
        # a learning-rate schedule, which the whole-step graph reads from a
        # device tensor; (c) one K2 a step in the trace of each call, no K1,
        # K3, K6 or K8
        for capturable, schedule, adamw, what in (
                (True, None, False, "capturable Adam"),
                (False, None, False, "plain Adam"),
                (True, halve, False, "capturable Adam + LearningRateScheduler"),
                (True, halve, True, "capturable AdamW + LearningRateScheduler")):
            same_loss, same_params, hist, eager, kernels, launches = resident_matches_eager(
                torch, policy, data_np, capturable, schedule, adamw)
            counts = pass_counts(kernels)
            log(f"3g {policy}, {what}: fit_resident 3 epochs ({hist['resident_graph']}: "
                f"{hist['resident_graph_reason']}; captures {len(hist['resident_capture_ms'])}) "
                f"vs the GroupedTrainer.step loop: losses {hist['loss']} vs {eager}, equal bit "
                f"for bit {same_loss}; parameters and learning rates equal {same_params}; the "
                f"fit alone: "
                f"K2 wrapper launches {launches['shapenet_mse_grads']}, torch.profiler over its "
                f"{steps} steps (tensor-core, CUDA-core) {counts}")
            want_form = "step" if capturable else "forward_backward"
            if (not (same_loss and same_params) or hist["resident_graph"] != want_form
                    or not all(np.isfinite(hist["loss"]))):
                raise AssertionError(f"the resident {policy} fit ({what}) departs from the "
                                     f"eager loop")
            if len(hist["resident_capture_ms"]) != 1:
                raise AssertionError(f"the resident {policy} fit ({what}) captured "
                                     f"{len(hist['resident_capture_ms'])} times")
            check_resident_launches(f"the resident {policy} fit ({what})", hist,
                                    kernels, launches, "K2", "shapenet_mse_grads", steps, tc)
    # (d) Sobolev and Hessian resident fits: one K6 or K8 a step
    G_s, P_s = 16, 32768
    t_s, x_s, u_s = traveling_wave(G_s, P_s, seed=22)
    jac_s, hess_s = random_targets(G_s, P_s, seed=23)
    for policy in (FLAGSHIP_POLICY, "float32"):
        tc = policy == FLAGSHIP_POLICY
        for name, wrapper, extra in (
                ("K6", "shapenet_sobolev_grads", {"target_jac": jac_s}),
                ("K8", "shapenet_hessian_grads", {"target_jac": jac_s, "target_hess": hess_s})):
            trainer, state = resident_trainer(torch, policy, 7, w_jac=0.1, w_hess=0.01)
            state, kernels, launches = profiled_fit(
                torch, trainer, state, t_s, x_s, u_s, epochs=3, group_batch=8,
                point_batch=16384, seed=4, **extra)
            counts = check_resident_launches(
                f"the resident {policy} {name} fit", trainer.history, kernels, launches, name,
                wrapper, 6, tc)
            log(f"3g {policy}: resident {'Sobolev' if name == 'K6' else 'Hessian'} fit at "
                f"G={G_s} P={P_s} ([8, 16384] batches, 3 epochs, "
                f"{trainer.history['resident_graph']}): {wrapper} wrapper launches "
                f"{launches[wrapper]}, torch.profiler over its 6 steps {counts}; losses "
                f"{trainer.history['loss']}")
            if not all(np.isfinite(trainer.history["loss"])):
                raise AssertionError(f"the resident {policy} {name} fit diverged")
            del trainer, state
    # tutorial 8's product paths at their own shapes (float32, plain Adam)
    from nif_tpu_torch.training import GroupedTrainer

    t8 = tutorial8_problem()
    for name, hess in (("main_trainer", False), ("main_hessian", True)):
        model = nif_tpu_torch.NIFMultiScale(TUTORIAL8_S, TUTORIAL8_P, device="cuda", seed=0)
        tr = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-4), w_jac=0.1,
                            w_hess=1e-3)
        st = tr.init(0)
        st, kernels, launches = profiled_fit(
            torch, tr, st, t8[0], t8[1], t8[2], target_jac=t8[3],
            target_hess=t8[4] if hess else None, epochs=300, group_batch=10, point_batch=256,
            seed=0)
        h = tr.history["loss"]
        p_name, key = ("K8", "shapenet_hessian_grads") if hess else ("K6", "shapenet_sobolev_grads")
        counts = check_resident_launches(f"tutorial 8's {name}", tr.history, kernels, launches,
                                         p_name, key, 300, False)
        log(f"3g tutorial 8 {name} (G=10, 256 points, full batch, 300 epochs, "
            f"{tr.history['resident_graph']}): loss {h[0]:.6e} -> {h[-1]:.6e}; path "
            f"{tr.history['sobolev_path']}; {key} wrapper launches {launches[key]}, "
            f"torch.profiler over its 300 steps {counts}")
        if not h[-1] < h[0] or tr.history["sobolev_path"] != "fused":
            raise AssertionError(f"tutorial 8's {name} did not train through its kernel")
    # (e) residual sampling: K1 once per 4M-point chunk at each refresh
    trainer, state = resident_trainer(torch, FLAGSHIP_POLICY, 8)
    _build.reset_launches()
    state = trainer.fit_resident(state, *data_np, epochs=4, group_batch=RESIDENT_GB,
                                 point_batch=RESIDENT_PB, point_sampling="residual",
                                 resample_every=2, seed=9)
    launches = dict(_build.LAUNCHES)
    chunks = -(-RESIDENT_G // (4_000_000 // RESIDENT_P))
    k1_counter = bf16_body_counter("shapenet_fwd")
    log(f"3g residual fit_resident (resample_every=2, 4 epochs): losses "
        f"{trainer.history['loss']}; K1 launches {launches['shapenet_fwd']} ({k1_counter} "
        f"{launches[k1_counter]}) for 2 refreshes of {chunks} chunks; K2 wrapper "
        f"launches {launches['shapenet_mse_grads']} with "
        f"{len(trainer.history['resident_capture_ms'])} captures")
    if (launches["shapenet_fwd"] != 2 * chunks or launches[k1_counter] != 2 * chunks
            or launches["shapenet_mse_grads"] != 1 + len(trainer.history["resident_capture_ms"])
            or not all(np.isfinite(trainer.history["loss"]))):
        raise AssertionError(f"the residual resident fit launched {launches}")
    probs = trainer.residual_probs(state, *data_np)
    data = ResidentData(*data_np, group_batch=RESIDENT_GB, point_batch=RESIDENT_PB, seed=10,
                        residual=True, device="cuda")
    data.set_probs(probs)
    g, draws, step = 0, [], 0
    while sum(len(d) for d in draws) < 50_000:
        gsel, idx = data.indices()
        rows = (gsel == g).nonzero().flatten()
        draws += [idx[r].cpu().numpy() for r in rows]
        step += 1
    draws = np.concatenate(draws)[:50_000]
    p_value, stat = equal_mass_chi2(draws, probs[g])
    log(f"3g residual draws of group {g}: 50000 draws over {step} steps against its "
        f"probabilities (max/min {probs[g].max() / probs[g].min():.2f}): chi-square {stat:.2f} "
        f"in 100 equal-mass bins, p = {p_value:.4f}")
    if not p_value > 1e-3:
        raise AssertionError("residual draws do not follow the residual probabilities")
    del trainer, state, data
    # (f) the point-wise Trainer on TravelingWave, tutorial 1's model
    tw = nif_tpu_torch.demo.TravelingWave()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)
    pw = Trainer(nif_tpu_torch.NIF(TUTORIAL1_S, TUTORIAL1_P, device="cuda"),
                 lambda p: torch.optim.Adam(p, lr=2e-3))
    pw_state = pw.init(0)
    t0 = time.perf_counter()
    pw_state = pw.fit(pw_state, inputs, targets, epochs=1500, batch_size=512)
    pw_s = time.perf_counter() - t0
    h = pw.history["loss"]
    mse = pw.evaluate(pw_state, inputs, targets)
    log(f"3g point-wise Trainer, tutorial 1 (NIF swish 30x2, TravelingWave 2000 rows, batch "
        f"512, Adam 2e-3): 1500 epochs in {pw_s:.2f} s = {pw_s / 6000 * 1e3:.4f} ms a step on "
        f"the host clock; loss {h[0]:.6e} -> {h[-1]:.6e}, evaluate {mse:.6e}")
    if not h[-1] < 0.5 * h[0]:
        raise AssertionError("the point-wise Trainer did not halve tutorial 1's loss")
    return data_np


def phase_resident_timing(torch, log, data_np, smi):
    """Phase 4f: the resident step's times beside ``GroupedTrainer.step``
    and ``fit`` at the same batch shape."""
    from nif_tpu_torch.training.resident import ResidentData
    from nif_tpu_torch.utils.bench import FLAGSHIP_POLICY, cuda_ms

    n_pts = RESIDENT_GB * RESIDENT_PB
    t, x, u = data_np
    jac, hess = random_targets(RESIDENT_G, RESIDENT_P, seed=24)
    out = {}
    for policy in (FLAGSHIP_POLICY, "float32"):
        res = {}
        for capturable in (True, False):
            trainer, state = resident_trainer(torch, policy, 12, capturable)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.fit_resident(state, t, x, u, epochs=25, group_batch=RESIDENT_GB,
                                         point_batch=RESIDENT_PB, seed=13)
            host = (time.perf_counter() - t0) / 50 * 1e3
            hist = trainer.history
            res[hist["resident_graph"]] = (hist["resident_step_ms"][-1], host,
                                           hist["resident_capture_ms"][-1])
            log(f"4f {policy} resident MSE step ({hist['resident_graph']}), 50 steps in one "
                f"chunk: {hist['resident_step_ms'][-1]:.4f} ms a replayed step on the device "
                f"clock = {n_pts / hist['resident_step_ms'][-1] * 1e3:.4e} train points/s; "
                f"{host:.4f} ms a step on the host clock of the whole call (staging, eager "
                f"first step, capture and readback included); capture "
                f"{hist['resident_capture_ms'][-1]:.2f} ms")
            if capturable:
                log_step_report(f"4f {policy} resident MSE step ({hist['resident_graph']})",
                                trainer.model, RESIDENT_GB, RESIDENT_PB,
                                hist["resident_step_ms"][-1], policy == "float32", smi)
                data = ResidentData(t, x, u, group_batch=RESIDENT_GB, point_batch=RESIDENT_PB,
                                    seed=14, device="cuda")
                kernels, busy, window = profile_replays(torch, trainer, state, data, 10)
                top = sorted(kernels, key=lambda k: -k[2])[:4]
                log(f"4f {policy} resident MSE step: torch.profiler over 10 replays: window "
                    f"{window:.3f} ms, device busy share {busy:.4f}; largest kernels "
                    + "; ".join(f"{k[:48]} {us / 10:.1f} us x{c // 10}" for k, c, us in top))
                res["busy"] = busy
                launches = sum(c for _, c, _ in kernels) / 10
                idle_us = window / 10 * (1.0 - busy) * 1e3
                sampler_eager_ms = cuda_ms(data.batch, reps=20)
                sampler_graph = torch.cuda.CUDAGraph()
                sampler_graph.register_generator_state(data.generator)
                with torch.cuda.graph(sampler_graph):
                    data.batch()
                sampler_ms = cuda_ms(sampler_graph.replay, reps=20)
                del sampler_graph
                log(f"4f {policy} resident MSE step: {launches:.1f} kernels a replay, "
                    f"{idle_us:.1f} us idle a replay = {idle_us / launches:.2f} us a kernel; "
                    f"the sampler and gathers alone (ResidentData.batch, CUDA events, mean of "
                    f"20): replayed as a graph {sampler_ms:.4f} ms, dispatched eagerly "
                    f"{sampler_eager_ms:.4f} ms")
                rng = np.random.default_rng(0)
                draw = lambda: (rng.permutation(RESIDENT_G)[:RESIDENT_GB],  # noqa: E731
                                rng.choice(RESIDENT_P, size=RESIDENT_PB, replace=False))
                gsel, psel = draw()
                gather = lambda: (t[gsel], x[gsel][:, psel], u[gsel][:, psel])  # noqa: E731
                host_batch = gather()
                fit_stages = {"draw": host_ms(torch, draw, 5),
                              "host gather": host_ms(torch, gather, 5),
                              "copy to the card": host_ms(
                                  torch, lambda: trainer._put(*host_batch), 5)}
                log(f"4f {policy} fit's host stages a step (host clock, mean of 5): "
                    + ", ".join(f"{k} {v:.4f} ms" for k, v in fit_stages.items()))
                batch = data.batch()
                trainer.step(state, **batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    state, _ = trainer.step(state, **batch)
                    torch.cuda.synchronize()
                res["step_host"] = (time.perf_counter() - t0) / 10 * 1e3
                t0 = time.perf_counter()
                state = trainer.fit(state, t, x, u, epochs=3, group_batch=RESIDENT_GB,
                                    point_batch=RESIDENT_PB)
                res["fit_host"] = (time.perf_counter() - t0) / 6 * 1e3
                log(f"4f {policy} at the same batch shape: GroupedTrainer.step synchronized "
                    f"each step {res['step_host']:.4f} ms on the host clock (mean of 10, the "
                    f"batch on the device); fit from host arrays (3 epochs, 6 steps) "
                    f"{res['fit_host']:.4f} ms a step on the host clock")
                del data, batch
            del trainer, state
        for name, extra in (("Sobolev", {"target_jac": jac}),
                            ("Hessian", {"target_jac": jac, "target_hess": hess})):
            trainer, state = resident_trainer(torch, policy, 15, w_jac=0.1, w_hess=0.01)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit_resident(state, t, x, u, epochs=5, group_batch=RESIDENT_GB,
                                 point_batch=RESIDENT_PB, seed=16, **extra)
            host = (time.perf_counter() - t0) / 10 * 1e3
            dev = trainer.history["resident_step_ms"][-1]
            res[name] = (dev, host)
            log(f"4f {policy} resident {name} step, 10 steps: {dev:.4f} ms a replayed step on "
                f"the device clock = {n_pts / dev * 1e3:.4e} train points/s; {host:.4f} ms a "
                f"step on the host clock of the whole call")
            del trainer, state
        out[policy] = res
    # tutorial 8's resident Sobolev step (G=10 x 256, full batch, float32) in
    # both graph forms, and with a learning-rate schedule (1 step an epoch:
    # the whole-step form captures anew every epoch)
    from nif_tpu_torch.training import GroupedTrainer, LearningRateScheduler
    import nif_tpu_torch

    t8 = tutorial8_problem()
    decay = lambda epoch, lr: lr * 0.99  # noqa: E731
    for schedule, epochs in ((None, 300), (decay, 30)):
        for capturable in (True, False):
            model = nif_tpu_torch.NIFMultiScale(TUTORIAL8_S, TUTORIAL8_P, device="cuda", seed=0)
            tr = GroupedTrainer(model, lambda p: torch.optim.Adam(
                p, lr=1e-4, capturable=capturable), w_jac=0.1)
            st = tr.init(0)
            callbacks = [LearningRateScheduler(schedule)] if schedule else []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit_resident(st, t8[0], t8[1], t8[2], target_jac=t8[3], epochs=epochs,
                            group_batch=10, point_batch=256, seed=0, callbacks=callbacks)
            host = (time.perf_counter() - t0) / epochs * 1e3
            h = tr.history
            dev = float(np.mean(h["resident_step_ms"]))
            out.setdefault("tutorial8", {})[(h["resident_graph"], bool(schedule))] = (dev, host)
            log(f"4f tutorial 8 resident Sobolev step (float32, G=10 x 256, full batch, "
                f"{h['resident_graph']}, {'LearningRateScheduler, ' if schedule else ''}"
                f"{epochs} steps): {dev:.4f} ms a replayed step on the device clock (mean over "
                f"{len(h['resident_step_ms'])} chunks); {host:.4f} ms a step on the host clock "
                f"of the whole call; {len(h['resident_capture_ms'])} captures, "
                f"{sum(h['resident_capture_ms']):.2f} ms in all")
            del tr, st, model
    log(f"4f card: {smi}")
    return out


# The L-BFGS fits of phase 3h: iterations, and the group chunk of the
# chunked objective (4 chunks of the flagship's 32 groups).
LBFGS_ITERS = 10
LBFGS_CHUNK = 8
# The streamed dataset of phase 3i: the flagship's inputs (si=3, so=1) at
# G=64 x P=65536 (x 50.3 MB, u 16.8 MB) in two shards of 32 groups, streamed
# at the flagship step shape.
STREAM_G, STREAM_P, STREAM_GB, STREAM_PB = 64, 65536, 32, 32768


def timed(torch, fn):
    """``(fn(), device ms, host ms)`` of one call: CUDA events around it on
    the current stream, and the host clock from a synchronized start to a
    synchronized end."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b), (time.perf_counter() - t0) * 1e3


def lbfgs_fit(torch, log, what, opt, wrapper, tc, max_iter=LBFGS_ITERS, dtype=None,
              per_eval=1):
    """``opt.minimize(max_iter, dtype)`` alone, the launch counts reset just
    before it and read just after: each objective evaluation launched
    ``wrapper`` ``per_eval`` times (once a chunk; its tensor-core variant
    too when ``tc``; with ``dtype`` float64, or no ``wrapper``, no kernel at
    all) and no accepted loss rose by more than the line search's
    approximate-decrease rule allows (1e-6 of the loss before it). Returns
    ``{"ms_iter", "host_ms_iter", "evals_iter", "reads_iter", ...}``."""
    from nif_tpu_torch.ops import _build

    before = dict(opt.counts)
    n_hist = len(opt.history["loss"])
    _build.reset_launches()
    _, dev_ms, host_ms = timed(torch, lambda: opt.minimize(max_iter=max_iter, dtype=dtype))
    launches = dict(_build.LAUNCHES)
    counts = {k: opt.counts[k] - before[k] for k in before}
    h = opt.history["loss"][n_hist:]
    its = counts["iterations"]
    rec = {"ms_iter": dev_ms / its, "host_ms_iter": host_ms / its,
           "evals_iter": counts["evaluations"] / its, "reads_iter": counts["host_reads"] / its,
           "first": h[0], "last": h[-1], "iterations": its}
    log(f"3h {what}: {its} L-BFGS iterations, losses {h[0]:.6e} -> {h[-1]:.6e}; "
        f"{counts['evaluations']} objective evaluations, {counts['host_reads']} host reads; "
        f"launches {({k: v for k, v in launches.items() if v})}; "
        f"{rec['ms_iter']:.4f} ms an iteration on the device clock, "
        f"{rec['host_ms_iter']:.4f} on the host clock")
    if dtype is not None or wrapper is None:
        want = {}
    else:
        want = {wrapper: per_eval * counts["evaluations"]}
        if tc:
            tc_counter = (bf16_body_counter(wrapper)
                          if wrapper in ("shapenet_mse_grads", "shapenet_bwd") else wrapper + "_tc")
            want[tc_counter] = per_eval * counts["evaluations"]
    got = {k: v for k, v in launches.items() if v}
    rose = any(b > a + 1e-6 * abs(a) for a, b in zip(h, h[1:]))
    if got != want or not all(np.isfinite(h)) or rose:
        raise AssertionError(f"{what}: launches {got} for {counts['evaluations']} evaluations "
                             f"(want {want}), losses {h}")
    return rec


def phase_lbfgs(torch, log):
    """Phase 3h: L-BFGS fine-tuning on the card. Returns the fits' times for
    phase 4g."""
    import nif_tpu_torch
    from nif_tpu_torch.optimizers import GroupedLBFGS, LBFGS, cast_parameters
    from nif_tpu_torch.utils.bench import FLAGSHIP_PNET, FLAGSHIP_POLICY, FLAGSHIP_SHAPE

    out = {}
    G, P = 32, 32768
    t, x, u = traveling_wave(G, P, seed=31)
    for policy in (FLAGSHIP_POLICY, "float32"):
        tc = policy == FLAGSHIP_POLICY
        model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, policy, device="cuda",
                                            seed=3)
        opt = GroupedLBFGS(model, t, x, u)
        chunked = GroupedLBFGS(model, t, x, u, chunk_groups=LBFGS_CHUNK)
        v, g = opt._value_and_grads()
        vc, gc = chunked._value_and_grads()
        g, gc = torch.cat([a.reshape(-1) for a in g]), torch.cat([a.reshape(-1) for a in gc])
        v_rel = abs(float(vc) - float(v)) / abs(float(v))
        g_err = float(torch.max(torch.abs(gc - g))) / float(torch.max(torch.abs(g)))
        # the sums' order; under the bf16 policy the ParameterNet's backward
        # rounds each gradient product to bf16, so its bound is BF16_REL
        g_bound = BF16_REL if tc else 5e-5
        log(f"3h {policy} flagship G={G} x P={P}: the objective in {G // LBFGS_CHUNK} chunks "
            f"of {LBFGS_CHUNK} groups vs in memory: value {float(vc):.8e} vs {float(v):.8e} "
            f"(rel {v_rel:.2e}), gradient max|diff| / max|g| {g_err:.2e} (bound {g_bound:.2e})")
        if not (v_rel <= 1e-5 and g_err <= g_bound):
            raise AssertionError(f"the chunked {policy} objective departs from the in-memory one")
        out[("MSE", policy)] = lbfgs_fit(torch, log, f"{policy} flagship MSE fit", opt,
                                         "shapenet_mse_grads", tc)
        out[("MSE chunked", policy)] = lbfgs_fit(
            torch, log, f"{policy} flagship MSE fit, {LBFGS_CHUNK}-group chunks", chunked,
            "shapenet_mse_grads", tc, max_iter=3, per_eval=G // LBFGS_CHUNK)
        del model, opt, chunked, g, gc
    # tutorial 8's shape: Sobolev (K6) and Hessian (K8) fits
    t8 = tutorial8_problem()
    for policy in (FLAGSHIP_POLICY, "float32"):
        for name, wrapper, extra in (
                ("Sobolev", "shapenet_sobolev_grads", {"target_jac": t8[3]}),
                ("Hessian", "shapenet_hessian_grads", {"target_jac": t8[3],
                                                       "target_hess": t8[4]})):
            model = nif_tpu_torch.NIFMultiScale(TUTORIAL8_S, TUTORIAL8_P, policy, device="cuda",
                                                seed=4)
            info = model.sobolev_path_info(t8[1].shape[1], 1, hess=name == "Hessian")
            if info["path"] != "fused":
                raise AssertionError(f"tutorial 8's {name} fit would run eager: {info}")
            tc = info["kernel"] == "tc"
            opt = GroupedLBFGS(model, t8[0], t8[1], t8[2], w_jac=0.1, w_hess=1e-3, **extra)
            out[(name, policy)] = lbfgs_fit(
                torch, log, f"{policy} tutorial 8 {name} fit (G=10 x 256)", opt, wrapper, tc)
    # float64 at G=4 of the flagship shape: eager, no kernel
    model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                        device="cuda", seed=5)
    opt = GroupedLBFGS(model, t[:4], x[:4], u[:4])
    out[("MSE float64", FLAGSHIP_POLICY)] = lbfgs_fit(
        torch, log, "float64 flagship MSE fit (G=4 x 32768)", opt, None, False, max_iter=5,
        dtype="float64")
    f64 = model._any_f64()
    cast_parameters(model, "float32")
    if not f64 or model._any_f64():
        raise AssertionError("the float64 fit left the parameters in the wrong dtype")
    del model, opt
    # tutorial 1's point-wise fine-tune, float32 and float64
    tw = nif_tpu_torch.demo.TravelingWave()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)
    for dtype in (None, "float64"):
        model = nif_tpu_torch.NIF(TUTORIAL1_S, TUTORIAL1_P, device="cuda", seed=6)
        opt = LBFGS(model, inputs=inputs, targets=targets, reg=False)
        with torch.no_grad():
            before = float(torch.mean(torch.square(
                model.apply(inputs) - torch.as_tensor(targets, device="cuda"))))
        rec = lbfgs_fit(torch, log, f"tutorial 1 point-wise fit ({dtype or 'float32'})", opt,
                        None, False, max_iter=200, dtype=dtype)
        cast_parameters(model, "float32")
        with torch.no_grad():
            after = float(torch.mean(torch.square(
                model.apply(inputs) - torch.as_tensor(targets, device="cuda"))))
        log(f"3h tutorial 1 point-wise fit ({dtype or 'float32'}): MSE {before:.6e} -> "
            f"{after:.6e}")
        if not after < before:
            raise AssertionError("the point-wise L-BFGS fit did not lower tutorial 1's MSE")
        out[("point-wise", dtype or "float32")] = rec
    return out


def phase_stream(torch, log, root):
    """Phase 3i: streamed grouped training from a sharded ``GroupedDataset``
    in ``root`` through ``prefetch_to_device``. Returns the dataset."""
    from nif_tpu_torch.data import GroupedDataset, nifio, prefetch_to_device
    from nif_tpu_torch.ops import _build

    if not nifio.native_available():
        raise AssertionError("the native reader did not build on this machine")
    t, x, u = traveling_wave(STREAM_G, STREAM_P, seed=41)
    GroupedDataset.create_from_arrays(t, x, u, root, groups_per_file=STREAM_G // 2)
    ds = GroupedDataset(root)
    log(f"3i dataset: G={STREAM_G} x P={STREAM_P} in {len(ds.files)} shards, x "
        f"{x.nbytes / 1e6:.1f} MB, u {u.nbytes / 1e6:.1f} MB of float32; native reader "
        f"{nifio.native_available()} ({nifio._target().name})")
    (tr, st), (ref, rst) = flagship_trainer(torch), flagship_trainer(torch)
    host = []

    def tee(it):
        for item in it:
            host.append(item)
            yield item

    losses, same = [], []
    stream = prefetch_to_device(tee(ds.iter_batches(STREAM_GB, STREAM_PB, epochs=2, seed=7)))
    for k, (_epoch, bt, bx, bu, bw) in enumerate(stream):
        if not (bx.is_cuda and bw is None and tuple(bx.shape) == (STREAM_GB, STREAM_PB, 3)):
            raise AssertionError(f"streamed batch {k}: {bx.device} {tuple(bx.shape)}")
        _build.reset_launches()
        st, loss = tr.step(st, bt, bx, bu, bw)
        loss = float(loss)
        launches = {k2: v for k2, v in _build.LAUNCHES.items() if v}
        rst, ref_loss = ref.step(rst, *host[k][1:5])
        same.append(loss == float(ref_loss))
        losses.append(loss)
        if launches != {"shapenet_mse_grads": 1, bf16_body_counter("shapenet_mse_grads"): 1}:
            raise AssertionError(f"streamed step {k} launched {launches}")
    same_params = all(torch.equal(a, b) for a, b in
                      zip(tr.model.parameters(), ref.model.parameters()))
    log(f"3i streamed GroupedTrainer.step x{len(losses)} (2 epochs of [{STREAM_GB}, "
        f"{STREAM_PB}] batches through prefetch_to_device): losses {losses}; equal bit for "
        f"bit to the steps on the same batches as host arrays {same}, parameters equal "
        f"{same_params}; one tensor-core K2 a step")
    if len(losses) != 4 or not all(same) or not same_params:
        raise AssertionError("the streamed steps depart from the host-array steps")
    return ds


def phase_optimizer_timing(torch, log, lbfgs_times, ds, resident_np, smi):
    """Phase 4g: L-BFGS, streamed-step and optimizer times."""
    from nif_tpu_torch import optimizers
    from nif_tpu_torch.data import prefetch_to_device
    from nif_tpu_torch.training.resident import graph_form
    from nif_tpu_torch.utils.bench import FLAGSHIP_POLICY, FLAGSHIP_TRAIN_LR, cuda_ms

    for (what, policy), r in lbfgs_times.items():
        log(f"4g L-BFGS {what} ({policy}): {r['ms_iter']:.4f} ms an iteration on the device "
            f"clock, {r['host_ms_iter']:.4f} on the host clock; {r['evals_iter']:.3f} "
            f"objective evaluations and {r['reads_iter']:.3f} host reads an iteration "
            f"({r['iterations']} iterations; card {smi})")
    # where an L-BFGS iteration's time goes: torch.profiler over 5 iterations
    # of the flagship bf16 MSE fit and of tutorial 8's bf16 Sobolev fit
    for what, make in lbfgs_profile_cases(torch):
        opt = make()
        opt.minimize(max_iter=1)
        kernels, busy, window, host_ops, its = profiled_lbfgs(torch, opt, 5)
        top = sorted(kernels, key=lambda k: -k[2])[:4]
        log(f"4g L-BFGS {what}, torch.profiler over {its} iterations: window {window:.3f} ms "
            f"= {window / its:.4f} ms an iteration, device busy share {busy:.4f}, "
            f"{sum(c for _, c, _ in kernels) / its:.1f} kernels an iteration; largest kernels "
            + "; ".join(f"{k[:40]} {us / its:.1f} us x{c / its:.1f}" for k, c, us in top)
            + "; most host time (self, an iteration) "
            + "; ".join(f"{k[:40]} {us / its / 1e3:.3f} ms x{c / its:.1f}"
                        for k, c, us in host_ops[:5]) + f" (card {smi})")
        del opt
    # streamed steps, with and without prefetch, in turns (20 steps each: 10
    # epochs of the two shards)
    n_pts = STREAM_GB * STREAM_PB
    tr, st = flagship_trainer(torch)
    batches = ds.iter_batches(STREAM_GB, STREAM_PB, epochs=1, seed=11)
    for _ in range(2):  # warm-up, the kernel loaded
        st, _ = tr.step(st, *next(batches)[1:5])
    res = {"prefetch_to_device": [], "host arrays": []}
    for name in ("prefetch_to_device", "host arrays", "host arrays", "prefetch_to_device"):
        stream = ds.iter_batches(STREAM_GB, STREAM_PB, epochs=10, seed=12)
        if name == "prefetch_to_device":
            stream = prefetch_to_device(stream)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for item in stream:
            st, _ = tr.step(st, *item[1:5])
            n += 1
        torch.cuda.synchronize()
        res[name].append((time.perf_counter() - t0) / n * 1e3)
    for name, ms in res.items():
        log(f"4g streamed GroupedTrainer.step ({name}), 20 steps of [{STREAM_GB}, "
            f"{STREAM_PB}] a run, two runs in turns: {ms[0]:.4f} and {ms[1]:.4f} ms a step on "
            f"the host clock = {n_pts / np.mean(ms) * 1e3:.4e} train points/s (card {smi})")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        a.record()
        for item in prefetch_to_device(ds.iter_batches(STREAM_GB, STREAM_PB, epochs=5, seed=13)):
            st, _ = tr.step(st, *item[1:5])
        b.record()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    window = a.elapsed_time(b)
    busy = sum(us for _, _, us in kernels) / (window * 1e3)
    top = sorted(kernels, key=lambda k: -k[2])[:4]
    log(f"4g streamed steps through prefetch_to_device, torch.profiler over 10 steps: window "
        f"{window:.3f} ms, device busy share {busy:.4f}; largest kernels "
        + "; ".join(f"{k[:40]} {us / 10:.1f} us x{c / 10:.1f}" for k, c, us in top))
    del tr, st
    # first-order optimizers at the flagship step shape, and fit_resident
    # under each against the eager loop (5 steps: 32 groups, one step an epoch)
    lr = FLAGSHIP_TRAIN_LR
    cases = [
        ("torch.optim.Adam", lambda p: torch.optim.Adam(p, lr=lr)),
        ("adabelief_full", optimizers.adabelief_full(lr)),
        ("lion", optimizers.lion(lr * 0.1)),
        ("centralized adam (capturable)",
         optimizers.centralize_gradients(optimizers.adam(lr, capturable=True))),
        ("adam on warmup_linear_decay (capturable)",
         optimizers.adam(optimizers.warmup_linear_decay(lr, 4, 0.5), capturable=True)),
    ]
    t, x, u = (a[:RESIDENT_GB] for a in resident_np)
    for name, make in cases:
        trainer, state = flagship_trainer(torch, make)
        psel = np.random.default_rng(3).choice(x.shape[1], size=RESIDENT_PB, replace=False)
        batch = tuple(torch.as_tensor(a, device="cuda") for a in (t, x[:, psel], u[:, psel]))
        form = graph_form(state.opt_state, "cuda")[0]
        step_ms = cuda_ms(lambda: trainer.step(state, *batch), reps=5, warmup=2)
        opt_ms = cuda_ms(state.opt_state.step, reps=5, warmup=1)
        same_loss, same_params, hist, eager = resident_vs_eager_with(torch, make, (t, x, u))
        log(f"4g {FLAGSHIP_POLICY} GroupedTrainer.step under {name}: {step_ms:.4f} ms a step "
            f"(CUDA events, mean of 5), opt.step() alone {opt_ms:.4f} ms; graph_form "
            f"{form!r}; fit_resident 5 steps ({hist['resident_graph']}, "
            f"{len(hist['resident_capture_ms'])} captures) vs the eager loop: losses equal "
            f"bit for bit {same_loss}, parameters {same_params} (card {smi})")
        if not (same_loss and same_params) or hist["resident_graph"] != form:
            raise AssertionError(f"fit_resident under {name} departs from the eager loop: "
                                 f"{hist['loss']} vs {eager}")
        del trainer, state
    return res


def lbfgs_profile_cases(torch):
    """``[(what, make)]``: the L-BFGS fits 4g profiles, each ``make()`` a
    fresh ``GroupedLBFGS`` (bf16 policy)."""
    import nif_tpu_torch
    from nif_tpu_torch.optimizers import GroupedLBFGS
    from nif_tpu_torch.utils.bench import FLAGSHIP_PNET, FLAGSHIP_POLICY, FLAGSHIP_SHAPE

    def flagship():
        model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                            device="cuda", seed=3)
        return GroupedLBFGS(model, *traveling_wave(32, 32768, seed=31))

    def tutorial8():
        t8 = tutorial8_problem()
        model = nif_tpu_torch.NIFMultiScale(TUTORIAL8_S, TUTORIAL8_P, FLAGSHIP_POLICY,
                                            device="cuda", seed=4)
        return GroupedLBFGS(model, t8[0], t8[1], t8[2], target_jac=t8[3], w_jac=0.1)

    return [("flagship MSE fit (G=32 x P=32768)", flagship),
            ("tutorial 8 Sobolev fit (G=10 x 256)", tutorial8)]


def profiled_lbfgs(torch, opt, n):
    """``opt.minimize(max_iter=n)`` under ``torch.profiler``: ``(device
    kernels, busy share of the window, window ms, host ops [(name, count,
    self host us)] by self host time, iterations)``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    before = opt.counts["iterations"]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        a.record()
        opt.minimize(max_iter=n)
        b.record()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    window = a.elapsed_time(b)
    host_ops = sorted(((e.key, e.count, e.self_cpu_time_total) for e in prof.key_averages()
                       if not str(e.device_type).endswith("CUDA")), key=lambda r: -r[2])
    return (kernels, sum(us for _, _, us in kernels) / (window * 1e3), window, host_ops,
            opt.counts["iterations"] - before)


def flagship_trainer(torch, make=None, seed=9):
    """The flagship model (bf16 policy, random weights from ``seed``) under a
    ``GroupedTrainer`` with the optimizer factory ``make`` (default Adam at
    the bench's lr): ``(trainer, state)``."""
    import nif_tpu_torch
    from nif_tpu_torch.training import GroupedTrainer
    from nif_tpu_torch.utils.bench import (FLAGSHIP_PNET, FLAGSHIP_POLICY, FLAGSHIP_SHAPE,
                                           FLAGSHIP_TRAIN_LR)

    if make is None:
        make = lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR)  # noqa: E731
    model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                        device="cuda", seed=seed)
    tr = GroupedTrainer(model, make)
    return tr, tr.init(seed)


def resident_vs_eager_with(torch, make, data_np, steps=5):
    """``fit_resident`` for ``steps`` one-step epochs under the optimizer
    factory ``make`` against a loop of ``GroupedTrainer.step`` on a copy
    over the same batches: ``(same losses, same parameters and learning
    rates, history, eager losses)``, each "same" bit for bit."""
    from nif_tpu_torch.training.resident import ResidentData

    t, x, u = data_np
    trainer, state = flagship_trainer(torch, make, seed=5)
    state = trainer.fit_resident(state, t, x, u, epochs=steps, group_batch=t.shape[0],
                                 point_batch=RESIDENT_PB, seed=17)
    ref, rstate = flagship_trainer(torch, make, seed=5)
    data = ResidentData(t, x, u, group_batch=t.shape[0], point_batch=RESIDENT_PB, seed=17,
                        device="cuda")
    eager = []
    for _ in range(steps):
        rstate, loss = ref.step(rstate, **data.batch())
        eager.append(float(loss))
    lrs = [g["lr"] for g in state.opt_state.param_groups]
    same_params = (all(torch.equal(a, b) for a, b in
                       zip(trainer.model.parameters(), ref.model.parameters()))
                   and lrs == [g["lr"] for g in rstate.opt_state.param_groups])
    return trainer.history["loss"] == eager, same_params, trainer.history, eager


# The int8 ROM decode of phase 3j: the JAX bench's fixed-mesh decode
# (bench.py:356-358), G=256 snapshots onto one mesh of P=32768 points of the
# NIF-linear flagship (q_phi 4.2 MB of int8, the field 33.5 MB of float32).
ROM_G, ROM_P = 256, 32768


def rom_decode_phase(torch, log, smi, policy):
    """Phase 3j under one policy: the NIF-linear flagship's int8 pack on a
    fixed mesh; the int8 product against its float64 version (bit for bit);
    the decode against the float64 product of its own dequantized operands
    (rel 1e-6 of max: the rescale and bias add three float32 roundings) and
    against the float32 fixed-mesh decode (``phi`` precomputed, the JAX
    bench's ``romf_step`` with the bias) and ``apply_shared_mesh`` within
    rel-L2 1e-2 (the JAX test's bound), and within 1.1x the rel-L2 that int8
    rounding of these operands adds (each entry's rounding uniform over one
    step: variance ``sum_k a_k^2 s_phi^2 / 12 + phi_k^2 s_a^2 / 12``);
    ``predict_shared_mesh(int8_pack=...)`` and the loaded
    ``shared_mesh_int8`` artifact bit for bit the decode. Then the float32
    decode, the int8 decode and the artifact on CUDA events, and the device
    time of each (``torch.profiler``, 10 calls). Returns ``{name: ms}``."""
    import nif_tpu_torch
    from nif_tpu_torch.compression import quantize_shared_mesh, rom_decode_int8
    from nif_tpu_torch.compression.quantization import _int8_product, _quantize_rows
    from nif_tpu_torch.models.parameter_net import parameter_net_apply
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.serving import export_apply, load_exported, predict_shared_mesh
    from nif_tpu_torch.utils import rel_l2
    from nif_tpu_torch.utils.bench import FLAGSHIP_PNET, LINEAR_SHAPE, cuda_ms

    model = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(LINEAR_SHAPE, FLAGSHIP_PNET,
                                                              policy, device="cuda", seed=1)
    rng = np.random.default_rng(7)
    t = rng.standard_normal((ROM_G, 4)).astype(np.float32)
    x = rng.standard_normal((ROM_P, 3)).astype(np.float32)
    t_dev = torch.from_numpy(t).cuda()
    pack = quantize_shared_mesh(model, x)
    P, so, K = pack["shape"]
    if pack["q_phi"].shape != (P * so, K) or pack["q_phi"].dtype != torch.int8:
        raise AssertionError(f"the pack's q_phi is {pack['q_phi'].shape} {pack['q_phi'].dtype}")
    _build.reset_launches()
    with torch.no_grad():
        phi = model.x_to_phi(x).float()  # [P, so, K], the pack's rows before rounding

        def romf():  # the float32 decode on the fixed mesh, phi precomputed
            a, _ = parameter_net_apply(model.pnet.params, t_dev, model.cfg_parameter_net,
                                       model.pnet_kind)
            return torch.einsum("pok,gk->gpo", phi, a.float()) + pack["bias"]

        a, _ = parameter_net_apply(model.pnet.params, t_dev, model.cfg_parameter_net,
                                   model.pnet_kind)
        q_a, s_a = _quantize_rows(a.float())
        acc = _int8_product(q_a, pack["q_phi_padded"], P * so)
        same = torch.equal(acc.double(), q_a.double() @ pack["q_phi"].double().T)
        u8 = rom_decode_int8(model, pack, t_dev)
        deq = ((q_a.double() * s_a.double()[:, None])
               @ (pack["q_phi"].double() * pack["s_phi"].double()[:, None]).T)
        deq = deq.reshape(ROM_G, P, so) + pack["bias"].double()
        d_deq = float((u8.double() - deq).abs().max() / deq.abs().max())
        uf = romf()
        rows = phi.reshape(P * so, K).double()
        noise = ((a.double() ** 2).sum(1)[:, None] * pack["s_phi"].double()[None, :] ** 2
                 + s_a.double()[:, None] ** 2 * (rows ** 2).sum(1)[None, :]) / 12
        predicted = float(torch.sqrt(noise.sum()) / torch.linalg.vector_norm(uf.double()))
        rel = float(rel_l2(u8, uf))
        rel_apply = float(rel_l2(u8, model.apply_shared_mesh(t_dev, x).float()))
    torch.cuda.synchronize()
    decode_launches = dict(_build.LAUNCHES)
    served = predict_shared_mesh(model, t, int8_pack=pack)
    same_served = np.array_equal(served, u8.cpu().numpy())
    loaded = load_exported(export_apply(model, batch_size=P, layout="shared_mesh_int8",
                                        group_batch=ROM_G, int8_pack=pack))
    same_loaded = torch.equal(loaded(t_dev), u8)
    log(f"3j {policy} int8 ROM decode G={ROM_G} onto P={P} (so={so}, K={K}; q_phi "
        f"{pack['q_phi'].numel() / 1e6:.2f} MB int8, the field {u8.numel() * 4 / 1e6:.1f} MB "
        f"f32): torch._int_mm int32 equals the float64 product bit for bit {same}; max|d| vs "
        f"the float64 dequantized product {d_deq:.3e} of max (bound 1e-6); rel-L2 vs the "
        f"float32 fixed-mesh decode {rel:.4e} (bound 1e-2; int8 rounding predicts "
        f"{predicted:.4e}, bound 1.1x), vs apply_shared_mesh {rel_apply:.4e} (bound 1e-2); "
        f"predict_shared_mesh(int8_pack=...) equal {same_served}; the loaded "
        f"shared_mesh_int8 artifact equal {same_loaded}; hand-written kernel launches "
        f"{sum(decode_launches.values())} (the decode runs none)")
    if (not (same and same_served and same_loaded) or d_deq > 1e-6 or rel > 1.1 * predicted
            or max(rel, rel_apply) > 1e-2 or any(decode_launches.values())):
        raise AssertionError(f"{policy} int8 ROM decode: product exact {same}, dequantized "
                             f"{d_deq}, rel-L2 {rel} (predicted {predicted}), served "
                             f"{same_served}, artifact {same_loaded}, launches "
                             f"{decode_launches}")
    del acc, deq, uf, served, rows, noise
    with torch.no_grad():
        calls = {"f32": romf, "int8": lambda: rom_decode_int8(model, pack, t_dev),
                 "artifact": lambda: loaded(t_dev)}
        times = {k: cuda_ms(f, reps=50, warmup=5) for k, f in calls.items()}
        device = {k: device_ms(torch, f, 10) for k, f in calls.items()}
    log(f"3j {policy} fixed-mesh decode times G={ROM_G} x P={P} (CUDA events, mean of 50; "
        f"card {smi}): float32 (phi precomputed) {times['f32']:.4f} ms = "
        f"{ROM_G * P / times['f32'] * 1e3:.4e} points/s; int8 {times['int8']:.4f} ms = "
        f"{ROM_G * P / times['int8'] * 1e3:.4e} points/s; the loaded shared_mesh_int8 artifact "
        f"{times['artifact']:.4f} ms; int8/f32 time ratio {times['int8'] / times['f32']:.3f}; "
        f"device time a call (torch.profiler, 10 calls: kernels, count): "
        + "; ".join(f"{k} {ms:.4f} ms ({n} kernels)" for k, (ms, n) in device.items()))
    return times


def export_phase(torch, log, smi):
    """Phase 3k: the flagship's ``grouped`` artifact at G=32 x P=32768 in
    both policies (one call of K1's registered op in its graph; a call
    launches K1 once, the tensor-core one in bf16, bit for bit
    ``apply_grouped``, and a ``torch.profiler`` trace of one call holds one
    K1 kernel and no other fused pass), timed beside ``apply_grouped``;
    then the NIF-linear ``shared_mesh`` and the flagship's ``pointwise``
    artifacts round-trip bit for bit. Returns the K1 launches of the two
    artifact calls and the times."""
    import nif_tpu_torch
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.serving import export_apply, load_exported
    from nif_tpu_torch.utils.bench import (FLAGSHIP_PNET, FLAGSHIP_SHAPE, LINEAR_SHAPE,
                                           cuda_ms)

    G, P = 32, 32768
    rng = np.random.default_rng(11)
    t = torch.from_numpy(rng.standard_normal((G, 4)).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.standard_normal((G, P, 3)).astype(np.float32)).cuda()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    res = {}
    for policy in ("mixed_bfloat16", "float32"):
        model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, policy,
                                            device="cuda", seed=0)
        t0 = time.perf_counter()
        blob = export_apply(model, batch_size=P, layout="grouped", group_batch=G)
        export_s = time.perf_counter() - t0
        fn = load_exported(blob)
        ops = [str(n.target) for n in fn.program.graph.nodes
               if n.op == "call_function" and "nif_tpu_torch" in str(n.target)]
        with torch.inference_mode():
            ref = model.apply_grouped(t, x)
        torch.cuda.synchronize()
        _build.reset_launches()
        out = fn(t, x)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        with torch.profiler.profile(activities=acts) as prof:
            fn(t, x)
            torch.cuda.synchronize()
        counts = pass_counts(device_kernels(prof))
        tc = policy == "mixed_bfloat16"
        same = torch.equal(out, ref)
        art_ms = cuda_ms(lambda: fn(t, x), reps=20)
        art_dev = device_ms(torch, lambda: fn(t, x), 10)
        with torch.inference_mode():
            apply_ms = cuda_ms(lambda: model.apply_grouped(t, x), reps=20)
            apply_dev = device_ms(torch, lambda: model.apply_grouped(t, x), 10)
        log(f"3k {policy} grouped artifact G={G} P={P}: {len(blob) / 1e6:.2f} MB, exported in "
            f"{export_s:.1f} s; its graph calls {ops}; a call launched {launches}; the trace of "
            f"one call {counts}; bit for bit apply_grouped {same}; {art_ms:.4f} ms a call "
            f"against apply_grouped's {apply_ms:.4f} (CUDA events, mean of 20; card {smi}); "
            f"device time a call {art_dev[0]:.4f} ms ({art_dev[1]:.0f} kernels) against "
            f"{apply_dev[0]:.4f} ({apply_dev[1]:.0f})")
        body_counter = bf16_body_counter("shapenet_fwd") if tc else None
        if (ops != ["nif_tpu_torch.shapenet_fwd.default"] or not same
                or launches["shapenet_fwd"] != 1 or (tc and launches[body_counter] != 1)
                or sum(launches.values()) != 1 + int(tc)
                or counts["K1"] != ((1, 0) if tc else (0, 1))
                or any(sum(c) for p, c in counts.items() if p != "K1")):
            raise AssertionError(f"the {policy} grouped artifact: graph {ops}, launches "
                                 f"{launches}, trace {counts}, equal {same}")
        res[policy] = {"launches": launches["shapenet_fwd"], "ms": art_ms, "apply_ms": apply_ms}
        if tc:
            rows = torch.cat([t.repeat_interleave(128, 0), x[:, :128].reshape(-1, 3)], 1)
            pfn = load_exported(export_apply(model, batch_size=rows.shape[0]))
            with torch.inference_mode():
                same_pw = torch.equal(pfn(rows), model.apply(rows))
            lin = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(
                LINEAR_SHAPE, FLAGSHIP_PNET, policy, device="cuda", seed=1)
            xm = x[0, :8192]
            sfn = load_exported(export_apply(lin, batch_size=8192, layout="shared_mesh",
                                             group_batch=16))
            with torch.inference_mode():
                same_sm = torch.equal(sfn(t[:16], xm), lin.apply_shared_mesh(t[:16], xm))
            log(f"3k {policy} pointwise artifact ({rows.shape[0]} rows) bit for bit apply "
                f"{same_pw}; NIF-linear shared_mesh artifact (16 snapshots onto 8192 points) "
                f"bit for bit apply_shared_mesh {same_sm}")
            if not (same_pw and same_sm):
                raise AssertionError("the pointwise or shared_mesh artifact departs")
            del lin
        del model, fn, ref, out
    return res


def pruning_phase(torch, log, smi, resident_np):
    """Phase 3l: six flagship ``GroupedTrainer.step`` under
    ``MagnitudePruning(adam, 0.5, begin 0, end 4, every 2)`` (one
    tensor-core K2 a step): every prunable tensor keeps at most its kept
    count (sparsity >= 0.5 within one entry a tensor), its mask frozen after
    step 4 and the pruned entries exactly 0; then a 5-step ``fit_resident``
    with that optimizer (the ``forward_backward`` graph form) against its
    eager loop, bit for bit."""
    from nif_tpu_torch import compression, optimizers
    from nif_tpu_torch.compression.pruning import _kept_count
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.utils.bench import FLAGSHIP_TRAIN_LR

    make = compression.MagnitudePruning(optimizers.adam(FLAGSHIP_TRAIN_LR), final_sparsity=0.5,
                                        begin_step=0, end_step=4, update_every=2)
    trainer, state = flagship_trainer(torch, make, seed=0)
    t, x, u = (a[:RESIDENT_GB] for a in resident_np)
    batch = tuple(torch.as_tensor(a[:, :RESIDENT_PB] if a.ndim == 3 else a, device="cuda")
                  for a in (t, x, u))
    _build.reset_launches()
    losses, frozen = [], None
    for step in range(6):
        state, loss = trainer.step(state, *batch)
        losses.append(float(loss))
        if step == 3:
            frozen = [None if m is None else m.clone() for m in state.opt_state.masks]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    params = [p for _, p in trainer.model.param_items()]
    worst, held = 1.0, True
    for p, m, f in zip(params, state.opt_state.masks, frozen):
        if m is None:
            continue
        k = _kept_count(p.numel(), 4, 0.5, 0, 4)
        nonzero = int(torch.count_nonzero(p))
        worst = min(worst, 1 - nonzero / p.numel())
        held = held and torch.equal(m, f) and nonzero <= k and not bool((p[~m] != 0).any())
        if p.numel() - nonzero < p.numel() * 0.5 - 1:
            held = False
    sp = compression.sparsity(trainer.model.param_tree())
    log(f"3l MagnitudePruning(adam, 0.5, end_step=4, every 2) on the flagship, 6 steps G=32 "
        f"P=32768: losses {losses}; launches {launches}; prunable sparsity {sp:.6f} (least of "
        f"a tensor {worst:.6f}); masks frozen after step 4 and pruned entries exactly 0: {held}")
    if (not held or launches[bf16_body_counter("shapenet_mse_grads")] != 6
            or not np.all(np.isfinite(losses))):
        raise AssertionError(f"pruned training: held {held}, launches {launches}")
    del trainer, state, batch
    same_loss, same_params, hist, eager = resident_vs_eager_with(torch, make, (t, x, u))
    log(f"3l fit_resident 5 steps under MagnitudePruning(adam) ({hist['resident_graph']}) vs "
        f"the eager loop: losses equal bit for bit {same_loss}, parameters {same_params} "
        f"(card {smi})")
    if not (same_loss and same_params) or hist["resident_graph"] != "forward_backward":
        raise AssertionError(f"the pruned fit_resident departs: {hist['loss']} vs {eager}")


# The grouped dataset of phase 3m: the flagship's inputs (si=3, so=1) at
# G=64 x P=32768 (x 25.2 MB, u 8.4 MB of float32) in two shards of 32
# groups, trained by the CLI at the flagship step shape.
CLI_G, CLI_P, CLI_EPOCHS = 64, 32768, 3
# Phases 3n and 3o: the flagship step's global batch, and the resident
# dataset of 3o (32 groups of 65536 points, drawn at 16 x 32768).
MESH_G, MESH_P, MESH_STEPS = 32, 32768, 5
# 3n's split-head GroupedLBFGS: iterations at the flagship step's shape
MESH_LBFGS_ITERS = 3
NCCL_RESIDENT = (32, 65536, 16, 32768)


def _tf32_off(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def phase_cli(torch, log, smi):
    """Phase 3m: ``python -m nif_tpu_torch`` in this process at the
    flagship's full width: a grouped dataset directory (traveling wave,
    G=64 x P=32768 in two shards), ``train`` at ``--group-batch 32
    --point-batch 32768`` for three epochs (six steps, one tensor-core K2
    each; the loss finite and falling), ``eval`` (one K1 a chunk of 32
    groups; its JSON equal to ``evaluate_metrics`` on the restored
    checkpoint, rel 1e-5: float64 sums there, float32 sums here) and
    ``export --serving-layout grouped`` (the loaded artifact bit for bit
    ``apply_grouped``, one K1 a call). Returns the train step's host ms."""
    import contextlib
    import io
    import os

    import nif_tpu_torch
    from nif_tpu_torch import cli
    from nif_tpu_torch.data import GroupedDataset
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.serving import load_exported
    from nif_tpu_torch.training import Checkpointer, GroupedTrainer, TrainState
    from nif_tpu_torch.utils.bench import FLAGSHIP_PNET, FLAGSHIP_POLICY, FLAGSHIP_SHAPE

    root = tempfile.TemporaryDirectory(prefix="nif_cli_")
    d = root.name
    t, x, u = traveling_wave(CLI_G, CLI_P, 21)
    GroupedDataset.create_from_arrays(t, x, u, os.path.join(d, "snaps"), groups_per_file=32)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"cfg_shape_net": FLAGSHIP_SHAPE, "cfg_parameter_net": FLAGSHIP_PNET,
                   "mixed_policy": FLAGSHIP_POLICY}, f)
    base = ["--config", os.path.join(d, "config.json"), "--data", os.path.join(d, "snaps"),
            "--model", "multiscale", "--ckpt-dir", os.path.join(d, "ckpt"), "--device", "cuda"]

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = cli.main(argv)
        torch.cuda.synchronize()
        return out, buf.getvalue()

    phase0 = time.perf_counter()
    _build.reset_launches()
    t0 = time.perf_counter()
    loss, printed = run(["train", *base, "--epochs", str(CLI_EPOCHS), "--lr", "1e-3",
                         "--group-batch", "32", "--point-batch", str(CLI_P)])
    train_s = time.perf_counter() - t0
    train_launches = dict(_build.LAUNCHES)
    epochs = [float(ln.split()[-1]) for ln in printed.splitlines() if ln.startswith("epoch")]
    path = [ln for ln in printed.splitlines() if ln.startswith("compute path")]
    steps = CLI_EPOCHS * CLI_G // 32
    log(f"3m cli train (G={CLI_G} x P={CLI_P}, group batch 32, {steps} steps): epoch losses "
        f"{epochs}, {path}; launches {train_launches}; {train_s:.2f} s, {train_s / steps * 1e3:.1f} "
        f"ms a step on the host clock with the dataset stream, checkpoints each epoch and "
        f"the first step's warm-up (card {smi})")
    if (not np.all(np.isfinite(epochs)) or len(epochs) != CLI_EPOCHS
            or not epochs[-1] < epochs[0]
            or train_launches[bf16_body_counter("shapenet_mse_grads")] != steps
            or train_launches["shapenet_mse_grads"] != steps):
        raise AssertionError(f"cli train: losses {epochs}, launches {train_launches}")

    _build.reset_launches()
    mse, printed = run(["eval", *base])
    eval_launches = dict(_build.LAUNCHES)
    got = json.loads(printed.strip().splitlines()[-1])
    model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                        device="cuda")
    model.param_tree().load_state_dict(Checkpointer(os.path.join(d, "ckpt")).restore())
    ref = GroupedTrainer(model, lambda p: torch.optim.Adam(p)).evaluate_metrics(
        TrainState(model.param_tree(), None), t, x, u, group_batch=32)
    rel = max(abs(got[k] - ref[k]) / abs(ref[k]) for k in ("mse", "rel_l2"))
    log(f"3m cli eval: {got}; evaluate_metrics on the restored checkpoint {ref} (rel {rel:.3e}); "
        f"launches {eval_launches}")
    if rel > 1e-5 or eval_launches[bf16_body_counter("shapenet_fwd")] != CLI_G // 32:
        raise AssertionError(f"cli eval {got} vs {ref}, launches {eval_launches}")

    art = os.path.join(d, "flagship.pt2")
    _, printed = run(["export", *base, "--out", art, "--serving-layout", "grouped",
                      "--batch-size", str(CLI_P), "--group-batch", "32"])
    meta = json.loads(printed.strip().splitlines()[-1])
    fn = load_exported(art)
    tt, xx = (torch.from_numpy(a[:32]).cuda() for a in (t, x))
    _build.reset_launches()
    out = fn(tt, xx)
    torch.cuda.synchronize()
    art_launches = dict(_build.LAUNCHES)
    with torch.inference_mode():
        same = torch.equal(out, model.apply_grouped(tt, xx))
    log(f"3m cli export: {meta}; the loaded artifact bit for bit apply_grouped: {same}; a "
        f"call launched {art_launches}; the phase took {time.perf_counter() - phase0:.1f} s "
        f"(train, eval, the reference evaluation, export and a call)")
    if (not same or art_launches[bf16_body_counter("shapenet_fwd")] != 1
            or meta["layout"] != "grouped"):
        raise AssertionError(f"cli export: equal {same}, launches {art_launches}")
    root.cleanup()
    return train_s


def _mesh_trainer(torch, mesh, seed, cls="GroupedTrainer", capturable=False, **kw):
    import nif_tpu_torch
    from nif_tpu_torch import training
    from nif_tpu_torch.utils.bench import (FLAGSHIP_PNET, FLAGSHIP_POLICY, FLAGSHIP_SHAPE,
                                           FLAGSHIP_TRAIN_LR)

    dev = "cuda" if mesh is None else mesh.device
    model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                        device=dev, seed=seed)
    make = lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR, capturable=capturable)  # noqa: E731
    tr = getattr(training, cls)(model, make, mesh=mesh, **kw)
    return tr, tr.init(seed)


def _steps(torch, tr, state, batch, n):
    """``n`` steps on one batch, placed on the card once (the rank's block
    under a mesh), so the times hold no host copy: (losses, host ms a step
    after the first, each step ending in a synchronize)."""
    batch = tr._put(*batch)
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, loss = tr.step(state, *batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, float(np.mean(ms[1:]))


def _flat_params(model):
    """The parameters (a split head reassembled) as one float64 vector per
    leaf, and a digest of their bits."""
    import hashlib

    from nif_tpu_torch.parallel.state import local_params

    leaves, h = [], hashlib.sha256()

    def walk(node):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k])
            else:
                leaves.append(np.asarray(node[k], np.float64))
                h.update(np.ascontiguousarray(node[k]).tobytes())

    walk(local_params(model))
    return leaves, h.hexdigest()


def _param_gap(a, b) -> float:
    """max|a - b| / max|b| over all the parameters."""
    return (max(float(np.max(np.abs(x - y))) for x, y in zip(a, b))
            / max(float(np.max(np.abs(y))) for y in b))


def ranks_3n(seed: int) -> dict:
    """One of phase 3n's two ranks on one card over gloo (its own process;
    ``parallel.launch.run_ranks``): data-parallel ``GroupedTrainer.step`` x5
    on the flagship's G=32 x P=32768 global batch (16 groups a rank) beside
    the one-process step on the full batch, the row-parallel head on a
    ('data', 'model') = (1, 2) mesh, ZeRO-1 on the point-wise ``Trainer``
    against the replicated one, and the meshed evaluation against the
    unmeshed one."""
    import torch

    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.parallel import make_mesh
    from nif_tpu_torch.parallel.zero import ZeroOneOptimizer
    from nif_tpu_torch.training import GroupedTrainer

    _tf32_off(torch)
    t, x, u = traveling_wave(MESH_G, MESH_P, seed)
    out = {}
    dp_mesh = make_mesh()
    _build.reset_launches()
    tr, state = _mesh_trainer(torch, dp_mesh, seed)
    out["dp_losses"], out["dp_ms"] = _steps(torch, tr, state, (t, x, u), MESH_STEPS)
    out["dp_launches"] = dict(_build.LAUNCHES)
    dp_params, out["dp_digest"] = _flat_params(tr.model)
    meshed = tr.evaluate_metrics(state, t, x, u)
    unmeshed = GroupedTrainer(tr.model, lambda p: torch.optim.Adam(p)).evaluate_metrics(
        state, t, x, u)
    out["eval"] = [meshed, unmeshed]
    del tr, state

    one, ostate = _mesh_trainer(torch, None, seed)
    out["one_losses"], out["one_ms"] = _steps(torch, one, ostate, (t, x, u), MESH_STEPS)
    one_params, _ = _flat_params(one.model)
    out["dp_vs_one"] = _param_gap(dp_params, one_params)
    del one, ostate

    tp_mesh = make_mesh(axis_names=("data", "model"), mesh_shape=(1, 2))
    tp, tstate = _mesh_trainer(torch, tp_mesh, seed, shard_model_axis=True)
    out["tp_head_rows"] = int(tp.model.pnet.params["last"]["w"].shape[0])
    out["tp_losses"], out["tp_ms"] = _steps(torch, tp, tstate, (t, x, u), MESH_STEPS)
    tp_params, out["tp_digest"] = _flat_params(tp.model)
    out["tp_vs_dp"] = _param_gap(tp_params, dp_params)
    del tp, tstate

    # the point-wise Trainer on rows of two snapshots, 4 steps of 4096 rows
    rows = np.concatenate([np.repeat(t[:2], 8192, 0),
                           x[:2, :8192].reshape(-1, 3)], 1).astype(np.float32)
    target = u[:2, :8192].reshape(-1, 1)
    zero = {}
    for name, shard in (("replicated", False), ("zero1", True)):
        ptr, pstate = _mesh_trainer(torch, dp_mesh, seed, "Trainer", shard_opt_state=shard)
        pstate = ptr.fit(pstate, rows, target, epochs=1, batch_size=4096)
        zero[name] = (ptr.history["loss"], _flat_params(ptr.model)[0])
        if shard:
            opt = pstate.opt_state
            out["zero1_owned"] = [len(opt.owned), len(opt.params),
                                  isinstance(opt, ZeroOneOptimizer)]
    out["zero1_losses"] = [zero["replicated"][0], zero["zero1"][0]]
    out["zero1_vs_replicated"] = _param_gap(zero["zero1"][1], zero["replicated"][1])

    # GroupedLBFGS on the row-parallel head (the whole head in the flat
    # vector, gathered by all_reduce) against one unsplit process, from the
    # same init; each rank's K2 launches counted against its evaluations
    from nif_tpu_torch.optimizers import GroupedLBFGS

    out["lbfgs"] = {}
    for name, mesh in (("tp", tp_mesh), ("one", None)):
        tr, _ = _mesh_trainer(torch, mesh, seed, shard_model_axis=mesh is not None)
        opt = GroupedLBFGS(tr.model, t, x, u, mesh=mesh)
        _build.reset_launches()
        t0 = time.perf_counter()
        opt.minimize(max_iter=MESH_LBFGS_ITERS)
        torch.cuda.synchronize()
        out["lbfgs"][name] = {
            "loss": [float(v) for v in opt.history["loss"]], "counts": dict(opt.counts),
            "k2": _build.LAUNCHES[bf16_body_counter("shapenet_mse_grads")],
            "ms_iter": (time.perf_counter() - t0) * 1e3 / max(opt.counts["iterations"], 1),
            "head_rows": int(tr.model.pnet.params["last"]["w"].shape[0])}
        del tr, opt
    return out


def phase_two_ranks(torch, log, smi):
    """Phase 3n: two ranks on the one card over gloo (NCCL refuses two ranks
    on one device), each its own process with a timeout; see
    :func:`ranks_3n`. The parameters equal across the ranks bit for bit; the
    data-parallel losses and parameters within the bf16 bounds of the
    one-process step (BF16_LOSS_REL, and BF16_REL of max|p|), the
    row-parallel head and ZeRO-1 within them of data parallelism and the
    replicated optimizer, the global evaluation rel 1e-5 of the unmeshed.
    Returns the host ms of a data-parallel and a one-process step."""
    import os

    from nif_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    r0, r1 = run_ranks(f"{os.path.abspath(__file__)}:ranks_3n", 2, {"seed": 23},
                       backend="gloo", device="cuda:0", timeout=400)
    wall = time.perf_counter() - t0
    # the one-process step alone on the card (in the ranks two processes
    # share it)
    tr, state = _mesh_trainer(torch, None, 23)
    _, alone_ms = _steps(torch, tr, state, traveling_wave(MESH_G, MESH_P, 23), MESH_STEPS)
    del tr, state
    rel = lambda a, b: float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))  # noqa: E731
    ev = r0["eval"]
    eval_rel = max(abs(ev[0][k] - ev[1][k]) / abs(ev[1][k]) for k in ("mse", "rel_l2"))
    log(f"3n two ranks over gloo on one card ({wall:.1f} s, process starts included): "
        f"data-parallel losses {r0['dp_losses']} (rank 1 {r1['dp_losses']}), one process "
        f"{r0['one_losses']}; loss rel {rel(r0['dp_losses'], r0['one_losses']):.3e}, "
        f"parameters {r0['dp_vs_one']:.3e} of max|p|; parameters equal across ranks "
        f"{r0['dp_digest'] == r1['dp_digest']}; launches a rank {r0['dp_launches']}")
    log(f"3n row-parallel head ({r0['tp_head_rows']} of 128 latent rows a rank): losses "
        f"{r0['tp_losses']}, rel {rel(r0['tp_losses'], r0['dp_losses']):.3e} of data parallel, "
        f"parameters {r0['tp_vs_dp']:.3e}; ZeRO-1 point-wise Trainer (rank 0 owns "
        f"{r0['zero1_owned']}): losses {r0['zero1_losses'][1]} vs replicated "
        f"{r0['zero1_losses'][0]}, parameters {r0['zero1_vs_replicated']:.3e}; global "
        f"evaluation {ev[0]} vs unmeshed {ev[1]} (rel {eval_rel:.3e})")
    lb0, lb1 = r0["lbfgs"], r1["lbfgs"]
    lb_rel = rel(lb0["tp"]["loss"], lb0["one"]["loss"])
    log(f"3n GroupedLBFGS on the row-parallel head ({lb0['tp']['head_rows']} of 128 latent rows "
        f"a rank), {MESH_LBFGS_ITERS} iterations at G={MESH_G} x P={MESH_P}: losses "
        f"{lb0['tp']['loss']} (rank 1 {lb1['tp']['loss']}) vs one unsplit process "
        f"{lb0['one']['loss']}, rel {lb_rel:.3e} (bound {BF16_LOSS_REL}); counts {lb0['tp']['counts']} "
        f"vs {lb0['one']['counts']}; tensor-core K2 launches a rank {lb0['tp']['k2']}, "
        f"{lb1['tp']['k2']} (one process {lb0['one']['k2']}); host ms an iteration "
        f"{lb0['tp']['ms_iter']:.4f} split over gloo, {lb0['one']['ms_iter']:.4f} unsplit (both "
        f"ranks running at once; card {smi})")
    for lb in (lb0, lb1):
        if (lb["tp"]["k2"] != lb["tp"]["counts"]["evaluations"]
                or lb["one"]["k2"] != lb["one"]["counts"]["evaluations"]
                or lb["tp"]["counts"]["iterations"] != MESH_LBFGS_ITERS
                or lb["tp"]["head_rows"] != 64 or not np.all(np.isfinite(lb["tp"]["loss"]))):
            raise AssertionError(f"split-head GroupedLBFGS: {lb}")
    if lb0["tp"] != {**lb1["tp"], "ms_iter": lb0["tp"]["ms_iter"]} or lb_rel > BF16_LOSS_REL:
        raise AssertionError(f"split-head GroupedLBFGS departs: {lb0} / {lb1}")
    log(f"3n host-clock step at G={MESH_G} x P={MESH_P}: data parallel over gloo "
        f"{r0['dp_ms']:.4f} ms (rank 1 {r1['dp_ms']:.4f}), row-parallel head "
        f"{r0['tp_ms']:.4f}, one process alone on the card {alone_ms:.4f} (and "
        f"{r0['one_ms']:.4f} in each rank, both ranks running it at once; mean of "
        f"{MESH_STEPS - 1} after the first; gloo's all_reduce goes through the host, so "
        f"this times the collective's path, not the card; card {smi})")
    if (r0["dp_digest"] != r1["dp_digest"] or r0["tp_digest"] != r1["tp_digest"]
            or rel(r0["dp_losses"], r0["one_losses"]) > BF16_LOSS_REL
            or r0["dp_vs_one"] > BF16_REL
            or rel(r0["tp_losses"], r0["dp_losses"]) > BF16_LOSS_REL
            or r0["tp_vs_dp"] > BF16_REL or r0["tp_head_rows"] != 64
            or rel(r0["zero1_losses"][1], r0["zero1_losses"][0]) > BF16_LOSS_REL
            or r0["zero1_vs_replicated"] > BF16_REL or not r0["zero1_owned"][2]
            or not 0 < r0["zero1_owned"][0] < r0["zero1_owned"][1]
            or eval_rel > 1e-5
            or r0["dp_launches"][bf16_body_counter("shapenet_mse_grads")] != MESH_STEPS
            or not np.all(np.isfinite(r0["dp_losses"]))):
        raise AssertionError(f"two ranks over gloo departs: {r0} / {r1}")
    return r0["dp_ms"], alone_ms


def ranks_3o(seed: int) -> dict:
    """Phase 3o's rank: NCCL at world size 1. ``GroupedTrainer(mesh=...)``
    steps and ``fit_resident`` (capturable Adam: the whole step a CUDA
    graph, the gradient ``all_reduce`` in it; profiled, so the trace counts
    the NCCL kernels a replay launches) beside the unmeshed runs."""
    import torch

    from nif_tpu_torch.parallel import collectives, make_mesh

    _tf32_off(torch)
    t, x, u = traveling_wave(MESH_G, MESH_P, seed)
    mesh = make_mesh()
    out = {}
    for name, m in (("mesh", mesh), ("none", None)):
        tr, state = _mesh_trainer(torch, m, seed)
        out[name + "_losses"], out[name + "_ms"] = _steps(torch, tr, state, (t, x, u),
                                                          MESH_STEPS)
        out[name + "_digest"] = _flat_params(tr.model)[1]
        del tr, state
    G, P, gb, pb = NCCL_RESIDENT
    rt, rx, ru = traveling_wave(G, P, seed + 1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, m in (("mesh", mesh), ("none", None)):
        tr, state = _mesh_trainer(torch, m, seed, capturable=True)
        torch.cuda.synchronize()
        before = dict(collectives.COUNTS)
        with torch.profiler.profile(activities=acts) as prof:
            tr.fit_resident(state, rt, rx, ru, epochs=3, group_batch=gb, point_batch=pb, seed=7)
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        out["resident_" + name] = {
            "losses": tr.history["loss"], "form": tr.history["resident_graph"],
            "step_ms": tr.history["resident_step_ms"],
            "all_reduce": {k: collectives.COUNTS[k] - before[k] for k in before},
            "nccl_kernels": sum(c for k, c, _ in kernels if "nccl" in k.lower()),
            "digest": _flat_params(tr.model)[1]}
        del tr, state
    return out


def phase_nccl(torch, log, smi):
    """Phase 3o: NCCL at world size 1 (``ranks_3o`` in its own process):
    the meshed steps and ``fit_resident`` bit for bit the unmeshed ones, the
    resident step captured whole with one NCCL all_reduce a step in the
    trace; with two cards or more, 3n's data-parallel check on two ranks
    over NCCL too. Returns the host ms of a meshed and an unmeshed step."""
    import os

    from nif_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    (r,) = run_ranks(f"{os.path.abspath(__file__)}:ranks_3o", 1, {"seed": 29},
                     backend="nccl", device="cuda:0", timeout=300)
    wall = time.perf_counter() - t0
    rm, rn = r["resident_mesh"], r["resident_none"]
    steps = 3 * (NCCL_RESIDENT[0] // NCCL_RESIDENT[2])
    log(f"3o NCCL at world size 1 ({wall:.1f} s, process start included): meshed steps "
        f"{r['mesh_losses']} vs unmeshed {r['none_losses']}, parameters bit for bit "
        f"{r['mesh_digest'] == r['none_digest']}; fit_resident ({rm['form']}) losses "
        f"{rm['losses']} vs unmeshed ({rn['form']}) {rn['losses']}, parameters bit for bit "
        f"{rm['digest'] == rn['digest']}; gradient all_reduce calls {rm['all_reduce']} (one "
        f"in the eager first step, one captured; the graph replays it at each of the other "
        f"{steps - 1} steps); kernels named nccl in the trace {rm['nccl_kernels']}")
    log(f"3o host-clock step at G={MESH_G} x P={MESH_P}: meshed (NCCL, world 1) "
        f"{r['mesh_ms']:.4f} ms vs unmeshed {r['none_ms']:.4f}; replayed resident step "
        f"{rm['step_ms']} vs {rn['step_ms']} ms (CUDA events; card {smi})")
    if (r["mesh_losses"] != r["none_losses"] or r["mesh_digest"] != r["none_digest"]
            or rm["losses"] != rn["losses"] or rm["digest"] != rn["digest"]
            or rm["form"] != "step" or rm["all_reduce"] != {"all_reduce": 2, "captured": 1}
            or rn["all_reduce"] != {"all_reduce": 0, "captured": 0}):
        raise AssertionError(f"NCCL at world size 1 departs: {r}")
    if torch.cuda.device_count() >= 2:
        r0, r1 = run_ranks(f"{os.path.abspath(__file__)}:ranks_3n", 2, {"seed": 23},
                           backend="nccl", device="cuda", timeout=400)
        log(f"3o data parallel on two cards over NCCL: losses {r0['dp_losses']} vs one "
            f"process {r0['one_losses']}; parameters {r0['dp_vs_one']:.3e} of max|p|, equal "
            f"across ranks {r0['dp_digest'] == r1['dp_digest']}; step {r0['dp_ms']:.4f} ms")
        if r0["dp_digest"] != r1["dp_digest"] or r0["dp_vs_one"] > BF16_REL:
            raise AssertionError("two ranks over NCCL depart")
    else:
        log("3o one card: the two-rank NCCL check needs two")
    return r["mesh_ms"], r["none_ms"]


# Phase 3p: tutorial 13 at its --paper configuration (G=64 x P=262144, width
# 128, latent 128, mixed_bfloat16, [8, 32768] batches) with the epochs cut to
# 3: 56 training groups in batches of 8, 21 resident steps (the first eager,
# then replays).
PAPER_EPOCHS = 3
# Tutorial 1's start point: the JAX package's init at jax.random.key(0) as
# numpy (tests/test_torch_examples_lbfgs.py holds the file equal to it), the
# start tests/test_examples.py's budget and threshold were set on.
TUTORIAL1_INIT = "tests/data/tutorial1_jax_init_key0.npz"


def _example(name):
    import importlib

    return importlib.import_module(f"nif_tpu_torch.examples.{name}")


def _quiet(fn):
    """``fn()`` with its standard output kept: ``(result, printed lines)``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def _profiled(torch, fn):
    """``fn()`` alone under ``torch.profiler``, the launch counts reset just
    before it and read just after: ``(result, device kernels, launches)``."""
    from nif_tpu_torch.ops import _build

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _build.reset_launches()
        out = fn()
        launches = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
    return out, device_kernels(prof), launches


def _carry_tutorial1_init(mod):
    """Tutorial 1's trainer, starting from :data:`TUTORIAL1_INIT`."""
    import os

    import torch

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), TUTORIAL1_INIT)
    with np.load(path) as z:
        init = {k.replace("/", "."): torch.from_numpy(z[k]) for k in z.files}

    class Carried(mod.Trainer):
        def init(self, seed=0):
            state = super().init(seed)
            self.model.param_tree().load_state_dict(init)
            return state

    return Carried


def phase_examples(torch, log, smi):
    """Phase 3p: the tutorials on the card (``nif_tpu_torch/examples``).
    Tutorial 13 at ``--paper`` with the epochs cut to :data:`PAPER_EPOCHS`,
    run whole under ``torch.profiler``: one tensor-core K2 a resident step
    (the wrapper once in the eager step and once a capture), the last epoch's
    loss below the first, the held-out ``apply_grouped`` one tensor-core K1,
    a finite rel-L2, the finer decode ``[8, 524288, 1]``. ``entry()``'s
    function through ``torch.export`` and ``torch.compile``, each call one
    launch of the tensor-core K1 through the registered op. Then at the
    budgets and thresholds of ``tests/test_examples.py``: tutorial 8's
    ``main_grouped`` (one CUDA-core K6 a step), ``main_trainer`` (one a
    resident step) and ``main_hessian`` (one CUDA-core K8 a resident step,
    K7 in its evaluation), tutorial 5's ``grouped_streaming_demo`` (one
    CUDA-core K2 a step), tutorial 1 (L-BFGS on the card, from the JAX
    package's init) and tutorial 10 (the export artifact loaded on the card).
    Returns the phase's seconds."""
    from nif_tpu_torch.ops import _build

    phase0 = time.perf_counter()
    m13 = _example("13_paper_scale_3d")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        (r, printed), kernels, launches = _profiled(torch, lambda: _quiet(
            lambda: m13.run(paper=True, epochs=PAPER_EPOCHS, workdir=work)))
        wall13 = time.perf_counter() - t0
    hist = r["trainer"].history
    steps = int(r["state"].step)
    counts = pass_counts(kernels)
    captures = len(hist["resident_capture_ms"])
    G, P = r["data"][1].shape[:2]
    u_fine = tuple(r["u_fine"].shape)
    for line in printed:
        log(f"3p tutorial 13 --paper --epochs {PAPER_EPOCHS}: {line} (card {smi})")
    log(f"3p tutorial 13: G={G} x P={P} ({r['n_train']} training groups), {steps} resident "
        f"steps ({hist['resident_graph']}: {hist['resident_graph_reason']}), epoch losses "
        f"{hist['loss']}; replayed step {hist['resident_step_ms']} ms (CUDA events) = "
        f"{[8 * 32768 / (ms * 1e-3) for ms in hist['resident_step_ms']]} points/s, captures "
        f"{captures} ({hist['resident_capture_ms']} ms); trace {counts}, wrapper launches "
        f"{({k: v for k, v in launches.items() if v})}; held-out rel-L2 {r['err']:.4f}; finer "
        f"decode {u_fine}; the whole run {wall13:.1f} s under torch.profiler, training "
        f"{r['train_s']:.3f} s ({r['points'] / r['train_s']:.6e} points/s, capture and the "
        f"eager first step included; card {smi})")
    log_step_report("3p tutorial 13's replayed resident step, bf16", r["model"], 8, 32768,
                    hist["resident_step_ms"][-1], False, smi)
    want = {p: (0, 0) for p in PASS_KERNELS}
    want.update(K1=(1, 0), K2=(steps, 0))
    if (steps != PAPER_EPOCHS * (r["n_train"] // 8) or counts != want
            or launches[bf16_body_counter("shapenet_mse_grads")] != 1 + captures
            or launches[bf16_body_counter("shapenet_fwd", r["model"].cfg_shape_net)] != 1
            or not hist["loss"][-1] < hist["loss"][0]
            or not np.isfinite(r["err"]) or u_fine != (G - r["n_train"], 2 * P, 1)
            or (G, P) != (64, 262144)):
        raise AssertionError(f"tutorial 13 --paper: {steps} steps, trace {counts}, launches "
                             f"{launches}, losses {hist['loss']}, rel-L2 {r['err']}, "
                             f"decode {u_fine}")
    del r

    # entry(): export and compile, K1 through its registered op
    from nif_tpu_torch.entry import entry

    fn, args = entry("cuda")
    t0 = time.perf_counter()
    program = torch.export.export(fn, args)
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    compiled = torch.compile(fn)
    _build.reset_launches()
    with torch.no_grad():
        eager = fn(*args)
        exported = program.module()(*args)
        comp = compiled(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    entry_counter = bf16_body_counter("shapenet_fwd", fn.model.cfg_shape_net)
    entry_launches = _build.LAUNCHES[entry_counter]
    comp_rel = float(torch.linalg.vector_norm(comp - eager) / torch.linalg.vector_norm(eager))
    log(f"3p entry(): torch.export graph calls {[o for o in ops if 'nif_tpu_torch' in o]}; "
        f"eager, exported and compiled calls launched the tensor-core K1 ({entry_counter}) "
        f"{entry_launches} "
        f"times; exported bit for bit eager {torch.equal(exported, eager)}, compiled rel-L2 "
        f"{comp_rel:.3e} from eager; export + compile + three calls {entry_s:.1f} s")
    if (not any("shapenet_fwd" in o for o in ops) or entry_launches != 3
            or not torch.equal(exported, eager) or comp_rel > 1e-2
            or tuple(eager.shape) != (4, 64, 1)):
        raise AssertionError(f"entry(): ops {ops}, launches {entry_launches}, rel {comp_rel}")

    # tutorial 8: the grouped step through the CUDA-core K6 (float32 policy)
    m08 = _example("08_sobolev_training")
    t0 = time.perf_counter()
    _build.reset_launches()
    value_mse, _ = _quiet(lambda: m08.main_grouped(epochs=10))
    got = dict(_build.LAUNCHES)
    log(f"3p tutorial 8 main_grouped (10 epochs): value MSE {value_mse:.4e}; K6 launches "
        f"{got['shapenet_sobolev_grads']} (tensor-core {got['shapenet_sobolev_grads_tc']}); "
        f"{time.perf_counter() - t0:.1f} s")
    if (not value_mse < 5.0 or got["shapenet_sobolev_grads"] != 10
            or got["shapenet_sobolev_grads_tc"]):
        raise AssertionError(f"tutorial 8 main_grouped: {value_mse}, launches {got}")
    for name, fn8, pass_name in (("main_trainer", m08.main_trainer, "K6"),
                                 ("main_hessian", m08.main_hessian, "K8")):
        t0 = time.perf_counter()
        (loss, _), kernels, got = _profiled(torch, lambda: _quiet(lambda: fn8(epochs=10)))
        c = pass_counts(kernels)
        # the float32 K7 (the Hessian evaluation) shares the K8 body's
        # kernel, and K5's float32 tangent body the K6 body's
        want = {p: (0, 0) for p in PASS_KERNELS}
        want["K6"] = (0, 10 * (pass_name == "K6") + got["shapenet_fwd_jac"])
        want["K8"] = (0, 10 * (pass_name == "K8") + got["shapenet_fwd_hess"])
        log(f"3p tutorial 8 {name} (10 resident epochs): final loss {loss:.4e}; trace "
            f"{ {p: v for p, v in c.items() if sum(v)} }, wrapper launches "
            f"{ {k: v for k, v in got.items() if v} }; {time.perf_counter() - t0:.1f} s; "
            f"kernels {[(k[:90], n) for k, n, _ in kernels if 'sob' in k or 'hess' in k]}")
        if not np.isfinite(loss) or c != want:
            raise AssertionError(f"tutorial 8 {name}: loss {loss}, trace {c}, launches {got}")

    # tutorial 5, part 2: streamed grouped steps through the CUDA-core K2
    m05 = _example("05_large_scale_training")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        _build.reset_launches()
        final, _ = _quiet(lambda: m05.grouped_streaming_demo(workdir=work, epochs=2))
        got = dict(_build.LAUNCHES)
    log(f"3p tutorial 5 grouped_streaming_demo (2 epochs): final loss {final:.4e}; K2 launches "
        f"{got['shapenet_mse_grads']} (mma.sync {got['shapenet_mse_grads_tc']}, wgmma "
        f"{got['shapenet_mse_grads_wg']}); {time.perf_counter() - t0:.1f} s")
    if (not np.isfinite(final) or got["shapenet_mse_grads"] != 8 or got["shapenet_mse_grads_tc"]
            or got["shapenet_mse_grads_wg"]):
        raise AssertionError(f"tutorial 5 grouped: {final}, launches {got}")

    # tutorial 1: Adam, a checkpoint round trip and L-BFGS on the card
    m01 = _example("01_simple_1d_wave")
    own = m01.Trainer
    m01.Trainer = _carry_tutorial1_init(m01)
    try:
        with tempfile.TemporaryDirectory() as work:
            t0 = time.perf_counter()
            mse1, printed = _quiet(lambda: m01.main(epochs=60, batch_size=512, lbfgs_iters=600,
                                                    ckpt_dir=work))
    finally:
        m01.Trainer = own
    log(f"3p tutorial 1 (60 epochs, 600 L-BFGS iterations, from the JAX init at key 0): "
        f"{[ln for ln in printed if 'MSE' in ln or 'checkpoint' in ln]}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not mse1 < 0.5:
        raise AssertionError(f"tutorial 1 on the card: MSE {mse1}")

    # tutorial 10: predict and the torch.export artifact reloaded on the card
    m10 = _example("10_serving")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        rl2, printed = _quiet(lambda: m10.main(epochs=30, out_dir=work))
    log(f"3p tutorial 10 (30 epochs): {printed[-2:]}; {time.perf_counter() - t0:.1f} s")
    if not rl2 < 1.5:
        raise AssertionError(f"tutorial 10 on the card: rel-L2 {rl2}")
    seconds = time.perf_counter() - phase0
    log(f"3p took {seconds:.1f} s (card {smi})")
    return seconds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    wall0 = time.perf_counter()
    import nif_tpu_torch
    from nif_tpu_torch.config import ShapeNetConfig
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_derivatives import (
        _shapenet_fwd_jac_on, _shapenet_fwd_jac_simt, _shapenet_sobolev_grads_simt,
        derivative_geometry, k5_variant,
        shapenet_fwd_jac_cuda, shapenet_fwd_jac_reference, shapenet_sobolev_grads_cuda,
        shapenet_sobolev_grads_reference)
    from nif_tpu_torch.ops.fused_hessian import (
        _shapenet_fwd_hess_on, _shapenet_fwd_hess_simt, _shapenet_hessian_grads_on,
        _shapenet_hessian_grads_simt, k7_variant, k8_variant, shapenet_fwd_hess_cuda,
        shapenet_hessian_grads_cuda)
    from nif_tpu_torch.ops.fused_linear import (
        linear_geometry, niflinear_mse_grads_cuda, niflinear_mse_grads_reference)
    from nif_tpu_torch.ops.fused_shapenet import (
        _shapenet_bwd_on, _shapenet_bwd_simt, _shapenet_fwd_on, _shapenet_fwd_simt,
        _shapenet_mse_grads_on,
        _shapenet_mse_grads_simt, k1_geometry, k1_variant, shapenet_bwd_cuda,
        shapenet_fused_bwd_reference, shapenet_fwd_cuda, shapenet_grouped_fused_reference,
        shapenet_mse_grads_cuda, shapenet_mse_grads_reference)
    from nif_tpu_torch.ops.derivatives import output_and_jacobian_grouped
    from nif_tpu_torch.ops.shapenet import shapenet_grouped
    from nif_tpu_torch.serving import predict_grouped, predict_shared_mesh
    from nif_tpu_torch.training import GroupedTrainer
    from nif_tpu_torch.utils import rel_l2
    from nif_tpu_torch.utils.bench import (FLAGSHIP_PNET, FLAGSHIP_POLICY, FLAGSHIP_SHAPE,
                                           FLAGSHIP_TRAIN_LR, LINEAR_SHAPE, cuda_ms,
                                           flagship_hessian_step, flagship_linear_step,
                                           flagship_sobolev_step, flagship_train_step)
    from nif_tpu_torch.utils.roofline import card_peaks, kernel_bound_ms, kernel_cost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---- phase 1: the card and the builds
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    log(f"card: {smi}")
    build_all(["shapenet_fwd", "shapenet_fwd_tc", "shapenet_fwd_wgmma", "shapenet_bwd",
               "shapenet_bwd_tc", "shapenet_bwd_wgmma", "shapenet_jac", "shapenet_jac_tc",
               "shapenet_hess", "shapenet_hess_tc", "shapenet_hess_wgmma", "shapenet_linear",
               "shapenet_linear_tc"])
    peaks = card_peaks(name)
    flag_cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)

    # ---- phase 2: K1 against its plain version, and its determinism
    for i, (variant, args) in enumerate(CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check_k1(torch, ShapeNetConfig(*args), variant, 3, 256, dtype, seed=i)
    for i, args in enumerate(K2_TC_EXTRA):
        check_k1(torch, ShapeNetConfig(*args), "siren", 3, 200, torch.bfloat16, seed=160 + i)
    # NIF-linear's trunk: so * K = 128 output columns of the last product
    trunk_cfg = ShapeNetConfig(3, 128, 128, 2, "sine", False, 30.0)
    check_k1(torch, trunk_cfg, "siren", 4, 4096, torch.bfloat16, seed=170)
    # the CUDA-core body (shapenet_fwd.cu) beyond CASES, in float32 and on
    # bf16 shapes the tensor-core K1 refuses
    for i, (variant, args) in enumerate(SIMT_FWD_EXTRA):
        cfg = ShapeNetConfig(*args)
        if k1_variant(torch.bfloat16, cfg, variant) != "simt":
            raise AssertionError(f"the tensor-core K1 takes {cfg}, not the CUDA-core body")
        for dtype in (torch.float32, torch.bfloat16):
            check_k1(torch, cfg, variant, 3, 200, dtype, seed=190 + i)
    k1f_err = check_k1(torch, flag_cfg, "siren", 32, 32768, torch.float32, seed=10)
    check_k1(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, seed=11)
    check_k1(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, seed=11, simt=True)
    # the wgmma and the mma.sync bodies on the CASES chains the wgmma body
    # takes (a ragged P) and at the flagship, each against plain K1 and
    # against each other
    for i, (variant, args) in enumerate(CASES):
        cfg = ShapeNetConfig(*args)
        if variant == "siren" and k1_variant(torch.bfloat16, cfg, variant) == "wgmma":
            check_k1_bodies(torch, cfg, 3, 200, seed=230 + i)
    k1_body_errs = check_k1_bodies(torch, flag_cfg, 32, 32768, seed=11)
    check_k1_deep_chain(torch)
    # two runs on one input give the same bits: the routed bf16 body (wgmma
    # at the flagship), the mma.sync body by name, the CUDA-core body in f32
    for dtype, kernel in ((torch.bfloat16, None), (torch.bfloat16, "tc"),
                          (torch.float32, None)):
        wb, x = chain_data(torch, flag_cfg, 32, 32768, dtype, seed=15)
        body = kernel or k1_variant(dtype, flag_cfg, "siren")
        before = dict(_build.LAUNCHES)
        runs = [shapenet_fwd_cuda(wb, x, flag_cfg, "siren") if kernel is None
                else _shapenet_fwd_on(kernel, wb, x, flag_cfg, "siren") for _ in range(2)]
        got, want = _body_launches("shapenet_fwd", before, body, n=2)
        if got != want:
            raise AssertionError(f"the flagship {dtype} K1 runs launched {got}, not two {body} K1")
        if not torch.equal(runs[0], runs[1]):
            raise AssertionError(f"K1 ({dtype}, {body}) is not deterministic: two runs on one "
                                 f"input differ")
        log(f"K1 flagship {dtype} (G=32, P=32768, the {body} body): two runs give "
            f"bitwise-equal outputs")
        del wb, x, runs

    # ---- phase 2b: K2 against its plain version, and its determinism
    for i, (variant, args) in enumerate(CASES):
        for dtype in (torch.float32, torch.bfloat16):
            for weighted in (False, True):
                check_k2(torch, ShapeNetConfig(*args), variant, 3, 256, dtype, weighted, seed=i)
    for i, args in enumerate(K2_TC_EXTRA):  # the mma.sync body, named
        for weighted in (False, True):
            check_k2(torch, ShapeNetConfig(*args), "siren", 3, 200, torch.bfloat16, weighted,
                     seed=140 + i, kernel="tc")
    check_k2(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, False, seed=12)
    check_k2(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, False, seed=12, kernel="simt")
    # f32 at the flagship train shape (G=32 x P=32768, the float32-policy
    # step's, so the kernel's splits and order of sums are the timed ones),
    # unweighted as the step calls it and weighted: the weight grads sum
    # 32768 f32 terms a group in another order than plain K2's, so the
    # fused backward's bound (K3's, the f32 K6's) holds there
    k2f_err = max(check_k2(torch, flag_cfg, "siren", 32, 32768, torch.float32, weighted,
                           seed=16, f32_bound=5e-5) for weighted in (False, True))
    # the wgmma body and the mma.sync body on the CASES chains the wgmma body
    # takes, with and without point weights, at a ragged P, each against
    # plain K2 and the two losses against each other; then both at the
    # flagship, and two runs of each there bit for bit
    for i, (variant, args) in enumerate(CASES):
        cfg = ShapeNetConfig(*args)
        if variant == "siren" and _wg_takes(torch, cfg):
            for weighted in (False, True):
                check_k2_bodies(torch, cfg, 3, 200, weighted, seed=120 + i)
    k2_body_errs = check_k2_bodies(torch, flag_cfg, 32, 32768, False, seed=12)
    for body in ("wgmma", "tc"):
        wb, x = chain_data(torch, flag_cfg, 32, 32768, torch.bfloat16, seed=13)
        tgt, w = side_data(torch, flag_cfg, 32, 32768, seed=13)[:2]
        before = dict(_build.LAUNCHES)
        runs = [_shapenet_mse_grads_on(body, wb, x, tgt, flag_cfg, "siren", w) for _ in range(2)]
        got, want = _body_launches("shapenet_mse_grads", before, body)
        if {k: v // 2 for k, v in got.items()} != want:
            raise AssertionError(f"the flagship bf16 {body} K2 runs launched {got}")
        if not (torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])):
            raise AssertionError(f"the {body} K2 is not deterministic: two runs on one input "
                                 f"differ")
        log(f"K2 flagship bf16 (G=32, P=32768, weighted, the {body} body): two runs give "
            f"bitwise-equal loss and d_wb")
    wb, x = chain_data(torch, flag_cfg, 32, 32768, torch.float32, seed=17)
    tgt, w = side_data(torch, flag_cfg, 32, 32768, seed=17)[:2]
    before = dict(_build.LAUNCHES)
    runs = [shapenet_mse_grads_cuda(wb, x, tgt, flag_cfg, "siren", w) for _ in range(2)]
    if (_build.LAUNCHES["shapenet_mse_grads"] != before["shapenet_mse_grads"] + 2
            or _build.LAUNCHES["shapenet_mse_grads_tc"] != before["shapenet_mse_grads_tc"]
            or _build.LAUNCHES["shapenet_mse_grads_wg"] != before["shapenet_mse_grads_wg"]):
        raise AssertionError("the flagship f32 K2 runs did not take the CUDA-core kernel")
    if not (torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])):
        raise AssertionError("the f32 K2 is not deterministic: two runs on one input differ")
    log("K2 flagship f32 (G=32, P=32768, weighted, CUDA cores): two runs give bitwise-equal "
        "loss and d_wb")
    del wb, x, tgt, w, runs

    # ---- phase 2c: K3 against its plain version; autograd through K1 + K3
    for i, (variant, args) in enumerate(CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check_k3(torch, ShapeNetConfig(*args), variant, 3, 256, dtype, seed=i)
    for i, args in enumerate(K2_TC_EXTRA):  # the mma.sync K3 on the mma.sync K2's shapes
        check_k3(torch, ShapeNetConfig(*args), "siren", 3, 200, torch.bfloat16, seed=150 + i,
                 kernel="tc")
    # the wgmma body on the CASES chains it takes (ragged P), beside the
    # mma.sync body
    for i, (variant, args) in enumerate(CASES):
        cfg = ShapeNetConfig(*args)
        if variant == "siren" and _wg_takes(torch, cfg, k3=True):
            for body in ("wgmma", "tc"):
                check_k3(torch, cfg, variant, 3, 200, torch.bfloat16, seed=130 + i, kernel=body)
    check_k3(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, seed=14)
    k3_body_errs = {body: check_k3(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16,
                                   seed=14, kernel=body) for body in ("wgmma", "tc")}
    k3_simt_err = check_k3(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, seed=14,
                           kernel="simt")
    # each tensor-core K3 against the CUDA-core one on the same bf16 inputs,
    # and two flagship runs of each
    wb, x = chain_data(torch, flag_cfg, 32, 32768, torch.bfloat16, seed=20)
    g = side_data(torch, flag_cfg, 32, 32768, seed=20)[2].to(torch.bfloat16)
    simt_out = _shapenet_bwd_simt(wb, x, g, flag_cfg, "siren")
    for body in ("wgmma", "tc"):
        before = dict(_build.LAUNCHES)
        runs = [_shapenet_bwd_on(body, wb, x, g, flag_cfg, "siren") for _ in range(2)]
        got, want = _body_launches("shapenet_bwd", before, body)
        if {k: v // 2 for k, v in got.items()} != want:
            raise AssertionError(f"the flagship bf16 {body} K3 runs launched {got}")
        if not (torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])):
            raise AssertionError(f"the {body} K3 is not deterministic: two runs on one input "
                                 f"differ")
        gaps = []
        for what, mine, other in zip(("d_wb", "dx"), runs[0], simt_out):
            err, scale = max_diff(torch, mine, other, f"K3 flagship bf16 {body} vs simt {what}")
            gaps.append(err / scale)
            if err > BF16_REL * scale:
                raise AssertionError(f"the {body} K3's {what} is {err} from the CUDA-core "
                                     f"K3's, beyond {BF16_REL} of {scale}")
        log(f"K3 flagship bf16 (G=32, P=32768, the {body} body): two runs give bitwise-equal "
            f"d_wb and dx; against the CUDA-core K3 on the same inputs d_wb {gaps[0]:.2e}, dx "
            f"{gaps[1]:.2e} of max|CUDA-core| (plain: {body} {k3_body_errs[body]:.3e}, CUDA "
            f"cores {k3_simt_err:.3e})")
    del wb, x, g, runs, simt_out
    # f32 at the flagship shape K3 is timed at (phase 4b)
    k3f_err = check_k3(torch, flag_cfg, "siren", 32, 32768, torch.float32, seed=18,
                       f32_bound=5e-5)
    wb, x = chain_data(torch, flag_cfg, 32, 32768, torch.float32, seed=19)
    g = side_data(torch, flag_cfg, 32, 32768, seed=19)[2]
    runs = [shapenet_bwd_cuda(wb, x, g, flag_cfg, "siren") for _ in range(2)]
    if not (torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])):
        raise AssertionError("the f32 K3 is not deterministic: two runs on one input differ")
    log("K3 flagship f32 (G=32, P=32768, CUDA cores): two runs give bitwise-equal d_wb and dx")
    del wb, x, g, runs
    model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET,
                                        mixed_policy=FLAGSHIP_POLICY, device="cuda", seed=0)
    rng = np.random.default_rng(1)
    t_g = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)).cuda()
    x_g = torch.from_numpy(rng.uniform(-1, 1, (8, 4096, 3)).astype(np.float32)).cuda()
    g_g = torch.from_numpy(rng.standard_normal((8, 4096, 1)).astype(np.float32)).cuda()
    params = [p for _, p in model.param_items()]
    _build.reset_launches()
    fused_grads = torch.autograd.grad(model.apply_grouped(t_g, x_g), params, g_g)
    torch.cuda.synchronize()
    bwd_path = dict(_build.LAUNCHES)
    eager_grads = torch.autograd.grad(model.apply_grouped(t_g, x_g, fused=False), params, g_g)
    k3_counter = bf16_body_counter("shapenet_bwd")
    k1_counter = bf16_body_counter("shapenet_fwd")
    if (bwd_path["shapenet_bwd"] != 1 or bwd_path[k3_counter] != 1
            or bwd_path["shapenet_fwd"] != 1 or bwd_path[k1_counter] != 1):
        raise AssertionError(f"apply_grouped under autograd launched {bwd_path}, "
                             f"not one {k1_counter} K1 and one {k3_counter} K3")
    worst = 0.0
    for (path, _), a, b in zip(model.param_items(), fused_grads, eager_grads):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"fused gradient of {path} is not finite")
        worst = max(worst, float(rel_l2(a, b)))
    log(f"apply_grouped backward on the card (G=8, P=4096, bf16): launches {bwd_path}; "
        f"ParameterNet grads fused (K1+K3) vs eager: worst rel-L2 {worst:.4f}")
    # The bf16 eager chain rounds omega*(u@W) to bf16 and takes the exact
    # sine: the two paths' grads differ by 3-4% rel-L2 on the CPU at these widths.
    if worst > 0.15:
        raise AssertionError(f"fused and eager ParameterNet grads differ by rel-L2 {worst}")
    # the float32 policy: the CUDA-core K1 forward and the f32 K3 backward,
    # both exact-sine f32 like the eager chain
    model_f32 = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET,
                                            mixed_policy="float32", device="cuda", seed=0)
    params = [p for _, p in model_f32.param_items()]
    _build.reset_launches()
    fused_grads = torch.autograd.grad(model_f32.apply_grouped(t_g, x_g), params, g_g)
    torch.cuda.synchronize()
    bwd_f32_path = dict(_build.LAUNCHES)
    eager_grads = torch.autograd.grad(model_f32.apply_grouped(t_g, x_g, fused=False), params,
                                      g_g)
    if (bwd_f32_path["shapenet_bwd"] != 1 or bwd_f32_path["shapenet_bwd_tc"] != 0
            or bwd_f32_path["shapenet_bwd_wg"] != 0
            or bwd_f32_path["shapenet_fwd"] != 1 or bwd_f32_path["shapenet_fwd_tc"] != 0
            or bwd_f32_path["shapenet_fwd_wg"] != 0):
        raise AssertionError(f"a float32 apply_grouped under autograd launched {bwd_f32_path}, "
                             f"not one CUDA-core K1 and one CUDA-core K3")
    worst = max(float(rel_l2(a, b)) for a, b in zip(fused_grads, eager_grads))
    # the control: the same backward with K3's inputs rounded to bf16 (the
    # tensor-core K3), which the bound below must tell from an f32 K3
    wb_c, _ = model_f32.pnet(model_f32._compute(t_g))
    d_wb_bf = shapenet_bwd_cuda(wb_c.detach().bfloat16(), x_g.bfloat16(), g_g.bfloat16(),
                                model_f32.cfg_shape_net, model_f32.shapenet_variant)[0]
    control_grads = torch.autograd.grad(wb_c, params, d_wb_bf.float())
    control = max(float(rel_l2(a, b)) for a, b in zip(control_grads, eager_grads))
    log(f"apply_grouped backward on the card (G=8, P=4096, float32 policy): launches "
        f"{bwd_f32_path}; ParameterNet grads fused (K1+K3) vs eager: worst rel-L2 {worst:.2e}; "
        f"with a bf16 K3 in its place: {control:.2e}")
    # both f32 with the true sine: only the order of the f32 sums and omega_0's
    # rounding (folded into W0' on the fused path) differ (PERF.md §6: 1.85e-06)
    if not all(bool(torch.isfinite(a).all()) for a in fused_grads) or worst > 1e-4:
        raise AssertionError(f"float32 fused and eager ParameterNet grads differ by rel-L2 "
                             f"{worst}")
    if not control > 1e-4:
        raise AssertionError(f"a bf16 K3 passes the float32 bound: rel-L2 {control}")
    del model_f32, fused_grads, eager_grads, control_grads, wb_c, d_wb_bf

    # ---- phase 2d: K5 against its plain version (both bodies), and its determinism
    for i, (variant, args) in enumerate(CASES + JAC_EXTRA):
        for dtype in (torch.float32, torch.bfloat16):
            check_k5(torch, ShapeNetConfig(*args), variant, 3, 256, dtype, seed=20 + i)
    for i, args in enumerate(JAC_REV_TC):  # the mma.sync reverse body, named
        cfg = ShapeNetConfig(*args)
        if k5_variant(torch.bfloat16, cfg, "siren") not in ("wgmma", "tc"):
            raise AssertionError(f"no tensor-core K5 takes {cfg}")
        check_k5(torch, cfg, "siren", 3, 200, torch.bfloat16, seed=180 + i, kernel="tc")
    # the wgmma and the mma.sync reverse bodies on the CASES + JAC_EXTRA
    # chains the wgmma body takes (a ragged P) and at the flagship
    for i, (variant, args) in enumerate(CASES + JAC_EXTRA):
        cfg = ShapeNetConfig(*args)
        if variant == "siren" and k5_variant(torch.bfloat16, cfg, variant) == "wgmma":
            check_k5_bodies(torch, cfg, 3, 200, seed=240 + i)
    k5_body_errs = check_k5_bodies(torch, flag_cfg, 32, 32768, seed=30)
    # the CUDA-core reverse body (shapenet_fwd.cu, beside the CUDA-core K1)
    # beyond CASES: so = 2-3 sweeps, si 5-7, widths 24-1024, in float32 and
    # on bf16 shapes the tensor-core K5 refuses
    for i, (variant, args) in enumerate(SIMT_FWD_EXTRA):
        cfg = ShapeNetConfig(*args)
        if k5_variant(torch.bfloat16, cfg, variant) != "simt":
            raise AssertionError(f"the tensor-core K5 takes {cfg}, not the CUDA-core body")
        for dtype in (torch.float32, torch.bfloat16):
            check_k5(torch, cfg, variant, 3, 200, dtype, seed=200 + i)
    # the tangent body (so >= si) beyond CASES + JAC_EXTRA: f32 on K6's
    # forward half (si <= 4), bf16 on the body TANGENT_EXTRA names, si = 5 on
    # the stacked body in both dtypes
    for i, (variant, args, bf16_body) in enumerate(TANGENT_EXTRA):
        cfg = ShapeNetConfig(*args)
        for dtype in (torch.float32, torch.bfloat16):
            body = bf16_body if dtype == torch.bfloat16 else None
            check_k5(torch, cfg, variant, 3, 200, dtype, seed=220 + i, body=body)
    check_k5(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, seed=30)
    check_k5(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, seed=30, simt=True)
    k5f_err = check_k5(torch, flag_cfg, "siren", 32, 32768, torch.float32, seed=31)
    # the tangent body at its timed shape (si = so = 3, G=32, P=32768)
    tan_cfg = ShapeNetConfig(*TANGENT_SHAPE)
    k5t_err = check_k5(torch, tan_cfg, "siren", 32, 32768, torch.bfloat16, seed=33)
    check_k5(torch, tan_cfg, "siren", 32, 32768, torch.bfloat16, seed=33, simt=True)
    k5tf_err = check_k5(torch, tan_cfg, "siren", 32, 32768, torch.float32, seed=34)
    for cfg, body in ((flag_cfg, "reverse"), (tan_cfg, "tangent")):
        for dtype, named in ((torch.bfloat16, None), (torch.bfloat16, "tc"),
                             (torch.float32, None)):
            if named and body == "tangent":  # the tangent body has one tensor-core body
                continue
            wb, x = chain_data(torch, cfg, 32, 32768, dtype, seed=32)
            kernel = named or k5_variant(dtype, cfg, "siren")
            before = dict(_build.LAUNCHES)
            runs = [shapenet_fwd_jac_cuda(wb, x, cfg, "siren") if named is None
                    else _shapenet_fwd_jac_on(named, wb, x, cfg, "siren") for _ in range(2)]
            got, want = _body_launches("shapenet_fwd_jac", before, kernel, n=2)
            if got != want:
                raise AssertionError(f"the {dtype} K5 runs at {cfg} launched {got}, not two "
                                     f"{kernel} K5")
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"K5 ({body}, {dtype}) is not deterministic: two runs on "
                                     f"one input differ")
            log(f"K5 {describe(cfg, 'siren', 32, 32768, dtype)} (the {kernel} {body} body): "
                f"two runs give bitwise-equal y and jac")
            del wb, x, runs

    # ---- phase 2e: K6 against its plain version, and its determinism
    for i, (variant, args) in enumerate(CASES):
        cfg = ShapeNetConfig(*args)
        for dtype in (torch.float32, torch.bfloat16):
            for weighted in (False, True):
                check_k6(torch, cfg, variant, 3, 256, dtype, weighted, cfg.output_dim > 1,
                         seed=40 + i)
    for i, args in enumerate(HESS_TC_EXTRA):
        cfg = ShapeNetConfig(*args)
        for weighted in (False, True):
            check_k6(torch, cfg, "siren", 3, 200, torch.bfloat16, weighted, cfg.output_dim > 1,
                     seed=130 + i)
    k6_err = check_k6(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, False, False, seed=50)
    check_k6(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, False, False, seed=50,
             simt=True)
    # f32 at G=8 and at the float32 policy's Sobolev step shape (G=32, timed
    # in phase 4c), unweighted as the step calls it and weighted (plain K6 in
    # chunks of 8 groups)
    k6f_err = max([check_k6(torch, flag_cfg, "siren", 8, 32768, torch.float32, False, False,
                            seed=53)]
                  + [check_k6(torch, flag_cfg, "siren", 32, 32768, torch.float32, weighted,
                              False, seed=54, chunk=8) for weighted in (False, True)])
    for dtype, seed, kernel in ((torch.bfloat16, 51, "tensor-core"),
                                (torch.float32, 55, "CUDA-core")):
        wb, x = chain_data(torch, flag_cfg, 32, 32768, dtype, seed=seed)
        tgt, w, jt = sobolev_data(torch, flag_cfg, 32, 32768, seed=seed)
        before = dict(_build.LAUNCHES)
        runs = [shapenet_sobolev_grads_cuda(wb, x, tgt, jt, flag_cfg, "siren", weight=w)
                for _ in range(2)]
        tc = 2 if dtype == torch.bfloat16 else 0
        if (_build.LAUNCHES["shapenet_sobolev_grads"] != before["shapenet_sobolev_grads"] + 2
                or _build.LAUNCHES["shapenet_sobolev_grads_tc"]
                != before["shapenet_sobolev_grads_tc"] + tc):
            raise AssertionError(f"the flagship {dtype} K6 runs did not take the {kernel} kernel")
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"the {dtype} K6 is not deterministic: two runs on one input "
                                 f"differ")
        log(f"K6 flagship {dtype} (G=32, P=32768, weighted, {kernel} kernel): two runs give "
            f"bitwise-equal terms and d_wb")
    del wb, x, tgt, w, jt, runs

    # ---- phase 2f: K7 against its plain version, and its determinism
    k7_body = k7_variant(torch.bfloat16, flag_cfg, "siren")
    k8_body = k8_variant(torch.bfloat16, flag_cfg, "siren")
    log(f"the flagship's bf16 K7 routes to the {k7_body} body, its K8 to the {k8_body} body")
    for i, (variant, args) in enumerate(HESS_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check_k7(torch, ShapeNetConfig(*args), variant, 3, 256, dtype, seed=60 + i)
    for i, args in enumerate(HESS_TC_EXTRA):  # the mma.sync body, named
        check_k7(torch, ShapeNetConfig(*args), "siren", 3, 200, torch.bfloat16, seed=150 + i,
                 body="tc")
    for i, args in enumerate(HESS_WG):  # the wgmma body, named
        check_k7(torch, ShapeNetConfig(*args), "siren", 3, 200, torch.bfloat16, seed=160 + i,
                 body="wgmma")
    k7_body_errs = {body: check_k7(torch, flag_cfg, "siren", 8, 32768, torch.bfloat16, seed=70,
                                   body=body) for body in ("wgmma", "tc")}
    check_k7(torch, flag_cfg, "siren", 8, 32768, torch.bfloat16, seed=70, simt=True)
    # f32 at G=8 and at the shape phase 4d times and the float32 policy's
    # evaluate_sobolev runs (G=32: the splits and order of sums timed there)
    k7f_err = max(check_k7(torch, flag_cfg, "siren", 8, 32768, torch.float32, seed=71),
                  check_k7(torch, flag_cfg, "siren", 32, 32768, torch.float32, seed=73,
                           chunk=8))
    # two runs of each body at the shape phase 4d times give the same bits;
    # the two bf16 bodies agree with each other there
    k7_runs = {}
    for dtype, seed, body in ((torch.bfloat16, 72, "wgmma"), (torch.bfloat16, 72, "tc"),
                              (torch.float32, 74, "simt")):
        wb, x = chain_data(torch, flag_cfg, 32, 32768, dtype, seed=seed)
        before = dict(_build.LAUNCHES)
        runs = [_shapenet_fwd_hess_on(body, wb, x, flag_cfg, "siren") for _ in range(2)]
        got, want = _body_launches("shapenet_fwd_hess", before, body, 2)
        if got != want:
            raise AssertionError(f"the flagship {dtype} K7 runs on the {body} body launched {got}")
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"the {dtype} K7 ({body} body) is not deterministic: two runs "
                                 f"on one input differ")
        log(f"K7 flagship {dtype} (G=32, P=32768, {body} body): two runs give bitwise-equal "
            f"y, jac and hess")
        if dtype == torch.bfloat16:
            k7_runs[body] = runs[0]
    for out, a, b in zip(("y", "jac", "hess"), k7_runs["wgmma"], k7_runs["tc"]):
        err, scale = max_diff(torch, a, b, f"K7 flagship wgmma vs mma.sync {out}")
        if err > BF16_REL * scale:
            raise AssertionError(f"the wgmma and mma.sync K7 differ on {out}: {err} of {scale}")
        log(f"K7 flagship wgmma vs mma.sync body {out}: max|d| {err:.3e} ({err / scale:.2e} of "
            f"max|mma.sync|)")
    del wb, x, runs, k7_runs

    # ---- phase 2g: K8 against its plain version, and its determinism
    for i, (variant, args) in enumerate(HESS_CASES):
        cfg = ShapeNetConfig(*args)
        for dtype in (torch.float32, torch.bfloat16):
            for weighted in (False, True):
                check_k8(torch, cfg, variant, 3, 256, dtype, weighted, cfg.output_dim > 1,
                         seed=80 + i)
    for i, args in enumerate(HESS_TC_EXTRA):  # the mma.sync body, named
        cfg = ShapeNetConfig(*args)
        for weighted in (False, True):
            check_k8(torch, cfg, "siren", 3, 200, torch.bfloat16, weighted, cfg.output_dim > 1,
                     seed=120 + i, body="tc")
    for i, args in enumerate(HESS_WG):  # the wgmma body, named: unweighted, weighted, masked
        cfg = ShapeNetConfig(*args)
        for weighted, masked in ((False, False), (True, False), (True, True)):
            check_k8(torch, cfg, "siren", 3, 200, torch.bfloat16, weighted, masked,
                     seed=130 + i, body="wgmma")
    k8_body_errs = {body: check_k8(torch, flag_cfg, "siren", 8, 32768, torch.bfloat16, False,
                                   False, seed=90, body=body) for body in ("wgmma", "tc")}
    # f32 at G=8 and at the float32 policy's Hessian step shape (G=32, timed
    # in phase 4d), unweighted as the step calls it and weighted
    k8f_err = max([check_k8(torch, flag_cfg, "siren", 8, 32768, torch.float32, False, False,
                            seed=93)]
                  + [check_k8(torch, flag_cfg, "siren", 32, 32768, torch.float32, weighted, False,
                              seed=94, chunk=8) for weighted in (False, True)])
    k8_runs = {}
    for dtype, seed, body in ((torch.bfloat16, 91, "wgmma"), (torch.bfloat16, 91, "tc"),
                              (torch.float32, 95, "simt")):
        wb, x = chain_data(torch, flag_cfg, 32, 32768, dtype, seed=seed)
        tgt, w, jt, ht = hessian_data(torch, flag_cfg, 32, 32768, seed=seed)
        before = dict(_build.LAUNCHES)
        runs = [_shapenet_hessian_grads_on(body, wb, x, tgt, jt, ht, flag_cfg, "siren",
                                           weight=w) for _ in range(2)]
        got, want = _body_launches("shapenet_hessian_grads", before, body, 2)
        if got != want:
            raise AssertionError(f"the flagship {dtype} K8 runs on the {body} body launched {got}")
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"the {dtype} K8 ({body} body) is not deterministic: two runs "
                                 f"on one input differ")
        log(f"K8 flagship {dtype} (G=32, P=32768, weighted, {body} body): two runs give "
            f"bitwise-equal terms and d_wb")
        if dtype == torch.bfloat16:
            k8_runs[body] = runs[0]
    rels = [abs(float(a) - float(b)) / abs(float(b))
            for a, b in zip(k8_runs["wgmma"][:3], k8_runs["tc"][:3])]
    err, scale = max_diff(torch, k8_runs["wgmma"][3], k8_runs["tc"][3], "K8 wgmma vs mma.sync")
    log(f"K8 flagship wgmma vs mma.sync body: terms rel {', '.join(f'{r:.2e}' for r in rels)}, "
        f"d_wb max|d| {err:.3e} ({err / scale:.2e} of max|mma.sync|)")
    if max(rels) > BF16_LOSS_REL or err > BF16_REL * scale:
        raise AssertionError("the wgmma and mma.sync K8 differ at the flagship")
    del wb, x, tgt, w, jt, ht, runs, k8_runs

    # ---- phase 2h: K4 against its plain version, and its determinism
    for i, case in enumerate(LINEAR_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            for weighted in (False, True):
                check_k4(torch, case, 3, 256, dtype, weighted, seed=100 + i)
    k4_err = check_k4(torch, LINEAR_CASES[0], 32, 32768, torch.bfloat16, False, seed=110)
    # f32 at the float32 policy's NIF-linear step shape (timed in phase 4e),
    # unweighted as the step calls it and weighted
    k4f_err = max(check_k4(torch, LINEAR_CASES[0], 32, 32768, torch.float32, weighted, seed=113)
                  for weighted in (False, True))
    for dtype, seed in ((torch.bfloat16, 111), (torch.float32, 114)):
        lcfg, lso, lws, lbs, la, lbias, lx, ltgt, lw = linear_data(
            torch, LINEAR_CASES[0], 32, 32768, dtype, seed=seed)
        runs = [k4_outputs(niflinear_mse_grads_cuda(lws, lbs, la, lbias, lx, ltgt, lcfg, lso,
                                                    lw)) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"the {dtype} K4 is not deterministic: two runs on one input "
                                 f"differ")
        log(f"K4 flagship trunk {dtype} (G=32, P=32768, weighted): two runs give bitwise-equal "
            f"loss and grads")
    del lws, lbs, la, lbias, lx, ltgt, lw, runs

    # ---- phase 3: serve the flagship model
    if model.po_dim != 33665:
        raise AssertionError(f"flagship po_dim {model.po_dim} != 33665")
    info = model.fast_path_info(32768)
    log(f"fast path at P=32768: {info}")
    if info["path"] != "fused":
        raise AssertionError(f"flagship serving would not take the kernel: {info}")
    rng = np.random.default_rng(0)
    requests = [(32, 32768), (7, 1000), (70, 4096)]  # full, ragged P, chunked G
    chunks = sum(-(-G // min(32, G)) for G, _ in requests)
    inputs = [(rng.standard_normal((G, 4)).astype(np.float32),
               rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)) for G, P in requests]
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [predict_grouped(model, t, x) for t, x in inputs]
    serve_s = time.perf_counter() - t0
    serve_launches = dict(_build.LAUNCHES)
    log(f"served {len(requests)} requests ({sum(G * P for G, P in requests)} points) "
        f"in {serve_s:.3f} s; launches {serve_launches}, chunks {chunks}")
    serve_counter = bf16_body_counter("shapenet_fwd")
    if serve_launches["shapenet_fwd"] != chunks or serve_launches[serve_counter] != chunks:
        raise AssertionError(f"K1 launched {serve_launches} for {chunks} chunks, not one "
                             f"{serve_counter} K1 each")
    with torch.inference_mode():
        for (G, P), (t, x), out in zip(requests, inputs, outs):
            if out.shape != (G, P, 1) or out.dtype != np.float32:
                raise AssertionError(f"request G={G} P={P}: got {out.shape} {out.dtype}")
            if not np.isfinite(out).all():
                raise AssertionError(f"request G={G} P={P}: non-finite output")
            got = torch.from_numpy(out).cuda()
            wb = model.p_to_w(t)
            xc = model.policy.cast_to_compute(x, device=model.device)
            plain = shapenet_grouped_fused_reference(wb, xc, model.cfg_shape_net, "siren").float()
            eager = shapenet_grouped(wb, xc, model.cfg_shape_net, "siren").float()
            d_plain = float((got - plain).abs().max())
            d_eager = float((got - eager).abs().max())
            r_eager = float(rel_l2(got, eager))
            log(f"request G={G} P={P}: max|u|={float(plain.abs().max()):.4f} "
                f"max|d| vs plain K1 {d_plain:.3e}, vs eager {d_eager:.3e} "
                f"(rel-L2 {r_eager:.4f})")
            # The same function with the kernel's rounding points: tight.
            if d_plain > 1e-2 * float(plain.abs().max()):
                raise AssertionError(f"request G={G} P={P}: served output departs from plain K1")
            # The eager bf16 path rounds omega*(u@W) to bf16 at |z| up to ~30
            # (a 0.125-0.25 step in the sine's argument) and takes the exact
            # sine: 2-5% rel-L2 from the kernel at this width (H100 and CPU runs).
            if r_eager > 0.15 or d_eager > 0.3 * float(eager.abs().max()):
                raise AssertionError(f"request G={G} P={P}: served output departs from eager")
    # the float32 policy: the CUDA-core K1, full f32 products
    f32_model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, "float32",
                                            device="cuda", seed=0)
    _build.reset_launches()
    f32_out = predict_grouped(f32_model, *inputs[0])
    torch.cuda.synchronize()
    f32_serve_launches = dict(_build.LAUNCHES)
    with torch.inference_mode():
        t, x = inputs[0]
        f32_plain = shapenet_grouped_fused_reference(
            f32_model.p_to_w(t), f32_model.policy.cast_to_compute(x, device=f32_model.device),
            f32_model.cfg_shape_net, "siren").float().cpu().numpy()
    d_f32 = float(np.abs(f32_out - f32_plain).max())
    log(f"served one request (G=32, P=32768) under the float32 policy: launches "
        f"{f32_serve_launches}; max|d| vs plain K1 {d_f32:.3e} (max|u| "
        f"{float(np.abs(f32_plain).max()):.4f})")
    # the launch took the CUDA-core body of shapenet_fwd.cu: its geometry at
    # the request's shape
    f32_serve_geo = k1_geometry(f32_model.cfg_shape_net, "siren", *inputs[0][1].shape[:2],
                                torch.float32)
    log(f"the float32 request's K1 geometry: {describe_geometry(f32_serve_geo)}")
    if (f32_serve_launches["shapenet_fwd"] != 1 or f32_serve_launches["shapenet_fwd_tc"]
            or f32_serve_launches["shapenet_fwd_wg"] or f32_serve_geo["body"] != "simt"
            or not np.isfinite(f32_out).all() or d_f32 > 2e-4 * float(np.abs(f32_plain).max())
            + 1e-5):
        raise AssertionError(f"a float32 request launched {f32_serve_launches} on "
                             f"{f32_serve_geo} or departs from plain K1 by {d_f32}")
    del f32_model, f32_out, f32_plain

    # ---- phase 3b: train the flagship
    G, P = 32, 32768
    trainer, state, (t_tr, x_tr, u_tr) = flagship_train_step(G, P)
    tmodel = trainer.model
    if tmodel.fast_path_info(P)["path"] != "fused":
        raise AssertionError(f"flagship training would not take K2: {tmodel.fast_path_info(P)}")
    loss_k, grads_k = tmodel.mse_value_and_grad(t_tr, x_tr, u_tr)
    wb_tr, _ = tmodel.pnet(tmodel._compute(t_tr))
    loss_p, d_wb_p = shapenet_mse_grads_reference(
        wb_tr.detach(), tmodel._compute(x_tr), u_tr, tmodel.cfg_shape_net, "siren")
    grads_p = torch.autograd.grad(wb_tr, [p for _, p in tmodel.param_items()], d_wb_p)
    l_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = 0.0
    for (path, _), b in zip(tmodel.param_items(), grads_p):
        a = grads_k
        for key in path:
            a = a[key]
        worst = max(worst, float(rel_l2(a, b)))
    log(f"flagship step 0: loss {float(loss_k):.6e} vs plain K2 {float(loss_p):.6e} (rel "
        f"{l_rel:.2e}); ParameterNet grads vs plain K2 + autograd: worst rel-L2 {worst:.2e}")
    if l_rel > BF16_LOSS_REL or worst > 1e-2:
        raise AssertionError("the flagship step's loss or grads depart from plain K2")
    n_steps = 5
    _build.reset_launches()
    losses = []
    for _ in range(n_steps):
        state, loss = trainer.step(state, t_tr, x_tr, u_tr)
        losses.append(loss)
    torch.cuda.synchronize()
    train_launches = dict(_build.LAUNCHES)
    losses = [float(v) for v in losses]
    log(f"flagship train: {n_steps} steps, losses {losses}, launches {train_launches}, "
        f"path {trainer.history.get('path')}")
    k2_counter = bf16_body_counter("shapenet_mse_grads")
    if (train_launches["shapenet_mse_grads"] != n_steps or train_launches[k2_counter] != n_steps
            or not all(np.isfinite(losses))):
        raise AssertionError(f"{n_steps} train steps launched {train_launches}, losses {losses}")
    log(f"step 0's loss equals the K2 call above bit for bit: {losses[0] == float(loss_k)}")
    # the mma.sync body's own path: bench.py's w256_d2 chain (width 256, whose
    # weights alone exceed the wgmma body's shared memory) trains one step
    # and differentiates apply_grouped, each through one mma.sync launch
    w256_model = nif_tpu_torch.NIFMultiScale(dict(FLAGSHIP_SHAPE, units=256), FLAGSHIP_PNET,
                                             mixed_policy=FLAGSHIP_POLICY, device="cuda", seed=3)
    w256_trainer = GroupedTrainer(w256_model, lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR))
    w256_state = w256_trainer.init(3)
    _build.reset_launches()
    w256_state, w256_loss = w256_trainer.step(w256_state, t_tr, x_tr, u_tr)
    w256_params = [p for _, p in w256_model.param_items()]
    w256_grads = torch.autograd.grad(w256_model.apply_grouped(t_g, x_g), w256_params, g_g)
    torch.cuda.synchronize()
    w256_launches = dict(_build.LAUNCHES)
    log(f"w256_d2 (width 256, bf16): one GroupedTrainer.step at G={G} P={P}, loss "
        f"{float(w256_loss):.6e}, and one apply_grouped backward at G=8 P=4096; launches "
        f"{({k: v for k, v in w256_launches.items() if v})}")
    if (w256_launches["shapenet_mse_grads_tc"] != 1 or w256_launches["shapenet_bwd_tc"] != 1
            or w256_launches["shapenet_mse_grads_wg"] or w256_launches["shapenet_bwd_wg"]
            or not np.isfinite(float(w256_loss))
            or not all(bool(torch.isfinite(gr).all()) for gr in w256_grads)):
        raise AssertionError(f"the w256_d2 step and backward launched {w256_launches}")
    del w256_model, w256_trainer, w256_state, w256_params, w256_grads
    # the float32 policy: the CUDA-core K2, full f32 products
    f32_mse_trainer = GroupedTrainer(
        nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, "float32", device="cuda",
                                    seed=0),
        lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR))
    f32_mse_state = f32_mse_trainer.init(0)
    _build.reset_launches()
    f32_mse_state, f32_mse_loss = f32_mse_trainer.step(f32_mse_state, t_tr, x_tr, u_tr)
    torch.cuda.synchronize()
    mse_f32_launches = dict(_build.LAUNCHES)
    log(f"flagship train, float32 policy: 1 step, loss {float(f32_mse_loss):.6e}, launches "
        f"{mse_f32_launches}")
    if (mse_f32_launches["shapenet_mse_grads"] != 1 or mse_f32_launches["shapenet_mse_grads_tc"]
            or mse_f32_launches["shapenet_mse_grads_wg"] or not np.isfinite(float(f32_mse_loss))):
        raise AssertionError(f"a float32 train step launched {mse_f32_launches}")
    t_w, x_w, u_w = traveling_wave(16, 8192, seed=2)
    fmodel = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                         device="cuda", seed=1)
    fitter = GroupedTrainer(fmodel, lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR))
    fstate = fitter.init(1)
    _build.reset_launches()
    fstate = fitter.fit(fstate, t_w, x_w, u_w, epochs=30, group_batch=8, point_batch=4096)
    fit_launches = dict(_build.LAUNCHES)
    metrics = fitter.evaluate_metrics(fstate, t_w, x_w, u_w)
    hist = fitter.history["loss"]
    log(f"fit on a traveling wave (G=16, P=8192, 4096-point batches, 30 epochs): epoch "
        f"losses first {hist[0]:.6e} last {hist[-1]:.6e}; K2 launches {fit_launches}; "
        f"evaluate_metrics {metrics}")
    if (fit_launches["shapenet_mse_grads"] != 60 or fit_launches[k2_counter] != 60
            or not hist[-1] < hist[0]):
        raise AssertionError(f"the fit did not take the {k2_counter} K2 for every step or did "
                             f"not lower the loss")

    # ---- phase 3c: Sobolev-train the flagship
    strainer, sstate, (t_s, x_s, u_s, j_s) = flagship_sobolev_step(G, P)
    smodel = strainer.model
    sinfo = smodel.sobolev_path_info(P, 3)
    if sinfo["path"] != "fused":
        raise AssertionError(f"flagship Sobolev training would not take K6: {sinfo}")
    total_k, terms_k, sgrads_k = smodel.sobolev_value_and_grad(t_s, x_s, u_s, target_jac=j_s)
    wb_s, _ = smodel.pnet(smodel._compute(t_s))
    jt_flat = j_s.transpose(2, 3).reshape(G, P, 3)  # column k*so + j, as the kernel takes it
    rv, rj, r_wb = shapenet_sobolev_grads_reference(
        wb_s.detach(), smodel._compute(x_s), u_s, jt_flat, smodel.cfg_shape_net, "siren")
    sgrads_p = torch.autograd.grad(wb_s, [p for _, p in smodel.param_items()], r_wb)
    t_rel = [abs(float(a) - float(b)) / abs(float(b))
             for a, b in ((terms_k["value_mse"], rv), (terms_k["jacobian_mse"], rj))]
    worst = 0.0
    for (path, _), b in zip(smodel.param_items(), sgrads_p):
        a = sgrads_k
        for key in path:
            a = a[key]
        worst = max(worst, float(rel_l2(a, b)))
    log(f"flagship Sobolev step 0 ({sinfo}): value {float(terms_k['value_mse']):.6e} jac "
        f"{float(terms_k['jacobian_mse']):.6e} vs plain K6 (rel {t_rel[0]:.2e}, {t_rel[1]:.2e}); "
        f"ParameterNet grads vs plain K6 + autograd: worst rel-L2 {worst:.2e}")
    if max(t_rel) > BF16_LOSS_REL or worst > 1e-2 or not np.isfinite(float(total_k)):
        raise AssertionError("the flagship Sobolev step's terms or grads depart from plain K6")
    del wb_s, r_wb, sgrads_p, sgrads_k
    _build.reset_launches()
    slosses = []
    for _ in range(n_steps):
        sstate, loss = strainer.step(sstate, t_s, x_s, u_s, target_jac=j_s)
        slosses.append(loss)
    torch.cuda.synchronize()
    sob_launches = dict(_build.LAUNCHES)
    slosses = [float(v) for v in slosses]
    log(f"flagship Sobolev train: {n_steps} steps, losses {slosses}, launches {sob_launches}, "
        f"path {strainer.history.get('sobolev_path')}")
    if (sob_launches["shapenet_sobolev_grads"] != n_steps
            or sob_launches["shapenet_sobolev_grads_tc"] != n_steps
            or sob_launches["shapenet_mse_grads"] or not all(np.isfinite(slosses))):
        raise AssertionError(f"{n_steps} Sobolev steps launched {sob_launches}, losses {slosses}")
    # the float32 policy: the CUDA-core K6, full f32 products
    sf32_trainer = GroupedTrainer(
        nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, "float32", device="cuda",
                                    seed=0),
        lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR))
    sf32_state = sf32_trainer.init(0)
    _build.reset_launches()
    sf32_state, sf32_loss = sf32_trainer.step(sf32_state, t_s, x_s, u_s, target_jac=j_s)
    torch.cuda.synchronize()
    sf32_launches = dict(_build.LAUNCHES)
    log(f"flagship Sobolev train, float32 policy: 1 step, loss {float(sf32_loss):.6e}, launches "
        f"{sf32_launches}, path {sf32_trainer.model.sobolev_path_info(P, 3)}")
    if (sf32_launches["shapenet_sobolev_grads"] != 1 or sf32_launches["shapenet_sobolev_grads_tc"]
            or not np.isfinite(float(sf32_loss))):
        raise AssertionError(f"a float32 Sobolev step launched {sf32_launches}")
    # the launch went to the si <= 4 body on the f32 tile machinery: one wave
    # of SMs / G splits, its planes in shared memory (the stacked_kernel body
    # takes 8 splits and a global scratch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sgeo = derivative_geometry("sobolev", flag_cfg, "siren", G, P, torch.float32)
    log(f"the float32 K6's geometry at G={G} P={P}: {sgeo}")
    if (sgeo["kernel"], sgeo["tile"], sgeo["residuals"], sgeo["splits"]) != (
            "simt", 16, "shared", max(1, min(64, sms // G))):
        raise AssertionError(f"the float32 Sobolev step did not take the redesigned K6: {sgeo}")
    j_w = wave_jacobian(t_w, x_w)
    eval_chunks = 4
    _build.reset_launches()
    sf32_eval = sf32_trainer.evaluate_sobolev(sf32_state, t_w, x_w, u_w, j_w,
                                              group_batch=16 // eval_chunks)
    jf32_eval_launches = dict(_build.LAUNCHES)
    log(f"float32-policy evaluate_sobolev ({eval_chunks} chunks): {sf32_eval}; launches "
        f"{jf32_eval_launches}")
    # each chunk's launch took the CUDA-core reverse body of shapenet_fwd.cu
    jf32_geo = derivative_geometry("reverse", flag_cfg, "siren", 16 // eval_chunks,
                                   x_w.shape[1], torch.float32)
    log(f"the float32 Jacobian evaluation's K5 geometry: {describe_geometry(jf32_geo)}")
    if (jf32_eval_launches["shapenet_fwd_jac"] != eval_chunks
            or jf32_eval_launches["shapenet_fwd_jac_tc"]
            or jf32_eval_launches["shapenet_fwd_jac_wg"] or jf32_geo["body"] != "simt"
            or not all(np.isfinite(v) for v in sf32_eval.values())):
        raise AssertionError(f"a float32 Jacobian evaluation launched {jf32_eval_launches} on "
                             f"{jf32_geo}")
    smodel_w = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                           device="cuda", seed=1)
    sfitter = GroupedTrainer(smodel_w, lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR))
    sfstate = sfitter.init(1)
    before = sfitter.evaluate_sobolev(sfstate, t_w, x_w, u_w, j_w, group_batch=16 // eval_chunks)
    _build.reset_launches()
    sfstate = sfitter.fit(sfstate, t_w, x_w, u_w, epochs=30, group_batch=8, point_batch=4096,
                          target_jac=j_w)
    sfit_launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    after = sfitter.evaluate_sobolev(sfstate, t_w, x_w, u_w, j_w, group_batch=16 // eval_chunks)
    eval_launches = dict(_build.LAUNCHES)
    shist = sfitter.history["loss"]
    log(f"Sobolev fit on the traveling wave (G=16, P=8192, 4096-point batches, 30 epochs, "
        f"w_value = w_jac = 1): epoch losses first {shist[0]:.6e} last {shist[-1]:.6e}; "
        f"launches {sfit_launches}; evaluate_sobolev before {before}, after {after} "
        f"({eval_chunks} chunks, launches {eval_launches})")
    if (sfit_launches["shapenet_sobolev_grads"] != 60
            or sfit_launches["shapenet_sobolev_grads_tc"] != 60 or not shist[-1] < shist[0]):
        raise AssertionError("the Sobolev fit did not take the tensor-core K6 for every step or "
                             "did not lower its loss")
    if not (after["value_mse"] < before["value_mse"]
            and after["jacobian_mse"] < before["jacobian_mse"]):
        raise AssertionError(f"the Sobolev fit did not lower both terms: {before} -> {after}")
    k5_counter = bf16_body_counter("shapenet_fwd_jac")
    if (eval_launches["shapenet_fwd_jac"] != eval_chunks
            or eval_launches[k5_counter] != eval_chunks):
        raise AssertionError(f"evaluate_sobolev launched {eval_launches} for {eval_chunks} "
                             f"chunks, not one {k5_counter} K5 each")
    # the mma.sync reverse body's own path: a flagship-width chain of two
    # resblocks (four hidden matrices, whose act' slots the wgmma body's
    # shared memory cannot hold), one evaluation chunk of the traveling wave
    res_shape = dict(FLAGSHIP_SHAPE, use_resblock=True)
    res_cfg = ShapeNetConfig.from_dict(res_shape)
    if k5_variant(torch.bfloat16, res_cfg, "siren") != "tc":
        raise AssertionError(f"K5 does not route {res_cfg} to the mma.sync body")
    rtrainer = GroupedTrainer(nif_tpu_torch.NIFMultiScale(res_shape, FLAGSHIP_PNET,
                                                          FLAGSHIP_POLICY, device="cuda", seed=2),
                              lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR))
    _build.reset_launches()
    res_eval = rtrainer.evaluate_sobolev(rtrainer.init(2), t_w, x_w, u_w, j_w, group_batch=16)
    res_eval_launches = dict(_build.LAUNCHES)
    log(f"evaluate_sobolev of a two-resblock flagship-width model (one chunk of G=16, P=8192): "
        f"{res_eval}; launches {res_eval_launches}")
    got, want = _body_launches("shapenet_fwd_jac", {k: 0 for k in res_eval_launches}, "tc")
    if got != want or not all(np.isfinite(v) for v in res_eval.values()):
        raise AssertionError(f"the resblock evaluation launched {res_eval_launches}, not one "
                             f"mma.sync K5")
    del rtrainer

    # ---- phase 3d: Hessian-train the flagship
    htrainer, hstate, (t_h, x_h, u_h, j_h, h_h) = flagship_hessian_step(G, P)
    hmodel = htrainer.model
    hinfo = hmodel.sobolev_path_info(P, 3, hess=True)
    if hinfo["path"] != "fused":
        raise AssertionError(f"flagship Hessian training would not take K8: {hinfo}")
    hkw = dict(w_jac=htrainer.w_jac, w_hess=htrainer.w_hess)
    _, hterms_k, hgrads_k = hmodel.sobolev_value_and_grad(t_h, x_h, u_h, target_jac=j_h,
                                                          target_hess=h_h, **hkw)
    wb_h, _ = hmodel.pnet(hmodel._compute(t_h))
    jt_h = j_h.transpose(2, 3).reshape(G, P, 3)  # column k*so + j
    ht_h = hmodel._hessian_targets(h_h, G, P, 3, 1, np.arange(1), np.arange(3), True, None)[0]
    hterms_p, r_wb = plain_k8_chunked(torch, wb_h.detach(), hmodel._compute(x_h), u_h, jt_h,
                                      ht_h, hmodel.cfg_shape_net, **hkw)
    hgrads_p = torch.autograd.grad(wb_h, [p for _, p in hmodel.param_items()], r_wb)
    h_rel = [abs(float(hterms_k[k]) - float(b)) / abs(float(b)) for k, b in
             zip(("value_mse", "jacobian_mse", "hessian_mse"), hterms_p)]
    worst = 0.0
    for (path, _), b in zip(hmodel.param_items(), hgrads_p):
        a = hgrads_k
        for key in path:
            a = a[key]
        worst = max(worst, float(rel_l2(a, b)))
    log(f"flagship Hessian step 0 ({hinfo}): terms "
        f"{ {k: f'{float(v):.6e}' for k, v in hterms_k.items()} } vs plain K8 (rel "
        f"{', '.join(f'{r:.2e}' for r in h_rel)}); ParameterNet grads vs plain K8 + autograd: "
        f"worst rel-L2 {worst:.2e}")
    if max(h_rel) > BF16_LOSS_REL or worst > 1e-2:
        raise AssertionError("the flagship Hessian step's terms or grads depart from plain K8")
    del wb_h, r_wb, hgrads_p, hgrads_k
    _build.reset_launches()
    hlosses = []
    for _ in range(n_steps):
        hstate, loss = htrainer.step(hstate, t_h, x_h, u_h, target_jac=j_h, target_hess=h_h)
        hlosses.append(loss)
    torch.cuda.synchronize()
    hess_launches = dict(_build.LAUNCHES)
    hlosses = [float(v) for v in hlosses]
    log(f"flagship Hessian train: {n_steps} steps, losses {hlosses}, launches {hess_launches}, "
        f"path {htrainer.history.get('sobolev_path')}")
    got, want = _body_launches("shapenet_hessian_grads", {k: 0 for k in hess_launches}, k8_body,
                               n_steps)
    if (got != want or hess_launches["shapenet_sobolev_grads"]
            or hess_launches["shapenet_mse_grads"] or not all(np.isfinite(hlosses))):
        raise AssertionError(f"{n_steps} Hessian steps launched {hess_launches}, losses {hlosses}")
    # the float32 policy: the CUDA-core K8, full f32 products
    hf32_trainer = GroupedTrainer(
        nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, "float32", device="cuda",
                                    seed=0),
        lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR), **hkw)
    hf32_state = hf32_trainer.init(0)
    _build.reset_launches()
    hf32_state, hf32_loss = hf32_trainer.step(hf32_state, t_h, x_h, u_h, target_jac=j_h,
                                              target_hess=h_h)
    torch.cuda.synchronize()
    hf32_launches = dict(_build.LAUNCHES)
    log(f"flagship Hessian train, float32 policy: 1 step, loss {float(hf32_loss):.6e}, launches "
        f"{hf32_launches}")
    got, want = _body_launches("shapenet_hessian_grads", {k: 0 for k in hf32_launches}, "simt")
    if got != want or not np.isfinite(float(hf32_loss)):
        raise AssertionError(f"a float32 Hessian step launched {hf32_launches}")
    h_w = wave_hessian(t_w, x_w)
    _build.reset_launches()
    hf32_eval = hf32_trainer.evaluate_sobolev(hf32_state, t_w, x_w, u_w, j_w, target_hess=h_w,
                                              group_batch=16 // eval_chunks)
    hf32_eval_launches = dict(_build.LAUNCHES)
    log(f"float32-policy evaluate_sobolev with Hessian targets ({eval_chunks} chunks): "
        f"{hf32_eval}; launches {hf32_eval_launches}")
    got, want = _body_launches("shapenet_fwd_hess", {k: 0 for k in hf32_eval_launches}, "simt",
                               eval_chunks)
    if got != want or not all(np.isfinite(v) for v in hf32_eval.values()):
        raise AssertionError(f"a float32 Hessian evaluation launched {hf32_eval_launches}")
    hmodel_w = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                           device="cuda", seed=1)
    hfitter = GroupedTrainer(hmodel_w, lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR), **hkw)
    hfstate = hfitter.init(1)
    hbefore = hfitter.evaluate_sobolev(hfstate, t_w, x_w, u_w, j_w, target_hess=h_w,
                                       group_batch=16 // eval_chunks)
    _build.reset_launches()
    hfstate = hfitter.fit(hfstate, t_w, x_w, u_w, epochs=30, group_batch=8, point_batch=4096,
                          target_jac=j_w, target_hess=h_w)
    hfit_launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    hafter = hfitter.evaluate_sobolev(hfstate, t_w, x_w, u_w, j_w, target_hess=h_w,
                                      group_batch=16 // eval_chunks)
    heval_launches = dict(_build.LAUNCHES)
    hhist = hfitter.history["loss"]
    log(f"Hessian fit on the traveling wave (G=16, P=8192, 4096-point batches, 30 epochs, "
        f"w_jac={hkw['w_jac']}, w_hess={hkw['w_hess']}): epoch losses first {hhist[0]:.6e} last "
        f"{hhist[-1]:.6e}; launches {hfit_launches}; evaluate_sobolev before {hbefore}, after "
        f"{hafter} ({eval_chunks} chunks, launches {heval_launches})")
    if hfit_launches["shapenet_hessian_grads"] != 60 or not hhist[-1] < hhist[0]:
        raise AssertionError("the Hessian fit did not take K8 for every step or did not lower "
                             "its loss")
    if not hafter["hessian_mse"] < hbefore["hessian_mse"]:
        raise AssertionError(f"the Hessian fit did not lower the Hessian term: {hbefore} -> "
                             f"{hafter}")
    got, want = _body_launches("shapenet_fwd_hess", {k: 0 for k in heval_launches}, k7_body,
                               eval_chunks)
    if got != want:
        raise AssertionError(f"evaluate_sobolev launched {heval_launches} for {eval_chunks} "
                             f"chunks, not one {k7_body} K7 each")
    # the bodies the flagship does not route to, on their own paths: a
    # flagship-width model of two inputs (si = 2: six streams, which the
    # wgmma body has no instance for) takes the mma.sync K7 and K8; one
    # Hessian step and one evaluation chunk (G=8, P=4096), each read alone
    si2_shape = dict(FLAGSHIP_SHAPE, input_dim=2)
    si2_cfg = ShapeNetConfig.from_dict(si2_shape)
    if (k7_variant(torch.bfloat16, si2_cfg, "siren"), k8_variant(torch.bfloat16, si2_cfg,
                                                                 "siren")) != ("tc", "tc"):
        raise AssertionError(f"K7/K8 do not route {si2_cfg} to the mma.sync body")
    si2_trainer = GroupedTrainer(nif_tpu_torch.NIFMultiScale(si2_shape, FLAGSHIP_PNET,
                                                             FLAGSHIP_POLICY, device="cuda",
                                                             seed=3),
                                 lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR), **hkw)
    rng = np.random.default_rng(17)
    si2_np = [rng.standard_normal((8, t_h.shape[1])), rng.uniform(-1, 1, (8, 4096, 2)),
              rng.standard_normal((8, 4096, 1)), rng.standard_normal((8, 4096, 1, 2)),
              rng.standard_normal((8, 4096, 1, 2, 2))]
    si2_np[4] = 0.5 * (si2_np[4] + si2_np[4].transpose(0, 1, 2, 4, 3))
    si2_t, si2_x, si2_u, si2_j, si2_h = (a.astype(np.float32) for a in si2_np)
    si2_state = si2_trainer.init(3)
    _build.reset_launches()
    si2_state, si2_loss = si2_trainer.step(
        si2_state, *(torch.from_numpy(a).cuda() for a in (si2_t, si2_x, si2_u)),
        target_jac=torch.from_numpy(si2_j).cuda(), target_hess=torch.from_numpy(si2_h).cuda())
    torch.cuda.synchronize()
    si2_step_launches = dict(_build.LAUNCHES)
    got, want = _body_launches("shapenet_hessian_grads", {k: 0 for k in si2_step_launches}, "tc")
    _build.reset_launches()
    si2_eval = si2_trainer.evaluate_sobolev(si2_state, si2_t, si2_x, si2_u, si2_j,
                                            target_hess=si2_h, group_batch=8)
    si2_eval_launches = dict(_build.LAUNCHES)
    log(f"the mma.sync K7/K8's own path (a flagship-width model of two inputs, G=8, P=4096): "
        f"one Hessian step, loss {float(si2_loss):.6e}, launches {si2_step_launches}; "
        f"evaluate_sobolev {si2_eval}, launches {si2_eval_launches}")
    got7, want7 = _body_launches("shapenet_fwd_hess", {k: 0 for k in si2_eval_launches}, "tc")
    if (got != want or got7 != want7 or not np.isfinite(float(si2_loss))
            or not all(np.isfinite(v) for v in si2_eval.values())):
        raise AssertionError("the two-input model did not take one mma.sync K8 and one mma.sync "
                             "K7")
    del si2_trainer, si2_state
    # the mma.sync K7 and K8 against plain at this path's shape (G=8, P=4096,
    # si = 2), K8 unweighted as the step calls it and weighted
    k7_si2_err = check_k7(torch, si2_cfg, "siren", 8, 4096, torch.bfloat16, seed=75, body="tc")
    k8_si2_err = max(check_k8(torch, si2_cfg, "siren", 8, 4096, torch.bfloat16, weighted, False,
                              seed=96, body="tc") for weighted in (False, True))

    # ---- phase 3e: serve and train the NIF-linear model
    ltrainer, lstate, (t_l, x_l, u_l) = flagship_linear_step(G, P)
    lmodel = ltrainer.model
    linfo = lmodel.fast_path_info(P)
    if linfo["path"] != "fused":
        raise AssertionError(f"NIF-linear training would not take K4: {linfo}")
    x_lc = lmodel._compute(x_l)
    _build.reset_launches()
    with torch.inference_mode():
        served = lmodel.apply_grouped(t_l, x_l, fused=True)
        torch.cuda.synchronize()
        lserve_launches = dict(_build.LAUNCHES)
        trunk_wb = lmodel._trunk_flat_weights().to(x_lc.dtype).expand(G, -1)
        phi_plain = shapenet_grouped_fused_reference(trunk_wb, x_lc, lmodel._trunk_cfg, "siren")
        a_l = lmodel.p_to_lr(t_l)
        plain = (torch.einsum("gpok,gk->gpo", phi_plain.reshape(G, P, 1, -1), a_l)
                 + lmodel.snet.bias.to(a_l.dtype)).float()
        eager = lmodel.apply_grouped(t_l, x_l, fused=False).float()
    if served.shape != (G, P, 1) or not bool(torch.isfinite(served).all()):
        raise AssertionError(f"NIF-linear apply_grouped(fused=True): {served.shape}, or not finite")
    d_plain = float((served - plain).abs().max())
    r_eager = float(rel_l2(served, eager))
    trunk_kernel = k1_variant(x_lc.dtype, lmodel._trunk_cfg)
    log(f"NIF-linear apply_grouped(fused=True) G={G} P={P}: launches {lserve_launches} (the "
        f"{trunk_kernel} K1 for the trunk's {lmodel._trunk_cfg.output_dim} columns); max|u| "
        f"{float(plain.abs().max()):.4f}, max|d| vs plain K1 trunk {d_plain:.3e}, rel-L2 vs the "
        f"eager trunk {r_eager:.4f}")
    got, want = _body_launches("shapenet_fwd", {k: 0 for k in lserve_launches}, trunk_kernel)
    if got != want or sum(lserve_launches.values()) != 1 + int(trunk_kernel != "simt"):
        raise AssertionError(f"apply_grouped(fused=True) launched {lserve_launches}, not one "
                             f"{trunk_kernel} K1")
    if d_plain > 1e-2 * float(plain.abs().max()) or r_eager > 0.15:
        raise AssertionError("NIF-linear apply_grouped(fused=True) departs from plain K1 or eager")
    del served, plain, eager, phi_plain, trunk_wb
    rng = np.random.default_rng(3)
    t_m = rng.standard_normal((40, 4)).astype(np.float32)
    x_m = rng.uniform(-1, 1, (8192, 3)).astype(np.float32)
    _build.reset_launches()
    mesh_out = predict_shared_mesh(lmodel, t_m, x_m, group_batch=16)
    mesh_launches = dict(_build.LAUNCHES)
    with torch.inference_mode():
        x_rep = np.ascontiguousarray(np.broadcast_to(x_m, (40, 8192, 3)))
        mesh_ref = lmodel.apply_grouped(t_m, x_rep).float().cpu()
    d_mesh = float((torch.from_numpy(mesh_out) - mesh_ref).abs().max())
    log(f"predict_shared_mesh (40 snapshots onto one 8192-point mesh, chunks of 16): "
        f"{mesh_out.shape} {mesh_out.dtype}, max|d| vs apply_grouped on the repeated mesh "
        f"{d_mesh:.3e} (max|u| {float(mesh_ref.abs().max()):.4f}); launches {mesh_launches}")
    if (mesh_out.shape != (40, 8192, 1) or not np.isfinite(mesh_out).all()
            or d_mesh > 1e-2 * float(mesh_ref.abs().max())):
        raise AssertionError("predict_shared_mesh departs from apply_grouped")
    loss_k, lgrads_k = lmodel.mse_value_and_grad(t_l, x_l, u_l)
    a_l = lmodel.pnet(lmodel._compute(t_l))[0]
    cdt = x_lc.dtype
    lws, lbs = lmodel._trunk_lists()
    lp = niflinear_mse_grads_reference([w.detach().to(cdt) for w in lws],
                                       [b.detach().to(cdt) for b in lbs], a_l.detach().to(cdt),
                                       lmodel.snet.bias.detach().to(cdt), x_lc, u_l,
                                       lmodel._trunk_cfg, 1)
    pnet_params = list(lmodel.pnet.params.parameters())
    plain_grads = dict(zip(map(id, pnet_params),
                           torch.autograd.grad(a_l, pnet_params, lp[3].to(a_l.dtype))))
    plain_grads.update(zip(map(id, [*lws, *lbs, lmodel.snet.bias]), [*lp[1], *lp[2], lp[4]]))
    l_rel = abs(float(loss_k) - float(lp[0])) / abs(float(lp[0]))
    worst = 0.0
    for path, p in lmodel.param_items():
        got = lgrads_k
        for key in path:
            got = got[key]
        worst = max(worst, float(rel_l2(got, plain_grads[id(p)])))
    log(f"NIF-linear step 0 ({linfo}): loss {float(loss_k):.6e} vs plain K4 {float(lp[0]):.6e} "
        f"(rel {l_rel:.2e}); ParameterNet and trunk grads vs plain K4 + autograd: worst "
        f"rel-L2 {worst:.2e}")
    if l_rel > BF16_LOSS_REL or worst > 1e-2:
        raise AssertionError("the NIF-linear step's loss or grads depart from plain K4")
    del lp, plain_grads, lgrads_k
    _build.reset_launches()
    llosses = []
    for _ in range(n_steps):
        lstate, loss = ltrainer.step(lstate, t_l, x_l, u_l)
        llosses.append(loss)
    torch.cuda.synchronize()
    lin_launches = dict(_build.LAUNCHES)
    llosses = [float(v) for v in llosses]
    log(f"NIF-linear train: {n_steps} steps, losses {llosses}, launches {lin_launches}, "
        f"path {ltrainer.history.get('path')}")
    if (lin_launches["niflinear_mse_grads"] != n_steps
            or lin_launches["niflinear_mse_grads_tc"] != n_steps
            or lin_launches["shapenet_mse_grads"] or not all(np.isfinite(llosses))):
        raise AssertionError(f"{n_steps} NIF-linear steps launched {lin_launches}, "
                             f"losses {llosses}")
    # the float32 policy: the CUDA-core K4, full f32 products
    f32_trainer = GroupedTrainer(
        nif_tpu_torch.NIFMultiScaleLastLayerParameterized(LINEAR_SHAPE, FLAGSHIP_PNET, "float32",
                                                          device="cuda", seed=1),
        lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR))
    f32_state = f32_trainer.init(1)
    _build.reset_launches()
    f32_losses = []
    for _ in range(2):
        f32_state, loss = f32_trainer.step(f32_state, t_l, x_l, u_l)
        f32_losses.append(loss)
    torch.cuda.synchronize()
    f32_launches = dict(_build.LAUNCHES)
    f32_losses = [float(v) for v in f32_losses]
    log(f"NIF-linear train, float32 policy: 2 steps, losses {f32_losses}, launches "
        f"{f32_launches}")
    if (f32_launches["niflinear_mse_grads"] != 2 or f32_launches["niflinear_mse_grads_tc"]
            or not all(np.isfinite(f32_losses))):
        raise AssertionError(f"2 float32 NIF-linear steps launched {f32_launches}")
    # the launches went to the body on the f32 tile machinery: one wave of
    # one block per SM over all groups' tiles, its planes in shared memory
    # (a grid of 8 splits a group would not)
    lgeo = linear_geometry(lmodel._trunk_cfg, 1, G, P, torch.float32)
    log(f"the float32 K4's geometry at G={G} P={P}: {lgeo}")
    if (lgeo["variant"], lgeo["tile"], lgeo["residuals"], lgeo["blocks"]) != (
            "simt", 64, "shared", min(sms, G * (P // 64))):
        raise AssertionError(f"the float32 NIF-linear step did not take the redesigned K4: "
                             f"{lgeo}")
    lmodel_w = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(
        LINEAR_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY, device="cuda", seed=1)
    lfitter = GroupedTrainer(lmodel_w, lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR))
    lfstate = lfitter.init(1)
    _build.reset_launches()
    lfstate = lfitter.fit(lfstate, t_w, x_w, u_w, epochs=30, group_batch=8, point_batch=4096)
    lfit_launches = dict(_build.LAUNCHES)
    lhist = lfitter.history["loss"]
    log(f"NIF-linear fit on the traveling wave (G=16, P=8192, 4096-point batches, 30 epochs): "
        f"epoch losses first {lhist[0]:.6e} last {lhist[-1]:.6e}; launches {lfit_launches}; "
        f"evaluate_metrics {lfitter.evaluate_metrics(lfstate, t_w, x_w, u_w)}")
    if lfit_launches["niflinear_mse_grads"] != 60 or not lhist[-1] < lhist[0]:
        raise AssertionError("the NIF-linear fit did not take K4 for every step or did not "
                             "lower the loss")
    lsinfo = lmodel.sobolev_path_info(P, 3)
    if lsinfo["path"] != "fused":
        raise AssertionError(f"NIF-linear Sobolev training would not take K6: {lsinfo}")
    wb_eff, cfg_eff = lmodel._fwd_jac_effective_chain(t_s)
    rv, rj, r_wb = shapenet_sobolev_grads_reference(
        wb_eff.detach(), lmodel._compute(x_s), u_s, j_s.transpose(2, 3).reshape(G, P, 3),
        cfg_eff, "siren")
    lsgrads_p = torch.autograd.grad(wb_eff, [p for _, p in lmodel.param_items()], r_wb)
    _build.reset_launches()
    _, lterms_k, lsgrads_k = lmodel.sobolev_value_and_grad(t_s, x_s, u_s, target_jac=j_s)
    torch.cuda.synchronize()
    lsob_launches = dict(_build.LAUNCHES)
    ls_rel = [abs(float(a) - float(b)) / abs(float(b))
              for a, b in ((lterms_k["value_mse"], rv), (lterms_k["jacobian_mse"], rj))]
    worst = 0.0
    for (path, _), b in zip(lmodel.param_items(), lsgrads_p):
        got = lsgrads_k
        for key in path:
            got = got[key]
        worst = max(worst, float(rel_l2(got, b)))
    log(f"NIF-linear Sobolev step ({lsinfo}): launches {lsob_launches}; value "
        f"{float(lterms_k['value_mse']):.6e} jac {float(lterms_k['jacobian_mse']):.6e} vs plain "
        f"K6 on the effective chain (rel {ls_rel[0]:.2e}, {ls_rel[1]:.2e}); trunk and "
        f"ParameterNet grads vs plain K6 + autograd: worst rel-L2 {worst:.2e}")
    if (lsob_launches["shapenet_sobolev_grads"] != 1
            or lsob_launches["shapenet_sobolev_grads_tc"] != 1 or sum(lsob_launches.values()) != 2
            or max(ls_rel) > BF16_LOSS_REL or worst > 1e-2):
        raise AssertionError("the NIF-linear Sobolev step did not take one tensor-core K6 or "
                             "departs from plain K6")
    del wb_eff, r_wb, lsgrads_p, lsgrads_k
    _build.reset_launches()
    lafter = lfitter.evaluate_sobolev(lfstate, t_w, x_w, u_w, j_w,
                                      group_batch=16 // eval_chunks)
    leval_launches = dict(_build.LAUNCHES)
    eff_kernel = k5_variant(x_lc.dtype, lmodel._derivative_kernel_cfg()[0], "siren", 3)
    log(f"NIF-linear evaluate_sobolev after the fit ({eval_chunks} chunks): {lafter}; "
        f"launches {leval_launches} (the {eff_kernel} K5 on the effective chain)")
    got, want = _body_launches("shapenet_fwd_jac", {k: 0 for k in leval_launches}, eff_kernel,
                               n=eval_chunks)
    if got != want or not all(np.isfinite(v) for v in lafter.values()):
        raise AssertionError(f"NIF-linear evaluate_sobolev launched {leval_launches}")

    # ---- phase 3f: the Jacobian evaluation of tutorial 8's model (si = so = 1,
    # width 30, random weights from a seed) at G=32, P=32768 under both
    # policies: one launch of K5's tangent body per chunk (one chunk), the
    # tensor-core body in bf16 and none of the other bodies, K6's forward half
    # on the CUDA cores in float32; then tutorial 3's NIF-linear model, whose
    # effective chain (si = so = 2) takes the body k5_variant picks
    t8_host = tutorial8_data(G, P, seed=60)
    t8 = {}
    for policy, dtype in ((FLAGSHIP_POLICY, torch.bfloat16), ("float32", torch.float32)):
        t8_model = nif_tpu_torch.NIFMultiScale(TUTORIAL8_S, TUTORIAL8_P, policy, device="cuda",
                                               seed=0)
        t8_trainer = GroupedTrainer(t8_model, lambda p: torch.optim.Adam(p, lr=1e-4))
        t8_state = t8_trainer.init(0)
        t8_geo = derivative_geometry("tangent", t8_model.cfg_shape_net, "siren", G, P, dtype)
        _build.reset_launches()
        t8_out = t8_trainer.evaluate_sobolev(t8_state, *t8_host)
        t8_launches = dict(_build.LAUNCHES)
        tc = int(dtype == torch.bfloat16)
        body = "tc" if tc else "simt"
        log(f"tutorial 8 evaluate_sobolev, {policy} (G={G} P={P}, one chunk): {t8_out}; "
            f"launches {t8_launches}; {describe_geometry(t8_geo)}")
        if (t8_launches["shapenet_fwd_jac"] != 1 or t8_launches["shapenet_fwd_jac_tc"] != tc
                or sum(t8_launches.values()) != 1 + tc or t8_geo["body"] != body
                or not all(np.isfinite(v) for v in t8_out.values())):
            raise AssertionError(f"tutorial 8's {policy} Jacobian evaluation launched "
                                 f"{t8_launches} on {t8_geo}, not one {body} tangent body")
        tt8, tx8 = (torch.as_tensor(a, device="cuda") for a in t8_host[:2])
        with torch.inference_mode():
            y8, jac8 = output_and_jacobian_grouped(t8_model, tt8, tx8)
            y8_ref, jac8_ref = shapenet_fwd_jac_reference(
                t8_model._derivative_weights(tt8), t8_model._compute(tx8), t8_model.cfg_shape_net,
                "siren")
        for what, out, ref in (("y", y8, y8_ref), ("jac", jac8, jac8_ref)):
            err, scale = max_diff(torch, out, ref, f"tutorial 8 {policy} {what}")
            bound = 2e-4 * scale + 1e-5 if dtype == torch.float32 else BF16_REL * scale
            log(f"tutorial 8 {policy} grouped {what} against plain K5: max|d| {err:.3e} "
                f"({err / max(scale, 1e-30):.2e} of max|plain|)")
            if err > bound:
                raise AssertionError(f"tutorial 8's {policy} {what} departs from plain K5")
        t8[dtype] = (t8_trainer, t8_state, t8_launches, t8_geo)
        del tt8, tx8, y8, jac8, y8_ref, jac8_ref
    for policy, dtype in ((FLAGSHIP_POLICY, torch.bfloat16), ("float32", torch.float32)):
        t3_model = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(
            TUTORIAL3_S, TUTORIAL3_P, policy, device="cuda", seed=0)
        rng = np.random.default_rng(61)
        tt3 = torch.as_tensor(rng.uniform(0, 1, (8, 1)).astype(np.float32), device="cuda")
        tx3 = torch.as_tensor(rng.uniform(-1, 1, (8, 4096, 2)).astype(np.float32),
                              device="cuda")
        cfg3 = t3_model._derivative_kernel_cfg()[0]
        kernel = k5_variant(dtype, cfg3, "siren", 2)
        _build.reset_launches()
        with torch.inference_mode():
            y3, jac3 = output_and_jacobian_grouped(t3_model, tt3, tx3)
            t3_launches = dict(_build.LAUNCHES)
            y3_ref, jac3_ref = shapenet_fwd_jac_reference(
                t3_model._derivative_weights(tt3), t3_model._compute(tx3), cfg3, "siren")
        errs = [max_diff(torch, out, ref, f"tutorial 3 {policy}")
                for out, ref in ((y3, y3_ref), (jac3, jac3_ref))]
        rel = BF16_REL if dtype == torch.bfloat16 else 2e-4
        log(f"tutorial 3 (NIF-linear, effective chain si=so=2 n=30) output_and_jacobian_grouped, "
            f"{policy}, G=8 P=4096: the {kernel} K5 ({t3_launches}); y, jac max|d| of max|plain| "
            f"{', '.join(f'{e / max(sc, 1e-30):.2e}' for e, sc in errs)}")
        got3, want3 = _body_launches("shapenet_fwd_jac", {k: 0 for k in t3_launches}, kernel)
        if (got3 != want3
                or any(e > rel * sc + (1e-5 if dtype == torch.float32 else 0.0)
                       for e, sc in errs)):
            raise AssertionError(f"tutorial 3's {policy} Jacobian launched {t3_launches} or "
                                 f"departs from plain K5")
        del t3_model, tt3, tx3, y3, jac3, y3_ref, jac3_ref

    # ---- phase 3g: GroupedTrainer.fit_resident, the residual sampling and
    # the point-wise Trainer
    resident_np = phase_resident(torch, log)

    # ---- phase 3h: L-BFGS fine-tuning through K2, K6 and K8
    lbfgs_times = phase_lbfgs(torch, log)

    # ---- phase 3i: streamed grouped training from shards through
    # prefetch_to_device
    stream_dir = tempfile.TemporaryDirectory(prefix="nif_stream_")
    stream_ds = phase_stream(torch, log, stream_dir.name)

    # ---- phase 4: K1 times at the flagship shape (bf16, as served; the
    # CUDA-core K1 on the same inputs and in float32)
    G, P = requests[0]
    t, x = inputs[0]
    with torch.inference_mode():
        wb = model.p_to_w(t)
        xc = model.policy.cast_to_compute(x, device=model.device)
        k1_ms = cuda_ms(lambda: shapenet_fwd_cuda(wb, xc, flag_cfg, "siren"), reps=20)
        k1_simt_ms = cuda_ms(lambda: _shapenet_fwd_simt(wb, xc, flag_cfg, "siren"), reps=10)
        # the wgmma and the mma.sync bodies on the same inputs, in turns
        k1_body_ms = {}
        for body in ("tc", "wgmma", "wgmma", "tc"):
            k1_body_ms.setdefault(body, []).append(
                cuda_ms(lambda: _shapenet_fwd_on(body, wb, xc, flag_cfg, "siren"), reps=20))
        plain_ms = cuda_ms(lambda: shapenet_grouped_fused_reference(
            wb, xc, flag_cfg, "siren"), reps=5, warmup=1)
        wbf, xf = wb.float(), xc.float()
        k1f_ms = cuda_ms(lambda: shapenet_fwd_cuda(wbf, xf, flag_cfg, "siren"), reps=10)
        k1f_plain_ms = cuda_ms(lambda: shapenet_grouped_fused_reference(
            wbf, xf, flag_cfg, "siren"), reps=5, warmup=1)
        t_dev, x_dev = torch.from_numpy(t).cuda(), torch.from_numpy(x).cuda()
        e2e_ms = cuda_ms(lambda: model.apply_grouped(t_dev, x_dev), reps=20)
        t0 = time.perf_counter()
        for _ in range(3):
            predict_grouped(model, t, x)
        serve_ms = (time.perf_counter() - t0) / 3 * 1e3
    k1_cost = kernel_cost("K1", flag_cfg, G, P)
    mma_flops, sine_flops, nbytes = (k1_cost[k] for k in ("products", "elementwise", "bytes"))
    t_bytes = nbytes / peaks[2] * 1e3
    bound_ms, k1_by = kernel_bound_ms(k1_cost, peaks)
    k1f_bound, k1f_by, _ = kernel_bound("K1", flag_cfg, G, P, peaks, f32=True)
    del wbf, xf
    log(f"K1 bf16, tensor cores: {k1_ms:.4f} ms (wrapper incl. omega prescale) = "
        f"{mma_flops / 1e9 / k1_ms:.2f} TFLOP/s of products, the CUDA-core K1 on the same bf16 "
        f"inputs {k1_simt_ms:.4f} ms ({k1_simt_ms / k1_ms:.2f}x), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (products {mma_flops / 1e9:.1f} GFLOP -> "
        f"{mma_flops / peaks[0] * 1e3:.4f} ms, sine {sine_flops / 1e9:.2f} GFLOP -> "
        f"{sine_flops / peaks[1] * 1e3:.4f} ms, {nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms); "
        f"K1 f32, CUDA cores: {k1f_ms:.4f} ms, plain {k1f_plain_ms:.4f} ms, bound "
        f"{k1f_bound:.4f} ms (f32 peak); library_ms null: no single PyTorch call computes this "
        f"chain")
    log(f"K1 bf16 bodies in turns on the same inputs (tc, wgmma, wgmma, tc; ms): wgmma "
        f"{k1_body_ms['wgmma']}, mma.sync {k1_body_ms['tc']}; routed: "
        f"{bf16_body_counter('shapenet_fwd')} (card {smi})")
    log(f"end to end apply_grouped (f32 inputs on the card) G={G} P={P}: {e2e_ms:.4f} ms = "
        f"{G * P / e2e_ms * 1e3:.4e} points/s; predict_grouped from host arrays: "
        f"{serve_ms:.4f} ms = {G * P / serve_ms * 1e3:.4e} points/s")
    # the float32 policy's serving (the CUDA-core K1): apply_grouped on inputs
    # on the card and predict_grouped from host arrays, each on the device
    # clock and on the host clock (each call synchronized)
    f32_model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, "float32",
                                            device="cuda", seed=0)
    with torch.inference_mode():
        f32_apply = lambda: f32_model.apply_grouped(t_dev, x_dev)  # noqa: E731
        f32_apply_ms = cuda_ms(f32_apply, reps=20)
        f32_apply_host_ms = host_ms(torch, f32_apply, reps=20)
    f32_predict = lambda: predict_grouped(f32_model, t, x)  # noqa: E731
    f32_predict_ms = cuda_ms(f32_predict, reps=5, warmup=1)
    f32_predict_host_ms = host_ms(torch, f32_predict, reps=5)
    del f32_model
    log(f"float32 policy (the CUDA-core K1), G={G} P={P}: apply_grouped (inputs on the card) "
        f"{f32_apply_ms:.4f} ms on the device clock = {G * P / f32_apply_ms * 1e3:.4e} points/s, "
        f"{f32_apply_host_ms:.4f} ms on the host clock (mean of 20); predict_grouped from host "
        f"arrays {f32_predict_ms:.4f} ms on the device clock = "
        f"{G * P / f32_predict_ms * 1e3:.4e} points/s, {f32_predict_host_ms:.4f} ms on the host "
        f"clock (mean of 5)")

    # ---- phase 4b: train-step, K2 and K3 times at the flagship shape (bf16)
    G, P = 32, 32768
    step_box = [state]

    def one_step():
        step_box[0], _ = trainer.step(step_box[0], t_tr, x_tr, u_tr)

    step_ms = cuda_ms(one_step, reps=10)
    mstages = mse_step_stages(torch, trainer, step_box[0], (t_tr, x_tr, u_tr))
    wb, x = chain_data(torch, flag_cfg, G, P, torch.bfloat16, seed=15)
    tgt, _, g = side_data(torch, flag_cfg, G, P, seed=15)
    g = g.to(torch.bfloat16)
    k2_ms = cuda_ms(lambda: shapenet_mse_grads_cuda(wb, x, tgt, flag_cfg, "siren"), reps=10,
                    warmup=2)
    k2_simt_ms = cuda_ms(lambda: _shapenet_mse_grads_simt(wb, x, tgt, flag_cfg, "siren"),
                         reps=5, warmup=1)
    k2_plain_ms = cuda_ms(lambda: shapenet_mse_grads_reference(wb, x, tgt, flag_cfg, "siren"),
                          reps=3, warmup=1)
    f32_in = (wb.float(), x.float(), tgt)
    k2f_ms = cuda_ms(lambda: shapenet_mse_grads_cuda(*f32_in, flag_cfg, "siren"), reps=5,
                     warmup=1)
    k2f_plain_ms = cuda_ms(lambda: shapenet_mse_grads_reference(*f32_in, flag_cfg, "siren"),
                           reps=3, warmup=1)
    del f32_in
    k3_ms = cuda_ms(lambda: shapenet_bwd_cuda(wb, x, g, flag_cfg, "siren"), reps=10, warmup=2)
    # the wgmma and the mma.sync bodies on the same inputs, in turns
    body_ms = {}
    for kernel, body in (("K2", "tc"), ("K2", "wgmma"), ("K2", "wgmma"), ("K2", "tc"),
                         ("K3", "tc"), ("K3", "wgmma"), ("K3", "wgmma"), ("K3", "tc")):
        if kernel == "K2":
            fn = lambda: _shapenet_mse_grads_on(body, wb, x, tgt, flag_cfg, "siren")  # noqa: E731
        else:
            fn = lambda: _shapenet_bwd_on(body, wb, x, g, flag_cfg, "siren")  # noqa: E731
        body_ms.setdefault((kernel, body), []).append(cuda_ms(fn, reps=10, warmup=2))
    k3_simt_ms = cuda_ms(lambda: _shapenet_bwd_simt(wb, x, g, flag_cfg, "siren"), reps=5,
                         warmup=1)
    k3_plain_ms = cuda_ms(lambda: shapenet_fused_bwd_reference(wb, x, g, flag_cfg, "siren"),
                          reps=3, warmup=1)
    f32_in = (wb.float(), x.float(), g.float())
    k3f_ms = cuda_ms(lambda: shapenet_bwd_cuda(*f32_in, flag_cfg, "siren"), reps=5, warmup=1)
    k3f_plain_ms = cuda_ms(lambda: shapenet_fused_bwd_reference(*f32_in, flag_cfg, "siren"),
                           reps=3, warmup=1)
    del f32_in
    # the float32 policy's step (the CUDA-core K2), on the device and the host clock
    f32_box = [f32_mse_state]

    def one_f32_step():
        f32_box[0], _ = f32_mse_trainer.step(f32_box[0], t_tr, x_tr, u_tr)

    f32_step_ms = cuda_ms(one_f32_step, reps=10)
    t0 = time.perf_counter()
    for _ in range(10):
        one_f32_step()
        torch.cuda.synchronize()
    f32_step_host_ms = (time.perf_counter() - t0) / 10 * 1e3
    f32_stages = mse_step_stages(torch, f32_mse_trainer, f32_box[0], (t_tr, x_tr, u_tr))
    del f32_mse_trainer, f32_mse_state, f32_box
    k2_bound, k2_by, k2_gf = kernel_bound("K2", flag_cfg, G, P, peaks)
    k2f_bound, k2f_by, _ = kernel_bound("K2", flag_cfg, G, P, peaks, f32=True)
    k3_bound, k3_by, k3_gf = kernel_bound("K3", flag_cfg, G, P, peaks)
    k3f_bound, k3f_by, _ = kernel_bound("K3", flag_cfg, G, P, peaks, f32=True)
    log(f"flagship train step (GroupedTrainer.step, Adam, bf16, G={G} P={P}): {step_ms:.4f} ms "
        f"= {G * P / step_ms * 1e3:.4e} train points/s; stages timed alone: "
        f"{', '.join(f'{k} {v:.4f} ms' for k, v in mstages.items())}")
    log(f"K2 bf16, tensor cores: {k2_ms:.4f} ms (wrapper incl. prescale, workspace and reduce) "
        f"= {k2_gf / k2_ms:.2f} TFLOP/s of products, the CUDA-core K2 on the same bf16 inputs "
        f"{k2_simt_ms:.4f} ms ({k2_simt_ms / k2_ms:.2f}x), plain {k2_plain_ms:.4f} ms, bound "
        f"{k2_bound:.4f} ms by {k2_by} ({k2_gf:.1f} GFLOP of products); K2 f32, CUDA cores: "
        f"{k2f_ms:.4f} ms, plain {k2f_plain_ms:.4f} ms, bound {k2f_bound:.4f} ms by {k2f_by} "
        f"(f32 peak); K3 bf16, tensor cores: {k3_ms:.4f} ms = {k3_gf / k3_ms:.2f} TFLOP/s of "
        f"products, the CUDA-core K3 on the same bf16 inputs {k3_simt_ms:.4f} ms "
        f"({k3_simt_ms / k3_ms:.2f}x), plain {k3_plain_ms:.4f} ms, bound "
        f"{k3_bound:.4f} ms by {k3_by} ({k3_gf:.1f} GFLOP); K3 f32 {k3f_ms:.4f} ms, plain "
        f"{k3f_plain_ms:.4f} ms, bound {k3f_bound:.4f} ms by {k3f_by} (f32 peak); library_ms "
        f"null: no single PyTorch call computes these chains")
    log(f"K2 and K3 bf16 at G={G} P={P}, the wgmma body and the mma.sync body in turns (tc, "
        f"wgmma, wgmma, tc; ms): K2 wgmma {body_ms[('K2', 'wgmma')]}, mma.sync "
        f"{body_ms[('K2', 'tc')]}; K3 wgmma {body_ms[('K3', 'wgmma')]}, mma.sync "
        f"{body_ms[('K3', 'tc')]}; routed: K2 {bf16_body_counter('shapenet_mse_grads')}, K3 "
        f"{bf16_body_counter('shapenet_bwd')} (card {smi})")
    log(f"flagship train step, float32 policy (GroupedTrainer.step, Adam, the CUDA-core K2, "
        f"G={G} P={P}): {f32_step_ms:.4f} ms on the device clock = "
        f"{G * P / f32_step_ms * 1e3:.4e} train points/s, {f32_step_host_ms:.4f} ms on the host "
        f"clock (each step synchronized); stages timed alone: "
        f"{', '.join(f'{k} {v:.4f} ms' for k, v in f32_stages.items())}")
    log_step_report(f"4b GroupedTrainer.step, bf16 (K2 counted as "
                    f"{bf16_body_counter('shapenet_mse_grads')})", trainer.model, G, P, step_ms,
                    False, smi)
    log_step_report("4b GroupedTrainer.step, float32 policy", trainer.model, G, P, f32_step_ms,
                    True, smi)

    # ---- phase 4c: Sobolev-step, K5 and K6 times at the flagship shape (bf16;
    # K6 also on the CUDA-core kernel on the same inputs, and in float32)
    sbox = [sstate]

    def one_sobolev_step():
        sbox[0], _ = strainer.step(sbox[0], t_s, x_s, u_s, target_jac=j_s)

    sstep_ms = cuda_ms(one_sobolev_step, reps=5, warmup=1)
    wb, x = chain_data(torch, flag_cfg, G, P, torch.bfloat16, seed=52)
    tgt, _, jt = sobolev_data(torch, flag_cfg, G, P, seed=52)
    k5_ms = cuda_ms(lambda: shapenet_fwd_jac_cuda(wb, x, flag_cfg, "siren"), reps=10)
    # the wgmma and the mma.sync reverse bodies on the same inputs, in turns
    k5_body_ms = {}
    for body in ("tc", "wgmma", "wgmma", "tc"):
        k5_body_ms.setdefault(body, []).append(
            cuda_ms(lambda: _shapenet_fwd_jac_on(body, wb, x, flag_cfg, "siren"), reps=10))
    log(f"K5 (reverse) bf16 bodies in turns on the same inputs (tc, wgmma, wgmma, tc; ms): "
        f"wgmma {k5_body_ms['wgmma']}, mma.sync {k5_body_ms['tc']}; routed: "
        f"{bf16_body_counter('shapenet_fwd_jac')} (card {smi})")
    k5_simt_ms = cuda_ms(lambda: _shapenet_fwd_jac_simt(wb, x, flag_cfg, "siren"), reps=5,
                         warmup=1)
    k5_plain_ms = cuda_ms(lambda: shapenet_fwd_jac_reference(wb, x, flag_cfg, "siren"),
                          reps=3, warmup=1)
    wbf, xf = wb.float(), x.float()
    k5f_ms = cuda_ms(lambda: shapenet_fwd_jac_cuda(wbf, xf, flag_cfg, "siren"), reps=5, warmup=1)
    k5f_plain_ms = cuda_ms(lambda: shapenet_fwd_jac_reference(wbf, xf, flag_cfg, "siren"),
                           reps=3, warmup=1)
    del wbf, xf
    k6_ms = cuda_ms(lambda: shapenet_sobolev_grads_cuda(wb, x, tgt, jt, flag_cfg, "siren"),
                    reps=10, warmup=2)
    k6_simt_ms = cuda_ms(lambda: _shapenet_sobolev_grads_simt(wb, x, tgt, jt, flag_cfg,
                                                              "siren"), reps=3, warmup=1)
    k6_plain_ms = cuda_ms(lambda: shapenet_sobolev_grads_reference(
        wb, x, tgt, jt, flag_cfg, "siren"), reps=2, warmup=1)
    f32_in = (wb.float(), x.float(), tgt, jt)
    k6f_ms = cuda_ms(lambda: shapenet_sobolev_grads_cuda(*f32_in, flag_cfg, "siren"), reps=3,
                     warmup=1)
    k6f_plain_ms = cuda_ms(lambda: shapenet_sobolev_grads_reference(*f32_in, flag_cfg, "siren"),
                           reps=2, warmup=1)
    del wb, x, tgt, jt, f32_in
    # the float32 policy's Sobolev step (the CUDA-core K6), on the device and
    # the host clock, with its stages
    sf32_box = [sf32_state]

    def one_f32_sobolev_step():
        sf32_box[0], _ = sf32_trainer.step(sf32_box[0], t_s, x_s, u_s, target_jac=j_s)

    sf32_step_ms = cuda_ms(one_f32_sobolev_step, reps=5, warmup=1)
    t0 = time.perf_counter()
    for _ in range(5):
        one_f32_sobolev_step()
        torch.cuda.synchronize()
    sf32_step_host_ms = (time.perf_counter() - t0) / 5 * 1e3
    sf32_stages = sobolev_step_stages(torch, sf32_trainer, sf32_box[0], (t_s, x_s, u_s, j_s))
    # the float32 policy's Jacobian evaluation at the flagship shape from host
    # arrays (one launch of the CUDA-core K5 reverse body: one chunk of 32
    # groups), on the device clock and on the host clock
    eval_host = tuple(a.cpu().numpy() for a in (t_s, x_s, u_s, j_s))
    jeval = lambda: sf32_trainer.evaluate_sobolev(sf32_box[0], *eval_host)  # noqa: E731
    before = dict(_build.LAUNCHES)
    jeval()
    got, want = _body_launches("shapenet_fwd_jac", before, "simt")
    if got != want:
        raise AssertionError("the float32 flagship Jacobian evaluation did not launch the "
                             "CUDA-core K5 once")
    jeval_ms = cuda_ms(jeval, reps=3, warmup=0)
    jeval_host_ms = host_ms(torch, jeval, reps=3)
    del sf32_trainer, sf32_state, sf32_box, eval_host
    # K5's tangent body (so >= si) at si = so = 3, the flagship widths: bf16 on
    # the tensor cores, beside the CUDA-core body on the same inputs, and f32
    # on the CUDA-core body (K6's forward half)
    wb, x = chain_data(torch, tan_cfg, G, P, torch.bfloat16, seed=53)
    before = dict(_build.LAUNCHES)
    k5t_ms = cuda_ms(lambda: shapenet_fwd_jac_cuda(wb, x, tan_cfg, "siren"), reps=10, warmup=2)
    if (_build.LAUNCHES["shapenet_fwd_jac"] != before["shapenet_fwd_jac"] + 12
            or _build.LAUNCHES["shapenet_fwd_jac_tc"] != before["shapenet_fwd_jac_tc"] + 12):
        raise AssertionError("bf16 K5 at so = si did not take the tensor-core tangent body")
    k5t_simt_ms = cuda_ms(lambda: _shapenet_fwd_jac_simt(wb, x, tan_cfg, "siren"), reps=5,
                          warmup=1)
    k5t_plain_ms = cuda_ms(lambda: shapenet_fwd_jac_reference(wb, x, tan_cfg, "siren"), reps=2,
                           warmup=1)
    wbf, xf = wb.float(), x.float()
    k5tf_ms = cuda_ms(lambda: shapenet_fwd_jac_cuda(wbf, xf, tan_cfg, "siren"), reps=10, warmup=2)
    k5tf_plain_ms = cuda_ms(lambda: shapenet_fwd_jac_reference(wbf, xf, tan_cfg, "siren"),
                            reps=2, warmup=1)
    del wb, x, wbf, xf
    # tutorial 8's Jacobian evaluation from host arrays (one chunk, one
    # tangent-body launch) under both policies, on the device and host clocks,
    # and the tangent body alone on that call's weights and coordinates
    t8_ms = {}
    tt8, tx8 = (torch.as_tensor(a, device="cuda") for a in t8_host[:2])
    for dtype, (t8_trainer, t8_state, _, _) in t8.items():
        def t8_eval(tr=t8_trainer, st=t8_state):
            return tr.evaluate_sobolev(st, *t8_host)

        t8_model = t8_trainer.model
        with torch.inference_mode():
            wb8, x8 = t8_model._derivative_weights(tt8), t8_model._compute(tx8)

        def t8_kernel(wb=wb8, x=x8, cfg=t8_model.cfg_shape_net):
            return shapenet_fwd_jac_cuda(wb, x, cfg, "siren")

        t8_ms[dtype] = (cuda_ms(t8_eval, reps=5, warmup=1), host_ms(torch, t8_eval, reps=5),
                        cuda_ms(t8_kernel, reps=10, warmup=2))
    del tt8, tx8, wb8, x8
    k5t_bound, k5t_by, k5t_gf = kernel_bound("K5", tan_cfg, G, P, peaks, body="tangent")
    k5tf_bound, k5tf_by, _ = kernel_bound("K5", tan_cfg, G, P, peaks, f32=True, body="tangent")
    k5_bound, k5_by, k5_gf = kernel_bound("K5", flag_cfg, G, P, peaks)
    k5f_bound, k5f_by, _ = kernel_bound("K5", flag_cfg, G, P, peaks, f32=True)
    k6_bound, k6_by, k6_gf = kernel_bound("K6", flag_cfg, G, P, peaks)
    k6f_bound, k6f_by, _ = kernel_bound("K6", flag_cfg, G, P, peaks, f32=True)
    log(f"flagship Sobolev step (GroupedTrainer.step with target_jac, Adam, bf16, G={G} "
        f"P={P}): {sstep_ms:.4f} ms = {G * P / sstep_ms * 1e3:.4e} train points/s")
    log(f"K5 (reverse) bf16, tensor cores: {k5_ms:.4f} ms = {k5_gf / k5_ms:.2f} TFLOP/s of "
        f"products, the CUDA-core K5 on the same bf16 inputs {k5_simt_ms:.4f} ms "
        f"({k5_simt_ms / k5_ms:.2f}x), plain {k5_plain_ms:.4f} ms, bound {k5_bound:.4f} ms by "
        f"{k5_by} ({k5_gf:.1f} GFLOP of products); K5 (reverse) f32, CUDA cores: {k5f_ms:.4f} "
        f"ms, plain {k5f_plain_ms:.4f} ms, bound {k5f_bound:.4f} ms by {k5f_by} (f32 peak); K6 "
        f"bf16, tensor cores: {k6_ms:.4f} ms "
        f"(wrapper incl. prescale, workspace and reduce) = {k6_gf / k6_ms:.2f} TFLOP/s of "
        f"products, the CUDA-core K6 on the same bf16 inputs {k6_simt_ms:.4f} ms "
        f"({k6_simt_ms / k6_ms:.2f}x), plain {k6_plain_ms:.4f} ms, bound {k6_bound:.4f} ms by "
        f"{k6_by} ({k6_gf:.1f} GFLOP); K6 f32, CUDA cores: {k6f_ms:.4f} ms = "
        f"{k6_gf / k6f_ms:.2f} TFLOP/s of products, plain {k6f_plain_ms:.4f} ms, bound "
        f"{k6f_bound:.4f} ms by {k6f_by} (f32 peak); library_ms null: no single PyTorch call "
        f"computes these chains")
    log(f"flagship Sobolev step, float32 policy (GroupedTrainer.step with target_jac, Adam, "
        f"the CUDA-core K6, G={G} P={P}): {sf32_step_ms:.4f} ms on the device clock = "
        f"{G * P / sf32_step_ms * 1e3:.4e} train points/s, {sf32_step_host_ms:.4f} ms on the "
        f"host clock (each step synchronized); stages timed alone: "
        f"{', '.join(f'{k} {v:.4f} ms' for k, v in sf32_stages.items())}")
    log(f"flagship Jacobian evaluation, float32 policy (GroupedTrainer.evaluate_sobolev from "
        f"host arrays, one launch of the CUDA-core K5, G={G} P={P}): {jeval_ms:.4f} ms on the "
        f"device clock = {G * P / jeval_ms * 1e3:.4e} points/s, {jeval_host_ms:.4f} ms on the "
        f"host clock (mean of 3)")
    log(f"K5 (tangent body, si=3 so=3 n=128, G={G} P={P}) bf16, tensor cores: {k5t_ms:.4f} ms "
        f"= {k5t_gf / k5t_ms:.2f} TFLOP/s of products, the CUDA-core body on the same bf16 "
        f"inputs {k5t_simt_ms:.4f} ms ({k5t_simt_ms / k5t_ms:.2f}x), plain {k5t_plain_ms:.4f} "
        f"ms, bound {k5t_bound:.4f} ms by {k5t_by} ({k5t_gf:.1f} GFLOP of products); f32, CUDA "
        f"cores (K6's forward half): {k5tf_ms:.4f} ms = {k5t_gf / k5tf_ms:.2f} TFLOP/s of "
        f"products, plain {k5tf_plain_ms:.4f} ms, bound {k5tf_bound:.4f} ms by {k5tf_by} (f32 "
        f"peak); library_ms null: no single PyTorch call computes this chain")
    for dtype, (dev, host, kernel_ms) in t8_ms.items():
        policy = FLAGSHIP_POLICY if dtype == torch.bfloat16 else "float32"
        log(f"tutorial 8 Jacobian evaluation ({policy} policy; GroupedTrainer.evaluate_sobolev "
            f"from host arrays, one launch of the {t8[dtype][3]['body']} tangent body, G={G} "
            f"P={P}): {dev:.4f} ms on the device clock = {G * P / dev * 1e3:.4e} points/s, "
            f"{host:.4f} ms on the host clock (mean of 5); the tangent body alone on its "
            f"weights and coordinates {kernel_ms:.4f} ms ({kernel_ms / dev:.1%} of the call)")

    # ---- phase 4d: Hessian-step, K7 and K8 times at the flagship shape (bf16)
    hbox = [hstate]

    def one_hessian_step():
        hbox[0], _ = htrainer.step(hbox[0], t_h, x_h, u_h, target_jac=j_h, target_hess=h_h)

    hstep_ms = cuda_ms(one_hessian_step, reps=3, warmup=1)
    hstages = hessian_step_stages(torch, htrainer, hbox[0], (t_h, x_h, u_h, j_h, h_h))
    wb, x = chain_data(torch, flag_cfg, G, P, torch.bfloat16, seed=92)
    tgt, _, jt, ht = hessian_data(torch, flag_cfg, G, P, seed=92)
    k7_ms = cuda_ms(lambda: shapenet_fwd_hess_cuda(wb, x, flag_cfg, "siren"), reps=10, warmup=2)
    k7_simt_ms = cuda_ms(lambda: _shapenet_fwd_hess_simt(wb, x, flag_cfg, "siren"), reps=3,
                         warmup=1)
    k7_plain_ms = cuda_ms(lambda: plain_k7_chunked(torch, wb, x, flag_cfg), reps=2, warmup=1)
    k8_ms = cuda_ms(lambda: shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht, flag_cfg, "siren"),
                    reps=5, warmup=1)
    k8_simt_ms = cuda_ms(lambda: _shapenet_hessian_grads_simt(wb, x, tgt, jt, ht, flag_cfg,
                                                              "siren"), reps=3, warmup=1)
    k8_plain_ms = cuda_ms(lambda: plain_k8_chunked(torch, wb, x, tgt, jt, ht, flag_cfg),
                          reps=2, warmup=1)
    # the two bf16 bodies of K7 and K8 in turns (wgmma, mma.sync, mma.sync,
    # wgmma) on the same inputs
    hess_body_ms = {}
    for kernel, reps, launch in (
            ("K7", 10, lambda body: _shapenet_fwd_hess_on(body, wb, x, flag_cfg, "siren")),
            ("K8", 5, lambda body: _shapenet_hessian_grads_on(body, wb, x, tgt, jt, ht, flag_cfg,
                                                              "siren"))):
        for body in ("wgmma", "tc", "tc", "wgmma"):
            hess_body_ms.setdefault((kernel, body), []).append(
                cuda_ms(lambda: launch(body), reps=reps, warmup=1))
    # the mma.sync K7 and K8 at the shape of their own path (the two-input
    # model, G=8, P=4096), beside their plain versions
    wb2, x2 = chain_data(torch, si2_cfg, 8, 4096, torch.bfloat16, seed=97)
    tgt2, _, jt2, ht2 = hessian_data(torch, si2_cfg, 8, 4096, seed=97)
    k7_si2_ms = cuda_ms(lambda: shapenet_fwd_hess_cuda(wb2, x2, si2_cfg, "siren"), reps=10,
                        warmup=2)
    k7_si2_plain_ms = cuda_ms(lambda: plain_k7_chunked(torch, wb2, x2, si2_cfg), reps=3,
                              warmup=1)
    k8_si2_ms = cuda_ms(lambda: shapenet_hessian_grads_cuda(wb2, x2, tgt2, jt2, ht2, si2_cfg,
                                                            "siren"), reps=10, warmup=2)
    k8_si2_plain_ms = cuda_ms(lambda: plain_k8_chunked(torch, wb2, x2, tgt2, jt2, ht2, si2_cfg),
                              reps=3, warmup=1)
    del wb2, x2, tgt2, jt2, ht2
    k7_si2_bound, k7_si2_by, _ = kernel_bound("K7", si2_cfg, 8, 4096, peaks)
    k8_si2_bound, k8_si2_by, _ = kernel_bound("K8", si2_cfg, 8, 4096, peaks)
    log(f"the mma.sync K7/K8 on their own path's shape (si = 2, G=8, P=4096, bf16): K7 "
        f"{k7_si2_ms:.4f} ms, plain {k7_si2_plain_ms:.4f} ms, bound {k7_si2_bound:.4f} ms by "
        f"{k7_si2_by}; K8 {k8_si2_ms:.4f} ms, plain {k8_si2_plain_ms:.4f} ms, bound "
        f"{k8_si2_bound:.4f} ms by {k8_si2_by}")
    torch.cuda.reset_peak_memory_stats()
    plain_k8_chunked(torch, wb, x, tgt, jt, ht, flag_cfg)
    torch.cuda.synchronize()
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    f32_in = (wb.float(), x.float(), tgt, jt, ht)
    k7f_ms = cuda_ms(lambda: shapenet_fwd_hess_cuda(*f32_in[:2], flag_cfg, "siren"), reps=5,
                     warmup=1)
    k7f_plain_ms = cuda_ms(lambda: plain_k7_chunked(torch, *f32_in[:2], flag_cfg), reps=2,
                           warmup=1)
    k8f_ms = cuda_ms(lambda: shapenet_hessian_grads_cuda(*f32_in, flag_cfg, "siren"), reps=5,
                     warmup=1)
    k8f_plain_ms = cuda_ms(lambda: plain_k8_chunked(torch, *f32_in, flag_cfg), reps=2, warmup=1)
    del wb, x, tgt, jt, ht, f32_in
    # the float32 policy's Hessian step (the CUDA-core K8), on the device and
    # the host clock
    hf32_box = [hf32_state]

    def one_f32_hessian_step():
        hf32_box[0], _ = hf32_trainer.step(hf32_box[0], t_h, x_h, u_h, target_jac=j_h,
                                           target_hess=h_h)

    hf32_step_ms = cuda_ms(one_f32_hessian_step, reps=3, warmup=1)
    t0 = time.perf_counter()
    for _ in range(3):
        one_f32_hessian_step()
        torch.cuda.synchronize()
    hf32_step_host_ms = (time.perf_counter() - t0) / 3 * 1e3
    hf32_stages = hessian_step_stages(torch, hf32_trainer, hf32_box[0],
                                      (t_h, x_h, u_h, j_h, h_h))
    del hf32_trainer, hf32_state, hf32_box
    k7_bound, k7_by, k7_gf = kernel_bound("K7", flag_cfg, G, P, peaks)
    k7f_bound, k7f_by, _ = kernel_bound("K7", flag_cfg, G, P, peaks, f32=True)
    k8_bound, k8_by, k8_gf = kernel_bound("K8", flag_cfg, G, P, peaks)
    k8f_bound, k8f_by, _ = kernel_bound("K8", flag_cfg, G, P, peaks, f32=True)
    log(f"flagship Hessian step (GroupedTrainer.step with target_jac and target_hess, Adam, "
        f"bf16, G={G} P={P}): {hstep_ms:.4f} ms = {G * P / hstep_ms * 1e3:.4e} train points/s; "
        f"stages timed alone: {', '.join(f'{k} {v:.4f} ms' for k, v in hstages.items())}")
    for kernel in ("K7", "K8"):
        log(f"{kernel} bf16 bodies in turns (wgmma, mma.sync, mma.sync, wgmma): wgmma "
            f"{', '.join(f'{v:.4f}' for v in hess_body_ms[(kernel, 'wgmma')])} ms against "
            f"mma.sync {', '.join(f'{v:.4f}' for v in hess_body_ms[(kernel, 'tc')])} ms; "
            f"routed to the {k7_body if kernel == 'K7' else k8_body} body")
    log(f"K7 bf16, tensor cores: {k7_ms:.4f} ms = {k7_gf / k7_ms:.2f} TFLOP/s of products, "
        f"the CUDA-core K7 on the same bf16 inputs {k7_simt_ms:.4f} ms "
        f"({k7_simt_ms / k7_ms:.2f}x), plain {k7_plain_ms:.4f} ms, bound {k7_bound:.4f} ms by "
        f"{k7_by} ({k7_gf:.1f} GFLOP of products); K7 f32, CUDA cores: {k7f_ms:.4f} ms, plain "
        f"{k7f_plain_ms:.4f} ms, bound {k7f_bound:.4f} ms by {k7f_by} (f32 peak); K8 bf16, "
        f"tensor cores: {k8_ms:.4f} ms (wrapper incl. "
        f"prescale, workspace and reduce) = {k8_gf / k8_ms:.2f} TFLOP/s of products, the "
        f"CUDA-core K8 on the same bf16 inputs {k8_simt_ms:.4f} ms, plain {k8_plain_ms:.4f} ms, "
        f"bound {k8_bound:.4f} ms by {k8_by} ({k8_gf:.1f} GFLOP); K8 f32, CUDA cores: "
        f"{k8f_ms:.4f} ms, plain {k8f_plain_ms:.4f} ms, bound {k8f_bound:.4f} ms by {k8f_by} "
        f"(f32 peak); the plain versions ran in 4 chunks of 8 groups (peak {plain_peak_gb:.1f} "
        f"GB allocated for plain K8); library_ms null: no single PyTorch call computes these "
        f"chains")
    log(f"flagship Hessian step, float32 policy (GroupedTrainer.step with target_jac and "
        f"target_hess, Adam, the CUDA-core K8, G={G} P={P}): {hf32_step_ms:.4f} ms on the device "
        f"clock = {G * P / hf32_step_ms * 1e3:.4e} train points/s, {hf32_step_host_ms:.4f} ms on "
        f"the host clock (each step synchronized); stages timed alone: "
        f"{', '.join(f'{k} {v:.4f} ms' for k, v in hf32_stages.items())}")

    # ---- phase 4e: NIF-linear step, K4 and eager-step times (bf16)
    lbox = [lstate]

    def one_linear_step():
        lbox[0], _ = ltrainer.step(lbox[0], t_l, x_l, u_l)

    lstep_ms = cuda_ms(one_linear_step, reps=10)
    eager_trainer = GroupedTrainer(lmodel, ltrainer.make_optimizer, fused=False)
    eager_ms = cuda_ms(lambda: eager_trainer.step(lbox[0], t_l, x_l, u_l), reps=5, warmup=2)
    lcfg, lso, lws, lbs, la, lbias, lx, ltgt, _ = linear_data(
        torch, LINEAR_CASES[0], G, P, torch.bfloat16, seed=112)
    k4_ms = cuda_ms(lambda: niflinear_mse_grads_cuda(lws, lbs, la, lbias, lx, ltgt, lcfg, lso),
                    reps=10)
    k4_plain_ms = cuda_ms(lambda: niflinear_mse_grads_reference(lws, lbs, la, lbias, lx, ltgt,
                                                                lcfg, lso), reps=3, warmup=1)
    f32_in = [[v.float() for v in lws], [v.float() for v in lbs], la.float(), lbias.float(),
              lx.float(), ltgt]
    k4f_ms = cuda_ms(lambda: niflinear_mse_grads_cuda(*f32_in, lcfg, lso), reps=3, warmup=1)
    k4f_plain_ms = cuda_ms(lambda: niflinear_mse_grads_reference(*f32_in, lcfg, lso), reps=3,
                           warmup=1)
    del lws, lbs, la, lbias, lx, ltgt, f32_in
    # the float32 policy's NIF-linear step (the CUDA-core K4) on the device
    # and the host clock, with its stages, and its eager step beside it
    lf32_box = [f32_state]

    def one_f32_linear_step():
        lf32_box[0], _ = f32_trainer.step(lf32_box[0], t_l, x_l, u_l)

    lf32_step_ms = cuda_ms(one_f32_linear_step, reps=10)
    t0 = time.perf_counter()
    for _ in range(10):
        one_f32_linear_step()
        torch.cuda.synchronize()
    lf32_step_host_ms = (time.perf_counter() - t0) / 10 * 1e3
    lf32_stages = linear_step_stages(torch, f32_trainer, lf32_box[0], (t_l, x_l, u_l))
    eager_f32 = GroupedTrainer(f32_trainer.model, f32_trainer.make_optimizer, fused=False)
    eager_f32_ms = cuda_ms(lambda: eager_f32.step(lf32_box[0], t_l, x_l, u_l), reps=5, warmup=2)
    del f32_trainer, f32_state, lf32_box, eager_f32
    k4_bound, k4_by, k4_gf = kernel_bound("K4", lcfg, G, P, peaks, so=lso)
    k4f_bound, k4f_by, k4f_gf = kernel_bound("K4", lcfg, G, P, peaks, f32=True, so=lso)
    log(f"NIF-linear train step (GroupedTrainer.step, Adam, bf16, G={G} P={P}): {lstep_ms:.4f} "
        f"ms = {G * P / lstep_ms * 1e3:.4e} train points/s; eager step (autograd over the eager "
        f"trunk + Adam): {eager_ms:.4f} ms = {G * P / eager_ms * 1e3:.4e} train points/s")
    log(f"K4 bf16, tensor cores: {k4_ms:.4f} ms (wrapper incl. prescale, workspace and "
        f"reduce) = {k4_gf / k4_ms:.2f} TFLOP/s of products, plain {k4_plain_ms:.4f} ms, bound "
        f"{k4_bound:.4f} ms by {k4_by} ({k4_gf:.1f} GFLOP of products); K4 f32, CUDA cores: "
        f"{k4f_ms:.4f} ms = {k4f_gf / k4f_ms:.2f} TFLOP/s of products, plain "
        f"{k4f_plain_ms:.4f} ms, bound {k4f_bound:.4f} ms by {k4f_by} (f32 peak; {k4f_gf:.1f} "
        f"GFLOP of products and matrix-vector work: the bottleneck's backward as outer "
        f"products); library_ms "
        f"null: no single PyTorch call computes this pass")
    log(f"NIF-linear train step, float32 policy (GroupedTrainer.step, Adam, the CUDA-core K4, "
        f"G={G} P={P}): {lf32_step_ms:.4f} ms on the device clock = "
        f"{G * P / lf32_step_ms * 1e3:.4e} train points/s, {lf32_step_host_ms:.4f} ms on the "
        f"host clock (each step synchronized); stages timed alone: "
        f"{', '.join(f'{k} {v:.4f} ms' for k, v in lf32_stages.items())}; the eager float32 "
        f"step (autograd over the eager trunk + Adam): {eager_f32_ms:.4f} ms = "
        f"{G * P / eager_f32_ms * 1e3:.4e} train points/s")

    # ---- phase 4f: the resident step's times beside step and fit
    phase_resident_timing(torch, log, resident_np, smi)

    # ---- phase 4g: L-BFGS, streamed-step and first-order optimizer times
    phase_optimizer_timing(torch, log, lbfgs_times, stream_ds, resident_np, smi)
    stream_dir.cleanup()

    # ---- phase 3j: the int8 ROM decode of the NIF-linear flagship, and its times
    for policy in ("mixed_bfloat16", "float32"):
        rom_decode_phase(torch, log, smi, policy)

    # ---- phase 3k: export_apply/load_exported on the card (K1 as a registered op)
    exported = export_phase(torch, log, smi)

    # ---- phase 3l: MagnitudePruning in GroupedTrainer.step and fit_resident
    pruning_phase(torch, log, smi, resident_np)

    # ---- phase 3m: the command line at the flagship's width
    phase_cli(torch, log, smi)

    # ---- phase 3n: two ranks on the one card over gloo
    phase_two_ranks(torch, log, smi)

    # ---- phase 3o: NCCL at world size 1, fit_resident's graph holding the all_reduce
    phase_nccl(torch, log, smi)

    # ---- phase 3p: the tutorials on the card, tutorial 13 at paper scale
    phase_examples(torch, log, smi)
    log(f"card: {smi}")
    log(f"chip_smoke wall clock: {time.perf_counter() - wall0:.1f} s (builds included)")
    log(json.dumps({"kernels": [{
        "name": "shapenet_fwd",
        "route": "cuda",
        "body": "tc",
        "source": "nif_tpu_torch/csrc/shapenet_fwd_tc.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:489",
        "launches": lserve_launches["shapenet_fwd_tc"],
        "path": "the NIF-linear trunk (so = 128)",
        "op": "torch.ops.nif_tpu_torch.shapenet_fwd",
        "max_abs_err": k1_body_errs["tc"],
        "ms": float(np.mean(k1_body_ms["tc"])),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_wg",
        "route": "cuda",
        "body": "wgmma",
        "source": "nif_tpu_torch/csrc/shapenet_fwd_wgmma.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:489",
        "launches": serve_launches["shapenet_fwd_wg"],
        "path": "the flagship served",
        "op": "torch.ops.nif_tpu_torch.shapenet_fwd",
        "exported_launches": exported["mixed_bfloat16"]["launches"],
        "max_abs_err": k1_body_errs["wgmma"],
        "ms": float(np.mean(k1_body_ms["wgmma"])),
        "routed_ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_f32",
        "route": "cuda",
        "body": f32_serve_geo["body"],
        "source": "nif_tpu_torch/csrc/shapenet_fwd.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:489",
        "launches": f32_serve_launches["shapenet_fwd"],
        "op": "torch.ops.nif_tpu_torch.shapenet_fwd",
        "exported_launches": exported["float32"]["launches"],
        "max_abs_err": k1f_err,
        "ms": k1f_ms,
        "plain_ms": k1f_plain_ms,
        "bound_ms": k1f_bound,
        "bound_by": k1f_by,
        "library_ms": None,
    }, {
        "name": "shapenet_mse_grads",
        "route": "cuda",
        "body": "tc",
        "source": "nif_tpu_torch/csrc/shapenet_bwd_tc.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:786",
        "launches": (train_launches["shapenet_mse_grads_tc"]
                     or w256_launches["shapenet_mse_grads_tc"]),
        "path": ("the flagship step" if train_launches["shapenet_mse_grads_tc"]
                 else "the w256_d2 step"),
        "max_abs_err": k2_body_errs["tc"],
        "ms": float(np.mean(body_ms[("K2", "tc")])),
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }, {
        "name": "shapenet_mse_grads_wg",
        "route": "cuda",
        "body": "wgmma",
        "source": "nif_tpu_torch/csrc/shapenet_bwd_wgmma.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:786",
        "launches": train_launches["shapenet_mse_grads_wg"],
        "path": "the flagship step",
        "max_abs_err": k2_body_errs["wgmma"],
        "ms": float(np.mean(body_ms[("K2", "wgmma")])),
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }, {
        "name": "shapenet_mse_grads_f32",
        "route": "cuda",
        "source": "nif_tpu_torch/csrc/shapenet_bwd.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:786",
        "launches": mse_f32_launches["shapenet_mse_grads"],
        "max_abs_err": k2f_err,
        "ms": k2f_ms,
        "plain_ms": k2f_plain_ms,
        "bound_ms": k2f_bound,
        "bound_by": k2f_by,
        "library_ms": None,
    }, {
        "name": "shapenet_bwd",
        "route": "cuda",
        "body": "tc",
        "source": "nif_tpu_torch/csrc/shapenet_bwd_tc.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:702",
        "launches": bwd_path["shapenet_bwd_tc"] or w256_launches["shapenet_bwd_tc"],
        "path": ("the flagship autograd phase" if bwd_path["shapenet_bwd_tc"]
                 else "the w256_d2 backward"),
        "max_abs_err": k3_body_errs["tc"],
        "ms": float(np.mean(body_ms[("K3", "tc")])),
        "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound,
        "bound_by": k3_by,
        "library_ms": None,
    }, {
        "name": "shapenet_bwd_wg",
        "route": "cuda",
        "body": "wgmma",
        "source": "nif_tpu_torch/csrc/shapenet_bwd_wgmma.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:702",
        "launches": bwd_path["shapenet_bwd_wg"],
        "path": "the flagship autograd phase",
        "max_abs_err": k3_body_errs["wgmma"],
        "ms": float(np.mean(body_ms[("K3", "wgmma")])),
        "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound,
        "bound_by": k3_by,
        "library_ms": None,
    }, {
        "name": "shapenet_bwd_f32",
        "route": "cuda",
        "source": "nif_tpu_torch/csrc/shapenet_bwd.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:702",
        "launches": bwd_f32_path["shapenet_bwd"],
        "max_abs_err": k3f_err,
        "ms": k3f_ms,
        "plain_ms": k3f_plain_ms,
        "bound_ms": k3f_bound,
        "bound_by": k3f_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_jac",
        "route": "cuda",
        "body": "tc",
        "source": "nif_tpu_torch/csrc/shapenet_fwd_tc.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:1445",
        "launches": res_eval_launches["shapenet_fwd_jac_tc"],
        "path": "the two-resblock model's evaluate_sobolev",
        "max_abs_err": k5_body_errs["tc"],
        "ms": float(np.mean(k5_body_ms["tc"])),
        "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound,
        "bound_by": k5_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_jac_wg",
        "route": "cuda",
        "body": "wgmma",
        "source": "nif_tpu_torch/csrc/shapenet_fwd_wgmma.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:1445",
        "launches": eval_launches["shapenet_fwd_jac_wg"],
        "path": "the flagship's evaluate_sobolev",
        "max_abs_err": k5_body_errs["wgmma"],
        "ms": float(np.mean(k5_body_ms["wgmma"])),
        "routed_ms": k5_ms,
        "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound,
        "bound_by": k5_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_jac_f32",
        "route": "cuda",
        "body": jf32_geo["body"],
        "source": "nif_tpu_torch/csrc/shapenet_fwd.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:1445",
        "launches": jf32_eval_launches["shapenet_fwd_jac"],
        "max_abs_err": k5f_err,
        "ms": k5f_ms,
        "plain_ms": k5f_plain_ms,
        "bound_ms": k5f_bound,
        "bound_by": k5f_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_jac_tangent",
        "route": "cuda",
        "body": t8[torch.bfloat16][3]["body"],
        "source": "nif_tpu_torch/csrc/shapenet_jac_tc.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:1375",
        "launches": t8[torch.bfloat16][2]["shapenet_fwd_jac_tc"],
        "max_abs_err": k5t_err,
        "ms": k5t_ms,
        "plain_ms": k5t_plain_ms,
        "bound_ms": k5t_bound,
        "bound_by": k5t_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_jac_tangent_f32",
        "route": "cuda",
        "body": t8[torch.float32][3]["body"],
        "source": "nif_tpu_torch/csrc/shapenet_jac.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:1375",
        "launches": t8[torch.float32][2]["shapenet_fwd_jac"],
        "max_abs_err": k5tf_err,
        "ms": k5tf_ms,
        "plain_ms": k5tf_plain_ms,
        "bound_ms": k5tf_bound,
        "bound_by": k5tf_by,
        "library_ms": None,
    }, {
        "name": "shapenet_sobolev_grads",
        "route": "cuda",
        "source": "nif_tpu_torch/csrc/shapenet_jac_tc.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:1698",
        "launches": sob_launches["shapenet_sobolev_grads_tc"],
        "max_abs_err": k6_err,
        "ms": k6_ms,
        "plain_ms": k6_plain_ms,
        "bound_ms": k6_bound,
        "bound_by": k6_by,
        "library_ms": None,
    }, {
        "name": "shapenet_sobolev_grads_f32",
        "route": "cuda",
        "source": "nif_tpu_torch/csrc/shapenet_jac.cu",
        "body": "sob_simt_kernel (on stack_simt.cuh)",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:1698",
        "launches": sf32_launches["shapenet_sobolev_grads"],
        "max_abs_err": k6f_err,
        "ms": k6f_ms,
        "plain_ms": k6f_plain_ms,
        "bound_ms": k6f_bound,
        "bound_by": k6f_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_hess",
        "route": "cuda",
        "body": "tc",
        "source": "nif_tpu_torch/csrc/shapenet_hess_tc.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:2223",
        "launches": si2_eval_launches["shapenet_fwd_hess_tc"],
        "path": "the two-input model's evaluate_sobolev (si = 2, G=8, P=4096)",
        "max_abs_err": k7_si2_err,
        "ms": k7_si2_ms,
        "plain_ms": k7_si2_plain_ms,
        "bound_ms": k7_si2_bound,
        "bound_by": k7_si2_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_hess_wg",
        "route": "cuda",
        "body": "wgmma",
        "source": "nif_tpu_torch/csrc/shapenet_hess_wgmma.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:2223",
        "launches": heval_launches["shapenet_fwd_hess_wg"],
        "path": "the flagship's evaluate_sobolev",
        "max_abs_err": k7_body_errs["wgmma"],
        "ms": float(np.mean(hess_body_ms[("K7", "wgmma")])),
        "routed_ms": k7_ms,
        "mma_sync_ms": float(np.mean(hess_body_ms[("K7", "tc")])),
        "mma_sync_max_abs_err": k7_body_errs["tc"],
        "plain_ms": k7_plain_ms,
        "bound_ms": k7_bound,
        "bound_by": k7_by,
        "library_ms": None,
    }, {
        "name": "shapenet_fwd_hess_f32",
        "route": "cuda",
        "source": "nif_tpu_torch/csrc/shapenet_hess.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:2223",
        "launches": hf32_eval_launches["shapenet_fwd_hess"],
        "max_abs_err": k7f_err,
        "ms": k7f_ms,
        "plain_ms": k7f_plain_ms,
        "bound_ms": k7f_bound,
        "bound_by": k7f_by,
        "library_ms": None,
    }, {
        "name": "shapenet_hessian_grads",
        "route": "cuda",
        "body": "tc",
        "source": "nif_tpu_torch/csrc/shapenet_hess_tc.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:2326",
        "launches": si2_step_launches["shapenet_hessian_grads_tc"],
        "path": "the two-input model's Hessian step (si = 2, G=8, P=4096)",
        "max_abs_err": k8_si2_err,
        "ms": k8_si2_ms,
        "plain_ms": k8_si2_plain_ms,
        "bound_ms": k8_si2_bound,
        "bound_by": k8_si2_by,
        "library_ms": None,
    }, {
        "name": "shapenet_hessian_grads_wg",
        "route": "cuda",
        "body": "wgmma",
        "source": "nif_tpu_torch/csrc/shapenet_hess_wgmma.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:2326",
        "launches": hess_launches["shapenet_hessian_grads_wg"],
        "path": "the flagship Hessian step",
        "max_abs_err": k8_body_errs["wgmma"],
        "ms": float(np.mean(hess_body_ms[("K8", "wgmma")])),
        "routed_ms": k8_ms,
        "mma_sync_ms": float(np.mean(hess_body_ms[("K8", "tc")])),
        "mma_sync_max_abs_err": k8_body_errs["tc"],
        "plain_ms": k8_plain_ms,
        "bound_ms": k8_bound,
        "bound_by": k8_by,
        "library_ms": None,
    }, {
        "name": "shapenet_hessian_grads_f32",
        "route": "cuda",
        "source": "nif_tpu_torch/csrc/shapenet_hess.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:2326",
        "launches": hf32_launches["shapenet_hessian_grads"],
        "max_abs_err": k8f_err,
        "ms": k8f_ms,
        "plain_ms": k8f_plain_ms,
        "bound_ms": k8f_bound,
        "bound_by": k8f_by,
        "library_ms": None,
    }, {
        "name": "niflinear_mse_grads",
        "route": "cuda",
        "source": "nif_tpu_torch/csrc/shapenet_linear_tc.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:1044",
        "launches": lin_launches["niflinear_mse_grads_tc"],
        "max_abs_err": k4_err,
        "ms": k4_ms,
        "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound,
        "bound_by": k4_by,
        "library_ms": None,
    }, {
        "name": "niflinear_mse_grads_f32",
        "route": "cuda",
        "source": "nif_tpu_torch/csrc/shapenet_linear.cu",
        "body": "linear_simt_kernel (on stack_simt.cuh)",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:1044",
        "launches": f32_launches["niflinear_mse_grads"],
        "max_abs_err": k4f_err,
        "ms": k4f_ms,
        "plain_ms": k4f_plain_ms,
        "bound_ms": k4f_bound,
        "bound_by": k4f_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

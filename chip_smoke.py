#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Fails at once without a CUDA device; prints the card's name and power
   limit (nvidia-smi).
2. Builds the port's CUDA kernels from dreamfusion_tpu_torch/csrc into
   build/torch_kernels (set-up time; one nvcc per source, all started
   together, then one link; sm_90a).
3. For each kernel, at the shapes of the flagship training step (K1-K4)
   and of the SD 2.1 and SD 1.5 towers (K10-K12), compares the kernel with
   its plain PyTorch version on the same inputs and times both, and the
   one PyTorch call that computes the same function where there is one
   (CUDA events, median after warm-up; fp32 convs against cuDNN with TF32
   off).  K10's and K12's forwards have routes chosen by shape (wgmma +
   TMA at the UNet's head dims, d = 64 for SD 2.1 and 40, 80, 160 for SD
   1.5, each its own route, and at d = 512; K12's wgmma route at stride 1
   and 2, its narrow-input wgmma route for the conv_ins and its narrow
   fp32 one), each checked and timed under its own name at the shapes
   that take it; K10 on JAX's branch (q·scale rounded to bf16 first on the
   chunked one, as the plain version does) beside SDPA.  K12's mma.sync
   forward and dgrad serve the CLIP towers' patch embeddings (zero123's
   ViT-L/14 at start-up, step 9; CLIP guidance's ViT-B/16 every step,
   step 10): the SD runs must not launch them, and they are checked and
   timed at shapes of their own too (``MMA_CONVS``).  Then K10-K12 again at
   zero123's shapes (``ZERO123_CONVS``, ``ZERO123_ATTNS``,
   ``zero123_groupnorms``: the UNet at 32² latents, its cross-attention
   over one key, where the output must be v bit for bit, the VAE at 256²,
   the patch conv), each with its graph ms too.  K12's input gradient,
   likewise, at every
   dgrad shape of the SD step (the VAE encoder's backward): its wgmma
   route (stride 1, and stride 2 as four parity classes in one launch),
   its narrow route (the conv_in's 3-channel dx) and its fp32 route (the
   conv_out's) each under its own name, beside cuDNN's input gradient; the
   mma.sync dgrad (``conv_dgrad``) at ``MMA_CONVS``' shapes and the CLIP
   patch conv's (step 10), with 0 SD launches.  K11 (GroupNorm + SiLU,
   CUDA) at every shape of the SD step
   (``SD_GROUPNORMS``), forward and, for the VAE's, backward, each on the
   route ``group_norm_route`` gives (resident in a cluster's shared
   memory, or streaming), beside ``F.group_norm`` (+ ``F.silu``) and its
   backward; K10's backward (wgmma + TMA) at the VAE mid-block's shape
   beside SDPA's backward.  Each kernel's bound is the larger of its
   bytes (each input read once, each output written once) at 3.35 TB/s and its
   operations at the H100's peak for their type (989 TFLOP/s bf16 tensor
   core, 67 TFLOP/s fp32; K10's softmax exponentials, one a logit, at
   3.9e12/s, whichever of the two operation times is longer).
   K2 as the render's march region (the cube's near/far, the march and
   the clamped sample positions in one launch) and as the kernel from
   torch's near/far, each against its plain twin, with the region's
   samples held to the other's.
   K1 beside ``F.grid_sample`` (bilinear, align_corners=True, the three
   planes as a batch: the features) and its backward (their VJP into the
   planes and the positions).  K4 (CUDA: the head alone, and the head with
   the normals and the shading folded in, at every shading id) and K3
   (with every background form: a [3] colour or the background MLP's
   chosen on the device, one a ray, white, none; and the orient loss) at
   the flagship step's shapes, h and tangents from the flagship MLP, and
   at an eval chunk (4096 rays of an 800² view: the head alone, K3 with the
   white background), each with its graph ms (``graph_ms``).  K6 (hash encode forward with the jacobian
   and backward, tv and wd, forward and backward) runs at the flagship
   spec (L4C8 affine smoothstep, 2^19 rows per hashed level) at the step's
   98,304 sample positions and the grid refresh's 262,144-position chunk,
   and again in the tcnn layout (L16C2 xor).  K1 and K6 again at the DMTet
   stage's albedo query with the step's own inputs: the 262,144 positions
   K7 interpolates on the 512² view below (the missed pixels at x01 = 0.5),
   cotangents zero where no triangle covers the pixel; each encoder's
   forward, table-only backward and backward with the position gradient
   (``triplane_bwd_dx``, ``hashgrid_bwd_dx``: one launch for both
   gradients).
   K7 (rasterize + interpolate, forward and backward) and K8 (marching
   tets and the three mesh regularizers, forward and backward) run at the
   DMTet stage's shapes: tet_grid_size 128 (274,625 grid vertices,
   1,572,864 tets, ~1.9M edge slots, 131,072 triangle slots) and 512²
   renders; K7's forward also at the texture bake's 1024² (after step 4,
   on the mesh it exported).  K7's tile lists must equal ``tile_lists``'
   (each tile's first cap triangles by index); K8's faces, mask and slots
   must equal the plain version's bit for bit, and normal consistency's
   pairs (from the static tet adjacency) the plain version's sorted-key
   pairs, and its true face count (the slots past max_tris included) the
   plain version's; K7's per-tile counts (before its tile_cap cut) the
   plain version's.  K7's bound counts the function's work, not an implementation's:
   each triangle set up and binned once into the tiles its box touches,
   then ~20 fp32 operations per (pixel, listed triangle).
4. Resets the launch counters and trains the flagship-width oracle path
   (stage 1) through dreamfusion_tpu_torch.main for 300 steps, with one
   eval (validation PNGs at 800²), rolling checkpoints, an 8-frame 800²
   turntable (cut from 100 frames) and the textured mesh export; requires
   a finite loss at every logged step, finite gradients, a launch of
   K1-K4, K3's backward and K4's shade pair exactly once a step and the
   head's backward never (``run_render_launches``), an analytic-scene PSNR
   at least 3 dB above the initial one, and the PNGs, checkpoint, mesh.obj
   (> 0 faces) and albedo PNG on disk; logs each phase's time.  Then two
   steps built as main builds them, the counters reset before each
   (``stage1_step_launches``): K2, K3 and K4 exactly as
   ``step_render_launches`` counts, and the head 8 times more in the step
   that refreshes the 128³ grid.  Then K7 again at the DMTet path's own
   shape (``dmtet_surface_raster_phase``): the surface that step 6 starts
   from, at the renderer's tile_cap, in the far training view whose
   fullest tile lists the most (thousands of triangles: several 1024-slot
   windows of the backwards), forward and both backwards against the plain
   versions; its rows are K7's in the JSON line.
5. Resets the counters and trains the SD 2.1 path (full SD 2.1 width,
   random weights from the seed) through dreamfusion_tpu_torch.main for 25
   steps: 6 warm-up steps (render as latent) and 19 through the VAE;
   requires finite losses and gradients, a launch of every kernel (every
   route of K10's and K12's forwards and of K12's dgrad: per VAE step 23
   wgmma, 1 narrow and 1 fp32 dgrads, ``SD_DGRADS``, and none on mma.sync;
   K11's routes exactly as ``SD_GROUPNORMS`` counts them, K10's d = 64
   route 32 times a step, its d = 512 forward and its backward once per
   VAE step), K2, K3 and K4 exactly (the shade pair and K3's backward once a
   step, K3's forward once more and the head once for each test frame, the
   head 8 times a refresh) and a non-zero triplane gradient in both phases;
   logs s/step and peak memory.  Then, counters reset, the same run through SD 1.5 (``--sd_version
   1.5``: CLIP-L, the 8-head UNet), with the same checks but K10's UNet
   routes at d = 40, 80 and 160 (10, 10 and 12 a step, ``SD15_UNET_ATTNS``;
   d = 64 never), and every K11 and K12 route launched exactly as often as
   in the SD 2.1 run (the same shapes).
6. Resets the counters and trains the DMTet stage from the stage-1
   checkpoint (--dmtet --init_with, oracle guidance, lr 0.002, tet grid
   128, 512² renders) for 100 steps (cut from thousands) with --save_mesh;
   requires finite losses and gradients, a launch of every K7/K8 kernel
   and of K1 and K4 (K1's backward with the position gradient exactly once
   a step, its table-only backward never), non-zero sdf and deform
   gradients, a non-empty surface whose true face count is within the
   marching tets' cap at every step, K7's fullest tile within its tile_cap
   at every step (``surface_checks``; max_tris sized from the init
   surface, tile_cap the kernel's most), and a written mesh.obj; logs s/step, peak memory, the face
   counts, the fullest tile and the analytic PSNR of the albedo render at
   the first and last step; every K7/K8 backward exactly once a step
   (``DMTET_STEP_LAUNCHES``: the interpolate's twice), and K7's fullest
   tile within tile_cap in every eval and test view too (every DMTet run).
   Then one more
   step of the same run, built as main builds it, the counters reset just
   before it: K1's forward and its ``_dx`` backward once each (one view),
   the table-only backward never, and every K7/K8 entry point exactly as
   ``DMTET_STEP_LAUNCHES`` counts.
   Then, counters reset, the DMTet stage under SD 2.1 at full width
   (random weights) from the same stage-1 checkpoint (``--text "a
   hamburger"``, tet grid 128, the VAE encoding the 512² render with
   gradient) for 20 steps in 10-step blocks, with the same checks, every
   K10/K11/K12 route exactly as one SD VAE step counts it each step
   (``SD_DGRADS``, ``SD_GROUPNORMS``, K10's d = 64 route 32 times, its d =
   512 forward and backward once) and no mma.sync conv; logs s/step, peak
   memory and the face counts; and its one-step launch check, the SD
   routes included.
7. The hash-grid backbone (-O's), each run with the counters reset just
   before it: stage 1 with the flagship oracle flags on --backbone grid
   and small tv and weight-decay weights (300 steps, the same run's end and
   checks as step 4, a launch of every K6 kernel and of K2-K4, a non-zero
   grid_table gradient at every step); SD 2.1 through -O (25 steps, every
   K6 encode and K10-K12 kernel launched, a non-zero grid_table gradient in
   both phases; s/step and peak memory); and 20 DMTet steps at tet grid
   128 from the grid stage 1 (K6's forward and its ``_dx`` backward
   launched by the albedo query, the latter once a step; non-zero sdf,
   deform and table gradients), and its one-step launch check.
8. The image → 3D pipeline (``--image analytic:two_sphere --guidance
   image_oracle``, run_flagship.py's image-oracle flags): K5 (the gradient
   clamp, CUDA) against its plain version and ``torch.clamp`` at the
   SDS, known-view and DMTet image shapes, fp32 and bf16; the clip limit
   chosen from a real SDS step's image gradient (its CLIP_QUANTILE, ~20%
   clamped); then, the counters reset just before it, stage 1 with
   ``--grad_clip_rgb`` for 300 steps with the same run's end as step 4,
   requiring finite losses and gradients, launches of K1-K5 (K3 and K4 as
   in step 4, the shade pair twice a step: the 3-D normal smoothness's
   second query; the two-step check too), a known-view step every 4th
   step, a known-view masked PSNR at least 3 dB above the
   initial one and the mesh on disk; its SDS and known-view steps timed
   apart from its checkpoint (each launching K5 once).  K9 (signed
   distance, CUDA) on the DMTet init's real workload, the 274,625
   tet-grid-128 points against that run's exported mesh (the plain version
   on 16,384 of them; the kernel with its distance culling off, bit for
   bit, and the pairs whose distance part ran, counted on the card), and
   on a UV sphere against its analytic distance.
   Then, counters reset, the DMTet stage from that mesh.obj (``--dmtet
   --init_with mesh.obj``, tet grid 128, 512², the image oracle, K5) for
   20 steps: K9 launched once (the init), K5 once per SDS step, K7 and K8
   every step, known-view DMTet steps, non-zero sdf and deform gradients,
   the surface checks of step 6; the init's seconds logged; and its
   one-step launch check as step 6's.
9. Zero-1-to-3 from an image file, at full width on random weights from
   seed 0 (SD 1.5's UNet on 8 channels, 859.5M parameters; the VAE at
   256²; CLIP ViT-L/14): the reference is an RGBA PNG of the analytic
   scene's default view and its mask, written here.  Stage 1 (``--image
   ref_rgba.png``: the image preset) through main for 6 + 25 steps, a
   known-view step every 4th, the counters reset just before it: finite
   losses and gradients, K10-K12 launched exactly as the towers' topology
   gives (``zero123_launches``: per SDS step one UNet call at CFG batch 2,
   the VAE encoder forward and backward at 256²; at start-up the reference
   embedding and the patch conv once), peak memory, the start-up seconds
   of each tower and of the embedding; then the same run built as main
   builds it, its SDS and known-view steps timed apart (synchronised)
   after the 6 warm-up steps.  ``--image_config`` with K = 3 (a CSV of
   config/example.csv's form, weights 1, 1, 0.5): one UNet call at batch 6
   a step, the closeness weights equal to JAX's formula (float64 numpy
   here), K10-K12 exactly.  The DMTet stage under zero123 (tet grid 128,
   512² renders resized to 256²) from step 4's checkpoint for 20 steps
   with step 6's checks (no face dropped, no tile cut, in the steps and in
   the eval and test views) and K10-K12 exactly.  The novel-view CLI
   (``guidance/zero123.py``) for 3 DDIM steps: a finite 256² PNG.
10. The image + text recipe (``--image ref_rgba.png --text "a
   hamburger"``: SD 2.1 and CLIP guidance summed, ViT-B/16 with the
   gradient through it into the render), at full width on random weights
   from seed 0: K12's two mma.sync routes at its patch conv (k = s = 16 on
   3 channels at 224², ``CLIP_PATCH_CONV``) against their plain versions
   and cuDNN (their JSON rows), then stage 1 through main for 6 + 25 steps
   (a known-view step every 2nd, the first 20% SD's warm-up), the counters
   reset just before it: finite losses and gradients, K10-K12 exactly
   (``sd_step_launches``: one ``conv_fwd_mma`` and one ``conv_dgrad`` a
   CLIP loss, one forward more for the reference's embedding), K2-K4
   exactly, peak memory; the same run rebuilt, its SDS and known-view
   steps timed apart; the DMTet stage under SD + CLIP from step 4's
   checkpoint for 14 steps with step 6's checks and K10-K12 exactly; one
   CLIP eval metric at full width (one ``conv_fwd_mma``, no dgrad); and
   raw checkpoints loaded by the card's torch through ``load_pretrained``
   (a diffusers directory of ``.safetensors``, one of ``.bin`` files with
   a shard index, SD 1.5's and zero123's ``.ckpt`` with the published key
   names at narrow widths): every tensor bit for bit.  The oracle, SD and
   zero123 runs launch no ``conv_dgrad``, and ``conv_fwd_mma`` only at
   zero123's start-up (each checked exactly).
11. DeepFloyd-IF at full width on random weights from seed 0 (IF-I-XL:
   4.23B parameters, bf16 under ``--fp16``): K12 at each of the 30
   distinct conv shapes and K10 at the three attention shapes of one UNet
   call (``if_unet_calls``: the tower's own forward on the meta device
   with the two ops recorded; [77 text + N spatial] keys at CFG batch 2
   and Perp-Neg's 4, lse checked too) against their plain versions, with
   ``F.conv2d`` / SDPA and the call's summed K12 and K10 ms; stage 1
   (``--IF --fp16 true``, triplane, 64² renders) through main for 6 + 25
   steps, the counters reset just before it: finite losses and gradients,
   the UNet's count (JAX's 4,225,193,478), K10/K12 exactly as the topology
   gives (``if_step_launches``: 90 wgmma, 1 narrow-input and 1 fp32 conv
   and 22 attentions a UNet call, no K11), K2-K4 exactly; the same run
   rebuilt, its steps timed (synchronised, medians after 6) with the peak
   memory; Perp-Neg under IF for 5 steps (the UNet at batch 4, the same
   launches) and timed; T5-XXL (4.76B, fp32) built on the card beside the
   UNet, the five prompts encoded, seconds and peak memory, then freed;
   the DMTet stage under IF from step 4's checkpoint (tet grid 128, 512²
   shrunk to 64²) for 14 steps with step 6's checks and K10/K12 exactly.
12. The vanilla backbone (``-O2``: fp16, the degree-12 frequency
   encoding into the 5-layer ResMLP, progressive levels) and the small
   field options.  K2's vanilla launches (the sphere's near/far, the
   stratified coarse samples and positions; then from the coarse density
   the weights, the inverse-CDF draws, the sorted merge, the deltas and
   positions) against their plain twins bit for bit, at the -O2 step's
   4096 rays and at a 4096-ray chunk of an 800² view; K4 at the step's
   393,216 samples with each activation (trunc_exp, softplus) and its
   normals-given route (``field_select``); K3 at [4096, 96] with no mask,
   the background MLP's colour and the orient loss.  ``--text "a
   hamburger" -O2`` at full SD 2.1 width through main for 6 + 25 steps,
   the counters reset just before it: finite losses and gradients,
   K10-K12 exactly (``sd_step_launches``), K2-K4 exactly (two K2 launches
   a render, the head once for the coarse pass, the shade pair and K3 once
   a step), no march or encoder kernel; two steps (warm-up and VAE)
   counted exactly; the run rebuilt and its steps timed with the peak
   memory.  ``--guidance oracle -O2`` for 300 steps with the run's end (2
   eval views, a 2-frame 800² turntable: each view shades 61M samples),
   the +3 dB gate and stage 1's checks; K7 again at the DMTet surface that
   stage 1 gives (its rows in the log, not the JSON line); DMTet from it
   for 14 steps with the surface checks and its one-step launch check (no
   encoder kernel: the positions' gradient goes through plain torch).
   The triplane under the oracle with ``--normal_mode finite_difference
   --density_activation softplus --optim adam --grad_clip 1 --lambda_tv
   1e-4`` for 20 steps: ``field_select`` once each way a step, the shade
   pair never.
13. Guidance snapshots, txt2img and the guidance sets at full width on
   random weights from seed 0.  K10-K12 at every shape of the SD VAE
   decoder at 512² and of zero123's at 256² (``SD_DECODER_*``,
   ``ZERO123_DECODER_*``, held to the decoder's own calls recorded on the
   meta device, ``record_towers``), each against its plain version on its
   checked route with its event and graph ms, bound and cuDNN's /
   F.group_norm's / SDPA's ms, logged and printed as one ``decoder rows``
   JSON log line; a whole decode of each on the card (finite, K10-K12
   exactly the recorded calls, its ms beside its calls' summed row ms and
   bounds).  ``--save_guidance --save_guidance_interval 1`` through main:
   the SD 2.1 triplane run (6 steps, 3 snapshots), IF, zero123 and the
   DMTet stage under SD from step 4's checkpoint (one each): every
   triptych [h, 3w, 3], finite, its noised panel unlike its render,
   K10-K12 exactly (``tower_launches``: the forwards recorded from the
   towers' own code, the encoder's backward from ``SD_DGRADS`` and the
   K11 backward rows; each snapshot one encode, one CFG UNet call and two
   decodes, IF's one UNet call), s a snapshot.  Both txt2img CLIs (3 DDIM
   steps): a finite 512² and 64² PNG, K10-K12 exactly, ms a DDIM step.
   ``--image_config`` (K = 2) with ``--text`` and ``--guidance SD zero123
   clip`` for 12 steps: finite losses and gradients, a known-view step
   every 4th, K10-K12 exactly (both UNets a step, both VAEs with their
   backward after the warm-up, zero123's start-up embeddings, CLIP's patch
   conv forward and input gradient a step), the synchronised median SDS
   step and the peak memory; SD with ``--image_config`` and ``--text`` (4
   steps, exact); the pixel oracle with the analytic reference image (8
   steps, 2 known-view, no tower launch).
14. Tooling at full width on random weights: K10's fp32 forward at the
   DPT's [1, 577, 12, 64] and K12's tiled fp32 route at each of the 17
   distinct conv shapes of a 384² DPT forward (and at an odd shape,
   ``FP32_TILED_CONVS``), each against its plain version, with its event
   and graph ms beside SDPA's or cuDNN's (fp32, TF32 off), and the 40
   convs' sums by both timers; the DPT (vitb_rn50_384) through
   ``run_omnidata`` from an omnidata ``.ckpt`` (depth) and a converted
   ``.npz`` (normals), K10/K12 exactly (``dpt_launches``), the forward's
   ms at 384², the card against the CPU at 128²; a 512² turntable of the
   stage-1 mesh (K7 exactly), R-precision, a viewer frame, ``--profile``.
15. The towers' backward to their weights at full width on random weights
   from seed 0: K12's weight gradient (``conv_wgrad_wgmma``, bf16 on
   wgmma + TMA; ``conv_wgrad_wgmma_i8``, the conv_ins' on wgmma n72;
   ``conv_wgrad_fp32_tiled``, the conv_outs), K11's backward with
   the affine gradients (``groupnorm_bwd_{resident,stream}_affine``) and
   K10's flash-style backward at d = 40, 64, 80 and 160
   (``attention_bwd_flash*``), each against its plain version at every
   distinct shape the four towers launch it at (recorded from the towers'
   own forwards on the meta device), two launches bit for bit, with event
   and graph ms, bound and the library call's ms
   (``aten.convolution_backward`` with the weight's mask,
   ``aten.native_group_norm_backward`` with the affine mask, SDPA's
   backward by events and, as its autograd node alone, in a CUDA graph);
   ``conv_wgrad_mma`` (no tower's any more) at shapes of its own
   (``MMA_WGRAD_CONVS``); logged as one ``tower backward rows`` JSON line,
   and each
   tower's wgrad rows summed over its calls (kernel, cuDNN and bound,
   event and graph ms); then the SD
   2.1 UNet (CFG batch 2, 64², 77 keys), the SD 1.5 UNet, zero123's UNet
   (K = 1, 32², one key, 8 input channels) and the SD VAE encoder (512²),
   each with every parameter and the input wanting gradients: one forward
   and one backward of a seeded cotangent, every gradient finite, K10-K12
   launched exactly as ``tower_launches(..., unet_grad=1)`` derives them,
   the synchronised forward and backward walls (median of 3) and the peak
   memory.
16. The DPT's backward and the encoders' second derivative on random
   weights: K10's fp32 backward (``attention_bwd_fp32``) at the ViT's
   [1, 577, 12, 64] against its plain version and SDPA's fp32 backward;
   K12's tiled fp32 input gradient (``conv_dgrad_fp32_tiled``) and its
   tiled fp32 weight gradient (``conv_wgrad_fp32_tiled``) at each of the
   17 distinct
   conv shapes of a 384² DPT against their plain versions and cuDNN's
   (TF32 off), with the 40 convs' sums; K1's and K6's ``_dx``
   backwards with cotangents on the jacobian at stage 1's 98,304 samples
   (and, among step 3's rows, at the DMTet query's 262,144), beside the same
   launch without them; event and graph ms, bound and library ms as one
   ``DPT backward rows`` JSON line; then the DPT (vitb_rn50_384, depth) at
   384² with every weight and the input trainable: one forward and
   backward with the counters reset just before, K10/K12 launched exactly
   as ``dpt_grad_launches`` derives them on the meta device (12
   ``attention_bwd_fp32``, 40 ``conv_dgrad_fp32_tiled``, 40
   ``conv_wgrad_fp32_tiled``, no ``conv_dgrad``), every gradient finite, the
   synchronised walls (median of 3) and the peak memory.
17. Prints one JSON line with every kernel's route, source, the TPU
   function it replaces, launches on its path (K2's vanilla launches: the
   -O2 SD run; K4's ``field_select``: the field-options run; K1-K4 and
   K10-K12: the SD run, K10's d = 40, 80 and 160 routes: the SD 1.5
   run, K10's fp32 forward and K12's tiled fp32 route: the DPT's depth
   run, the new kernels of step 15: the four towers' backwards summed
   (``conv_wgrad_mma``: 0, no tower's), those of step 16: the DPT's
   backward run,
   ``conv_fwd_mma`` and ``conv_dgrad``: the image + text run; K7, K8 and K1's ``_dx``
   route: the DMTet run; K6's encode: the SD -O run, its ``_dx`` route:
   the DMTet run from the grid, its tv and wd: the grid stage 1; K5: the
   image stage 1; K9: the DMTet stage from its mesh), error, times and
   bound; the last line is the result object.  Any
   failure exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 300
FLAGSHIP = ["--guidance", "oracle", "--backbone", "triplane",
            "--oracle_scene", "two_sphere", "--lr", "0.01", "--seed", "0",
            "--lambda_3d_normal_smooth", "0"]
# the run's end: one eval at step 300, a checkpoint per 100-step epoch, an
# 8-frame turntable at the default 800², the textured mesh
STAGE1_END = ["--eval_interval", "3", "--dataset_size_test", "8",
              "--save_mesh", "--ckpt", "scratch"]
SD_STEPS = 25
SD_FLAGS = ["--text", "a hamburger", "--backbone", "triplane", "--seed", "0",
            "--lambda_3d_normal_smooth", "0", "--dataset_size_train", "5",
            "--eval_interval", "0", "--H", "64", "--W", "64",
            "--dataset_size_test", "2", "--ckpt", "scratch"]
# the hash-grid backbone (-O's): stage 1 with its tv and weight-decay terms
# on (small weights; both default to 0), SD through -O, and a DMTet stage
# from the grid stage 1
GRID_FLAGSHIP = [("grid" if f == "triplane" else f) for f in FLAGSHIP] + [
    "--lambda_tv", "1e-4", "--lambda_wd", "1e-5"]
SD_GRID_FLAGS = ["-O"] + [f for f in SD_FLAGS
                          if f not in ("--backbone", "triplane")]
# SD 1.5 (CLIP-L, the 8-head UNet: head dims 40, 80, 160) on the triplane
SD15_FLAGS = SD_FLAGS + ["--sd_version", "1.5"]
DMTET_STEPS = 100
DMTET_FLAGS = ["--guidance", "oracle", "--backbone", "triplane",
               "--oracle_scene", "two_sphere", "--seed", "0",
               "--lambda_3d_normal_smooth", "0", "--dmtet", "--lr", "0.002",
               "--tet_grid_size", "128", "--dataset_size_test", "8",
               "--save_mesh", "--ckpt", "scratch",
               # 10-step blocks: the rate leaves out the first; one eval
               "--dataset_size_train", "10", "--eval_interval", "10"]
# the DMTet stage under SD 2.1 (full width, random weights) from the oracle
# stage 1's checkpoint: random-weight SD gives no usable stage-1 surface
DMTET_SD_STEPS = 20             # one eval, at step 20
DMTET_SD_FLAGS = [f for f in DMTET_FLAGS if f not in (
    "--guidance", "oracle", "--oracle_scene", "two_sphere")] + [
    "--text", "a hamburger", "--eval_interval", "2"]
DMTET_GRID_STEPS = 20           # one eval, at step 20
GRID_DMTET_FLAGS = [("grid" if f == "triplane" else f) for f in DMTET_FLAGS] \
    + ["--eval_interval", "2"]
# the image → 3D run (scripts/run_flagship.py --mode image_oracle's flags,
# --grad_clip_rgb added at a limit chosen from a real step), and the DMTet
# stage from its exported mesh
IMAGE_FLAGSHIP = ["--image", "analytic:two_sphere", "--guidance",
                  "image_oracle", "--guidance_scale", "1.0", "--lr", "0.01",
                  "--backbone", "triplane", "--seed", "0",
                  "--lambda_3d_normal_smooth", "0"]
IMAGE_DMTET_STEPS = 20           # 5 known-view steps; one eval, at step 20
IMAGE_DMTET_FLAGS = ["--image", "analytic:two_sphere", "--guidance",
                     "image_oracle", "--backbone", "triplane", "--seed", "0",
                     "--dmtet", "--tet_grid_size", "128", "--lr", "0.002",
                     "--dataset_size_test", "8", "--save_mesh", "--ckpt",
                     "scratch", "--dataset_size_train", "10",
                     "--eval_interval", "2"]
# Zero-1-to-3 at full width (random weights from seed 0): SD 1.5's UNet on 8
# channels at 32² latents (CFG batch 2·K over K references), the VAE at
# 256², CLIP ViT-L/14 at 224²; the reference an RGBA PNG of the analytic
# scene's default view that the smoke writes.  Stage 1 runs 6 warm-up and
# 25 timed steps (every 4th a known-view step); the K = 3 run
# (``--image_config``, config/example.csv's form) 5 steps; the DMTet stage
# from the oracle stage 1's checkpoint 20 steps; the novel-view CLI 3 DDIM
# steps.
ZERO123_WARMUP, ZERO123_STEPS = 6, 25
ZERO123_FLAGS = ["--backbone", "triplane", "--seed", "0",
                 "--dataset_size_train", "31", "--eval_interval", "0",
                 "--H", "64", "--W", "64", "--dataset_size_test", "2",
                 "--ckpt", "scratch"]
ZERO123_REFS = [(1.0, 3.2, 90.0, 0.0), (1.0, 3.2, 90.0, 180.0),
                (0.5, 3.2, 90.0, 90.0)]   # zero123_weight, radius, polar, az
ZERO123_K3_STEPS = 5                      # steps 0 and 4 known-view
ZERO123_DMTET_STEPS = 20
ZERO123_DMTET_FLAGS = ["--backbone", "triplane", "--seed", "0", "--dmtet",
                       "--tet_grid_size", "128", "--lr", "0.002",
                       "--dataset_size_test", "2", "--save_mesh", "--ckpt",
                       "scratch", "--dataset_size_train", "10",
                       "--eval_interval", "2"]
# The image + text recipe at full width (random weights from seed 0): SD
# 2.1's towers and CLIP guidance's ViT-B/16 (and its 12-layer text tower),
# the reference the zero123 run's PNG; a known-view step every 2nd step,
# the first 20% of the run SD's warm-up.  Stage 1 runs 6 warm-up and 25
# timed steps; the DMTet stage under SD + CLIP from the oracle stage 1's
# checkpoint 14 steps.
IMAGE_TEXT_WARMUP, IMAGE_TEXT_STEPS = 6, 25
IMAGE_TEXT_FLAGS = ["--text", "a hamburger", "--backbone", "triplane",
                    "--seed", "0", "--dataset_size_train", "31",
                    "--eval_interval", "0", "--H", "64", "--W", "64",
                    "--dataset_size_test", "2", "--ckpt", "scratch"]
IMAGE_TEXT_DMTET_STEPS = 14
IMAGE_TEXT_DMTET_FLAGS = ["--text", "a hamburger", "--backbone", "triplane",
                          "--seed", "0", "--dmtet", "--tet_grid_size", "128",
                          "--lr", "0.002", "--dataset_size_test", "2",
                          "--save_mesh", "--ckpt", "scratch",
                          "--dataset_size_train", "7", "--eval_interval", "2"]
# DeepFloyd-IF at full width (IF-I-XL, 4.23B parameters, on random weights
# from seed 0, bf16 under --fp16): the pixel UNet at CFG batch 2 on 64²
# (the 64² render as it is); stage 1 runs 6 warm-up and 25 timed steps,
# Perp-Neg (UNet batch 4) 5 steps, the DMTet stage from the oracle stage
# 1's checkpoint 14 steps (512² renders shrunk to 64²).  Its prompts come
# from JAX's md5 stand-in (random weights: no T5); the T5-XXL phase encodes
# the same five prompts through a full-width fp32 T5 on random weights.
IF_WARMUP, IF_STEPS = 6, 25
IF_FLAGS = ["--text", "a hamburger", "--IF", "--fp16", "true", "--backbone",
            "triplane", "--seed", "0", "--lambda_3d_normal_smooth", "0",
            "--dataset_size_train", "31", "--eval_interval", "0", "--H",
            "64", "--W", "64", "--dataset_size_test", "2", "--ckpt",
            "scratch"]
IF_PERPNEG_STEPS = 5
IF_DMTET_STEPS = 14
IF_DMTET_FLAGS = ["--text", "a hamburger", "--IF", "--fp16", "true",
                  "--backbone", "triplane", "--seed", "0",
                  "--lambda_3d_normal_smooth", "0", "--dmtet",
                  "--tet_grid_size", "128", "--lr", "0.002",
                  "--dataset_size_test", "2", "--save_mesh", "--ckpt",
                  "scratch", "--dataset_size_train", "7",
                  "--eval_interval", "2"]
IF_UNET_PARAMS = 4_225_193_478            # JAX's pinned count
# The vanilla backbone (-O2: fp16, the frequency-encoded ResMLP field,
# progressive levels; BASELINE.json's configs[0]): SD 2.1 at full width on
# 64² renders, 6 warm-up and 25 timed steps (the first 20% SD's warm-up);
# the weight-free twin, 300 oracle steps with the run's end (2 eval views
# and a 2-frame 800² turntable, cut from 4 and 8 to keep the smoke's time:
# each 800² view shades 61M samples, ~1.2 s); DMTet
# from its checkpoint, 14 steps.  The small field options on the triplane
# under the oracle: the finite-difference normals (K4's normals-given
# route), softplus, Adam, the elementwise clip and the triplane's tv.
O2_WARMUP, O2_STEPS = 6, 25
O2_SD_FLAGS = ["--text", "a hamburger", "-O2", "--seed", "0",
               "--dataset_size_train", "5", "--eval_interval", "0", "--H",
               "64", "--W", "64", "--dataset_size_test", "2", "--ckpt",
               "scratch"]
# (the default lr, 1e-3, as the JAX CLI's: the triplane flagship's 0.01
# is too large for the ResMLP, +2.98 dB in 300 steps against 1e-3's +12.45)
O2_ORACLE_FLAGS = ["--guidance", "oracle", "-O2", "--oracle_scene",
                   "two_sphere", "--seed", "0", "--lambda_3d_normal_smooth",
                   "0"]
O2_STAGE1_END = [f if f != "8" else "2" for f in STAGE1_END] + [
    "--dataset_size_valid", "2"]
O2_DMTET_STEPS = 14
O2_DMTET_FLAGS = [f for f in DMTET_FLAGS if f not in (
    "--backbone", "triplane")] + ["-O2", "--dataset_size_train", "7",
                                  "--eval_interval", "2",
                                  "--dataset_size_test", "2"]
OPTION_STEPS = 20
OPTION_FLAGS = FLAGSHIP + ["--normal_mode", "finite_difference",
                           "--density_activation", "softplus", "--optim",
                           "adam", "--grad_clip", "1", "--lambda_tv", "1e-4",
                           "--dataset_size_train", "10", "--eval_interval",
                           "0", "--H", "64", "--W", "64",
                           "--dataset_size_test", "1", "--ckpt", "scratch"]
# CLIP guidance's ViT-B/16 patch embedding (k = s = 16 on 3 channels, no
# bias): conv_fwd_mma forward and conv_dgrad input gradient, once each a
# CLIP loss; its rows fill the two kernels' JSON entries
CLIP_PATCH_CONV = (1, 224, 224, 3, 768, 16, 16, 0, "bf16", True)
CLIP_QUANTILE = 0.8              # the limit clamps ~20% of a step's gradient
# K9's fp32 operations per (point, triangle) pair with no culling (the
# unculled kernel's, logged as a reference beside the bound's count): 15
# differences, six 3-term dots (30), va/vb/vc (9), the region tests
# (~27), the region's candidate (~15 on average), |p - q|² and the min (9),
# the winding term's three norms (18), triple product (14), denominator
# (23), atan2 (~20), scale and fp64 add (2)
SDF_OPS_PER_PAIR = 180
# What the function needs a pair, K9's bound: the point's 9 differences and
# the winding term, always (86); the distance part's dots, region tests,
# candidate, |p - q|² and min (90) where the triangle's sphere is within
# reach, counted on the card in that run; the culling test (12).  The
# triangle's own 6 differences are formed once a triangle, in its record.
SDF_WINDING_OPS = 86
SDF_DIST_OPS = 90
SDF_CULL_OPS = 12

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK = {"bf16": 989e12, "fp32": 67e12}    # dense tensor-core bf16, fp32
# exponentials (MUFU ex2): 16 per SM per clock, ~3.9e12/s on the H100 SXM
# (the FlashAttention-3 paper's figure); K10's softmax takes one a logit
EXP_PER_S = 3.9e12

# kernel → (route, source, the TPU function it replaces)
KERNELS = {
    "triplane_fwd": ("cuda", "dreamfusion_tpu_torch/csrc/triplane.cu",
                     "dreamfusion_tpu/ops/triplane.py:178"),
    "triplane_bwd": ("cuda", "dreamfusion_tpu_torch/csrc/triplane.cu",
                     "dreamfusion_tpu/ops/triplane.py:178"),
    "triplane_bwd_dx": ("cuda", "dreamfusion_tpu_torch/csrc/triplane.cu",
                        "dreamfusion_tpu/ops/triplane.py:96"),
    "march_rays": ("cuda", "dreamfusion_tpu_torch/csrc/occupancy.cu",
                   "dreamfusion_tpu/ops/occupancy.py:71"),
    "vanilla_coarse": ("cuda", "dreamfusion_tpu_torch/csrc/occupancy.cu",
                       "dreamfusion_tpu/core/sampling.py:94"),
    "vanilla_resample": ("cuda", "dreamfusion_tpu_torch/csrc/occupancy.cu",
                         "dreamfusion_tpu/core/sampling.py:44"),
    "composite_fwd": ("cuda", "dreamfusion_tpu_torch/csrc/composite.cu",
                      "dreamfusion_tpu/ops/composite.py:39"),
    "composite_bwd": ("cuda", "dreamfusion_tpu_torch/csrc/composite.cu",
                      "dreamfusion_tpu/ops/composite.py:39"),
    "field_head_fwd": ("cuda", "dreamfusion_tpu_torch/csrc/field_head.cu",
                       "dreamfusion_tpu/ops/activation.py:9"),
    "field_head_bwd": ("cuda", "dreamfusion_tpu_torch/csrc/field_head.cu",
                       "dreamfusion_tpu/ops/activation.py:9"),
    "field_shade_fwd": ("cuda", "dreamfusion_tpu_torch/csrc/field_head.cu",
                        "dreamfusion_tpu/models/nerf.py:211"),
    "field_shade_bwd": ("cuda", "dreamfusion_tpu_torch/csrc/field_head.cu",
                        "dreamfusion_tpu/models/nerf.py:211"),
    "field_select_fwd": ("cuda", "dreamfusion_tpu_torch/csrc/field_head.cu",
                         "dreamfusion_tpu/models/nerf.py:332"),
    "field_select_bwd": ("cuda", "dreamfusion_tpu_torch/csrc/field_head.cu",
                         "dreamfusion_tpu/models/nerf.py:332"),
    "attention_fwd_wgmma": ("cuda", "dreamfusion_tpu_torch/csrc/attention.cu",
                            "dreamfusion_tpu/ops/attention.py:27"),
    "attention_fwd_wgmma_d40": ("cuda",
                                "dreamfusion_tpu_torch/csrc/attention.cu",
                                "dreamfusion_tpu/ops/attention.py:27"),
    "attention_fwd_wgmma_d80": ("cuda",
                                "dreamfusion_tpu_torch/csrc/attention.cu",
                                "dreamfusion_tpu/ops/attention.py:72"),
    "attention_fwd_wgmma_d160": ("cuda",
                                 "dreamfusion_tpu_torch/csrc/attention.cu",
                                 "dreamfusion_tpu/ops/attention.py:72"),
    "attention_fwd_wgmma_d512": ("cuda",
                                 "dreamfusion_tpu_torch/csrc/attention.cu",
                                 "dreamfusion_tpu/ops/attention.py:27"),
    "attention_bwd_wgmma": ("cuda", "dreamfusion_tpu_torch/csrc/attention.cu",
                            "dreamfusion_tpu/ops/attention.py:72"),
    "conv_fwd_wgmma": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                       "dreamfusion_tpu/ops/conv.py:58"),
    "conv_fwd_wgmma_i8": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                          "dreamfusion_tpu/ops/conv.py:58"),
    "conv_fwd_fp32": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                      "dreamfusion_tpu/ops/conv.py:58"),
    "conv_fwd_mma": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                     "dreamfusion_tpu/ops/conv.py:58"),
    "conv_fwd_fp32_tiled": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                            "dreamfusion_tpu/ops/conv.py:58"),
    "conv_dgrad_wgmma": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                         "dreamfusion_tpu/ops/conv.py:95"),
    "conv_dgrad_narrow": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                          "dreamfusion_tpu/ops/conv.py:95"),
    "conv_dgrad_fp32": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                        "dreamfusion_tpu/ops/conv.py:95"),
    "conv_dgrad": ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                   "dreamfusion_tpu/ops/conv.py:95"),
}
for _d, _line in (("fwd", 100), ("bwd", 143)):
    for _r in ("resident", "stream"):
        KERNELS[f"groupnorm_{_d}_{_r}"] = (
            "cuda", "dreamfusion_tpu_torch/csrc/groupnorm.cu",
            f"dreamfusion_tpu/models/unet.py:{_line}")
for _n, _f in (("raster", "raster.cu"), ("interpolate", "raster.cu")):
    for _d in ("fwd", "bwd"):
        KERNELS[f"{_n}_{_d}"] = ("cuda", f"dreamfusion_tpu_torch/csrc/{_f}",
                                 "dreamfusion_tpu/ops/raster.py:" +
                                 ("44" if _n == "raster" else "205"))
for _n, _line in (("marching_tets", 59), ("vertex_normals", 103),
                  ("laplacian", 122), ("normal_consistency", 142)):
    for _d in ("fwd", "bwd"):
        KERNELS[f"{_n}_{_d}"] = (
            "cuda", "dreamfusion_tpu_torch/csrc/marching_tets.cu",
            f"dreamfusion_tpu/ops/marching_tets.py:{_line}")
for _n, _line in (("hashgrid", 201), ("hashgrid_tv", 322),
                  ("hashgrid_wd", 358)):
    for _d in ("fwd", "bwd"):
        KERNELS[f"{_n}_{_d}"] = (
            "cuda", "dreamfusion_tpu_torch/csrc/hashgrid.cu",
            f"dreamfusion_tpu/ops/hashgrid.py:{_line}")
KERNELS["hashgrid_bwd_dx"] = ("cuda", "dreamfusion_tpu_torch/csrc/hashgrid.cu",
                              "dreamfusion_tpu/ops/hashgrid.py:201")
KERNELS["attention_fwd_fp32"] = (
    "cuda", "dreamfusion_tpu_torch/csrc/attention.cu",
    "dreamfusion_tpu/ops/attention.py:72")
KERNELS["clip_grad_bwd"] = ("cuda", "dreamfusion_tpu_torch/csrc/clip_grad.cu",
                            "dreamfusion_tpu/core/math.py:39")
KERNELS["signed_distance"] = ("cuda", "dreamfusion_tpu_torch/csrc/sdf.cu",
                              "dreamfusion_tpu/mesh/sdf.py:214")
# the towers' backward to their weights: mm_conv's dk (f_bwd :112),
# group_norm_fused's dscale and dbias (:148-149), attention's backward at
# the UNets' head dims (d = 40's 64² self-attention on the chunked branch)
for _r in ("wgmma", "wgmma_i8", "mma", "fp32_tiled"):
    KERNELS[f"conv_wgrad_{_r}"] = ("cuda", "dreamfusion_tpu_torch/csrc/conv.cu",
                                   "dreamfusion_tpu/ops/conv.py:112")
for _r in ("resident", "stream"):
    KERNELS[f"groupnorm_bwd_{_r}_affine"] = (
        "cuda", "dreamfusion_tpu_torch/csrc/groupnorm.cu",
        "dreamfusion_tpu/models/unet.py:148")
for _n, _line in (("", 27), ("_d40", 27), ("_d80", 72), ("_d160", 72)):
    KERNELS[f"attention_bwd_flash{_n}"] = (
        "cuda", "dreamfusion_tpu_torch/csrc/attention.cu",
        f"dreamfusion_tpu/ops/attention.py:{_line}")
# the DPT's backward: attention's fp32 VJP (dense_attention, JAX's branch
# for the DPT's ViT) and mm_conv's dx (f_bwd :112) at fp32
KERNELS["attention_bwd_fp32"] = (
    "cuda", "dreamfusion_tpu_torch/csrc/attention.cu",
    "dreamfusion_tpu/ops/attention.py:72")
KERNELS["conv_dgrad_fp32_tiled"] = ("cuda",
                                    "dreamfusion_tpu_torch/csrc/conv.cu",
                                    "dreamfusion_tpu/ops/conv.py:95")
# the stage-1 step: K4's head with the normals and the shading (and the head
# alone in the density refresh)
GRID_KERNELS = ("hashgrid_fwd", "hashgrid_bwd", "march_rays",
                "composite_fwd", "composite_bwd", "field_head_fwd",
                "field_shade_fwd", "field_shade_bwd")
GRID_REG_KERNELS = ("hashgrid_tv_fwd", "hashgrid_tv_bwd", "hashgrid_wd_fwd",
                    "hashgrid_wd_bwd")
ORACLE_KERNELS = ("triplane_fwd", "triplane_bwd", "march_rays",
                  "composite_fwd", "composite_bwd", "field_head_fwd",
                  "field_shade_fwd", "field_shade_bwd")
# K10's and K12's forwards, K12's dgrad and K11 count each route apart
# (ops/kernels.py): the SD step must launch every one of them, and never
# K12's mma.sync forward or dgrad (conv_fwd_mma, conv_dgrad: shapes off
# every path, checked at MMA_CONVS)
SD_TOWER_KERNELS = ("attention_fwd_wgmma", "attention_fwd_wgmma_d512",
                    "attention_bwd_wgmma", "groupnorm_fwd_resident",
                    "groupnorm_fwd_stream", "groupnorm_bwd_resident",
                    "groupnorm_bwd_stream", "conv_fwd_wgmma",
                    "conv_fwd_wgmma_i8", "conv_fwd_fp32", "conv_dgrad_wgmma",
                    "conv_dgrad_narrow", "conv_dgrad_fp32")
SD_KERNELS = ("march_rays", "composite_fwd", "composite_bwd",
              "field_head_fwd", "field_shade_fwd",
              "field_shade_bwd") + SD_TOWER_KERNELS
# dgrads per SD step through the VAE (the encoder's backward): 20 stride-1
# and 3 stride-2 on the wgmma route, the conv_in's on the narrow one, the
# fp32 conv_out's
SD_DGRADS = {"conv_dgrad_wgmma": 23, "conv_dgrad_narrow": 1,
             "conv_dgrad_fp32": 1}
# the DMTet albedo query's positions take a gradient: K1's (or K6's) forward
# and its backward with the position gradient once a view, the table-only
# backward never (``dmtet_path`` and ``dmtet_view_launches`` check it)
DMTET_KERNELS = tuple(k for k in KERNELS if k.split("_")[0] in
                      ("raster", "interpolate", "marching", "vertex",
                       "laplacian", "normal")) + (
    "triplane_fwd", "triplane_bwd_dx", "field_head_fwd", "field_head_bwd")
# K7's and K8's launches in one DMTet step of one view (--batch_size 1): the
# mesh, the view's raster and two interpolates (positions and normals), the
# vertex normals and the two regularizers, each forward and backward
DMTET_STEP_LAUNCHES = {
    "marching_tets_fwd": 1, "marching_tets_bwd": 1, "raster_fwd": 1,
    "raster_bwd": 1, "interpolate_fwd": 2, "interpolate_bwd": 2,
    "vertex_normals_fwd": 1, "vertex_normals_bwd": 1, "laplacian_fwd": 1,
    "laplacian_bwd": 1, "normal_consistency_fwd": 1,
    "normal_consistency_bwd": 1}
# K3's and K4's entry points, whose launches a step's checks count
RENDER_KERNELS = ("composite_fwd", "composite_bwd", "field_shade_fwd",
                  "field_shade_bwd", "field_head_fwd", "field_head_bwd")
IMAGE_KERNELS = ORACLE_KERNELS + ("clip_grad_bwd",)
# the -O2 step: K2's vanilla launches, K4's head (the coarse density pass)
# and shade pair, K3; no occupancy march, no encoder kernel
O2_KERNELS = ("vanilla_coarse", "vanilla_resample", "composite_fwd",
              "composite_bwd", "field_head_fwd", "field_shade_fwd",
              "field_shade_bwd")
O2_DMTET_KERNELS = tuple(k for k in DMTET_KERNELS
                         if not k.startswith("triplane"))
ENCODER_KERNELS = ("triplane_fwd", "triplane_bwd", "triplane_bwd_dx",
                   "hashgrid_fwd", "hashgrid_bwd", "hashgrid_bwd_dx",
                   "march_rays")
IMAGE_DMTET_KERNELS = DMTET_KERNELS + ("clip_grad_bwd", "signed_distance")
# The SD 2.1 step's K12 forwards (bf16 unless stated; the UNet at CFG batch
# 2 on 64² latents, the VAE encoder at 512²): B, H, W, I, O, kernel size,
# stride, padding, dtype, and whether the dgrad is checked too.  Every one is
# held against its plain version here; bench_sd_kernels.py times the same
# list for any checkout.
SD_CONVS = [
    (1, 512, 512, 128, 128, 3, 1, 1, "bf16", True),       # VAE level 0
    (1, 256, 256, 128, 256, 3, 1, 1, "bf16", True),       # level 1's entry
    (1, 256, 256, 256, 256, 3, 1, 1, "bf16", True),       # VAE level 1
    (1, 128, 128, 256, 512, 3, 1, 1, "bf16", True),       # level 2's entry
    (1, 128, 128, 512, 512, 3, 1, 1, "bf16", True),       # VAE level 2
    (1, 64, 64, 512, 512, 3, 1, 1, "bf16", True),         # VAE level 3, mid
    (2, 64, 64, 320, 320, 3, 1, 1, "bf16", False),        # UNet level 0
    (2, 32, 32, 640, 640, 3, 1, 1, "bf16", False),        # UNet level 1
    (2, 16, 16, 1280, 1280, 3, 1, 1, "bf16", False),      # UNet level 2
    (2, 8, 8, 1280, 1280, 3, 1, 1, "bf16", False),        # level 3: split-K
    (2, 32, 32, 320, 640, 1, 1, 0, "bf16", False),        # a 1x1 skip conv
    (2, 64, 64, 320, 320, 3, 2, 1, "bf16", False),        # UNet downs
    (2, 32, 32, 640, 640, 3, 2, 1, "bf16", False),
    (2, 16, 16, 1280, 1280, 3, 2, 1, "bf16", False),      # split-K 16
    (1, 512, 512, 128, 128, 3, 2, ((0, 1), (0, 1)), "bf16", True),  # VAE downs
    (1, 256, 256, 256, 256, 3, 2, ((0, 1), (0, 1)), "bf16", True),
    (1, 128, 128, 512, 512, 3, 2, ((0, 1), (0, 1)), "bf16", True),
    (1, 512, 512, 3, 128, 3, 1, 1, "bf16", True),         # VAE conv_in
    (2, 64, 64, 4, 320, 3, 1, 1, "bf16", False),          # UNet conv_in
    (2, 64, 64, 320, 4, 3, 1, 1, "fp32", False),          # UNet conv_out
    (1, 64, 64, 512, 8, 3, 1, 1, "fp32", True),           # VAE conv_out
]
# Shapes of no path that K12's mma.sync forward (conv_fwd_mma) still takes,
# in SD_CONVS's layout, at odd sizes: bf16 with 8 < I and I % 64 != 0 (at
# stride 2 and 1).  Held against the plain version as SD_CONVS are; no
# path may launch it.
MMA_CONVS = [
    (1, 17, 15, 32, 48, 3, 2, 1, "bf16", True),
    (2, 33, 31, 24, 40, 3, 1, 1, "bf16", True),
]
# The tiled fp32 route (conv_fwd_fp32_tiled) at odd shapes of no path (the
# DPT's own shapes come from dpt_calls): O > 8, and O <= 8 with I % 4 != 0
# (4-byte copies); their dgrads on the tiled fp32 dgrad (a 3-channel dx in
# the second; 4-byte copies of a 5-channel dy over 4 parity classes in the
# third)
FP32_TILED_CONVS = [(1, 33, 31, 16, 16, 3, 1, 1, "fp32", True),
                    (1, 33, 31, 3, 8, 3, 1, 1, "fp32", True),
                    (1, 21, 19, 6, 5, 3, 2, 1, "fp32", True)]
# K11 in one SD 2.1 step: B, H, W, C, eps, SiLU, calls per step, and
# whether the backward runs (the VAE encoder's, at 512²; the UNet at CFG
# batch 2 on 64² latents runs forward only).  The UNet's resnet norms take
# eps 1e-5 and SiLU, its SpatialTransformer norms eps 1e-6 and no SiLU; the
# VAE's all eps 1e-6, the mid-block attention's without SiLU.  61 UNet
# calls (every step) and 22 VAE calls (each VAE step), counted from the
# towers (tests/test_torch_sdops.py); the SD runs below check the counts.
SD_GROUPNORMS = [
    (2, 64, 64, 320, 1e-5, True, 8, False),
    (2, 64, 64, 320, 1e-6, False, 5, False),
    (2, 64, 64, 640, 1e-5, True, 2, False),
    (2, 64, 64, 960, 1e-5, True, 1, False),
    (2, 32, 32, 320, 1e-5, True, 1, False),
    (2, 32, 32, 640, 1e-5, True, 6, False),
    (2, 32, 32, 640, 1e-6, False, 5, False),
    (2, 32, 32, 960, 1e-5, True, 1, False),
    (2, 32, 32, 1280, 1e-5, True, 1, False),
    (2, 32, 32, 1920, 1e-5, True, 1, False),
    (2, 16, 16, 640, 1e-5, True, 1, False),
    (2, 16, 16, 1280, 1e-5, True, 6, False),
    (2, 16, 16, 1280, 1e-6, False, 5, False),
    (2, 16, 16, 1920, 1e-5, True, 1, False),
    (2, 16, 16, 2560, 1e-5, True, 2, False),
    (2, 8, 8, 1280, 1e-5, True, 11, False),
    (2, 8, 8, 1280, 1e-6, False, 1, False),
    (2, 8, 8, 2560, 1e-5, True, 3, False),
    (1, 512, 512, 128, 1e-6, True, 4, True),        # VAE level 0
    (1, 256, 256, 128, 1e-6, True, 1, True),        # level 1's entry
    (1, 256, 256, 256, 1e-6, True, 3, True),
    (1, 128, 128, 256, 1e-6, True, 1, True),        # level 2's entry
    (1, 128, 128, 512, 1e-6, True, 3, True),
    (1, 64, 64, 512, 1e-6, True, 9, True),          # level 3, mid, norm_out
    (1, 64, 64, 512, 1e-6, False, 1, True),         # mid-block attention
]
# K10: q [B, N, h, d], k and v [B, M, h, d]; whether the backward is
# checked.  SD 2.1's UNet (d = 64) and the VAE mid-block (d = 512), then SD
# 1.5's UNet (8 heads: d = 40, 80, 160); the 8² cross-attention (once a
# step) has no row of its own.
SD_ATTNS = [
    (2, 4096, 4096, 5, 64, False),    # UNet level-0 self-attention
    (1, 4096, 4096, 1, 512, True),    # VAE mid-block
    (2, 4096, 77, 5, 64, False),      # UNet level-0 cross-attention
    (2, 1024, 1024, 10, 64, False),   # UNet level 1
    (2, 256, 256, 20, 64, False),     # UNet level 2
    (2, 64, 64, 20, 64, False),       # UNet level 3 and mid-block
    (2, 4096, 4096, 8, 40, False),    # SD 1.5 64² self (JAX's chunked)
    (2, 4096, 77, 8, 40, False),      # SD 1.5 64² cross
    (2, 1024, 1024, 8, 80, False),    # SD 1.5 32²
    (2, 1024, 77, 8, 80, False),
    (2, 256, 256, 8, 160, False),     # SD 1.5 16²
    (2, 256, 77, 8, 160, False),
    (2, 64, 64, 8, 160, False),       # SD 1.5 8² mid-block self
]
# Zero-1-to-3's tower shapes: SD's with the latents at 32² and the VAE at
# 256² (half of SD's sides; the same topology), the UNet's conv_in on 8
# channels, and the ViT-L/14 patch embedding (k = s = 14, no bias, once at
# start-up: conv_fwd_mma's first path shape).
PATCH_CONV = (1, 224, 224, 3, 1024, 14, 14, 0, "bf16", False)
ZERO123_CONVS = [(B, H // 2, W // 2, 8 if (I, O) == (4, 320) else I, O, k,
                  st, pad, dt, dgrad)
                 for B, H, W, I, O, k, st, pad, dt, dgrad in SD_CONVS] + [
    PATCH_CONV]


def zero123_groupnorms(K: int):
    """K11 in one zero123 SDS step over K references: ``SD_GROUPNORMS`` at
    half the sides, the UNet's rows at CFG batch 2K."""
    return [(2 * K if not bwd else B, H // 2, W // 2, C, eps, silu, n, bwd)
            for B, H, W, C, eps, silu, n, bwd in SD_GROUPNORMS]


# K10 in zero123's UNet (SD 1.5's head dims): each level's self-attention
# and its cross-attention over the one context token (M = 1: out = v); the
# VAE mid-block at 256²; and a K = 5 self-attention at 32², JAX's chunked
# branch (q·scale rounded at d = 40).
ZERO123_ATTNS = [
    (2, 1024, 1024, 8, 40, False), (2, 1024, 1, 8, 40, False),
    (2, 256, 256, 8, 80, False), (2, 256, 1, 8, 80, False),
    (2, 64, 64, 8, 160, False), (2, 64, 1, 8, 160, False),
    (2, 16, 16, 8, 160, False), (2, 16, 1, 8, 160, False),
    (1, 1024, 1024, 1, 512, True),
    (10, 1024, 1024, 8, 40, False),
]
SD15_HEAD_DIMS = (40, 80, 160)
# K10's UNet launches per SD step (one self- and one cross-attention per
# transformer: 16 transformers), by route
SD21_UNET_ATTNS = {"attention_fwd_wgmma": 32}
SD15_UNET_ATTNS = {"attention_fwd_wgmma_d40": 10,    # 64²: 5 + 5
                   "attention_fwd_wgmma_d80": 10,    # 32²: 5 + 5
                   "attention_fwd_wgmma_d160": 12}   # 16²: 5 + 5, 8²: 1 + 1


# The SD VAE decoder at 512² (one decode of [1, 64, 64, 4] latents: the
# --save_guidance snapshot's two, txt2img's one), in SD_CONVS' layout, each
# distinct shape once; ``decoder_kernel_phases`` holds the lists to the
# decoder's own calls (recorded on the meta device) and counts them.  Its
# 1x1 convs (post_quant_conv, the shortcuts) are dense layers (F.linear),
# as in the encoder and JAX.
SD_DECODER_CONVS = [
    (1, 64, 64, 4, 512, 3, 1, 1, "bf16", False),         # conv_in
    (1, 64, 64, 512, 512, 3, 1, 1, "bf16", False),       # mid, up level 0
    (1, 128, 128, 512, 512, 3, 1, 1, "bf16", False),     # up 1 (+ upsample)
    (1, 256, 256, 512, 512, 3, 1, 1, "bf16", False),     # upsample to 256²
    (1, 256, 256, 512, 256, 3, 1, 1, "bf16", False),     # up 2's entry
    (1, 256, 256, 256, 256, 3, 1, 1, "bf16", False),     # up 2
    (1, 512, 512, 256, 256, 3, 1, 1, "bf16", False),     # upsample to 512²
    (1, 512, 512, 256, 128, 3, 1, 1, "bf16", False),     # up 3's entry
    (1, 512, 512, 128, 128, 3, 1, 1, "bf16", False),     # up 3
    (1, 512, 512, 128, 3, 3, 1, 1, "fp32", False),       # conv_out
]
# K11 in one decode: SD_GROUPNORMS' layout (eps 1e-6; the mid-block
# attention's norm without SiLU), forward only
SD_DECODER_GROUPNORMS = [
    (1, 64, 64, 512, 1e-6, True, 10, False),
    (1, 64, 64, 512, 1e-6, False, 1, False),
    (1, 128, 128, 512, 1e-6, True, 6, False),
    (1, 256, 256, 512, 1e-6, True, 1, False),
    (1, 256, 256, 256, 1e-6, True, 5, False),
    (1, 512, 512, 256, 1e-6, True, 1, False),
    (1, 512, 512, 128, 1e-6, True, 6, False),
]
SD_DECODER_ATTNS = [(1, 4096, 4096, 1, 512, False)]     # the mid-block
# zero123's decoder: the same tower at half the sides (256²)
ZERO123_DECODER_CONVS = [(B, H // 2, W // 2, *r)
                         for B, H, W, *r in SD_DECODER_CONVS]
ZERO123_DECODER_GROUPNORMS = [(B, H // 2, W // 2, *r)
                              for B, H, W, *r in SD_DECODER_GROUPNORMS]
ZERO123_DECODER_ATTNS = [(1, 1024, 1024, 1, 512, False)]
# Guidance snapshots, txt2img and the guidance sets at full width (random
# weights from seed 0).  The SD 2.1 triplane run with --save_guidance
# --save_guidance_interval 1 takes 6 steps in 2-step epochs (3 snapshots);
# IF, zero123 and the DMTet stage under SD one snapshot each (2 steps); the
# txt2img CLIs 3 DDIM steps; the multi-prior stage 1 (--image_config with
# K = 2 and --text, --guidance SD zero123 clip) 12 steps, each its own
# block (synchronised step times); SD with --image_config and --text 4
# steps; the pixel oracle with the analytic reference image 8 steps.
SNAP_FLAGS = ["--iters", "6", "--dataset_size_train", "2",
              "--save_guidance", "--save_guidance_interval", "1"]
TXT2IMG_STEPS = 3
MULTI_STEPS = 12
MULTI_FLAGS = ["--text", "a hamburger", "--guidance", "SD", "zero123",
               "clip", "--backbone", "triplane", "--seed", "0",
               "--lambda_3d_normal_smooth", "0", "--dataset_size_train", "1",
               "--save_interval", "1000", "--eval_interval", "0", "--H",
               "64", "--W", "64", "--dataset_size_test", "1", "--ckpt",
               "scratch", "--iters", str(MULTI_STEPS)]
REFS_SD_STEPS = 4
ORACLE_REF_STEPS = 8


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, flops: float, kind: str, exps: float = 0.0):
    """(least ms, "bytes" or "operations") for the card's peaks: the larger
    of the bytes' time and the operations' (the products at the peak of
    their type, the exponentials at EXP_PER_S, whichever is longer)."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = max(flops / PEAK[kind], exps / EXP_PER_S) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 10):
    """Device ms of one call: `calls` calls captured in one CUDA graph,
    replayed between two CUDA events; the median of `reps` replays (no host
    in the window).  None for no call."""
    import torch
    if fn is None:
        return None
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def host_us(fn, n: int = 200) -> dict:
    """Host µs of one call, the card idle before each (what a host-bound
    step pays: Python, the launch): {"host_us_min": the least of `n`, which
    other processes on the host's cores can only raise, "host_us": the
    median}."""
    import torch
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return {"host_us_min": min(times) * 1e6,
            "host_us": statistics.median(times) * 1e6}


def _pairs(a, b):
    """The (got, want) pairs of two output lists, outputs that are None in
    both (an optional output not asked for) left out."""
    for x, y in zip(a, b):
        check((x is None) == (y is None), "an output is None on one side")
        if x is not None:
            yield x, y


def max_err(a, b) -> float:
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in _pairs(a, b))


def assert_close(name, got, want, atol, rtol) -> float:
    """Every pair within atol + rtol·|want|; returns the max abs error."""
    for x, y in _pairs(got, want):
        x, y = x.detach().float(), y.detach().float()
        bad = (x - y).abs() > atol + rtol * y.abs()
        check(not bool(bad.any()),
              f"{name}: {int(bad.sum())} of {y.numel()} values outside "
              f"atol {atol} + rtol {rtol} (max err {max_err([x], [y]):.3e})")
    return max_err(got, want)


def record_kernel(results, name, err, ms, plain_ms, tol, n_bytes, flops,
                  kind, library_ms, where="", exps=0.0, main=False):
    """Log one comparison; the first one of a kernel fills its JSON entry
    (the representative shape of the main path), unless a later one is
    the main path's own (``main``)."""
    b_ms, b_by = bound(n_bytes, flops, kind, exps)
    lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
    by_exp = b_by == "operations" and exps / EXP_PER_S > flops / PEAK[kind]
    log(f"{name}{where}: max_abs_err {err:.3e} (tolerance {tol}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, bound "
        f"{b_ms:.4f} ms ({b_by}{' (exponentials)' if by_exp else ''}; "
        f"{n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP"
        f"{f', {exps / 1e6:.0f}M exp' if exps else ''})")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
    if main:
        results[name] = row
    else:
        results.setdefault(name, row)


def grid_sample_calls(torch, x01, planes, g_feat):
    """K1's yardstick: ``F.grid_sample`` (bilinear, align_corners=True,
    zero padding) over the three planes as a batch computes K1's features
    in one call, and ``aten.grid_sampler_2d_backward`` their VJP into the
    planes and the grid (the positions) in one more.  Layouts are made here,
    outside the timed calls → (forward, backward, the features [N, 3C])."""
    import torch.nn.functional as F
    N, C = x01.shape[0], planes.shape[-1]
    inp = planes.permute(0, 3, 1, 2).contiguous()             # [3, C, R, R]
    uv = torch.stack([x01[:, [a, b]] for a, b in ((0, 1), (0, 2), (1, 2))])
    grid = (uv.flip(-1) * 2 - 1)[:, None].contiguous()        # [3, 1, N, 2]
    gout = g_feat.float().reshape(N, 3, C).permute(1, 2, 0)[:, :, None] \
        .contiguous()                                         # [3, C, 1, N]

    def fwd():
        return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    def bwd():
        return torch.ops.aten.grid_sampler_2d_backward(
            gout, inp, grid, 0, 0, True, [True, True])

    feat = fwd()[:, :, 0].permute(2, 0, 1).reshape(N, 3 * C)
    return fwd, bwd, feat


def triplane_rows(torch, results, x, planes, cots, jac, where):
    """K1 against its plain version at positions `x` [N, 3] in [0, 1]:
    the forward (bf16 outputs; with `jac` the jacobian too) and the
    table-only backward from cotangents `cots` (on feat, and with `jac` on
    jx, jy, jz: 4 of them; else 1); without `jac`, also the backward with
    the position gradient (``triplane_bwd_dx``).  Beside each, the library
    yardstick (``grid_sample_calls``: the features alone, and their VJP).
    The bytes count the plane rows the positions touch (data-dependent:
    what this run reads)."""
    from dreamfusion_tpu_torch.ops import triplane as K1
    bf = torch.bfloat16
    N, C, R = x.shape[0], planes.shape[-1], planes.shape[1]
    rows = int(torch.unique(K1._corners(x, R)[0]).numel()) * C * 4
    lib_fwd, lib_bwd, lib_feat = grid_sample_calls(torch, x, planes, cots[0])
    # the yardstick computes the same features (fp32 rounding of the
    # coordinates: 1e-5)
    assert_close("grid_sample", [lib_feat],
                 [K1.triplane_fwd_plain(x, planes, False)[0]], 1e-5, 1e-5)
    lib_ms = (median_ms(lib_fwd), median_ms(lib_bwd))
    out_k = K1.triplane_fwd_cuda(x, planes, jac, bf)
    torch.cuda.synchronize()
    out_p = [o.to(bf) for o in K1.triplane_fwd_plain(x, planes, jac)]
    # both round the same fp32 sums to bf16: one bf16 ulp at most
    err = assert_close("triplane_fwd", out_k, out_p, 1e-6, 2 ** -7)
    record_kernel(results, "triplane_fwd", err,
                  median_ms(lambda: K1.triplane_fwd_cuda(x, planes, jac, bf)),
                  median_ms(lambda: K1.triplane_fwd_plain(x, planes, jac)),
                  "1 bf16 ulp", nbytes(x, *out_k) + rows,
                  N * 3 * 4 * C * 2 * (3 if jac else 1), "fp32", lib_ms[0],
                  where + (" (library: the features only)" if jac else ""))
    g_j = cots[1:] if jac else (None,) * 3
    dk = K1.triplane_bwd_cuda(x, planes.shape, cots[0], g_j)
    torch.cuda.synchronize()
    dp = K1.triplane_bwd_plain(x, planes.shape, cots[0], g_j)
    scale = float(dp.abs().max())
    err = assert_close("triplane_bwd", [dk], [dp], 1e-5 * scale, 1e-5)
    record_kernel(results, "triplane_bwd", err,
                  median_ms(lambda: K1.triplane_bwd_cuda(x, planes.shape,
                                                         cots[0], g_j)),
                  median_ms(lambda: K1.triplane_bwd_plain(x, planes.shape,
                                                          cots[0], g_j), 5),
                  "1e-5 of max |dplanes| (fp32 reductions in any order)",
                  nbytes(x, cots[0], *g_j, dk),
                  N * 3 * 4 * C * 2 * (3 if jac else 1), "fp32", lib_ms[1],
                  where + " (library: the features' VJP, planes and grid)")
    if jac:
        return
    (pk, xk) = K1.triplane_bwd_dx_cuda(x, planes, cots[0])
    torch.cuda.synchronize()
    (pp, xp) = K1.triplane_bwd_dx_plain(x, planes, cots[0])
    err = max(assert_close("triplane_bwd_dx", [pk], [pp],
                           1e-5 * float(pp.abs().max()), 1e-5),
              assert_close("triplane_bwd_dx", [xk], [xp],
                           1e-5 * float(xp.abs().max()), 1e-5))
    record_kernel(results, "triplane_bwd_dx", err,
                  median_ms(lambda: K1.triplane_bwd_dx_cuda(x, planes,
                                                            cots[0])),
                  median_ms(lambda: K1.triplane_bwd_dx_plain(x, planes,
                                                             cots[0]), 5),
                  "1e-5 of max |dplanes|, of max |dx| (fp32 reductions in "
                  "any order)", nbytes(x, cots[0], pk, xk) + rows,
                  N * 3 * 4 * C * 4, "fp32", lib_ms[1],
                  where + " (library: the features' VJP, planes and grid)")


def flagship_march(torch) -> dict:
    """The flagship step's 4096 rays (seed 1) and their march through a
    sphere-shaped 128³ occupancy grid with 32 probes: the march's inputs,
    its output ``mk``, the generator ``g`` after its draws, and the step's
    98,304 sample positions, ``xyz`` and ``x01`` (the encoder's [0, 1]
    coordinates).  The plain march places them (from torch's near/far, as
    in every checkout ``bench_sd_kernels.py`` compares), so the later
    kernels' inputs do not depend on K2's kernel."""
    from dreamfusion_tpu_torch.config import Config, finalize
    from dreamfusion_tpu_torch.core.sampling import (near_far_from_bound,
                                                     stratified_u)
    from dreamfusion_tpu_torch.ops import occupancy as K2
    from dreamfusion_tpu_torch.training.trainer import draw_step, train_batch

    dev = torch.device("cuda")
    cfg = finalize(Config(guidance=("oracle",), backbone="triplane"))
    g = torch.Generator(device=dev).manual_seed(1)
    draws = draw_step(g, cfg, dev)
    batch = train_batch(cfg, draws.pose, draws.fov, 0, cfg.h, cfg.w)
    ro = batch.rays_o.reshape(-1, 3).contiguous()
    rd = batch.rays_d.reshape(-1, 3).contiguous()
    G = cfg.grid_size
    ax = (torch.arange(G, device=dev) + 0.5) / G * 2 - 1
    X, Y, Z = torch.meshgrid(ax, ax, ax, indexing="ij")
    occ = ((X - 0.2) ** 2 + Y ** 2 + Z ** 2 < 0.25)[None].contiguous()
    near, far = near_far_from_bound(ro, rd, cfg.bound, "cube", cfg.min_near)
    edges = K2.probe_edges(cfg.grid_coarse_steps, device=dev)
    u = stratified_u(torch.rand(ro.shape[0], cfg.grid_fine_steps, device=dev,
                                generator=g)).contiguous()
    mk = K2.march_plain(ro, rd, near, far, occ, cfg.bound, edges, u)
    xyz = torch.clamp(ro[:, None] + rd[:, None] * mk.z_vals[..., None],
                      -cfg.bound, cfg.bound).reshape(-1, 3).contiguous()
    x01 = ((xyz + cfg.bound) / (2 * cfg.bound)).contiguous()
    return dict(cfg=cfg, g=g, ro=ro, rd=rd, near=near, far=far, occ=occ,
                edges=edges, u=u, mk=mk, xyz=xyz, x01=x01)


def probe_cells(torch, ro, rd, near, far, occ, bound, edges) -> int:
    """Distinct occupancy-grid cells the march's probes read (bytes: the
    grid is one byte a cell), as ``march_plain`` places the probes."""
    from dreamfusion_tpu_torch.ops import occupancy as K2
    z_edges = near + (far - near) * edges[None, :]
    z_mid = 0.5 * (z_edges[:, 1:] + z_edges[:, :-1])
    pts = ro[:, None, :] + rd[:, None, :] * z_mid[..., None]
    cascade, G = occ.shape[0], occ.shape[1]
    mip = K2.mip_from_pos(pts, cascade)
    mb = torch.clamp(torch.exp2(mip.float()), max=bound)[..., None]
    cell = torch.clamp(torch.floor((pts / mb * 0.5 + 0.5) * G).long(), 0,
                       G - 1)
    flat = ((mip * G + cell[..., 0]) * G + cell[..., 1]) * G + cell[..., 2]
    return int(torch.unique(flat).numel())


def kernel_phases(torch, results, smi_line):
    """Each kernel against its plain version at the flagship step's shapes:
    4096 rays x 24 samples (N = 98,304 field samples), a 3x256²x16 triplane,
    a 128³ occupancy grid, 32 probes (K3 and K4: ``render_kernel_phases``).
    """
    from dreamfusion_tpu_torch.ops import occupancy as K2

    m = flagship_march(torch)
    cfg, g, ro, rd, near, far, occ, edges, u = (
        m[k] for k in ("cfg", "g", "ro", "rd", "near", "far", "occ", "edges",
                       "u"))
    dev = ro.device
    R, S, P = ro.shape[0], cfg.grid_fine_steps, cfg.grid_coarse_steps

    def record(name, err, ms, plain_ms, tol, n_bytes, flops, where=""):
        # fp32 CUDA-core arithmetic, a few operations per byte
        record_kernel(results, name, err, ms, plain_ms, tol, n_bytes, flops,
                      "fp32", None, where)

    # ---- K2: the march region (near/far, march, positions), one launch --
    rk, xk = K2.march_region_cuda(ro, rd, occ, cfg.bound, cfg.min_near,
                                  edges, u)
    torch.cuda.synchronize()
    rp, xp = K2.march_region_plain(ro, rd, occ, cfg.bound, cfg.min_near,
                                   edges, u)
    same = (rk.mask == rp.mask).all(-1)
    check(float(same.float().mean()) >= 0.999,
          f"march_rays: masks differ on {int((~same).sum())} of {R} rays")
    check(bool(rp.mask.any()), "march_rays: no occupied sample")
    check(rk.mask.dtype == torch.bool, "march_rays: the mask is not bool")
    tol = "z, deltas, positions 1e-5 on rays whose masks agree (>= 99.9%)"
    err = assert_close("march_rays", [rk.z_vals[same], rk.deltas[same],
                                      xk[same]],
                       [rp.z_vals[same], rp.deltas[same], xp[same]], 1e-5,
                       1e-6)
    # the twin takes torch's near/far: the rays whose samples it places
    # bit for bit as the kernel does
    diff = (rp.z_vals != rk.z_vals).any(-1) | (rp.mask != rk.mask).any(-1)
    log(f"march_rays: the kernel's samples against the twin's (torch's "
        f"near/far): {int(diff.sum())} of {R} rays differ in a bit")
    cells = probe_cells(torch, ro, rd, near, far, occ, cfg.bound, edges)
    region = lambda: K2.march_region_cuda(ro, rd, occ, cfg.bound,
                                          cfg.min_near, edges, u)
    what = " [the region: near/far, march, positions]"
    log(f"march_rays{what}: graph {graph_ms(region):.4f} ms on {smi_line}")
    record("march_rays", err, median_ms(region),
           median_ms(lambda: K2.march_region_plain(
               ro, rd, occ, cfg.bound, cfg.min_near, edges, u)), tol,
           nbytes(ro, rd, u, edges, *rk, xk) + cells,
           R * (P * 20 + S * 30), what)

    xyz, x01 = m["xyz"], m["x01"]
    N = xyz.shape[0]

    # ---- K1 triplane, bf16 outputs as in the fp16 step ------------------
    planes = torch.randn(3, cfg.triplane_resolution, cfg.triplane_resolution,
                         cfg.triplane_channels, device=dev, generator=g) * 0.1
    D = 3 * cfg.triplane_channels
    cots = [torch.randn(N, D, device=dev, generator=g).to(torch.bfloat16)
            for _ in range(4)]
    triplane_rows(torch, results, x01, planes, cots, True,
                  f" [{N} step samples, {cfg.triplane_resolution}²x"
                  f"{cfg.triplane_channels}] + jacobian")

    render_kernel_phases(torch, results, m, smi_line)
    return x01


def flagship_field_inputs(torch, m, act="exp") -> dict:
    """What the field head sees in the flagship step: h and the tangents
    from the flagship's 3x64 MLP (bf16) on a 256²x16 triplane (seeded,
    ±0.1) at the march ``m``'s 98,304 sample positions; one light direction
    a ray; the ratio as a device scalar.  `act`: the field's density
    activation."""
    from dreamfusion_tpu_torch.core.math import safe_normalize
    from dreamfusion_tpu_torch.models.nerf import NeRFField
    cfg, dev = m["cfg"], m["ro"].device
    g = torch.Generator(device=dev).manual_seed(13)
    field = NeRFField(backbone="triplane", bound=cfg.bound,
                      hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                      density_act=act, blob_density=cfg.blob_density,
                      blob_radius=cfg.blob_radius,
                      triplane_resolution=cfg.triplane_resolution,
                      triplane_channels=cfg.triplane_channels,
                      compute_dtype=torch.bfloat16)
    field.reset_parameters(torch.Generator().manual_seed(0))
    field.to(dev)
    with torch.no_grad():
        for p in field.triplanes:
            p.copy_(torch.randn(p.shape, device=dev, generator=g) * 0.1)
        feat, jac = field.encode(m["xyz"], need_jacobian=True)
        h, t = field.sigma_net(feat, torch.bfloat16,
                               tangents=torch.stack(jac))
    light = safe_normalize(m["ro"] + torch.randn(
        m["ro"].shape, device=dev, generator=g))
    return dict(field=field, h=h, t=t, light=light, g=g,
                ratio=torch.tensor(0.3, device=dev))


def _bf16_close(name, got, want, floor):
    """Each value within one bf16 ulp (2^-7 of it) plus `floor` of the
    largest: both round an fp32 result once → the max abs error."""
    for x, y in _pairs(got, want):
        x, y = x.float(), y.float()
        bad = (x - y).abs() > 2 ** -7 * y.abs() + floor * float(
            y.abs().max())
        check(not bool(bad.any()), f"{name}: {int(bad.sum())} of "
              f"{y.numel()} values outside 1 bf16 ulp + {floor} of the "
              f"largest (max err {max_err([x], [y]):.3e})")
    return max_err(got, want)


def render_kernel_phases(torch, results, m, smi_line):
    """K4 (the head alone, and with the normals and the shading) and K3
    (with every background form and the orient loss) against their plain
    twins at the flagship step's shapes (4096 rays x 24, bf16 h and
    tangents from the flagship MLP, the march's masks, one light a ray)
    and at an eval chunk (4096 rays of an 800² circle view: the head alone,
    K3 with the white background); event ms and graph ms (20 calls in a
    CUDA graph) of each, beside the card's name and power limit."""
    from dreamfusion_tpu_torch.ops import activation as K4
    from dreamfusion_tpu_torch.ops import composite as K3
    fi = flagship_field_inputs(torch, m)
    h, t, light, ratio, g = (fi[k] for k in ("h", "t", "light", "ratio",
                                             "g"))
    cfg, xyz, mk = m["cfg"], m["xyz"], m["mk"]
    R, S = mk.z_vals.shape
    N, dev = R * S, xyz.device
    bd, br, bound = cfg.blob_density, cfg.blob_radius, cfg.bound

    def record(name, err, fn, plain, tol, n_bytes, flops, where):
        ms, gms = median_ms(fn), graph_ms(fn)
        log(f"{name}{where}: graph {gms:.4f} ms on {smi_line}")
        record_kernel(results, name, err, ms, median_ms(plain), tol,
                      n_bytes, flops, "fp32", None, where)

    # ---- K4: the head alone (the refresh, the DMTet albedo query) --------
    fk = K4.field_head_fwd_cuda(h, xyz, bd, br)
    torch.cuda.synchronize()
    fp = K4.field_head_fwd_plain(h, xyz, bd, br)
    err = assert_close("field_head_fwd", fk, fp, 1e-6, 1e-5)
    record("field_head_fwd", err,
           lambda: K4.field_head_fwd_cuda(h, xyz, bd, br),
           lambda: K4.field_head_fwd_plain(h, xyz, bd, br), "1e-5 rel",
           nbytes(h, xyz, *fk), N * 20, f" [{N} step samples, bf16 h]")
    gc = [torch.randn(o.shape, device=dev, generator=g) for o in fp]
    bk = K4.field_head_bwd_cuda(h, xyz, bd, br, *gc)
    torch.cuda.synchronize()
    bp = K4.field_head_bwd_plain(h, xyz, bd, br, *gc).to(h.dtype)
    err = _bf16_close("field_head_bwd", [bk], [bp], 1e-6)
    record("field_head_bwd", err,
           lambda: K4.field_head_bwd_cuda(h, xyz, bd, br, *gc),
           lambda: K4.field_head_bwd_plain(h, xyz, bd, br, *gc),
           "1 bf16 ulp + 1e-6 of the largest", nbytes(h, xyz, *gc, bk),
           N * 15, f" [{N} step samples, bf16 h]")

    # ---- K4 with the normals and the shading (every shading id) ---------
    for sid in (1, 3, 0, 2):         # lambertian and normal first: the path
        ids = torch.tensor(sid, device=dev)
        args = (h, t, xyz, light, ratio, ids, bd, br, bound)
        sk = K4.field_shade_fwd_cuda(*args)
        torch.cuda.synchronize()
        sp = K4.field_shade_fwd_plain(*args)
        err = assert_close("field_shade_fwd", sk, sp, 1e-5, 2e-5)
        where = f" [{N} step samples, bf16 h and tangents, shading {sid}]"
        record("field_shade_fwd", err,
               lambda: K4.field_shade_fwd_cuda(*args),
               lambda: K4.field_shade_fwd_plain(*args), "1e-5 + 2e-5 rel",
               nbytes(h, t, xyz, light, *sk), N * 60, where)
        gs = [torch.randn(o.shape, device=dev, generator=g) for o in sp]
        dk = K4.field_shade_bwd_cuda(*args, *gs)
        torch.cuda.synchronize()
        check(not bool(dk[1][..., 1:].any()),
              "field_shade_bwd: tangent columns 1-3 not zero")
        dp = K4.field_shade_bwd_plain(*args, *gs)
        err = _bf16_close("field_shade_bwd", dk, dp, 1e-5)
        record("field_shade_bwd", err,
               lambda: K4.field_shade_bwd_cuda(*args, *gs),
               lambda: K4.field_shade_bwd_plain(*args, *gs),
               "1 bf16 ulp + 1e-5 of the largest",
               nbytes(h, t, xyz, light, *gs, *dk), N * 90, where)

    # ---- K3 with every background form and the orient loss ---------------
    ids = torch.tensor(1, device=dev)
    sigma, rgb, normal = K4.field_shade_fwd_cuda(h, t, xyz, light, ratio,
                                                 ids, bd, br, bound)
    sigma, rgb = sigma.reshape(R, S), rgb.reshape(R, S, 3)
    normals = normal.reshape(R, S, 3)
    z, dl, mask, rd = mk.z_vals, mk.deltas, mk.mask, m["rd"]
    rgb3 = torch.rand(3, device=dev, generator=g)
    net = torch.rand(R, 3, device=dev, generator=g)
    forms = [   # the step's first: a drawn colour or the net's, chosen
        ("[3] colour or the net's (drawn: net), orient",
         dict(bg_color=rgb3.expand(R, 3), bg_net=net,
              use_bg_net=torch.tensor(True, device=dev)), True),
        ("[3] colour or the net's (drawn: colour), orient",
         dict(bg_color=rgb3.expand(R, 3), bg_net=net,
              use_bg_net=torch.tensor(False, device=dev)), True),
        ("[R, 3] colour (known view), orient",
         dict(bg_color=torch.rand(R, 3, device=dev, generator=g)), True),
        ("white, no orient", dict(bg_color=1.0), False),
        ("none, no orient", {}, False)]
    for what, bg, orient in forms:
        extra = dict(bg, normals=normals if orient else None,
                     rays_d=rd if orient else None)
        fargs = (sigma, rgb, z, dl, mask, 1e-4, False)
        ck = K3._composite_fwd_cuda(*fargs, **extra)
        torch.cuda.synchronize()
        cp = K3.composite_fwd_plain(*fargs, **extra)
        err = assert_close("composite_fwd", ck, cp, 1e-5, 1e-5)
        where = f" [{R}x{S} step rays, background {what}]"
        store = [v for v in (bg.get("bg_color"), bg.get("bg_net"),
                             bg.get("use_bg_net")) if torch.is_tensor(v)]
        store = [v[0] if v.dim() == 2 and v.stride(0) == 0 else v
                 for v in store]             # a broadcast colour: 3 floats
        record("composite_fwd", err,
               lambda: K3._composite_fwd_cuda(*fargs, **extra),
               lambda: K3.composite_fwd_plain(*fargs, **extra),
               "1e-5", nbytes(sigma, rgb, z, dl, mask, *store, *(
                   (normals, rd) if orient else ()), *ck), R * S * 30, where)
        cc = [torch.randn(o.shape, device=dev, generator=g) for o in cp
              if o is not None]
        bargs = (sigma, rgb, z, dl, mask, cp.weights, *cc[:4], 1e-4)
        gl = cc[4] if orient else None
        gk = K3._composite_bwd_cuda(*bargs, **extra, g_loss=gl,
                                    wsum=ck.weights_sum)
        torch.cuda.synchronize()
        gp = K3.composite_bwd_plain(*bargs, **extra, g_loss=gl)
        gk = [x for x in gk if x is not None]
        gp = [x for x in gp if x is not None]
        check(len(gk) == len(gp), "composite_bwd: gradients differ in kind")
        scale = max(float(x.abs().max()) for x in gp)
        err = assert_close("composite_bwd", gk, gp, 1e-5 * scale, 1e-4)
        record("composite_bwd", err,
               lambda: K3._composite_bwd_cuda(*bargs, **extra, g_loss=gl,
                                              wsum=ck.weights_sum),
               lambda: K3.composite_bwd_plain(*bargs, **extra, g_loss=gl),
               "1e-4 rel, 1e-5 of the largest (sums in another order)",
               nbytes(sigma, rgb, z, dl, mask, cp.weights, *store, *cc,
                      *gk), R * S * 40, where)

    # ---- an eval chunk: 4096 rays of an 800² view, albedo, white ---------
    from dreamfusion_tpu_torch.core.sampling import det_u
    from dreamfusion_tpu_torch.ops import occupancy as K2
    from dreamfusion_tpu_torch.training.data import circle_view_batch
    view = circle_view_batch(cfg, 0, 8, cfg.H, cfg.W, dev)
    ro = view.rays_o[0][:cfg.max_ray_batch]
    rde = view.rays_d[0][:cfg.max_ray_batch]
    me, xe = K2.march_region_cuda(ro, rde, m["occ"], bound, cfg.min_near,
                                  m["edges"], det_u(1, S, device=dev)[0])
    xe = xe.reshape(-1, 3)
    with torch.no_grad():
        he = fi["field"].sigma_net(fi["field"].encode(xe), torch.bfloat16)
    where = (f" [eval chunk: {ro.shape[0]} rays x {S} of an {cfg.H}x"
             f"{cfg.W} view, albedo")
    ek = K4.field_head_fwd_cuda(he, xe, bd, br)
    torch.cuda.synchronize()
    ep = K4.field_head_fwd_plain(he, xe, bd, br)
    err = assert_close("field_head_fwd", ek, ep, 1e-6, 1e-5)
    record("field_head_fwd", err,
           lambda: K4.field_head_fwd_cuda(he, xe, bd, br),
           lambda: K4.field_head_fwd_plain(he, xe, bd, br), "1e-5 rel",
           nbytes(he, xe, *ek), xe.shape[0] * 20, where + "]")
    se = ek[0].reshape(-1, S)
    ae = ek[1].reshape(-1, S, 3)
    fargs = (se, ae, me.z_vals, me.deltas, me.mask, 1e-4, False, 1.0)
    ck = K3._composite_fwd_cuda(*fargs)
    torch.cuda.synchronize()
    cp = K3.composite_fwd_plain(*fargs)
    err = assert_close("composite_fwd", ck, cp, 1e-5, 1e-5)
    record("composite_fwd", err, lambda: K3._composite_fwd_cuda(*fargs),
           lambda: K3.composite_fwd_plain(*fargs), "1e-5",
           nbytes(se, ae, *me, *ck),
           se.numel() * 25, where + ", white background]")


def hashgrid_kernel_phases(torch, results, x01):
    """K6 against its plain version at the flagship spec (L4C8 affine
    smoothstep, 2^19 rows, desired resolution 2048: 1,576,960 x 8 fp32),
    at the shapes of the grid step (the step's 98,304 sample positions,
    forward with the jacobian in bf16, backward), of the density-grid
    refresh (262,144 positions, forward only) and of the tv (4096 cells
    per level) and wd terms; then the tcnn layout (L16C2 xor).  The DMTet
    albedo query's rows are ``field_query_phase``'s."""
    from dreamfusion_tpu_torch.config import Config
    from dreamfusion_tpu_torch.ops import hashgrid as K6
    from dreamfusion_tpu_torch.training.trainer import grid_spec_of

    dev = x01.device
    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16

    def rows_touched(x, spec):
        """Distinct table rows the corners of x read (the gather's bytes
        depend on the data: count what this run's positions need)."""
        ids = [K6._corners(x, spec, l)[0].reshape(-1)
               for l in range(spec.num_levels)]
        return int(torch.unique(torch.cat(ids)).numel())

    def encode_phase(spec, x, where, jac=True, dtype=bf):
        C, L = spec.level_dim, spec.num_levels
        table = (torch.rand(spec.table_size, C, device=dev, generator=g)
                 - 0.5) * 0.2
        ok = K6.hash_fwd_cuda(x, table, spec, L, jac, dtype)
        torch.cuda.synchronize()
        op = [o.to(dtype) for o in K6.hash_fwd_plain(x, table, spec, L, jac)]
        # both round fp32 sums to bf16: one bf16 ulp, plus 1e-6 of each
        # output's largest, since the jacobian sums 8 terms of up to ~500
        # that can cancel (fp32 sums in two orders differ by ~1e-4 there)
        err = max(assert_close("hashgrid_fwd", [a], [b], 1e-6 + 1e-6 * float(
            b.float().abs().max()), 2 ** -7) for a, b in zip(ok, op))
        N = x.shape[0]
        row_bytes = rows_touched(x, spec) * C * 4
        record_kernel(results, "hashgrid_fwd", err, median_ms(
            lambda: K6.hash_fwd_cuda(x, table, spec, L, jac, dtype)),
            median_ms(lambda: K6.hash_fwd_plain(x, table, spec, L, jac), 5),
            "1 bf16 ulp + 1e-6 of max", nbytes(x, *ok) + row_bytes,
            N * L * (8 * C * 2 * (4 if jac else 1) + 120), "fp32", None,
            where)
        return table

    # ---- the flagship spec at the step's positions ------------------------
    spec = grid_spec_of(Config())
    N, L, C = x01.shape[0], spec.num_levels, spec.level_dim
    where = (f" [{N} samples, L{L}C{C} {spec.gridtype} "
             f"{spec.interpolation}, {spec.table_size} rows]")
    table = encode_phase(spec, x01, where + " + jacobian")
    cots = [torch.randn(N, L * C, device=dev, generator=g).to(bf)
            for _ in range(4)]
    dk = K6.hash_bwd_cuda(x01, spec, L, cots[0], cots[1:])
    torch.cuda.synchronize()
    dp = K6.hash_bwd_plain(x01, spec, L, cots[0], cots[1:])
    scale = float(dp.abs().max())
    err = assert_close("hashgrid_bwd", [dk], [dp], 1e-5 * scale, 1e-5)
    record_kernel(results, "hashgrid_bwd", err, median_ms(
        lambda: K6.hash_bwd_cuda(x01, spec, L, cots[0], cots[1:])),
        median_ms(lambda: K6.hash_bwd_plain(x01, spec, L, cots[0], cots[1:]),
                  5), "1e-5 of max |dtable| (fp32 atomics in any order)",
        nbytes(x01, *cots, dk), N * L * 8 * C * 8, "fp32", None, where)

    # ---- the grid refresh's chunk: forward only ----------------------------
    xr = torch.rand(262144, 3, device=dev, generator=g)
    encode_phase(spec, xr, " [262,144 refresh positions, no jacobian]",
                 jac=False)

    # ---- tv and wd over the flagship table ---------------------------------
    cells = K6.draw_tv_cells(g, spec, dev)
    tv_rows = sum(int(torch.unique(torch.cat([i0[None], i1])).numel())
                  for l in range(L) for i0, i1 in
                  [K6._tv_pairs(cells[l], spec, l)])
    tk = K6.hash_tv_cuda(table, cells, spec)
    torch.cuda.synchronize()
    tp = K6.hash_tv_plain(table, cells, spec)
    err = assert_close("hashgrid_tv_fwd", [tk], [tp], 0, 1e-5)
    c32 = cells.to(torch.int32)
    record_kernel(results, "hashgrid_tv_fwd", err, median_ms(
        lambda: K6.hash_tv_cuda(table, cells, spec)),
        median_ms(lambda: K6.hash_tv_plain(table, cells, spec)),
        "1e-5 rel", nbytes(c32, tk) + tv_rows * C * 4,
        L * cells.shape[1] * 3 * C * 3, "fp32", None,
        f" [{L} x {cells.shape[1]} cells]")
    gl = torch.tensor(0.7, device=dev)
    tbk = K6.hash_tv_bwd_cuda(table, cells, spec, gl)
    torch.cuda.synchronize()
    tbp = K6.hash_tv_bwd_plain(table, cells, spec, gl)
    scale = float(tbp.abs().max())
    err = assert_close("hashgrid_tv_bwd", [tbk], [tbp], 1e-5 * scale, 1e-5)
    record_kernel(results, "hashgrid_tv_bwd", err, median_ms(
        lambda: K6.hash_tv_bwd_cuda(table, cells, spec, gl)),
        median_ms(lambda: K6.hash_tv_bwd_plain(table, cells, spec, gl)),
        "1e-5 of max (fp32 atomics in any order)",
        nbytes(c32, gl, tbk) + tv_rows * C * 4,
        L * cells.shape[1] * 3 * C * 6, "fp32", None,
        f" [{L} x {cells.shape[1]} cells]")
    wk = K6.hash_wd_cuda(table, spec)
    torch.cuda.synchronize()
    wp = K6.hash_wd_plain(table, spec)
    err = assert_close("hashgrid_wd_fwd", [wk], [wp], 0, 1e-5)
    record_kernel(results, "hashgrid_wd_fwd", err, median_ms(
        lambda: K6.hash_wd_cuda(table, spec)),
        median_ms(lambda: K6.hash_wd_plain(table, spec)), "1e-5 rel",
        nbytes(table, wk), 2 * table.numel(), "fp32", None,
        f" [{spec.table_size} x {C}]")
    wbk = K6.hash_wd_bwd_cuda(table, spec, gl)
    torch.cuda.synchronize()
    wbp = K6.hash_wd_bwd_plain(table, spec, gl)
    err = assert_close("hashgrid_wd_bwd", [wbk], [wbp], 0, 1e-6)
    record_kernel(results, "hashgrid_wd_bwd", err, median_ms(
        lambda: K6.hash_wd_bwd_cuda(table, spec, gl)),
        median_ms(lambda: K6.hash_wd_bwd_plain(table, spec, gl)), "1e-6 rel",
        nbytes(table, gl, wbk), table.numel(), "fp32", None,
        f" [{spec.table_size} x {C}]")

    # ---- the tcnn layout: L16C2 xor, 2^19 rows -----------------------------
    tcnn = grid_spec_of(Config(grid_levels=16, grid_features_per_level=2,
                               grid_hash="xor"))
    where = (f" [{N} samples, L16C2 xor smoothstep, {tcnn.table_size} "
             f"rows] + jacobian")
    encode_phase(tcnn, x01, where)
    cots = [torch.randn(N, 32, device=dev, generator=g).to(bf)
            for _ in range(4)]
    dk = K6.hash_bwd_cuda(x01, tcnn, 16, cots[0], cots[1:])
    torch.cuda.synchronize()
    dp = K6.hash_bwd_plain(x01, tcnn, 16, cots[0], cots[1:])
    scale = float(dp.abs().max())
    err = assert_close("hashgrid_bwd", [dk], [dp], 1e-5 * scale, 1e-5)
    record_kernel(results, "hashgrid_bwd", err, median_ms(
        lambda: K6.hash_bwd_cuda(x01, tcnn, 16, cots[0], cots[1:])),
        median_ms(lambda: K6.hash_bwd_plain(x01, tcnn, 16, cots[0], cots[1:]),
                  5), "1e-5 of max |dtable|", nbytes(x01, *cots, dk),
        N * 16 * 8 * 2 * 8, "fp32", None, where)


def _randn_on(torch, g):
    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, device="cuda", generator=g) * scale).to(
            dtype)
    return randn


def _close_to(name, got, want, rel, floor):
    """|got - want| <= rel*|want| + floor*max|want| everywhere."""
    scale = float(want.float().abs().max())
    return assert_close(name, [got], [want], floor * scale, rel)


def _graph_where(where, fn, graph):
    """`where` with the call's graph ms appended (``graph_ms``) when
    `graph` is set."""
    return f"{where}, graph {graph_ms(fn):.4f} ms" if graph else where


def conv_rows(torch, results, rows, randn, graph=False, no_bias=(),
              times=None, main=()):
    """K12's forward (by route) and, where the row asks, its dgrad against
    the plain versions and cuDNN at each row of ``SD_CONVS``' layout;
    `graph`: log each call's graph ms too, the forward's cuDNN call's
    beside it; `no_bias`: rows whose conv has no bias (the patch
    embeddings), whose forward and dgrad rows fill their kernels' JSON
    entries (the path's own shapes), as do the `main` rows; `times`: a
    dict given each row's forward (kernel ms, library ms, and with `graph`
    their graph ms, else None)."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input

    from dreamfusion_tpu_torch.ops import conv as K12
    from dreamfusion_tpu_torch.ops import kernels

    bf = torch.bfloat16
    dev = torch.device("cuda")
    for row in rows:
        B, H, W, I, O, k, st, pad, dt, dgrad = row
        dt = torch.float32 if dt == "fp32" else bf
        pads = K12.norm_padding(pad)
        route = K12.conv_route(dt, I, O, (st, st), k * k)
        where = f" [{B},{H},{W},{I}->{O}] {k}x{k} s{st} pad {pads} {dt}"
        x = randn(B, H, W, I, dtype=dt)
        w = randn(O, k, k, I, scale=(k * k * I) ** -0.5, dtype=dt)
        bias = None if row in no_bias else randn(O, dtype=torch.float32)
        kernels.reset_launch_counts()
        yk = K12.conv2d_fwd_cuda(x, w, bias, (st, st), pads, dt)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[route] == 1, f"{where}: not on {route}")
        yp = K12.conv2d_plain(x, w, bias, (st, st), pads, dt)
        fp32 = dt == torch.float32
        # same bf16 products, fp32 sums in another order, one rounding
        err = _close_to(route, yk, yp, 1e-5 if fp32 else 2 ** -7, 1e-4)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
        # one F.conv2d call; an asymmetric (TF-SAME) pad is applied to its
        # input first, outside the timing
        sym = pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]
        xl = xc if sym else F.pad(xc, (*pads[1], *pads[0]))
        # fp32 in full fp32, as the kernel's FMAs (cuDNN's default TF32
        # would be another function)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        lib_call = lambda: F.conv2d(xl, wc, None if bias is None else
                                    bias.to(dt), st, pads[0][0] if sym else 0)
        try:
            lib = median_ms(lib_call, 10)
            # cuDNN's fp32 algorithm can take 0.2 s (the DPT's 192² conv):
            # few calls
            lib_g = graph_ms(lib_call, 5, 3) if graph else None
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        flops = 2 * yk.numel() * k * k * I
        call = lambda: K12.conv2d_fwd_cuda(x, w, bias, (st, st), pads, dt)
        ms = median_ms(call, 10)
        k_g = graph_ms(call) if graph else None
        if times is not None:
            times[row] = (ms, lib, k_g, lib_g)
        record_kernel(results, route, err, ms,
                      median_ms(lambda: K12.conv2d_plain(
                          x, w, bias, (st, st), pads, dt), 5),
                      "1e-5 rel" if fp32 else "1 bf16 ulp + 1e-4 of max",
                      nbytes(x, w, bias, yk), flops,
                      "fp32" if fp32 else "bf16", lib,
                      where + (f", graph {k_g:.4f} ms (cuDNN {lib_g:.4f})"
                               if graph else ""),
                      main=row in no_bias or row in main)
        if not dgrad:
            continue
        route = K12.dgrad_route(dt, I, O, (st, st), (k, k))
        dy = randn(*yk.shape, dtype=dt)
        kernels.reset_launch_counts()
        dk = K12.conv2d_dgrad_cuda(dy, w, x.shape, (st, st), pads, dt)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[route] == 1, f"{where} dgrad: not on {route}")
        xr = torch.zeros(x.shape, device=dev, requires_grad=True)
        (dp,) = torch.autograd.grad(K12.conv2d_plain(
            xr, w, None, (st, st), pads, torch.float32), xr, dy.float())
        err = _close_to(route, dk, dp, 1e-5 if fp32 else 2 ** -7, 1e-4)
        dyc = dy.permute(0, 3, 1, 2)
        lib = None
        if pads[0][0] == pads[0][1]:
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                lib = median_ms(lambda: conv2d_input(xc.shape, wc, dyc, st,
                                                     pads[0][0]), 10)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32

        def plain_dgrad():
            xr = torch.zeros(x.shape, device=dev, requires_grad=True)
            torch.autograd.grad(K12.conv2d_plain(
                xr, w, None, (st, st), pads, torch.float32), xr, dy.float())

        call = lambda: K12.conv2d_dgrad_cuda(dy, w, x.shape, (st, st), pads,
                                             dt)
        record_kernel(results, route, err, median_ms(call, 10),
                      median_ms(plain_dgrad, 3),
                      "1e-5 rel" if fp32 else "1 bf16 ulp + 1e-4 of max",
                      nbytes(dy, w, dk), flops, "fp32" if fp32 else "bf16",
                      lib, _graph_where(where + " dgrad", call, graph),
                      main=row in no_bias or row in main)


def attention_rows(torch, results, rows, randn, graph=False,
                   check_lse=False, times=None):
    """K10's forward (by head dim, on JAX's branch: q·scale rounded to bf16
    first on the chunked one) and, where the row asks, its backward
    against the plain versions and SDPA.  A row of one key (zero123's
    cross-attention) must give v exactly (P = 1); with `check_lse`, every
    row's lse is held to the fp32 logits' logsumexp (IF's key counts: the
    last KV tile part zero-filled and masked); `times`: a dict given each
    row's forward (kernel ms, SDPA ms)."""
    import torch.nn.functional as F

    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import kernels

    for B, N, M, h, d, bwd in rows:
        rq = K10.chunked_branch(B, N, M, h)
        where = (f" q [{B},{N},{h},{d}] kv [{B},{M},{h},{d}]"
                 f"{' (chunked branch: bf16(q·scale))' if rq else ''}")
        q, k, v = randn(B, N, h, d), randn(B, M, h, d), randn(B, M, h, d)
        scale = d ** -0.5
        route = K10.attention_route(d)
        kernels.reset_launch_counts()
        ok_, lse = K10.attention_fwd_cuda(q, k, v, scale, rq)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[route] == 1, f"{where}: not on {route}")
        op = K10.attention_plain(q, k, v, scale, rq)
        # P rounded to bf16 before (plain) or after (kernel) normalising
        err = _close_to(route, ok_, op, 2 ** -7, 1e-2)
        if M == 1:
            check(torch.equal(ok_, v.expand_as(ok_)),
                  f"{where}: the output is not v bit for bit")
            logit = torch.einsum("bnhd,bmhd->bhn", q.float(), k.float()) \
                * scale
            lse_err = _close_to(route + " lse", lse, logit, 1e-5, 1e-5)
            where += f" (out = v exactly; lse - logit {lse_err:.2e})"
        elif check_lse:
            logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
            lse_err = _close_to(route + " lse", lse,
                                torch.logsumexp(logits * scale, dim=-1),
                                1e-5, 1e-5)
            where += f" (lse err {lse_err:.2e})"
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                        10)
        flops = 4 * B * h * N * M * d
        call = lambda: K10.attention_fwd_cuda(q, k, v, scale, rq)
        ms = median_ms(call, 10)
        if times is not None:
            times[(B, N, M, h, d, bwd)] = (ms, lib)
        record_kernel(results, route, err, ms,
                      median_ms(lambda: K10.attention_plain(q, k, v, scale,
                                                            rq), 5),
                      "1 bf16 ulp + 1e-2 of max", nbytes(q, k, v, ok_, lse),
                      flops, "bf16", lib, _graph_where(where, call, graph),
                      exps=B * h * N * M)
        if not bwd:
            continue
        do = randn(B, N, h, d)
        kernels.reset_launch_counts()
        gk = K10.attention_bwd_cuda(q, k, v, ok_, lse, do, scale)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["attention_bwd_wgmma"] == 1,
              f"{where}: backward not on attention_bwd_wgmma")
        qkv = [t.float().requires_grad_() for t in (q, k, v)]
        gp = torch.autograd.grad(K10.attention_plain(*qkv, scale), qkv,
                                 do.float())
        # P and dS pass through bf16 between the kernel's products
        err = max(_close_to("attention_bwd_wgmma", a, b, 2 ** -7, 3e-2)
                  for a, b in zip(gk, gp))

        def plain_bwd():
            qkv = [t.float().requires_grad_() for t in (q, k, v)]
            torch.autograd.grad(K10.attention_plain(*qkv, scale), qkv,
                                do.float())

        # the library's backward alone: SDPA's graph is built once
        qkvt = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        ot, dot = F.scaled_dot_product_attention(*qkvt), do.transpose(1, 2)
        lib = median_ms(lambda: torch.autograd.grad(ot, qkvt, dot,
                                                    retain_graph=True), 10)
        call = lambda: K10.attention_bwd_cuda(q, k, v, ok_, lse, do, scale)
        record_kernel(results, "attention_bwd_wgmma", err,
                      median_ms(call, 10), median_ms(plain_bwd, 3),
                      "1 bf16 ulp + 3e-2 of max",
                      nbytes(q, k, v, ok_, lse, do, *gk),
                      10 * B * h * N * M * d, "bf16", lib,
                      _graph_where(where, call, graph), exps=B * h * N * M)


def groupnorm_rows(torch, results, rows, randn, graph=False, times=None):
    """K11 (+ SiLU) forward and, for the rows with a backward (the VAE's),
    backward on the route ``group_norm_route`` gives, against the plain
    versions and ``F.group_norm`` (+ ``F.silu``); `times`: a dict given
    each row's forward (kernel ms, library ms)."""
    import torch.nn.functional as F

    from dreamfusion_tpu_torch.ops import groupnorm as K11
    from dreamfusion_tpu_torch.ops import kernels

    bf = torch.bfloat16
    sms = kernels.sm_count(torch.device("cuda"))
    for B, H, W, C, eps, silu, per_step, bwd in rows:
        G = K11.groups_for(C)
        x = randn(B, H, W, C, scale=3.0)
        wt, bs = randn(C), randn(C)          # the towers' bf16 weights
        fwd = K11.group_norm_route((B, H, W, C), bf, False, G, sms)
        where = (f" [{B},{H},{W},{C}] Cg {C // G}, slab {fwd.slab}, cluster "
                 f"{fwd.cluster}{' + SiLU' if silu else ''}, {per_step}x a "
                 f"step")
        kernels.reset_launch_counts()
        yk, stats = K11.group_norm_fwd_cuda(x, wt, bs, G, eps, silu)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[fwd.name] == 1, f"{where}: not on {fwd.name}")
        yp = K11.group_norm_plain(x, wt, bs, G, eps, silu)
        err = _close_to(fwd.name, yk, yp, 2 ** -7, 1e-3)
        xc = x.permute(0, 3, 1, 2)

        def lib_fwd():
            y = F.group_norm(xc, G, wt, bs, eps)
            return F.silu(y) if silu else y

        call = lambda: K11.group_norm_fwd_cuda(x, wt, bs, G, eps, silu)
        ms, lib = median_ms(call, 10), median_ms(lib_fwd, 10)
        if times is not None:
            times[(B, H, W, C, eps, silu, per_step, bwd)] = (ms, lib)
        record_kernel(results, fwd.name, err, ms,
                      median_ms(lambda: K11.group_norm_plain(
                          x, wt, bs, G, eps, silu), 5),
                      "1 bf16 ulp + 1e-3 of max", nbytes(x, wt, bs, yk),
                      10 * x.numel(), "fp32", lib,
                      _graph_where(where, call, graph))
        if not bwd:
            continue
        route = K11.group_norm_route((B, H, W, C), bf, True, G, sms)
        dy = randn(B, H, W, C)
        kernels.reset_launch_counts()
        dk = K11.group_norm_bwd_cuda(x, wt, bs, stats, dy, G, silu)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[route.name] == 1,
              f"{where} backward: not on {route.name}")
        x32 = x.float().requires_grad_()
        (dp,) = torch.autograd.grad(K11.group_norm_plain(
            x32, wt, bs, G, eps, silu), x32, dy.float())
        err = _close_to(route.name, dk, dp, 2 ** -7, 2e-2)

        def plain_gn_bwd():
            x32 = x.float().requires_grad_()
            torch.autograd.grad(K11.group_norm_plain(x32, wt, bs, G, eps,
                                                     silu), x32, dy.float())

        # the library's backward alone: the graph is built once
        xl = xc.detach().requires_grad_()
        yl = F.group_norm(xl, G, wt, bs, eps)
        yl = F.silu(yl) if silu else yl
        dyc = dy.permute(0, 3, 1, 2)
        lib = median_ms(lambda: torch.autograd.grad(yl, xl, dyc,
                                                    retain_graph=True), 10)
        call = lambda: K11.group_norm_bwd_cuda(x, wt, bs, stats, dy, G, silu)
        record_kernel(results, route.name, err, median_ms(call, 10),
                      median_ms(plain_gn_bwd, 3), "1 bf16 ulp + 2e-2 of max",
                      nbytes(x, dy, wt, bs, dk), 20 * x.numel(), "fp32", lib,
                      _graph_where(where.replace(
                          f", slab {fwd.slab}, cluster {fwd.cluster}",
                          f", slab {route.slab}, cluster {route.cluster}")
                          + " backward", call, graph))


def sd_kernel_phases(torch, results):
    """K10-K12 against their plain versions at the SD 2.1 towers' shapes
    (bf16 unless stated): the UNet at CFG batch 2 on 64² latents, the VAE
    encoder at 512², forward and backward where the path has one."""
    randn = _randn_on(torch, torch.Generator(device="cuda").manual_seed(2))
    conv_rows(torch, results, SD_CONVS + MMA_CONVS, randn)
    attention_rows(torch, results, SD_ATTNS, randn)
    groupnorm_rows(torch, results, SD_GROUPNORMS, randn)


def sd_groupnorm_launches(torch, K11, sms, n_steps, n_vae):
    """K11's launches per route in an SD run of `n_steps` steps, `n_vae` of
    them through the VAE (``SD_GROUPNORMS``: the UNet's rows every step,
    the VAE's forward and backward each VAE step)."""
    want = {}
    for B, H, W, C, eps, silu, per_step, bwd in SD_GROUPNORMS:
        G = K11.groups_for(C)
        for back in ((False, True) if bwd else (False,)):
            name = K11.group_norm_route((B, H, W, C), torch.bfloat16, back,
                                        G, sms).name
            want[name] = want.get(name, 0) + per_step * (
                n_vae if bwd else n_steps)
    return want


def _geometry_tet128(torch, dev, g):
    """The DMTet stage's grid at tet_grid_size 128 with a two-sphere sdf
    (the oracle scene's shape) and a small deformation."""
    from dreamfusion_tpu_torch.mesh.tets import CACHE_DIR, load_cached_tet_grid
    grid = load_cached_tet_grid(CACHE_DIR / "cube_64.npz", 64)
    t = lambda a: torch.from_numpy(a).to(dev)
    v = t(grid.vertices)
    d1 = 0.36 - torch.linalg.norm(v - torch.tensor([0.26, 0, 0.08],
                                                   device=dev), dim=-1)
    d2 = 0.24 - torch.linalg.norm(v - torch.tensor([-0.3, 0, -0.14],
                                                   device=dev), dim=-1)
    sdf = torch.clamp(4 * torch.maximum(d1, d2), -1, 1)
    sdf = torch.where(sdf.abs() < 1e-4, 1e-3, sdf)
    pos = v + torch.randn(v.shape, device=dev, generator=g) * 2e-3
    return grid, pos.contiguous(), sdf.contiguous(), t(grid.indices), \
        t(grid.tet_edges), t(grid.unique_edges)


def _raster_ops(listed, bmin, bmax, valid, H, W, tile, soft):
    """Operations of the function for this run's data, whatever the
    implementation: each triangle set up once (~40 fp32) and binned once
    into the tiles its padded box touches (~4 per (triangle, tile)), then
    ~20 fp32 per (pixel, listed triangle)."""
    import torch
    pad = soft + 1.0
    ntx, nty = -(-W // tile), -(-H // tile)
    x0 = torch.floor((bmin[:, 0] - pad) / tile).clamp(min=0)
    x1 = torch.floor((bmax[:, 0] + pad) / tile).clamp(max=ntx - 1)
    y0 = torch.floor((bmin[:, 1] - pad) / tile).clamp(min=0)
    y1 = torch.floor((bmax[:, 1] + pad) / tile).clamp(max=nty - 1)
    touched = ((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)
               * valid).sum()
    return (float(listed.sum()) * tile * tile * 20 + float(touched) * 4
            + valid.shape[0] * 40)


def explain_raster_bwd(torch, ok, op, sx, sy, sz, faces, gk, gp, bad):
    """Log where K7's backward (``gk``, the kernel's; ``gp``, the plain
    version's) lies outside the tolerance (``bad`` [V, 3]): for up to six
    such vertices, the triangles on it that win a pixel or its margin, how
    far (relative) an FMA of one product would move their den, how many of
    their pixels' winners differ between the two sides, and how many of
    their margin pixels tie in the margin's min."""
    import numpy as np
    from dreamfusion_tpu_torch.ops.raster import _edge_form
    f = faces.long()
    x, y = (t.detach().cpu().numpy()[f.cpu().numpy()] for t in (sx, sy))
    e0x, e0y = x[:, 1] - x[:, 0], y[:, 1] - y[:, 0]
    e1x, e1y = x[:, 2] - x[:, 0], y[:, 2] - y[:, 0]
    den = (e0x * e1y) - (e0y * e1x)                  # float32, as the plain
    fma = (e0x.astype(np.float64) * e1y - e0y * e1x).astype(np.float32)
    gap = np.abs(fma - den) / np.maximum(np.abs(den), 1e-30)
    b = ok.bins                 # the kernel's margin winners, from its slots
    H, W = ok.tri_id.shape
    ms = (b.slots >> 16) & 0xFFFF
    yy, xx = torch.meshgrid(torch.arange(H, device=ms.device),
                            torch.arange(W, device=ms.device), indexing="ij")
    tile = (yy // b.tile) * -(-W // b.tile) + xx // b.tile
    marg = torch.where(ms == 0xFFFF, -1, b.lists[tile, ms.long().clamp(
        max=b.lists.shape[1] - 1)])
    differ = ok.tri_id != op.tri_id
    for v in torch.nonzero(bad.any(1))[:6, 0].tolist():
        tris = torch.nonzero((f == v).any(1))[:, 0]
        won, mwon = torch.isin(ok.tri_id, tris), torch.isin(marg, tris)
        ties = 0
        if bool(mwon.any()):
            py, px = torch.nonzero(mwon, as_tuple=True)
            bu, bv, _ = _edge_form(sx, sy, sz, f, marg[py, px].long(),
                                   px.float() + 0.5, py.float() + 0.5)
            bw = 1.0 - bu - bv
            lo = torch.minimum(torch.minimum(bu, bv), bw)
            ties = int(((bu == lo).int() + (bv == lo).int()
                        + (bw == lo).int() > 1).sum())
        t = tris.cpu().numpy()
        log(f"raster_bwd: vertex {v} kernel {[float(g[v]) for g in gk]} "
            f"plain {[float(g[v]) for g in gp]}; its triangles {t.tolist()}, "
            f"den {den[t].tolist()}, an FMA's gap {gap[t].tolist()}; "
            f"{int(won.sum())} pixels won ({int((won & differ).sum())} "
            f"winners differ), {int(mwon.sum())} margin pixels, {ties} "
            f"ties in the margin's min")


def record_raster(torch, results, sx, sy, sz, faces, valid, H, W, cap, soft,
                  where, backward, main=False):
    """K7 rasterize (and interpolate of the positions) against the plain
    version; forward, and backward when asked; ``main``: the rows of the
    JSON line (``record_kernel``)."""
    from dreamfusion_tpu_torch.ops import raster as K7
    dev = sx.device
    g = torch.Generator(device=dev).manual_seed(3)
    ins_k = [x.clone().requires_grad_(backward) for x in (sx, sy, sz)]
    ins_p = [x.clone().requires_grad_(backward) for x in (sx, sy, sz)]
    ok = K7.raster_cuda(*ins_k, faces, valid, H, W, 32, cap, soft)
    torch.cuda.synchronize()
    op = K7.raster_plain(*ins_p, faces, valid, H, W, 32, cap, soft)
    same = ok.tri_id == op.tri_id
    frac = float(same.float().mean())
    check(frac >= 0.9999, f"raster_fwd{where}: tri_id differs on "
          f"{int((~same).sum())} of {same.numel()} pixels")
    hit = same & (op.tri_id >= 0)
    check(float(hit.float().mean()) > 0.01, f"raster_fwd{where}: no hit")
    err = assert_close("raster_fwd", [ok.bary[hit], ok.depth[same],
                                      ok.alpha[same]],
                       [op.bary[hit], op.depth[same], op.alpha[same]],
                       1e-5, 1e-5)
    T = faces.shape[0]
    with torch.no_grad():
        _, _, _, _, bmin, bmax = K7._face_coeffs(sx, sy, sz, faces.long())
        ids, listed = K7.tile_lists(bmin, bmax, valid, H, W, 32, cap, soft)
    # the kernel's lists: the first cap triangles by index of every tile
    b = ok.bins
    cap = b.lists.shape[1]
    n = b.counts.clamp(max=cap)
    check(bool(torch.equal(n, listed.sum(1).to(n.dtype))),
          f"raster_fwd{where}: tile counts differ from tile_lists")
    keep = torch.arange(cap, device=dev)[None] < n[:, None]
    check(bool(torch.equal(b.lists[keep], ids[:, :cap][keep].to(
        torch.int32))), f"raster_fwd{where}: tile lists differ from "
        "tile_lists")
    check(bool(torch.equal(ok.tile_counts, op.tile_counts)),
          f"raster_fwd{where}: the per-tile counts differ from the plain "
          f"version's")
    fullest = int(ok.tile_counts.max())
    log(f"raster_fwd{where}: fullest tile {fullest} triangles (cap {cap}; "
        f"the backwards sum its list in {-(-min(fullest, cap) // 1024)} "
        f"windows of 1024)")
    det = [x.detach() for x in (sx, sy, sz)]
    outs = nbytes(*ok[:4], b.slots)       # + the winners' slots
    record_kernel(results, "raster_fwd", err, median_ms(
        lambda: K7.raster_cuda(*det, faces, valid, H, W, 32, cap, soft)),
        median_ms(lambda: K7.raster_plain(*det, faces, valid, H, W, 32, cap,
                                          soft), 5, 1),
        "tri_id on >= 99.99% of pixels; bary, depth, alpha 1e-5; lists "
        "equal", nbytes(sx, sy, sz, faces, valid) + outs,
        _raster_ops(listed, bmin, bmax, valid, H, W, 32, soft), "fp32",
        None, f" [{H}x{W}, {T} faces, cap {cap}, soft {soft}]", main=main)
    log(f"raster{where}: {float((op.tri_id >= 0).float().mean()):.3f} of "
        f"pixels covered, {float(listed.sum(1).float().mean()):.1f} "
        f"triangles listed per tile (max {int(listed.sum(1).max())}; "
        f"{int((b.counts > cap).sum())} tiles over the cap)")

    # interpolate the surface positions through the kernel's bary
    V = sx.shape[0]
    attrs = torch.randn(V, 3, device=dev, generator=g)
    bk = ok.bary.detach().contiguous()
    ik = K7.interpolate(attrs, ok._replace(bary=bk), faces)
    torch.cuda.synchronize()
    ip = K7.interpolate_plain(attrs, bk, ok.tri_id, faces)
    err = assert_close("interpolate_fwd", [ik], [ip], 1e-6, 1e-5)
    Pn = H * W
    record_kernel(results, "interpolate_fwd", err, median_ms(
        lambda: K7.interpolate(attrs, ok._replace(bary=bk), faces)),
        median_ms(lambda: K7.interpolate_plain(attrs, bk, ok.tri_id, faces)),
        "1e-5 rel", nbytes(attrs, bk, ok.tri_id, faces, ik), Pn * 3 * 6,
        "fp32", None, where, main=main)
    if not backward:
        return
    cots = [torch.randn(o.shape, device=dev, generator=g)
            for o in (ok.bary, ok.depth, ok.alpha)]

    def loss(o):
        return sum((x * c).sum() for x, c in zip((o.bary, o.depth, o.alpha),
                                                  cots))
    gk = torch.autograd.grad(loss(ok), ins_k, retain_graph=True)
    torch.cuda.synchronize()
    gp = torch.autograd.grad(loss(op), ins_p, retain_graph=True)
    scale = max(float(x.abs().max()) for x in gp)
    # fp32 atomics in any order; pixels whose winner differs are excluded
    # above only for the forward, so hold the sums to 1e-4 of the largest
    bad = torch.stack([(a - b).abs() > 1e-4 * scale + 1e-4 * b.abs()
                       for a, b in zip(gk, gp)], -1)
    if bool(bad.any()):
        explain_raster_bwd(torch, ok, op, sx, sy, sz, faces, gk, gp, bad)
    err = assert_close(f"raster_bwd ({int((~same).sum())} pixels' winners "
                       f"differ)", gk, gp, 1e-4 * scale, 1e-4)
    saved = [ok.tri_id, ok.alpha]
    hits = float((ok.tri_id >= 0).sum())
    record_kernel(results, "raster_bwd", err, median_ms(
        lambda: torch.autograd.grad(loss(ok), ins_k, retain_graph=True)),
        median_ms(lambda: torch.autograd.grad(loss(op), ins_p,
                                              retain_graph=True), 5, 1),
        "1e-4 of max |grad| + 1e-4 rel (atomics)",
        nbytes(sx, sy, sz, faces, *saved, ok.tri_id, *cots, *gk),
        hits * 100 + Pn * 120, "fp32", None, where, main=main)
    a1 = attrs.clone().requires_grad_()
    b1 = bk.clone().requires_grad_()
    a2 = attrs.clone().requires_grad_()
    b2 = bk.clone().requires_grad_()
    yk = K7.interpolate(a1, ok._replace(bary=b1), faces)
    yp = K7.interpolate_plain(a2, b2, ok.tri_id, faces)
    c = torch.randn(yk.shape, device=dev, generator=g)
    gk = torch.autograd.grad(yk, [a1, b1], c, retain_graph=True)
    torch.cuda.synchronize()
    gp = torch.autograd.grad(yp, [a2, b2], c, retain_graph=True)
    scale = max(float(x.abs().max()) for x in gp)
    err = assert_close("interpolate_bwd", gk, gp, 1e-5 * scale, 1e-5)
    record_kernel(results, "interpolate_bwd", err, median_ms(
        lambda: torch.autograd.grad(yk, [a1, b1], c, retain_graph=True)),
        median_ms(lambda: torch.autograd.grad(yp, [a2, b2], c,
                                              retain_graph=True)),
        "1e-5 of max + 1e-5 rel (atomics)",
        nbytes(attrs, bk, ok.tri_id, faces, c, *gk), Pn * 3 * 8, "fp32",
        None, where, main=main)


def dmtet_kernel_phases(torch, results):
    """K8 and K7 against their plain versions at the DMTet stage's shapes:
    tet_grid_size 128, max_tris 131,072, a 512² view of the surface; then
    K1 and K6 at that view's albedo query (``field_query_phase``)."""
    from dreamfusion_tpu_torch.config import Config, apply_dmtet, finalize
    from dreamfusion_tpu_torch.ops import marching_tets as K8
    from dreamfusion_tpu_torch.ops.raster import project_verts, screen_coords
    from dreamfusion_tpu_torch.training.data import circle_view_batch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    grid, pos, sdf, tets, te, ue = _geometry_tet128(torch, dev, g)
    max_tris = 8 * 128 ** 2
    V, F, E = pos.shape[0], tets.shape[0], ue.shape[0]
    where = f" [V {V}, F {F}, E {E}, max_tris {max_tris}]"

    # ---- marching tets --------------------------------------------------
    t0 = time.time()
    topo = K8.tet_topology(tets, te, V, E)
    torch.cuda.synchronize()
    log(f"tet topology (once per grid){where}: {time.time() - t0:.3f} s")
    p1, s1 = pos.clone().requires_grad_(), sdf.clone().requires_grad_()
    p2, s2 = pos.clone().requires_grad_(), sdf.clone().requires_grad_()
    mk = K8.marching_tets(p1, s1, tets, te, ue, max_tris, topo)
    torch.cuda.synchronize()
    mp = K8.marching_tets_plain(p2, s2, tets, te, ue, max_tris)
    check(bool(torch.equal(mk.faces, mp.faces)) and
          bool(torch.equal(mk.face_mask, mp.face_mask)),
          "marching_tets_fwd: faces or mask differ from the plain version")
    ts, fi = K8.mesh_slots_plain(sdf, tets, max_tris)
    has = (ts.reshape(-1, 2) >= 0).any(1).repeat_interleave(2)
    check(bool(torch.equal(mk.slots.tri_slot[has], ts[has])) and
          bool(torch.equal(mk.slots.face_info, fi)),
          "marching_tets_fwd: tri_slot or face_info differ from the plain "
          "version")
    n_faces = int(mk.face_mask.sum())
    check(0 < n_faces < max_tris, f"marching_tets_fwd: {n_faces} faces")
    check(int(mk.n_faces) == int(mp.n_faces) == n_faces,
          f"marching_tets_fwd: true face count {int(mk.n_faces)}, the plain "
          f"version's {int(mp.n_faces)}, {n_faces} kept")
    err = assert_close("marching_tets_fwd", [mk.verts], [mp.verts], 1e-6, 0)
    mt_bytes = nbytes(pos, sdf, tets, te, ue, mk.verts, mk.vert_valid,
                      mk.faces, mk.face_mask)
    record_kernel(results, "marching_tets_fwd", err, median_ms(
        lambda: K8.marching_tets(pos, sdf, tets, te, ue, max_tris, topo)),
        median_ms(lambda: K8.marching_tets_plain(pos, sdf, tets, te, ue,
                                                 max_tris), 5),
        "faces, mask and slots equal, verts 1e-6", mt_bytes, E * 12 + F * 12,
        "fp32", None, f"{where}, {n_faces} faces")
    c = torch.randn(mk.verts.shape, device=dev, generator=g)
    gk = torch.autograd.grad(mk.verts, [p1, s1], c, retain_graph=True)
    torch.cuda.synchronize()
    gp = torch.autograd.grad(mp.verts, [p2, s2], c, retain_graph=True)
    scale = max(float(x.abs().max()) for x in gp)
    err = assert_close("marching_tets_bwd", gk, gp, 1e-5 * scale, 1e-5)
    record_kernel(results, "marching_tets_bwd", err, median_ms(
        lambda: torch.autograd.grad(mk.verts, [p1, s1], c,
                                    retain_graph=True)),
        median_ms(lambda: torch.autograd.grad(mp.verts, [p2, s2], c,
                                              retain_graph=True), 5),
        "1e-5 of max + 1e-5 rel (atomics)", nbytes(pos, sdf, ue, c, *gk),
        E * 20, "fp32", None, where)

    # ---- the three regularizers on that surface ---------------------------
    mesh = mk._replace(verts=mk.verts.detach())
    # normal consistency's pairs: the kernel's (from the static topology)
    # against the plain version's sort of the edge keys
    _, partner = K8.normal_consistency_cuda(mesh)
    sl = torch.arange(max_tris, device=dev)[:, None].expand_as(partner)
    live = partner >= 0
    a, b = sl[live], partner[live].long()
    got = torch.unique(torch.stack([torch.minimum(a, b), torch.maximum(a, b)],
                                   -1), dim=0)
    want = K8.nc_pairs_plain(mesh.faces, mesh.face_mask, E)
    check(bool(torch.equal(got, want)), f"normal_consistency_fwd: "
          f"{got.shape[0]} pairs, the plain version {want.shape[0]}")
    log(f"normal consistency{where}: {got.shape[0]} pairs, the plain "
        f"version's set")
    T = max_tris
    cn = torch.randn(mesh.verts.shape, device=dev, generator=g)
    regs = {
        "vertex_normals": (lambda m: K8.vertex_normals(m),
                           lambda m: K8.vertex_normals_plain(
                               m.verts, m.faces, m.face_mask),
                           T * 30 + E * 10, T * 40 + E * 15),
        "laplacian": (K8.laplacian_smooth_loss,
                      lambda m: K8.laplacian_plain(m.verts, m.faces,
                                                   m.face_mask),
                      T * 30 + E * 12, T * 20 + E * 15),
        "normal_consistency": (K8.normal_consistency_loss,
                               lambda m: K8.normal_consistency_plain(
                                   m.verts, m.faces, m.face_mask),
                               T * 60, T * 70),
    }
    for name, (kern, plain, fops, bops) in regs.items():
        v1 = mesh.verts.clone().requires_grad_()
        v2 = mesh.verts.clone().requires_grad_()
        yk = kern(mesh._replace(verts=v1))
        torch.cuda.synchronize()
        yp = plain(mesh._replace(verts=v2))
        out_bytes = nbytes(yk)
        err = assert_close(f"{name}_fwd", [yk], [yp],
                           1e-5 * float(yp.abs().max()), 1e-5)
        record_kernel(results, f"{name}_fwd", err, median_ms(
            lambda: kern(mesh)), median_ms(lambda: plain(mesh), 5),
            "1e-5 rel", nbytes(mesh.verts, mesh.faces, mesh.face_mask) +
            out_bytes, fops, "fp32", None, f"{where}, {n_faces} faces")
        cot = cn if name == "vertex_normals" else torch.ones((), device=dev)
        gk = torch.autograd.grad(yk, v1, cot, retain_graph=True)
        torch.cuda.synchronize()
        gp = torch.autograd.grad(yp, v2, cot, retain_graph=True)
        scale = float(gp[0].abs().max())
        check(scale > 0, f"{name}_bwd: zero gradient")
        err = assert_close(f"{name}_bwd", gk, gp, 1e-4 * scale, 1e-4)
        record_kernel(results, f"{name}_bwd", err, median_ms(
            lambda: torch.autograd.grad(yk, v1, cot, retain_graph=True)),
            median_ms(lambda: torch.autograd.grad(yp, v2, cot,
                                                  retain_graph=True), 5),
            "1e-4 of max + 1e-4 rel (atomics)",
            nbytes(mesh.verts, mesh.faces, mesh.face_mask, *gk) +
            (nbytes(cn) if name == "vertex_normals" else 0), bops, "fp32",
            None, where)

    # ---- K7 at the DMTet view: 512², cap 512, soft edge 1 ------------------
    cfg = finalize(apply_dmtet(Config(guidance=("oracle",),
                                      backbone="triplane")))
    b = circle_view_batch(cfg, 1, 4, cfg.h, cfg.w, dev)
    clip = project_verts(mesh.verts, b.mvp[0])
    sx, sy, sz, valid = screen_coords(clip, mesh.faces, mesh.face_mask,
                                      cfg.h, cfg.w)
    record_raster(torch, results, sx.contiguous(), sy.contiguous(),
                  sz.contiguous(), mesh.faces, valid, cfg.h, cfg.w, 512, 1.0,
                  " (DMTet view)", True)
    field_query_phase(torch, results, *dmtet_query(torch, mesh, b.mvp[0],
                                                   cfg.h, cfg.w, cfg.bound))


def dmtet_query(torch, mesh, mvp, H, W, bound):
    """The DMTet albedo query of one view: K7's raster of the surface and
    ``interpolate`` of its vertices, as ``DMTetRenderer.render`` queries
    the field → (positions in the encoder's [0, 1] coordinates [H·W, 3],
    the covered pixels [H·W]); a missed pixel's position is 0, x01 = 0.5."""
    from dreamfusion_tpu_torch.ops.raster import (interpolate, project_verts,
                                                  rasterize)
    with torch.no_grad():
        out = rasterize(project_verts(mesh.verts, mvp), mesh.faces,
                        mesh.face_mask, H, W)
        xyz = interpolate(mesh.verts, out, mesh.faces).reshape(-1, 3)
    x01 = ((xyz + bound) / (2 * bound)).contiguous()
    return x01, (out.tri_id >= 0).reshape(-1)


def field_query_phase(torch, results, x01, covered):
    """K1 and K6 at the DMTet albedo query's shape with the step's own
    inputs: the positions of a 512² view (``dmtet_query``; its missed
    pixels all at x01 = 0.5), cotangents random where a triangle covers the
    pixel and 0 elsewhere (alpha is 0 there), bf16 as in the fp16 step.
    Each encoder's forward (bf16, no jacobian), its table-only backward and
    its backward with the position gradient, against the plain versions, at
    the flagship's 3x256²x16 planes and L4C8 table."""
    from dreamfusion_tpu_torch.config import Config
    from dreamfusion_tpu_torch.ops import hashgrid as K6
    from dreamfusion_tpu_torch.training.trainer import grid_spec_of
    dev = x01.device
    g = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    N = x01.shape[0]
    keep = covered[:, None].to(torch.float32)
    cfg = Config()
    R, C = cfg.triplane_resolution, cfg.triplane_channels
    planes = torch.randn(3, R, R, C, device=dev, generator=g) * 0.1
    gq = (torch.randn(N, 3 * C, device=dev, generator=g) * keep).to(bf)
    where = (f" [{N} DMTet queries, {float(covered.float().mean()):.3f} "
             f"covered]")
    triplane_rows(torch, results, x01, planes, [gq], False, where)

    spec = grid_spec_of(cfg)
    L, Cg = spec.num_levels, spec.level_dim
    table = (torch.rand(spec.table_size, Cg, device=dev, generator=g)
             - 0.5) * 0.2
    ids = [K6._corners(x01, spec, l)[0].reshape(-1) for l in range(L)]
    rows = int(torch.unique(torch.cat(ids)).numel()) * Cg * 4
    where += f" [L{L}C{Cg}, {spec.table_size} rows]"
    ok = K6.hash_fwd_cuda(x01, table, spec, L, False, bf)
    torch.cuda.synchronize()
    op = K6.hash_fwd_plain(x01, table, spec, L, False)[0].to(bf)
    err = assert_close("hashgrid_fwd", ok, [op], 1e-6, 2 ** -7)
    record_kernel(results, "hashgrid_fwd", err, median_ms(
        lambda: K6.hash_fwd_cuda(x01, table, spec, L, False, bf)),
        median_ms(lambda: K6.hash_fwd_plain(x01, table, spec, L, False), 5),
        "1 bf16 ulp", nbytes(x01, *ok) + rows, N * L * (8 * Cg * 2 + 120),
        "fp32", None, where)
    gh = (torch.randn(N, L * Cg, device=dev, generator=g) * keep).to(bf)
    none = (None,) * 3
    dk = K6.hash_bwd_cuda(x01, spec, L, gh, none)
    torch.cuda.synchronize()
    dp = K6.hash_bwd_plain(x01, spec, L, gh, none)
    err = assert_close("hashgrid_bwd", [dk], [dp],
                       1e-5 * float(dp.abs().max()), 1e-5)
    record_kernel(results, "hashgrid_bwd", err, median_ms(
        lambda: K6.hash_bwd_cuda(x01, spec, L, gh, none)),
        median_ms(lambda: K6.hash_bwd_plain(x01, spec, L, gh, none), 5),
        "1e-5 of max |dtable| (fp32 reductions in any order)",
        nbytes(x01, gh, dk), N * L * 8 * Cg * 2, "fp32", None, where)
    tk, xk = K6.hash_bwd_dx_cuda(x01, table, spec, L, gh)
    torch.cuda.synchronize()
    tp, xp = K6.hash_bwd_dx_plain(x01, table, spec, L, gh)
    err = max(assert_close("hashgrid_bwd_dx", [tk], [tp],
                           1e-5 * float(tp.abs().max()), 1e-5),
              assert_close("hashgrid_bwd_dx", [xk], [xp],
                           1e-5 * float(xp.abs().max()), 1e-5))
    record_kernel(results, "hashgrid_bwd_dx", err, median_ms(
        lambda: K6.hash_bwd_dx_cuda(x01, table, spec, L, gh)),
        median_ms(lambda: K6.hash_bwd_dx_plain(x01, table, spec, L, gh), 5),
        "1e-5 of max |dtable|, of max |dx| (fp32 reductions in any order)",
        nbytes(x01, gh, tk, xk) + rows, N * L * 8 * Cg * 4, "fp32", None,
        where)
    # the same positions with cotangents on the jacobian too (slice 13)
    hess = []
    encoder_hessian_rows(torch, results, x01, covered,
                         f" [{N} DMTet queries, "
                         f"{float(covered.float().mean()):.3f} covered]", hess)
    log(f"encoder second-derivative rows {json.dumps(hess)}")


def bake_kernel_phase(torch, results, obj_path):
    """K7 forward at the texture bake's shape: the UV atlas of the mesh the
    oracle run exported, 1024², soft edge 0, the bake's cap (the kernel's
    most)."""
    from dreamfusion_tpu_torch.mesh.export import read_obj
    from dreamfusion_tpu_torch.ops.raster import MAX_TILE_CAP, screen_coords
    dev = torch.device("cuda")
    _, tris, uv, _ = read_obj(obj_path)
    u = torch.from_numpy(uv).to(dev)
    clip = torch.stack([u[:, 0] * 2 - 1, -(u[:, 1] * 2 - 1),
                        torch.zeros_like(u[:, 0]),
                        torch.ones_like(u[:, 0])], -1)
    faces = torch.from_numpy(tris).to(dev)
    T = faces.shape[0]
    sx, sy, sz, valid = screen_coords(
        clip, faces, torch.ones(T, dtype=torch.bool, device=dev), 1024, 1024)
    record_raster(torch, results, sx.contiguous(), sy.contiguous(),
                  sz.contiguous(), faces, valid, 1024, 1024, MAX_TILE_CAP,
                  0.0, " (texture bake)", False)


def dmtet_far_views(torch, port_main, init_with, ws, flags=DMTET_FLAGS):
    """The surface the DMTet path starts from (``init_with``, built as main
    builds the run) and the 24 views at the far end of the training ranges
    (unit draws 1 for the radius and the field of view; 3 polar angles x 8
    azimuths) → (cfg, DMTet renderer, mesh, mvp [24, 4, 4], the fullest
    tile's count in each view)."""
    from dreamfusion_tpu_torch.core.poses import PoseDraws
    from dreamfusion_tpu_torch.ops.raster import project_verts, rasterize
    from dreamfusion_tpu_torch.training.trainer import train_batch
    args = port_main.build_parser().parse_args(flags + [
        "--init_with", init_with, "--workspace", ws, "--iters", "1"])
    cfg = port_main.config_from_args(args)
    trainer, state, _ = port_main.build_run(cfg, torch.device("cuda"), False,
                                            log=lambda *a: None)
    dmr = trainer.dmtet_renderer
    with torch.no_grad():
        mesh = dmr.extract_mesh(trainer.geo_params(state.model,
                                                   state.tet_scale))
        verts, dev = mesh.verts.detach(), mesh.verts.device
        th, ph = torch.meshgrid(torch.tensor([0.0, 0.5, 1.0]),
                                torch.arange(8) / 8.0, indexing="ij")
        n = th.numel()
        ones = lambda *sh: torch.ones(*sh, device=dev)
        zeros = lambda *sh: torch.zeros(*sh, device=dev)
        pose = PoseDraws(radius=ones(n), thetas=th.reshape(-1).to(dev),
                         phis=ph.reshape(-1).to(dev),
                         sphere_normal=zeros(n, 3), sphere_u=ones(()),
                         jitter_center=zeros(n, 3),
                         jitter_target=zeros(n, 3), jitter_up=zeros(n, 3))
        mvp = train_batch(cfg, pose, ones(()), 0, cfg.h, cfg.w).mvp
        fullest = [int(rasterize(project_verts(verts, m), mesh.faces,
                                 mesh.face_mask, cfg.h, cfg.w, dmr.tile,
                                 dmr.tile_cap).tile_counts.max())
                   for m in mvp]
    return cfg, dmr, mesh, mvp, fullest


def dmtet_surface_raster_phase(torch, results, port_main, init_with, ws,
                               flags=DMTET_FLAGS, main=True, what="DMTet"):
    """K7 at the DMTet stage's own shape, whose rows the JSON line reports
    (``main``): the surface the DMTet path `flags` starts from, at the
    renderer's tile_cap, in the far view (``dmtet_far_views``) whose
    fullest tile lists the most, so that the backwards sum the crowded
    tiles' lists in several 1024-slot windows; forward and both backwards
    against the plain versions."""
    from dreamfusion_tpu_torch.ops.raster import project_verts, screen_coords
    cfg, dmr, mesh, mvp, fullest = dmtet_far_views(torch, port_main,
                                                   init_with, ws, flags)
    n = len(fullest)
    i = max(range(n), key=fullest.__getitem__)
    log(f"{what} surface: {int(mesh.n_faces)} faces (max_tris "
        f"{dmr.max_tris}), fullest tile over the {n} far views "
        f"{min(fullest)}-{fullest[i]} (view {i}), tile_cap {dmr.tile_cap}")
    sx, sy, sz, valid = screen_coords(project_verts(mesh.verts.detach(),
                                                    mvp[i]),
                                      mesh.faces, mesh.face_mask, cfg.h,
                                      cfg.w)
    record_raster(torch, results, sx.contiguous(), sy.contiguous(),
                  sz.contiguous(), mesh.faces, valid, cfg.h, cfg.w,
                  dmr.tile_cap, dmr.soft_edge_px,
                  f" ({what} surface, far view {i})", True, main=main)


def clip_grad_kernel_phase(torch, results):
    """K5 against its plain version and ``torch.clamp`` at the three shapes
    of the image path: the SDS step's [1,64,64,3], the known view's
    [96,96,3] and the DMTet stage's [1,512,512,3], fp32 and bf16; each
    timed by events and by the host's µs per call (least of 200)."""
    from dreamfusion_tpu_torch.ops import clip_grad as K5
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    limit = 0.05
    for shape in ((1, 64, 64, 3), (96, 96, 3), (1, 512, 512, 3)):
        for dt in (torch.float32, torch.bfloat16):
            cot = (torch.randn(shape, device=dev, generator=g) * 0.1).to(dt)
            yk = K5.clip_grad_bwd_cuda(cot, limit)
            torch.cuda.synchronize()
            yp = K5.clip_grad_plain(cot, limit)
            check(torch.equal(yk, yp), f"clip_grad_bwd {shape} {dt}: "
                  f"differs from the plain clamp")
            share = float((cot.float().abs() > limit).float().mean())
            kernel = lambda: K5.clip_grad_bwd_cuda(cot, limit)
            clamp = lambda: torch.clamp(cot, -limit, limit)
            where = f" [{list(shape)} {str(dt)[6:]}, {share:.3f} clamped]"
            log(f"clip_grad_bwd{where}: host µs per call (least of 200) "
                f"{host_us(kernel)['host_us_min']:.2f}, torch.clamp "
                f"{host_us(clamp)['host_us_min']:.2f}")
            record_kernel(
                results, "clip_grad_bwd", max_err([yk], [yp]),
                median_ms(kernel), median_ms(lambda: K5.clip_grad_plain(
                    cot, limit)), "exact", nbytes(cot, yk), 2 * cot.numel(),
                "fp32", median_ms(clamp), where)


def _uv_sphere(np, radius, n_theta, n_phi):
    """A watertight UV sphere → (verts [V,3] float32, tris [T,3] int32)."""
    th = np.pi * np.arange(1, n_theta) / n_theta
    ph = 2 * np.pi * np.arange(n_phi) / n_phi
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)),
                     np.outer(np.sin(th), np.sin(ph)),
                     np.outer(np.cos(th), np.ones_like(ph))], -1)
    verts = np.concatenate([[[0, 0, 1]], ring.reshape(-1, 3),
                            [[0, 0, -1]]]) * radius
    r = lambda i, j: 1 + i * n_phi + j % n_phi
    tris = [(0, r(0, j), r(0, j + 1)) for j in range(n_phi)]
    for i in range(n_theta - 2):
        for j in range(n_phi):
            tris += [(r(i, j), r(i + 1, j), r(i + 1, j + 1)),
                     (r(i, j), r(i + 1, j + 1), r(i, j + 1))]
    bot = len(verts) - 1
    tris += [(bot, r(n_theta - 2, j + 1), r(n_theta - 2, j))
             for j in range(n_phi)]
    return verts.astype(np.float32), np.asarray(tris, np.int32)


def sdf_kernel_phase(torch, results, obj_path, smi_line):
    """K9 on the DMTet init's real workload: the 274,625 tet-grid-128
    points scaled as the init scales them, against the mesh the image run
    exported (normalised).  The kernel runs the whole set; the plain
    version a 16,384-point subset with chunk 128 (its [chunk, T]
    temporaries).  Distances within 1e-5 + 1e-5·|sd|, the signed values so
    where the plain winding number is clear of 0.5, no NaN; then a UV
    sphere's analytic signed distance away from its surface."""
    import numpy as np
    from dreamfusion_tpu_torch.mesh import sdf as K9
    from dreamfusion_tpu_torch.mesh.tets import (CACHE_DIR,
                                                 load_cached_tet_grid)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    mv, mt = K9.load_mesh(obj_path)
    mv = K9.normalize_mesh(mv)
    scale = float(np.abs(mv).max()) + 0.1
    grid = load_cached_tet_grid(CACHE_DIR / "cube_64.npz", 64)
    pts = torch.from_numpy(grid.vertices).to(dev) * scale
    v, f = torch.from_numpy(mv).to(dev), torch.from_numpy(mt).to(dev)
    P, T = pts.shape[0], f.shape[0]
    sd, wn = K9.signed_distance(pts, v, f, return_winding=True)
    torch.cuda.synchronize()
    idx = torch.randperm(P, device=dev, generator=g)[:16384]
    sub = pts[idx].contiguous()
    t0 = time.time()
    sdp, wnp = K9.signed_distance_plain(sub, v, f, chunk=128,
                                        return_winding=True)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    check(not bool(sd.isnan().any() or wn.isnan().any()),
          "signed_distance: NaN in the kernel's output")
    tol = 1e-5 + 1e-5 * sdp.abs()
    dist_err = (sd[idx].abs() - sdp.abs()).abs()
    check(bool((dist_err <= tol).all()), f"signed_distance: "
          f"{int((dist_err > tol).sum())} distances of 16,384 outside "
          f"1e-5 + 1e-5|sd| (max err {float(dist_err.max()):.3e})")
    clear = (wnp - 0.5).abs() > 1e-4
    sgn_err = (sd[idx] - sdp).abs()[clear]
    check(bool((sgn_err <= tol[clear]).all()),
          f"signed_distance: {int((sgn_err > tol[clear]).sum())} signed "
          f"values differ where the winding number is clear of 0.5")
    inside = float((sd < 0).float().mean())
    err = max(float(dist_err.max()), float(sgn_err.max()))
    # the culling is exact: sd and the winding number bit for bit with the
    # distance part run for every pair; the pairs whose distance part ran,
    # counted on the card
    routes = {}
    for cull in (True, False):
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        out = K9.signed_distance_cuda(pts, v, f, True, cull, count)
        check(torch.equal(out[0], sd) and torch.equal(out[1], wn),
              f"signed_distance: cull {cull}: not the default route's "
              f"result bit for bit")
        routes[cull] = (median_ms(lambda: K9.signed_distance_cuda(
            pts, v, f, False, cull), 5, 1), int(count))
    n_dist = routes[True][1]
    done = P * T * (SDF_WINDING_OPS + SDF_CULL_OPS) + n_dist * SDF_DIST_OPS
    log(f"signed_distance, culled and not (event ms; pairs whose distance "
        f"part ran): " + "; ".join(
            f"cull {cull}: {ms:.3f} ms, {n:,} of {P * T:,}"
            for cull, (ms, n) in routes.items())
        + f"; operations done by the culled kernel {done / 1e9:.1f} G "
        f"({done / (P * T):.1f} a pair: the bound's) against "
        f"{P * T * SDF_OPS_PER_PAIR / 1e9:.1f} G with no culling "
        f"({SDF_OPS_PER_PAIR} a pair); on {smi_line}")
    t_sub = median_ms(lambda: K9.signed_distance(sub, v, f), 5, 1)
    record_kernel(results, "signed_distance", err,
                  median_ms(lambda: K9.signed_distance(pts, v, f), 5, 1),
                  plain_ms, "1e-5 + 1e-5|sd|; signs where |wn - 0.5| > 1e-4",
                  nbytes(pts, sd, v, f), done, "fp32", None,
                  f" [{P} points x {T} triangles; the plain version on "
                  f"16,384 of them]")
    log(f"signed_distance: {inside:.4f} of the points inside; the kernel "
        f"on the 16,384-point subset {t_sub:.3f} ms against the plain "
        f"version's {plain_ms:.1f} ms there")
    # a UV sphere: the analytic signed distance away from the surface
    sv, st = _uv_sphere(np, 0.4, 120, 160)
    sd_s = K9.signed_distance(pts, torch.from_numpy(sv).to(dev),
                              torch.from_numpy(st).to(dev))
    want = torch.linalg.norm(pts, dim=-1) - 0.4
    far = want.abs() > 0.02
    check(bool((sd_s[far].sign() == want[far].sign()).all()),
          "signed_distance: a sign differs from the sphere's away from it")
    sag = float((sd_s - want).abs().max())
    check(sag < 3e-4, f"signed_distance: {sag:.3e} from the sphere's "
          f"distance (more than its facets' sag)")
    log(f"signed_distance on a UV sphere ({len(st)} triangles): signs agree "
        f"away from it, max |sd - (|x| - 0.4)| {sag:.3e}")


def _rounded(d) -> dict:
    return {k: round(v, 3) for k, v in d.items()}


def _check_outputs(ws, summary, what) -> None:
    """Validation PNGs, the turntable (mp4 or PNG frames) and a mesh.obj
    with faces and its albedo PNG."""
    from dreamfusion_tpu_torch.mesh.export import read_obj
    val = os.listdir(os.path.join(ws, "validation"))
    res = os.listdir(os.path.join(ws, "results"))
    check(any(n.endswith("_rgb.png") for n in val),
          f"{what}: no validation PNG in {ws}")
    check("df_rgb.mp4" in res or "df_rgb_0000.png" in res,
          f"{what}: no turntable in {res}")
    path = summary.get("mesh_path") or ""
    check(path.endswith("mesh.obj") and os.path.exists(path),
          f"{what}: no mesh.obj written ({path!r})")
    _, tris, uv, tex = read_obj(path)
    check(len(tris) > 0 and uv is not None and tex is not None and
          os.path.exists(tex), f"{what}: mesh.obj without faces or texture")
    log(f"{what}: {path} with {len(tris)} faces and {os.path.basename(tex)}")


def step_render_launches(cfg) -> dict:
    """K2's, K3's and K4's launches in one stage-1 step of one view (after
    the warm-up): its march region (one launch), its shaded render,
    composited, and their backwards; the 3-D normal smoothness (on under
    ``--image``) shades the perturbed positions once more.  The eval
    renders take the head alone, and a step that refreshes the density
    grid adds the head ``refresh_launches`` times.  The vanilla render
    (-O2) takes K2's coarse and resample launches instead of the march,
    and the head once for its coarse density pass."""
    shade = 1 + int(cfg.lambda_3d_normal_smooth > 0)
    out = {"march_rays": 1, "composite_fwd": 1, "composite_bwd": 1,
           "field_shade_fwd": shade, "field_shade_bwd": shade,
           "field_head_fwd": 0, "field_head_bwd": 0}
    if cfg.backbone == "vanilla":
        out.update(march_rays=0, vanilla_coarse=1, vanilla_resample=1,
                   field_head_fwd=1)
    return out


def refresh_launches(cfg) -> int:
    """K4 head launches of one density-grid refresh: the grid's cells a
    chunk at a time, per cascade (8 at the flagship's 128³); none under
    vanilla, which keeps no density grid."""
    from dreamfusion_tpu_torch.ops.occupancy import _CHUNK
    if cfg.backbone == "vanilla":
        return 0
    return cfg.cascade * -(-cfg.grid_size ** 3 // _CHUNK)


def run_render_launches(launches, cfg, n_steps, what, renders=None) -> None:
    """K2's, K3's and K4's launches over a whole run of `n_steps` steps:
    the shaded renders and the backwards as ``step_render_launches`` says
    each step, the head's backward never, the head at least once a chunk of
    each refresh, the march at least once a step; with `renders` (the run's
    eval and test renders, each one march and one composite with the head
    alone; under vanilla each render chunk's coarse and resample launches
    and the head twice, the coarse pass and the albedo shading) the
    forwards and the marches exactly."""
    n_refresh = -(-n_steps // cfg.update_extra_interval)
    per_step = step_render_launches(cfg)
    vanilla = cfg.backbone == "vanilla"
    march = "vanilla_coarse" if vanilla else "march_rays"
    for name in ("composite_bwd", "field_shade_fwd", "field_shade_bwd"):
        check(launches[name] == per_step[name] * n_steps,
              f"{what}: {name} launched {launches[name]} times in "
              f"{n_steps} steps ({per_step[name]} a step)")
    check(launches["field_head_bwd"] == 0,
          f"{what}: field_head_bwd launched {launches['field_head_bwd']} "
          f"times (never in stage 1)")
    head = n_refresh * refresh_launches(cfg) + \
        per_step["field_head_fwd"] * n_steps
    if vanilla:
        check(launches["march_rays"] == 0 and launches["vanilla_resample"]
              == launches["vanilla_coarse"], f"{what}: march_rays "
              f"{launches['march_rays']}, vanilla coarse and resample "
              f"{launches['vanilla_coarse']}, "
              f"{launches['vanilla_resample']} launches")
    if renders is None:
        check(launches["field_head_fwd"] >= head, f"{what}: field_head_fwd "
              f"launched {launches['field_head_fwd']} times, under {head}")
        check(launches[march] >= n_steps, f"{what}: {march} launched "
              f"{launches[march]} times in {n_steps} steps")
        return
    want = {march: n_steps + renders,
            "composite_fwd": n_steps + renders,
            "field_head_fwd": head + renders * (1 + vanilla)}
    got = {k: launches[k] for k in want}
    check(got == want, f"{what}: K2 and the K3/K4 forwards {got}, not {want}"
          f" ({n_steps} steps, {n_refresh} refreshes, {renders} test "
          f"renders)")


def stage1_step_launches(torch, port_main, kernels, flags, ws, what):
    """Two stage-1 steps of the run `flags` describes (built as main builds
    it), the counters reset just before each: K2, K3 and K4 launch exactly
    ``step_render_launches``, and the first step's refresh adds the head
    ``refresh_launches`` times."""
    args = port_main.build_parser().parse_args(
        flags + ["--workspace", ws, "--iters", "2"])
    cfg = port_main.config_from_args(args)
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False, log=lambda *a: None)
    for _ in range(2):
        want = step_render_launches(cfg)
        if state.step % cfg.update_extra_interval == 0:
            want["field_head_fwd"] += refresh_launches(cfg)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        trainer.run_step(state, gen)
        torch.cuda.synchronize()
        got = {k: kernels.LAUNCHES[k] for k in want}
        check(got == want, f"{what}: step {state.step - 1} launched K2-K4 "
              f"{got}, not {want}")
        log(f"{what}: step {state.step - 1} launched K2-K4 {got}")


def stage1_path(port_main, kernels, flags, ws, what, required, group,
                smi_line, end=STAGE1_END):
    """Stage 1 under the oracle with the run's end, the counters reset just
    before it → (summary, launches)."""
    kernels.reset_launch_counts()
    summary = port_main.main(flags + end + [
        "--iters", str(STEPS), "--workspace", ws])
    launches = dict(kernels.LAUNCHES)
    log(f"{what} path: {STEPS} steps, steady {summary['steady_its']:.3f} "
        f"it/s, PSNR {summary['psnr_init']:.3f} -> "
        f"{summary['psnr_final']:.3f} dB, launches {launches}")
    log(f"{what} run's end (s): {_rounded(summary['phases'])}; export "
        f"phases (s): {_rounded(summary['export_phases'])}; on {smi_line}")
    check(summary["all_losses_finite"],
          f"{what}: non-finite loss: {summary['losses']}")
    check(summary["grad_ok"], f"{what}: a step had non-finite gradients")
    for name in required:
        check(launches[name] > 0, f"the {what} path never launched {name}")
    towers = {k: launches[k] for k in ("conv_fwd_mma", "conv_dgrad")}
    check(towers == {"conv_fwd_mma": 0, "conv_dgrad": 0},
          f"{what}: the oracle launched the patch conv's routes {towers}")
    run_render_launches(launches, port_main.config_from_args(
        port_main.build_parser().parse_args(flags)), STEPS, what)
    check(all(g > 0 for g in summary[f"{group}_grad_max"]),
          f"{what}: a step had a zero {group} gradient")
    gain = summary["psnr_final"] - summary["psnr_init"]
    check(gain >= 3.0, f"{what}: PSNR rose only {gain:.3f} dB (bar: 3 dB)")
    _check_outputs(ws, summary, what)
    ckpts = os.listdir(os.path.join(ws, "checkpoints"))
    check("df_ep0003.pth" in ckpts and "df.pth" in ckpts,
          f"{what}: stage-1 checkpoints missing: {sorted(ckpts)}")
    return summary, launches


def sd_path(torch, port_main, kernels, flags, ws, what, group, smi_line,
            unet_attns=SD21_UNET_ATTNS, steps=SD_STEPS, timed_after=None):
    """SD at full width (`steps` steps: the first 20% SD's warm-up, the rest
    through the VAE), the counters reset just before it → launches.
    `unet_attns`: the UNet's K10 launches per step by route (SD 2.1's or SD
    1.5's head dims); the other UNet routes must not launch.  `group`: the
    field's encoder, "triplane" or "grid", whose kernels must launch, or
    "vanilla", under which no encoder and no march kernel may.  With
    `timed_after` (the -O2 run): two steps built as main builds them, every
    count exact (``sd_step_exact``), then the same run rebuilt, its steps
    timed (synchronised, the median after `timed_after`) with the peak
    memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_sd = time.time()
    sd = port_main.main(flags + ["--iters", str(steps), "--workspace", ws])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    main_blocks = sd["blocks"][2:]        # steps 11 on: all after warm-up
    s_step = sum(t for _, t in main_blocks) / sum(n for n, _ in main_blocks)
    blocks_ms = [round(1e3 * t / n, 2) for n, t in main_blocks]
    log(f"{what} path: {steps} steps in {time.time() - t_sd:.1f} s "
        f"(start-up included), losses {sd['losses']}, steady "
        f"{s_step:.4f} s/step over steps 11-{steps} (VAE phase; "
        f"ms/step by 5-step block {blocks_ms}), peak "
        f"device memory {peak_gib:.2f} GiB, on {smi_line}, launches "
        f"{launches}")
    check(sd["all_losses_finite"], f"{what}: non-finite loss: {sd['losses']}")
    check(sd["grad_ok"], f"{what}: a step had non-finite gradients")
    n_vae = sum(not ph for ph in sd["latent_phase"])
    for name, per_step in SD_DGRADS.items():
        check(launches[name] == per_step * n_vae,
              f"{what}: {launches[name]} launches of {name} in {n_vae} VAE "
              f"steps, not {per_step} a step")
    # K11 by route (SD_GROUPNORMS' counts) and K10's backward (the VAE
    # mid-block's), exactly
    from dreamfusion_tpu_torch.ops import groupnorm as K11
    n_steps = len(sd["latent_phase"])
    want = sd_groupnorm_launches(torch, K11, kernels.sm_count(
        torch.device("cuda")), n_steps, n_vae)
    want["attention_bwd_wgmma"] = n_vae
    want["attention_fwd_wgmma_d512"] = n_vae      # the VAE mid-block
    # no CLIP guidance: no patch conv, either way
    want["conv_fwd_mma"] = want["conv_dgrad"] = 0
    unet_routes = {**SD21_UNET_ATTNS, **SD15_UNET_ATTNS}
    for name in unet_routes:
        want[name] = unet_attns.get(name, 0) * n_steps
    for name, n in want.items():
        check(launches[name] == n,
              f"{what}: {launches[name]} launches of {name} in {n_steps} "
              f"steps ({n_vae} through the VAE), not {n}")
    required = {"grid": ("hashgrid_fwd", "hashgrid_bwd"),
                "triplane": ("triplane_fwd", "triplane_bwd"),
                "vanilla": ("vanilla_coarse", "vanilla_resample")}[group]
    for name in tuple(k for k in SD_KERNELS if k not in unet_routes) + \
            required:
        if group == "vanilla" and name in ENCODER_KERNELS:
            continue
        check(launches[name] > 0, f"the {what} path never launched {name}")
    if group == "vanilla":
        enc = {k: launches[k] for k in ENCODER_KERNELS if launches[k]}
        check(not enc, f"{what}: encoder or march kernels launched {enc}")
    # K2, K3 and K4 exactly: no evals, the test's frames at H x W in
    # max_ray_batch chunks
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        flags))
    check(cfg.backbone == group, f"{what}: backbone {cfg.backbone}")
    renders = cfg.dataset_size_test * -(-cfg.H * cfg.W // cfg.max_ray_batch)
    run_render_launches(launches, cfg, n_steps, what, renders)
    for latent in (True, False):
        gm = [gr for gr, ph in zip(sd[f"{group}_grad_max"],
                                   sd["latent_phase"]) if ph == latent]
        phase = "warm-up" if latent else "VAE"
        check(len(gm) > 0 and all(g > 0 for g in gm),
              f"{what}: zero {group} gradient in the {phase} phase: {gm}")
    if timed_after is not None:
        sd_step_exact(torch, port_main, kernels, flags, ws + "_step", what)
        torch.cuda.reset_peak_memory_stats()
        med, low = if_timed_steps(torch, port_main, flags, steps, timed_after,
                                  ws + "_timing")
        step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"{what} step (synchronised, median over steps {timed_after}-"
            f"{steps - 1}): {1e3 * med:.2f} ms (min {1e3 * low:.2f}), peak "
            f"device memory {step_peak:.2f} GiB; on {smi_line}")
    return launches


def sd_step_exact(torch, port_main, kernels, flags, ws, what):
    """Two SD steps of the run `flags` describes, built as main builds it
    (one in SD's warm-up, one after it, through the VAE), the counters
    reset just before each: K2-K4 as ``step_render_launches`` and K10-K12
    as ``sd_step_launches`` count them, exactly."""
    args = port_main.build_parser().parse_args(
        flags + ["--workspace", ws, "--iters", "5"])
    cfg = port_main.config_from_args(args)
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False, log=lambda *a: None)
    render = step_render_launches(cfg)
    for step in range(2):
        if step == 1:
            state.step = 4                 # past the warm-up's 20%
        latent = trainer.latent_phase(state.step)
        want = {**render, **sd_step_launches(torch, kernels, 1,
                                             0 if latent else 1)}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        trainer.run_step(state, gen)
        torch.cuda.synchronize()
        got = {k: kernels.LAUNCHES[k] for k in want}
        check(got == want, f"{what}: step {state.step - 1} (latent "
              f"{latent}) launched {got}, not {want}")
        log(f"{what}: step {state.step - 1} (latent {latent}) launched K2-K4 "
            f"{({k: got[k] for k in render})} and "
            f"{sum(got.values()) - sum(render.values())} K10-K12 launches, "
            f"exactly")


def sd15_path(torch, port_main, kernels, ws, smi_line, sd21_launches):
    """SD 1.5 at full width through the triplane, the counters reset just
    before it → launches: K10 at d = 40, 80 and 160 exactly
    (``SD15_UNET_ATTNS`` a step), and K11's and K12's routes launched
    exactly as often as in the SD 2.1 run of the same flags (the same
    shapes: only the attention's head dims and the text tower differ)."""
    launches = sd_path(torch, port_main, kernels, SD15_FLAGS, ws, "SD 1.5",
                       "triplane", smi_line, SD15_UNET_ATTNS)
    same = [k for k in launches if k.startswith(("conv_", "groupnorm_"))]
    diff = {k: (launches[k], sd21_launches[k]) for k in same
            if launches[k] != sd21_launches[k]}
    check(not diff, f"SD 1.5: K11/K12 launches differ from SD 2.1's "
          f"(SD 1.5, SD 2.1): {diff}")
    log(f"SD 1.5: K11 and K12 launched exactly as in SD 2.1 "
        f"({sum(launches[k] for k in same)} launches over {len(same)} "
        f"routes)")
    return launches


def dmtet_path(torch, port_main, kernels, flags, steps, ws, what, required,
               group, smi_line):
    """The DMTet stage from a stage-1 checkpoint, the counters reset just
    before it → (summary, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_dm = time.time()
    dm = port_main.main(flags + ["--iters", str(steps), "--workspace", ws])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = dm["blocks"][1:]
    s_step = sum(t for _, t in steady) / sum(n for n, _ in steady)
    psnr = (f", albedo PSNR {dm['psnr_init']:.3f} -> "
            f"{dm['psnr_final']:.3f} dB" if "psnr_init" in dm else "")
    log(f"{what} path: {steps} steps in {time.time() - t_dm:.1f} s "
        f"(start-up and run's end included), losses {dm['losses']}, "
        f"{s_step:.4f} s/step over steps 11-{steps} (ms/step by "
        f"block {[round(1e3 * t / n, 2) for n, t in dm['blocks']]}), peak "
        f"device memory {peak_gib:.2f} GiB, "
        f"{surface_line(dm)}{psnr}, run's end (s) "
        f"{_rounded(dm['phases'])}, export (s) "
        f"{_rounded(dm['export_phases'])}, on {smi_line}, launches "
        f"{launches}")
    check(dm["all_losses_finite"], f"{what}: non-finite loss: {dm['losses']}")
    check(dm["grad_ok"], f"{what}: a step had non-finite gradients")
    for name in required:
        check(launches[name] > 0, f"the {what} path never launched {name}")
    # one view a step (--batch_size 1): its albedo query's backward gives the
    # table's and the positions' gradients in one launch, and nothing takes
    # the table-only route or a second forward for the positions
    # (the vanilla field's positions take theirs through plain torch: no
    # encoder kernel at all)
    if group == "vanilla":
        enc_l = {k: launches[k] for k in ENCODER_KERNELS if launches[k]}
        check(not enc_l, f"{what}: encoder kernels launched {enc_l}")
    else:
        enc = "triplane" if group == "triplane" else "hashgrid"
        check(launches[f"{enc}_bwd_dx"] == steps and
              launches[f"{enc}_bwd"] == 0 and launches[f"{enc}_fwd"] >= steps,
              f"{what}: {enc} launched fwd {launches[f'{enc}_fwd']}, bwd "
              f"{launches[f'{enc}_bwd']}, bwd_dx "
              f"{launches[f'{enc}_bwd_dx']} times in {steps} steps (bwd_dx "
              f"once a step, bwd never)")
    # the backwards run once a step (evals and the export add forwards)
    for name, n in DMTET_STEP_LAUNCHES.items():
        check(launches[name] == n * steps if name.endswith("_bwd")
              else launches[name] >= n * steps,
              f"{what}: {name} launched {launches[name]} times in {steps} "
              f"steps ({n} a step)")
    for gname in ("sdf", "deform", group):
        gm = dm[f"{gname}_grad_max"]
        check(all(g > 0 for g in gm), f"{what}: zero {gname} gradient: {gm}")
    surface_checks(dm, what)
    views = dm["view_tile_max"]
    check(views and not dm["view_tile_cut"], f"{what}: eval/test views "
          f"cut a tile's list: {dm['view_tile_cut']} (of {len(views)})")
    log(f"{what}: {len(views)} eval/test views, fullest tile "
        f"{max(n for _, n in views)} of tile_cap {dm['tile_cap']}")
    _check_outputs(ws, dm, what)
    return dm, launches


def surface_line(dm) -> str:
    """The run's face counts and fullest tiles against their caps."""
    return (f"faces {dm['n_faces_true'][0]} -> {dm['n_faces_true'][-1]} "
            f"(most {max(dm['n_faces_true'])}) of max_tris "
            f"{dm['max_tris_at'][0]} -> {dm['max_tris']}, fullest tile "
            f"{dm['tile_max'][0]} -> {dm['tile_max'][-1]} (most "
            f"{max(dm['tile_max'])}) of tile_cap {dm['tile_cap']}")


def surface_checks(dm, what) -> None:
    """A non-empty surface; at every step its true face count within the
    marching tets' cap and K7's fullest tile within the tile cap (no face
    dropped, no tile's list cut)."""
    check(all(n > 0 for n in dm["n_faces"]),
          f"{what}: an empty surface: {dm['n_faces']}")
    over = [(s, n, c) for s, (n, c) in enumerate(zip(dm["n_faces_true"],
                                                     dm["max_tris_at"]))
            if n > c]
    check(not over and not dm["faces_dropped_steps"], f"{what}: faces "
          f"dropped (step, true count, max_tris): {over[:10]}")
    cut = [(s, n, dm["tile_cap"]) for s, n in enumerate(dm["tile_max"])
           if n > dm["tile_cap"]]
    check(not cut and not dm["tile_cut_steps"], f"{what}: tile lists cut "
          f"(step, fullest tile, tile_cap): {cut[:10]}")


def sd_step_launches(torch, kernels, n_steps, n_vae=None, n_clip=0,
                     n_embed=0) -> dict:
    """K10's, K11's and K12's launches in `n_steps` SD 2.1 SDS steps,
    `n_vae` of them (default: all) through the VAE, with `n_clip` CLIP
    losses (ViT-B/16's patch conv forward and input gradient each) and
    `n_embed` image embeddings without gradient: every route of K10, K11
    and K12's dgrad exactly, and the mma.sync routes exactly (the patch
    conv's: no conv of SD's towers takes them)."""
    from dreamfusion_tpu_torch.ops import groupnorm as K11
    n_vae = n_steps if n_vae is None else n_vae
    want = sd_groupnorm_launches(torch, K11, kernels.sm_count(
        torch.device("cuda")), n_steps, n_vae)
    want.update({k: n * n_vae for k, n in SD_DGRADS.items()})
    want.update({k: n * n_steps for k, n in SD21_UNET_ATTNS.items()})
    want.update(attention_fwd_wgmma_d512=n_vae, attention_bwd_wgmma=n_vae,
                conv_fwd_mma=n_clip + n_embed, conv_dgrad=n_clip)
    return want


def dmtet_view_launches(torch, port_main, kernels, flags, ws, what, enc,
                        sd=False):
    """One DMTet step of the run `flags` describes (built as main builds
    it), the counters reset just before it: its one view's albedo query
    launches the encoder `enc`'s forward once and its backward with the
    position gradient once, and the table-only backward never; K7 and K8
    launch exactly ``DMTET_STEP_LAUNCHES``; with `sd`, K10-K12 exactly as
    one SD VAE step launches them (``sd_step_launches``)."""
    args = port_main.build_parser().parse_args(
        flags + ["--workspace", ws, "--iters", "2"])
    cfg = port_main.config_from_args(args)
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False, log=lambda *a: None)
    trainer.run_step(state, gen)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    trainer.run_step(state, gen)
    torch.cuda.synchronize()
    if enc is None:         # the vanilla field: no encoder kernel
        got = {k: kernels.LAUNCHES[k] for k in ENCODER_KERNELS}
        want = dict.fromkeys(ENCODER_KERNELS, 0)
    else:
        got = {k: kernels.LAUNCHES[f"{enc}_{k}"]
               for k in ("fwd", "bwd", "bwd_dx")}
        want = {"fwd": cfg.batch_size, "bwd": 0, "bwd_dx": cfg.batch_size}
    check(got == want, f"{what}: one step launched {enc} {got}, not {want}")
    k78 = {k: kernels.LAUNCHES[k] for k in DMTET_STEP_LAUNCHES}
    check(cfg.batch_size == 1 and k78 == DMTET_STEP_LAUNCHES,
          f"{what}: one step launched K7/K8 {k78}, not "
          f"{DMTET_STEP_LAUNCHES}")
    # the albedo query: K4's head alone, once each way
    k4 = {k: kernels.LAUNCHES[k] for k in RENDER_KERNELS}
    want4 = {k: int(k.startswith("field_head")) for k in k4}
    check(k4 == want4, f"{what}: one step launched K3/K4 {k4}, not {want4}")
    if sd:
        want_sd = sd_step_launches(torch, kernels, 1)
        got_sd = {k: kernels.LAUNCHES[k] for k in want_sd}
        check(got_sd == want_sd, f"{what}: one step launched K10-K12 "
              f"{got_sd}, not {want_sd}")
        k4 = {**k4, "K10-K12": sum(got_sd.values())}
    log(f"{what}: one step ({cfg.batch_size} view) launched {enc} {got}, "
        f"K7/K8 {k78}, K3/K4 {k4}")


def dmtet_sd_path(torch, port_main, kernels, ws, init_with, smi_line):
    """The DMTet stage under SD 2.1 at full width from a stage-1
    checkpoint, the counters reset just before it: ``dmtet_path``'s checks
    and every K10-K12 route exactly as ``sd_step_launches`` counts."""
    flags = DMTET_SD_FLAGS + ["--init_with", init_with]
    dm, launches = dmtet_path(torch, port_main, kernels, flags,
                              DMTET_SD_STEPS, ws, "DMTet SD",
                              DMTET_KERNELS + SD_TOWER_KERNELS, "triplane",
                              smi_line)
    want = sd_step_launches(torch, kernels, DMTET_SD_STEPS)
    got = {k: launches[k] for k in want}
    check(got == want, f"DMTet SD: K10-K12 launched {got} in "
          f"{DMTET_SD_STEPS} steps, not {want}")
    log(f"DMTet SD: K10-K12 launched exactly as {DMTET_SD_STEPS} SD VAE "
        f"steps ({sum(got.values())} launches over {len(got)} routes); "
        f"init {dm['init_seconds']:.3f} s")
    dmtet_view_launches(torch, port_main, kernels, flags, ws + "_view",
                        "DMTet SD", "triplane", sd=True)


def zero123_kernel_phases(torch, results):
    """K10-K12 against their plain versions at zero123's shapes, each with
    its graph ms (``ZERO123_CONVS``, ``ZERO123_ATTNS``,
    ``zero123_groupnorms(1)``)."""
    randn = _randn_on(torch, torch.Generator(device="cuda").manual_seed(3))
    conv_rows(torch, results, ZERO123_CONVS, randn, graph=True,
              no_bias=(PATCH_CONV,))
    attention_rows(torch, results, ZERO123_ATTNS, randn, graph=True)
    groupnorm_rows(torch, results, zero123_groupnorms(1), randn, graph=True)


def zero123_towers(torch):
    """Zero123's full-width UNet, VAE and vision tower on the meta device
    (shapes only)."""
    from dreamfusion_tpu_torch.guidance.zero123 import Zero123Config
    from dreamfusion_tpu_torch.models.clip import CLIPVisionEncoder
    from dreamfusion_tpu_torch.models.unet import UNet2DCondition
    from dreamfusion_tpu_torch.models.vae import AutoencoderKL
    zc = Zero123Config()
    with torch.device("meta"):
        return (UNet2DCondition(zc.unet_config()),
                AutoencoderKL(zc.vae_config()),
                CLIPVisionEncoder(zc.vision_config()))


def zero123_launches(torch, kernels, K: int, n_sds: int, embed: bool,
                     n_vae=None) -> dict:
    """K10's, K11's and K12's launches by route in `n_sds` zero123 SDS
    steps over K references (one UNet call at CFG batch 2K, the VAE
    encoder forward and backward at 256²) and, with `embed`, the start-up's
    reference embeddings (the VAE encoder's forward at batch K, the ViT's
    patch conv), from the towers' topology: K10's route is each attention
    module's head dim, K12's each conv's (its route does not depend on the
    spatial size), K11's each norm's shape (``zero123_groupnorms``).
    `n_vae`: the SDS steps through the VAE (default: all; a warm-up step
    renders the latents)."""
    from dreamfusion_tpu_torch.models.unet import Conv2d, CrossAttention
    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import conv as K12
    from dreamfusion_tpu_torch.ops import groupnorm as K11

    unet, vae, vision = zero123_towers(torch)
    n_vae = n_sds if n_vae is None else n_vae
    want = {}

    def add(name, n):
        want[name] = want.get(name, 0) + n

    def route(m, dgrad=False):
        O, kh, kw, I = m.weight.shape
        st = (m.stride, m.stride)
        return K12.dgrad_route(m.compute_dtype, I, O, st, (kh, kw)) if \
            dgrad else K12.conv_route(m.compute_dtype, I, O, st, kh * kw)

    for m in unet.modules():
        if isinstance(m, CrossAttention):
            add(K10.attention_route(m.head_dim), n_sds)
        elif isinstance(m, Conv2d):
            add(route(m), n_sds)
    for m in vae.encoder.modules():
        if isinstance(m, Conv2d):
            add(route(m), n_vae + embed)
            add(route(m, dgrad=True), n_vae)
    add("attention_fwd_wgmma_d512", n_vae + embed)
    add("attention_bwd_wgmma", n_vae)
    sms = kernels.sm_count(torch.device("cuda"))
    bf = torch.bfloat16
    for B, H, W, C, eps, silu, n, bwd in zero123_groupnorms(K):
        G = K11.groups_for(C)
        name = lambda b, back: K11.group_norm_route((b, H, W, C), bf, back,
                                                    G, sms).name
        add(name(B, False), n * (n_vae if bwd else n_sds))
        if bwd:
            add(name(B, True), n * n_vae)
            if embed:
                add(name(K, False), n)
    if embed:
        add(route(vision.embeddings.patch_embedding), 1)
    return want


def write_reference_png(port_main, ws) -> str:
    """The analytic scene's default view at the known-view size (96² at
    64² renders), rgb premasked and the hit mask as alpha, as an RGBA PNG
    under `ws`."""
    import numpy as np

    from dreamfusion_tpu_torch.training.image_data import \
        analytic_ref_images
    from dreamfusion_tpu_torch.utils.image import save_image
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        ["--image", "analytic:two_sphere", "--guidance", "image_oracle"]))
    ref = analytic_ref_images(cfg, cfg.h, cfg.w)
    os.makedirs(ws, exist_ok=True)
    path = os.path.join(ws, "ref_rgba.png")
    save_image(path, np.concatenate(
        [ref.rgb[0], ref.mask[0][..., None].astype(np.float32)], axis=-1))
    return path


def check_tower_launches(launches, want, what) -> None:
    got = {k: launches[k] for k in want}
    check(got == want, f"{what}: K10-K12 launched {got}, not {want}")
    others = {k: v for k, v in launches.items() if v and k not in want and
              k.startswith(("attention_", "conv_", "groupnorm_"))}
    check(not others, f"{what}: K10-K12 routes off the topology: {others}")


def zero123_path(torch, port_main, kernels, png, ws, smi_line):
    """Zero123 stage 1 at full width through ``main`` (6 + 25 steps, a
    known-view step every 4th), the counters reset just before it: finite
    losses and gradients, K10-K12 exactly as ``zero123_launches`` derives
    (one reference), K1-K4 on every step; then the same run built as main
    builds it, its SDS and known-view steps timed apart (synchronised)
    after the 6 warm-up steps → launches."""
    n = ZERO123_WARMUP + ZERO123_STEPS
    flags = ["--image", png] + ZERO123_FLAGS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    z = port_main.main(flags + ["--iters", str(n), "--workspace", ws])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_known = z["known_view_steps"]
    n_sds = n - n_known
    unet, vae, vision = zero123_towers(torch)
    counts = {k: sum(p.numel() for p in m.parameters()) / 1e6 for k, m in
              (("UNet", unet), ("VAE", vae), ("vision", vision))}
    log(f"zero123 path: {n} steps ({n_known} known-view) in {wall:.1f} s "
        f"(start-up and run's end included), losses {z['losses']}, "
        f"known-view masked PSNR {z['kv_psnr_init']:.3f} -> "
        f"{z['kv_psnr_final']:.3f} dB, peak device memory {peak_gib:.2f} "
        f"GiB, parameters (M) {_rounded(counts)} + cc_projection "
        f"{(768 + 4) * 768 + 768} (772 -> 768), "
        f"start-up (s) {_rounded(z['startup'])}, on {smi_line}, launches "
        f"{launches}")
    check(z["all_losses_finite"], f"zero123: non-finite loss {z['losses']}")
    check(z["grad_ok"], "zero123: a step had non-finite gradients")
    check(n_known == -(-n // 4), f"zero123: {n_known} known-view steps")
    check(round(counts["UNet"], 1) == 859.5,
          f"zero123: UNet of {counts['UNet']}M parameters")
    check_tower_launches(launches, zero123_launches(
        torch, kernels, 1, n_sds, True), "zero123")
    for name in ORACLE_KERNELS:
        check(launches[name] > 0, f"the zero123 path never launched {name}")
    run_render_launches(launches, port_main.config_from_args(
        port_main.build_parser().parse_args(flags)), n, "zero123")
    check(all(g > 0 for g in z["triplane_grad_max"]),
          "zero123: a step had a zero triplane gradient")
    # the step times, SDS and known-view apart
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        flags + ["--iters", str(n), "--workspace", ws + "_timing"]))
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False, log=lambda *a: None)
    times = {"SDS": [], "known-view": []}
    for i in range(n):
        kind = "known-view" if trainer.is_known_view_step(state.step) \
            else "SDS"
        torch.cuda.synchronize()
        t = time.time()
        trainer.run_step(state, gen)
        torch.cuda.synchronize()
        if i >= ZERO123_WARMUP:
            times[kind].append(time.time() - t)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"zero123 step times (synchronised, median over steps "
        f"{ZERO123_WARMUP}-{n - 1}: {len(times['SDS'])} SDS, "
        f"{len(times['known-view'])} known-view): SDS "
        f"{1e3 * med['SDS']:.2f} ms (min {1e3 * min(times['SDS']):.2f}), "
        f"known-view {1e3 * med['known-view']:.2f} ms (min "
        f"{1e3 * min(times['known-view']):.2f}); start-up of this build (s) "
        f"{_rounded(trainer.startup)}; on {smi_line}")
    return launches


def jax_closeness_weights(np, dp, da, dr, refs):
    """JAX's zero123 ws (``guidance/zero123.py`` :255-279) in float64
    numpy: the views' deltas [B] against the references (weight, radius,
    polar, azimuth) → [B, K]."""
    w, rr, rp, ra = (np.array(c, np.float64) for c in zip(*refs))

    def cart(r, th, ph):
        v = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) *
                      np.sin(ph), r * np.cos(th)], -1)
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)

    a = cart(dr + rr[0], np.deg2rad(dp + rp[0]), np.deg2rad(da + ra[0]))
    b = cart(rr, np.deg2rad(rp), np.deg2rad(ra))
    ang = np.rad2deg(np.arccos(np.clip(a @ b.T, -1, 1)))
    inv = np.minimum(1 / np.maximum(ang, 1e-6), 100.0)
    inv = inv / inv.max(-1, keepdims=True)
    inv = np.where(inv < 0.1, 0.0, inv)
    ws = w[None] * inv
    ws = ws / ws.max(-1, keepdims=True)
    return np.where(ws < 0.1, 0.0, ws)


def zero123_refs_phase(torch, port_main, kernels, png, ws):
    """``--image_config`` with K = 3 (config/example.csv's form, weights 1,
    1, 0.5; three PNGs), built as main builds it, 5 steps: each SDS step
    runs the UNet once at batch 6, its ws equal JAX's formula (float64
    numpy) within 1e-4, and K10-K12 launch exactly as
    ``zero123_launches`` derives for K = 3."""
    import numpy as np

    from dreamfusion_tpu_torch.guidance.zero123 import (closeness_weights,
                                                        pose_angle_grad_scale)
    from dreamfusion_tpu_torch.training.trainer import train_batch
    from dreamfusion_tpu_torch.utils.image import load_image, save_image

    os.makedirs(ws, exist_ok=True)
    img = load_image(png)
    rows = ["zero123_weight, radius, polar, azimuth, image"]
    for i, (w, r, p, a) in enumerate(ZERO123_REFS):
        path = os.path.join(ws, f"ref{i}_rgba.png")
        save_image(path, img if i == 0 else img[:, ::-1])
        rows.append(f"{w:g}, {r:g}, {p:g}, {a:g}, {path}")
    csv = os.path.join(ws, "refs.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        ["--image", png, "--image_config", csv] + ZERO123_FLAGS + [
            "--iters", str(ZERO123_K3_STEPS), "--workspace", ws]))
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False, log=lambda *a: None)
    guidance, emb = trainer.priors["zero123"]
    check(tuple(emb["c_crossattn"].shape) == (3, 1, 768) and
          tuple(emb["c_concat"].shape) == (3, 32, 32, 4),
          f"K = 3: embeddings {emb['c_crossattn'].shape}, "
          f"{emb['c_concat'].shape}")
    batches = []
    hook = guidance.unet.register_forward_pre_hook(
        lambda mod, args: batches.append(args[0].shape[0]))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    n_sds, ws_err = 0, 0.0
    try:
        for _ in range(ZERO123_K3_STEPS):
            if trainer.is_known_view_step(state.step):
                trainer.run_step(state, gen)
                continue
            draws = trainer.draw_step(gen)
            b = train_batch(cfg, draws.pose, draws.fov, state.step, cfg.h,
                            cfg.w)
            _, angles = pose_angle_grad_scale(
                emb["ref_polars"], emb["ref_azimuths"], emb["ref_radii"],
                b.delta_polar, b.delta_azimuth, b.delta_radius,
                cfg.zero123_grad_scale, 1.0, 1)
            got = closeness_weights(angles, emb["zero123_ws"]).cpu().numpy()
            want = jax_closeness_weights(
                np, *(t.double().cpu().numpy() for t in (
                    b.delta_polar, b.delta_azimuth, b.delta_radius)),
                ZERO123_REFS)
            ws_err = max(ws_err, float(np.abs(got - want).max()))
            check(np.allclose(got, want, atol=1e-4),
                  f"K = 3: ws {got} against JAX's {want}")
            trainer.train_step(state, draws)
            n_sds += 1
        torch.cuda.synchronize()
    finally:
        hook.remove()
    check(batches == [6] * n_sds, f"K = 3: UNet batches {batches} in "
          f"{n_sds} SDS steps (one call at 6 a step)")
    check_tower_launches(dict(kernels.LAUNCHES), zero123_launches(
        torch, kernels, 3, n_sds, False), "zero123 K = 3")
    log(f"zero123 K = 3: {n_sds} SDS steps, one UNet call at batch 6 each, "
        f"ws within {ws_err:.2e} of JAX's formula, K10-K12 exactly as the "
        f"topology gives")


def zero123_dmtet_path(torch, port_main, kernels, png, init_with, ws,
                       smi_line):
    """The DMTet stage under zero123 at full width (tet grid 128, 512²
    renders resized to the VAE's 256²) from the oracle stage 1's
    checkpoint: ``dmtet_path``'s checks (no face dropped, no tile cut in a
    step, an eval or a test view) and K10-K12 exactly as
    ``zero123_launches`` derives."""
    flags = ["--image", png] + ZERO123_DMTET_FLAGS + ["--init_with",
                                                      init_with]
    dm, launches = dmtet_path(torch, port_main, kernels, flags,
                              ZERO123_DMTET_STEPS, ws, "DMTet zero123",
                              DMTET_KERNELS, "triplane", smi_line)
    n_sds = ZERO123_DMTET_STEPS - dm["known_view_steps"]
    check(dm["known_view_steps"] == -(-ZERO123_DMTET_STEPS // 4),
          f"DMTet zero123: {dm['known_view_steps']} known-view steps")
    check_tower_launches(launches, zero123_launches(
        torch, kernels, 1, n_sds, True), "DMTet zero123")
    log(f"DMTet zero123: {n_sds} SDS steps, K10-K12 exactly as the "
        f"topology gives; start-up (s) {_rounded(dm['startup'])}")


def novel_view_phase(torch, png, ws):
    """The novel-view CLI at full width, 3 DDIM steps: a 256² PNG."""
    from dreamfusion_tpu_torch.guidance import zero123
    from dreamfusion_tpu_torch.utils.image import load_image
    out = os.path.join(ws, "novel.png")
    t0 = time.time()
    zero123._main(["--image", png, "--steps", "3", "--polar", "-20",
                   "--azimuth", "40", "--out", out])
    torch.cuda.synchronize()
    img = load_image(out)
    check(img.shape == (256, 256, 3), f"novel view: {img.shape}")
    log(f"novel-view CLI: 3 DDIM steps at full width in "
        f"{time.time() - t0:.1f} s (towers and embedding included), "
        f"{out} mean {img.mean():.3f}")


def choose_clip_limit(torch, port_main, ws):
    """--grad_clip_rgb's limit for the image runs: the CLIP_QUANTILE of
    |d loss / d rendered rgb| of a real SDS step (after 20 steps of the
    image run without clamping), captured here by autograd on the image."""
    args = port_main.build_parser().parse_args(
        IMAGE_FLAGSHIP + ["--workspace", ws, "--iters", str(STEPS)])
    cfg = port_main.config_from_args(args)
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False)
    for _ in range(20):
        trainer.run_step(state, gen)
    while trainer.is_known_view_step(state.step):
        trainer.run_step(state, gen)
    draws = trainer.draw_step(gen)
    pred, _, batch, bg = trainer.render_part(state, draws, False)
    img = pred.detach().requires_grad_()
    (cot,) = torch.autograd.grad(
        trainer.guidance_loss(img, batch, draws, bg, False), [img])
    mag = cot.abs().flatten()
    limit = float(f"{float(torch.quantile(mag, CLIP_QUANTILE)):.3g}")
    share = float((mag > limit).float().mean())
    log(f"--grad_clip_rgb {limit}: clamps {share:.4f} of the image "
        f"gradient of SDS step {state.step} (|grad| max "
        f"{float(mag.max()):.4g}, median {float(mag.median()):.4g})")
    check(0.01 <= share <= 0.5, f"the clip limit clamps {share} of a step")
    return limit


def step_timing(torch, port_main, kernels, flags, n=12):
    """s/step of the image run's SDS and known-view steps apart, from its
    last checkpoint, each step synchronised; K5 launches in both kinds."""
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        flags))
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False)
    state, loaded = trainer.load_checkpoint(state, "latest")
    check(loaded, "step timing: no checkpoint of the image run")
    out = {}
    for kind, draw, step in (
            ("SDS", trainer.draw_step, trainer.train_step),
            ("known-view", trainer.draw_known_view,
             trainer.known_view_step)):
        kernels.reset_launch_counts()
        times = []
        for _ in range(n):
            draws = draw(gen)
            torch.cuda.synchronize()
            t = time.time()
            step(state, draws)
            torch.cuda.synchronize()
            times.append(time.time() - t)
        check(kernels.LAUNCHES["clip_grad_bwd"] == n,
              f"{kind} steps launched K5 {kernels.LAUNCHES['clip_grad_bwd']}"
              f" times in {n} steps")
        out[kind] = statistics.median(times[2:])
    return out


def image_path(torch, port_main, kernels, ws, smi_line):
    """The image → 3D stage 1 at flagship width with --grad_clip_rgb, the
    counters reset just before it → (summary, launches, limit)."""
    limit = choose_clip_limit(torch, port_main, ws + "_clip")
    flags = IMAGE_FLAGSHIP + ["--grad_clip_rgb", str(limit)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    summary = port_main.main(flags + STAGE1_END + [
        "--iters", str(STEPS), "--workspace", ws])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_known = summary["known_view_steps"]
    kv0, kv1 = summary["kv_psnr_init"], summary["kv_psnr_final"]
    log(f"image path: {STEPS} steps ({n_known} known-view), steady "
        f"{summary['steady_its']:.3f} it/s, known-view masked PSNR "
        f"{kv0:.3f} -> {kv1:.3f} dB, analytic PSNR "
        f"{summary['psnr_init']:.3f} -> {summary['psnr_final']:.3f} dB, "
        f"peak device memory {peak_gib:.2f} GiB, launches {launches}")
    log(f"image run's end (s): {_rounded(summary['phases'])}; export "
        f"phases (s): {_rounded(summary['export_phases'])}; on {smi_line}")
    check(summary["all_losses_finite"],
          f"image: non-finite loss: {summary['losses']}")
    check(summary["grad_ok"], "image: a step had non-finite gradients")
    for name in IMAGE_KERNELS:
        check(launches[name] > 0, f"the image path never launched {name}")
    run_render_launches(launches, port_main.config_from_args(
        port_main.build_parser().parse_args(flags)), STEPS, "image")
    check(n_known == -(-STEPS // 4), f"image: {n_known} known-view steps "
          f"in {STEPS} (known_view_interval 4)")
    check(all(g > 0 for g in summary["triplane_grad_max"]),
          "image: a step had a zero triplane gradient")
    check(kv1 - kv0 >= 3.0, f"image: the known-view PSNR rose only "
          f"{kv1 - kv0:.3f} dB (bar: 3 dB)")
    _check_outputs(ws, summary, "image")
    stage1_step_launches(torch, port_main, kernels, flags, ws + "_step",
                         "image")
    timing = step_timing(torch, port_main, kernels, flags + [
        "--iters", str(STEPS), "--workspace", ws])
    log(f"image step times (synchronised, median of 10 after 2): SDS "
        f"{1e3 * timing['SDS']:.2f} ms, known-view "
        f"{1e3 * timing['known-view']:.2f} ms; K5 launched once in every "
        f"step of both kinds; on {smi_line}")
    return summary, launches, limit


def image_dmtet_path(torch, port_main, kernels, flags, ws, smi_line):
    """The DMTet stage from the image run's mesh.obj through K9 →
    launches."""
    dm, launches = dmtet_path(torch, port_main, kernels, flags,
                              IMAGE_DMTET_STEPS, ws,
                              "DMTet from the image mesh",
                              IMAGE_DMTET_KERNELS, "triplane", smi_line)
    n_known = dm["known_view_steps"]
    log(f"DMTet from the image mesh: init (mesh load + K9) "
        f"{dm['init_seconds']:.3f} s, {n_known} known-view steps")
    check(launches["signed_distance"] == 1, f"K9 launched "
          f"{launches['signed_distance']} times (once, at the init)")
    check(n_known == -(-IMAGE_DMTET_STEPS // 4),
          f"DMTet image: {n_known} known-view steps")
    n_sds = IMAGE_DMTET_STEPS - n_known
    check(launches["clip_grad_bwd"] == n_sds, f"K5 launched "
          f"{launches['clip_grad_bwd']} times in {n_sds} SDS steps")
    for name in ("raster_fwd", "marching_tets_fwd", "raster_bwd",
                 "marching_tets_bwd"):
        check(launches[name] >= IMAGE_DMTET_STEPS,
              f"{name} launched {launches[name]} times in "
              f"{IMAGE_DMTET_STEPS} steps")
    return launches


def clip_kernel_phase(torch, results):
    """K12's two mma.sync routes at the patch conv CLIP guidance runs every
    step (``CLIP_PATCH_CONV``: ViT-B/16 at 224²) against their plain
    versions, with event, graph and cuDNN ms (``F.conv2d``, and
    ``conv2d_input``, i.e. ``aten.convolution_backward``, for the dgrad)."""
    randn = _randn_on(torch, torch.Generator(device="cuda").manual_seed(4))
    conv_rows(torch, results, [CLIP_PATCH_CONV], randn, graph=True,
              no_bias=(CLIP_PATCH_CONV,))


def image_text_counts(n, summary, interval=2):
    """(SDS steps, those through the VAE, known-view steps) of a run of `n`
    steps from step 0 with a known-view step every `interval`-th."""
    known = [s % interval == 0 for s in range(n)]
    latent = summary["latent_phase"]
    n_sds = sum(not k for k in known)
    n_vae = sum(not k and not lat for k, lat in zip(known, latent))
    return n_sds, n_vae, sum(known)


def image_text_path(torch, port_main, kernels, png, ws, smi_line):
    """The image + text recipe at full width through ``main`` (6 + 25 steps:
    SD 2.1 and CLIP ViT-B/16 summed, a known-view step every 2nd, the
    warm-up's first 20%), the counters reset just before it: finite losses
    and gradients; K10-K12 exactly (``sd_step_launches``: the UNet every
    SDS step, the VAE after the warm-up, one ``conv_fwd_mma`` and one
    ``conv_dgrad`` a CLIP loss, one ``conv_fwd_mma`` more for the
    reference's embedding at start-up); K2-K4 exactly; then the same run
    built as main builds it, its SDS and known-view steps timed apart
    (synchronised) after the 6 warm-up steps → launches."""
    n = IMAGE_TEXT_WARMUP + IMAGE_TEXT_STEPS
    flags = ["--image", png] + IMAGE_TEXT_FLAGS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    it = port_main.main(flags + ["--iters", str(n), "--workspace", ws])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        flags + ["--iters", str(n)]))
    check(cfg.guidance == ("SD", "clip") and cfg.known_view_interval == 2,
          f"image + text: the recipe gave {cfg.guidance}, every "
          f"{cfg.known_view_interval}th step known-view")
    n_sds, n_vae, n_known = image_text_counts(n, it)
    log(f"image + text path: {n} steps ({n_known} known-view, {n_sds} SDS, "
        f"{n_vae} of them through the VAE) in {wall:.1f} s (start-up and "
        f"run's end included), losses {it['losses']}, known-view masked "
        f"PSNR {it['kv_psnr_init']:.3f} -> {it['kv_psnr_final']:.3f} dB, "
        f"peak device memory {peak_gib:.2f} GiB, start-up (s) "
        f"{_rounded(it['startup'])}, on {smi_line}, launches {launches}")
    check(it["all_losses_finite"], f"image + text: non-finite loss "
          f"{it['losses']}")
    check(it["grad_ok"], "image + text: a step had non-finite gradients")
    check(it["known_view_steps"] == n_known,
          f"image + text: {it['known_view_steps']} known-view steps")
    check(0 < n_vae < n_sds, f"image + text: {n_vae} of {n_sds} SDS steps "
          f"through the VAE")
    want = sd_step_launches(torch, kernels, n_sds, n_vae, n_clip=n_sds,
                            n_embed=1)
    got = {k: launches[k] for k in want}
    check(got == want, f"image + text: K10-K12 launched {got}, not {want}")
    for name in ORACLE_KERNELS:
        check(launches[name] > 0, f"the image + text path never launched "
              f"{name}")
    # K2-K4: the 3-D normal smoothness shades twice, but not in the
    # warm-up's SDS steps (normal shading, rendered as the latent)
    latent_sds = n_sds - n_vae
    shade = 2 * n - latent_sds
    k34 = {k: launches[k] for k in ("composite_bwd", "field_shade_fwd",
                                    "field_shade_bwd", "field_head_bwd")}
    check(k34 == {"composite_bwd": n, "field_shade_fwd": shade,
                  "field_shade_bwd": shade, "field_head_bwd": 0},
          f"image + text: K3/K4 launched {k34} in {n} steps")
    check(all(g > 0 for g in it["triplane_grad_max"]),
          "image + text: a step had a zero triplane gradient")
    log(f"image + text: K10-K12 exactly ({sum(got.values())} launches over "
        f"{len(got)} routes): conv_fwd_mma {got['conv_fwd_mma']} "
        f"({n_sds} CLIP losses + the reference's embedding), conv_dgrad "
        f"{got['conv_dgrad']}")
    # the step times, SDS and known-view apart
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        flags + ["--iters", str(n), "--workspace", ws + "_timing"]))
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False, log=lambda *a: None)
    times = {"SDS": [], "known-view": []}
    for i in range(n):
        kind = "known-view" if trainer.is_known_view_step(state.step) \
            else "SDS"
        torch.cuda.synchronize()
        t = time.time()
        trainer.run_step(state, gen)
        torch.cuda.synchronize()
        if i >= IMAGE_TEXT_WARMUP:
            times[kind].append(time.time() - t)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"image + text step times (synchronised, median over steps "
        f"{IMAGE_TEXT_WARMUP}-{n - 1}: {len(times['SDS'])} SDS, "
        f"{len(times['known-view'])} known-view): SDS "
        f"{1e3 * med['SDS']:.2f} ms (min {1e3 * min(times['SDS']):.2f}), "
        f"known-view {1e3 * med['known-view']:.2f} ms (min "
        f"{1e3 * min(times['known-view']):.2f}); start-up of this build (s) "
        f"{_rounded(trainer.startup)}; on {smi_line}")
    return launches


def image_text_dmtet_path(torch, port_main, kernels, png, init_with, ws,
                          smi_line):
    """The DMTet stage of the image + text recipe (SD 2.1 + CLIP ViT-B/16,
    tet grid 128, 512² renders) from the oracle stage 1's checkpoint:
    ``dmtet_path``'s checks (no face dropped, no tile cut in a step, an
    eval or a test view) and K10-K12 exactly (``sd_step_launches``: each
    SDS step through the VAE with one CLIP loss)."""
    flags = ["--image", png] + IMAGE_TEXT_DMTET_FLAGS + ["--init_with",
                                                         init_with]
    steps = IMAGE_TEXT_DMTET_STEPS
    dm, launches = dmtet_path(torch, port_main, kernels, flags, steps, ws,
                              "DMTet SD + CLIP", DMTET_KERNELS, "triplane",
                              smi_line)
    n_known = dm["known_view_steps"]
    n_sds = steps - n_known
    check(n_known == -(-steps // 2),
          f"DMTet SD + CLIP: {n_known} known-view steps")
    want = sd_step_launches(torch, kernels, n_sds, n_clip=n_sds, n_embed=1)
    got = {k: launches[k] for k in want}
    check(got == want, f"DMTet SD + CLIP: K10-K12 launched {got}, not "
          f"{want}")
    log(f"DMTet SD + CLIP: {n_sds} SDS steps, K10-K12 exactly "
        f"(conv_fwd_mma {got['conv_fwd_mma']}, conv_dgrad "
        f"{got['conv_dgrad']}); start-up (s) {_rounded(dm['startup'])}")


def clip_eval_phase(torch, port_main, kernels, smi_line):
    """A text run's CLIP eval metric at full width (``--guidance clip``: the
    run's ViT-B/16 scores min(dataset_size_valid, 4) EMA renders of the
    validation circle at 64²): one ``conv_fwd_mma`` for the batch, no
    dgrad, a finite score; its seconds."""
    build = os.path.join(ROOT, "build", "chip_smoke_clip_eval_ws")
    args = port_main.build_parser().parse_args(
        ["--text", "a hamburger", "--guidance", "clip", "--backbone",
         "triplane", "--seed", "0", "--workspace", build, "--iters", "1"])
    cfg = port_main.config_from_args(args)
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False, log=lambda *a: None)
    port_main.install_clip_scorer(trainer, cfg, False, log=lambda *a: None)
    check(trainer.clip_scorer is not None, "no CLIP scorer was installed")
    trainer.run_step(state, gen)
    trainer.eval_metric(state)              # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    score = trainer.eval_metric(state)
    torch.cuda.synchronize()
    sec = time.time() - t0
    got = {k: kernels.LAUNCHES[k] for k in ("conv_fwd_mma", "conv_dgrad")}
    check(got == {"conv_fwd_mma": 1, "conv_dgrad": 0},
          f"CLIP eval metric: the patch conv launched {got}")
    check(math.isfinite(score) and abs(score) <= 100.0,
          f"CLIP eval metric: {score}")
    log(f"CLIP eval metric at full width: {score:.4f} (x100 cosine, "
        f"{min(cfg.dataset_size_valid, 4)} views at {cfg.h}x{cfg.w}) in "
        f"{1e3 * sec:.1f} ms (synchronised), patch conv {got}; on "
        f"{smi_line}")


def _write_safetensors(torch, path, tensors):
    """A .safetensors file: the 8-byte little-endian header length, the
    JSON header, then each tensor's bytes (F32, F16 or BF16)."""
    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}
    header, blobs, off = {}, [], 0
    for k, t in tensors.items():
        raw = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + raw.numel()]}
        blobs.append(raw.numpy().tobytes())
        off += raw.numel()
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))


def raw_weights_phase(torch, port_main, ws):
    """Raw checkpoints read by the card's own torch through the loader
    ``--pretrained_root`` runs (``load_pretrained``): a tiny diffusers
    directory (fp16 and bf16 ``.safetensors``; ``.bin`` files with the
    UNet sharded behind an index), an SD 1.5 CompVis ``.ckpt`` and a
    zero123 ``.ckpt`` (EMA weights, the OpenAI ViT) with the published key
    names (``tests/fixtures``) at narrow widths; the towers must hold the
    written tensors bit for bit."""
    from types import SimpleNamespace

    from dreamfusion_tpu_torch.guidance.sd import (SDConfig,
                                                   StableDiffusionGuidance)
    from dreamfusion_tpu_torch.models.clip import (CLIPTextConfig,
                                                   CLIPTextEncoder,
                                                   CLIPVisionConfig,
                                                   CLIPVisionEncoder)
    from dreamfusion_tpu_torch.models.unet import (Dense, UNet2DCondition,
                                                   UNetConfig)
    from dreamfusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from dreamfusion_tpu_torch.utils import raw_weights as R
    from dreamfusion_tpu_torch.utils.params import load_pretrained_towers
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    t0 = time.time()

    def as_torch(p, ndim):
        """The port parameter's shape in a torch checkpoint's layout."""
        if p.dim() == 4:
            return torch.randn(p.shape, generator=g).permute(0, 3, 1, 2)
        t = torch.randn(p.shape, generator=g)
        return t[..., None, None] if ndim == 4 else t

    def same(tower, written, key=lambda k: k, what=""):
        n = 0
        for k, p in tower.named_parameters():
            src = written[key(k)]
            want = R.fit_layout(src, p.shape, k).to(p.dtype)
            check(torch.equal(p.detach().cpu(), want), f"raw weights: "
                  f"{what}{k} differs from the file")
            n += 1
        return n

    # the diffusers directory: .safetensors, then .bin with a shard index
    sdg = StableDiffusionGuidance(SDConfig(tiny=True, image_size=16,
                                           latent_size=8), dev)
    dtypes = {"unet": torch.float16, "vae": torch.bfloat16,
              "text": torch.float32}
    files = {}
    for name, tower in sdg.towers().items():
        pre = "text_model." if name == "text" else ""
        files[name] = {pre + k: as_torch(p, 2).to(dtypes[name]).contiguous()
                       for k, p in tower.named_parameters()}
    sub = {"unet": ("unet", "diffusion_pytorch_model"),
           "vae": ("vae", "diffusion_pytorch_model"),
           "text": ("text_encoder", "model")}
    counts = {}
    for form in ("safetensors", "bin"):
        root = os.path.join(ws, f"diffusers_{form}")
        for name, (d, stem) in sub.items():
            os.makedirs(os.path.join(root, d), exist_ok=True)
            if form == "safetensors":
                _write_safetensors(torch, os.path.join(
                    root, d, stem + ".safetensors"), files[name])
            elif name == "unet":
                keys = sorted(files[name])
                shards = {f"{stem}-0000{i + 1}-of-00002.bin": keys[i::2]
                          for i in range(2)}
                for fname, ks in shards.items():
                    torch.save({k: files[name][k] for k in ks},
                               os.path.join(root, d, fname))
                with open(os.path.join(root, d, stem + ".bin.index.json"),
                          "w") as f:
                    json.dump({"weight_map": {k: fn for fn, ks in
                                              shards.items() for k in ks}}, f)
            else:
                torch.save(files[name], os.path.join(root, d, stem + ".bin"))
        sdg.load_pretrained(root, torch.Generator(device=dev).manual_seed(0),
                            log=lambda *a: None)
        counts[form] = sum(
            same(t, files[n], (lambda k: "text_model." + k) if n == "text"
                 else (lambda k: k), f"diffusers {form} {n}.")
            for n, t in sdg.towers().items())
    # SD 1.5's and zero123's CompVis .ckpt, their published keys
    narrow = dict(model_channels=32, context_dim=32, num_heads=2,
                  dtype=torch.float32)
    vae_cfg = VAEConfig(ch=32, dtype=torch.float32)
    with torch.device(dev):
        towers = {"sd15": SimpleNamespace(
            unet=UNet2DCondition(UNetConfig(**narrow)),
            vae=AutoencoderKL(vae_cfg),
            text_encoder=CLIPTextEncoder(CLIPTextConfig.tiny())),
            "zero123": SimpleNamespace(
            unet=UNet2DCondition(UNetConfig(in_channels=8, **narrow)),
            vae=AutoencoderKL(vae_cfg),
            vision=CLIPVisionEncoder(CLIPVisionConfig(
                image_size=28, hidden_size=32, num_heads=2,
                projection_dim=16, dtype=torch.float32)),
            cc_projection=Dense(36, 32))}
    for kind, ns in towers.items():
        with open(os.path.join(ROOT, "tests", "fixtures",
                               f"{kind}_ldm_keys.json")) as f:
            inv = json.load(f)
        ukey = R.ldm_to_diffusers_unet_key(4, 2)
        vkey = R.ldm_to_diffusers_vae_key(4)
        unet_p = dict(ns.unet.named_parameters())
        vae_p = dict(ns.vae.named_parameters())
        sd, expect = {}, {}
        for k, shape in inv.items():
            if ukey(k) is not None:
                sd[k] = as_torch(unet_p[ukey(k)], len(shape))
            elif vkey(k) is not None:
                sd[k] = as_torch(vae_p[vkey(k)], len(shape))
        if kind == "zero123":
            for k in list(sd):
                if k.startswith("model.diffusion_model."):
                    ek = "model_ema." + k[len("model."):].replace(".", "")
                    sd[ek] = torch.randn(sd[k].shape, generator=g)
            vis = dict(ns.vision.named_parameters())
            hidden = ns.vision.cfg.hidden_size
            pre = "cond_stage_model.model.visual."
            top = {"class_embedding": "embeddings.class_embedding",
                   "positional_embedding":
                       "embeddings.position_embedding.weight",
                   "conv1.weight": "embeddings.patch_embedding.weight",
                   "ln_pre.weight": "pre_layrnorm.weight",
                   "ln_pre.bias": "pre_layrnorm.bias",
                   "ln_post.weight": "post_layernorm.weight",
                   "ln_post.bias": "post_layernorm.bias"}
            for k in inv:
                r = k[len(pre):] if k.startswith(pre) else None
                if r in top:
                    sd[k] = as_torch(vis[top[r]], len(inv[k]))
                elif r == "proj":
                    sd[k] = torch.randn(hidden, ns.vision.cfg.projection_dim,
                                        generator=g)
                elif r is not None:
                    i, rest = r[len("transformer.resblocks."):].split(".", 1)
                    rows = 3 * hidden if "in_proj" in rest else None
                    name = {"attn.out_proj": "self_attn.out_proj",
                            "ln_1": "layer_norm1", "ln_2": "layer_norm2",
                            "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2"}
                    if rows:
                        shape = (rows, hidden) if rest.endswith("weight") \
                            else (rows,)
                        sd[k] = torch.randn(shape, generator=g)
                    else:
                        base, wb = rest.rsplit(".", 1)
                        sd[k] = as_torch(vis[f"encoder.layers.{i}."
                                             f"{name[base]}.{wb}"], 2)
            sd["cc_projection.weight"] = torch.randn(32, 36, generator=g)
            sd["cc_projection.bias"] = torch.randn(32, generator=g)
        path = os.path.join(ws, f"{kind}.ckpt")
        torch.save({"state_dict": {k: v.contiguous() for k, v in sd.items()},
                    "global_step": 1}, path)
        convert = R.convert_zero123 if kind == "zero123" else R.convert_sd
        logs = []
        load_pretrained_towers(path, {"unet": ns.unet},
                               lambda src: convert(src, ns, logs.append))
        # the SD 1.5 inventory holds no text tower: it keeps its weights
        check(any(("text tower: kept" if kind == "sd15" else "EMA") in m
                  for m in logs), f"raw weights: {kind}: {logs}")
        if kind == "zero123":
            for k in list(sd):
                if k.startswith("model.diffusion_model."):
                    sd[k] = sd["model_ema." + k[len("model."):].replace(
                        ".", "")]
            written = R.openai_clip_visual_to_transformers(sd, pre)
            counts[kind] = same(ns.vision, written, what="zero123 vision.") \
                + same(ns.cc_projection, sd, lambda k: "cc_projection." + k,
                       "zero123 cc_projection.")
        unet_src = R.rename(sd, R.ldm_to_diffusers_unet_key(4, 2))
        vae_src = R.rename(sd, R.ldm_to_diffusers_vae_key(4))
        counts[kind] = counts.get(kind, 0) + same(
            ns.unet, unet_src, what=f"{kind} unet.") + same(
            ns.vae, vae_src, what=f"{kind} vae.")
    log(f"raw weights: the diffusers directory (.safetensors; .bin with the "
        f"UNet sharded), the SD 1.5 and zero123 .ckpt loaded on torch "
        f"{torch.__version__}, every tensor bit for bit (tensors checked "
        f"{counts}) in {time.time() - t0:.1f} s")


def if_unet_calls(torch, B: int):
    """Every K12 and K10 call of one IF-I-XL UNet call at batch `B` on 64²,
    in order, from the tower's own forward on the meta device with the two
    ops recorded instead of run → (convs: (B, H, W, I, O, k, stride, pads,
    dtype), attentions: (B, N, M, heads, d))."""
    from unittest import mock

    from dreamfusion_tpu_torch.models import if_unet, unet
    from dreamfusion_tpu_torch.ops import conv as K12
    convs, attns = [], []

    def conv(x, w, bias, stride=1, padding=0, out_dtype=None):
        st, pads = (stride, stride), K12.norm_padding(padding)
        B_, H, W, I = x.shape
        O, kh, kw, _ = w.shape
        dt = out_dtype or x.dtype
        convs.append((B_, H, W, I, O, kh, stride, pads, dt))
        return torch.empty(B_, *K12.out_size(H, W, kh, kw, st, pads), O,
                           dtype=dt, device=x.device)

    def attention(q, k, v):
        attns.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                      q.shape[3]))
        return torch.empty_like(q)

    with torch.device("meta"), mock.patch.object(unet, "conv2d", conv), \
            mock.patch.object(if_unet, "attention", attention):
        net = if_unet.IFUNet(if_unet.IFUNetConfig.xl(), torch.bfloat16)
        net(torch.empty(B, 64, 64, 3), torch.zeros(B, dtype=torch.long),
            torch.empty(B, 77, 4096))
    return convs, attns


def if_step_launches(torch, n_calls: int) -> dict:
    """K10's and K12's launches by route in `n_calls` IF UNet calls (one an
    SDS step, CFG or Perp-Neg): each conv's route by its shape, each
    attention's by its head dim; no K11 (JAX's IF normalises with flax's
    GroupNorm) and nothing else of K10-K12."""
    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import conv as K12
    convs, attns = if_unet_calls(torch, 2)
    want = {}
    for _, _, _, I, O, k, st, _, dt in convs:
        r = K12.conv_route(dt, I, O, (st, st), k * k)
        want[r] = want.get(r, 0) + n_calls
    for *_, d in attns:
        r = K10.attention_route(d)
        want[r] = want.get(r, 0) + n_calls
    return want


def if_kernel_phases(torch, results):
    """K12 at each distinct conv shape of one IF UNet call at CFG batch 2
    (``if_unet_calls``: the narrow conv_in, the 3×3 convs, the 1×1
    shortcuts, the fp32 conv_out) and K10 at its three attention shapes
    (77 text + N spatial keys) at CFG batch 2 and Perp-Neg's 4, lse checked
    too, each against its plain version with the library call beside it →
    (distinct conv shapes, TFLOP of conv a CFG call)."""
    convs, attns = if_unet_calls(torch, 2)
    rows = sorted({(B, H, W, I, O, k, st, pads,
                    "fp32" if dt == torch.float32 else "bf16", False)
                   for B, H, W, I, O, k, st, pads, dt in convs},
                  key=lambda r: (-r[1], r[3], r[4], r[5]))
    tflop = sum(2 * B * H * W * O * k * k * I
                for B, H, W, I, O, k, _, _, _ in convs) / 1e12
    log(f"IF UNet (CFG batch 2, 64²): {len(convs)} convs a call, "
        f"{len(rows)} distinct shapes, {tflop:.3f} TFLOP; {len(attns)} "
        f"attentions over {sorted(set(a[1:] for a in attns))} (N, M, "
        f"heads, d)")
    randn = _randn_on(torch, torch.Generator(device="cuda").manual_seed(4))
    t0 = time.time()
    ct, at = {}, {}
    conv_rows(torch, results, rows, randn, times=ct)
    shapes = sorted(set(attns), key=lambda a: -a[1])
    attention_rows(torch, results, [(B * m, N, M, h, d, False)
                                    for m in (1, 2)
                                    for B, N, M, h, d in shapes],
                   randn, check_lse=True, times=at)
    # one UNet call's K12 and K10 time: each row's event ms times its calls
    key = lambda B, H, W, I, O, k, st, pads, dt: (
        B, H, W, I, O, k, st, pads,
        "fp32" if dt == torch.float32 else "bf16", False)
    k12 = [ct[key(*c)] for c in convs]
    k10 = [at[(*a, False)] for a in attns]
    log(f"IF UNet call (CFG batch 2), sums of the rows' event ms over its "
        f"calls: K12 {sum(m for m, *_ in k12):.3f} ms ({len(k12)} convs; "
        f"F.conv2d {sum(l for _, l, *_ in k12):.3f}), K10 "
        f"{sum(m for m, _ in k10):.3f} ms ({len(k10)} attentions; SDPA "
        f"{sum(l for _, l in k10):.3f}); bound of the convs "
        f"{tflop * 1e12 / PEAK['bf16'] * 1e3:.3f} ms (operations)")
    log(f"IF K10/K12 rows in {time.time() - t0:.1f} s")
    return len(rows), tflop


def if_timed_steps(torch, port_main, flags, n, warmup, ws):
    """The run `flags` describes built as main builds it, `n` steps each
    synchronised → (median, min) seconds of the steps after `warmup`."""
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        flags + ["--iters", str(n), "--workspace", ws]))
    trainer, state, gen = port_main.build_run(cfg, torch.device("cuda"),
                                              False, log=lambda *a: None)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.time()
        trainer.run_step(state, gen)
        torch.cuda.synchronize()
        times.append(time.time() - t)
    return statistics.median(times[warmup:]), min(times[warmup:])


def if_path(torch, port_main, kernels, ws, smi_line):
    """DeepFloyd-IF stage 1 at full width through ``main`` (6 + 25 steps),
    the counters reset just before it: finite losses and gradients, the
    UNet's parameter count, K10/K12 exactly as ``if_step_launches`` counts
    (one UNet call a step, nothing else of K10-K12), K2-K4 every step;
    the same run built as main builds it, its steps timed (synchronised)
    after the 6 warm-up steps; then Perp-Neg under IF for 5 steps with the
    same launch checks → launches of the stage-1 run."""
    from dreamfusion_tpu_torch.models.if_unet import IFUNet, IFUNetConfig
    n = IF_WARMUP + IF_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    out = port_main.main(IF_FLAGS + ["--iters", str(n), "--workspace", ws])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.device("meta"):
        n_unet = sum(p.numel() for p in IFUNet(IFUNetConfig.xl(),
                                               torch.bfloat16).parameters())
    log(f"IF path: {n} steps in {wall:.1f} s (start-up and run's end "
        f"included), losses {out['losses']}, peak device memory "
        f"{peak_gib:.2f} GiB, UNet {n_unet / 1e9:.4f}B parameters (bf16), "
        f"start-up (s) {_rounded(out['startup'])}, on {smi_line}, launches "
        f"{launches}")
    check(out["all_losses_finite"], f"IF: non-finite loss {out['losses']}")
    check(out["grad_ok"], "IF: a step had non-finite gradients")
    check(n_unet == IF_UNET_PARAMS, f"IF: UNet of {n_unet} parameters")
    check(not any(out["latent_phase"]), "IF: a warm-up (latent) step")
    check_tower_launches(launches, if_step_launches(torch, n), "IF")
    for name in ORACLE_KERNELS:
        check(launches[name] > 0, f"the IF path never launched {name}")
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        IF_FLAGS))
    run_render_launches(launches, cfg, n, "IF", cfg.dataset_size_test * -(
        -cfg.H * cfg.W // cfg.max_ray_batch))
    check(all(g > 0 for g in out["triplane_grad_max"]),
          "IF: a step had a zero triplane gradient")
    torch.cuda.reset_peak_memory_stats()
    med, low = if_timed_steps(torch, port_main, IF_FLAGS, n, IF_WARMUP,
                              ws + "_timing")
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"IF step (synchronised, median over steps {IF_WARMUP}-{n - 1}): "
        f"{1e3 * med:.2f} ms (min {1e3 * low:.2f}), peak device memory "
        f"{step_peak:.2f} GiB (UNet, the field, activations; no T5); on "
        f"{smi_line}")
    # Perp-Neg: the UNet at batch 4, the same launches a step
    flags = IF_FLAGS + ["--perpneg"]
    kernels.reset_launch_counts()
    pn = port_main.main(flags + ["--iters", str(IF_PERPNEG_STEPS),
                                 "--workspace", ws + "_perpneg"])
    torch.cuda.synchronize()
    pn_launches = dict(kernels.LAUNCHES)
    check(pn["all_losses_finite"] and pn["grad_ok"],
          f"IF Perp-Neg: losses {pn['losses']}, grad_ok {pn['grad_ok']}")
    check_tower_launches(pn_launches, if_step_launches(
        torch, IF_PERPNEG_STEPS), "IF Perp-Neg")
    pmed, plow = if_timed_steps(torch, port_main, flags, 8, 3,
                                ws + "_perpneg_timing")
    log(f"IF Perp-Neg: {IF_PERPNEG_STEPS} steps, losses {pn['losses']}, "
        f"K10/K12 exactly; step (synchronised, median of 5 after 3) "
        f"{1e3 * pmed:.2f} ms (min {1e3 * plow:.2f}); on {smi_line}")
    return launches


def t5_phase(torch, smi_line):
    """T5-XXL once, as a run with T5 weights starts: the full-width fp32
    encoder on random weights (seed 0) built on the card beside the IF UNet,
    the five prompts of ``prepare_embeddings`` encoded (their hash tokens),
    finite [1, 77, 4096] states unlike the md5 stand-ins; seconds and
    memory logged, then freed."""
    from dreamfusion_tpu_torch.guidance.deepfloyd import IFConfig, IFGuidance
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g = IFGuidance(IFConfig(), "cuda", torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    init_s = g.init_t5(gen)
    n_t5 = sum(p.numel() for p in g.t5.parameters())
    t5_gib = sum(p.numel() * p.element_size()
                 for p in g.t5.parameters()) / 2 ** 30
    torch.cuda.synchronize()
    t0 = time.time()
    emb = g.prepare_embeddings("a hamburger", "")
    torch.cuda.synchronize()
    enc_s = time.time() - t0
    t0 = time.time()
    again = g.encode_text("a hamburger")
    torch.cuda.synchronize()
    one_s = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    check(sorted(emb) == ["back", "default", "front", "side", "uncond"],
          f"T5: embeddings {sorted(emb)}")
    for k, v in emb.items():
        check(tuple(v.shape) == (1, 77, 4096) and v.dtype == torch.float32
              and bool(torch.isfinite(v).all()), f"T5: {k} {tuple(v.shape)}")
    check(torch.equal(again, emb["default"]), "T5: a second encode differs")
    check(not torch.equal(emb["default"], g.fallback_embedding(
        "a hamburger")), "T5: the states are the md5 stand-in")
    g.free_t5()
    del g
    torch.cuda.empty_cache()
    log(f"T5-XXL: {n_t5 / 1e9:.4f}B parameters ({t5_gib:.2f} GiB fp32), "
        f"built and drawn on the card in {init_s:.2f} s; five prompts "
        f"encoded in {enc_s:.3f} s (one more {1e3 * one_s:.1f} ms); peak "
        f"device memory {peak:.2f} GiB with the bf16 UNet resident; freed "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB left); on "
        f"{smi_line}")
    check(round(n_t5 / 1e9, 2) == 4.76, f"T5: {n_t5} parameters")


def if_dmtet_path(torch, port_main, kernels, init_with, ws, smi_line):
    """The DMTet stage under IF at full width (tet grid 128, 512² renders
    shrunk to 64² with the antialiased resize) from the oracle stage 1's
    checkpoint: ``dmtet_path``'s checks (no face dropped, no tile cut in a
    step, an eval or a test view) and K10/K12 exactly as
    ``if_step_launches`` counts."""
    flags = IF_DMTET_FLAGS + ["--init_with", init_with]
    dm, launches = dmtet_path(torch, port_main, kernels, flags,
                              IF_DMTET_STEPS, ws, "DMTet IF", DMTET_KERNELS,
                              "triplane", smi_line)
    check_tower_launches(launches, if_step_launches(torch, IF_DMTET_STEPS),
                         "DMTet IF")
    log(f"DMTet IF: K10/K12 exactly ({IF_DMTET_STEPS} UNet calls); "
        f"start-up (s) {_rounded(dm['startup'])}")


def vanilla_kernel_phases(torch, results, smi_line):
    """K2's vanilla launches, K4's routes and K3 at the -O2 SD step's
    shapes, against their plain twins, with event and graph ms: the step's
    4096 rays (perturbed draws) and one 4096-ray chunk of an 800² eval view
    (deterministic), the coarse density from the full-width vanilla field
    (random weights, bf16) on the kernel's own coarse positions; K2's z,
    deltas and positions must equal the twin's bit for bit.  K4 at the
    step's 393,216 shaded samples (h and the tangents from the ResMLP),
    with each activation, and its normals-given route there for the log
    only (no path runs it at this shape: ``options_select_rows`` fills its
    entries); K3 at [4096, 96] with the background MLP's colour and the
    orient loss."""
    from dreamfusion_tpu_torch.config import Config, apply_O2, finalize
    from dreamfusion_tpu_torch.core.math import safe_normalize
    from dreamfusion_tpu_torch.ops import activation as K4
    from dreamfusion_tpu_torch.ops import composite as K3
    from dreamfusion_tpu_torch.ops import resample as KV
    from dreamfusion_tpu_torch.training.data import circle_view_batch
    from dreamfusion_tpu_torch.training.trainer import (build_renderer,
                                                        draw_step,
                                                        train_batch)
    dev = torch.device("cuda")
    cfg = finalize(apply_O2(Config(text="a hamburger")))
    g = torch.Generator(device=dev).manual_seed(2)
    renderer = build_renderer(cfg)
    renderer.field.reset_parameters(torch.Generator().manual_seed(0))
    renderer.to(dev)
    field = renderer.field
    draws = draw_step(g, cfg, dev)
    batch = train_batch(cfg, draws.pose, draws.fov, 0, cfg.h, cfg.w)
    view = circle_view_batch(cfg, 0, 8, cfg.H, cfg.W, dev)
    lin, centres = renderer.vanilla_consts(dev)
    S, n, b = cfg.num_steps, cfg.upsample_steps, cfg.bound
    chunk = cfg.max_ray_batch

    def record(name, err, fn, plain, tol, n_bytes, flops, where, main):
        ms, gms = median_ms(fn), graph_ms(fn)
        log(f"{name}{where}: graph {gms:.4f} ms on {smi_line}")
        record_kernel(results, name, err, ms, median_ms(plain), tol,
                      n_bytes, flops, "fp32", None, where, main=main)

    cases = [("step: 4096 rays, perturbed", batch.rays_o.reshape(-1, 3),
              batch.rays_d.reshape(-1, 3), draws.march_u, draws.pdf_u),
             (f"eval chunk: {chunk} rays of an {cfg.H}x{cfg.W} view",
              view.rays_o[0][:chunk], view.rays_d[0][:chunk], None,
              centres)]
    for i, (what, o, d, uc, up) in enumerate(cases):
        R, where = o.shape[0], f" [{what}]"
        ck = KV.vanilla_coarse_cuda(o, d, b, lin, uc)
        torch.cuda.synchronize()
        cp = KV.vanilla_coarse_plain(o, d, b, lin, uc)
        diff = [int((x != y).sum()) for x, y in _pairs(ck, cp)]
        check(sum(diff) == 0, f"vanilla_coarse{where}: {diff} values of "
              f"z, positions differ from the twin's")
        with torch.no_grad():
            sigma = field.density(ck[2].reshape(-1, 3), 1.0)["sigma"] \
                .reshape(R, S)
        record("vanilla_coarse", 0.0,
               lambda: KV.vanilla_coarse_cuda(o, d, b, lin, uc),
               lambda: KV.vanilla_coarse_plain(o, d, b, lin, uc),
               "bit for bit", nbytes(o, d, lin, uc, ck[0], ck[2]),
               R * S * 12, where, i == 0)
        rk = KV.vanilla_resample_cuda(o, d, b, ck[0], sigma, up)
        torch.cuda.synchronize()
        rp = KV.vanilla_resample_plain(o, d, b, ck[0], sigma, up)
        diff = [int((x != y).sum()) for x, y in zip(rk, rp)]
        check(sum(diff) == 0, f"vanilla_resample{where}: {diff} values of "
              f"z, deltas, positions differ from the twin's (max "
              f"{max_err(rk, rp):.3e})")
        M = S + n
        record("vanilla_resample", 0.0,
               lambda: KV.vanilla_resample_cuda(o, d, b, ck[0], sigma, up),
               lambda: KV.vanilla_resample_plain(o, d, b, ck[0], sigma, up),
               "bit for bit", nbytes(o, d, ck[0], sigma, up, *rk),
               R * (S * 16 + n * 30 + M * 8), where, i == 0)
        if i == 0:
            z96, deltas96, x96 = rk

    # ---- K4 at the step's shaded samples, h and tangents from the ResMLP -
    R, M = z96.shape
    N = R * M
    x = x96.reshape(-1, 3)
    with torch.no_grad():
        feat, jac = field.encode(x, 1.0, need_jacobian=True)
        h, t = field.sigma_net(feat, torch.bfloat16,
                               tangents=torch.stack(jac))
    ro = cases[0][1]
    light = safe_normalize(ro + torch.randn(ro.shape, device=dev,
                                            generator=g))
    ratio, ids = torch.tensor(0.3, device=dev), torch.tensor(1, device=dev)
    bd, br = cfg.blob_density, cfg.blob_radius
    for act in ("exp", "softplus"):
        where = f" [-O2 step: {N} samples, bf16 h and tangents, {act}]"
        args = (h, t, x, light, ratio, ids, bd, br, b)
        sk = K4.field_shade_fwd_cuda(*args, act=act)
        torch.cuda.synchronize()
        sp = K4.field_shade_fwd_plain(*args, act=act)
        err = assert_close("field_shade_fwd", sk, sp, 1e-5, 2e-5)
        record("field_shade_fwd", err,
               lambda: K4.field_shade_fwd_cuda(*args, act=act),
               lambda: K4.field_shade_fwd_plain(*args, act=act),
               "1e-5 + 2e-5 rel", nbytes(h, t, x, light, *sk), N * 60,
               where, False)
        gs = [torch.randn(o.shape, device=dev, generator=g) for o in sp]
        dk = K4.field_shade_bwd_cuda(*args, *gs, act=act)
        torch.cuda.synchronize()
        dp = K4.field_shade_bwd_plain(*args, *gs, act=act)
        err = _bf16_close("field_shade_bwd", dk, dp, 1e-5)
        record("field_shade_bwd", err,
               lambda: K4.field_shade_bwd_cuda(*args, *gs, act=act),
               lambda: K4.field_shade_bwd_plain(*args, *gs, act=act),
               "1 bf16 ulp + 1e-5 of the largest",
               nbytes(h, t, x, light, *gs, *dk), N * 90, where, False)
        hc = h[:R * S]
        xc = x[:R * S]
        where = f" [-O2 coarse pass: {R * S} samples, bf16 h, {act}]"
        fk = K4.field_head_fwd_cuda(hc, xc, bd, br, act)
        torch.cuda.synchronize()
        fp = K4.field_head_fwd_plain(hc, xc, bd, br, act)
        err = assert_close("field_head_fwd", fk, fp, 1e-6, 1e-5)
        record("field_head_fwd", err,
               lambda: K4.field_head_fwd_cuda(hc, xc, bd, br, act),
               lambda: K4.field_head_fwd_plain(hc, xc, bd, br, act),
               "1e-5 rel", nbytes(hc, xc, *fk), R * S * 20, where, False)
        # the normals-given route: unit normals as the six probes give
        normal = safe_normalize(torch.randn(N, 3, device=dev, generator=g))
        sargs = (h, normal, x, light, ratio, ids, bd, br)
        where = (f" [{N} samples, bf16 h, given fp32 normals, lambertian, "
                 f"{act}]")
        qk = K4.field_select_fwd_cuda(*sargs, act=act)
        torch.cuda.synchronize()
        qp = K4.field_select_fwd_plain(*sargs, act=act)
        err = assert_close("field_select_fwd", qk, qp, 1e-5, 2e-5)
        record("field_select_fwd", err,
               lambda: K4.field_select_fwd_cuda(*sargs, act=act),
               lambda: K4.field_select_fwd_plain(*sargs, act=act),
               "1e-5 + 2e-5 rel", nbytes(h, normal, x, light, *qk), N * 40,
               where, False)
        gq = [torch.randn(o.shape, device=dev, generator=g) for o in qp]
        bk = K4.field_select_bwd_cuda(*sargs, *gq, act=act)
        torch.cuda.synchronize()
        bp = K4.field_select_bwd_plain(*sargs, *gq, act=act)
        err = max(_bf16_close("field_select_bwd", bk[:1], bp[:1], 1e-5),
                  assert_close("field_select_bwd", bk[1:], bp[1:], 1e-5,
                               2e-5))
        record("field_select_bwd", err,
               lambda: K4.field_select_bwd_cuda(*sargs, *gq, act=act),
               lambda: K4.field_select_bwd_plain(*sargs, *gq, act=act),
               "g_h 1 bf16 ulp + 1e-5 of the largest, g_normal 1e-5 + "
               "2e-5 rel", nbytes(h, normal, x, light, *gq, *bk), N * 50,
               where, False)

    # ---- K3 at [4096, 96], no mask, the net's colour and the orient loss -
    sigma, rgb, nrm = (v.reshape(R, M, -1).squeeze(-1)
                       for v in K4.field_shade_fwd_cuda(h, t, x, light,
                                                        ratio, ids, bd, br,
                                                        b))
    extra = dict(bg_color=torch.rand(3, device=dev, generator=g).expand(R, 3),
                 bg_net=torch.rand(R, 3, device=dev, generator=g),
                 use_bg_net=torch.tensor(True, device=dev), normals=nrm,
                 rays_d=cases[0][2].contiguous())
    fargs = (sigma, rgb, z96, deltas96, None, 1e-4, False)
    where = f" [-O2 step: {R}x{M}, no mask, the net's colour, orient]"
    ck = K3._composite_fwd_cuda(*fargs, **extra)
    torch.cuda.synchronize()
    cp = K3.composite_fwd_plain(*fargs, **extra)
    err = assert_close("composite_fwd", ck, cp, 1e-5, 1e-5)
    record("composite_fwd", err, lambda: K3._composite_fwd_cuda(
        *fargs, **extra), lambda: K3.composite_fwd_plain(*fargs, **extra),
        "1e-5", nbytes(sigma, rgb, z96, deltas96, extra["bg_net"], nrm,
                       *ck), R * M * 30, where, False)
    cc = [torch.randn(o.shape, device=dev, generator=g) for o in cp]
    bargs = (sigma, rgb, z96, deltas96, None, cp.weights, *cc[:4], 1e-4)
    gk = K3._composite_bwd_cuda(*bargs, **extra, g_loss=cc[4],
                                wsum=ck.weights_sum)
    torch.cuda.synchronize()
    gp = K3.composite_bwd_plain(*bargs, **extra, g_loss=cc[4])
    scale = max(float(v.abs().max()) for v in gp)
    err = assert_close("composite_bwd", gk, gp, 1e-5 * scale, 1e-4)
    record("composite_bwd", err, lambda: K3._composite_bwd_cuda(
        *bargs, **extra, g_loss=cc[4], wsum=ck.weights_sum),
        lambda: K3.composite_bwd_plain(*bargs, **extra, g_loss=cc[4]),
        "1e-4 rel, 1e-5 of the largest (sums in another order)",
        nbytes(sigma, rgb, z96, deltas96, cp.weights, nrm, *cc, *gk),
        R * M * 40, where, False)


def options_path(torch, port_main, kernels, ws, smi_line, results):
    """The small field options on the triplane under the oracle, the
    counters reset just before it: the finite-difference normals (K4's
    normals-given route once each way a step, the shade pair never),
    softplus, Adam, the elementwise clip and the triplane's tv for
    ``OPTION_STEPS`` steps: finite losses and gradients, the triplane's
    backward twice a step (the probes' query is a second one); then
    ``options_select_rows`` → launches."""
    kernels.reset_launch_counts()
    t0 = time.time()
    out = port_main.main(OPTION_FLAGS + ["--iters", str(OPTION_STEPS),
                                         "--workspace", ws])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"field options path (finite-difference normals, softplus, Adam, "
        f"--grad_clip 1, triplane tv): {OPTION_STEPS} steps in "
        f"{time.time() - t0:.1f} s, losses {out['losses']}, PSNR "
        f"{out['psnr_init']:.3f} -> {out['psnr_final']:.3f} dB, on "
        f"{smi_line}")
    check(out["all_losses_finite"] and out["grad_ok"], f"field options: "
          f"losses {out['losses']}, grad_ok {out['grad_ok']}")
    # the triplane's backward twice a step: the shaded samples' query and
    # the six probes' (one query of 6N positions)
    want = {"field_select_fwd": OPTION_STEPS,
            "field_select_bwd": OPTION_STEPS, "field_shade_fwd": 0,
            "field_shade_bwd": 0, "triplane_bwd": 2 * OPTION_STEPS,
            "composite_bwd": OPTION_STEPS}
    got = {k: launches[k] for k in want}
    check(got == want, f"field options: launched {got}, not {want}")
    check(all(v > 0 for v in out["triplane_grad_max"]),
          "field options: a zero triplane gradient")
    options_select_rows(torch, results, smi_line)
    return launches


def options_select_rows(torch, results, smi_line):
    """K4's normals-given route at the options run's own shape against its
    plain twin, each way: the flagship step's 98,304 samples
    (``flagship_march``), h from the flagship's triplane MLP (bf16), the
    six probes' normals of that field under softplus (one query of 589,824
    positions), one light a ray, the lambertian id.  These rows fill the
    route's entries in the JSON line."""
    from dreamfusion_tpu_torch.ops import activation as K4
    m = flagship_march(torch)
    fi = flagship_field_inputs(torch, m, act="softplus")
    field, h, g, x = fi["field"], fi["h"], fi["g"], m["xyz"]
    with torch.no_grad():
        normal = field._finite_difference_normal(x, None).contiguous()
    check(bool(torch.isfinite(normal).all()) and
          float(normal.norm(dim=-1).max()) > 0.5,
          "field options: the probes' normals are not unit vectors")
    N, act = x.shape[0], "softplus"
    args = (h, normal, x, fi["light"], fi["ratio"],
            torch.tensor(1, device=x.device), field.blob_density,
            field.blob_radius)
    where = (f" [the options run: {N} samples, bf16 h of the triplane MLP, "
             f"the six probes' normals, lambertian, {act}]")

    def record(name, err, fn, plain, tol, n_bytes, flops):
        ms, gms = median_ms(fn), graph_ms(fn)
        log(f"{name}{where}: graph {gms:.4f} ms on {smi_line}")
        record_kernel(results, name, err, ms, median_ms(plain), tol,
                      n_bytes, flops, "fp32", None, where, main=True)

    qk = K4.field_select_fwd_cuda(*args, act=act)
    torch.cuda.synchronize()
    qp = K4.field_select_fwd_plain(*args, act=act)
    err = assert_close("field_select_fwd", qk, qp, 1e-5, 2e-5)
    record("field_select_fwd", err,
           lambda: K4.field_select_fwd_cuda(*args, act=act),
           lambda: K4.field_select_fwd_plain(*args, act=act),
           "1e-5 + 2e-5 rel", nbytes(h, normal, x, fi["light"], *qk), N * 40)
    gq = [torch.randn(o.shape, device=x.device, generator=g) for o in qp]
    bk = K4.field_select_bwd_cuda(*args, *gq, act=act)
    torch.cuda.synchronize()
    bp = K4.field_select_bwd_plain(*args, *gq, act=act)
    err = max(_bf16_close("field_select_bwd", bk[:1], bp[:1], 1e-5),
              assert_close("field_select_bwd", bk[1:], bp[1:], 1e-5, 2e-5))
    record("field_select_bwd", err,
           lambda: K4.field_select_bwd_cuda(*args, *gq, act=act),
           lambda: K4.field_select_bwd_plain(*args, *gq, act=act),
           "g_h 1 bf16 ulp + 1e-5 of the largest, g_normal 1e-5 + 2e-5 rel",
           nbytes(h, normal, x, fi["light"], *gq, *bk), N * 50)


# ---- guidance snapshots, txt2img and the guidance sets (slice 10) ---------

def record_towers(torch, kernels, run, full=None):
    """Run `run()`, which builds towers on the meta device and calls them,
    with each K12 conv, K11 group norm and K10 attention recorded instead
    of run → (forward launches by route, the calls: ("conv", B, H, W, I, O,
    k, stride, dtype), ("gn", B, H, W, C, SiLU), ("attn", B, N, M, heads,
    d)); `full`, a list, gets each call with all it takes: ("conv", B, H,
    W, I, O, k, stride, pads, dtype), ("gn", B, H, W, C, eps, SiLU, dtype),
    ("attn", B, N, M, heads, d)."""
    from unittest import mock

    from dreamfusion_tpu_torch.models import if_unet, unet, vae
    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import conv as K12
    from dreamfusion_tpu_torch.ops import groupnorm as K11
    sms = kernels.sm_count(torch.device("cuda"))
    routes, calls = {}, []

    def add(route, call):
        routes[route] = routes.get(route, 0) + 1
        calls.append(call)

    def conv(x, w, bias, stride=1, padding=0, out_dtype=None):
        st, pads = (stride, stride), K12.norm_padding(padding)
        B, H, W, I = x.shape
        O, kh, kw, _ = w.shape
        dt = out_dtype or x.dtype
        name = "fp32" if dt == torch.float32 else "bf16"
        add(K12.conv_route(dt, I, O, st, kh * kw), (
            "conv", B, H, W, I, O, kh, stride, name))
        if full is not None:
            full.append(("conv", B, H, W, I, O, kh, stride, pads, name))
        return torch.empty(B, *K12.out_size(H, W, kh, kw, st, pads), O,
                           dtype=dt, device=x.device)

    def group_norm(x, weight, bias, groups, eps, silu=False):
        add(K11.group_norm_route(tuple(x.shape), x.dtype, False, groups,
                                 sms).name, ("gn", *x.shape, silu))
        if full is not None:
            full.append(("gn", *x.shape, eps, silu,
                         "fp32" if x.dtype == torch.float32 else "bf16"))
        return torch.empty_like(x)

    def attention(q, k, v):
        call = ("attn", q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                q.shape[3])
        add(K10.attention_route(q.shape[-1]), call)
        if full is not None:
            full.append(call)
        return torch.empty_like(q)

    with torch.device("meta"), mock.patch.object(unet, "conv2d", conv), \
            mock.patch.object(unet, "group_norm", group_norm), \
            mock.patch.object(unet, "attention", attention), \
            mock.patch.object(vae, "attention", attention), \
            mock.patch.object(if_unet, "attention", attention):
        run()
    return routes, calls


def add_counts(*counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


_TOWER_FWD = {}
_TOWER_FULL = {}


def tower_forward(torch, kernels, prior, part, batch=1):
    """One full-width forward of SD 2.1's ("SD"), SD 1.5's ("SD15": its
    UNet) or zero123's `part`: "unet" (a CFG call at batch 2·`batch`:
    zero123's over `batch` references), "encode" (the VAE encoder at batch
    `batch`) or "decode" (one decode of [1, ls, ls, 4] latents) →
    ``record_towers``' (routes, calls), kept; its calls with all they take
    (``full``) in ``_TOWER_FULL``."""
    key = (prior, part, batch)
    if key not in _TOWER_FWD:
        from dreamfusion_tpu_torch.models.unet import (UNet2DCondition,
                                                       UNetConfig)
        from dreamfusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
        ls = 32 if prior == "zero123" else 64

        def run():
            if part == "unet":
                cfg = {"SD": UNetConfig.sd21, "SD15": UNetConfig.sd15,
                       "zero123": UNetConfig.zero123}[prior]()
                n = 2 * batch
                UNet2DCondition(cfg)(
                    torch.empty(n, ls, ls, cfg.in_channels),
                    torch.zeros(n, dtype=torch.long),
                    torch.empty(n, 1 if prior == "zero123" else 77,
                                cfg.context_dim))
            elif part == "encode":
                AutoencoderKL(VAEConfig.sd()).encode(
                    torch.empty(batch, 8 * ls, 8 * ls, 3))
            else:
                AutoencoderKL(VAEConfig.sd()).decode(
                    torch.empty(1, ls, ls, 4))

        full = _TOWER_FULL[key] = []
        _TOWER_FWD[key] = record_towers(torch, kernels, run, full)
    return _TOWER_FWD[key]


def grad_routes(torch, kernels, full) -> dict:
    """K10-K12's backward launches by route of recorded calls (``full``)
    whose weights and input all want gradients: per conv its dgrad and its
    wgrad, per group norm its backward's ``_affine`` route, per attention
    the head dim's backward."""
    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import conv as K12
    from dreamfusion_tpu_torch.ops import groupnorm as K11
    sms = kernels.sm_count(torch.device("cuda"))
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}
    out = {}
    for call in full:
        kind, B, *dims = call
        if kind == "conv":
            H, W, I, O, k, st, _, dt = dims
            names = [K12.dgrad_route(dtype[dt], I, O, (st, st), (k, k)),
                     K12.wgrad_route(dtype[dt], I, O, (st, st), k * k)]
        elif kind == "gn":
            H, W, C, _, _, dt = dims
            names = [K11.group_norm_route(
                (B, H, W, C), dtype[dt], True, K11.groups_for(C),
                sms).name + "_affine"]
        else:
            names = [K10.attention_bwd_route(dims[-1])]
        for n in names:
            out[n] = out.get(n, 0) + 1
    return out


def vae_backward_launches(torch, kernels, prior) -> dict:
    """The VAE encoder's backward in one SDS step through the VAE: K12's
    dgrads (``SD_DGRADS``), K11's backwards (``SD_GROUPNORMS``' rows with
    one, zero123's at half the sides) and K10's."""
    from dreamfusion_tpu_torch.ops import groupnorm as K11
    sms = kernels.sm_count(torch.device("cuda"))
    rows = SD_GROUPNORMS if prior == "SD" else zero123_groupnorms(1)
    want = dict(SD_DGRADS, attention_bwd_wgmma=1)
    for B, H, W, C, eps, silu, n, bwd in rows:
        if bwd:
            name = K11.group_norm_route((B, H, W, C), torch.bfloat16, True,
                                        K11.groups_for(C), sms).name
            want[name] = want.get(name, 0) + n
    return want


def tower_launches(torch, kernels, prior, unet=0, encode=0, encode_bwd=0,
                   decode=0, K=1, unet_grad=0, encode_grad=0) -> dict:
    """K10-K12 launches by route of `unet` CFG UNet calls (zero123's over K
    references), `encode` VAE encodes (`encode_bwd` of them with their
    backward to the image) and `decode` decodes of SD 2.1's, SD 1.5's or
    zero123's full-width towers: the forwards from the towers' own code
    (``tower_forward``); `unet_grad` and `encode_grad` of the UNet calls and
    encodes also run the backward to every weight and the input
    (``grad_routes`` of the same calls)."""
    fwd = lambda part, b=1: tower_forward(torch, kernels, prior, part, b)[0]
    scale = lambda d, n: {k: v * n for k, v in d.items() if v * n}

    def grads(part, b=1):
        tower_forward(torch, kernels, prior, part, b)
        return grad_routes(torch, kernels, _TOWER_FULL[(prior, part, b)])

    out = [scale(fwd("unet", K), unet)] if unet else []
    if encode:
        out.append(scale(fwd("encode"), encode))
    if decode:
        out.append(scale(fwd("decode"), decode))
    if unet_grad:
        out.append(scale(grads("unet", K), unet_grad))
    if encode_grad:
        out.append(scale(grads("encode"), encode_grad))
    return add_counts(*out, scale(vae_backward_launches(torch, kernels,
                                                        prior), encode_bwd))


def _call_bound(call) -> float:
    """The least ms of one recorded call (``bound``): its inputs read once,
    its output written once, its operations at the peak of their type."""
    kind, *dims = call
    if kind == "conv":
        B, H, W, I, O, k, st, dt = dims
        e = 4 if dt == "fp32" else 2
        Ho, Wo = -(-H // st), -(-W // st)
        return bound((B * H * W * I + O * k * k * I + B * Ho * Wo * O) * e
                     + 4 * O, 2 * B * Ho * Wo * O * k * k * I, dt)[0]
    if kind == "gn":
        B, H, W, C, silu = dims
        return bound(4 * B * H * W * C, 10 * B * H * W * C, "fp32")[0]
    B, N, M, h, d = dims
    return bound(2 * d * h * B * (2 * N + 2 * M) + 4 * B * h * N,
                 4 * B * h * N * M * d, "bf16", B * h * N * M)[0]


def decoder_kernel_phases(torch, kernels, results, smi_line) -> dict:
    """K10-K12 against their plain versions at every shape of the SD VAE
    decoder at 512² and of zero123's at 256² (``SD_DECODER_*``,
    ``ZERO123_DECODER_*``, held to the decoder's own calls recorded on the
    meta device), each on its checked route with its event and graph ms,
    its bound and cuDNN's / F.group_norm's / SDPA's ms; then a whole decode
    of each on random bf16 weights: finite, its K10-K12 launches exactly
    the recorded ones, its ms beside the sum of its calls' row ms and
    bounds → {prior: decode ms}.  The rows are logged as one JSON line."""
    from dreamfusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    randn = _randn_on(torch, torch.Generator(device="cuda").manual_seed(5))
    out, rows_json = {}, {}
    for prior, convs, gns, attns, ls in (
            ("SD", SD_DECODER_CONVS, SD_DECODER_GROUPNORMS,
             SD_DECODER_ATTNS, 64),
            ("zero123", ZERO123_DECODER_CONVS, ZERO123_DECODER_GROUPNORMS,
             ZERO123_DECODER_ATTNS, 32)):
        routes, calls = tower_forward(torch, kernels, prior, "decode")
        n_of = {}
        for c in calls:
            n_of[c] = n_of.get(c, 0) + 1
        got = {kind: {c[1:]: n for c, n in n_of.items() if c[0] == kind}
               for kind in ("conv", "gn", "attn")}
        want_convs = {(B, H, W, I, O, k, st, dt) for B, H, W, I, O, k, st,
                      _, dt, _ in convs}
        check(set(got["conv"]) == want_convs, f"{prior} decoder convs "
              f"{sorted(got['conv'])}, not the list's {sorted(want_convs)}")
        want_gn = {(B, H, W, C, silu): n for B, H, W, C, _, silu, n, _ in gns}
        check(got["gn"] == want_gn, f"{prior} decoder norms {got['gn']}, "
              f"not {want_gn}")
        check(got["attn"] == {a[:5]: 1 for a in attns}, f"{prior} decoder "
              f"attention {got['attn']}, not {attns}")
        times = {}
        t0 = time.time()
        conv_rows(torch, results, convs, randn, graph=True, times=times)
        attention_rows(torch, results, attns, randn, graph=True, times=times)
        groupnorm_rows(torch, results, gns, randn, graph=True, times=times)
        # one decode: each call at its row's event ms (and library ms)
        row_of = {}
        for r in convs:
            row_of[("conv",) + r[:7] + (r[8],)] = r
        for r in gns:
            row_of[("gn",) + r[:4] + (r[5],)] = r
        for r in attns:
            row_of[("attn",) + r[:5]] = r
        k_ms = sum(times[row_of[c]][0] for c in calls)
        lib_ms = sum(times[row_of[c]][1] or 0.0 for c in calls)
        b_ms = sum(_call_bound(c) for c in calls)
        flops = sum(2 * c[1] * c[2] * c[3] * c[4] * c[5] * c[6] ** 2
                    for c in calls if c[0] == "conv")
        # the whole decoder on random bf16 weights
        with torch.device("cuda"):
            vae = AutoencoderKL(VAEConfig.sd())
        g = torch.Generator(device="cuda").manual_seed(0)
        with torch.no_grad():
            for p in vae.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device="cuda",
                                    dtype=p.dtype) * 0.02)
            z = torch.randn(1, ls, ls, 4, generator=g, device="cuda")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            img = vae.decode(z)
            torch.cuda.synchronize()
            launched = {k: v for k, v in kernels.LAUNCHES.items()
                        if v and k.startswith(("conv_", "groupnorm_",
                                               "attention_"))}
            check(launched == routes, f"{prior} decode launched "
                  f"{launched}, not {routes}")
            check(tuple(img.shape) == (1, 8 * ls, 8 * ls, 3) and
                  bool(torch.isfinite(img).all()),
                  f"{prior} decode: {tuple(img.shape)}, finite "
                  f"{bool(torch.isfinite(img).all())}")
            ms = median_ms(lambda: vae.decode(z), 5, 2)
        del vae
        out[prior] = ms
        log(f"{prior} VAE decode at {8 * ls}²: {ms:.3f} ms (event, median "
            f"of 5), its {len(calls)} K10-K12 calls at their rows' event ms "
            f"{k_ms:.3f} (cuDNN / F.group_norm / SDPA {lib_ms:.3f}), bound "
            f"{b_ms:.3f} ms ({flops / 1e12:.3f} TFLOP of convs); launches "
            f"{routes}; rows in {time.time() - t0:.1f} s; on {smi_line}")
        rows_json[prior] = {
            "decode_ms": ms, "calls_ms": k_ms, "calls_library_ms": lib_ms,
            "calls_bound_ms": b_ms, "conv_tflop": flops / 1e12,
            "rows": [{"row": list(r), "ms": times[r][0],
                      "library_ms": times[r][1]}
                     for r in list(convs) + list(gns) + list(attns)]}
        # the recorder against the hand counts of the SDS step
        if prior == "SD":
            step = tower_launches(torch, kernels, "SD", unet=1, encode=1,
                                  encode_bwd=1)
            hand = sd_step_launches(torch, kernels, 1, 1)
            diff = {k: (step.get(k, 0), n) for k, n in hand.items()
                    if step.get(k, 0) != n}
        else:
            step = tower_launches(torch, kernels, "zero123", unet=1,
                                  encode=1, encode_bwd=1)
            hand = zero123_launches(torch, kernels, 1, 1, False)
            diff = {k: (step.get(k, 0), hand.get(k, 0))
                    for k in set(step) | set(hand)
                    if step.get(k, 0) != hand.get(k, 0)}
        check(not diff, f"{prior}: recorded step launches differ from the "
              f"hand counts (recorded, hand): {diff}")
    log(f"decoder rows {json.dumps(rows_json)}")
    return out


def _capture_snapshots(port_trainer):
    """Patch the trainer module's ``save_image`` to keep whether each
    snapshot's array is finite → (the patch, {path: finite})."""
    from unittest import mock

    import numpy as np
    finite = {}
    real = port_trainer.save_image

    def save(path, img):
        finite[path] = bool(np.isfinite(np.asarray(img, np.float64)).all())
        real(path, img)

    return mock.patch.object(port_trainer, "save_image", save), finite


def snapshot_run(torch, port_main, kernels, flags, ws, what, n_snaps,
                 want_of, smi_line) -> float:
    """A run of `flags` through main with ``--save_guidance``, the counters
    reset just before it: `n_snaps` triptychs [h, 3w, 3], finite, each
    noised panel unlike its render; finite losses and gradients; K10-K12
    exactly ``want_of(n_vae)``, `n_vae` the steps through the VAE (those
    after the warm-up) → s per snapshot."""
    from dreamfusion_tpu_torch.training import trainer as port_trainer
    from dreamfusion_tpu_torch.utils.image import load_image
    cfg = port_main.config_from_args(port_main.build_parser().parse_args(
        flags))
    patch, finite = _capture_snapshots(port_trainer)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    with patch:
        out = port_main.main(flags + ["--workspace", ws])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    snaps = out["guidance_snapshots"]
    check(len(snaps) == n_snaps, f"{what}: {len(snaps)} snapshots, not "
          f"{n_snaps}: {snaps}")
    check(out["all_losses_finite"] and out["grad_ok"],
          f"{what}: losses {out['losses']}, grad_ok {out['grad_ok']}")
    for p in snaps:
        img = load_image(p)
        check(img.shape == (cfg.h, 3 * cfg.w, 3) and finite[p],
              f"{what}: {p} is {img.shape}, finite {finite[p]}")
        check(bool((img[:, cfg.w:2 * cfg.w] != img[:, :cfg.w]).any()),
              f"{what}: {p}'s noised panel equals its render")
    want = want_of(sum(not lat for lat in out["latent_phase"]))
    check_tower_launches(launches, want, what)
    per = out["phases"]["guidance_snapshot"] / n_snaps
    log(f"{what}: {len(out['losses'])} logged blocks and {n_snaps} "
        f"snapshots in {time.time() - t0:.1f} s (start-up included), "
        f"{per:.3f} s a snapshot, K10-K12 exactly "
        f"({sum(want.values())} launches); {os.path.basename(snaps[-1])}; "
        f"on {smi_line}")
    return per


def snapshot_phases(torch, port_main, kernels, png, init_with, ws,
                    smi_line) -> dict:
    """``--save_guidance --save_guidance_interval 1`` at full width: the SD
    2.1 triplane run (6 steps, 3 snapshots: one VAE encode, one CFG UNet
    call and two 512² decodes each), IF (one snapshot: a UNet call),
    zero123 (one: the encode and two 256² decodes) and the DMTet stage
    under SD from the oracle stage 1's checkpoint (one, its view through
    K8 and K7) → s per snapshot by run."""
    out = {}
    out["SD"] = snapshot_run(
        torch, port_main, kernels, SD_FLAGS + SNAP_FLAGS, ws + "_sd",
        "SD snapshots", 3, lambda n_vae: tower_launches(
            torch, kernels, "SD", unet=6 + 3, encode=n_vae + 3,
            encode_bwd=n_vae, decode=6), smi_line)
    two = ["--iters", "2", "--dataset_size_train", "2", "--save_guidance",
           "--save_guidance_interval", "1"]
    out["IF"] = snapshot_run(
        torch, port_main, kernels, IF_FLAGS + two, ws + "_if",
        "IF snapshot", 1, lambda _: if_step_launches(torch, 3), smi_line)
    out["zero123"] = snapshot_run(
        torch, port_main, kernels, ["--image", png] + ZERO123_FLAGS + two,
        ws + "_zero123", "zero123 snapshot", 1, lambda _: add_counts(
            zero123_launches(torch, kernels, 1, 1, True),
            tower_launches(torch, kernels, "zero123", unet=1, encode=1,
                           decode=2)), smi_line)
    dm = [f for f in DMTET_SD_FLAGS if f != "--save_mesh"] + two + [
        "--eval_interval", "0", "--dataset_size_test", "1", "--init_with",
        init_with]
    out["DMTet SD"] = snapshot_run(
        torch, port_main, kernels, dm, ws + "_dmtet_sd", "DMTet SD snapshot",
        1, lambda n_vae: tower_launches(torch, kernels, "SD", unet=3,
                                        encode=n_vae + 1, encode_bwd=n_vae,
                                        decode=2), smi_line)
    return out


def _timed(obj, name, times):
    """Patch `obj.name` to a synchronised, timed call appending its seconds
    to `times`."""
    from unittest import mock
    import torch
    real = getattr(obj, name)

    def call(*a, **kw):
        torch.cuda.synchronize()
        t = time.time()
        r = real(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.time() - t)
        return r

    return mock.patch.object(obj, name, call)


def txt2img_phase(torch, kernels, ws, smi_line) -> dict:
    """The SD and IF txt2img CLIs at full width, TXT2IMG_STEPS DDIM steps
    each, the counters reset just before each: a finite 512² and 64² PNG,
    K10-K12 exactly (SD: a CFG UNet call a step and one 512² decode; IF: a
    UNet call a step), the sampling loop's synchronised seconds a step →
    {cli: s per DDIM step}."""
    import numpy as np

    from dreamfusion_tpu_torch.guidance import deepfloyd, sd
    from dreamfusion_tpu_torch.utils.image import load_image
    n = TXT2IMG_STEPS
    os.makedirs(ws, exist_ok=True)
    out = {}
    for name, mod, cls, method, side, want in (
            ("sd", sd, sd.StableDiffusionGuidance, "produce_latents", 512,
             tower_launches(torch, kernels, "SD", unet=n, decode=1)),
            ("deepfloyd", deepfloyd, deepfloyd.IFGuidance, "produce_imgs",
             64, if_step_launches(torch, n))):
        path = os.path.join(ws, f"{name}.png")
        times = []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        with _timed(cls, method, times):
            mod._main(["a hamburger", "--steps", str(n), "--out", path])
        torch.cuda.synchronize()
        total = time.time() - t0
        img = load_image(path)
        check(img.shape == (side, side, 3) and np.isfinite(img).all(),
              f"txt2img {name}: {img.shape}")
        check_tower_launches(dict(kernels.LAUNCHES), want,
                             f"txt2img {name}")
        out[name] = times[0] / n
        log(f"txt2img CLI {name}: a finite {side}² PNG, {n} DDIM steps in "
            f"{times[0]:.3f} s ({1e3 * out[name]:.2f} ms a step), "
            f"{total:.1f} s in all (towers and prompts included), K10-K12 "
            f"exactly ({sum(want.values())} launches); on {smi_line}")
    return out


def guidance_sets_phase(torch, port_main, kernels, png, ws, smi_line):
    """Guidance sets through main at full width, the counters reset just
    before each: ``--image_config`` (K = 2) with ``--text`` and
    ``--guidance SD zero123 clip`` for MULTI_STEPS steps, each its own
    block (finite losses and gradients, a known-view step every 4th, K10-K12
    exactly: SD's and zero123's UNet a step, their VAEs through the encoder
    with its backward after the warm-up, zero123's start-up embedding of
    both references, CLIP's patch conv forward and input gradient a step
    and its reference embedding; the synchronised median ms of the SDS
    steps after the warm-up and the peak memory); SD with
    ``--image_config`` and ``--text``; the pixel oracle with the analytic
    reference image (known-view steps, no tower launch)."""
    from dreamfusion_tpu_torch.utils.image import load_image, save_image
    os.makedirs(ws, exist_ok=True)
    img = load_image(png)
    rows = ["image, polar, azimuth, radius, zero123_weight"]
    for k, (a, w) in enumerate(((0.0, 1.0), (180.0, 0.5))):
        path = os.path.join(ws, f"ref{k}_rgba.png")
        save_image(path, img if k == 0 else img[:, ::-1])
        rows.append(f"{path}, 90, {a:g}, 3.2, {w:g}")
    csv = os.path.join(ws, "refs.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    out = port_main.main(["--image_config", csv] + MULTI_FLAGS +
                         ["--workspace", ws + "_multi"])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = MULTI_STEPS
    known = [s % 4 == 0 for s in range(n)]
    sds = [not k for k in known]
    vae = [s and not lat for s, lat in zip(sds, out["latent_phase"])]
    n_sds, n_vae = sum(sds), sum(vae)
    check(out["all_losses_finite"] and out["grad_ok"],
          f"multi-prior: losses {out['losses']}, grad_ok {out['grad_ok']}")
    check(out["known_view_steps"] == sum(known),
          f"multi-prior: {out['known_view_steps']} known-view steps")
    want = add_counts(
        tower_launches(torch, kernels, "SD", unet=n_sds, encode=n_vae,
                       encode_bwd=n_vae),
        zero123_launches(torch, kernels, 2, n_sds, True, n_vae=n_vae),
        {"conv_fwd_mma": n_sds + 1, "conv_dgrad": n_sds})
    check_tower_launches(launches, want, "multi-prior")
    steps = [t / k for (k, t), v in zip(out["blocks"], vae) if v]
    med = statistics.median(steps)
    log(f"multi-prior stage 1 (--image_config K = 2, --text, --guidance SD "
        f"zero123 clip): {n} steps ({n_sds} SDS, {n_vae} through both VAEs, "
        f"{sum(known)} known-view) in {time.time() - t0:.1f} s (start-up "
        f"included), losses {[round(x, 3) for x in out['losses']]}, SDS step "
        f"after the warm-up {1e3 * med:.2f} ms (synchronised median of "
        f"{len(steps)}, min {1e3 * min(steps):.2f}), peak device memory "
        f"{peak:.2f} GiB, K10-K12 exactly ({sum(want.values())} launches); "
        f"start-up (s) {_rounded(out['startup'])}; on {smi_line}")
    # SD with --image_config and --text
    n = REFS_SD_STEPS
    flags = ["--image_config", csv] + [
        f for f in MULTI_FLAGS if f not in ("zero123", "clip")]
    flags[flags.index("--iters") + 1] = str(n)
    kernels.reset_launch_counts()
    out = port_main.main(flags + ["--workspace", ws + "_sd"])
    torch.cuda.synchronize()
    sds = [s % 4 != 0 for s in range(n)]
    n_vae = sum(s and not lat for s, lat in zip(sds, out["latent_phase"]))
    check(out["all_losses_finite"] and out["grad_ok"] and
          out["known_view_steps"] == n - sum(sds),
          f"SD with --image_config: {out['losses']}, "
          f"{out['known_view_steps']} known-view steps")
    check_tower_launches(dict(kernels.LAUNCHES), tower_launches(
        torch, kernels, "SD", unet=sum(sds), encode=n_vae, encode_bwd=n_vae),
        "SD with --image_config")
    log(f"SD with --image_config and --text: {n} steps ({sum(sds)} SDS), "
        f"finite, K10-K12 exactly")
    # the pixel oracle with the analytic reference image
    kernels.reset_launch_counts()
    out = port_main.main(
        ["--image", "analytic:two_sphere", "--guidance", "oracle",
         "--backbone", "triplane", "--seed", "0", "--iters",
         str(ORACLE_REF_STEPS), "--dataset_size_train", "4",
         "--eval_interval", "0", "--H", "64", "--W", "64",
         "--dataset_size_test", "1", "--ckpt", "scratch", "--workspace",
         ws + "_oracle"])
    torch.cuda.synchronize()
    towers = {k: v for k, v in kernels.LAUNCHES.items() if v and
              k.startswith(("conv_", "groupnorm_", "attention_"))}
    check(out["all_losses_finite"] and out["grad_ok"] and
          out["known_view_steps"] == 2 and not towers and
          "kv_psnr_final" in out and "psnr_final" in out,
          f"the pixel oracle with a reference image: {out['losses']}, "
          f"{out['known_view_steps']} known-view steps, towers {towers}")
    log(f"the pixel oracle with --image analytic:two_sphere: "
        f"{ORACLE_REF_STEPS} steps (2 known-view), known-view PSNR "
        f"{out['kv_psnr_init']:.3f} -> {out['kv_psnr_final']:.3f} dB, "
        f"oracle PSNR {out['psnr_init']:.3f} -> {out['psnr_final']:.3f} dB")
    return {"step_ms": 1e3 * med, "peak_gib": peak}


# ---------------------------------------------------------------------------
# tooling (slice 11): the DPT of preprocess_image, mesh_to_video,
# r_precision, the viewer and --profile
# ---------------------------------------------------------------------------

DPT_HW = 384
DPT_MAIN_CONV = (1, 96, 96, 256, 256, 3, 1, ((1, 1), (1, 1)), "fp32", False)
TURNTABLE_FRAMES, TURNTABLE_SIZE = 4, 512
PROFILE_FLAGS = ["--iters", "8", "--dataset_size_train", "4",
                 "--dataset_size_test", "1", "--eval_interval", "-1",
                 "--ckpt", "scratch", "--profile"]


def dpt_grad_calls(cfg, hw: int, grad: bool = True):
    """K12's and K10's calls of one DPT at hw² on the meta device, from the
    model's own ``forward_grad`` and, with `grad`, autograd's backward of
    it with every weight and the input wanting gradients → [(kind, shapes
    ...)]: ("conv", x shape, w shape, stride, pads) and ("attn", q shape)
    in the forward; ("dgrad", ...) and ("wgrad", ...) where the backward
    asks a conv's input or weight gradient, ("attn_bwd", q shape) where it
    asks an attention's."""
    import torch

    from dreamfusion_tpu_torch.models import dpt as D
    from dreamfusion_tpu_torch.ops.conv import out_size
    calls = []

    class Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, bias, stride, pads):
            ctx.key = (tuple(x.shape), tuple(w.shape), stride, pads)
            calls.append(("conv", *ctx.key))
            Ho, Wo = out_size(x.shape[1], x.shape[2], w.shape[1], w.shape[2],
                              (stride, stride), pads)
            return x.new_empty(x.shape[0], Ho, Wo, w.shape[0])

        @staticmethod
        def backward(ctx, dy):
            need_x, need_w, need_b = ctx.needs_input_grad[:3]
            x_shape, w_shape = ctx.key[:2]
            if need_x:
                calls.append(("dgrad", *ctx.key))
            if need_w:
                calls.append(("wgrad", *ctx.key))
            return (dy.new_empty(x_shape) if need_x else None,
                    dy.new_empty(w_shape) if need_w else None,
                    dy.new_empty(w_shape[0]) if need_b else None, None, None)

    class Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            calls.append(("attn", tuple(q.shape)))
            return torch.empty_like(q)

        @staticmethod
        def backward(ctx, do):
            calls.append(("attn_bwd", tuple(do.shape)))
            return torch.empty_like(do), torch.empty_like(do), \
                torch.empty_like(do)

    def conv2d(x, w, bias, stride, pads, out_dtype=None):
        return Conv.apply(x, w, bias, stride, tuple(map(tuple, pads)))

    saved = D.conv2d, D.attention
    D.conv2d, D.attention = conv2d, Attention.apply
    try:
        with torch.device("meta"):
            model = D.DPTDepthModel(cfg)
            x = torch.empty(1, hw, hw, 3)
            if grad:
                model.requires_grad_(True)
                x.requires_grad_(True)
            out = model.forward_grad(x) if grad else model(x)
            if grad:
                out.sum().backward()
    finally:
        D.conv2d, D.attention = saved
    return calls


def dpt_calls(cfg, hw: int):
    """K12's and K10's calls of one DPT forward at hw² (``dpt_grad_calls``
    without the backward) → ([(x shape, w shape, stride, pads)], [q
    shape])."""
    calls = dpt_grad_calls(cfg, hw, grad=False)
    return ([c[1:] for c in calls if c[0] == "conv"],
            [c[1] for c in calls if c[0] == "attn"])


def _dpt_routes(torch, calls) -> dict:
    """{route: launches} of recorded DPT calls (``dpt_grad_calls``)."""
    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import conv as K12
    f32 = torch.float32
    out = {}
    for kind, *shapes in calls:
        if kind in ("attn", "attn_bwd"):
            d = shapes[0][-1]
            r = (K10.attention_route(d, f32) if kind == "attn" else
                 K10.attention_bwd_route(d, f32))
        else:
            _, (O, kh, kw, I), st, _ = shapes
            r = (K12.conv_route(f32, I, O, (st, st), kh * kw)
                 if kind == "conv" else
                 K12.dgrad_route(f32, I, O, (st, st), (kh, kw))
                 if kind == "dgrad" else
                 K12.wgrad_route(f32, I, O, (st, st), kh * kw))
        out[r] = out.get(r, 0) + 1
    return out


def dpt_launches(torch, cfg, hw: int = DPT_HW) -> dict:
    """{route: launches} of one DPT forward at hw² (``dpt_calls``)."""
    return _dpt_routes(torch, dpt_grad_calls(cfg, hw, grad=False))


def dpt_grad_launches(torch, cfg, hw: int = DPT_HW) -> dict:
    """{route: launches} of one DPT forward and backward at hw², every
    weight and the input wanting gradients (``dpt_grad_calls``)."""
    return _dpt_routes(torch, dpt_grad_calls(cfg, hw))


def dpt_kernel_phases(torch, results) -> None:
    """K10's fp32 forward at the ViT's [1, 577, 12, 64] against the plain
    version and SDPA (fp32, TF32 off), its lse against the logits'
    logsumexp, and K12 at every distinct fp32 conv shape of a 384² DPT
    forward (and ``FP32_TILED_CONVS``) against the plain version and
    cuDNN (TF32 off), each by CUDA events and in a CUDA graph (``graph_ms``),
    the library's call by the same two timers; the 40 convs' sums."""
    import torch.nn.functional as F

    from dreamfusion_tpu_torch.models.dpt import DPTConfig
    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import kernels

    g = torch.Generator(device="cuda").manual_seed(11)
    randn = _randn_on(torch, g)
    convs, attns = dpt_calls(DPTConfig.depth(), DPT_HW)
    B, N, h, d = attns[0]
    q, k, v = (randn(B, N, h, d, dtype=torch.float32) for _ in range(3))
    scale = d ** -0.5
    kernels.reset_launch_counts()
    o, lse = K10.attention_fwd_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["attention_fwd_fp32"] == 1,
          "the fp32 attention did not take attention_fwd_fp32")
    op = K10.attention_plain(q, k, v, scale)
    # fp32 throughout: sums in another order and the online softmax's
    # rescaling
    err = _close_to("attention_fwd_fp32", o, op, 1e-5, 1e-5)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    lse_err = _close_to("attention_fwd_fp32 lse", lse,
                        torch.logsumexp(logits, dim=-1), 1e-5, 1e-6)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib, lib_g = median_ms(sdpa, 10), graph_ms(sdpa)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    call = lambda: K10.attention_fwd_cuda(q, k, v, scale)
    record_kernel(results, "attention_fwd_fp32", err, median_ms(call, 10),
                  median_ms(lambda: K10.attention_plain(q, k, v, scale), 5),
                  "1e-5 rel + 1e-5 of max", nbytes(q, k, v, o, lse),
                  4 * B * h * N * N * d, "fp32", lib,
                  f" q [{B},{N},{h},{d}] fp32 (lse err {lse_err:.2e}), graph "
                  f"{graph_ms(call):.4f} ms (SDPA {lib_g:.4f})",
                  exps=B * h * N * N, main=True)
    conv_rows(torch, results, FP32_TILED_CONVS, randn)
    rows, seen = [], set()
    for (B, H, W, I), (O, kh, _, _), st, pads in convs:
        row = (B, H, W, I, O, kh, st, pads, "fp32", False)
        if row not in seen:
            seen.add(row)
            rows.append(row)
    times = {}
    # the JSON entry: the 96² RCU conv (5 a forward, the most time)
    conv_rows(torch, results, rows, randn, graph=True, times=times,
              main=[DPT_MAIN_CONV])
    n = {r: sum(1 for (x, w, st, p) in convs
                if (*x, w[0], w[1], st, p, "fp32", False) == r)
         for r in rows}
    total, lib, total_g, lib_g = (sum(times[r][i] * n[r] for r in rows)
                                  for i in range(4))
    ratio = {r: times[r][2] / times[r][3] for r in rows}
    worst = max(rows, key=ratio.get)
    log(f"DPT K12: {len(convs)} fp32 convs a 384² forward over {len(rows)} "
        f"shapes, {total:.3f} ms of kernels against cuDNN's {lib:.3f} ms "
        f"(events); graph {total_g:.3f} ms against {lib_g:.3f}; the "
        f"largest ratio to cuDNN's graph ms {ratio[worst]:.3f} at "
        f"{worst[:8]}")


def dpt_device_split(torch, run) -> dict:
    """One call of `run` (a DPT forward) under ``torch.profiler``: its
    kernels' summed device ms, by group (K12's tiled route and its split-K
    reduce, K10's fp32 forward, cuBLAS's GEMMs) and the three largest
    other kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    groups = {"K12": 0.0, "K10": 0.0, "gemm": 0.0, "other": 0.0}
    other = {}
    for name, ms in by_name.items():
        key = ("K12" if "conv_fp32_tiled" in name or "splitk" in name else
               "K10" if "attn_fwd_fp32" in name else
               "gemm" if "gemm" in name.lower() else "other")
        groups[key] += ms
        if key == "other":
            other[name[:50]] = ms
    top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
    return {"device_ms": sum(groups.values()), **groups,
            "other_top": {k: round(v, 4) for k, v in top}}


def random_dpt_state(torch, model, seed: int):
    """Random weights for `model` in place, from the seed: kernels N(0,
    1/fan_in), norm weights 1, biases 0, the tokens N(0, 0.02²)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("cls_token", "pos_embed")):
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        * 0.02)
            elif p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        * fan_in ** -0.5)
            elif "norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


def write_omnidata_ckpt(torch, model, path: str) -> None:
    """`model`'s weights as an omnidata checkpoint holds them: conv
    [O, I, kh, kw], under ``state_dict`` and the Lightning ``model.``
    prefix, with the dead refinenet4.resConfUnit1 unit."""
    sd = {}
    for k, v in model.state_dict().items():
        v = v.detach().cpu()
        sd["model." + k] = v.permute(0, 3, 1, 2).contiguous() \
            if v.dim() == 4 else v
    F_ = model.cfg.features
    for c in (1, 2):
        sd[f"model.scratch.refinenet4.resConfUnit1.conv{c}.weight"] = \
            torch.zeros(F_, F_, 3, 3)
        sd[f"model.scratch.refinenet4.resConfUnit1.conv{c}.bias"] = \
            torch.zeros(F_)
    torch.save({"state_dict": sd}, path)


def dpt_path(torch, kernels, png, ws, smi_line) -> dict:
    """The DPT at full width (vitb_rn50_384, random weights from a seed) as
    ``preprocess_image`` runs it, on the reference PNG: depth from an
    omnidata ``.ckpt`` (``convert_dpt`` on the fly), normals from the
    ``.npz`` that ``utils.convert --kind dpt`` writes from another; each
    run through ``run_omnidata`` with the counters reset just before and
    K10/K12 exactly as ``dpt_launches``; the sidecars written where
    ``load_ref_images`` reads them; the forward's wall time; the card's
    output against the CPU's at 128² → {"depth_ms", "normal_ms",
    "launches": the depth run's counts}."""
    import numpy as np

    import shutil

    from dreamfusion_tpu_torch import preprocess_image as PI
    from dreamfusion_tpu_torch.config import Config
    from dreamfusion_tpu_torch.models import dpt as D
    from dreamfusion_tpu_torch.training.image_data import load_ref_images
    from dreamfusion_tpu_torch.utils import convert as PC
    os.makedirs(ws, exist_ok=True)
    rgb = PI.read_rgb(png)
    out, want = {}, None
    for task, seed in (("depth", 31), ("normal", 32)):
        cfg = getattr(D.DPTConfig, task)()
        with torch.device("cuda"):
            model = D.DPTDepthModel(cfg)
        random_dpt_state(torch, model, seed)
        ckpt = os.path.join(ws, f"omnidata_dpt_{task}_v2.ckpt")
        write_omnidata_ckpt(torch, model, ckpt)
        if task == "normal":
            PC.main(["--kind", "dpt", "--src", ckpt, "--out", ws])
            ckpt = os.path.join(ws, "dpt_normal.npz")
        want = dpt_launches(torch, cfg)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        pred = PI.run_omnidata(rgb, ckpt, task)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check(got == want, f"DPT {task}: launches {got}, want {want}")
        out.setdefault("launches", got)
        shape = rgb.shape[:2] if task == "depth" else (*rgb.shape[:2], 3)
        # clamped to [0, 1], then resized: rows of weights that sum to 1
        # within an ulp
        check(pred.shape == shape and np.isfinite(pred).all() and
              pred.min() >= 0 and pred.max() <= 1 + 1e-6,
              f"DPT {task}: output {pred.shape} in [{pred.min()}, "
              f"{pred.max()}]")
        loaded = D.load_dpt(ckpt, cfg, "cuda")
        sd = loaded.state_dict()
        check(all(torch.equal(sd[k], v) for k, v in
                  model.state_dict().items()),
              f"DPT {task}: {os.path.basename(ckpt)} did not load the "
              f"weights bit for bit")
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.time()
            PI.dpt_predict(loaded, rgb, task)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        out[f"{task}_ms"] = 1e3 * statistics.median(times[1:])
        split = dpt_device_split(
            torch, lambda: PI.dpt_predict(loaded, rgb, task))
        top = split.pop("other_top")
        log(f"DPT {task}, one forward under the profiler: device "
            f"{split['device_ms']:.3f} ms of kernels against "
            f"{out[f'{task}_ms']:.2f} ms of wall; ms by group "
            f"{_rounded(split)}, the largest others {top}")
        log(f"DPT {task} at {DPT_HW}² (vitb_rn50_384, "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
            f"parameters, random): run_omnidata {load_s:.2f} s with the "
            f"load from {os.path.basename(ckpt)}; the forward with its "
            f"resizes {out[f'{task}_ms']:.2f} ms (median of 3, "
            f"synchronised); launches {got}; output in [{pred.min():.4f}, "
            f"{pred.max():.4f}]; on {smi_line}")
        if task == "depth":
            # the sidecars beside a copy of the reference, as
            # preprocess_image writes them and load_ref_images reads them
            ref = os.path.join(ws, "ref_rgba.png")
            shutil.copyfile(png, ref)
            PI.write_png(ref.replace("_rgba", "_depth"),
                         (pred * 255).astype(np.uint8))
            PI.write_png(ref.replace("_rgba", "_normal"),
                         (PI.normal_from_depth(pred) * 255).astype(np.uint8))
            refs = load_ref_images(Config(image=ref), 64, 64)
            check(refs.depth is not None and refs.normal is not None,
                  "load_ref_images did not read the DPT's sidecars")
            # the card against the CPU at 128² on the raw head (no relu)
            raw = D.DPTDepthModel(D.DPTConfig(num_channels=1,
                                              non_negative=False))
            raw.load_state_dict({k: v.cpu() for k, v in sd.items()})
            x = torch.rand(1, 128, 128, 3, generator=torch.Generator(
            ).manual_seed(5)) * 2 - 1
            y_cpu = raw(x)
            y_gpu = raw.cuda()(x.cuda()).cpu()
            err = _close_to("DPT 128² card vs CPU", y_gpu, y_cpu, 1e-3, 1e-3)
            log(f"DPT depth at 128² on the card against the CPU's plain "
                f"versions: max abs err {err:.3e} of a largest "
                f"{float(y_cpu.abs().max()):.3e} (tolerance 1e-3 rel + 1e-3 "
                f"of max)")
        del model, loaded
    torch.cuda.empty_cache()
    return out


def turntable_phase(torch, kernels, mesh_path, ws, smi_line) -> dict:
    """``evaluation.mesh_to_video`` on the stage-1 mesh at 512², a few
    frames, the counters reset just before: K7 exactly (a ``raster_fwd``
    and an ``interpolate_fwd`` a frame), finite frames with the mesh in
    them → {"frame_s": a frame's render, synchronised; "cli_s": the CLI's
    wall, the OBJ and texture reads and the frames' writes included}."""
    import numpy as np

    from dreamfusion_tpu_torch.evaluation import mesh_to_video as MV
    from dreamfusion_tpu_torch.mesh.export import read_obj
    from dreamfusion_tpu_torch.utils.image import load_image
    os.makedirs(ws, exist_ok=True)
    args = ["--mesh", mesh_path, "--out", os.path.join(ws, "turntable.mp4"),
            "--frames", str(TURNTABLE_FRAMES), "--size",
            str(TURNTABLE_SIZE)]
    MV.main(args[:5] + ["1", "--size", "64"])          # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    path = MV.main(args)
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    want = {"raster_fwd": TURNTABLE_FRAMES,
            "interpolate_fwd": TURNTABLE_FRAMES}
    check(got == want, f"mesh_to_video: launches {got}, want {want}")
    frame = load_image(path) if path.endswith(".png") else None
    if frame is not None:
        check(frame.shape == (TURNTABLE_SIZE, TURNTABLE_SIZE, 3) and
              np.isfinite(frame).all() and (frame < 0.99).any(),
              f"mesh_to_video: frame {frame.shape}, all white or not finite")
    verts, tris, uv, tex_path = read_obj(mesh_path)
    tex = load_image(tex_path)[..., :3]
    torch.cuda.synchronize()
    t0 = time.time()
    MV.render_turntable(verts, tris, uv, tex, frames=TURNTABLE_FRAMES,
                        size=TURNTABLE_SIZE)
    torch.cuda.synchronize()
    frame_s = (time.time() - t0) / TURNTABLE_FRAMES
    log(f"mesh_to_video: {TURNTABLE_FRAMES} frames at {TURNTABLE_SIZE}² of "
        f"the stage-1 mesh ({len(tris)} faces): the CLI {cli_s:.3f} s -> "
        f"{os.path.basename(path)}, a frame's render {1e3 * frame_s:.2f} "
        f"ms (synchronised, the copy to the host included); launches "
        f"{got}; on {smi_line}")
    return {"frame_s": frame_s, "cli_s": cli_s}


def r_precision_phase(torch, kernels, stage1_ws, ws) -> dict:
    """``evaluation.r_precision`` at full width (ViT-B/16, random weights
    from the seed) on the stage-1 run's validation renders with two
    distractors: one ``conv_fwd_mma`` for the batch, no K10 (the CLIP
    towers' attention is plain, as JAX's), finite numbers."""
    from dreamfusion_tpu_torch.evaluation import r_precision as RP
    os.makedirs(ws, exist_ok=True)
    dis = os.path.join(ws, "distractors.txt")
    with open(dis, "w") as f:
        f.write("a red car\na wooden chair\n")
    images = os.path.join(stage1_ws, "validation")
    n = len([f for f in os.listdir(images) if f.endswith(".png")])
    kernels.reset_launch_counts()
    out = RP.main(["--images", images, "--text", "a hamburger",
                   "--distractors", dis])
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(got == {"conv_fwd_mma": 1}, f"r_precision: launches {got}")
    check(out["n_images"] == n and out["n_prompts"] == 3 and
          math.isfinite(out["mean_clip_similarity"]) and
          0.0 <= out["r_precision"] <= 1.0, f"r_precision: {out}")
    log(f"r_precision on {n} renders (random ViT-B/16): {out}")
    return out


def viewer_phase(torch, port_main, kernels, stage1_ws, smi_line) -> float:
    """One 256² frame of the browser viewer on the stage-1 run (its
    config.json and latest checkpoint), fetched over HTTP on localhost:
    a PNG of the frame, K1-K4 launched → seconds the request took."""
    import threading
    import urllib.request

    from dreamfusion_tpu_torch import viewer as V
    from dreamfusion_tpu_torch.config import load_config_json
    from dreamfusion_tpu_torch.utils.image import decode_png
    cfg = load_config_json(os.path.join(stage1_ws, "config.json"))
    trainer, state, gen = port_main.build_run(
        dataclasses.replace(cfg, test=True), torch.device("cuda"), False,
        log=lambda *a: None)
    state, loaded = trainer.load_checkpoint(state, "latest")
    check(loaded, "viewer: no stage-1 checkpoint")
    srv = V.make_server(V.ViewerState(trainer, state, gen), False, 0,
                        "127.0.0.1")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        page = urllib.request.urlopen(url + "/", timeout=60).read()
        check(b"<canvas" in page, "viewer: no page")
        urllib.request.urlopen(url + "/render?size=64", timeout=120).read()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        body = urllib.request.urlopen(
            url + "/render?polar=70&azimuth=30&size=256&shading=lambertian",
            timeout=120).read()
        sec = time.time() - t0
    finally:
        srv.shutdown()
        srv.server_close()
        th.join()
    img = decode_png(body)
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(img.shape == (256, 256, 3) and img.min() < 250,
          f"viewer: frame {img.shape}, all white")
    for k in ("triplane_fwd", "march_rays", "composite_fwd"):
        check(got.get(k, 0) > 0, f"viewer: the frame never launched {k}")
    log(f"viewer: a 256² lambertian frame over HTTP in {1e3 * sec:.1f} ms "
        f"(the PNG encode included); launches {got}; on {smi_line}")
    return sec


def profile_phase(port_main, ws) -> dict:
    """``main --profile`` on the flagship oracle, 8 steps with epochs of
    4: the first epoch's Chrome trace, with device time in it."""
    summary = port_main.main(FLAGSHIP + PROFILE_FLAGS + ["--workspace", ws])
    prof = summary.get("profile") or {}
    path = prof.get("trace", "")
    check(os.path.exists(path) and os.path.getsize(path) > 0,
          f"--profile wrote no trace ({path})")
    with open(path) as f:
        json.load(f)
    check(sum(prof["device_ms"].values()) > 0,
          f"--profile: no device time in the trace: {prof['device_ms']}")
    log(f"--profile: {path} ({os.path.getsize(path) / 1e6:.1f} MB), device "
        f"ms by group {_rounded(prof['device_ms'])}")
    return prof


def tooling_phases(torch, port_main, kernels, results, stage1_ws, mesh_path,
                   png, smi_line) -> dict:
    """Slice 11: the DPT's kernel rows and path, the turntable, r_precision,
    the viewer and --profile → the DPT path's launches."""
    build = os.path.join(ROOT, "build")
    t0 = time.time()
    dpt_kernel_phases(torch, results)
    t_rows = time.time() - t0
    dpt_ms = dpt_path(torch, kernels, png,
                      os.path.join(build, "chip_smoke_dpt"), smi_line)
    launches = dpt_ms.pop("launches")
    turn = turntable_phase(torch, kernels, mesh_path,
                           os.path.join(build, "chip_smoke_turntable"),
                           smi_line)
    r_precision_phase(torch, kernels, stage1_ws,
                      os.path.join(build, "chip_smoke_rprec"))
    view_s = viewer_phase(torch, port_main, kernels, stage1_ws, smi_line)
    profile_phase(port_main, os.path.join(build, "chip_smoke_profile_ws"))
    log(f"tooling phases in {time.time() - t0:.1f} s (the DPT's kernel rows "
        f"{t_rows:.1f} s): DPT ms {_rounded(dpt_ms)}, turntable s "
        f"{_rounded(turn)}, s a viewer frame {view_s:.4f}; on {smi_line}")
    return launches


# ---- the towers' backward to their weights (slice 12) ----------------------

# The new kernels of the towers' backward: K12's weight gradient, K11's
# backward with the affine gradients, K10's flash-style backward at the
# UNets' head dims (the VAE's d = 512 backward is the SD step's
# attention_bwd_wgmma)
GRAD_KERNELS = ("conv_wgrad_wgmma", "conv_wgrad_wgmma_i8",
                "conv_wgrad_fp32_tiled",
                "groupnorm_bwd_resident_affine", "groupnorm_bwd_stream_affine",
                "attention_bwd_flash", "attention_bwd_flash_d40",
                "attention_bwd_flash_d80", "attention_bwd_flash_d160")
# conv_wgrad_mma's shapes (no tower's: bf16 with 8 < I, I % 64 != 0, or a
# narrow input at stride 2), in record_towers' full layout; held to the
# plain version as the towers' rows, its kernels-line row reads 0 launches
MMA_WGRAD_CONVS = [(2, 33, 31, 24, 40, 3, 1, ((1, 1), (1, 1)), "bf16"),
                   (1, 17, 15, 3, 16, 3, 2, ((1, 1), (1, 1)), "bf16")]
# tower → (tower_forward's prior, part): each runs at the SD step's shapes
# (the UNets at CFG batch 2, SD's on 64² latents and 77 text keys, zero123's
# at K = 1 on 32² latents with one key; the VAE encoder at 512²)
GRAD_TOWERS = {"SD 2.1 UNet": ("SD", "unet"), "SD 1.5 UNet": ("SD15", "unet"),
               "zero123 UNet": ("zero123", "unet"),
               "SD VAE encoder": ("SD", "encode")}
# the rows whose numbers fill the kernels' JSON entries: the UNet's 64²
# level (and its fp32 conv_out), the VAE's conv_in; the first attention of
# each head dim (the UNets' 64² self-attention)
GRAD_MAIN_CONVS = {(2, 64, 64, 320, 320, 3, 1, ((1, 1), (1, 1)), "bf16"),
                   (2, 64, 64, 320, 4, 3, 1, ((1, 1), (1, 1)), "fp32"),
                   (1, 512, 512, 3, 128, 3, 1, ((1, 1), (1, 1)), "bf16")}


def wgrad_rows(torch, results, convs, randn, rows_json):
    """K12's weight gradient (by route) at each recorded conv shape
    (``record_towers``' full calls) against the transposed shifted einsum
    in fp32 (``conv2d_wgrad_plain``), beside cuDNN's weight gradient alone
    (``aten.convolution_backward`` with the weight's output mask, TF32 off);
    event and graph ms, bound: the forward's operations."""
    import torch.nn.functional as F

    from dreamfusion_tpu_torch.ops import conv as K12
    from dreamfusion_tpu_torch.ops import kernels

    for row in convs:
        B, H, W, I, O, k, st, pads, dt = row
        fp32 = dt == "fp32"
        dtype = torch.float32 if fp32 else torch.bfloat16
        route = K12.wgrad_route(dtype, I, O, (st, st), k * k)
        where = (f" [{B},{H},{W},{I}->{O}] {k}x{k} s{st} pad {pads} {dt} "
                 f"wgrad")
        Ho, Wo = K12.out_size(H, W, k, k, (st, st), pads)
        x = randn(B, H, W, I, dtype=dtype)
        dy = randn(B, Ho, Wo, O, dtype=dtype)
        wshape = (O, k, k, I)
        call = lambda: K12.conv2d_wgrad_cuda(x, dy, wshape, (st, st), pads,
                                             dtype)
        kernels.reset_launch_counts()
        dw = call()
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[route] == 1 and
              sum(kernels.LAUNCHES.values()) == 1, f"{where}: not on {route}")
        check(torch.equal(dw, call()), f"{where}: two launches differ")
        plain = lambda: K12.conv2d_wgrad_plain(x, dy, wshape, (st, st), pads)
        # bf16: one rounding of fp32 sums taken in another order
        err = _close_to(route, dw, plain(), 1e-5 if fp32 else 2 ** -7,
                        1e-4 if fp32 else 2 ** -8)
        sym = pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]
        xc = x.permute(0, 3, 1, 2)
        xl = xc if sym else F.pad(xc, (*pads[1], *pads[0]))
        wc = torch.empty(O, I, k, k, device="cuda", dtype=dtype)
        dyc = dy.permute(0, 3, 1, 2)
        pad = [pads[0][0], pads[1][0]] if sym else [0, 0]
        lib_call = lambda: torch.ops.aten.convolution_backward(
            dyc, xl, wc, None, [st, st], pad, [1, 1], False, [0, 0], 1,
            [False, True, False])
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib = median_ms(lib_call, 10)
            lib_g = graph_ms(lib_call, 5, 3)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        ms, k_g = median_ms(call, 10), graph_ms(call)
        flops = 2 * B * Ho * Wo * O * k * k * I
        n_bytes = nbytes(x, dy, dw)
        record_kernel(results, route, err, ms, median_ms(plain, 3),
                      "1e-5 rel + 1e-4 of max" if fp32 else
                      "1 bf16 ulp + 2^-8 of max", n_bytes, flops,
                      "fp32" if fp32 else "bf16", lib,
                      where + f", graph {k_g:.4f} ms (cuDNN {lib_g:.4f})",
                      main=row in GRAD_MAIN_CONVS or
                      tuple(row) == DPT_MAIN_CONV[:9])
        rows_json.append({"kernel": route, "row": [B, H, W, I, O, k, st,
                                                   pads, dt],
                          "ms": ms, "graph_ms": k_g, "library_ms": lib,
                          "library_graph_ms": lib_g,
                          "bound_ms": bound(n_bytes, flops, "fp32" if fp32
                                            else "bf16")[0]})


def groupnorm_affine_rows(torch, results, gns, randn, rows_json):
    """K11's backward with the affine gradients at each recorded norm shape
    (bf16 x, dy and weights, the towers' dtypes): dscale and dbias against
    autograd of the plain version in fp32, dx bit for bit the frozen
    route's; beside ``aten.native_group_norm_backward`` with the affine
    mask (NCHW, no SiLU)."""
    from dreamfusion_tpu_torch.ops import groupnorm as K11
    from dreamfusion_tpu_torch.ops import kernels

    bf = torch.bfloat16
    sms = kernels.sm_count(torch.device("cuda"))
    for B, H, W, C, eps, silu, dt in gns:
        check(dt == "bf16", f"a {dt} group norm in the towers")
        G = K11.groups_for(C)
        x = randn(B, H, W, C, scale=3.0)
        wt = (1 + randn(C, dtype=torch.float32) * 0.1).to(bf)
        bs = randn(C, scale=0.1)
        dy = randn(B, H, W, C)
        route = K11.group_norm_route((B, H, W, C), bf, True, G, sms)
        name = route.name + "_affine"
        where = (f" [{B},{H},{W},{C}] Cg {C // G}, slab {route.slab}, "
                 f"cluster {route.cluster}{' + SiLU' if silu else ''} "
                 f"backward + affine")
        _, stats = K11.group_norm_fwd_cuda(x, wt, bs, G, eps, silu)
        call = lambda: K11.group_norm_bwd_cuda(x, wt, bs, stats, dy, G, silu,
                                               affine=True)
        kernels.reset_launch_counts()
        dx, dw, db = call()
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[name] == 1 and
              sum(kernels.LAUNCHES.values()) == 1, f"{where}: not on {name}")
        check(torch.equal(dx, K11.group_norm_bwd_cuda(x, wt, bs, stats, dy,
                                                      G, silu)),
              f"{where}: dx is not the frozen route's")

        def plain():
            ins = [t.float().requires_grad_() for t in (x, wt, bs)]
            return torch.autograd.grad(K11.group_norm_plain(
                *ins, G, eps, silu), ins, dy.float())

        want = plain()
        err = max(_close_to(name, dw, want[1], 2 ** -7, 2 ** -8),
                  _close_to(name, db, want[2], 2 ** -7, 2 ** -8))
        xc = x.permute(0, 3, 1, 2).contiguous()
        dyc = dy.permute(0, 3, 1, 2).contiguous()
        _, mean, rstd = torch.ops.aten.native_group_norm(
            xc, wt, bs, B, C, H * W, G, eps)
        lib_call = lambda: torch.ops.aten.native_group_norm_backward(
            dyc, xc, mean, rstd, wt, B, C, H * W, G, [True, True, True])
        lib, lib_g = median_ms(lib_call, 10), graph_ms(lib_call, 5, 3)
        ms, k_g = median_ms(call, 10), graph_ms(call)
        n_bytes = nbytes(x, dy, wt, bs, dx, dw, db)
        record_kernel(results, name, err, ms, median_ms(plain, 3),
                      "1 bf16 ulp + 2^-8 of max", n_bytes, 24 * x.numel(),
                      "fp32", lib,
                      where + f", graph {k_g:.4f} ms (library {lib_g:.4f})")
        rows_json.append({"kernel": name, "row": [B, H, W, C, eps, silu],
                          "ms": ms, "graph_ms": k_g, "library_ms": lib,
                          "library_graph_ms": lib_g,
                          "bound_ms": bound(n_bytes, 24 * x.numel(),
                                            "fp32")[0]})


def sdpa_backward(torch, q, k, v, do):
    """SDPA's backward on [B, N, h, d] tensors as one library call: its
    autograd node (the kernel PyTorch picks for these inputs: flash or
    memory-efficient), from a graph built once here, called directly in
    this thread, so that a CUDA graph can capture it → (call, the node's
    name)."""
    import torch.nn.functional as F
    qkvt = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    node = F.scaled_dot_product_attention(*qkvt).grad_fn
    dot = do.transpose(1, 2)
    if not node.name().startswith("ScaledDotProduct"):
        return None, node.name()       # the math fallback: not one call

    def call():
        with torch.no_grad():          # no graph of the gradients' own
            return node(dot)
    return call, node.name()


def attention_bwd_rows(torch, results, attns, randn, rows_json):
    """K10's backward at each recorded attention shape of d = 40, 64, 80,
    160 on JAX's branch (bf16(q·scale) on the chunked one) against the
    kernels' arithmetic in torch (``attention_bwd_plain``), two launches
    bit for bit; beside SDPA's backward (autograd by events; its node alone
    in a CUDA graph); over one key dQ and dK are 0 in exact arithmetic and
    are held to dV's largest entry."""
    import torch.nn.functional as F

    from dreamfusion_tpu_torch.ops import attention as K10
    from dreamfusion_tpu_torch.ops import kernels

    for B, N, M, h, d in attns:
        rq = K10.chunked_branch(B, N, M, h)
        route = K10.attention_bwd_route(d)
        where = (f" q [{B},{N},{h},{d}] kv [{B},{M},{h},{d}]"
                 f"{' (chunked branch: bf16(q·scale))' if rq else ''} "
                 f"backward")
        q, k, v, do = (randn(B, n, h, d) for n in (N, M, M, N))
        scale = d ** -0.5
        o, lse = K10.attention_fwd_cuda(q, k, v, scale, rq)
        call = lambda: K10.attention_bwd_cuda(q, k, v, o, lse, do, scale, rq)
        kernels.reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[route] == 1 and
              sum(kernels.LAUNCHES.values()) == 1, f"{where}: not on {route}")
        check(all(torch.equal(a, b) for a, b in zip(got, call())),
              f"{where}: two launches differ")
        plain = lambda: K10.attention_bwd_plain(q, k, v, o, do, scale, rq)
        want = plain()
        if M == 1:
            ref = float(want[2].float().abs().max())
            for a in got[:2]:
                check(float(a.float().abs().max()) <= 2 ** -8 * ref,
                      f"{where}: dQ or dK over one key not 0")
            err = _close_to(route, got[2], want[2], 2 ** -7, 2 ** -8)
        else:
            err = max(_close_to(route, a, b, 2 ** -7, 2 ** -8)
                      for a, b in zip(got, want))
        qkvt = [t.transpose(1, 2).detach().requires_grad_()
                for t in (q, k, v)]
        ot, dot = F.scaled_dot_product_attention(*qkvt), do.transpose(1, 2)
        lib = median_ms(lambda: torch.autograd.grad(ot, qkvt, dot,
                                                    retain_graph=True), 10)
        lib_call, lib_node = sdpa_backward(torch, q, k, v, do)
        lib_g = lib_call and graph_ms(lib_call, 5, 3)
        ms, k_g = median_ms(call, 10), graph_ms(call)
        n_bytes = nbytes(q, k, v, o, lse, do, *got)
        flops, exps = 10 * B * h * N * M * d, B * h * N * M
        record_kernel(results, route, err, ms, median_ms(plain, 3),
                      "1 bf16 ulp + 2^-8 of max", n_bytes, flops, "bf16",
                      lib, where + f", graph {k_g:.4f} ms (SDPA's "
                      f"{lib_node} {lib_g})", exps=exps)
        rows_json.append({"kernel": route, "row": [B, N, M, h, d],
                          "ms": ms, "graph_ms": k_g, "library_ms": lib,
                          "library_graph_ms": lib_g,
                          "library_node": lib_node,
                          "bound_ms": bound(n_bytes, flops, "bf16",
                                            exps)[0]})


def _random_tower(torch, module, g):
    """Random weights from `g`: norm scales (the 1-D weights) 1 + N(0,
    0.1²), every other parameter N(0, 0.02²)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g, device="cuda")
            norm = p.ndim == 1 and name.endswith("weight")
            p.copy_(1 + 0.1 * r if norm else 0.02 * r)


def tower_grad_run(torch, kernels, what, prior, part, want):
    """One full-width tower on the card, random weights from seed 0, every
    parameter (the VAE's: its encoder's and quant_conv's) and the input
    wanting gradients: a forward and the backward of a seeded cotangent,
    the counters reset just before; every such parameter's gradient and
    the input's finite, K10-K12 launched exactly as `want` (None: not
    checked, for another checkout's routes); then two more iterations for
    the synchronised walls → {fwd_ms, bwd_ms, peak_gib}."""
    from dreamfusion_tpu_torch.models.unet import (UNet2DCondition,
                                                   UNetConfig)
    from dreamfusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("cuda"):
        if part == "unet":
            cfg = {"SD": UNetConfig.sd21, "SD15": UNetConfig.sd15,
                   "zero123": UNetConfig.zero123}[prior]()
            net = UNet2DCondition(cfg)
            trained = [net]
        else:
            net = AutoencoderKL(VAEConfig.sd())
            trained = [net.encoder, net.quant_conv]
    params = [p for m in trained for p in m.parameters()]
    for m in trained:
        _random_tower(torch, m, g)
        m.requires_grad_(True)
    if part == "unet":
        ls = 32 if prior == "zero123" else 64
        x = torch.randn(2, ls, ls, cfg.in_channels, generator=g,
                        device="cuda")
        t = torch.tensor([20, 731], device="cuda")
        ctx = torch.randn(2, 1 if prior == "zero123" else 77,
                          cfg.context_dim, generator=g, device="cuda")
        fwd = lambda xr: net(xr, t, ctx)
    else:
        x = torch.tanh(torch.randn(1, 512, 512, 3, generator=g,
                                   device="cuda"))

        def fwd(xr):
            m = net.encode(xr)
            return torch.cat([m.mean, m.logvar], -1)

    walls = []
    for it in range(3):
        for p in params:
            p.grad = None
        xr = x.clone().requires_grad_()
        torch.cuda.synchronize()
        if it == 0:
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fwd(xr)
        if it == 0:
            ct = torch.randn(out.shape, generator=g, device="cuda")
        loss = (out.float() * ct).sum()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        walls.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        if it == 0:
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            launched = {k: v for k, v in kernels.LAUNCHES.items()
                        if v and k.startswith(("conv_", "groupnorm_",
                                               "attention_"))}
            check(want is None or launched == want, f"{what}: launched "
                  f"{launched}, not the towers' {want}")
            bad = [n for m in trained for n, p in m.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad)
                                                 .all())]
            check(not bad, f"{what}: {len(bad)} parameters without a finite "
                  f"gradient, e.g. {bad[:3]}")
            check(xr.grad is not None and bool(torch.isfinite(xr.grad).all())
                  and bool(torch.isfinite(out).all()),
                  f"{what}: the output or the input's gradient not finite")
    n_par = sum(p.numel() for p in params)
    del net, trained, params
    torch.cuda.empty_cache()
    fwd_ms = statistics.median(w[0] for w in walls)
    bwd_ms = statistics.median(w[1] for w in walls)
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "first_bwd_ms": walls[0][1],
            "peak_gib": peak, "params": n_par}


def tower_backward_phase(torch, kernels, results, smi_line) -> dict:
    """The towers' backward to their weights at full width: K12's wgrad,
    K11's affine gradients and K10's backward at d = 40, 64, 80, 160 held
    to their plain versions at every distinct shape the four towers launch
    them at (recorded on the meta device, ``record_towers``), and
    ``conv_wgrad_mma`` at ``MMA_WGRAD_CONVS``, with event and graph ms,
    bound and the library call's ms, logged as one JSON line; then each
    tower's forward and backward on the card (``tower_grad_run``),
    launches exactly as ``tower_launches`` derives them → the new kernels'
    launches (and ``conv_wgrad_mma``'s, none) summed over the four
    towers."""
    randn = _randn_on(torch, torch.Generator(device="cuda").manual_seed(7))
    t0 = time.time()
    convs, gns, attns = [], [], []
    for prior, part in GRAD_TOWERS.values():
        tower_forward(torch, kernels, prior, part)
        for call in _TOWER_FULL[(prior, part, 1)]:
            kind, shape = call[0], call[1:]
            lst = {"conv": convs, "gn": gns, "attn": attns}[kind]
            if shape not in lst and (kind != "attn" or shape[-1] in
                                     (40, 64, 80, 160)):
                lst.append(shape)
    rows = []
    wgrad_rows(torch, results, convs + MMA_WGRAD_CONVS, randn, rows)
    groupnorm_affine_rows(torch, results, gns, randn, rows)
    attention_bwd_rows(torch, results, attns, randn, rows)
    log(f"tower backward rows: {len(convs)} wgrad, {len(gns)} norm and "
        f"{len(attns)} attention shapes in {time.time() - t0:.1f} s")
    log(f"tower backward rows {json.dumps(rows)}")
    wgrad_of = {tuple(r["row"]): r for r in rows
                if r["kernel"].startswith("conv_wgrad_")}
    for what, (prior, part) in GRAD_TOWERS.items():
        sums, by_route = [0.0] * 5, {}
        calls = [c[1:] for c in _TOWER_FULL[(prior, part, 1)]
                 if c[0] == "conv"]
        for c in calls:
            r = wgrad_of[c]
            by_route[r["kernel"]] = by_route.get(r["kernel"], 0) + 1
            for i, key in enumerate(("ms", "graph_ms", "bound_ms",
                                     "library_ms", "library_graph_ms")):
                sums[i] += r[key]
        log(f"{what} wgrad: its {len(calls)} convs summed ({by_route}): "
            f"event {sums[0]:.3f} ms, graph {sums[1]:.3f} ms against a bound "
            f"of {sums[2]:.3f} ms; cuDNN event {sums[3]:.3f}, graph "
            f"{sums[4]:.3f} ms; on {smi_line}")
    total = {}
    walls = {}
    for what, (prior, part) in GRAD_TOWERS.items():
        want = tower_launches(torch, kernels, prior,
                              **({"unet": 1, "unet_grad": 1} if part ==
                                 "unet" else {"encode": 1,
                                              "encode_grad": 1}))
        t1 = time.time()
        run = tower_grad_run(torch, kernels, what, prior, part, want)
        walls[what] = run
        total = add_counts(total, {k: want.get(k, 0) for k in
                                   GRAD_KERNELS + ("conv_wgrad_mma",)})
        log(f"{what} backward to its {run['params'] / 1e6:.2f}M weights: "
            f"forward {run['fwd_ms']:.2f} ms, backward {run['bwd_ms']:.2f} "
            f"ms (median of 3, synchronised; the first "
            f"{run['first_bwd_ms']:.2f}), peak {run['peak_gib']:.2f} GiB; "
            f"launches {want} ({time.time() - t1:.1f} s; {smi_line})")
    log(f"tower backward walls {json.dumps(walls)}")
    for k in GRAD_KERNELS:
        check(total.get(k, 0) > 0, f"{k}: no tower launched it")
    check(total["conv_wgrad_mma"] == 0, "a tower's wgrad on mma.sync")
    return total


# ---- the DPT's backward and the encoders' second derivative (slice 13) -----

# The kernels of the DPT's backward: K10's fp32 backward, K12's tiled fp32
# input and weight gradients (the latter also the towers' conv_outs', step
# 15; its launches here are the DPT's)
DPT_GRAD_KERNELS = ("attention_bwd_fp32", "conv_dgrad_fp32_tiled",
                    "conv_wgrad_fp32_tiled")


def encoder_hessian_rows(torch, results, x01, keep, where, rows_json):
    """K1's and K6's ``_dx`` backwards with cotangents on the jacobian too
    (the second derivative into the positions; the planes' or table's
    gradient from all four) at positions `x01` [N, 3], on the flagship's
    3x256²x16 planes and L4C8 table, bf16 cotangents (zero on the rows
    `keep` leaves out), each against its plain version, beside the same
    launch with the features' cotangent alone (the frozen path); no
    library call computes it.  Bound: bytes (the cotangents, the outputs
    and the table rows the positions touch)."""
    from dreamfusion_tpu_torch.config import Config
    from dreamfusion_tpu_torch.ops import hashgrid as K6
    from dreamfusion_tpu_torch.ops import kernels
    from dreamfusion_tpu_torch.ops import triplane as K1
    from dreamfusion_tpu_torch.training.trainer import grid_spec_of

    dev = x01.device
    g = torch.Generator(device=dev).manual_seed(9)
    N = x01.shape[0]
    k = keep[:, None].to(torch.float32)
    cfg = Config()
    R, C = cfg.triplane_resolution, cfg.triplane_channels
    planes = torch.randn(3, R, R, C, device=dev, generator=g) * 0.1
    spec = grid_spec_of(cfg)
    L, Cg = spec.num_levels, spec.level_dim
    table = (torch.rand(spec.table_size, Cg, device=dev, generator=g)
             - 0.5) * 0.2
    cases = {
        "triplane_bwd_dx": (
            3 * C, lambda gf, gj: K1.triplane_bwd_dx_cuda(x01, planes, gf, gj),
            lambda gf, gj: K1.triplane_bwd_dx_plain(x01, planes, gf, gj),
            int(torch.unique(K1._corners(x01, R)[0]).numel()) * C * 4,
            N * 3 * 4 * C, f", {R}²x{C} planes"),
        "hashgrid_bwd_dx": (
            L * Cg, lambda gf, gj: K6.hash_bwd_dx_cuda(x01, table, spec, L,
                                                       gf, gj),
            lambda gf, gj: K6.hash_bwd_dx_plain(x01, table, spec, L, gf, gj),
            int(torch.unique(torch.cat([K6._corners(x01, spec, l)[0]
                                        .reshape(-1) for l in range(L)]))
                .numel()) * Cg * 4,
            N * L * 8 * Cg, f", L{L}C{Cg} {spec.interpolation}, "
                            f"{spec.table_size} rows")}
    for name, (D, cuda, plain, rows, terms, shape) in cases.items():
        cots = [(torch.randn(N, D, device=dev, generator=g) * k).to(
            torch.bfloat16) for _ in range(4)]
        ms_of = {}
        for jac in (True, False):
            g_j = cots[1:] if jac else (None,) * 3
            call = lambda: cuda(cots[0], g_j)
            kernels.reset_launch_counts()
            dt, dx = call()
            torch.cuda.synchronize()
            check(kernels.LAUNCHES[name] == 1 and
                  sum(kernels.LAUNCHES.values()) == 1,
                  f"{name}{where}: not one launch")
            tp, xp = plain(cots[0], g_j)
            err = max(assert_close(name, [dt], [tp],
                                   1e-5 * float(tp.abs().max()), 1e-5),
                      assert_close(name, [dx], [xp],
                                   1e-5 * float(xp.abs().max()), 1e-5))
            check(bool(torch.isfinite(dx).all()), f"{name}: dx not finite")
            ms, k_g = median_ms(call), graph_ms(call)
            n_bytes = nbytes(x01, *cots[:4 if jac else 1], dt, dx) + rows
            flops = terms * (12 if jac else 4)
            what = (f"{where}{shape}, " + ("+ jacobian cotangents" if jac
                                           else "the features alone") +
                    f", graph {k_g:.4f} ms")
            if jac:
                record_kernel(results, name, err, ms,
                              median_ms(lambda: plain(cots[0], g_j), 3),
                              "1e-5 of max |dtable|, of max |dx| (fp32 "
                              "reductions in any order)", n_bytes, flops,
                              "fp32", None, what)
            else:
                log(f"{name}{what}: kernel {ms:.4f} ms, max_abs_err "
                    f"{err:.3e}")
            ms_of[jac] = (ms, k_g, err, bound(n_bytes, flops, "fp32")[0])
        rows_json.append({"kernel": name, "samples": N, "where": where,
                          "ms": ms_of[True][0], "graph_ms": ms_of[True][1],
                          "max_abs_err": ms_of[True][2],
                          "bound_ms": ms_of[True][3],
                          "frozen_ms": ms_of[False][0],
                          "frozen_graph_ms": ms_of[False][1],
                          "frozen_bound_ms": ms_of[False][3]})


def dgrad_fp32_rows(torch, results, convs, counts, randn, rows_json):
    """K12's tiled fp32 input gradient at each distinct conv shape of the
    DPT against autograd of the plain forward (1e-5 relative plus 1e-4 of
    the largest), beside cuDNN's input gradient alone
    (``aten.convolution_backward`` with the input's mask, TF32 off; a
    TF-SAME pad applied to x's shape first, as cuDNN pads symmetrically);
    event and graph ms; bound: the forward's operations → the sums over
    the 40 convs (event, graph, bound, cuDNN event and graph)."""
    from dreamfusion_tpu_torch.ops import conv as K12
    from dreamfusion_tpu_torch.ops import kernels

    route = "conv_dgrad_fp32_tiled"
    sums = [0.0] * 5
    for row in convs:
        B, H, W, I, O, k, st, pads, _ = row
        where = f" [{B},{H},{W},{I}->{O}] {k}x{k} s{st} pad {pads} fp32 dgrad"
        Ho, Wo = K12.out_size(H, W, k, k, (st, st), pads)
        w = randn(O, k, k, I, scale=(k * k * I) ** -0.5, dtype=torch.float32)
        dy = randn(B, Ho, Wo, O, dtype=torch.float32)
        call = lambda: K12.conv2d_dgrad_cuda(dy, w, (B, H, W, I), (st, st),
                                             pads, torch.float32)
        kernels.reset_launch_counts()
        dx = call()
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[route] == 1 and
              sum(kernels.LAUNCHES.values()) == 1, f"{where}: not on {route}")

        def plain():
            xr = torch.zeros(B, H, W, I, device="cuda", requires_grad=True)
            return torch.autograd.grad(K12.conv2d_plain(
                xr, w, None, (st, st), pads, torch.float32), xr, dy)[0]

        err = _close_to(route, dx, plain(), 1e-5, 1e-4)
        (pt, pb), (pl, pr) = pads
        wc = w.permute(0, 3, 1, 2)
        dyc = dy.permute(0, 3, 1, 2)
        xl = torch.empty(B, I, H + pt + pb, W + pl + pr, device="cuda")
        lib_call = lambda: torch.ops.aten.convolution_backward(
            dyc, xl, wc, None, [st, st], [0, 0], [1, 1], False, [0, 0], 1,
            [True, False, False])
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib = median_ms(lib_call, 10)
            lib_g = graph_ms(lib_call, 5, 3)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        ms, k_g = median_ms(call, 10), graph_ms(call)
        flops = 2 * B * Ho * Wo * O * k * k * I
        n_bytes = nbytes(dy, w, dx)
        b_ms = bound(n_bytes, flops, "fp32")[0]
        record_kernel(results, route, err, ms, median_ms(plain, 3),
                      "1e-5 rel + 1e-4 of max", n_bytes, flops, "fp32", lib,
                      where + f", graph {k_g:.4f} ms (cuDNN {lib_g:.4f})",
                      main=row[:8] == DPT_MAIN_CONV[:8])
        n = counts[row]
        for i, v in enumerate((ms, k_g, b_ms, lib, lib_g)):
            sums[i] += v * n
        rows_json.append({"kernel": route, "row": [B, H, W, I, O, k, st,
                                                   pads, "fp32"],
                          "calls": n, "ms": ms, "graph_ms": k_g,
                          "library_ms": lib, "library_graph_ms": lib_g,
                          "bound_ms": b_ms})
    return sums


def dpt_backward_phase(torch, kernels, results, x01, smi_line) -> dict:
    """The DPT's backward at full width on random weights and K1's and
    K6's second derivative: K10's fp32 backward at the ViT's [1, 577, 12,
    64] against its plain version and SDPA's fp32 backward (TF32 off); K12's
    tiled fp32 dgrad and its fp32 wgrad at each of the 17 distinct conv
    shapes of a 384² DPT against their plain versions and cuDNN's (TF32
    off), the 40 convs' sums; the ``_dx`` rows with jacobian cotangents at stage
    1's samples (`x01`; ``field_query_phase`` adds the DMTet query's 262,144
    of a 512² view); all as one JSON line; then the DPT (depth head) at
    384² with every weight and the input trainable: one forward and
    backward, the counters reset just before, K10/K12 exactly as
    ``dpt_grad_launches`` derives them on the meta device, every gradient
    finite, the synchronised walls (median of 3) and the peak → the new
    kernels' launches."""
    import torch.nn.functional as F

    from dreamfusion_tpu_torch.models import dpt as D
    from dreamfusion_tpu_torch.ops import attention as K10

    randn = _randn_on(torch, torch.Generator(device="cuda").manual_seed(13))
    cfg = D.DPTConfig.depth()
    calls = dpt_grad_calls(cfg, DPT_HW)
    rows_json = []
    t0 = time.time()

    # ---- K10's fp32 backward at the ViT's shape ---------------------------
    (B, N, h, d), = {c[1] for c in calls if c[0] == "attn_bwd"}
    q, k, v, do = (randn(B, N, h, d, dtype=torch.float32) for _ in range(4))
    scale = d ** -0.5
    o, lse = K10.attention_fwd_cuda(q, k, v, scale)
    call = lambda: K10.attention_bwd_cuda(q, k, v, o, lse, do, scale)
    kernels.reset_launch_counts()
    got = call()
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["attention_bwd_fp32"] == 1 and
          sum(kernels.LAUNCHES.values()) == 1,
          "the fp32 attention backward did not take attention_bwd_fp32")
    plain = lambda: K10.attention_bwd_plain(q, k, v, o, do, scale)
    err = max(_close_to("attention_bwd_fp32", a, b, 1e-5, 1e-4)
              for a, b in zip(got, plain()))
    # SDPA's backward through autograd (the engine's thread: events only)
    qkvt = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ot, dot = F.scaled_dot_product_attention(*qkvt), do.transpose(1, 2)
        lib = median_ms(lambda: torch.autograd.grad(ot, qkvt, dot,
                                                    retain_graph=True), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ms, k_g = median_ms(call, 10), graph_ms(call)
    n_bytes = nbytes(q, k, v, o, lse, do, *got)
    flops, exps = 10 * B * h * N * N * d, B * h * N * N
    record_kernel(results, "attention_bwd_fp32", err, ms,
                  median_ms(plain, 3), "1e-5 rel + 1e-4 of max", n_bytes,
                  flops, "fp32", lib,
                  f" q [{B},{N},{h},{d}] fp32 backward, graph {k_g:.4f} ms",
                  exps=exps, main=True)
    rows_json.append({"kernel": "attention_bwd_fp32", "row": [B, N, h, d],
                      "calls": 12, "ms": ms, "graph_ms": k_g,
                      "library_ms": lib,
                      "bound_ms": bound(n_bytes, flops, "fp32", exps)[0]})

    # ---- K12's fp32 dgrad and wgrad at the 17 shapes ----------------------
    counts = {}
    for kind, x_shape, (O, kh, _, _), st, pads in (c for c in calls
                                                   if c[0] == "dgrad"):
        row = (*x_shape, O, kh, st, pads, "fp32")
        counts[row] = counts.get(row, 0) + 1
    convs = list(counts)
    check(len(convs) == 17 and sum(counts.values()) == 40,
          f"{len(convs)} DPT dgrad shapes, {sum(counts.values())} calls")
    dg = dgrad_fp32_rows(torch, results, convs, counts, randn, rows_json)
    n_wg = len(rows_json)
    wgrad_rows(torch, results, convs, randn, rows_json)
    wg = [0.0] * 5
    for r in rows_json[n_wg:]:
        n = counts[tuple(r["row"][:7]) + (tuple(map(tuple, r["row"][7])),
                                          "fp32")]
        for i, key in enumerate(("ms", "graph_ms", "bound_ms", "library_ms",
                                 "library_graph_ms")):
            wg[i] += r[key] * n
    for name, sums in (("conv_dgrad_fp32_tiled", dg),
                       ("conv_wgrad_fp32_tiled", wg)):
        log(f"DPT {name}: the 40 convs of a 384² backward summed: event "
            f"{sums[0]:.3f} ms, graph {sums[1]:.3f} ms against a bound of "
            f"{sums[2]:.3f} ms; cuDNN (TF32 off) event {sums[3]:.3f}, graph "
            f"{sums[4]:.3f} ms; on {smi_line}")

    # ---- K1's and K6's second derivative ----------------------------------
    encoder_hessian_rows(torch, results, x01, torch.ones(
        x01.shape[0], dtype=torch.bool, device=x01.device),
        f" [{x01.shape[0]} stage-1 samples]", rows_json)
    log(f"DPT backward and encoder rows in {time.time() - t0:.1f} s")
    log(f"DPT backward rows {json.dumps(rows_json)}")

    # ---- the DPT's forward and backward at 384² ---------------------------
    want = dpt_grad_launches(torch, cfg)
    with torch.device("cuda"):
        model = D.DPTDepthModel(cfg)
    random_dpt_state(torch, model, 33)
    model.requires_grad_(True)
    g = torch.Generator(device="cuda").manual_seed(34)
    x = torch.rand(1, DPT_HW, DPT_HW, 3, device="cuda", generator=g) * 2 - 1
    walls = []
    for it in range(3):
        model.zero_grad(set_to_none=True)
        xr = x.clone().requires_grad_()
        torch.cuda.synchronize()
        if it == 0:
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
        t1 = time.perf_counter()
        out = model.forward_grad(xr)
        if it == 0:
            ct = torch.randn(out.shape, device="cuda", generator=g)
        loss = (out * ct).sum()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        walls.append(((t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3))
        if it == 0:
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            launched = {kk: vv for kk, vv in kernels.LAUNCHES.items()
                        if vv and kk.startswith(("conv_", "attention_"))}
            check(launched == want, f"DPT backward: launched {launched}, not "
                  f"{want}")
            # the checkpoint's final LayerNorm is dead in the reference too
            bad = [n for n, p in model.named_parameters()
                   if not n.startswith("pretrained.model.norm.") and
                   (p.grad is None or not bool(torch.isfinite(p.grad).all()))]
            check(not bad, f"DPT backward: {len(bad)} parameters without a "
                  f"finite gradient, e.g. {bad[:3]}")
            check(xr.grad is not None and bool(torch.isfinite(xr.grad).all())
                  and bool(torch.isfinite(out).all()),
                  "DPT backward: the output or the input's gradient not "
                  "finite")
            got_l = launched
    n_par = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    run = {"fwd_ms": statistics.median(w[0] for w in walls),
           "bwd_ms": statistics.median(w[1] for w in walls),
           "first_bwd_ms": walls[0][1], "peak_gib": peak, "params": n_par}
    log(f"DPT (vitb_rn50_384, depth) backward to its {n_par / 1e6:.2f}M "
        f"weights and the input at {DPT_HW}²: forward {run['fwd_ms']:.2f} "
        f"ms, backward {run['bwd_ms']:.2f} ms (median of 3, synchronised; "
        f"the first {run['first_bwd_ms']:.2f}), peak {peak:.2f} GiB; "
        f"launches {got_l}; on {smi_line}")
    log(f"DPT backward walls {json.dumps(run)}")
    return {k_: got_l.get(k_, 0) for k_ in DPT_GRAD_KERNELS}


def run() -> dict:
    t_run = time.time()
    try:
        import torch
    except ImportError as e:
        raise SmokeFailure(f"torch is not importable: {e}")
    check(torch.cuda.is_available(), "no CUDA device (torch.cuda)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    sys.path.insert(0, ROOT)
    try:
        from dreamfusion_tpu_torch import main as port_main
        from dreamfusion_tpu_torch.ops import kernels
    except ImportError as e:
        raise SmokeFailure(f"the port is not next to chip_smoke.py: {e}")

    t0 = time.time()
    kernels.cuda_lib()
    log(f"CUDA kernels built and loaded in {time.time() - t0:.1f} s "
        f"(build/torch_kernels)")
    fn = spill = None               # ptxas -v: one line per kernel
    for line in kernels.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            log(f"ptxas: {fn}: {spill}; {line.split(':', 1)[-1].strip()}")
    from dreamfusion_tpu_torch.native import meshops
    t0 = time.time()
    meshops.build()
    log(f"host mesh library built with g++ in {time.time() - t0:.1f} s "
        f"(build/meshops)")

    results = {}
    x01 = kernel_phases(torch, results, smi_line)
    t_k = time.time()
    hashgrid_kernel_phases(torch, results, x01)
    log(f"K6 phase in {time.time() - t_k:.1f} s")
    sd_kernel_phases(torch, results)
    t_k = time.time()
    zero123_kernel_phases(torch, results)
    log(f"zero123 K10-K12 rows in {time.time() - t_k:.1f} s")
    clip_kernel_phase(torch, results)
    clip_grad_kernel_phase(torch, results)
    t_k = time.time()
    dmtet_kernel_phases(torch, results)
    log(f"K7/K8 phases in {time.time() - t_k:.1f} s")

    # ---- stage 1, SD 2.1 and DMTet on the triplane (slices 1-3) -------------
    build = os.path.join(ROOT, "build")
    ws = os.path.join(build, "chip_smoke_ws")
    summary, _ = stage1_path(port_main, kernels, FLAGSHIP, ws, "oracle",
                             ORACLE_KERNELS, "triplane", smi_line)
    stage1_step_launches(torch, port_main, kernels, FLAGSHIP, ws + "_step",
                         "oracle")
    bake_kernel_phase(torch, results, summary["mesh_path"])
    t_k = time.time()
    dmtet_surface_raster_phase(torch, results, port_main,
                               os.path.join(ws, "checkpoints"),
                               os.path.join(build, "chip_smoke_k7_ws"))
    log(f"K7 phase at the DMTet surface in {time.time() - t_k:.1f} s")
    sd_launches = sd_path(torch, port_main, kernels, SD_FLAGS,
                          os.path.join(build, "chip_smoke_sd_ws"), "SD",
                          "triplane", smi_line)
    sd15_launches = sd15_path(torch, port_main, kernels,
                              os.path.join(build, "chip_smoke_sd15_ws"),
                              smi_line, sd_launches)
    dm, dm_launches = dmtet_path(
        torch, port_main, kernels, DMTET_FLAGS + [
            "--init_with", os.path.join(ws, "checkpoints")], DMTET_STEPS,
        os.path.join(build, "chip_smoke_dmtet_ws"), "DMTet", DMTET_KERNELS,
        "triplane", smi_line)
    dmtet_view_launches(torch, port_main, kernels, DMTET_FLAGS + [
        "--init_with", os.path.join(ws, "checkpoints")],
        os.path.join(build, "chip_smoke_dmtet_view_ws"), "DMTet", "triplane")
    dmtet_sd_path(torch, port_main, kernels,
                  os.path.join(build, "chip_smoke_dmtet_sd_ws"),
                  os.path.join(ws, "checkpoints"), smi_line)

    # ---- the same on the hash grid (slice 4) --------------------------------
    ws = os.path.join(build, "chip_smoke_grid_ws")
    _, grid_launches = stage1_path(port_main, kernels, GRID_FLAGSHIP, ws,
                                   "grid oracle",
                                   GRID_KERNELS + GRID_REG_KERNELS, "grid",
                                   smi_line)
    stage1_step_launches(torch, port_main, kernels, GRID_FLAGSHIP,
                         ws + "_step", "grid oracle")
    sd_grid_launches = sd_path(torch, port_main, kernels, SD_GRID_FLAGS,
                               os.path.join(build, "chip_smoke_sd_grid_ws"),
                               "SD -O", "grid", smi_line)
    _, dm_grid_launches = dmtet_path(
        torch, port_main, kernels, GRID_DMTET_FLAGS + [
            "--init_with", os.path.join(ws, "checkpoints")], DMTET_GRID_STEPS,
        os.path.join(build, "chip_smoke_dmtet_grid_ws"), "DMTet from grid",
        ("hashgrid_fwd", "hashgrid_bwd_dx", "raster_fwd",
         "marching_tets_fwd"), "grid", smi_line)
    dmtet_view_launches(torch, port_main, kernels, GRID_DMTET_FLAGS + [
        "--init_with", os.path.join(ws, "checkpoints")],
        os.path.join(build, "chip_smoke_dmtet_grid_view_ws"),
        "DMTet from grid", "hashgrid")

    # ---- image → 3D: stage 1 with K5, then DMTet from its mesh (slice 5) ---
    ws = os.path.join(build, "chip_smoke_image_ws")
    img, img_launches, limit = image_path(torch, port_main, kernels, ws,
                                          smi_line)
    t_k = time.time()
    sdf_kernel_phase(torch, results, img["mesh_path"], smi_line)
    log(f"K9 phase in {time.time() - t_k:.1f} s")
    img_dm_flags = IMAGE_DMTET_FLAGS + [
        "--grad_clip_rgb", str(limit), "--init_with", img["mesh_path"]]
    img_dm_launches = image_dmtet_path(
        torch, port_main, kernels, img_dm_flags,
        os.path.join(build, "chip_smoke_image_dmtet_ws"), smi_line)
    dmtet_view_launches(torch, port_main, kernels, img_dm_flags,
                        os.path.join(build, "chip_smoke_image_dmtet_view_ws"),
                        "DMTet from the image mesh", "triplane")

    # ---- Zero-1-to-3 from an image file (slice 6) ---------------------------
    t_z = time.time()
    zws = os.path.join(build, "chip_smoke_zero123_ws")
    png = write_reference_png(port_main, zws + "_ref")
    z_launches = zero123_path(torch, port_main, kernels, png, zws, smi_line)
    zero123_refs_phase(torch, port_main, kernels, png, zws + "_k3")
    zero123_dmtet_path(torch, port_main, kernels, png,
                       os.path.join(build, "chip_smoke_ws", "checkpoints"),
                       zws + "_dmtet", smi_line)
    novel_view_phase(torch, png, zws + "_novel")
    log(f"zero123 paths in {time.time() - t_z:.1f} s")
    check(z_launches["conv_dgrad"] == 0, "zero123 launched conv_dgrad")

    # ---- image + text: SD 2.1 + CLIP ViT-B/16, raw checkpoints (slice 7) --
    t_c = time.time()
    it_launches = image_text_path(
        torch, port_main, kernels, png,
        os.path.join(build, "chip_smoke_image_text_ws"), smi_line)
    image_text_dmtet_path(
        torch, port_main, kernels, png,
        os.path.join(build, "chip_smoke_ws", "checkpoints"),
        os.path.join(build, "chip_smoke_image_text_dmtet_ws"), smi_line)
    clip_eval_phase(torch, port_main, kernels, smi_line)
    raw_weights_phase(torch, port_main,
                      os.path.join(build, "chip_smoke_raw_ws"))
    log(f"image + text paths and raw weights in {time.time() - t_c:.1f} s")

    # ---- DeepFloyd-IF: IF-I-XL, T5-XXL, DMTet under IF (slice 8) ------------
    t_f = time.time()
    n_shapes, tflop = if_kernel_phases(torch, results)
    if_path(torch, port_main, kernels,
            os.path.join(build, "chip_smoke_if_ws"), smi_line)
    t5_phase(torch, smi_line)
    if_dmtet_path(torch, port_main, kernels,
                  os.path.join(build, "chip_smoke_ws", "checkpoints"),
                  os.path.join(build, "chip_smoke_if_dmtet_ws"), smi_line)
    log(f"IF paths ({n_shapes} conv shapes, {tflop:.3f} TFLOP of conv a "
        f"CFG call) in {time.time() - t_f:.1f} s")

    # ---- the vanilla backbone (-O2) and the small field options (slice 9) --
    t_v = time.time()
    vanilla_kernel_phases(torch, results, smi_line)
    o2_launches = sd_path(torch, port_main, kernels, O2_SD_FLAGS,
                          os.path.join(build, "chip_smoke_o2_sd_ws"),
                          "-O2 SD", "vanilla", smi_line,
                          steps=O2_WARMUP + O2_STEPS, timed_after=O2_WARMUP)
    ows = os.path.join(build, "chip_smoke_o2_ws")
    stage1_path(port_main, kernels, O2_ORACLE_FLAGS, ows, "-O2 oracle",
                O2_KERNELS, "vanilla", smi_line, O2_STAGE1_END)
    stage1_step_launches(torch, port_main, kernels, O2_ORACLE_FLAGS,
                         ows + "_step", "-O2 oracle")
    o2_dm_flags = O2_DMTET_FLAGS + ["--init_with",
                                    os.path.join(ows, "checkpoints")]
    dmtet_surface_raster_phase(torch, results, port_main,
                               os.path.join(ows, "checkpoints"),
                               ows + "_k7", O2_DMTET_FLAGS, main=False,
                               what="-O2 DMTet")
    dmtet_path(torch, port_main, kernels, o2_dm_flags, O2_DMTET_STEPS,
               ows + "_dmtet", "DMTet from -O2", O2_DMTET_KERNELS, "vanilla",
               smi_line)
    dmtet_view_launches(torch, port_main, kernels, o2_dm_flags,
                        ows + "_dmtet_view", "DMTet from -O2", None)
    opt_launches = options_path(torch, port_main, kernels,
                                os.path.join(build, "chip_smoke_options_ws"),
                                smi_line, results)
    log(f"-O2 and field-option paths in {time.time() - t_v:.1f} s")

    # ---- snapshots, txt2img and the guidance sets (slice 10) ---------------
    t_g = time.time()
    decode_ms = decoder_kernel_phases(torch, kernels, results, smi_line)
    snap_s = snapshot_phases(torch, port_main, kernels, png,
                             os.path.join(build, "chip_smoke_ws",
                                          "checkpoints"),
                             os.path.join(build, "chip_smoke_snap_ws"),
                             smi_line)
    t2i = txt2img_phase(torch, kernels,
                        os.path.join(build, "chip_smoke_txt2img"), smi_line)
    sets = guidance_sets_phase(torch, port_main, kernels, png,
                               os.path.join(build, "chip_smoke_sets_ws"),
                               smi_line)
    log(f"snapshots, txt2img and guidance sets in {time.time() - t_g:.1f} s:"
        f" decode ms {_rounded(decode_ms)}, s a snapshot "
        f"{_rounded(snap_s)}, s a DDIM step {_rounded(t2i)}, multi-prior "
        f"{_rounded(sets)}; on {smi_line}")

    # ---- tooling: preprocess_image's DPT, mesh_to_video, r_precision, the
    # viewer, --profile (slice 11) -------------------------------------------
    dpt_l = tooling_phases(torch, port_main, kernels, results,
                           os.path.join(build, "chip_smoke_ws"),
                           summary["mesh_path"], png, smi_line)

    # ---- the towers' backward to their weights (slice 12) ------------------
    t_b = time.time()
    grad_l = tower_backward_phase(torch, kernels, results, smi_line)
    log(f"tower backward phase in {time.time() - t_b:.1f} s")

    # ---- the DPT's backward and the encoders' second derivative (slice
    # 13) -------------------------------------------------------------------
    t_b = time.time()
    dpt_grad_l = dpt_backward_phase(torch, kernels, results, x01, smi_line)
    log(f"DPT backward phase in {time.time() - t_b:.1f} s")

    def launches_of(name):
        if name in DPT_GRAD_KERNELS:
            return dpt_grad_l[name]
        if name in GRAD_KERNELS or name == "conv_wgrad_mma":
            return grad_l[name]
        if name in ("attention_fwd_fp32", "conv_fwd_fp32_tiled"):
            return dpt_l[name]
        if name in ("vanilla_coarse", "vanilla_resample"):
            return o2_launches[name]
        if name.startswith("field_select"):
            return opt_launches[name]
        if name in ("conv_fwd_mma", "conv_dgrad"):
            return it_launches[name]
        if name in SD15_UNET_ATTNS:
            return sd15_launches[name]
        if name == "clip_grad_bwd":
            return img_launches[name]
        if name == "signed_distance":
            return img_dm_launches[name]
        if name in GRID_REG_KERNELS:
            return grid_launches[name]
        if name == "hashgrid_bwd_dx":
            return dm_grid_launches[name]
        if name.startswith("hashgrid"):
            return sd_grid_launches[name]
        if name in DMTET_KERNELS and name not in ORACLE_KERNELS:
            return dm_launches[name]
        return sd_launches[name]

    log(f"every phase passed in {time.time() - t_run:.1f} s (the build "
        f"included)")
    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches_of(name), **results[name]}
        for name, (route, src, rep) in KERNELS.items()]}
    print(json.dumps(line), flush=True)
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    try:
        result = run()
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    print(json.dumps(result), flush=True)

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`contextgs_tpu_torch`) on one NVIDIA
card: the quickest proof that the port builds, serves, trains and codes on
the GPU.

    python3 chip_smoke.py

Phases, one JSON object per line. A failed check or any other exception
prints one line {"phase": "failed", "failed_in": <phase>, "error": ...}
(the traceback goes to stderr) and exits 1; the result line is printed only
after every phase has held.

1. device  — the card's name and power limit; K1, K2, K3, K4
   (scripts/csrc/kvariants.cu) and K5/K6 (scripts/csrc/xpose.cu) built from
   the sources in the checkout (nvcc, sm_90a, one process each, together),
   with ptxas's register and shared-memory lines; with them K2's knock-outs
   (written from its source into build/k2_knockouts) and, where copies of
   the previous design's K3 and K2 sources lie in build/prev (scan_prev.cu,
   blend_backward_prev.cu, taken from git history: not in the repository,
   so a checkout skips them), those, to time old against new in this
   call; K1 at its other warp geometries (K1_GEOMETRIES, written from
   its source into build/k1_geometries); and, where a copy of K4's source
   from before its levels became stages of K1's per-warp design lies at
   build/prev/kvariants_prev.cu (from git history; a checkout skips it),
   that one. k4_ptxas: registers, shared memory and spills of each level
   of K4 (and of the previous design's, where present) and the blocks an
   SM holds of each by the occupancy calculator. k1_ptxas: registers,
   shared memory and spills of K1, of its other geometries and of K4's
   level 4; the codec's range coder (host C++, the port's own copy in
   compression/csrc) built with the host compiler, whose path and version
   it prints. k4_sass: K4's levels in the SASS cuobjdump prints (skipped
   where the toolkit has none), so that the sinks are seen to keep every
   stage's work: the bounds' loads and no copy at level 0, the row gather
   as at least nine cp.async copies (LDGSTS) and the ids' loads from level
   1 on, the exp from level 2 on only, and a walk that grows from level 2
   to 4; K1's own counts beside level 4's, not checked. Whether PIL and
   torchvision import, asked of a fresh interpreter (nothing on the port's path
   imports either).
2. k1_check — K1 against its plain PyTorch version on the card: golden small
   cases and the cull cases below (2e-5), then a 1280x720 view of a
   20k-anchor decoded scene (max
   2e-4, mean 1e-6: an include decision at T·(1-α) ≈ 1e-4 may flip between
   the plain version's log-space prefix and the kernel's sequential product,
   and each flip moves a pixel by at most α·T ≤ 1e-4).
   k2_check — K2 against its plain version (autograd through the plain
   blend) on the golden cases, three cases that probe its footprint cull
   (edges of the alpha >= 1/255 region and of its box on a warp's row
   boundary, opacities just above 1/255, conics that are not positive
   definite) and the 20k view, with random cotangents and a nonzero
   dL/dT_final: every component of d_rows inside the envelope of the
   plain gradients at T_EPS·(1±2e-4), widened by 1.5e-3 of that component's
   largest |grad| (the JAX package's Pallas-versus-oracle tolerance, the size
   of rounding between a sequential product and a log-space prefix).
   k3_check — K3 (the lane prefix sum) against its plain version on the
   card: int32 and uint32 exact, the two's complement wrap of [2, 100000],
   rows of 10001 (not a multiple of 4: the kernel's scalar edge), 1-D views
   4 bytes off a 16-byte boundary, the sizes 1, 127, 129, 4097 and 8193
   inclusive and exclusive, a 1-D exclusive row and one row of 1M (many
   tiles); float32 within scan.float_tolerance(N) · Σ|x| of a float64
   prefix, the worst share of that bound printed; K3's scratch left
   zeroed.
   carry_check — the carry kernel (ops/csrc/carry.cu) bit-equal to the
   plain chain (levels.segmented_carry_plain) in one launch a call, at the
   city's sizes: a level map's 2.4M slots (int64), a densify round's 26.4M
   keys (int32 flags; a start-free run to the end) and 26.4M keys each a
   start (int64); each timed beside the chain by events and by the
   profiler's device time, with its byte bound; its scratch left zeroed.
   k4_check — every level of K4 against its plain version and K1 on the
   golden cases, the cull cases and the kernel lab's 1x3600 table: v0
   exact, the sinks of v1 and v2 1e-5 relative, v3's sink (unscaled) and
   v4 with K1's tolerances; v4 bit-equal to K1, v3's T and last_contrib
   equal to K1's.
   k1_old_new — K1, and K1 at each other warp geometry, torch.equal to K4's
   level 4 (K1's design with its row gather staged by cp.async) in rgb,
   final T and last_contrib on the golden cases, the cull cases and the
   lab's 1x3600 table; and K1 torch.equal to the previous design's level
   4 where its copy is present.
   k56_check — K5 and K6 equal to x.transpose(1, 2).contiguous() at the
   lab's [8394, 128, 16] and at ragged slab counts.
3. serve — the main path of serving at full width: a decoded scene of
   ModelConfig() width (feat_dim 50, 10 offsets) and 100k anchors, built with
   the recipe of scripts/fps_bench.py from a seed, rendered by
   make_decoded_renderer → render_set over a full orbit of 32 views at
   1280x720 (the first 5 are render_set's warm-up) and scored by
   evaluate_images against a seeded target. K1's launch count is set to 0
   just before and read just after, and must equal the number of views; K1's
   inputs of the last view are kept from this run. Then a second pass over
   the orbit with CUDA events around the renderer's module-level calls (the
   stage split), K1 checked, timed and bounded on the kept inputs,
   k4_check and k4_decompose on them (each level of K4 timed beside K1,
   with its increment and its bounds, in turns with the previous design's
   level where its copy is present, and the per-tile list lengths): the
   split of K1's time on the main path; K2 checked
   on the same view with seeded cotangents (a denser list than training's:
   its time comes after training), the small
   CPU-vs-card check, and render(phase="plain") from init_scene_model over a
   seeded 100k-point cloud. K3's count is set to 0 with K1's and read
   after: K3 is off the main path (the rasterizer's prefix sums are
   torch.cumsum, as the reference's are jnp.cumsum).
   projection_check: the projection's and the cull's launch counts (one
   each a view), then the two kernels (ops/rasterize/csrc/projection.cu)
   against the plain chain on the last view's inputs (floats within 2e-6
   relative, every integer output and the cull mask equal), each timed by
   events (and by card_ms) beside the plain chain, with its bound from
   bytes. binning_check: the binning's launch count (two a view), then its
   kernels (ops/rasterize/csrc/binning.cu) against the plain chain
   (sorting.expand_and_sort_plain) on the last view's projection:
   gauss_ids, tile_bounds, demand and n_vis equal, two launches a call;
   each timed by events and by the profiler's device time beside the plain
   chain, with its bound from bytes.
4. ssim_grad — the SSIM gradient at 1280x720 on the card against float64 on
   the CPU (1e-5 relative; cuDNN's TF32 would give about 1e-3, printed too).
5. train — the main path of training at full width: train() from
   init_scene_model over the serve scene's 100k anchor positions, the 32
   serve renders as targets, 90 steps at 1280x720 (1-30 plain, 31-60 noise,
   61-90 context, densify every 10 steps from 20 to 70). K1's, K2's and
   K3's counts are set to 0 just before and read just after; K1 and K2 must
   equal the steps; the losses are finite and fall; bit_per_param is finite
   and above 0 on every context step; the level scales were searched (2)
   and every step's level counts sum to its kept anchors. CUDA events split
   each step into level maps, forward render (the context inside it),
   loss, backward, Adam, statistics and densify, per phase. K2 is checked
   again on the last step's inputs; train_profile: torch.profiler over 3
   more noise and 3 more context steps (device time by kernel, the
   device's busy share). context_eval: make_eval_render(phase="context")
   renders one view of the final state twice (finite, bit-identical: no
   draws, and K1 uses no atomics) and estimate_bits gives the model's size
   in MB per stream. Then train_small_cpu_vs_card: 5 plain steps of a
   small scene from one state on the CPU and on the card (losses 1e-3
   relative: atomics and reduction order differ); context_small_cpu_vs_card:
   5 context steps likewise, both sides given the same draws (loss and
   bit_per_param 1e-3 relative); k1_bound on the last step's inputs (K1
   on the training path); k4_check and k4_decompose on the last step's K1
   inputs, as on the serve view's; k1_old_new on the serve view's and the
   last step's K1 inputs: K1 torch.equal to K4's level 4 (and to the
   previous design's where present), the two timed in turns (v4, K1, K1,
   v4) by card_ms and by events, which is what the asynchronous staging is
   worth to K1, each other geometry in turns with K1, and the (warp,
   instance) pairs each geometry walks (fwd_warp_touched, fwd_warp_exp)
   beside the listed pairs / 32 that a walk without the cull reaches;
   k2_bound: K2 timed and bounded on the last step's
   inputs and on the serve view's, each beside the previous K2 in turns
   where its copy is present, with the shuffles and global atomics of both
   designs counted from the pair counts; and k2_knockouts: K2 beside its
   knock-outs on the serve view (no reduce-scatter; no cull).
   projection_check on the last step's inputs: one projection, cull and
   backward launch a step, the forward and the cull as on the serve view,
   and the backward's gradient of seeded cotangents against autograd of
   the plain chain and reference.project_vjp_reference (each leaf within
   1e-5 of its norm, no element off by more than 1e-4 of its largest),
   timed by events beside the plain chain's backward. Adam's launch count
   is set to 0 with K1's and must equal the steps after; adam_check on the
   last step's gradients and the state that step left: the kernel
   (train/csrc/adam.cu) against the op chain, p, m and v bit-equal, and the
   host time, kernels and device time a call of the kernel, the chain and
   the chain in torch._foreach_* ops, with the kernel's bound from bytes.
   The binning's launch count is set to 0 with K1's and must be twice the
   steps after; binning_check on the last step's projection, as on the
   serve view's.
5b. viewer — the live SIBR viewer on the train cell's final model at
   1280x720 (viewer_phase): a loopback client sends the camera messages of
   4 orbit cameras as SIBR sends them (transposed, columns negated), one
   at each of steps 15, 45 and 90 (plain, noise, context) and one at step
   90 with scaling_modifier 0.5; utils/viewer.ViewerServer.poll serves each
   with drivers.train.viewer_render. K1's count set to 0 before each poll
   and read after. Exact: each frame H·W·3 bytes and the verify string,
   equal to the bytes of a direct render (same phase, level maps and
   generator seed), the MiniCam from the wire within 1e-6 of the camera,
   K1 once a frame; K1 within 2e-4 (mean 1e-6) of its plain version on the
   context frame; the half-scale frame unlike the same camera at full
   scale. Printed: ms a frame (CUDA events around viewer_render) and a
   poll (host clock), median.
6. codec — the train cell's final model encoded at full width
   (encode_scene into a temporary directory, removed after), decoded
   (decode_scene) and encoded again; the decoded scene served over the
   serve cell's 32-view orbit (make_decoded_renderer → render_set, K1's
   count set to 0 just before and read just after) and scored by
   evaluate_images against the context eval render of the same cameras.
   Checked, exactly: every decoded state (anchor, feat, scaling, offsets,
   masks, hyper, level) equal to the encoder's, every stream consumed, the
   second encode byte-identical, K1 launched once a view and within 2e-4
   (mean 1e-6) of its plain version on each decoded view. The CDF kernel
   (compression/csrc/cdf_rows.cu; its count set to 0 before the phase's
   host check and read after the second encode): once for each card
   `_cdf_rows` call, and on every call of the first encode (the real
   streams' μ, σ, Q, window bases and windows) its uint16 rows equal to
   the plain version's (codec._windowed_cdf_rows + coder.quantize_cdf) and
   its float64 rows bit for bit (cdf_rows_check: 0 entries may differ);
   the kernel's device time over those calls by CUDA events, the plain
   version's by the host clock, beside their byte and FP64 bound. Printed
   only: bytes per stream against the model's estimate, anchors per level,
   windows and escapes, encode and decode seconds, ms per view beside the
   serve cell's, PSNR and SSIM, peak device memory.
6b. drivers — the port's drivers from disk, in a temporary directory
   removed after, with the settings of DRIVER_SCENE and DRIVER_SCHEDULE:
   scripts/make_synth_scene.main (512x512, 48 orbit views of 80k ground
   truth gaussians rendered by K1, 20k SfM points, so about 20k initial
   anchors at ModelConfig() widths), drivers.train.main (600 steps: plain
   to 200, noise to 400, context to 600, densify every 100 from 100 to
   500; the PLY snapshot and the checkpoint at 600; encode → decode →
   render the 6 test views → results.json), drivers.decompress.main and
   drivers.test.main (the newest checkpoint, encoded again), then the
   snapshot read back with load_model_ply and load_networks, and
   drivers.bench.main (30 chained forward+backward rasterizations of 200k
   gaussians at 1280x720 after 2 warm-up ones). K1's and K2's counts are
   set to 0 before the script and each driver and read after. Checked,
   exactly: K1 once a view in make_synth_scene; K2 once a training step
   and K1 once a step, once an eval view and once a decoded view; K1 once
   a test view in decompress and test; K1 and K2 once a bench iteration;
   "decoded" and "ours_from_ckpt" equal to "ours" (PSNR, SSIM; size_MB);
   the test driver's bitstreams byte-identical to train's; the snapshot
   equal to the loaded checkpoint's alive rows and networks, and that
   checkpoint to the final state; no jax and no PIL module imported;
   results.json finite with LPIPS null and LPIPS_skipped set. Within
   tolerance, on the inputs the drivers gave the kernels (kept by wrappers
   during the runs, compared after them): K1 within 2e-4 (mean 1e-6) of
   its plain version on the synthetic scene's last view, the train
   driver's last step, its 6 eval views and its 6 decoded test views, and
   the bench's last iteration; K2 inside the plain envelope on the train
   driver's last step and the bench's last iteration. The decoded test
   PSNR above 15 dB (a gate a broken chain fails, not a quality target).
   Printed: anchors, ms a step per phase (median, with a synchronize at
   each step), encode and decode seconds, coded MB against the model's
   estimate, ms a view of the decoded scene over all 48 views (the first
   5 left out), each driver's and the phase's seconds, and the bench's
   line.
   tools (tools_phase, on the drivers' model directory before it is
   removed): scripts.codec_diag on its newest checkpoint, whose payload
   and escape bits per stream must equal 8 x the bytes of that stream's
   files in the train driver's bitstreams (n_sym > 0; the table and
   act/ideal printed beside the model's estimate); scripts.collect_results
   over the directory (its rows = results.json's variants and PSNR);
   scripts.sweep over λ 0.004 and 0.0005 on a 128x128, 16-view, 1k-point
   synthetic scene, 100 steps each (each run a drivers.train process on
   the card): both exit 0 with a results.json (size and PSNR printed).
   The train driver also writes the checkpoint at the context
   transition, chkpnt400.pt (no step changes).
   rd_branch (rd_branch_phase, on that directory before it is removed):
   the state the train driver saved at step 400 (kept by a wrapper of
   train.loop.save_checkpoint) against the state train.loop.train loads
   from chkpnt400.pt, bit for bit: every parameter, buffer and Adam
   moment, Adam's count, the numpy and torch generators' states, the
   camera order, and no level scales; a branch at the run's own λ in
   process (train.loop.train with start_checkpoint, no codec) for 20
   steps: its first loss equal to the run's step 401, its steps 401-420
   within the largest relative spread of a second continuous run (in
   process, steps 1-420) from the run's (K2's atomics make each run's sum
   order its own; both printed), K1 and K2 once a step in both;
   scripts.rd_queue --lmbdas 0.002 --iters 600 --no_wait from chkpnt400.pt
   into <root>/l0.002 (a drivers.train process: the context steps,
   encode, decode, the decoded test views), then scripts.rd_finalize on
   <root> (drivers.test and scripts.codec_diag on that point,
   scripts.rd_table, drivers.bench, each a process; the drivers run's
   own directory lies outside the l{λ} layout, since the drivers and
   tools phases already ran the test driver and codec_diag on it): both
   exit 0, the summary entry rc 0 and branched from model/chkpnt400, the
   point's results.json with "ours_from_ckpt" equal to "ours" and its
   codec_diag.json, and rd_table a row for it. Printed: the losses'
   distances, the table, the drivers run's PSNR and size beside the
   point's, each part's seconds.
6b'. raster_tools — the scripts that measure the rasterizer, after
   k2_knockouts (raster_tools_phase), each through its module-level
   measure with K1's and K2's counts set to 0 just before and read just
   after: scripts.profile at the bench frame (200k gaussians, 1280x720: 10
   chained forward+backward steps, then each stage by CUDA events and by
   the profiler's kernel time), scripts.thr_sweep's five default rows
   (200k, 1M and 2M gaussians at 1280x720, 200k and 1M at 1920x1080, 20
   chained steps each, ms, Mpix/s, demand and peak memory),
   scripts.fps_bench (100k anchors, 32 views, 1280x720: the per-view loop
   and the chained one), scripts.kern_micro's six (chunks a tile, active
   tiles) configs of the lab table, scripts.corner_diag at its defaults,
   and scripts.r3_suite with one λ on a 128x128, 16-view, 1k-point
   synthetic scene, 100 steps, in a temporary directory, read back by
   scripts.rd_table. Checked: each script's K1 and K2 launches as its
   protocol makes them; K1 (2e-4, mean 1e-6) and K2 (inside the plain
   envelope) against their plain versions on the arguments kept from
   profile's run, from thr_sweep's two largest rows and from each of
   kern_micro's six configs (cotangents of ones); thr_sweep's and
   corner_diag's demands within 1e-4 of a CPU projection of the same
   draws; the chained sum of the images' means within 1e-6 of the naive
   one; corner_diag's n_valid equal to its tight demand; one r3_suite
   entry with rc 0 and results, an rd_table row with a finite PSNR, and
   the λ skipped on a second call. Printed: each script's numbers and the
   phase's seconds.
6b''. glue_labs — scripts.r3_micro and scripts.pack_lab on the card
   (glue_labs_phase), their tables (each piece by CUDA events around 20
   back-to-back calls), then every piece on the card against the same
   piece on the CPU on the same inputs: exact for the gathers, the
   transposes, the sorts' keys, the integer scatters, cumsums and forward
   fill; the unstable sorts' payloads (and indices) as a multiset for
   each key; float32 cumsums within 4·n·2^-24 of the running sum of |x|
   and the regroups within 8·2^-24·(B+1)·max|g|; pack_lab's frame on the
   card equal to the same frame on the CPU (demand, gauss_ids, tile
   bounds, depth order and ranks, the lab's gradient rows) with its
   monotone fractions, and its demand equal to the JAX package's count,
   547,648. No hand-written kernel runs there: each piece is a torch op.
6c. sharded — multi-GPU training (parallel/, train/sharded_loop.py),
   after glue_labs. offset_turns, where build/prev_offset holds K1's
   and K2's sources from before the row offset (blend_forward_nooffset.cu,
   blend_backward_nooffset.cu, from git history; k1_ptxas prints their
   registers and spills beside the new ones): the two against the new on
   the serve view, equal, and timed in turns. sharded_bands: K1 and K2
   over the bands of 2 and 4
   ranks (23 and 12 tile rows, the last band running 1 and 3 rows past the
   image) on the serve view's and the last training step's inputs, each
   band's tile lists cut from the whole image's: the stitched bands equal
   unbanded K1 bit for bit (rgb, final T, last_contrib), the bands' d_rows
   summed within 1.5e-3 of each component's largest |grad| of unbanded K2,
   each band's K1 and K2 against their plain versions with the same row
   offset, and the bands' times beside the unbanded call's. sharded_train:
   train_sharded on 2 ranks sharing the card over gloo (NCCL refuses two
   ranks on one device), the train cell's 90 steps; exact: each rank's K1
   and K2 once a step, the replicated parameters equal on the ranks, no
   jax, contextgs_tpu or PIL module in a rank, the gathered model's encode
   → decode round trip and K1 on a decoded view; bounded against the
   train phase's single-process run: the plain steps' loss within 5%, each
   phase's mean drift within 5% (a second single-process run with other
   draws, printed beside, shows the per-step spread the draws alone give
   the noise and context steps), the alive anchors within 25% of the
   grown; printed: ms a step per phase per rank, the splat gather's bytes
   and ms a step, the reshards' seconds, peak memory per rank.
   sharded_driver: drivers.train --mesh 1 over NCCL on the drivers phase's
   scene (made again, 150 steps), drivers.decompress and drivers.test;
   "decoded" and "ours_from_ckpt" equal to "ours", the rank's K1 and K2
   once a step, K1 once a decoded test view in each driver; the decoded
   PSNR beside the drivers phase's.
6d. growth_parity — scripts.growth_parity --devices 2 --points 20000
   --keys 3 (one densify on the JAX script's seeded state, single process
   on the card against 2 ranks sharing it over gloo, plus the host dedup):
   no overflow, anchors grown on every key, the single column equal to the
   same call on the CPU with the same draws; the table and the mean delta
   printed. scaling — scripts.scaling_bench's measure at 512x512, 20k
   points, 8 warm-up and 8 timed steps of the sharded context step, at
   world size 1 over NCCL and 2 over gloo sharing the card: each rank's K1
   and K2 once a step, the loss finite, no foreign module in a rank, and
   each rank's last K1 and K2 call (its band, by its row offset) against
   the plain versions on the same inputs (K1 within 2e-4, mean 1e-6; K2
   inside the plain envelope); Mpix/s printed.
7. k3_bound — K3, its plain version and torch.cumsum (the library call)
   timed by CUDA events over back-to-back calls (K3 and torch.cumsum in
   turns, and by the host's clock per call), and K3 and torch.cumsum by the
   profiler's kernel time (with the device operations of a K3 call), on
   the serve view's per-gaussian tile counts ([1, n] int32, the input of
   ops/rasterize/sorting.py's first cumsum) and on [16, 2^20] float32
   N(0,1) (the lane-major form of the reference's packed gradient prefix),
   each against its byte bound, and beside the previous K3 in turns where its
   copy is present.
8. the kernel labs, each lab's counts set to 0 just before and read just
   after: kvariants_lab (kvariants.run_all, K4's five levels on the lab's
   1x3600, 2x3600 and 8x450 tables), then k4_decompose per table (K1 timed
   on the same inputs, each level's bound of the work it needs and of the
   pairs it would walk without the cull, each level in turns with the
   previous design's where its copy is present, the plain versions on
   1x3600) and k4_uneven_tiles (8x450 over 1x3600). The tables' instances
   lie anywhere in the image and almost none meets its tile, so there
   levels 2-4 time the gather and the footprint pass; the serve view and
   the last step split K1's time. xpose_lab (xpose_lab.run_all:
   K5, K6, x.transpose(1, 2).contiguous() and the lab's torch rows) against
   the slab transpose's byte bound.
9. the `kernels` line (K1's launches: serve, train, viewer, codec,
   make_synth_scene, drivers, bench, rd_branch's two in-process runs,
   sharded_bands, sharded_train, sharded_driver, scaling_bench and the
   raster_tools scripts; K2's: train, drivers, bench, rd_branch, the
   sharded three, scaling_bench and the raster_tools scripts but
   fps_bench; the CDF kernel's: the host check, codec, cdf_check and
   drivers, the last for every driver and tool script of phase 6b; the
   projection's: serve and train, forward, cull and backward),
   then the card line from nvidia-smi, then the result.
"""

import collections
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

W, H = 1280, 720
N_VIEWS = 32                 # a full orbit
WARMUP = 5                   # render_set leaves the first 5 views out
PEAK_FP32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
# exp on the special-function units: 16 results per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
PEAK_FP64_FLOPS = 33.5e12    # H100 SXM, float64 outside the tensor cores
# float32 operations K1 spends on a (pixel, instance) pair, by how far the
# pair gets in the kernel's loop (csrc/blend_forward.cu), keyed as the plain
# version's pair counts: every pair walked takes dx, dy and power (11); one
# with power <= 0 takes the exp (counted on the SFU) and min(0.99, op·e)
# (2); one with alpha >= 1/255 takes T·(1-α) (2); one blended takes α·T and
# three rgb multiply-adds (7).
OPS = dict(evaluated=11, exp=2, tested=2, blended=7)
# float32 operations K2 spends on a pair up to last_contrib
# (csrc/blend_backward.cu): dx, dy and power (11) for every pair; op·e and
# the 0.99 clamp (2) where power <= 0 (the exp on the SFU); for a blended
# pair the colour dot product, the prefix, 1 - α and its reciprocal, dL/dα,
# the colour gradients and the T update (20), the gradients of opacity, mean
# and conic (19), and the 9 additions that sum the pixels' values (9).
OPS_K2 = dict(bwd_evaluated=11, bwd_exp=2, bwd_blended=48)
# the work the result needs: only the pairs that reach alpha >= 1/255 (K1:
# T·(1-α) tested; K2: blended) need their power, exp and the rest; a pair
# rejected at alpha < 1/255 needs none, and the kernels' culls skip it
NEED_K1 = dict(tested=11 + 2 + 2, blended=7)
NEED_K2 = dict(bwd_blended=11 + 2 + 48)
# K2's warp-level costs per (warp, instance) pair with a blended pixel:
# shuffles of the previous design's nine butterflies and of the
# reduce-scatter; global
# atomics per (warp, instance) then, per (tile, instance) now (at most)
K2_SHUFFLES = dict(prev=9 * 5, new=5 + 3 + 2 + 1 + 1)
# the previous design's K2 and K3 sources, copied here to time old against
# new in one
# call; not in the repository, so the phase is skipped where they are absent
PREV_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "prev")
PREV_SOURCES = dict(k3="scan_prev.cu", k2="blend_backward_prev.cu")
# K1 and K2 as they were before the row offset (their sources, copied from
# git history to build/prev_offset/blend_{forward,backward}_nooffset.cu):
# their registers and spills beside the new ones, and the two timed in
# turns on the serve view; skipped where the copies are absent
PREV_OFFSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "prev_offset")
PREV_OFFSET = dict(k1="blend_forward_nooffset.cu",
                   k2="blend_backward_nooffset.cu")
# K2's knock-outs, written from its source by text edits into build/ and
# timed beside it on the serve view: what each part of K2 costs. Each edit
# is (text of csrc/blend_backward.cu, replacement); a variant whose text is
# not found (the source changed) is skipped, not failed.
K2_HALVES = "".join(f"          halve<{s}, {d}>(g, wl & {d});\n" for s, d in (
    (9, 16), (5, 8), (3, 4), (2, 2), (1, 1)))
K2_KNOCKOUTS = {
    # the leader lanes store their own nine values' sum: no shuffles (the
    # gradient is wrong; the work before the reduction is all kept)
    "no_reduce_scatter": [(K2_HALVES, "          g[0] = g[0] + g[1] + g[2] + "
                           "g[3] + g[4] + g[5] + g[6] + g[7] + g[8];\n")],
    # every warp walks every instance and takes every exp: no cull (the
    # gradient is the same)
    "no_cull": [("        if (!((s_warps[j] >> warp) & 1u)) continue;     "
                 "// warp-uniform\n", ""),
                ("power <= 0.0f && !(power < s_ntau[j])", "power <= 0.0f")],
}
K2_KNOCKOUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "k2_knockouts")
# K1's warp geometries, by the pixels a warp covers: (kWarpW, kPerThread) of
# csrc/blend_forward.cu, a warp kWarpW wide and 32 / kWarpW · kPerThread
# tall. The source holds the one chosen; the others are written from it by
# text edits into build/ and timed beside it (skipped where the edits do not
# apply).
K1_GEOMETRIES = {"16x2": (16, 1), "8x4": (8, 1), "8x8_2px": (8, 2),
                 "16x4_2px": (16, 2)}
K1_GEOMETRY_LINES = (r"constexpr int kWarpW = (\d+);",
                     r"constexpr int kPerThread = (\d+);")
K1_GEOMETRY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "k1_geometries")
# float32 operations of K4's levels 2-4 (scripts/csrc/kvariants.cu) on a
# pair, keyed as OPS. Needed (NEED_K4), as NEED_K1 counts them: a pair that
# reaches alpha >= 1/255 takes its power, exp and clamp (13); level 2 adds
# it to its sink (1), with no early exit (its pairs counted at t_eps 0);
# level 3 adds T·(1-α) (2) and, for a blended pair, α·T and the sink's add
# (2); level 4 is K1: NEED_K1. Walked (OPS_K4, bound_walked_ms): every
# listed pair that each pixel reaches, as the previous design walked them:
# level 2 adds each alpha >= 1/255 to its sink (1); level 3 adds T·(1-α)
# (2) and, for a blended pair, α·T and the sink's add (2); level 4 OPS.
NEED_K4 = {2: dict(tested=11 + 2 + 1), 3: dict(tested=11 + 2 + 2, blended=2),
           4: NEED_K1}
OPS_K4 = {2: dict(evaluated=11, exp=2, tested=1),
          3: dict(evaluated=11, exp=2, tested=2, blended=2), 4: OPS}
# K4's source before its levels became stages of K1's per-warp design (one
# thread a pixel walking every listed instance), copied from git history
# to build/prev/kvariants_prev.cu: each level timed in turns with the new
# one and held equal to it, and K1 bit-equal to its level 4; skipped where
# the copy is absent
PREV_K4 = os.path.join(PREV_DIR, "kvariants_prev.cu")
K4_LEVELS = range(5)
ENVELOPE = 1.5e-3            # K2 against the plain envelope, of max |grad|
TRAIN_STEPS = 90
# first and last step of each phase of the train cell
TRAIN_PHASES = dict(plain=(1, 30), noise=(31, 60), context=(61, 90))
SPLIT_FROM = 6               # steps 1-5 hold the allocator's warm-up
# the training step's module-level calls the train split times; "context"
# (multi_scale_generate and estimate_rate) runs inside "forward"
TRAIN_STAGES = ("levels", "forward", "context", "loss", "backward", "adam",
                "stats", "densify")
# the renderer's module-level calls the stage split times, in call order
STAGES = ("visible_filter", "decode_neural_gaussians", "project_gaussians",
          "expand_and_sort", "blend_forward")
# what the split keeps of a stage's output: decoded gaussians, and the
# instance count and gaussians touching a tile
STAGE_COUNTS = {
    "decode_neural_gaussians": lambda ng: ng.xyz.shape[0],
    "expand_and_sort": lambda inst: (inst.demand, inst.n_vis)}


# the phase running now and the last phase printed, for the failure line
PROGRESS = {"phase": "start", "last_printed": None}


class SmokeFailure(Exception):
    """A check of this script that did not hold."""


def emit(**obj):
    PROGRESS["last_printed"] = obj.get("phase")
    print(json.dumps(obj), flush=True)


def begin(phase):
    """Name the phase that runs from here on."""
    PROGRESS["phase"] = phase


def check(ok, what):
    if not ok:
        raise SmokeFailure(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps):
    """Mean device time of `fn` over `reps` back-to-back calls after a
    warm-up, by CUDA events."""
    from contextgs_tpu_torch.scripts import time_ms

    return time_ms(fn, torch.device("cuda"), reps)


def card_ms(fn, reps=20, cold=False):
    """Mean time of a call of `fn` on the card with the host's launch gaps
    hidden: the card spins (`torch.cuda._sleep`) while the host enqueues,
    and CUDA events bracket the calls alone. Warm: `reps` calls back to
    back, the later finding in the 50 MB L2 what the earlier left there.
    Cold: each call alone after the card reads 256 MB, five times the L2, so
    that the cache holds clean lines of that buffer only (a write would
    leave dirty lines for the call to write back)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    if not cold:
        torch.cuda._sleep(1 << 23)        # ~4 ms, for the host to enqueue
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
    total = 0.0
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(1 << 20)        # ~0.5 ms
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def orbit_cameras(n, width, height, target_seed):
    from contextgs_tpu_torch.scene.cameras import Camera

    rng = np.random.default_rng(target_seed)
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        Rm = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
        target = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
        cams.append(Camera(uid=i, colmap_id=i, R=Rm,
                           T=np.array([0.0, 0.0, 4.0]), fov_x=1.2,
                           fov_y=2 * math.atan(math.tan(0.6) * height / width),
                           image=target, width=width, height=height))
    return cams


@contextlib.contextmanager
def wrapped(module, name, wrap):
    """Replace `module.name` by `wrap(original)` for the block."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def keep_args(store):
    """Wrapper that keeps the arguments of the last call in `store`."""
    def wrap(fn):
        def call(*args):
            store["args"] = args
            return fn(*args)
        return call
    return wrap


def timed_call(name, log, summary=lambda out: None):
    """Wrapper that brackets each call with CUDA events, logged as
    (name, start, end, summary(output))."""
    def wrap(fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            log.append((name, start, end, summary(out)))
            return out
        return call
    return wrap


def stage_targets():
    """(module, name) of each stage: the names the decoded renderer and
    rasterize look up at call time."""
    import contextgs_tpu_torch.evaluation as tev
    import contextgs_tpu_torch.ops.rasterize as trz

    return [(tev if n == "decode_neural_gaussians" else trz, n)
            for n in STAGES]


def render_keeping_k1(render, cam, bg):
    """One view through the renderer; returns K1's arguments from it."""
    import contextgs_tpu_torch.ops.rasterize as trz

    store = {}
    with wrapped(trz, "blend_forward", keep_args(store)):
        render(cam.as_device_dict(), bg)
    return store["args"]


def compare_k1(rows, ids, bounds, width, height, t_eps=1e-4, row_offset=0):
    """K1 against its plain version on the same card inputs."""
    from contextgs_tpu_torch.ops.rasterize import reference, tile_kernel

    got = tile_kernel.blend_forward(rows, ids, bounds, width, height, t_eps,
                                    row_offset)
    want = reference.blend_tiles_reference(rows, ids, bounds, width, height,
                                           (width + 15) // 16, t_eps=t_eps,
                                           row_offset=row_offset)
    torch.cuda.synchronize()
    diff = torch.cat([(got[0] - want[0]).abs().flatten(),
                      (got[1] - want[1]).abs().flatten()])
    pix = torch.maximum((got[0] - want[0]).abs().amax(0),
                        (got[1] - want[1]).abs())
    return dict(max_abs=float(diff.max()), mean_abs=float(diff.mean()),
                pixels_over_2e5=int((pix > 2e-5).sum()),
                last_contrib_mismatch=int((got[2] != want[2]).sum()),
                finite=bool(torch.isfinite(got[0]).all()
                            and torch.isfinite(got[1]).all()))


def golden_cases(dev):
    """Small blend cases: random rows 48x32, an occluder, and the case where
    the Pallas forward resets T at a chunk boundary (kernel must give G=0)."""
    rng = np.random.default_rng(11)
    n = 300
    rows = np.zeros((n, 9), np.float32)
    rows[:, 0] = rng.uniform(-4, 52, n)
    rows[:, 1] = rng.uniform(-4, 36, n)
    a, c = rng.uniform(0.005, 0.5, n), rng.uniform(0.005, 0.5, n)
    rows[:, 2:5] = np.stack([a, rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c),
                             c], 1)
    rows[:, 5] = rng.uniform(0.05, 1.0, n)
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    tiles = np.sort(rng.integers(0, 6, 4 * n))
    random_case = (rows, rng.integers(0, n, tiles.size).astype(np.int32),
                   np.searchsorted(tiles, np.arange(7)).astype(np.int32),
                   48, 32)
    occ = np.zeros((2, 9), np.float32)
    occ[:, 0:2] = 15.5
    occ[:, 2] = occ[:, 4] = 0.002
    occ[:, 5] = [1.0, 0.9]          # T·(1-α) stays clear of the 1e-4 cut
    occ[0, 6] = occ[1, 7] = 1.0
    occluder_case = (occ, np.int32([0, 1] * 4), np.int32([0, 2, 4, 6, 8]),
                     32, 32)
    cb = np.zeros((384, 9), np.float32)
    cb[:, 0:2] = 7.5
    cb[:, 2] = cb[:, 4] = 1e-4
    cb[:3, 5] = [0.99, 0.98, 0.99]
    cb[:3, 6] = 1.0
    cb[256, 5] = 0.3
    cb[256, 7] = 1000.0
    chunk_case = (cb, np.arange(384, dtype=np.int32), np.int32([0, 384]),
                  16, 16)
    for name, (r, i, b, w, h) in (("random_48x32", random_case),
                                  ("occluder", occluder_case),
                                  ("chunk_boundary", chunk_case)):
        yield name, (torch.from_numpy(r).to(dev), torch.from_numpy(i).to(dev),
                     torch.from_numpy(b).to(dev), w, h)


def cull_cases(dev, width=48, height=32, n=120):
    """Small blend cases that probe K2's footprint cull, in random (tile,
    depth) lists: `edge` puts each splat's alpha >= 1/255 edge, or its
    box's edge, on a warp's row boundary or a tile's column boundary;
    `faint` has opacities just above 1/255, some means on pixel centres;
    `not_pd` has conics with det <= 0 or a <= 0 (no box)."""
    for seed, case in enumerate(("edge", "faint", "not_pd")):
        rng = np.random.default_rng(60 + seed)
        rows = np.zeros((n, 9), np.float32)
        rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
        a, c = rng.uniform(0.01, 0.6, n), rng.uniform(0.01, 0.6, n)
        b = rng.uniform(-0.95, 0.95, n) * np.sqrt(a * c)
        op = rng.uniform(0.05, 1.0, n)
        mx, my = rng.uniform(0, width, n), rng.uniform(0, height, n)
        if case == "edge":
            tau = np.log(255 * op)
            det = a * c - b * b
            reach_y = np.sqrt(2 * tau * a / det)
            reach_x = np.sqrt(2 * tau * c / det)
            boundary = 2 * rng.integers(1, height // 2 - 1, n) - 0.5
            half = n // 2
            my[:half] = (boundary[:half] - reach_y[:half]
                         * rng.choice([-1, 1], half))
            my[half:] = np.round(boundary[half:] + 0.5) - reach_y[half:] - 1
            mx[::3] = (16 * rng.integers(1, width // 16, mx[::3].size) - 0.5
                       - reach_x[::3])
        elif case == "faint":
            op = (1 / 255) * (1 + rng.choice([1e-6, 1e-5, 1e-3, 1e-1], n))
            mx[::2], my[::2] = np.round(mx[::2]), np.round(my[::2])
        else:       # small enough that exp(power) stays finite
            a, c = rng.uniform(0.001, 0.015, n), rng.uniform(0.001, 0.015, n)
            b = (rng.choice([-1, 1], n) * np.sqrt(a * c)
                 * rng.uniform(1.0, 1.5, n))
            a[::4] = -a[::4]
            c[1::4] = -c[1::4]
        rows[:, 0], rows[:, 1], rows[:, 5] = mx, my, op
        rows[:, 2:5] = np.stack([a, b, c], 1)
        n_tiles = -(-width // 16) * -(-height // 16)
        tiles = np.sort(rng.integers(0, n_tiles, 4 * n))
        ids = rng.integers(0, n, tiles.size).astype(np.int32)
        bounds = np.searchsorted(tiles, np.arange(n_tiles + 1)).astype(
            np.int32)
        yield f"cull_{case}", (torch.from_numpy(rows).to(dev),
                               torch.from_numpy(ids).to(dev),
                               torch.from_numpy(bounds).to(dev), width,
                               height)


def roofline(n_bytes, n_ops, n_exp):
    """The least time for the work, and which term sets it: the bytes at
    the HBM rate, the float32 operations at the CUDA cores' rate, the exps
    at the special-function units' rate."""
    terms = dict(bytes=n_bytes / PEAK_HBM_BYTES * 1e3,
                 fp32=n_ops / PEAK_FP32_FLOPS * 1e3,
                 exp=n_exp / SFU_EXP_PER_S * 1e3)
    term = max(terms, key=terms.get)
    return dict(bytes_ms=terms["bytes"], fp32_ops_ms=terms["fp32"],
                exp_ms=terms["exp"], bound_ms=terms[term], bound_by=term)


def bounds_of(n_bytes, pairs, need, walked, need_exp, walked_exp):
    """The roofline of the work these inputs need (`need`: operations per
    pair by key, `need_exp` the key whose pairs take an exp), and beside it,
    as bound_walked_ms, that of every pair the kernel walks (`walked`,
    `walked_exp`)."""
    out = roofline(n_bytes, sum(n * pairs[k] for k, n in need.items()),
                   pairs[need_exp])
    walk = roofline(n_bytes, sum(n * pairs[k] for k, n in walked.items()),
                    pairs[walked_exp])
    out.update(fp32_ops=sum(n * pairs[k] for k, n in need.items()),
               bound_walked_ms=walk["bound_ms"],
               bound_walked_by=walk["bound_by"])
    return out


def k1_bound_of(rows, ids, bounds, width, height, pairs):
    """K1's bound on these inputs: bytes, the rows of gaussians with tile
    instances, ids and bounds read once, rgb, final T and last_contrib
    written once; operations and exps of the pairs that reach alpha >=
    1/255 (walked: of every pair the previous design's loop reaches, each
    pixel walking its whole list until done)."""
    rows_read = int(torch.unique(ids).numel())
    n_bytes = (rows_read * rows.shape[1] * 4 + ids.numel() * 4
               + bounds.numel() * 4 + height * width * (3 + 1 + 1) * 4)
    return dict(rows_read=rows_read, bytes=n_bytes, **bounds_of(
        n_bytes, pairs, NEED_K1, OPS, "tested", "exp"))


def k2_bound_of(rows, ids, bounds, width, height, pairs):
    """K2's bound on these inputs: bytes, the rows of gaussians with tile
    instances, ids and bounds, K1's three outputs and the two cotangents
    read once, d_rows written once; operations and exps of the blended
    pairs (walked: of every pair up to last_contrib). With the shuffles and
    global atomics of the previous design (nine butterflies and nine
    atomics per (warp, instance) with a blended pixel) and of this one (a
    12-shuffle reduce-scatter; at most nine atomics per (tile,
    instance))."""
    rows_read = int(torch.unique(ids).numel())
    n_bytes = (rows_read * rows.shape[1] * 4 + ids.numel() * 4
               + bounds.numel() * 4 + height * width * (3 + 1 + 1 + 3 + 1) * 4
               + rows.numel() * 4)
    warps = pairs["bwd_warp_blended"]
    return dict(rows_read=rows_read, bytes=n_bytes, **bounds_of(
        n_bytes, pairs, NEED_K2, OPS_K2, "bwd_blended", "bwd_exp"),
        shuffles_prev=K2_SHUFFLES["prev"] * warps,
        shuffles=K2_SHUFFLES["new"] * warps,
        atomics_prev=9 * warps, atomics_at_most=9 * pairs["bwd_tile_blended"],
        shuffles_per_touched_warp=K2_SHUFFLES["new"] * warps
        / max(pairs["bwd_warp_touched"], 1))


def k2_knockout_sources():
    """{name: path} of K2's knock-outs written from its source, those whose
    edits apply."""
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    text = tile_kernel.BACKWARD_SOURCE.read_text()
    os.makedirs(K2_KNOCKOUT_DIR, exist_ok=True)
    out = {}
    for name, edits in K2_KNOCKOUTS.items():
        variant = text
        for old, new in edits:
            if old not in variant:
                break
            variant = variant.replace(old, new)
        else:
            path = os.path.join(K2_KNOCKOUT_DIR, f"blend_backward_{name}.cu")
            with open(path, "w") as f:
                f.write(variant)
            out[name] = path
    return out


def k1_geometry(text):
    """The name in K1_GEOMETRIES of the geometry a K1 source holds."""
    found = tuple(int(re.search(line, text).group(1))
                  for line in K1_GEOMETRY_LINES)
    return next(n for n, g in K1_GEOMETRIES.items() if g == found)


def k1_warp(name):
    """(wide, tall) pixels of a warp of the K1 geometry `name`, as
    reference.FWD_WARP gives them."""
    width, per_thread = K1_GEOMETRIES[name]
    return width, 32 // width * per_thread


def k1_geometry_sources():
    """(the geometry K1's source holds, {name: path} of the others written
    from it, those whose edits apply)."""
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    text = tile_kernel.SOURCE.read_text()
    chosen = k1_geometry(text)
    os.makedirs(K1_GEOMETRY_DIR, exist_ok=True)
    out = {}
    for name, values in K1_GEOMETRIES.items():
        variant = text
        for line, value in zip(K1_GEOMETRY_LINES, values):
            variant = re.sub(line, line.replace(r"(\d+)", str(value)),
                             variant, count=1)
        if name != chosen and k1_geometry(variant) == name:
            path = os.path.join(K1_GEOMETRY_DIR, f"blend_forward_{name}.cu")
            with open(path, "w") as f:
                f.write(variant)
            out[name] = path
    return chosen, out


def k1_from(source):
    """The K1 of `source` (another warp geometry) behind the launch of K1's
    wrapper: the same arguments, the outputs allocated alike, the cached
    function."""
    from contextgs_tpu_torch.ops import cuda_build
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    def call(rows, ids, bounds, width, height, t_eps=1e-4, row_offset=0):
        out = (torch.empty((3, height, width), device=rows.device),
               torch.empty((height, width), device=rows.device),
               torch.empty((height, width), dtype=torch.int32,
                           device=rows.device))
        fn = cuda_build.c_function(source, "blend_forward",
                                   tile_kernel.FORWARD_ARGTYPES)
        err = cuda_build.launch(
            fn, rows.device, rows.data_ptr(), ids.data_ptr(),
            bounds.data_ptr(), width, height, (width + 15) // 16,
            bounds.numel() - 1, row_offset, t_eps,
            *(x.data_ptr() for x in out))
        check(err == 0, f"K1 of {source}: CUDA error {err}")
        return out
    return call


def ptxas_kernels(stem):
    """{kernel: ptxas's lines} of a source built in this process: stack,
    spills, registers and shared memory of each kernel."""
    from contextgs_tpu_torch.ops import cuda_build

    out = cuda_build.build_log.get(stem, {}).get("ptxas", "")
    kernels, name = {}, None
    for line in out.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)", line)
        if found:
            name = found.group(1)
            kernels.setdefault(name, [])
        elif name and ("Used" in line or "spill" in line):
            kernels[name].append(line.replace("ptxas info    :", "").strip())
    return kernels


def k1_equals_v4(case, rows, ids, bounds, width, height, t_eps=1e-4,
                 others=None, old_k4=None):
    """K1 against K4's level 4 (scripts/csrc/kvariants.cu: K1's design with
    the row gather staged by cp.async), on the same card inputs: rgb, final
    T and last_contrib torch.equal; and each other warp geometry of K1 in
    `others` ({name: call}) likewise. With `old_k4` (the previous design's
    K4, `k4_from`), K1 also against its level 4, the design before K1's
    per-warp lists. Emits k1_old_new and fails unless all are equal."""
    from contextgs_tpu_torch.ops.rasterize import tile_kernel
    from contextgs_tpu_torch.scripts import kvariants

    args = (rows, ids, bounds, width, height, t_eps)
    v4 = kvariants.blend_variant(4, *args)
    outs = {"k1": tile_kernel.blend_forward(*args)}
    outs.update({name: call(*args) for name, call in (others or {}).items()})
    old = old_k4(4, *args) if old_k4 is not None else None
    torch.cuda.synchronize()
    equal = {name: [bool(torch.equal(a, b)) for a, b in zip(out, v4)]
             for name, out in outs.items()}
    if old is not None:
        equal["k1_vs_previous_v4"] = [bool(torch.equal(a, b))
                                      for a, b in zip(outs["k1"], old)]
    emit(phase="k1_old_new", case=case, equal_rgb_t_last=equal,
         last_contrib_max=int(v4[2].max()))
    check(all(all(v) for v in equal.values()),
          f"K1 bit-equal to K4 v4 on {case}")


def k1_old_new(case, args, others, reps=20):
    """K1 and K4's level 4 (K1's design with its row gather staged by
    cp.async, double-buffered) on the same inputs (rows, ids, bounds,
    width, height, t_eps), in turns (v4, K1, K1, v4), by `card_ms` (host
    gaps hidden) and by CUDA events over back-to-back calls: what the
    asynchronous staging is worth to K1; each other warp geometry in
    `others` in turns with K1 by `card_ms`; and the (warp, instance) pairs
    each geometry walks and takes an exp on, beside the walked pairs / 32
    of a design without the cull."""
    from contextgs_tpu_torch.ops.rasterize import reference, tile_kernel
    from contextgs_tpu_torch.scripts import kvariants

    rows, ids, bounds, width, height, t_eps = args

    def old():
        return kvariants.blend_variant(4, *args)

    def new():
        return tile_kernel.blend_forward(*args)

    kernel = in_turns(old, new, card_ms)
    events = in_turns(old, new, lambda f: cuda_ms(f, reps))
    geometries = {name: in_turns(new, lambda c=call: c(*args), card_ms)
                  for name, call in others.items()}
    warps = {}
    for name in K1_GEOMETRIES:
        with wrapped(reference, "FWD_WARP", lambda _, n=name: k1_warp(n)):
            pairs = reference.blend_tiles_reference(
                rows, ids, bounds, width, height, (width + 15) // 16,
                t_eps=t_eps, count_pairs=True)[3]
        warps[name] = dict(fwd_warp_touched=pairs["fwd_warp_touched"],
                           fwd_warp_exp=pairs["fwd_warp_exp"],
                           pixels=32 * K1_GEOMETRIES[name][1])
    res = dict(case=case, v4_kernel_ms=kernel["prev_ms"],
               k1_kernel_ms=kernel["ms"], kernel_turns=kernel,
               v4_ms=events["prev_ms"], k1_ms=events["ms"],
               events_turns=events,
               v4_over_k1_kernel=kernel["prev_ms"] / kernel["ms"],
               geometries={name: dict(ms=t["ms"], k1_ms=t["prev_ms"],
                                      turns=t)
                           for name, t in geometries.items()},
               warp_pairs=warps,
               unculled_warp_pairs=pairs["evaluated"] / 32,
               pairs_evaluated=pairs["evaluated"],
               pairs_tested=pairs["tested"], pairs_blended=pairs["blended"])
    emit(phase="k1_old_new", **res)
    return res


def k2_knockouts(sources, args):
    """K2 and its knock-outs on the same inputs by `card_ms`, in turns (K2,
    each knock-out, each again in reverse, K2), and each one's largest
    difference from K2 in units of the largest |grad|."""
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    calls = {"k2": lambda: tile_kernel.blend_backward(*args)}
    calls.update({name: (lambda c=k2_from(path): c(*args))
                  for name, path in sources.items()})
    order = list(calls) + list(calls)[::-1]
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(card_ms(calls[name]))
    want = calls["k2"]()
    return {name: dict(ms=sum(t) / len(t), turns=t, max_diff_of_max_grad=float(
        (calls[name]() - want).abs().max() / want.abs().max()))
        for name, t in times.items()}


def prev_offset_sources():
    """K1's and K2's sources from before the row offset, or None where a
    copy is absent."""
    srcs = {k: os.path.join(PREV_OFFSET_DIR, f)
            for k, f in PREV_OFFSET.items()}
    return srcs if all(map(os.path.exists, srcs.values())) else None


def offset_turns(sources, k1_args, cot):
    """K1 and K2 beside their sources from before the row offset on the
    same unbanded inputs: equal (K1 bit for bit, K2 to its atomics' order)
    and timed in turns (old, new, new, old) by `cuda_ms`."""
    import ctypes

    from contextgs_tpu_torch.ops import cuda_build
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    rows, ids, bounds, width, height, t_eps = k1_args
    dev = rows.device
    tiles_x, n_tiles = (width + 15) // 16, bounds.numel() - 1
    old_f = cuda_build.c_function(
        sources["k1"], "blend_forward",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
        + [ctypes.c_void_p] * 4)
    old_b = cuda_build.c_function(
        sources["k2"], "blend_backward",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    head = (rows.data_ptr(), ids.data_ptr(), bounds.data_ptr())
    fwd = tile_kernel.blend_forward(rows, ids, bounds, width, height, t_eps)
    d_rgb, d_ft = cot

    def k1_old():
        out = (torch.empty((3, height, width), device=dev),
               torch.empty((height, width), device=dev),
               torch.empty((height, width), dtype=torch.int32, device=dev))
        check(cuda_build.launch(old_f, dev, *head, width, height, tiles_x,
                                n_tiles, t_eps,
                                *(x.data_ptr() for x in out)) == 0,
              "K1 before the row offset launched")
        return out

    def k2_old():
        d = torch.zeros_like(rows)
        check(cuda_build.launch(
            old_b, dev, *head, *(x.data_ptr() for x in fwd),
            d_rgb.data_ptr(), d_ft.data_ptr(), width, height, tiles_x,
            n_tiles, d.data_ptr()) == 0, "K2 before the row offset launched")
        return d

    def k2_new():
        return tile_kernel.blend_backward(rows, ids, bounds, *fwd, d_rgb,
                                          d_ft, width, height, t_eps)

    old_d, new_d = k2_old(), k2_new()
    res = dict(
        k1_equal=all(torch.equal(a, b) for a, b in zip(k1_old(), fwd)),
        k2_max_diff_of_max_grad=float((new_d - old_d).abs().max()
                                      / old_d.abs().max()),
        k1=in_turns(k1_old, lambda: tile_kernel.blend_forward(
            rows, ids, bounds, width, height, t_eps),
            lambda f: cuda_ms(f, 50)),
        k2=in_turns(k2_old, k2_new, lambda f: cuda_ms(f, 50)))
    check(res["k1_equal"], "K1 equal to K1 before the row offset")
    check(res["k2_max_diff_of_max_grad"] <= 1e-5,
          "K2 equal to K2 before the row offset, up to its atomics' order")
    return res


def prev_kernels():
    """The previous K3 and K2 sources under build/prev, or None where a copy is
    absent (a checkout holds only the repository's files)."""
    srcs = {k: os.path.join(PREV_DIR, f) for k, f in PREV_SOURCES.items()}
    return srcs if all(map(os.path.exists, srcs.values())) else None


def prev_k3(source):
    """The previous K3 behind a replica of its wrapper: the library and the
    function looked up on every call, the device guard, the output and the
    block-sum scratch allocated, three launches."""
    import ctypes

    from contextgs_tpu_torch.ops import cuda_build, scan

    def call(x):
        rows = x.view(1, -1) if x.dim() == 1 else x
        r, n = rows.shape
        out = torch.empty_like(x)
        partial = torch.empty((r, -(-n // 4096)), dtype=x.dtype,
                              device=x.device)
        fn = getattr(cuda_build.load_library(source), "lane_cumsum_f32"
                     if x.dtype == torch.float32 else "lane_cumsum_i32")
        if fn.argtypes is None:
            fn.argtypes = scan.ARGTYPES
            fn.restype = ctypes.c_int
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(rows.data_ptr(), out.data_ptr(), partial.data_ptr(), r,
                     n, 0, stream)
        check(err == 0, f"previous K3 launch: CUDA error {err}")
        return out
    return call


def k2_from(source, banded=True):
    """The K2 of `source` (the previous design, or a knock-out) behind the
    launch of K2's wrapper: the same arguments, the zeroed d_rows, the cached
    function. A source from before the row offset (`banded=False`: the
    previous design in build/prev) takes the unbanded inputs only."""
    import ctypes

    from contextgs_tpu_torch.ops import cuda_build
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    argtypes = (tile_kernel.BACKWARD_ARGTYPES if banded else
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                + [ctypes.c_void_p] * 2)

    def call(rows, ids, bounds, rgb, ft, last, d_rgb, d_ft, width, height,
             t_eps=None, row_offset=0):
        tiles_x = (width + 15) // 16
        d_rows = torch.zeros_like(rows)
        fn = cuda_build.c_function(source, "blend_backward", argtypes)
        offset = (row_offset,) if banded else ()
        check(banded or row_offset == 0, "an unbanded K2 takes no offset")
        err = cuda_build.launch(
            fn, rows.device, rows.data_ptr(), ids.data_ptr(),
            bounds.data_ptr(), rgb.data_ptr(), ft.data_ptr(),
            last.data_ptr(), d_rgb.data_ptr(), d_ft.data_ptr(), width,
            height, tiles_x, bounds.numel() - 1, *offset, d_rows.data_ptr())
        check(err == 0, f"K2 of {source}: CUDA error {err}")
        return d_rows
    return call


def in_turns(prev, new, time):
    """`time` of two calls in turns, `prev` (an old kernel, or the library
    call) then `new`: prev, new, new, prev; prev_ms and ms are the means."""
    t = [time(prev), time(new), time(new), time(prev)]
    return dict(prev_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2,
                prev_ms_turns=[t[0], t[3]], ms_turns=[t[1], t[2]])


def cotangents(width, height, seed, dev):
    gen = torch.Generator(dev).manual_seed(seed)
    return (torch.randn((3, height, width), generator=gen, device=dev),
            torch.randn((height, width), generator=gen, device=dev))


def compare_k2(rows, ids, bounds, width, height, d_rgb, d_ft, t_eps=1e-4,
               delta=2e-4, row_offset=0):
    """K2 against its plain version on the same card inputs: the largest
    distance outside the envelope of the plain gradients at t_eps·(1±δ), and
    the share of rows off the plain gradient at t_eps by more than 1e-4, both
    in units of each component's largest |grad|."""
    from contextgs_tpu_torch.ops.rasterize import reference, tile_kernel

    rgb, ft, last = tile_kernel.blend_forward(rows, ids, bounds, width,
                                              height, t_eps, row_offset)
    got = tile_kernel.blend_backward(rows, ids, bounds, rgb, ft, last, d_rgb,
                                     d_ft, width, height, t_eps, row_offset)
    torch.cuda.reset_peak_memory_stats()
    plain = torch.stack([reference.blend_tiles_backward_reference(
        rows, ids, bounds, rgb, ft, last, d_rgb, d_ft, width, height,
        t_eps * f, row_offset) for f in (1 - delta, 1.0, 1 + delta)])
    torch.cuda.synchronize()
    scale = plain[1].abs().amax(0).clamp_min(1e-30)
    outside = torch.maximum((plain.amin(0) - got) / scale,
                            (got - plain.amax(0)) / scale).clamp_min(0)
    off = ((got - plain[1]).abs() / scale).amax(1)
    return dict(envelope_err=float(outside.max()),
                rows_off_1e4=float((off > 1e-4).float().mean()),
                max_abs=float((got - plain[1]).abs().max()),
                max_grad=float(plain[1].abs().max()),
                finite=bool(torch.isfinite(got).all()),
                plain_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def check_k2(case, res):
    emit(phase="k2_check", case=case, **res)
    check(res["finite"] and res["envelope_err"] <= ENVELOPE,
          f"K2 {case} inside the plain envelope")


def keep_call(store):
    """Wrapper that keeps the arguments and keywords of the last call in
    `store["call"]`."""
    def wrap(fn):
        def call(*args, **kw):
            store["call"] = (args, kw)
            return fn(*args, **kw)
        return call
    return wrap


# bytes a gaussian (an anchor) each projection kernel must move: the
# forward reads means, scales, quats (12, 12, 16), opacities (4) and valid
# (1) and writes means2d, conics, depths, radii, the two rects and n_tiles
# (48); the cull reads means and the scales' first three (24) and valid (1)
# and writes the mask (1); the backward reads means, scales, quats and the
# cotangents of means2d and conics (8, 12; depths' where given, 4) and
# writes the three gradients (40)
PROJ_BYTES = dict(forward=45 + 48, cull=25 + 1, backward=40 + 20 + 40)


def grad_gap(got, want):
    """(‖g − w‖ / ‖w‖, max |g − w| / max |w|), the worst leaf's of each,
    over the elements where `want` is finite; None where `got` is not finite
    there."""
    norm, elem = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        fin = torch.isfinite(w)
        if not bool(torch.isfinite(g[fin]).all()):
            return None
        g, w = torch.where(fin, g, 0.0), torch.where(fin, w, 0.0)
        norm = max(norm, float((g - w).norm() / w.norm()))
        elem = max(elem, float((g - w).abs().max() / w.abs().max()))
    return norm, elem


def projection_check(where, proj_call, cull_call, dev, backward_seed=None):
    """The projection's kernels (ops/rasterize/csrc/projection.cu) against
    the plain chain on the last inputs a phase gave them (`keep_call`):
    outputs, the cull mask and, with `backward_seed`, the gradient of
    seeded cotangents of means2d and conics against autograd of the plain
    chain and reference.project_vjp_reference; each timed by events beside
    the plain chain, and its bound from bytes at 3.35 TB/s."""
    from contextgs_tpu_torch.ops.rasterize import projection as tproj
    from contextgs_tpu_torch.ops.rasterize import reference

    args, kw = proj_call
    args = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)
    kw = {k: v.detach() if isinstance(v, torch.Tensor) else v
          for k, v in kw.items()}
    n = args[0].shape[0]
    with torch.no_grad():
        got = tproj.project_gaussians(*args, **kw)
        want = tproj.project_gaussians_plain(*args, **kw)
    res = dict(where=where, n_gaussians=n, kept=int((want.radii > 0).sum()))
    for name in ("means2d", "conics", "depths"):
        a, b = getattr(got, name), getattr(want, name)
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        rel = torch.where(same, 0.0, (a - b).abs() / b.abs())
        res[f"{name}_max_rel"] = float(rel.max())
        res[f"{name}_bit_equal"] = bool(same.all())
    res["int_mismatch"] = {
        name: int((getattr(got, name) != getattr(want, name)).reshape(
            n, -1).any(1).sum())
        for name in ("radii", "rect_min", "rect_max", "n_tiles")}
    c_args, c_kw = cull_call
    c_args = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                   for a in c_args)
    n_anchors = c_args[0].shape[0]
    with torch.no_grad():
        res["cull_mismatch"] = int((tproj.visible_filter(*c_args, **c_kw)
                                    != tproj.visible_filter_plain(
                                        *c_args, **c_kw)).sum())
    res["n_anchors"] = n_anchors
    with torch.no_grad():
        res["ms"] = cuda_ms(lambda: tproj.project_gaussians(*args, **kw), 50)
        res["plain_ms"] = cuda_ms(
            lambda: tproj.project_gaussians_plain(*args, **kw), 5)
        res["card_ms"] = card_ms(lambda: tproj.project_gaussians(*args,
                                                                 **kw))
        res["cull_ms"] = cuda_ms(lambda: tproj.visible_filter(*c_args,
                                                              **c_kw), 50)
        res["cull_plain_ms"] = cuda_ms(
            lambda: tproj.visible_filter_plain(*c_args, **c_kw), 5)
        res["cull_card_ms"] = card_ms(
            lambda: tproj.visible_filter(*c_args, **c_kw))
    res["bound_ms"] = PROJ_BYTES["forward"] * n / PEAK_HBM_BYTES * 1e3
    res["cull_bound_ms"] = PROJ_BYTES["cull"] * n_anchors / PEAK_HBM_BYTES * 1e3
    ok = (all(res[f"{k}_max_rel"] <= 2e-6
              for k in ("means2d", "conics", "depths"))
          and not any(res["int_mismatch"].values())
          and res["cull_mismatch"] == 0)
    if backward_seed is not None:
        gen = torch.Generator(dev).manual_seed(backward_seed)
        d_m = torch.randn((n, 2), generator=gen, device=dev)
        d_c = torch.randn((n, 3), generator=gen, device=dev)

        def grads(project):
            leaves = [a.clone().requires_grad_() for a in args[:3]]
            out = project(*leaves, *args[3:], **kw)
            return torch.autograd.grad(
                (out.means2d * d_m).sum() + (out.conics * d_c).sum(), leaves)

        g_kernel, g_plain = grads(tproj.project_gaussians), grads(
            tproj.project_gaussians_plain)
        smod = args[10] if len(args) > 10 else kw.get("scale_modifier", 1.0)
        g_ref = reference.project_vjp_reference(*args[:9], d_m, d_c, None,
                                                scale_modifier=smod)
        res["grad_vs_autograd"] = grad_gap(g_kernel, g_plain)
        res["grad_vs_reference"] = grad_gap(g_kernel, g_ref)
        geom = tproj._geometry(
            *args[5:9], args[9] if len(args) > 9 else kw.get("tile_size", 16),
            smod, kw.get("tile_band"))
        res["backward_ms"] = cuda_ms(lambda: tproj._project_backward(
            args[:5], geom, d_m, d_c, None), 50)
        res["backward_card_ms"] = card_ms(lambda: tproj._project_backward(
            args[:5], geom, d_m, d_c, None))
        res["fwd_bwd_ms"] = cuda_ms(lambda: grads(tproj.project_gaussians),
                                    20)
        res["fwd_bwd_plain_ms"] = cuda_ms(
            lambda: grads(tproj.project_gaussians_plain), 5)
        res["backward_bound_ms"] = (PROJ_BYTES["backward"] * n
                                    / PEAK_HBM_BYTES * 1e3)
        ok = ok and all(g is not None and g[0] <= 1e-5 and g[1] <= 1e-4
                        for g in (res["grad_vs_autograd"],
                                  res["grad_vs_reference"]))
    emit(phase="projection_check", **res)
    check(ok, f"the projection's kernels against the plain chain, {where}")
    return res


# bytes the binning must move: it reads each gaussian slot's depth, tile
# count and both rects once (24) and writes each instance's gaussian id and
# each tile's bound once (4 each)
BIN_BYTES = dict(slot=4 + 4 + 8 + 8, instance=4, tile=4)


def binning_check(where, sort_args):
    """The binning's kernels (ops/rasterize/csrc/binning.cu) against the
    plain chain on the last arguments a phase gave expand_and_sort
    (`keep_args`): gauss_ids, tile_bounds, demand and n_vis equal, two
    launches a call; the kernels and the chain each timed by `call_costs`
    (host time, kernels and device time a call, events), and the kernels'
    bound from bytes at 3.35 TB/s."""
    from contextgs_tpu_torch.ops.rasterize import sorting as tsort

    proj, tiles_x, tiles_y = sort_args[:3]
    row0 = sort_args[3] if len(sort_args) > 3 else 0
    proj = proj._replace(**{k: getattr(proj, k).detach()
                            for k in proj._fields})
    before = tsort.launches
    got = tsort.expand_and_sort(proj, tiles_x, tiles_y, row0)
    launches = tsort.launches - before
    want = tsort.expand_and_sort_plain(proj, tiles_x, tiles_y, row0)
    n, n_tiles = proj.depths.shape[0], tiles_x * tiles_y
    equal = dict(gauss_ids=bool(torch.equal(got.gauss_ids, want.gauss_ids)),
                 tile_bounds=bool(torch.equal(got.tile_bounds,
                                              want.tile_bounds)),
                 demand=got.demand == want.demand,
                 n_vis=int(got.n_vis) == int(want.n_vis))
    n_bytes = (BIN_BYTES["slot"] * n + BIN_BYTES["instance"] * want.demand
               + BIN_BYTES["tile"] * (n_tiles + 1))
    res = dict(where=where, n_gaussians=n, instances=want.demand,
               n_vis=int(want.n_vis), tiles=n_tiles, row0=row0,
               sort_bits=tsort.tile_sort_bits(n_tiles), equal=equal,
               launches=launches, bytes=n_bytes,
               bound_ms=n_bytes / PEAK_HBM_BYTES * 1e3,
               kernel=call_costs(lambda: tsort.expand_and_sort(
                   proj, tiles_x, tiles_y, row0), 20),
               chain=call_costs(lambda: tsort.expand_and_sort_plain(
                   proj, tiles_x, tiles_y, row0), 5))
    emit(phase="binning_check", **res)
    check(all(equal.values()) and launches == 2,
          f"the binning's kernels equal to the plain chain in two launches, "
          f"{where}")
    return res


# the carry's inputs at BungeeNeRF's training sizes (`bungeenerf-train`: 600k
# anchors in 2.4M slots, K = 10): (name, keys, value type, keys that lead in
# sorted order, share of them that start a group); the keys past the lead
# are the sentinel group of free slots or dropped candidates, one start-free
# run to the end. `dense` starts a group at every key: the bytes' worst case.
CARRY_CASES = (("level_map_2.4M", 2_400_000, torch.int64, 600_000, 0.2),
               ("round_26.4M", 26_400_000, torch.int32, 640_000, 0.5),
               ("dense_26.4M", 26_400_000, torch.int64, 26_400_000, 1.0))


def carry_inputs(n, dtype, lead, share, dev, seed):
    """(is_start, values) of a carry case: a level map carries a permutation
    of the slots (`order`), a round the 0/1 flags of anchors and candidates
    (2.4M anchor slots first)."""
    gen = torch.Generator(dev).manual_seed(seed)
    is_start = torch.zeros(n, dtype=torch.bool, device=dev)
    is_start[:lead] = torch.rand(lead, generator=gen, device=dev) < share
    is_start[0] = True
    if lead < n:
        is_start[lead] = True                 # the sentinel group
    if dtype == torch.int64:
        values = torch.randperm(n, generator=gen, device=dev)
    else:
        values = (torch.arange(n, device=dev) >= 2_400_000).to(dtype)
    return is_start, values


def carry_check(dev):
    """The carry kernel (ops/csrc/carry.cu) against the plain chain
    (levels.segmented_carry_plain: arange, where, torch.cummax, gather) at
    the city's sizes: bit-equal, one launch a call; each timed by
    `call_costs` (host time, kernels and device time a call, events), with
    the kernel's bound from the bytes the case needs (flags, outputs, one
    value read a start) and its worst case (every key a start: 17 bytes a
    key with int64 values) at 3.35 TB/s."""
    from contextgs_tpu_torch.models import levels
    from contextgs_tpu_torch.ops import carry

    out = {}
    for i, (name, n, dtype, lead, share) in enumerate(CARRY_CASES):
        is_start, values = carry_inputs(n, dtype, lead, share, dev, 40 + i)
        before = carry.launches
        got = levels.segmented_carry(is_start, values)
        launches = carry.launches - before
        want = levels.segmented_carry_plain(is_start, values)
        size = values.element_size()
        starts = int(is_start.sum())
        n_bytes = n * (1 + size) + starts * size
        res = dict(case=name, keys=n, dtype=str(dtype).replace("torch.", ""),
                   starts=starts, equal=bool(torch.equal(got, want)),
                   launches=launches, bytes=n_bytes,
                   bound_ms=n_bytes / PEAK_HBM_BYTES * 1e3,
                   worst_bound_ms=n * (1 + 2 * size) / PEAK_HBM_BYTES * 1e3,
                   kernel=call_costs(
                       lambda: levels.segmented_carry(is_start, values), 20),
                   chain=call_costs(
                       lambda: levels.segmented_carry_plain(is_start, values),
                       5))
        # one kernel a call: its time a launch, since the profiler may drop
        # some events of back-to-back calls; where it caught none, the share
        # is taken from the events' time a call
        caught = res["kernel"]["kernels"] > 0
        res["device_ms_a_launch"] = (res["kernel"]["device_ms"]
                                     / res["kernel"]["kernels"]
                                     if caught else None)
        res["share_of_bound"] = res["bound_ms"] / (
            res["device_ms_a_launch"] if caught
            else res["kernel"]["events_ms"])
        res["share_from"] = "device_ms_a_launch" if caught else "events_ms"
        emit(phase="carry_check", **res)
        check(res["equal"] and launches == 1,
              f"the carry kernel equal to the plain chain in one launch, "
              f"{name}")
        out[name] = res
        del is_start, values, got, want
    torch.cuda.synchronize()
    zeroed = all(not bool(buf.any()) for buf in carry._scratch.values())
    emit(phase="carry_check", case="all", scratch_left_zeroed=zeroed)
    check(zeroed, "the carry kernel leaves its scratch zeroed")
    return out


# bytes an element Adam's kernel must move: it reads p, g, m, v and writes
# p, m, v (28); a leaf without a gradient reads no g (24)
ADAM_BYTES = dict(grad=28, no_grad=24)


def device_us(e):
    """Device time of a profiler event, in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def call_costs(fn, reps):
    """What a call of `fn` costs: the host's time to enqueue it (no wait),
    the card's kernels and their device time (torch.profiler), and the time
    a call by events, back to back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return dict(host_ms=host_ms,
                device_ms=sum(device_us(e) for e in kernels) / 1e3 / reps,
                kernels=sum(e.count for e in kernels) / reps,
                events_ms=cuda_ms(fn, reps))


def adam_foreach(params, grads, state, opt, it, scale, b1=0.9, b2=0.999,
                 eps=1e-15):
    """optim.chain_update over every leaf at once in PyTorch's multi-tensor
    ops (torch._foreach_*), in the chain's op order, a division by a host
    scalar as the product with its float32 reciprocal (as the chain's is on
    the card): the library's path to the same update, for scale."""
    from contextgs_tpu_torch.models.state import param_leaves
    from contextgs_tpu_torch.train import optim as toptim

    leaves = param_leaves(params)
    lrs = toptim.group_lrs(opt, it, scale)
    bc1, bc2 = toptim.bias_corrections(state.count + 1, b1, b2)
    ps = list(leaves.values())
    gs = [grads[n] if n in grads else torch.zeros_like(x)
          for n, x in leaves.items()]
    ms, vs = [state.mu[n] for n in leaves], [state.nu[n] for n in leaves]
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs),
                                               1 - b2))
    num = torch._foreach_mul(
        torch._foreach_mul(ms, float(np.float32(1) / np.float32(bc1))),
        [toptim.leaf_lr(n, lrs) for n in leaves])
    den = torch._foreach_sqrt(
        torch._foreach_mul(vs, float(np.float32(1) / np.float32(bc2))))
    torch._foreach_add_(den, eps)
    torch._foreach_sub_(ps, torch._foreach_div(num, den))


def adam_check(where, params, grads, state, opt, it, scale):
    """Adam's kernel (train/csrc/adam.cu) against the op chain
    (optim.chain_update) and the chain in torch._foreach_* ops: one more
    update of `params` and `state` with `grads` at step `it`, each from the
    same values (restored after), p, m and v compared bit for bit; the
    three timed by `call_costs`, and the kernel's bound from bytes at 3.35
    TB/s. The parameters and moments are left as they were."""
    from contextgs_tpu_torch.models.state import param_leaves
    from contextgs_tpu_torch.train import optim as toptim

    leaves = param_leaves(params)
    tensors = {n: (x, state.mu[n], state.nu[n]) for n, x in leaves.items()}
    kept = {n: [t.clone() for t in ts] for n, ts in tensors.items()}

    def restore():
        for n, ts in tensors.items():
            for t, k in zip(ts, kept[n]):
                t.copy_(k)

    def differ(update):
        """Elements of p, m and v whose bits differ from the chain's."""
        update()
        got = {n: [t.clone() for t in ts] for n, ts in tensors.items()}
        restore()
        chain()
        n_differ = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                       for n, ts in tensors.items()
                       for a, b in zip(got[n], ts))
        restore()
        return n_differ

    def kernel():
        toptim.adam_update(params, grads, state, opt, it, scale)

    def chain():
        lrs = toptim.group_lrs(opt, it, scale)
        bc1, bc2 = toptim.bias_corrections(state.count + 1, 0.9, 0.999)
        for n, (p, m, v) in tensors.items():
            toptim.chain_update(p, grads.get(n), m, v, toptim.leaf_lr(n, lrs),
                                0.9, 0.999, bc1, bc2, 1e-15)

    def foreach():
        adam_foreach(params, grads, state, opt, it, scale)

    before = toptim.launches
    res = dict(where=where, leaves=len(leaves),
               with_grad=sum(n in grads for n in leaves),
               elements=sum(x.numel() for x in leaves.values()),
               differ=differ(kernel), launches=toptim.launches - before,
               foreach_differ=differ(foreach))
    n_bytes = sum(x.numel() * ADAM_BYTES["grad" if n in grads else "no_grad"]
                  for n, x in leaves.items())
    res.update(bytes=n_bytes, bound_ms=n_bytes / PEAK_HBM_BYTES * 1e3,
               kernel=call_costs(kernel, 20), chain=call_costs(chain, 5),
               foreach=call_costs(foreach, 10))
    res["share_of_bound"] = (res["bound_ms"] / res["kernel"]["device_ms"]
                             if res["kernel"]["device_ms"] else None)
    restore()
    emit(phase="adam_check", **res)
    check(res["differ"] == 0 and res["launches"] == 1,
          f"Adam's kernel bit-equal to the op chain in one launch, {where}")
    return res


def ssim_grad(dev):
    """The SSIM gradient at 1280x720, card float32 against CPU float64; and
    what a backward in cuDNN's TF32 (the filter switched off TF32 for its
    forward only) gives, for scale."""
    from contextgs_tpu_torch.ops import ssim as tssim

    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)

    def grad(dtype, device):
        x = torch.from_numpy(a).to(device, dtype).requires_grad_(True)
        y = torch.from_numpy(b).to(device, dtype)
        return torch.autograd.grad(tssim.ssim(x, y), x)[0].double().cpu()

    want = grad(torch.float64, "cpu")
    got = grad(torch.float32, dev)

    def forward_only_fp32(img, window):
        c, k = img.shape[0], window.shape[0]
        allow = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return torch.nn.functional.conv2d(
                img[None], window[None, None].expand(c, 1, k, k),
                padding=k // 2, groups=c)[0]
        finally:
            torch.backends.cudnn.allow_tf32 = allow

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with wrapped(tssim, "_filter2d", lambda fn: forward_only_fp32):
            got_tf32 = grad(torch.float32, dev)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = float(want.abs().max())
    return dict(rel_err=float((got - want).abs().max()) / scale,
                rel_err_tf32_backward=float((got_tf32 - want).abs().max())
                / scale)


def train_scene(dec, renders, cams):
    """The serve scene's anchor positions and its orbit renders as a
    training scene (orbit radius 4: the nerf++ radius 1.1·4)."""
    from contextgs_tpu_torch.scene.dataset_readers import SceneInfo

    pts = dec.anchor.double().cpu().numpy()
    for cam, img in zip(cams, renders):
        cam.image = np.clip(img.permute(1, 2, 0).cpu().numpy(), 0, 1)
    return SceneInfo(points=pts, colors=np.zeros_like(pts),
                     normals=np.zeros_like(pts), train_cameras=cams,
                     test_cameras=[], radius=4.4)


def train_split_targets():
    """(module, name, stage) of the training step's module-level calls: the
    names train/step.py, train/loop.py and models/decode.py look up at call
    time."""
    import contextgs_tpu_torch.models.context as tctx
    import contextgs_tpu_torch.models.densify as tdensify
    import contextgs_tpu_torch.train.step as tstep

    return [(tstep, "build_level_maps", "levels"),
            (tstep, "render", "forward"),
            (tctx, "multi_scale_generate", "context"),
            (tctx, "estimate_rate", "context"), (tstep, "l1_loss", "loss"),
            (tstep, "ssim", "loss"), (torch.autograd, "grad", "backward"),
            (tstep, "adam_update", "adam"),
            (tdensify, "accumulate_stats", "stats"),
            (tdensify, "adjust_anchors", "densify")]


def train_small_cpu_vs_card(dev):
    """5 plain steps of a small scene from one state on the CPU and on the
    card; the loss sequences."""
    from contextgs_tpu_torch.config import ModelConfig, TrainConfig
    from contextgs_tpu_torch.models import state as tst
    from contextgs_tpu_torch.train.optim import init_adam
    from contextgs_tpu_torch.train.step import make_train_step

    cfg = TrainConfig(model=ModelConfig())
    w, h = 128, 96
    cams = orbit_cameras(4, w, h, 5)
    pts = np.random.default_rng(5).uniform(-2, 2, (2_000, 3))
    losses = {}
    for device in ("cpu", dev):
        model, _ = tst.init_scene_model(
            pts, cfg.model, generator=torch.Generator().manual_seed(5),
            device=device)
        p, b, adam = model.params, model.buffers, init_adam(model.params)
        step = make_train_step(cfg, w, h, "plain", 4.4)
        seq = []
        for it in range(1, 6):
            cam = cams[(it - 1) % len(cams)]
            gt = torch.from_numpy(np.ascontiguousarray(
                cam.image.transpose(2, 0, 1))).to(device)
            p, b, adam, m = step(p, b, adam, cam.as_device_dict(), gt,
                                 torch.zeros(3, device=device), it, True)
            seq.append(float(m.loss))
        losses[str(device)] = seq
    return losses["cpu"], losses[str(dev)]


def profile_train_steps(ts, cfg, scene, dev, phase, n=3):
    """torch.profiler over n steps of `phase` from the trained state (one
    warm-up step first): kernel time per step and the busiest kernels and
    host operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from contextgs_tpu_torch.train.step import make_train_step

    step = make_train_step(cfg, W, H, phase, ts.spatial_lr_scale,
                           level_scales=ts.level_scales or (),
                           voxel_size=ts.voxel_size)
    bg = torch.zeros(3, device=dev)
    state = (ts.model.params, ts.model.buffers, ts.adam)
    cams = scene.train_cameras

    def run(i):
        cam = cams[i % len(cams)]
        gt = torch.from_numpy(np.ascontiguousarray(
            cam.image.transpose(2, 0, 1))).to(dev)
        return step(*state, cam.as_device_dict(), gt, bg,
                    TRAIN_STEPS + 1 + i, True, ts.generator)[:3]

    state = run(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(1, n + 1):
            state = run(i)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(device_us(e) for e in kernels) / 1e3 / n

    def top(items, key, k):
        return [dict(name=e.key[:70], ms_per_step=key(e) / 1e3 / n,
                     calls_per_step=e.count / n)
                for e in sorted(items, key=key, reverse=True)[:k]]

    return dict(train_phase=phase, steps=n, profiled_wall_ms_per_step=wall_ms,
                kernel_ms_per_step=device_ms,
                kernels_per_step=sum(e.count for e in kernels) / n,
                top_kernels=top(kernels, device_us, 10),
                top_host_self=top(events, lambda e: e.self_cpu_time_total, 8))


def k3_cases():
    """(name, numpy input, exclusive) of k3_check."""
    rng = np.random.default_rng(12)

    def ints(shape, lo, hi):
        return rng.integers(lo, hi, shape).astype(np.int32)

    yield "i32_wrap_2x100000", ints((2, 100_000), -(2 ** 28), 2 ** 28), False
    # rows whose length is not a multiple of 4: from the second row on no
    # tile is 16-byte aligned, so they take the kernel's scalar edge
    yield "i32_4x10001", ints((4, 10_001), -(2 ** 28), 2 ** 28), False
    yield ("f32_4x10001_exclusive", rng.normal(size=(4, 10_001)).astype(
        np.float32), True)
    yield "i32_misaligned_1d_20000", ints(20_000, -(2 ** 28), 2 ** 28), False
    yield ("f32_misaligned_1d_20000", rng.normal(size=20_000).astype(
        np.float32), False)
    for n in (1, 127, 129, 4097, 8193):
        x = ints((8, n), 0, 100)
        yield f"i32_8x{n}", x, False
        yield f"i32_8x{n}_exclusive", x, True
    yield "i32_1d_5000_exclusive", ints(5000, 0, 1000), True
    yield "i32_1x1048579", ints((1, (1 << 20) + 3), -(2 ** 28), 2 ** 28), False
    yield "u32_3x10000", rng.integers(0, 2 ** 32, (3, 10_000),
                                      dtype=np.uint64).astype(np.uint32), False
    for shape, excl in (((8, 33_000), False), ((16, 1 << 20), False),
                        ((1, 300_001), True)):
        yield (f"f32_{shape[0]}x{shape[1]}" + ("_exclusive" if excl else ""),
               rng.normal(size=shape).astype(np.float32), excl)


def check_k3(dev):
    """K3 against its plain version on the card, case by case: int32 and
    uint32 exact, and equal to numpy's int32 prefix; float32 within
    float_tolerance(N) · Σ_{j≤i}|x_j| of a float64 prefix, with the worst
    share of that bound printed. Returns the largest float32 error."""
    from contextgs_tpu_torch.ops import scan

    worst, worst_share = 0.0, 0.0
    for name, x, excl in k3_cases():
        xt = torch.from_numpy(x).to(dev)
        if "misaligned" in name:         # a view 4 bytes off 16
            xt = torch.cat([xt[:1], xt])[1:]
            check(xt.data_ptr() % 16 == 4, "K3 misaligned view")
        got = scan.lane_cumsum(xt, exclusive=excl)
        torch.cuda.synchronize()
        res = dict(case=name, shape=list(x.shape), exclusive=excl)
        if x.dtype == np.float32:
            x64 = x.astype(np.float64)
            ref = np.cumsum(x64, axis=-1)
            mag = np.cumsum(np.abs(x64), axis=-1)
            if excl:
                ref, mag = ref - x64, mag - np.abs(x64)
            err = np.abs(got.cpu().numpy().astype(np.float64) - ref)
            allowed = scan.float_tolerance(x.shape[-1]) * mag
            res.update(max_abs=float(err.max()),
                       worst_share_of_bound=float(
                           (err / np.maximum(allowed, 1e-300)).max()))
            ok = bool((err <= allowed).all())
            worst = max(worst, res["max_abs"])
            worst_share = max(worst_share, res["worst_share_of_bound"])
        else:
            as_i32 = (lambda t: t.view(torch.int32)) if x.dtype == np.uint32 \
                else (lambda t: t)
            plain = scan.lane_cumsum_reference(as_i32(xt), excl)
            host = np.cumsum(x.view(np.int32), axis=-1, dtype=np.int32)
            if excl:
                host = np.concatenate(
                    [np.zeros_like(host[..., :1]), host[..., :-1]], -1)
            mismatch = int((as_i32(got) != plain).sum())
            res.update(mismatch=mismatch, host_mismatch=int(
                (as_i32(got).cpu().numpy() != host).sum()))
            ok = mismatch == 0 and res["host_mismatch"] == 0
        emit(phase="k3_check", ok=ok, **res)
        check(ok, f"K3 {name}")
    torch.cuda.synchronize()
    zeroed = all(not bool(buf.any()) for buf in scan._scratch.values())
    emit(phase="k3_check", case="all", float_max_abs=worst,
         float_worst_share_of_bound=worst_share, scratch_left_zeroed=zeroed,
         scratch_words={str(k): v.numel() for k, v in scan._scratch.items()})
    check(zeroed, "K3 leaves its scratch zeroed")
    return worst


def host_us(fn, calls=1000):
    """Host time per call of `fn` over back-to-back calls, a synchronize
    after: what the host spends to enqueue a call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def time_k3(x, prev=None, reps=50):
    """K3, its plain version and torch.cumsum on x, by CUDA events over
    back-to-back calls (what a caller sees, host launch gaps included; K3
    and torch.cumsum in turns: library, K3, K3, library), by the host's
    clock per call (in turns too) and by the profiler's kernel time (with
    the device operations of a K3 call), with the byte bound: each element
    read once and written once. With `prev` (the previous K3), old and new in
    turns by events and by `card_ms` (host gaps hidden)."""
    from contextgs_tpu_torch.ops import scan
    from contextgs_tpu_torch.scripts import device_profile

    n_bytes = 2 * x.numel() * x.element_size()

    def library():
        return torch.cumsum(x, -1, dtype=x.dtype)

    def k3():
        return scan.lane_cumsum(x)

    events = in_turns(library, k3, lambda f: cuda_ms(f, reps))
    host = in_turns(library, k3, host_us)
    k3_device_ms, k3_device_ops = device_profile(k3)
    res = dict(
        shape=list(x.shape), dtype=str(x.dtype).replace("torch.", ""),
        k3_ms=events["ms"], library_ms=events["prev_ms"],
        events_turns=dict(k3=events["ms_turns"],
                          library=events["prev_ms_turns"]),
        k3_host_us=host["ms"], library_host_us=host["prev_ms"],
        plain_ms=cuda_ms(lambda: scan.lane_cumsum_reference(x), reps),
        k3_device_ms=k3_device_ms, k3_device_ops=k3_device_ops,
        library_device_ms=device_profile(library)[0],
        bytes=n_bytes, bound_ms=n_bytes / PEAK_HBM_BYTES * 1e3)
    if prev is not None:
        old = prev_k3(prev)
        events = in_turns(lambda: old(x), k3, lambda f: cuda_ms(f, reps))
        kernel = in_turns(lambda: old(x), k3, card_ms)
        res.update(k3_prev_ms=events["prev_ms"], k3_new_ms=events["ms"],
                   k3_turns_ms=events, k3_prev_kernel_ms=kernel["prev_ms"],
                   k3_kernel_ms=kernel["ms"], k3_kernel_turns_ms=kernel,
                   prev_max_abs_diff=float((old(x) - k3()).abs().max()))
    return res


def context_small_cpu_vs_card(dev):
    """5 context steps of a small scene from one state on the CPU and on the
    card, both given the same draws: context_draws is called with a CPU
    generator seeded alike on each side, and its draws moved to the device.
    Returns {device: (losses, bit_per_param)}."""
    from contextgs_tpu_torch.config import ModelConfig, TrainConfig
    from contextgs_tpu_torch.models import context as tctx
    from contextgs_tpu_torch.models import levels as tlev
    from contextgs_tpu_torch.models import state as tst
    from contextgs_tpu_torch.train.optim import init_adam
    from contextgs_tpu_torch.train.step import make_train_step

    cfg = TrainConfig(model=ModelConfig())
    mcfg = cfg.model
    w, h = 128, 96
    cams = orbit_cameras(4, w, h, 5)
    pts = np.random.default_rng(6).uniform(-2, 2, (2_000, 3))
    original = tctx.context_draws
    out = {}
    for device in ("cpu", dev):
        model, voxel = tst.init_scene_model(
            pts, mcfg, generator=torch.Generator().manual_seed(6),
            device=device)
        p, b = model.params, model.buffers
        rng = np.random.default_rng(7)
        n = p.anchor.shape[0]
        alive = b.alive.cpu().numpy().astype(np.float32)

        def content(*shape, s):
            x = rng.normal(size=shape).astype(np.float32) * s
            return torch.from_numpy(x * alive.reshape(
                (-1,) + (1,) * (len(shape) - 1))).to(device)

        p = p._replace(anchor_feat=content(n, mcfg.feat_dim, s=0.3),
                       hyper_latent=content(n, mcfg.hyper_dim, s=1.0),
                       offsets=content(n, mcfg.n_offsets, 3, s=0.3))
        kept = tst.get_mask_anchor(p, b.alive)
        scales = tlev.find_divide_scale(
            p.anchor[kept].cpu().numpy(), voxel, b.bound_min.cpu().numpy(),
            b.bound_max.cpu().numpy(), mcfg.target_ratio, mcfg.level_num)
        adam = init_adam(p)
        step = make_train_step(cfg, w, h, "context", 4.4, level_scales=scales,
                               voxel_size=voxel)
        cpu_gen = torch.Generator().manual_seed(8)

        def same_draws(gen, n_, cfg_, training, device_=None):
            d = original(cpu_gen, n_, cfg_, training, "cpu")
            return tctx.ContextDraws(*(
                tuple(x.to(device_) for x in f) if isinstance(f, tuple)
                else f.to(device_) for f in d))

        losses, bpps = [], []
        tctx.context_draws = same_draws
        try:
            for it in range(1, 6):
                cam = cams[(it - 1) % len(cams)]
                gt = torch.from_numpy(np.ascontiguousarray(
                    cam.image.transpose(2, 0, 1))).to(device)
                p, b, adam, m = step(p, b, adam, cam.as_device_dict(), gt,
                                     torch.zeros(3, device=device),
                                     10_000 + it, True)
                losses.append(float(m.loss))
                bpps.append(float(m.bit_per_param))
        finally:
            tctx.context_draws = original
        out[str(device)] = (losses, bpps)
    return out["cpu"], out[str(dev)]


def sass_summary(source):
    """{kernel: {"instructions", "MUFU.EX2", "LDG", "LDGSTS", "STS",
    "LDS"}} of the source's built library, counted in the SASS that
    cuobjdump prints (NOPs left out; LDG counts the global loads into
    registers, LDGSTS the asynchronous copies into shared memory); None
    where the toolkit has no cuobjdump."""
    from contextgs_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(cuda_build._target(source))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    kernels, ops = {}, None
    for line in sass.splitlines():
        name = re.search(r"Function : (\S+)", line)
        if name:
            ops = kernels.setdefault(name.group(1), collections.Counter())
            continue
        op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                       line)
        if ops is not None and op and op.group(1) != "NOP":
            ops[op.group(1)] += 1

    def family(op):
        return op if op.startswith("MUFU.") else op.split(".")[0]

    return {name: dict(instructions=sum(ops.values()), **{
        k: sum(n for o, n in ops.items() if family(o).startswith(k)
               and (k != "LDG" or family(o) == "LDG"))
        for k in ("MUFU.EX2", "LDG", "LDGSTS", "STS", "LDS")})
        for name, ops in kernels.items()}


def check_k4_sass(k4, k1):
    """K4's levels in SASS keep their stages' work under -O3: level 0 loads
    the two bounds and copies nothing; from level 1 on the row gather is
    there as at least nine asynchronous copies (LDGSTS, one a field of the
    staged record) beside the loads of the bounds and of the ids; the exp
    from level 2 on only; and the walk grows from level 2 to 4. (Static
    counts need not grow from level 0 to 2: -O3 unrolls level 1's short
    chunk loop.) K1's own counts are printed beside level 4's and not
    checked: K1 gathers through registers."""
    levels = [next(v for k, v in k4.items() if f"ILi{lv}E" in k)
              for lv in K4_LEVELS]
    emit(phase="k4_sass", levels=levels, k1_sass=list(k1.values())[0],
         v4_sass=levels[4])
    check(levels[0]["LDG"] >= 2 and levels[0]["LDGSTS"] == 0
          and levels[0]["STS"] == 0,
          "K4 SASS: level 0 reads the bounds and stages nothing")
    check(all(lv["LDGSTS"] >= 9 and lv["LDG"] >= 3 for lv in levels[1:]),
          "K4 SASS: the row gather by cp.async from level 1 on")
    check(all((lv["MUFU.EX2"] > 0) == (i >= 2) for i, lv in enumerate(levels)),
          "K4 SASS: exps from level 2 on only")
    walk = [lv["instructions"] for lv in levels[2:]]
    check(walk == sorted(set(walk)), "K4 SASS: the walk grows from 2 to 4")


def compare_k4(level, rows, ids, bounds, width, height, t_eps, k1, big):
    """K4 at `level` against its plain version on the same card inputs, and
    against K1's outputs `k1`. v0 exact; the sinks of v1 and v2 within 1e-5
    relative (0 where the plain one is 0); v3's sink (unscaled) and v4 as
    K1 against its plain version: 2e-5 on small cases, on `big` ones max
    2e-4 and mean 1e-6; v4 bit-equal to K1, v3's T and last_contrib too."""
    from contextgs_tpu_torch.scripts import kvariants

    got = kvariants.blend_variant(level, rows, ids, bounds, width, height,
                                  t_eps)
    want = kvariants.blend_variant_reference(level, rows, ids, bounds, width,
                                             height, t_eps)
    torch.cuda.synchronize()
    diff = torch.cat([(got[0] - want[0]).abs().flatten(),
                      (got[1] - want[1]).abs().flatten()])
    res = dict(level=level, max_abs=float(diff.max()),
               finite=bool(torch.isfinite(got[0]).all()
                           and torch.isfinite(got[1]).all()),
               last_contrib_mismatch=int((got[2] != want[2]).sum()))
    if level <= 2:
        rel = (got[0] - want[0]).abs() / want[0].abs().clamp_min(1e-38)
        res.update(max_rel_sink=float(rel.max()),
                   t_one=bool((got[1] == 1).all()),
                   last_zero=bool((got[2] == 0).all()))
        ok = (res["max_rel_sink"] <= (0.0 if level == 0 else 1e-5)
              and res["t_one"] and res["last_zero"])
    else:
        scale = 1.0 / kvariants.SINK if level == 3 else 1.0
        err = torch.cat([((got[0] - want[0]) * scale).abs().flatten(),
                         (got[1] - want[1]).abs().flatten()])
        res.update(max_abs_unscaled=float(err.max()),
                   mean_abs_unscaled=float(err.mean()),
                   t_equals_k1=bool(torch.equal(got[1], k1[1])),
                   last_equals_k1=bool(torch.equal(got[2], k1[2])))
        ok = (res["t_equals_k1"] and res["last_equals_k1"] and (
            res["max_abs_unscaled"] <= 2e-4
            and res["mean_abs_unscaled"] <= 1e-6 if big
            else res["max_abs_unscaled"] <= 2e-5
            and res["last_contrib_mismatch"] == 0))
        if level == 4:
            res["rgb_equals_k1"] = bool(torch.equal(got[0], k1[0]))
            ok = ok and res["rgb_equals_k1"]
    res["ok"] = bool(ok and res["finite"])
    return res


def check_k4(case, rows, ids, bounds, width, height, t_eps=1e-4, big=False):
    """Every level of K4 against its plain version and K1 on one case; the
    largest |error| of each level."""
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    k1 = tile_kernel.blend_forward(rows, ids, bounds, width, height, t_eps)
    errs = []
    for level in K4_LEVELS:
        res = compare_k4(level, rows, ids, bounds, width, height, t_eps, k1,
                         big)
        emit(phase="k4_check", case=case, **res)
        check(res["ok"], f"K4 level {level} on {case}")
        errs.append(res["max_abs"])
    return errs


def k4_bounds(rows, ids, bounds, width, height, t_eps=1e-4):
    """The roofline of each level of K4 on these inputs, counting only the
    work that level needs: level 0 reads the bounds and writes rgb, T and
    last_contrib; level 1 also reads the listed ids and the rows of the
    gaussians they name; levels 2-4 add the operations and exps of the
    pairs that reach alpha >= 1/255 (NEED_K4), as K1's bound counts them:
    level 2 those of every listed instance with an in-image pixel (no early
    exit: the pair counts at t_eps = 0), levels 3 and 4 those up to each
    pixel's exit (at t_eps). Beside it, as bound_walked_ms, the bound of
    every pair each pixel reaches (OPS_K4), the previous design's walk."""
    from contextgs_tpu_torch.ops.rasterize import reference

    tiles_x = (width + 15) // 16
    first, end = int(bounds[0]), int(bounds[-1])
    base = bounds.numel() * 4 + height * width * (3 + 1 + 1) * 4
    rows_read = int(torch.unique(ids[first:end]).numel())
    gather = (end - first) * 4 + rows_read * rows.shape[1] * 4
    pairs = {lv: reference.blend_tiles_reference(
        rows, ids, bounds, width, height, tiles_x,
        t_eps=0.0 if lv == 2 else t_eps, count_pairs=True)[3]
        for lv in (2, 4)}
    pairs[3] = pairs[4]
    out = [roofline(base, 0, 0), roofline(base + gather, 0, 0)]
    for res in out:
        res.update(bound_walked_ms=res["bound_ms"],
                   bound_walked_by=res["bound_by"])
    for lv in (2, 3, 4):
        out.append(dict(bounds_of(base + gather, pairs[lv], NEED_K4[lv],
                                  OPS_K4[lv], "tested", "exp"),
                        pairs_tested=pairs[lv]["tested"],
                        pairs_evaluated=pairs[lv]["evaluated"]))
    return out


def k4_from(source):
    """The K4 of `source` (the previous design) behind the launch of K4's
    wrapper: the same arguments after the level, the outputs allocated
    alike, the cached function."""
    from contextgs_tpu_torch.ops import cuda_build
    from contextgs_tpu_torch.scripts import kvariants

    def call(level, rows, ids, bounds, width, height, t_eps=1e-4):
        out = (torch.empty((3, height, width), device=rows.device),
               torch.empty((height, width), device=rows.device),
               torch.empty((height, width), dtype=torch.int32,
                           device=rows.device))
        fn = cuda_build.c_function(source, "blend_variant",
                                   kvariants.ARGTYPES)
        err = cuda_build.launch(
            fn, rows.device, level, rows.data_ptr(), ids.data_ptr(),
            bounds.data_ptr(), width, height, (width + 15) // 16,
            bounds.numel() - 1, t_eps, *(x.data_ptr() for x in out))
        check(err == 0, f"K4 of {source}: CUDA error {err}")
        return out
    return call


def k4_decompose(case, times, inputs, width, height, t_eps=1e-4, old=None):
    """Each level's time by CUDA events over back-to-back calls through the
    wrapper, as the lab times them (`times`, host launch gaps included), by
    `card_ms` warm (`kernel_ms`: the same calls with the gaps hidden) and
    cold (`cold_ms`: one call at a time after an L2 flush), the first two
    with their increments over the level before; each level's bound, of the
    work it needs and of the pairs it would walk without the cull; K1's
    times beside v4's, on the same `inputs` (rows, ids, bounds). With `old`
    (the previous design's K4, `k4_from`): each level in turns with the old
    one by `card_ms` (old, new, new, old), and each level's outputs
    torch.equal to the old level's (fails otherwise)."""
    from contextgs_tpu_torch.ops.rasterize import tile_kernel
    from contextgs_tpu_torch.scripts import kvariants

    def level(lv):
        return lambda: kvariants.blend_variant(lv, *inputs, width, height,
                                               t_eps)

    def k1_call():
        return tile_kernel.blend_forward(*inputs, width, height, t_eps)

    kernel_ms = [card_ms(level(lv)) for lv in K4_LEVELS]
    cold = [card_ms(level(lv), 10, cold=True) for lv in K4_LEVELS]
    k1 = [cuda_ms(k1_call, 20), card_ms(k1_call),
          card_ms(k1_call, 10, cold=True)]
    bounds = k4_bounds(*inputs, width, height, t_eps)
    res = dict(phase="k4_decompose", case=case, k1_ms=k1[0],
               k1_kernel_ms=k1[1], k1_cold_ms=k1[2],
               levels=[dict(level=lv, ms=times[lv], kernel_ms=kernel_ms[lv],
                            cold_ms=cold[lv],
                            increment_ms=times[lv] - (times[lv - 1] if lv
                                                      else 0.0),
                            kernel_increment_ms=kernel_ms[lv] - (
                                kernel_ms[lv - 1] if lv else 0.0),
                            bound_ms=bounds[lv]["bound_ms"],
                            bound_term=bounds[lv]["bound_by"],
                            share_of_bound=bounds[lv]["bound_ms"]
                            / kernel_ms[lv],
                            bound_walked_ms=bounds[lv]["bound_walked_ms"],
                            bound_walked_term=bounds[lv]["bound_walked_by"],
                            pairs_tested=bounds[lv].get("pairs_tested"),
                            pairs_evaluated=bounds[lv].get(
                                "pairs_evaluated"))
                       for lv in K4_LEVELS],
               v4_minus_k1_kernel_ms=kernel_ms[4] - k1[1])
    if old is not None:
        turns, equal = [], []
        for lv in K4_LEVELS:
            turns.append(in_turns(
                lambda lv=lv: old(lv, *inputs, width, height, t_eps),
                level(lv), card_ms))
            got, was = level(lv)(), old(lv, *inputs, width, height, t_eps)
            torch.cuda.synchronize()
            equal.append([bool(torch.equal(a, b)) for a, b in zip(got, was)])
        res["previous_design"] = dict(
            kernel_ms=[t["prev_ms"] for t in turns],
            new_kernel_ms=[t["ms"] for t in turns],
            speedup=[t["prev_ms"] / t["ms"] for t in turns],
            turns=turns, equal_rgb_t_last=equal)
        check(all(all(e) for e in equal),
              f"K4's levels equal to the previous design's on {case}")
    return res


def tile_lengths(bounds):
    """The per-tile instance-list lengths of a view: least, median, p90,
    p99, most, mean, and the empty tiles."""
    lens = (bounds[1:] - bounds[:-1]).double()
    q = torch.quantile(lens, torch.tensor([0.5, 0.9, 0.99], dtype=lens.dtype,
                                          device=lens.device)).tolist()
    return dict(tiles=lens.numel(), min=int(lens.min()), median=q[0],
                p90=q[1], p99=q[2], max=int(lens.max()),
                mean=float(lens.mean()), empty=int((lens == 0).sum()))


def check_k56(dev):
    """K5 and K6 against x.transpose(1, 2).contiguous() on the card, exact,
    at the lab's [8394, 128, 16] and at slab counts that leave K6's last
    block of 8 ragged. Returns the largest |error| of each kernel."""
    from contextgs_tpu_torch.scripts import xpose_lab

    worst = dict.fromkeys(xpose_lab.KERNELS, 0.0)
    for nc in (xpose_lab.B // xpose_lab.C, 1, 7, 9, 8393):
        x = torch.randn((nc, xpose_lab.C, xpose_lab.K), device=dev,
                        generator=torch.Generator(dev).manual_seed(nc))
        want = xpose_lab.transpose_slabs_reference(x)
        for variant in xpose_lab.KERNELS:
            got = xpose_lab.transpose_slabs(x, variant)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            equal = bool(torch.equal(got, want))
            emit(phase="k56_check", variant=variant, nc=nc, equal=equal,
                 max_abs=err)
            check(equal, f"{xpose_lab.KERNELS[variant]} at nc={nc}")
            worst[variant] = max(worst[variant], err)
    return worst


def kernel_labs(dev, k4_err, k56_err, old_k4=None):
    """The main paths of the two kernel labs, each with its launch counts
    set to 0 just before and read just after: kvariants.run_all (K4's five
    levels on the lab's three configurations), then, on the same inputs,
    K1's time and each level's bound, the plain versions' times on the
    first configuration, and the uneven-tiles ratio (8x450 over 1x3600);
    xpose_lab.run_all (K5, K6, the library call and the lab's torch rows)
    against the slab transpose's byte bound. Returns the kernels-line
    entries of K4's levels, K5 and K6; `k4_err` and `k56_err` are the
    checks' largest errors. With `old_k4` (the previous design's K4), each
    table's levels also in turns with its levels (`k4_decompose`)."""
    from contextgs_tpu_torch.scripts import kvariants, xpose_lab

    lab_w, lab_h = 16 * kvariants.TILES_X, 16 * kvariants.TILES_Y
    kvariants.launches[:] = [0] * len(kvariants.LEVELS)
    k4_table = kvariants.run_all()
    torch.cuda.synchronize()
    k4_launches = list(kvariants.launches)
    emit(phase="kvariants_lab", table=k4_table, launches=k4_launches)
    check(min(k4_launches) > 0, "every level of K4 launched by the lab")
    k4_lab = {}
    one, uneven = list(k4_table)[0], list(k4_table)[-1]   # 1x3600, 8x450
    for config, times in k4_table.items():
        cpt, active = map(int, config.split("x"))
        lab = kvariants.lab_inputs(cpt, active, device=dev)
        k4_lab[config] = k4_decompose(config, times, lab, lab_w, lab_h,
                                      old=old_k4)
        if config == one:
            k4_lab[config]["plain_ms"] = [cuda_ms(
                lambda: kvariants.blend_variant_reference(
                    lv, *lab, lab_w, lab_h), 3) for lv in K4_LEVELS]
        emit(**k4_lab[config])
        del lab
    ratio = {f"v{lv}": k4_table[uneven][lv] / k4_table[one][lv]
             for lv in K4_LEVELS}
    ratio["k1"] = k4_lab[uneven]["k1_ms"] / k4_lab[one]["k1_ms"]
    ratio.update({f"v{lv}_kernel": k4_lab[uneven]["levels"][lv]["kernel_ms"]
                  / k4_lab[one]["levels"][lv]["kernel_ms"] for lv in K4_LEVELS})
    ratio["k1_kernel"] = (k4_lab[uneven]["k1_kernel_ms"]
                          / k4_lab[one]["k1_kernel_ms"])
    emit(phase="k4_uneven_tiles", configs=[uneven, one], ms_ratio=ratio)

    xpose_lab.launches.update(dict.fromkeys(xpose_lab.KERNELS, 0))
    xpose_table = xpose_lab.run_all()
    torch.cuda.synchronize()
    k56_launches = dict(xpose_lab.launches)
    nc = xpose_lab.B // xpose_lab.C
    slab_bytes = 2 * nc * xpose_lab.C * xpose_lab.K * 4
    slab_bound_ms = slab_bytes / PEAK_HBM_BYTES * 1e3
    slab_names = {v: next(n for n in xpose_table if xpose_lab.KERNELS[v] in n)
                  for v in xpose_lab.KERNELS}
    library_ms = xpose_table["T blocked [nc,C,16]->[nc,16,C]"]
    x = torch.randn((nc, xpose_lab.C, xpose_lab.K), device=dev)
    calls = {v: (lambda v=v: xpose_lab.transpose_slabs(x, v))
             for v in xpose_lab.KERNELS}
    calls["library"] = lambda: xpose_lab.transpose_slabs_reference(x)
    kernel_ms = {v: card_ms(call) for v, call in calls.items()}
    cold = {v: card_ms(call, 10, cold=True) for v, call in calls.items()}
    del x
    emit(phase="xpose_lab", table=xpose_table, launches=k56_launches,
         kernel_ms=kernel_ms, cold_ms=cold,
         bytes=slab_bytes, bound_ms=slab_bound_ms,
         share_of_bound={v: slab_bound_ms / xpose_table[n]
                         for v, n in slab_names.items()},
         library_share_of_bound=slab_bound_ms / library_ms)
    check(min(k56_launches.values()) > 0, "K5 and K6 launched by the lab")

    entries = []
    for lv, stage in enumerate(kvariants.LEVELS):
        level = k4_lab[one]["levels"][lv]
        entries.append(dict(
            name=f"kvariant_{stage[:2]}", route="cuda",
            source="contextgs_tpu_torch/scripts/csrc/kvariants.cu",
            replaces="scripts/kvariants.py:36", launches=k4_launches[lv],
            max_abs_err=k4_err[lv], ms=level["ms"],
            plain_ms=k4_lab[one]["plain_ms"][lv], bound_ms=level["bound_ms"],
            bound_walked_ms=level["bound_walked_ms"],
            bound_by="bytes" if level["bound_term"] == "bytes"
            else "operations", bound_term=level["bound_term"],
            library_ms=None, kernel_ms=level["kernel_ms"],
            cold_ms=level["cold_ms"], config=one, stage=stage))
    for variant, line in (("smem", 105), ("vec", 125)):
        entries.append(dict(
            name=xpose_lab.KERNELS[variant], route="cuda",
            source="contextgs_tpu_torch/scripts/csrc/xpose.cu",
            replaces=f"scripts/xpose_lab.py:{line}",
            launches=k56_launches[variant], max_abs_err=k56_err[variant],
            ms=xpose_table[slab_names[variant]], plain_ms=library_ms,
            bound_ms=slab_bound_ms, bound_by="bytes", bound_term="bytes",
            library_ms=library_ms, kernel_ms=kernel_ms[variant],
            library_kernel_ms=kernel_ms["library"], cold_ms=cold[variant],
            library_cold_ms=cold["library"],
            shape=[nc, xpose_lab.C, xpose_lab.K]))
    return entries


def same_files(dir_a, dir_b):
    """The two directories hold the same file names with the same bytes."""
    names = sorted(os.listdir(dir_a))
    if names != sorted(os.listdir(dir_b)):
        return False
    for name in names:
        with open(os.path.join(dir_a, name), "rb") as fa, \
                open(os.path.join(dir_b, name), "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def streams_add_up(out_dir, meta):
    """Each stream file's size is the sum of its lengths in meta.pkl."""
    from contextgs_tpu_torch.compression.codec import STREAMS

    def size(name):
        return os.path.getsize(os.path.join(out_dir, name))

    return (sum(meta["hyper_lens"]) == size("hyper.b")
            and all(sum(ch[s][0] + ch[s][2] for ch in lv["chunks"])
                    == size(f"{s}{lv['level']}.b")
                    for lv in meta["levels"] for s in STREAMS))


def cdf_rows_ops(mean, scale, q, base, w):
    """The float64 operations the CDF kernel spends on these rows, counted
    from its source (csrc/cdf_rows.cu) by the branch each entry takes: a
    product, sum, quotient or comparison-free clip as one, a fused
    multiply-add as two (the quotient's Newton steps as one, so the bound is
    low). Every entry takes the quantization's product; an inner entry its
    edge and z (5); its ndtr, where evaluated, the scaling by sqrt(1/2)
    (1) and then erf's branch (22), or erfc's: -a·a, e·p, the quotient and
    the halving (4), 1 - y where z > 0, glibc's exp (20, 21 below -512),
    the first pair of polynomials (31) or the second (21); the underflow
    takes -a·a and the halving (2) and 1 - y where z > 0."""
    sig = np.maximum(scale, np.float32(1e-9)).astype(np.float64)
    edges = (base[:, None] + (np.arange(1, w) - 0.5)[None, :]) * q[
        :, None].astype(np.float64)
    z = (edges - mean[:, None]) / sig[:, None]
    a = np.abs(z) * math.sqrt(0.5)
    live = np.abs(z) < 6 if w > 128 else np.ones(z.shape, bool)
    erf = live & (a < 1)
    erfc = live & (a >= 1)
    under = erfc & (a * a > 709.78)
    ex = erfc & ~under
    pos = int((erfc & (z > 0)).sum())
    return (mean.size * (w + 1) + 5 * z.size + int(live.sum())
            + 22 * int(erf.sum()) + 4 * int(ex.sum()) + 2 * int(under.sum())
            + pos + 20 * int(ex.sum()) + int((ex & (a * a >= 512)).sum())
            + 31 * int((ex & (a < 8)).sum()) + 21 * int((ex & (a >= 8)).sum()))


def cdf_rows_check(calls, dev):
    """The CDF kernel on the given `_cdf_rows` calls' inputs (μ, σ, Q, base,
    w): its uint16 rows against the plain version's, entry for entry, and
    its float64 rows bit for bit; the kernel's device time (CUDA events
    around each launch, summed), the wrapper's whole call (copies both ways,
    by the host clock) and the plain version's (host clock), each over all
    the calls, the launches timed after the card has spun long enough for
    the host to enqueue them all; and the bound of the kernel's work,
    uint16 rows only: 20
    bytes read and 2 (w + 1) written a row at the HBM rate, the float64
    operations (cdf_rows_ops) at the FP64 rate."""
    from contextgs_tpu_torch.compression import cdf_rows, codec, coder

    res = dict(calls=len(calls), symbols=0, entries=0, u16_differ=0,
               f64_differ=0, windows=dict(collections.Counter(
                   c[4] for c in calls)))
    plain_s = wrapper_s = 0.0
    n_bytes = n_ops = 0
    staged = []
    for mean, scale, q, base, w in calls:
        n = mean.size
        res["symbols"] += n
        res["entries"] += n * (w + 1)
        f, u = cdf_rows.cdf_rows(mean, scale, q, base, w, dev,
                                 float_rows=True)
        t0 = time.perf_counter()
        want_f = codec._windowed_cdf_rows(mean, scale, q, base, w)
        want_u = coder.quantize_cdf(want_f)
        plain_s += time.perf_counter() - t0
        res["u16_differ"] += int((u != want_u).sum())
        res["f64_differ"] += int((f.view(np.int64)
                                  != want_f.view(np.int64)).sum())
        t0 = time.perf_counter()
        cdf_rows.cdf_rows(mean, scale, q, base, w, dev)
        wrapper_s += time.perf_counter() - t0
        n_bytes += n * (20 + 2 * (w + 1))
        n_ops += cdf_rows_ops(mean, scale, q, base, w)
        staged.append((torch.from_numpy(np.concatenate([
            np.ascontiguousarray(x).view(np.uint8)
            for x in (base, mean, scale, q)])).to(dev), n, w))
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in staged]
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 26)    # ~34 ms, for the host to enqueue them all
    for (inputs, n, w), (e0, e1) in zip(staged, events):
        e0.record()
        cdf_rows.build_on_card(inputs, n, w)
        e1.record()
    torch.cuda.synchronize()
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    fp64_ms = n_ops / PEAK_FP64_FLOPS * 1e3
    res.update(ms=sum(e0.elapsed_time(e1) for e0, e1 in events),
               wrapper_ms=wrapper_s * 1e3, plain_ms=plain_s * 1e3,
               bytes=n_bytes, fp64_ops=n_ops, bytes_ms=bytes_ms,
               fp64_ms=fp64_ms, bound_ms=max(bytes_ms, fp64_ms),
               bound_by="bytes" if bytes_ms >= fp64_ms else "fp64")
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    return res


def codec_phase(ts, tcfg, scene, eval_render, size_mb, serve_ms, dev):
    """The codec on the train cell's final model at full width:
    encode_scene → files → decode_scene → make_decoded_renderer →
    render_set (K1) → evaluate_images. Checks the exact things: every
    decoded state equal to the encoder's, every stream consumed, a second
    encode byte-identical, K1 launched once a view of the decoded orbit and
    within its tolerance of the plain version on every decoded view. Prints
    the rest: bytes per stream against the model's estimate, anchors per
    level, windows and escapes, encode and decode seconds, ms per view
    beside the serve cell's, PSNR and SSIM against the context eval render
    of the same cameras, peak device memory. The CDF kernel: launched once
    a card `_cdf_rows` call, and held to the plain version on the first
    encode's calls (cdf_rows_check). Returns K1's launches and the CDF
    kernel's result with its launches by path."""
    import pickle

    from contextgs_tpu_torch.compression import cdf_rows, codec
    from contextgs_tpu_torch.evaluation import (evaluate_images,
                                                make_decoded_renderer,
                                                render_set)
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    mcfg = tcfg.model
    p, b = ts.model.params, ts.model.buffers
    args = (p, b, mcfg, ts.level_scales, ts.voxel_size)
    opts = dict(disable_hyper=tcfg.opt.disable_hyper)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cdf_rows.launches = 0
    codec._check_card(dev)        # the host check, once a process
    cdf_launches = dict(host_check=cdf_rows.launches)
    cdf_calls, encode_calls = [], []

    def counting(record):
        def wrap(fn):
            def call(*a, **kw):
                device = a[5] if len(a) > 5 else kw.get("device")
                cdf_calls.append(torch.device(device or "cpu").type)
                if record:      # μ, σ, Q, base, w
                    encode_calls.append(a[:5])
                return fn(*a, **kw)
            return call
        return wrap

    root = tempfile.mkdtemp(prefix="contextgs_codec_")
    try:
        first, second = (os.path.join(root, n) for n in ("a", "b"))
        stats = {}
        t0 = time.perf_counter()
        with wrapped(codec, "_cdf_rows", counting(True)):
            bits, states = codec.encode_scene(*args, first,
                                              return_states=True,
                                              stream_stats=stats, **opts)
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with wrapped(codec, "_cdf_rows", counting(False)):
            # raises on an unread stream
            dec = codec.decode_scene(first, mcfg)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        equal = {k: bool(np.array_equal(getattr(dec, k).cpu().numpy(),
                                        states[k]))
                 for k in ("anchor", "feat", "scaling", "offsets", "masks",
                           "hyper", "level")}
        with open(os.path.join(first, "meta.pkl"), "rb") as f:
            meta = pickle.load(f)
        consumed = streams_add_up(first, meta)
        files = {n: os.path.getsize(os.path.join(first, n))
                 for n in sorted(os.listdir(first))}
        t0 = time.perf_counter()
        with wrapped(codec, "_cdf_rows", counting(False)):
            codec.encode_scene(*args, second, **opts)
        encode2_s = time.perf_counter() - t0
        identical = same_files(first, second)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del states
    cdf_launches["codec"] = cdf_rows.launches - cdf_launches["host_check"]
    cdf_rows.launches = 0
    cdf_res = cdf_rows_check(encode_calls, dev)
    cdf_launches["cdf_check"] = cdf_rows.launches
    del encode_calls
    emit(phase="cdf_rows_check", **cdf_res, launches=cdf_launches,
         card_calls=len(cdf_calls))
    check(cdf_launches["codec"] == len(cdf_calls)
          and set(cdf_calls) == {"cuda"},
          "one CDF kernel launch a card _cdf_rows call of the codec")
    check(cdf_res["u16_differ"] == 0 and cdf_res["f64_differ"] == 0,
          "the CDF kernel's rows equal the plain version's on the encode's "
          "streams")

    cams = scene.train_cameras
    bg = np.zeros(3, np.float32)
    render = make_decoded_renderer(dec, tcfg, W, H)
    render(cams[0].as_device_dict(), bg)        # allocator warm-up
    torch.cuda.synchronize()
    view_ms = []
    tile_kernel.launches = 0
    renders, gts, fps = render_set(render, cams, bg, view_ms=view_ms)
    torch.cuda.synchronize()
    k1_launches = tile_kernel.launches
    # K1 against its plain version on every decoded view, each rendered
    # again with K1's inputs kept (these launches are not the main path's)
    k1_views = [compare_k1(*render_keeping_k1(render, cam, bg))
                for cam in cams]
    k1_res = dict(
        max_abs=max(v["max_abs"] for v in k1_views),
        mean_abs=max(v["mean_abs"] for v in k1_views),
        views_over_2e5=sum(v["pixels_over_2e5"] > 0 for v in k1_views),
        last_contrib_mismatch=sum(v["last_contrib_mismatch"]
                                  for v in k1_views),
        finite=all(v["finite"] for v in k1_views))
    bg_t = torch.zeros(3, device=dev)
    evals = [eval_render(p, b, cam.as_device_dict(), bg_t) for cam in cams]
    vs_eval = evaluate_images(renders, evals)
    same_as_eval = all(torch.equal(r, e) for r, e in zip(renders, evals))
    vs_targets = evaluate_images(renders, gts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del renders, gts, evals, render

    coded_mb = {k: bits[k] / 8 / 2 ** 20 for k in size_mb if k in bits}
    timed = view_ms[WARMUP:]
    emit(phase="codec", anchors=meta["n"],
         anchors_per_level={lv["level"]: lv["count"]
                            for lv in meta["levels"]},
         level_scales=meta["level_scales"], file_bytes=files,
         coded_mb=coded_mb, estimate_mb=size_mb,
         coded_over_estimate={k: v / size_mb[k] if size_mb[k] else None
                              for k, v in coded_mb.items()},
         windows={k: dict(collections.Counter(v.pop("windows", [])))
                  for k, v in stats.items()},
         stream_stats=stats, encode_s=encode_s, decode_s=decode_s,
         second_encode_s=encode2_s,
         states_equal=equal, streams_consumed=consumed,
         second_encode_identical=identical, views=len(cams),
         k1_launches=k1_launches, ms_per_view=1e3 / fps,
         view_ms_median=float(np.median(timed)),
         serve_cell_ms_per_view=serve_ms, k1_check=k1_res,
         renders_equal_context_eval=same_as_eval,
         PSNR_vs_context_eval=None if same_as_eval else vs_eval["PSNR"],
         SSIM_vs_context_eval=vs_eval["SSIM"],
         PSNR_vs_targets=vs_targets["PSNR"],
         SSIM_vs_targets=vs_targets["SSIM"], peak_mem_gib=peak_gib)
    check(all(equal.values()), f"decoded states equal the encoder's: {equal}")
    check(consumed, "every stream consumed in full")
    check(identical, "a second encode writes byte-identical files")
    check(k1_launches == len(cams),
          "K1 launches on the decoded orbit != views")
    check(k1_res["finite"] and k1_res["max_abs"] <= 2e-4
          and k1_res["mean_abs"] <= 1e-6, "K1 on the decoded views")
    return k1_launches, dict(cdf_res, launches_by_path=cdf_launches)

# the drivers phase: the synthetic scene (512x512, ModelConfig widths) at a
# size whose initial anchors come to about 20k, cut so that the codec's host
# CDF build stays within the time limit, and a cut training schedule
DRIVER_VIEWS = 48
DRIVER_TEST_VIEWS = DRIVER_VIEWS // 8      # every 8th view
DRIVER_SCENE = ["--res", "512", "--cams", str(DRIVER_VIEWS), "--gauss",
                "80000", "--points", "20000"]
DRIVER_STEPS = 600
DRIVER_CONTEXT_FROM = 400    # the context transition, where λ points branch
# the schedule's flags that a branched point shares with the drivers run
DRIVER_SHARED = ["--noise_from", "200", "--context_from",
                 str(DRIVER_CONTEXT_FROM), "--start_stat", "50",
                 "--update_from", "100", "--update_interval", "100",
                 "--update_until", "500"]
DRIVER_SCHEDULE = ["--iterations", str(DRIVER_STEPS), *DRIVER_SHARED,
                   "--checkpoint_iterations", str(DRIVER_CONTEXT_FROM),
                   str(DRIVER_STEPS)]
DRIVER_PHASES = dict(plain=(2, 200), noise=(201, 400), context=(401, 600))


def module_imports(name):
    """Whether `import name` succeeds, asked of a fresh interpreter so that
    this process imports nothing."""
    return subprocess.run([sys.executable, "-c", f"import {name}"],
                          capture_output=True, timeout=300).returncode == 0


def keep_output(store):
    """Wrapper that keeps the output of the last call in `store`."""
    def wrap(fn):
        def call(*args, **kw):
            store["out"] = fn(*args, **kw)
            return store["out"]
        return call
    return wrap


def drivers_phase(dev):
    """The port's drivers from disk, in a temporary directory removed
    after: make_synth_scene → drivers.train (600 steps of all three phases,
    the PLY snapshot and the checkpoint, encode → decode → render the test
    split) → drivers.decompress → drivers.test → the snapshot read back →
    drivers.bench. Checks the exact things: K1's and K2's launches per
    driver, "decoded" and "ours_from_ckpt" equal to "ours", the test
    driver's bitstreams byte-identical to train's, the snapshot equal to
    the checkpoint's alive rows and networks, no jax and no PIL module
    imported. Returns K1's and K2's launches by path."""
    import contextgs_tpu_torch.ops.rasterize as trz
    from contextgs_tpu_torch.drivers import bench, decompress
    from contextgs_tpu_torch.drivers import test as test_driver
    from contextgs_tpu_torch.drivers import train as train_driver
    from contextgs_tpu_torch.evaluation import (make_decoded_renderer,
                                                render_set)
    from contextgs_tpu_torch.models import state as tst
    from contextgs_tpu_torch.ops.rasterize import tile_kernel
    from contextgs_tpu_torch.scene import snapshot
    from contextgs_tpu_torch.scripts import make_synth_scene
    from contextgs_tpu_torch.train import loop as tloop

    t_phase = time.perf_counter()
    os.environ.pop("CONTEXTGS_LPIPS_WEIGHTS", None)   # LPIPS stays gated
    seconds, steps, kept = {}, [], {}
    # K1's and K2's inputs as the drivers gave them, held against the plain
    # versions after the drivers ran: the synthetic scene's last view; the
    # train driver's last 1 + 2 x 6 K1 calls (the last step, the eval
    # views, the decoded test views) and its last K2 call (the last step);
    # the bench's last iteration
    synth_k1, train_k2_in, bench_k1, bench_k2, decoded = {}, {}, {}, {}, {}
    train_k1_in = collections.deque(maxlen=1 + 2 * DRIVER_TEST_VIEWS)
    # for rd_branch: the state the train driver saved at the context
    # transition, and its losses over the steps a branch is compared on
    saved, losses = {}, {}

    def keep_recent(fn):
        def call(*args):
            train_k1_in.append(args)
            return fn(*args)
        return call

    def counts():
        return tile_kernel.launches, tile_kernel.backward_launches

    def zero():
        tile_kernel.launches = tile_kernel.backward_launches = 0

    def timing_train(fn):
        def call(cfg, scene, *, device=None, callback=None):
            def cb(it, ts, metrics):
                torch.cuda.synchronize()
                steps.append((it, time.perf_counter()))
                if it in BRANCH_STEPS:
                    losses[it] = float(metrics.loss)
                callback(it, ts, metrics)
            kept.update(cfg=cfg, scene=scene)
            kept["ts"] = fn(cfg, scene, device=device, callback=cb)
            return kept["ts"]
        return call

    def timing(name):
        def wrap(fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                seconds.setdefault(name, []).append(time.perf_counter() - t0)
                return out
            return call
        return wrap

    root = tempfile.mkdtemp(prefix="contextgs_drivers_")
    try:
        scene_dir = os.path.join(root, "scene")
        model = os.path.join(root, "model")
        zero()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr), \
                wrapped(trz, "blend_forward", keep_args(synth_k1)):
            check(make_synth_scene.main(["--out", scene_dir, *DRIVER_SCENE])
                  == 0, "make_synth_scene")
        seconds["make_synth_scene"] = time.perf_counter() - t0
        k1_synth, k2_synth = counts()

        zero()
        t0 = time.perf_counter()
        with wrapped(train_driver, "train", timing_train), \
                wrapped(tloop, "save_checkpoint", keep_saved(saved)), \
                wrapped(train_driver, "encode_scene", timing("encode")), \
                wrapped(train_driver, "decode_scene", timing("decode")), \
                wrapped(trz, "blend_forward", keep_recent), \
                wrapped(trz, "blend_backward", keep_args(train_k2_in)):
            check(train_driver.main(["-s", scene_dir, "-m", model,
                                     *DRIVER_SCHEDULE]) == 0,
                  "drivers.train")
        seconds["train_driver"] = time.perf_counter() - t0
        k1_train, k2_train = counts()
        modules = dict(jax="jax" in sys.modules, PIL="PIL" in sys.modules)
        ts, scene = kept["ts"], kept["scene"]
        n_test = len(scene.test_cameras)
        voxel = kept["cfg"].model.voxel_size
        init_anchors = len(tst.voxelize_points(scene.points, voxel))
        estimate_mb = tloop.estimate_bits(ts.model, kept["cfg"], ts)
        train_bits = os.path.join(root, "bitstreams_train")
        shutil.copytree(os.path.join(model, "bitstreams"), train_bits)

        zero()
        t0 = time.perf_counter()
        with wrapped(decompress, "decode_scene", timing("decode")), \
                wrapped(decompress, "decode_scene", keep_output(decoded)):
            check(decompress.main(["-s", scene_dir, "-m", model]) == 0,
                  "drivers.decompress")
        seconds["decompress_driver"] = time.perf_counter() - t0
        k1_decompress, k2_decompress = counts()

        zero()
        loaded = {}
        t0 = time.perf_counter()
        with wrapped(test_driver, "load_checkpoint", keep_output(loaded)), \
                wrapped(test_driver, "encode_scene", timing("encode")), \
                wrapped(test_driver, "decode_scene", timing("decode")):
            check(test_driver.main(["-s", scene_dir, "-m", model]) == 0,
                  "drivers.test")
        seconds["test_driver"] = time.perf_counter() - t0
        k1_test, k2_test = counts()
        identical = same_files(train_bits, os.path.join(model, "bitstreams"))
        with open(os.path.join(model, "results.json")) as f:
            results = json.load(f)

        # the snapshot against the checkpoint the test driver loaded
        params, buffers = loaded["out"][:2]
        pc = os.path.join(model, "point_cloud", f"iteration_{DRIVER_STEPS}")
        snap = snapshot.load_model_ply(os.path.join(pc, "point_cloud.ply"),
                                       kept["cfg"].model,
                                       tst.SceneModel(params, buffers))
        alive = buffers.alive
        n = int(alive.sum())
        snap_equal = {f: bool(torch.equal(getattr(snap.params, f)[:n],
                                          getattr(params, f)[alive]))
                      for f in tst.ANCHOR_FIELDS}
        snap_equal["n_alive"] = int(snap.buffers.alive.sum()) == n
        mlps, prior, extra = snapshot.load_networks(
            os.path.join(pc, "checkpoint.pth"), kept["cfg"].model, dev)
        snap_equal["networks"] = all(
            torch.equal(a, b) for a, b in zip(
                tst.net_leaves(mlps, prior).values(),
                tst.net_leaves(params.mlps, params.prior).values()))
        snap_equal["checkpoint_is_final_state"] = bool(
            n == tst.n_alive(ts.model) and torch.equal(
                params.anchor_feat[alive],
                ts.model.params.anchor_feat[ts.model.buffers.alive]))

        # ms a view: the decoded scene over all the scene's views, the
        # first WARMUP left out (these K1 launches are no driver's)
        cams = scene.train_cameras + scene.test_cameras
        render = make_decoded_renderer(decoded["out"], kept["cfg"],
                                       cams[0].width, cams[0].height,
                                       device=dev)
        view_ms = []
        render_set(render, cams, np.zeros(3, np.float32), view_ms=view_ms)
        del render, decoded["out"]

        zero()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                wrapped(trz, "blend_forward", keep_args(bench_k1)), \
                wrapped(trz, "blend_backward", keep_args(bench_k2)):
            check(bench.main([]) == 0, "drivers.bench")
        seconds["bench"] = time.perf_counter() - t0
        k1_bench, k2_bench = counts()
        bench_line = json.loads(out.getvalue().strip().splitlines()[-1])

        # the tool scripts on this model directory, before it is removed
        begin("tools")
        t0 = time.perf_counter()
        tools_phase(root, model, train_bits, estimate_mb)
        seconds["tools"] = time.perf_counter() - t0
        # a λ point branched from this run's transition checkpoint
        begin("rd_branch")
        t0 = time.perf_counter()
        branch_k1, branch_k2 = rd_branch_phase(
            root, model, kept["cfg"], scene, saved, losses, dev)
        seconds["rd_branch"] = time.perf_counter() - t0
        begin("drivers")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # K1 and K2 against their plain versions on the drivers' inputs (these
    # launches are not the main path's)
    k1_inputs = dict(synth_last_view=synth_k1["args"],
                     bench_last_iteration=bench_k1["args"])
    for i, args in enumerate(train_k1_in):
        name = ("train_last_step" if i == 0 else
                f"train_eval_view{i}" if i <= DRIVER_TEST_VIEWS else
                f"train_decoded_view{i - DRIVER_TEST_VIEWS}")
        k1_inputs[name] = args
    with torch.no_grad():
        k1_check = {name: compare_k1(*args)
                    for name, args in k1_inputs.items()}
        del k1_inputs, train_k1_in, synth_k1, bench_k1
        k2_check = {}
        for name, store in (("train_last_step", train_k2_in),
                            ("bench_last_iteration", bench_k2)):
            a = store.pop("args")
            k2_check[name] = compare_k2(*a[:3], a[8], a[9], *a[6:8], a[10])
            del a

    times = dict(steps)
    step_ms = {ph: float(np.median([(times[i] - times[i - 1]) * 1e3
                                    for i in range(a, b + 1)]))
               for ph, (a, b) in DRIVER_PHASES.items()}
    ours, decoded = results["ours"], results["decoded"]
    from_ckpt = results["ours_from_ckpt"]
    coded_mb = {k: v / 8 / 2 ** 20
                for k, v in ours["size_breakdown_bits"].items()
                if k in estimate_mb}
    want_k1_train = DRIVER_STEPS + 2 * n_test   # steps, eval, decoded views
    seconds["phase"] = time.perf_counter() - t_phase
    emit(phase="drivers", initial_anchors=init_anchors,
         final_anchors=tst.n_alive(ts.model),
         train_views=len(scene.train_cameras), test_views=n_test,
         step_ms_median=step_ms, ours=ours, decoded=decoded,
         ours_from_ckpt=from_ckpt, coded_mb=coded_mb,
         estimate_mb=estimate_mb,
         coded_over_estimate={k: v / estimate_mb[k] if estimate_mb[k]
                              else None for k, v in coded_mb.items()},
         ms_per_view_decoded=dict(
             views=len(view_ms) - WARMUP,
             median=float(np.median(view_ms[WARMUP:])),
             mean=float(np.mean(view_ms[WARMUP:])),
             least=min(view_ms[WARMUP:]), most=max(view_ms[WARMUP:])),
         seconds=seconds,
         k1_launches=dict(make_synth_scene=k1_synth, train=k1_train,
                          decompress=k1_decompress, test=k1_test),
         k2_launches=dict(train=k2_train, decompress=k2_decompress,
                          test=k2_test),
         bitstreams_identical=identical, snapshot_equal=snap_equal,
         modules_imported=modules)
    emit(phase="bench", **bench_line, k1_launches=k1_bench,
         k2_launches=k2_bench)
    emit(phase="drivers_k1_check", **k1_check)
    for name, res in k2_check.items():
        check_k2(f"drivers_{name}", res)
    check(len(k1_check) == 2 + 1 + 2 * DRIVER_TEST_VIEWS
          and all(r["finite"] and r["max_abs"] <= 2e-4
                  and r["mean_abs"] <= 1e-6 for r in k1_check.values()),
          "K1 on the drivers' inputs")
    check(k1_synth == DRIVER_VIEWS and k2_synth == 0,
          "make_synth_scene: K1 once a view")
    check(n_test == DRIVER_TEST_VIEWS, "the drivers scene's test split")
    check(k2_train == DRIVER_STEPS, "K2 once a training step")
    check(k1_train == want_k1_train,
          f"K1 {k1_train} != {DRIVER_STEPS} steps + 2 x {n_test} test views")
    check(k1_decompress == n_test and k2_decompress == 0,
          "decompress: K1 once a test view")
    check(k1_test == n_test and k2_test == 0, "test: K1 once a test view")
    check(decoded["PSNR"] == ours["PSNR"] and decoded["SSIM"] == ours["SSIM"],
          "decompress's PSNR and SSIM equal train's")
    check(identical, "the test driver's bitstreams equal train's")
    check(all(from_ckpt[k] == ours[k] for k in ("PSNR", "SSIM", "size_MB")),
          "ours_from_ckpt equals ours")
    check(all(snap_equal.values()), f"snapshot: {snap_equal}")
    check(not any(modules.values()), f"modules imported: {modules}")
    for name, entry in results.items():
        check(all(math.isfinite(entry[k]) for k in ("PSNR", "SSIM", "FPS"))
              and entry["LPIPS"] is None and entry.get("LPIPS_skipped"),
              f"results.json {name}")
    check(math.isfinite(ours["size_MB"]) and ours["size_MB"] > 0,
          "results.json size_MB")
    check(decoded["PSNR"] > 15.0, "decoded test PSNR above 15 dB")
    iters = bench.WARMUP + bench.CARD["iters"]
    check(k1_bench == iters and k2_bench == iters,
          "bench: K1 and K2 once an iteration")
    check(bench_line["value"] > 0, "bench throughput")
    return (dict(make_synth_scene=k1_synth,
                 drivers=k1_train + k1_decompress + k1_test,
                 bench=k1_bench, rd_branch=branch_k1),
            dict(drivers=k2_train, bench=k2_bench, rd_branch=branch_k2),
            decoded["PSNR"])


# the sharded phase: the bands of 2 and 4 ranks; two ranks on the one card
# over gloo (NCCL refuses two ranks on one device); NCCL at world size 1
# through the train driver, on the drivers phase's scene with a cut schedule
SHARD_BANDS = (2, 4)
SHARD_RANKS = 2
SHARD_TIMEOUT = 900                  # seconds the ranks may take
MESH_STEPS = 150
MESH_SCHEDULE = ["--iterations", str(MESH_STEPS), "--noise_from", "50",
                 "--context_from", "100", "--start_stat", "12",
                 "--update_from", "12", "--update_interval", "25",
                 "--update_until", "126", "--checkpoint_iterations",
                 str(MESH_STEPS)]
MESH_PHASES = dict(plain=(6, 50), noise=(51, 100), context=(101, 150))
SHARD_PHASES = dict(plain=(6, 30), noise=(31, 60), context=(61, 90))


def band_lists(ids, bounds, width, height, row0, n_rows):
    """The tile lists of the band of `n_rows` tile rows from `row0` on, cut
    from the whole image's: the same gaussians in the same order, tile ids
    local to the band, empty tiles past the image."""
    tiles_x, tiles_y = (width + 15) // 16, (height + 15) // 16
    lo = min(row0, tiles_y) * tiles_x
    hi = min(row0 + n_rows, tiles_y) * tiles_x
    b = bounds[lo:hi + 1]
    b = torch.cat([b, b[-1:].expand(n_rows * tiles_x - (hi - lo))])
    return ids[int(b[0]):int(b[-1])].contiguous(), (b - b[0]).contiguous()


def band_rows(x, row0, n_rows):
    """Rows [row0·16, (row0 + n_rows)·16) of an [.., H, W] image, zero past
    its bottom."""
    h = x.shape[-2]
    pad = (row0 + n_rows) * 16 - h
    x = torch.nn.functional.pad(x, (0, 0, 0, max(pad, 0)))
    return x[..., row0 * 16:(row0 + n_rows) * 16, :].contiguous()


def banded_kernels(case, k1_args, cot, n_bands):
    """K1 and K2 over the bands of `n_bands` ranks against unbanded K1 and
    K2 on the same inputs: the stitched bands bit for bit (rgb, final T,
    last_contrib), the bands' d_rows summed within K2's envelope tolerance
    (1.5e-3 of each component's largest |grad|); each band against its
    plain versions with the same row offset; the bands' time beside the
    unbanded call's (`card_ms`). Returns the launches of the banded
    calls."""
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    rows, ids, bounds, width, height, t_eps = k1_args
    d_rgb, d_ft = cot
    tiles_y = (height + 15) // 16
    n_rows = -(-tiles_y // n_bands)
    whole = tile_kernel.blend_forward(rows, ids, bounds, width, height, t_eps)
    whole_d = tile_kernel.blend_backward(rows, ids, bounds, *whole, d_rgb,
                                         d_ft, width, height, t_eps)
    bands = []
    for b in range(n_bands):
        row0 = b * n_rows
        b_ids, b_bounds = band_lists(ids, bounds, width, height, row0,
                                     n_rows)
        bands.append((b_ids, b_bounds, band_rows(d_rgb, row0, n_rows),
                      band_rows(d_ft, row0, n_rows), row0))
    band_h = n_rows * 16
    tile_kernel.launches = tile_kernel.backward_launches = 0
    outs, grads = [], []
    for b_ids, b_bounds, b_rgb, b_ft, row0 in bands:
        outs.append(tile_kernel.blend_forward(rows, b_ids, b_bounds, width,
                                              band_h, t_eps, row0))
        grads.append(tile_kernel.blend_backward(
            rows, b_ids, b_bounds, *outs[-1], b_rgb, b_ft, width, band_h,
            t_eps, row0))
    torch.cuda.synchronize()
    launches = (tile_kernel.launches, tile_kernel.backward_launches)
    stitched = [torch.cat([o[i] for o in outs], -2)[..., :height, :]
                for i in range(3)]
    bit_equal = {name: bool(torch.equal(a, w)) for name, a, w in zip(
        ("rgb", "final_t", "last_contrib"), stitched, whole)}
    summed = torch.stack(grads).sum(0)
    scale = whole_d.abs().amax(0).clamp_min(1e-30)
    k2_err = float(((summed - whole_d).abs() / scale).max())
    k1_ms = cuda_ms(lambda: tile_kernel.blend_forward(
        rows, ids, bounds, width, height, t_eps), 20)
    k2_ms = cuda_ms(lambda: tile_kernel.blend_backward(
        rows, ids, bounds, *whole, d_rgb, d_ft, width, height, t_eps), 20)
    band_k1_ms = [cuda_ms(lambda a=a: tile_kernel.blend_forward(
        rows, a[0], a[1], width, band_h, t_eps, a[4]), 20) for a in bands]
    band_k2_ms = [cuda_ms(lambda a=a, o=o: tile_kernel.blend_backward(
        rows, a[0], a[1], *o, a[2], a[3], width, band_h, t_eps, a[4]), 20)
        for a, o in zip(bands, outs)]
    plain = []
    for b_ids, b_bounds, b_rgb, b_ft, row0 in bands:
        k1 = compare_k1(rows, b_ids, b_bounds, width, band_h, t_eps, row0)
        k2 = compare_k2(rows, b_ids, b_bounds, width, band_h, b_rgb, b_ft,
                        t_eps, row_offset=row0)
        plain.append(dict(row0=row0, k1=k1, k2=k2))
    emit(phase="sharded_bands", case=case, bands=n_bands, tile_rows=n_rows,
         rows_past_image=n_rows * n_bands - tiles_y,
         instances=[int(a[0].numel()) for a in bands],
         bit_equal=bit_equal, k2_sum_err_of_max_grad=k2_err,
         launches=launches, k1_ms=k1_ms, band_k1_ms=band_k1_ms,
         k2_ms=k2_ms, band_k2_ms=band_k2_ms, plain=plain)
    check(all(bit_equal.values()),
          f"{case}: the stitched bands equal unbanded K1 ({bit_equal})")
    check(k2_err <= ENVELOPE, f"{case}: the bands' d_rows sum to K2's")
    for p in plain:
        check(p["k1"]["finite"] and p["k1"]["max_abs"] <= 2e-4
              and p["k1"]["mean_abs"] <= 1e-6,
              f"{case}: band at row {p['row0']}, K1 against its plain version")
        check(p["k2"]["finite"] and p["k2"]["envelope_err"] <= ENVELOPE,
              f"{case}: band at row {p['row0']}, K2 inside the plain envelope")
    check(launches == (n_bands, n_bands), "one K1 and one K2 a band")
    return launches


def rank_summary(report, phases):
    """A rank's report as the sharded phase prints it."""
    steps = report["steps"]

    def median(key, a, b):
        return float(np.median([s[key] for s in steps if a <= s["it"] <= b]))

    return dict(
        rank=report["rank"], backend=report["backend"],
        device=report["device"],
        step_ms_median={ph: median("ms", a, b)
                        for ph, (a, b) in phases.items()},
        splat_gather_bytes_median=median("splat_bytes", 1, len(steps)),
        splat_gather_ms_median={ph: median("splat_ms", a, b)
                                for ph, (a, b) in phases.items()},
        reshard_s=report["reshard_s"], densify=report["densify"],
        peak_mem_gib=report["peak_mem_gib"],
        k1_launches=report["k1_launches"],
        k2_launches=report["k2_launches"],
        foreign_modules=report["foreign_modules"])


def drift(losses, reference):
    """Per phase of SHARD_PHASES: the largest per-step |loss − reference| /
    reference and the mean of the signed (loss − reference) / reference."""
    rel = [(a - b) / b for a, b in zip(losses, reference)]
    return {ph: dict(max_abs_rel=max(abs(r) for r in rel[a - 1:b]),
                     mean_rel=float(np.mean(rel[a - 1:b])))
            for ph, (a, b) in SHARD_PHASES.items()}


def sharded_train_phase(tcfg, scene, single, dev):
    """train_sharded on SHARD_RANKS ranks sharing the card over gloo, the
    train cell's 90 steps; against the single-process run of the same call
    (`single`: its losses, its final and grown anchors). Exact: each rank's
    K1 and K2 once a step, the replicated parameters equal on the ranks,
    no jax, contextgs_tpu or PIL module in a rank, the gathered model's
    encode → decode round trip, K1 on a decoded view. Bounded, against the
    single run: the plain phase's per-step loss within 5% (no draws enter
    it: what differs is the band-local SSIM), every phase's mean signed
    drift within 5%, and the alive anchors within 25% of the grown. The
    noise and context steps draw their noise from each rank's generator,
    so their per-step losses differ from the single run's as a single run
    with other draws does (up to 7.2% at step 78 of this cell, NVIDIA H100
    80GB HBM3, 700 W): that spread is measured in the same call by a second
    single-process run with another seed and printed beside the sharded
    one. Returns the ranks' K1 and K2 launches."""
    from contextgs_tpu_torch.compression import codec
    from contextgs_tpu_torch.evaluation import make_decoded_renderer
    from contextgs_tpu_torch.train import loop as tloop
    from contextgs_tpu_torch.train.sharded_loop import train_sharded

    other = []

    def reseeded(it, ts_, metrics):
        if it == 1:
            ts_.generator.manual_seed(777)
        other.append(float(metrics.loss))

    tloop.train(tcfg, scene, callback=reseeded)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ts = train_sharded(tcfg, scene, SHARD_RANKS, device=dev, backend="gloo",
                       timeout=SHARD_TIMEOUT)
    train_s = time.perf_counter() - t0
    reports = ts.ranks
    losses = [s["loss"] for s in reports[0]["steps"]]
    sharded_drift = drift(losses, single["losses"])
    other_drift = drift(other, single["losses"])
    net_equal = all(torch.equal(x, reports[1]["net"][n])
                    for n, x in reports[0]["net"].items())
    alive = int(ts.model.buffers.alive.sum())
    grown = sum(d["grown"] for d in single["densify"])

    p, b = ts.model.params, ts.model.buffers
    root = tempfile.mkdtemp(prefix="contextgs_sharded_")
    try:
        t0 = time.perf_counter()
        _, states = codec.encode_scene(
            p, b, tcfg.model, ts.level_scales, ts.voxel_size, root,
            return_states=True, disable_hyper=tcfg.opt.disable_hyper)
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = codec.decode_scene(root, tcfg.model, device=dev)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    equal = {k: bool(np.array_equal(getattr(dec, k).cpu().numpy(),
                                    states[k]))
             for k in ("anchor", "feat", "scaling", "offsets", "masks",
                       "hyper", "level")}
    del states
    render = make_decoded_renderer(dec, tcfg, W, H, device=dev)
    k1_dec = compare_k1(*render_keeping_k1(
        render, scene.train_cameras[0], np.zeros(3, np.float32)))
    del render, dec
    summaries = [rank_summary(r, SHARD_PHASES) for r in reports]
    emit(phase="sharded_train", ranks=SHARD_RANKS, backend="gloo",
         steps=len(losses), seconds=train_s, anchors_final=alive,
         single_anchors_final=single["anchors_final"], single_grown=grown,
         drift_to_single=sharded_drift,
         other_draws_drift_to_single=other_drift, losses=losses,
         single_losses=single["losses"], other_draws_losses=other,
         level_scales=ts.level_scales, replicated_equal=net_equal,
         encode_s=encode_s, decode_s=decode_s, states_equal=equal,
         k1_decoded_view=k1_dec, per_rank=summaries)
    for r in summaries:
        check(r["k1_launches"] == TRAIN_STEPS
              and r["k2_launches"] == TRAIN_STEPS,
              f"rank {r['rank']}: K1 and K2 once a step")
        check(not r["foreign_modules"],
              f"rank {r['rank']} imported {r['foreign_modules']}")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          "sharded losses finite, one a step")
    check(net_equal, "the replicated parameters are equal on the ranks")
    check(all(equal.values()), f"sharded model round trip: {equal}")
    check(k1_dec["finite"] and k1_dec["max_abs"] <= 2e-4
          and k1_dec["mean_abs"] <= 1e-6, "K1 on a decoded view")
    check(sharded_drift["plain"]["max_abs_rel"] < 0.05,
          "sharded plain-phase loss within 5% of the single run's each step")
    check(all(abs(d["mean_rel"]) < 0.05 for d in sharded_drift.values()),
          f"sharded loss within 5% of the single run's per phase "
          f"({sharded_drift})")
    check(abs(alive - single["anchors_final"]) <= max(3, 0.25 * grown),
          "sharded alive anchors within 25% of the grown")
    return (sum(r["k1_launches"] for r in summaries),
            sum(r["k2_launches"] for r in summaries))


def mesh_driver_phase(dev, drivers_psnr):
    """drivers.train --mesh 1 over NCCL from main(argv), on the drivers
    phase's scene (made again in a temporary directory) with MESH_SCHEDULE,
    then drivers.decompress and drivers.test. Exact: results.json written,
    "decoded" and "ours_from_ckpt" equal to "ours", the rank's K1 and K2
    once a step over NCCL, K1 once a decoded test view in each driver, no
    jax or PIL module in the rank. Returns K1's and K2's launches."""
    import contextgs_tpu_torch.drivers.train as train_driver
    from contextgs_tpu_torch.drivers import decompress
    from contextgs_tpu_torch.drivers import test as test_driver
    from contextgs_tpu_torch.ops.rasterize import tile_kernel
    from contextgs_tpu_torch.scripts import make_synth_scene

    kept, seconds = {}, {}
    root = tempfile.mkdtemp(prefix="contextgs_mesh_")
    try:
        scene_dir = os.path.join(root, "scene")
        model = os.path.join(root, "model")
        with contextlib.redirect_stdout(sys.stderr):
            check(make_synth_scene.main(["--out", scene_dir, *DRIVER_SCENE])
                  == 0, "make_synth_scene")
        torch.cuda.empty_cache()
        parent = {}
        for name, main_fn, argv in (
                ("train", train_driver.main,
                 [*MESH_SCHEDULE, "--mesh", "1"]),
                ("decompress", decompress.main, []),
                ("test", test_driver.main, [])):
            tile_kernel.launches = tile_kernel.backward_launches = 0
            t0 = time.perf_counter()
            with wrapped(train_driver, "train_sharded", keep_output(kept)):
                check(main_fn(["-s", scene_dir, "-m", model, *argv]) == 0,
                      f"drivers.{name} (mesh)")
            seconds[name] = time.perf_counter() - t0
            parent[name] = (tile_kernel.launches,
                            tile_kernel.backward_launches)
        with open(os.path.join(model, "results.json")) as f:
            results = json.load(f)
        meta = torch.load(os.path.join(model, f"chkpnt{MESH_STEPS}.pt"),
                          weights_only=False)["meta"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rank = rank_summary(kept["out"].ranks[0], MESH_PHASES)
    ours, decoded = results["ours"], results["decoded"]
    n_test = DRIVER_TEST_VIEWS
    emit(phase="sharded_driver", steps=MESH_STEPS, ours=ours,
         decoded=decoded, ours_from_ckpt=results["ours_from_ckpt"],
         decoded_psnr=decoded["PSNR"], drivers_phase_decoded_psnr=drivers_psnr,
         checkpoint_n_devices=meta.get("n_devices"), seconds=seconds,
         parent_launches=parent, rank=rank)
    check(rank["backend"] == "nccl", "the mesh driver's rank ran NCCL")
    check(rank["k1_launches"] == MESH_STEPS
          and rank["k2_launches"] == MESH_STEPS,
          "mesh driver: K1 and K2 once a step in the rank")
    check(not rank["foreign_modules"],
          f"mesh driver rank imported {rank['foreign_modules']}")
    check(parent["train"] == (n_test, 0) and parent["decompress"]
          == (n_test, 0) and parent["test"] == (n_test, 0),
          f"mesh drivers: K1 once a decoded test view ({parent})")
    check(meta.get("n_devices") == 1, "the checkpoint says one rank")
    check(decoded["PSNR"] == ours["PSNR"] and decoded["SSIM"] == ours["SSIM"],
          "mesh: decompress's PSNR and SSIM equal train's")
    check(all(results["ours_from_ckpt"][k] == ours[k]
              for k in ("PSNR", "SSIM", "size_MB")),
          "mesh: ours_from_ckpt equals ours")
    check(decoded["PSNR"] > 15.0, "mesh: decoded test PSNR above 15 dB")
    k1 = rank["k1_launches"] + sum(v[0] for v in parent.values())
    return k1, rank["k2_launches"]


def sharded_phase(tcfg, scene, single, serve_k1, train_k1, dev,
                  drivers_psnr, prev_offset):
    """(a) the banded kernels on the serve view's and the last training
    step's K1/K2 inputs (and, where build/prev_offset holds their sources
    from before the row offset, K1 and K2 beside those in turns), (b) two
    ranks on the one card, (c) NCCL at world size 1 through the train
    driver. Returns K1's and K2's launches by path."""
    if prev_offset:
        emit(phase="offset_turns", case="serve_100k_1280x720",
             **offset_turns(prev_offset, serve_k1, cotangents(W, H, 50,
                                                              dev)))
    launches = {"sharded_bands": [0, 0]}
    for case, args, seed in (("serve_100k_1280x720", serve_k1, 60),
                             ("train_last_step_1280x720", train_k1, 61)):
        for n_bands in SHARD_BANDS:
            got = banded_kernels(case, args, cotangents(W, H, seed, dev),
                                 n_bands)
            launches["sharded_bands"][0] += got[0]
            launches["sharded_bands"][1] += got[1]
    launches["sharded_train"] = sharded_train_phase(tcfg, scene, single, dev)
    launches["sharded_driver"] = mesh_driver_phase(dev, drivers_psnr)
    return ({k: v[0] for k, v in launches.items()},
            {k: v[1] for k, v in launches.items()})


# the viewer phase: (step, scaling modifier) of each frame, one orbit camera
# a frame: the plain, noise and context steps of TRAIN_PHASES, and the last
# step again at half scale
VIEWER_FRAMES = ((15, 1.0), (45, 1.0), (90, 1.0), (90, 0.5))


def sibr_message(cam, scaling, train=True, keep_alive=False):
    """The camera message a SIBR remote viewer sends for `cam`: its
    matrices transposed already, in the viewer's flipped-axis convention
    (columns 1, 2 of the view and column 1 of the view-projection
    negated), length-prefixed JSON."""
    wv = cam.world_view.copy()
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    vp = cam.full_proj.copy()
    vp[:, 1] = -vp[:, 1]
    data = json.dumps(dict(
        resolution_x=cam.width, resolution_y=cam.height, train=train,
        fov_x=cam.fov_x, fov_y=cam.fov_y, z_near=cam.znear, z_far=cam.zfar,
        shs_python=False, rot_scale_python=False, keep_alive=keep_alive,
        scaling_modifier=scaling,
        view_matrix=[float(x) for x in wv.reshape(-1)],
        view_projection_matrix=[float(x) for x in vp.reshape(-1)])).encode()
    return len(data).to_bytes(4, "little") + data


def direct_frame(ts, tcfg, it, cam, scaling):
    """The uint8 frame of `cam` rendered directly (models/renderer.render)
    with the phase, level maps and generator seed the viewer uses."""
    from contextgs_tpu_torch.models import state as tst
    from contextgs_tpu_torch.models.levels import build_level_maps
    from contextgs_tpu_torch.models.renderer import render
    from contextgs_tpu_torch.train.loop import phase_of

    p, b = ts.model.params, ts.model.buffers
    phase, maps = phase_of(it, tcfg), None
    if phase == "context":
        maps = build_level_maps(tst.get_anchor(p, b), b.alive, ts.voxel_size,
                                tuple(ts.level_scales), tcfg.model.level_num)
    with torch.no_grad():
        out = render(p, b, tcfg.model, tcfg.opt, tcfg.pipe,
                     cam.as_device_dict(), cam.width, cam.height,
                     torch.zeros(3),
                     torch.Generator(p.anchor.device).manual_seed(0),
                     phase=phase, training=False, maps=maps,
                     scale_modifier=scaling)
    img = out.image.clamp(0.0, 1.0).permute(1, 2, 0).cpu().numpy()
    return (np.clip(img, 0.0, 1.0) * 255 + 0.5).astype(np.uint8).tobytes()


def viewer_phase(ts, tcfg):
    """The live viewer on the train cell's final model at 1280x720: a
    loopback SIBR client asks ViewerServer.poll for one frame at each of
    VIEWER_FRAMES (its own orbit camera each), which
    drivers.train.viewer_render draws through K1. K1's count is set to 0
    before each poll and read after. Exact: every frame whole (H·W·3 bytes
    and the verify string), equal to the direct render's bytes, the MiniCam
    from the wire within 1e-6 of the camera's matrices, K1 once a frame;
    K1 within 2e-4 (mean 1e-6) of its plain version on the context frame;
    the half-scale frame unlike the same camera at full scale. Returns K1's
    launches."""
    import socket
    import threading

    import contextgs_tpu_torch.ops.rasterize as trz
    from contextgs_tpu_torch.drivers import train as train_driver
    from contextgs_tpu_torch.ops.rasterize import tile_kernel
    from contextgs_tpu_torch.train.loop import phase_of
    from contextgs_tpu_torch.utils.viewer import (ViewerServer,
                                                  _recv_exact as recv_exact)

    cams = orbit_cameras(len(VIEWER_FRAMES), W, H, 3)
    verify = "/contextgs/viewer-smoke"
    server = ViewerServer("127.0.0.1", 0)
    client = socket.create_connection(("127.0.0.1", server.port), timeout=120)
    frames, seen, launches, frame_ms, poll_ms, k1_in = [], [], [], [], [], {}
    try:
        for i, ((it, scaling), cam) in enumerate(zip(VIEWER_FRAMES, cams)):
            got = {}

            def read(cam=cam, got=got):
                try:
                    got["frame"] = recv_exact(client, H * W * 3)
                    n = int.from_bytes(recv_exact(client, 4), "little")
                    got["verify"] = recv_exact(client, n).decode()
                except Exception as exc:        # reported by the gates
                    got["error"] = repr(exc)

            def render_rgb(mc, smod, it=it):
                seen.append(mc)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                img = train_driver.viewer_render(ts, it, tcfg, mc, smod)
                end.record()
                out = img.cpu().numpy()
                frame_ms.append(start.elapsed_time(end))
                return out

            client.sendall(sibr_message(cam, scaling))
            reader = threading.Thread(target=read)
            reader.start()
            keep = (wrapped(trz, "blend_forward", keep_args(k1_in))
                    if (it, scaling) == (90, 1.0)
                    else contextlib.nullcontext())
            tile_kernel.launches = 0
            t0 = time.perf_counter()
            with keep:
                server.poll(render_rgb, verify, it, TRAIN_STEPS)
            torch.cuda.synchronize()
            poll_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(tile_kernel.launches)
            reader.join(timeout=120)
            check(not reader.is_alive() and "error" not in got,
                  f"viewer frame {i}: {got.get('error', 'client hung')}")
            frames.append(got)
    finally:
        client.close()
        server.close()
    direct = [direct_frame(ts, tcfg, it, cam, scaling)
              for (it, scaling), cam in zip(VIEWER_FRAMES, cams)]
    full_scale_last = direct_frame(ts, tcfg, VIEWER_FRAMES[-1][0], cams[-1],
                                   1.0)
    cam_err = max(max(float(np.abs(mc.world_view - cam.world_view).max()),
                      float(np.abs(mc.full_proj - cam.full_proj).max()))
                  for mc, cam in zip(seen, cams))
    with torch.no_grad():
        k1 = compare_k1(*k1_in["args"])
    del k1_in
    emit(phase="viewer", width=W, height=H, frames=len(frames),
         steps=[it for it, _ in VIEWER_FRAMES],
         phases=[phase_of(it, tcfg) for it, _ in VIEWER_FRAMES],
         scaling=[s for _, s in VIEWER_FRAMES], k1_launches=launches,
         frame_ms=frame_ms, frame_ms_median=float(np.median(frame_ms)),
         poll_ms=poll_ms, poll_ms_median=float(np.median(poll_ms)),
         minicam_max_abs_err=cam_err,
         equal_to_direct=[f["frame"] == d for f, d in zip(frames, direct)],
         half_scale_differs=frames[-1]["frame"] != full_scale_last,
         k1_context_frame=k1)
    check(len(frames) == len(VIEWER_FRAMES) and all(
        len(f["frame"]) == H * W * 3 and f["verify"] == verify
        for f in frames), "viewer: every frame whole, then the verify string")
    check(len(seen) == len(VIEWER_FRAMES) and cam_err <= 1e-6,
          "viewer: the MiniCam from the wire is the orbit camera")
    check(all(f["frame"] == d for f, d in zip(frames, direct)),
          "viewer: each frame equals the direct render's bytes")
    check(launches == [1] * len(VIEWER_FRAMES), "viewer: K1 once a frame")
    check(k1["finite"] and k1["max_abs"] <= 2e-4 and k1["mean_abs"] <= 1e-6,
          "viewer: K1 on the context frame")
    check(frames[-1]["frame"] != full_scale_last,
          "viewer: the half-scale frame differs from the full-scale one")
    return sum(launches)


def tools_phase(root, model, train_bits, estimate_mb):
    """The tool scripts on the drivers phase's model directory: codec_diag
    (the newest checkpoint encoded again with the stream audit), whose
    payload and escape bits per stream must be the bytes of the train
    driver's {stream}{level}.b files, with symbols coded; collect_results
    over the directory, whose rows must be results.json's variants and
    PSNR; sweep over SWEEP_LMBDAS on a small synthetic scene (each run a
    drivers.train process on the card), both runs exiting 0 with a
    results.json."""
    import csv

    from contextgs_tpu_torch.compression.codec import STREAMS
    from contextgs_tpu_torch.scripts import (codec_diag, collect_results,
                                             make_synth_scene, sweep)

    seconds = {}
    t0 = time.perf_counter()
    table = io.StringIO()
    diag_json = os.path.join(root, "codec_diag.json")
    with contextlib.redirect_stdout(table):
        check(codec_diag.main(["-m", model, "--out", diag_json]) == 0,
              "codec_diag")
    seconds["codec_diag"] = time.perf_counter() - t0
    with open(diag_json) as f:
        diag = json.load(f)
    file_bits = {s: 8 * sum(os.path.getsize(os.path.join(train_bits, n))
                            for n in os.listdir(train_bits)
                            if re.fullmatch(rf"{s}\d+\.b", n))
                 for s in STREAMS}
    audit = {s: dict(coded_bits=diag["streams"][s]["payload_bits"]
                     + diag["streams"][s]["escape_bits"],
                     file_bits=file_bits[s], n_sym=diag["streams"][s]["n_sym"],
                     act_over_ideal=(diag["streams"][s]["payload_bits"]
                                     + diag["streams"][s]["escape_bits"])
                     / max(diag["streams"][s]["ideal_bits"], 1e-9),
                     estimate_mb=estimate_mb.get(s))
             for s in STREAMS if s in diag["streams"]}

    t0 = time.perf_counter()
    csv_path = os.path.join(root, "results.csv")
    with contextlib.redirect_stdout(sys.stderr):
        check(collect_results.main(["--root", model, "--out", csv_path])
              == 0, "collect_results")
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)
    seconds["collect_results"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    data = os.path.join(root, "sweep_data")
    out = os.path.join(root, "sweep_out")
    with contextlib.redirect_stdout(sys.stderr):
        check(make_synth_scene.main(["--out", os.path.join(data, "synth"),
                                     *SWEEP_SCENE]) == 0,
              "make_synth_scene (sweep)")
    log = io.StringIO()
    # each run is `python -m contextgs_tpu_torch.drivers.train`, found from
    # the checkout's root
    with contextlib.redirect_stdout(log), contextlib.chdir(
            os.path.dirname(os.path.abspath(__file__))):
        check(sweep.main(["--dataset", "mipnerf360", "--data_root", data,
                          "--scenes", "synth", "--lmbdas",
                          *map(str, SWEEP_LMBDAS), "--out", out,
                          "--iterations", str(SWEEP_STEPS),
                          "--extra", *SWEEP_SCHEDULE]) == 0, "sweep")
    seconds["sweep"] = time.perf_counter() - t0
    runs = {}
    for lm in SWEEP_LMBDAS:
        path = os.path.join(out, "mipnerf360", "synth", f"lmbda_{lm}",
                            "results.json")
        if os.path.exists(path):
            with open(path) as f:
                ours = json.load(f)["ours"]
            runs[str(lm)] = dict(size_MB=ours["size_MB"], PSNR=ours["PSNR"])
    failed = [ln for ln in log.getvalue().splitlines()
              if ln.startswith("FAILED")]
    emit(phase="tools", codec_diag_table=table.getvalue().splitlines(),
         codec_diag=audit, collect_results_rows=rows, sweep=runs,
         sweep_failed=failed, seconds=seconds)
    for s, a in audit.items():
        check(a["coded_bits"] == a["file_bits"] and a["n_sym"] > 0,
              f"codec_diag: {s} payload + escape = its stream files")
    check(set(audit) == set(STREAMS), "codec_diag: every stream audited")
    check(sorted((r["variant"], float(r["PSNR"])) for r in rows)
          == sorted((k, v["PSNR"]) for k, v in results.items()),
          "collect_results: the rows are results.json's variants and PSNR")
    check(not failed and len(runs) == len(SWEEP_LMBDAS)
          and all(math.isfinite(r["PSNR"]) and r["size_MB"] > 0
                  for r in runs.values()),
          f"sweep: both runs exit 0 with a results.json ({failed})")


# rd_branch: the queue's point, a λ other than the drivers run's, trained
# from that run's checkpoint at the transition for 50 context steps and
# finalised without the bench (the drivers phase ran it; the drivers run's
# own directory is not finalised: the drivers and tools phases already ran
# the test driver and codec_diag on it, and again they would cost about
# 80 s); two in-process branches at the drivers run's own λ are compared
# with the run on 20 steps, the run within BRANCH_SPREAD times the largest
# difference of the two branches
BRANCH_LMBDA = 0.002
BRANCH_ITERS = DRIVER_CONTEXT_FROM + 50
BRANCH_CHECK = 20
BRANCH_STEPS = range(DRIVER_CONTEXT_FROM + 1,
                     DRIVER_CONTEXT_FROM + BRANCH_CHECK + 1)
BRANCH_SPREAD = 10


class StopTraining(Exception):
    """Raised by a training callback to end a run early."""


def keep_saved(store):
    """Wrapper of train.loop.save_checkpoint that keeps a CPU copy of the
    state saved at the context transition (the one a branch starts
    from)."""
    def wrap(fn):
        def call(path, params, buffers, adam, meta):
            fn(path, params, buffers, adam, meta)
            if meta["iteration"] == DRIVER_CONTEXT_FROM:
                store.update(state_leaves(params, buffers, adam, meta))
        return call
    return wrap


def state_leaves(params, buffers, adam, meta):
    """{name: CPU copy} of a training state: every parameter, buffer and
    Adam moment, Adam's count, both generators' states and the camera
    order."""
    from contextgs_tpu_torch.models import state as tst

    leaves = {f"param.{k}": v for k, v in tst.param_leaves(params).items()}
    leaves.update({f"buffer.{k}": v for k, v in buffers._asdict().items()})
    leaves.update({f"adam.mu.{k}": v for k, v in adam.mu.items()})
    leaves.update({f"adam.nu.{k}": v for k, v in adam.nu.items()})
    leaves.update({"adam.count": adam.count,
                   "numpy_generator": meta["rng_state"],
                   "torch_generator": meta.get("generator_state"),
                   "camera_order": list(meta["cam_order"]),
                   "level_scales": meta["level_scales"]})
    return {k: v.detach().cpu().clone() if torch.is_tensor(v) else v
            for k, v in leaves.items()}


def same_leaf(a, b):
    if torch.is_tensor(a) or torch.is_tensor(b):
        return (torch.is_tensor(a) and torch.is_tensor(b)
                and a.dtype == b.dtype and torch.equal(a, b))
    return a == b


def losses_of(cfg, scene, dev, stop_at):
    """{step: loss} of train.loop.train(cfg) on the card up to `stop_at`,
    with K1's and K2's launches."""
    from contextgs_tpu_torch.ops.rasterize import tile_kernel
    from contextgs_tpu_torch.train import loop as tloop

    out = {}

    def cb(it, ts, metrics):
        if it in BRANCH_STEPS:
            out[it] = float(metrics.loss)
        if it == stop_at:
            raise StopTraining

    tile_kernel.launches = tile_kernel.backward_launches = 0
    try:
        tloop.train(cfg, scene, device=dev, callback=cb)
    except StopTraining:
        pass
    return out, tile_kernel.launches, tile_kernel.backward_launches


def rd_branch_phase(root, model, cfg, scene, saved, losses, dev):
    """The RD queue on the drivers run: the state loaded from its
    checkpoint at the context transition held bit for bit to the state
    it saved; two branches at the run's own λ in process (20 steps, no
    codec) against the run's steps 401-420 and against each other (K2's
    atomics and autograd's index backward sum in a varying order on the
    card, so after the first resumed step two branches differ as the
    branch and the run do: the run must lie within BRANCH_SPREAD times
    the branches' largest difference); then scripts.rd_queue trains
    λ = BRANCH_LMBDA from that checkpoint into <root>/l{λ:g} (a
    drivers.train process: the context steps, encode, decode, the decoded
    test views) and scripts.rd_finalize runs the test driver and
    codec_diag on it, then rd_table.
    Returns K1's and K2's launches (the in-process runs; the children's
    are theirs)."""
    import dataclasses

    from contextgs_tpu_torch.scripts import rd_finalize, rd_queue, rd_table
    from contextgs_tpu_torch.train import loop as tloop

    seconds = {}
    base = os.path.join(model, f"chkpnt{DRIVER_CONTEXT_FROM}.pt")
    stop = DRIVER_CONTEXT_FROM + BRANCH_CHECK
    branch_cfg = dataclasses.replace(
        cfg, model_path="", save_iterations=(), checkpoint_iterations=(),
        test_iterations=(), start_checkpoint=base)
    restored = {}

    def keep_loaded(fn):          # a copy: training updates it in place
        def call(*args):
            out = fn(*args)
            restored.update(state_leaves(*out))
            return out
        return call

    t0 = time.perf_counter()
    with wrapped(tloop, "load_checkpoint", keep_loaded):
        branched, k1_b, k2_b = losses_of(branch_cfg, scene, dev, stop)
    seconds["branch_in_process"] = time.perf_counter() - t0
    differ = sorted(k for k in saved if not same_leaf(saved[k],
                                                      restored.get(k)))
    t0 = time.perf_counter()
    again, k1_c, k2_c = losses_of(branch_cfg, scene, dev, stop)
    seconds["second_branch"] = time.perf_counter() - t0

    def rel(a, b):
        return {it: abs(a[it] - b[it]) / abs(b[it]) for it in BRANCH_STEPS}

    branch_off = rel(branched, losses)
    spread = rel(again, branched)
    first = BRANCH_STEPS[0]

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        queue_rc = rd_queue.main([
            "--out", root, "--base", base,
            "--lmbdas", f"{BRANCH_LMBDA:g}", "--iters", str(BRANCH_ITERS),
            "--voxel_size", f"{cfg.model.voxel_size:g}",
            "--checkpoint_iterations", str(BRANCH_ITERS), "--no_wait",
            "--extra_flags", " ".join(DRIVER_SHARED)])
    seconds["rd_queue"] = time.perf_counter() - t0
    with open(os.path.join(root, "summary.jsonl")) as f:
        entries = [json.loads(x) for x in f if x.strip()]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        finalize_rc = rd_finalize.main(["--out", root, "--no_bench"])
    seconds["rd_finalize"] = time.perf_counter() - t0
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        rd_table.main(["--out", root])
    rows = [ln for ln in table.getvalue().splitlines()[2:]
            if ln.startswith("| ")]
    run = os.path.join(root, f"l{BRANCH_LMBDA:g}")
    res = {}
    if os.path.exists(os.path.join(run, "results.json")):
        with open(os.path.join(run, "results.json")) as f:
            res = {k: dict(PSNR=v["PSNR"], size_MB=v["size_MB"])
                   for k, v in json.load(f).items()}
    with open(os.path.join(model, "results.json")) as f:
        run_ours = json.load(f)["ours"]
    with open(os.path.join(root, "rd_finalize.log")) as f:
        finalize_steps = [ln.strip() for ln in f if ln.startswith("=== ")]
    emit(phase="rd_branch", base=os.path.relpath(base, root),
         state_leaves=len(saved), state_differs=differ,
         first_step=dict(branch=branched.get(first),
                         second_branch=again.get(first),
                         run=losses.get(first)),
         branch_rel_off=branch_off, two_branches_rel_spread=spread,
         second_branch_rel_off=rel(again, losses),
         max_branch_off=max(branch_off.values()),
         max_spread=max(spread.values()), spread_factor=BRANCH_SPREAD,
         launches=dict(branch_k1=k1_b, branch_k2=k2_b, second_k1=k1_c,
                       second_k2=k2_c),
         queue_rc=queue_rc, summary=[{k: e.get(k) for k in (
             "lmbda", "iters", "rc", "branched_from")} for e in entries],
         finalize_rc=finalize_rc, finalize_steps=finalize_steps,
         rd_table=table.getvalue().splitlines(), results=res,
         codec_diag=os.path.exists(os.path.join(run, "codec_diag.json")),
         drivers_run={k: run_ours[k] for k in ("PSNR", "size_MB")},
         seconds=seconds)
    check(len(saved) > 0 and not differ,
          f"the state loaded from {os.path.basename(base)} equals the "
          f"state the drivers run saved ({differ})")
    check(saved["level_scales"] is None,
          "no level scales in the checkpoint at the transition")
    check(sorted(branched) == sorted(again) == sorted(losses)
          == list(BRANCH_STEPS), "the losses of steps 401-420 of each run")
    check(branched[first] == again[first] == losses[first],
          "the first resumed step's loss equals the continuous run's")
    check(max(branch_off.values())
          <= BRANCH_SPREAD * max(spread.values()),
          f"the branch within {BRANCH_SPREAD} times the spread of two "
          "branches")
    check(k1_b == k2_b == k1_c == k2_c == BRANCH_CHECK,
          "K1 and K2 once a step in the in-process branches")
    check(queue_rc == 0 and len(entries) == 1
          and entries[0]["rc"] == 0
          and entries[0]["branched_from"]
          == f"model/chkpnt{DRIVER_CONTEXT_FROM}",
          "rd_queue: the point trained, its entry branched from the base")
    point = f"l{BRANCH_LMBDA:g}"
    check(finalize_rc == 0 and [ln.split()[1] for ln in finalize_steps]
          == ["test", "codec_diag", "rd_table", "finalize"]
          and all(ln.split()[2] == point for ln in finalize_steps[:2]),
          "rd_finalize: the test driver and codec_diag on the point, "
          "rd_table, each exiting 0")
    check(set(res) == {"ours", "ours_from_ckpt"}
          and all(math.isfinite(v["PSNR"]) for v in res.values())
          and res["ours_from_ckpt"] == res["ours"],
          "the point's results.json: ours_from_ckpt = ours")
    check(os.path.exists(os.path.join(run, "codec_diag.json")),
          "the point's codec_diag.json")
    check(len(rows) == len(entries)
          and f"| {BRANCH_LMBDA:g} | {BRANCH_ITERS} | " in rows[0],
          "rd_table: a row for each point of the queue")
    return k1_b + k1_c, k2_b + k2_c


# the sweep of the tools phase: a small synthetic scene, two λ, a short
# three-phase schedule with one densify (about 1.4k anchors: the codec's
# host CDF build, not the steps, sets a run's time)
SWEEP_SCENE = ["--res", "128", "--cams", "16", "--gauss", "20000",
               "--points", "1000"]
SWEEP_LMBDAS = (0.004, 0.0005)
SWEEP_STEPS = 100
SWEEP_SCHEDULE = ["--noise_from", "33", "--context_from", "66",
                  "--start_stat", "5", "--update_from", "10",
                  "--update_interval", "20", "--update_until", "30"]
# growth_parity: the JAX script's state at 20k points, 3 keys, 2 ranks
# sharing the card over gloo
GROWTH_ARGV = ["--devices", "2", "--points", "20000", "--keys", "3"]


def growth_phase():
    """scripts.growth_parity on the card (2 ranks sharing it over gloo):
    its table and the mean delta; gates: no overflow (main raises),
    single > 0 for each key, and the single column equal to the same call
    on the CPU with the same draws."""
    from contextgs_tpu_torch.scripts import growth_parity

    t0 = time.perf_counter()
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        check(growth_parity.main(GROWTH_ARGV) == 0, "growth_parity")
    seconds = time.perf_counter() - t0
    lines = table.getvalue().splitlines()
    keys = int(GROWTH_ARGV[GROWTH_ARGV.index("--keys") + 1])
    # the table rounds delta% to 0.1%: work it out from the integer columns
    rows = [dict(zip(("key", "single", "mesh_raw", "mesh_dedup"),
                     map(int, ln.split()[:4])))
            for ln in lines[1:1 + keys]]
    for r in rows:
        r["delta_pct"] = (100.0 * (r["mesh_dedup"] - r["single"])
                          / max(r["single"], 1))
    cfg = growth_parity.config()
    points = int(GROWTH_ARGV[GROWTH_ARGV.index("--points") + 1])
    state = growth_parity.seeded_state(cfg, points)
    draws = growth_parity.key_draws(
        cfg, state[0].offsets.shape[0] * cfg.model.n_offsets, keys)
    cpu = [growth_parity.single_growth(cfg, state, d, "cpu") for d in draws]
    emit(phase="growth_parity", argv=GROWTH_ARGV, table=lines, rows=rows,
         mean_delta_pct=float(np.mean([r["delta_pct"] for r in rows])),
         single_cpu=[c[0] for c in cpu], seconds=seconds)
    check(len(rows) == keys and all(r["single"] > 0 for r in rows),
          "growth_parity: anchors grown on every key")
    check([r["single"] for r in rows] == [c[0] for c in cpu]
          and not any(c[1] for c in cpu),
          "growth_parity: the single column equals the CPU's")


# scaling_bench: (ranks, backend) and its flags
SCALING_RUNS = ((1, "nccl"), (2, "gloo"))
SCALING = dict(size=512, points=20000, iters=8)


def scaling_phase(dev):
    """scripts.scaling_bench's measure at world size 1 over NCCL and 2 over
    gloo sharing the card: Mpix/s of the whole sharded context step (K1 and
    K2 banded); each rank's K1 and K2 once a step (warm-up chain and timed
    chain), the loss finite, no foreign module in a rank; each rank's last
    K1 and K2 calls (its band, by its row offset) against their plain
    versions on the same inputs, K1 within 2e-4 (mean 1e-6), K2 inside the
    plain envelope. Returns K1's and K2's launches over the ranks."""
    from contextgs_tpu_torch.scripts import scaling_bench

    out, k1, k2 = [], 0, 0
    for n, backend in SCALING_RUNS:
        t0 = time.perf_counter()
        res = scaling_bench.measure(n, SCALING["size"], SCALING["points"],
                                    SCALING["iters"], device=dev,
                                    backend=backend, keep_kernel_args=True)
        seconds = time.perf_counter() - t0
        ranks = res["ranks"]
        # these launches are not the path's: its counts are the ranks' own
        plain, t0 = [], time.perf_counter()
        with torch.no_grad():
            for r, x in enumerate(ranks):
                kept = x.pop("kernel_args")
                a1, a2 = (tuple(a.to(dev) if torch.is_tensor(a) else a
                                for a in kept[name])
                          for name in ("blend_forward", "blend_backward"))
                plain.append(dict(
                    rank=r, row_offset=a1[6], band=list(a1[3:5]),
                    k1=compare_k1(*a1),
                    k2=compare_k2(*a2[:3], a2[8], a2[9], *a2[6:8], a2[10],
                                  row_offset=a2[11])))
                del kept, a1, a2
        plain_s = time.perf_counter() - t0
        out.append(dict(ranks=n, backend=backend, mpix_s=res["pix_s"] / 1e6,
                        loss=res["loss"], seconds=seconds, plain=plain,
                        plain_s=plain_s,
                        per_rank=[dict(rank=r, timed_s=x["seconds"],
                                       k1_launches=x["k1_launches"],
                                       k2_launches=x["k2_launches"],
                                       steps=x["steps"],
                                       foreign_modules=x["foreign_modules"])
                                  for r, x in enumerate(ranks)]))
        for r, x in enumerate(ranks):
            check(x["k1_launches"] == x["steps"] == x["k2_launches"]
                  == 2 * SCALING["iters"],
                  f"scaling {n} ranks: rank {r} K1 and K2 once a step")
            check(not x["foreign_modules"],
                  f"scaling {n} ranks: rank {r} imported "
                  f"{x['foreign_modules']}")
            k1 += x["k1_launches"]
            k2 += x["k2_launches"]
        check(math.isfinite(res["loss"]), f"scaling {n} ranks: loss finite")
        check(sorted(p["row_offset"] for p in plain)
              == [r * -(-SCALING["size"] // (16 * n)) for r in range(n)],
              f"scaling {n} ranks: one band a rank, by its row offset")
    emit(phase="scaling", **SCALING, runs=out)
    for run in out:
        for p in run["plain"]:
            where = f"scaling {run['ranks']} ranks, rank {p['rank']}"
            check(p["k1"]["finite"] and p["k1"]["max_abs"] <= 2e-4
                  and p["k1"]["mean_abs"] <= 1e-6,
                  f"{where}: K1 against its plain version")
            check(p["k2"]["finite"] and p["k2"]["envelope_err"] <= ENVELOPE,
                  f"{where}: K2 inside the plain envelope")
    return k1, k2


# the raster_tools phase: the rasterizer-measuring scripts at their
# defaults; thr_sweep's two largest rows and kern_micro's six configs held
# against the plain versions;
# r3_suite with one λ on the sweep's small scene, 100 steps
PROFILE_ITERS = 10
THR_ITERS = 20
THR_CHECKED = ((2_000_000, 1280, 720), (1_000_000, 1920, 1080))
# the card's demand against the CPU's (a radius can move by one for a very
# large splat): at most this share of the CPU's demand apart
DEMAND_RTOL = 1e-4
FPS_BENCH = dict(anchors=100_000, views=32, width=1280, height=720)
KERN_MICRO_ITERS = 20
R3_LMBDA = 0.004
R3_STEPS = 100


def counted(fn):
    """fn() with K1's and K2's counts set to 0 just before; → (its output,
    K1's launches, K2's launches)."""
    from contextgs_tpu_torch.ops.rasterize import tile_kernel

    tile_kernel.launches = tile_kernel.backward_launches = 0
    out = fn()
    return out, tile_kernel.launches, tile_kernel.backward_launches


def kept_kernels(fn):
    """fn() with the last arguments of ops.rasterize's blend_forward and
    blend_backward kept; → (its output, K1's launches, K2's launches, K1's
    last arguments, K2's last arguments)."""
    import contextgs_tpu_torch.ops.rasterize as trz

    k1, k2 = {}, {}
    with wrapped(trz, "blend_forward", keep_args(k1)), \
            wrapped(trz, "blend_backward", keep_args(k2)):
        out = counted(fn)
    return (*out, k1.get("args"), k2.get("args"))


def plain_checks(where, k1_args, k2_args, width, height):
    """K1 (max 2e-4, mean 1e-6) and K2 (inside the plain envelope) against
    their plain versions on the arguments kept from a script's run."""
    t0 = time.perf_counter()
    with torch.no_grad():
        k1 = compare_k1(*k1_args[:3], width, height)
        k2 = compare_k2(*k2_args[:3], width, height, *k2_args[6:8])
    res = dict(k1=k1, k2=k2, seconds=time.perf_counter() - t0)
    check(k1["finite"] and k1["max_abs"] <= 2e-4 and k1["mean_abs"] <= 1e-6,
          f"{where}: K1 against its plain version")
    check(k2["finite"] and k2["envelope_err"] <= ENVELOPE,
          f"{where}: K2 inside the plain envelope")
    return res


def raster_tools_phase(dev, root):
    """The port's rasterizer-measuring scripts on the card, each run by its
    module-level `measure` (or `main`) with K1's and K2's counts set to 0
    just before and read just after: profile at the bench frame,
    thr_sweep's five default rows, fps_bench (100k anchors, 32 views,
    1280x720), kern_micro's six configs, corner_diag at its defaults, and
    r3_suite (one λ on a 128x128, 16-view, 1k-point synthetic scene, 100
    steps, in `root`) read back by rd_table. Gates: each script's K1 and
    K2 launches as its protocol makes them; K1 and K2 against their plain
    versions on profile's frame, on thr_sweep's two largest rows and on
    each of kern_micro's six configs;
    thr_sweep's and corner_diag's demands against a CPU projection of the
    same draws (DEMAND_RTOL); fps_bench's chained and naive sums of the
    images' means (1e-6 relative); corner_diag's n_valid equal to its
    tight demand; r3_suite's entry with rc 0 and results, an rd_table row
    with a finite PSNR, and the λ skipped on a second call. Returns
    {script: (K1 launches, K2 launches)}."""
    from contextgs_tpu_torch.drivers import bench
    from contextgs_tpu_torch.scripts import (corner_diag, fps_bench,
                                             kern_micro, profile, r3_suite,
                                             rd_table, thr_sweep)

    launches = {}
    t_phase = time.perf_counter()

    # profile: E2E, then each stage by events and by the profiler
    it = PROFILE_ITERS
    res, k1, k2, k1_args, k2_args = kept_kernels(
        lambda: profile.measure(dev, iters=it))
    launches["profile"] = (k1, k2)
    checks = plain_checks("profile", k1_args, k2_args, res["width"],
                          res["height"])
    del k1_args, k2_args
    emit(phase="raster_tools", script="profile", **res,
         k1_launches=k1, k2_launches=k2, plain=checks)
    check(k1 == bench.WARMUP + it + 1 + 2 * (it + 1)
          and k2 == bench.WARMUP + it + 2 * (it + 1),
          "profile: K1 and K2 once an E2E step and a stage call")

    # thr_sweep: the five default rows; the two largest checked
    rows = []
    for g, w, h in thr_sweep.configs(thr_sweep.DEFAULT):
        row, k1, k2, k1_args, k2_args = kept_kernels(
            lambda: thr_sweep.measure(g, w, h, THR_ITERS, dev))
        launches[f"thr_sweep_{g}x{w}x{h}"] = (k1, k2)
        if (g, w, h) in THR_CHECKED:
            row["plain"] = plain_checks(f"thr_sweep {g}x{w}x{h}", k1_args,
                                        k2_args, w, h)
        del k1_args, k2_args
        torch.cuda.empty_cache()
        means, scales, quats, _, opac = thr_sweep.inputs(g, "cpu")
        row["demand_cpu"] = thr_sweep.probe_demand(
            means, scales, quats, opac, bench.camera_kwargs(w, h, "cpu"))
        del means, scales, quats, opac
        row.update(k1_launches=k1, k2_launches=k2)
        emit(phase="raster_tools", script="thr_sweep", **row)
        rows.append(row)
        check(k1 == k2 == bench.WARMUP + THR_ITERS,
              f"thr_sweep {g}x{w}x{h}: K1 and K2 once a step")
        check(abs(row["demand"] - row["demand_cpu"])
              <= DEMAND_RTOL * row["demand_cpu"],
              f"thr_sweep {g}x{w}x{h}: the demand against the CPU's")
        check(math.isfinite(row["ms_per_iter"]) and row["ms_per_iter"] > 0,
              f"thr_sweep {g}x{w}x{h}: a time")

    # fps_bench: the naive loop and the chained one
    res, k1, k2 = counted(lambda: fps_bench.measure(**FPS_BENCH, device=dev))
    launches["fps_bench"] = (k1, k2)
    emit(phase="raster_tools", script="fps_bench", **res, k1_launches=k1,
         k2_launches=k2)
    check(k1 == 1 + 2 * FPS_BENCH["views"] and k2 == 0,
          "fps_bench: K1 once a view")
    check(res["naive_sum"] > 0 and abs(res["chained_sum"] - res["naive_sum"])
          <= 1e-6 * abs(res["naive_sum"]),
          "fps_bench: the chained sum of the means against the naive one")

    # kern_micro: K1 and K2 on the lab table, six configs, each checked
    table, k1, k2 = counted(lambda: kern_micro.measure(
        dev, KERN_MICRO_ITERS, keep_kernel_args=True))
    launches["kern_micro"] = (k1, k2)
    for row in table:
        kept = row.pop("kernel_args")
        a1, a2 = kept["blend_forward"], kept["blend_backward"]
        row["plain"] = plain_checks(f"kern_micro {row['label']}", a1, a2,
                                    *a1[3:5])
        del kept, a1, a2
    emit(phase="raster_tools", script="kern_micro", iters=KERN_MICRO_ITERS,
         table=table, k1_launches=k1, k2_launches=k2)
    n = len(kern_micro.CONFIGS)
    check(k1 == n * (KERN_MICRO_ITERS + 2) and k2 == n * (KERN_MICRO_ITERS + 1),
          "kern_micro: K1 and K2 as time_ms calls them")

    # corner_diag: on the card and on the CPU
    diag = corner_diag.measure(device=dev)
    diag_cpu = corner_diag.measure(device="cpu")
    emit(phase="raster_tools", script="corner_diag", **diag, cpu=diag_cpu)
    check(diag["n_valid"] == diag["demand_tight"],
          "corner_diag: n_valid is the tight demand")
    for key in ("demand_plain", "demand_tight"):
        check(abs(diag[key] - diag_cpu[key]) <= DEMAND_RTOL * diag_cpu[key],
              f"corner_diag: {key} against the CPU's")

    # r3_suite: one λ, then rd_table, then the skip
    out = os.path.join(root, "r3")
    argv = ["--out", out, *SWEEP_SCENE, "--iters", str(R3_STEPS),
            "--lmbdas", f"{R3_LMBDA:g}",
            "--extra_flags", " ".join(SWEEP_SCHEDULE)]
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = r3_suite.main(argv)
    r3_s = time.perf_counter() - t0
    with open(os.path.join(out, "summary.jsonl")) as f:
        entries = [json.loads(x) for x in f if x.strip()]
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        rd_rc = rd_table.main(["--out", out])
    rd_lines = table.getvalue().splitlines()
    again = io.StringIO()
    with contextlib.redirect_stdout(again):
        rc_again = r3_suite.main(argv)
    with open(os.path.join(out, "summary.jsonl")) as f:
        n_entries = sum(1 for x in f if x.strip())
    emit(phase="raster_tools", script="r3_suite", argv=argv, seconds=r3_s,
         entries=[{k: v for k, v in e.items() if k != "results"}
                  for e in entries],
         psnr=[e.get("results", {}).get("ours", {}).get("PSNR")
               for e in entries],
         rd_table=rd_lines, second_call=again.getvalue().splitlines())
    check(rc == 0 and len(entries) == 1 and entries[0]["rc"] == 0
          and entries[0]["lmbda"] == R3_LMBDA and "results" in entries[0],
          "r3_suite: one entry, rc 0, with results")
    psnr = rd_lines[2].split("|")[3].strip() if len(rd_lines) == 3 else ""
    check(rd_rc == 0 and math.isfinite(float(psnr or "nan")),
          f"rd_table: a row with a PSNR ({rd_lines})")
    check(rc_again == 0 and n_entries == 1
          and f"skip λ={R3_LMBDA:g} (done)" in again.getvalue(),
          "r3_suite: the λ skipped on a second call")
    emit(phase="raster_tools_done", seconds=time.perf_counter() - t_phase,
         launches=launches)
    return launches


# glue_labs: the demand of pack_lab's frame, the bench frame, as the JAX
# package counts it (the bench frame of thr_sweep and profile)
PACK_LAB_DEMAND = 547_648


def sorted_pairs(keys, payload):
    """(key, payload) pairs in lexicographic order, on the host: an
    unstable sort's output as the multiset of payloads of each key."""
    keys, payload = keys.cpu().numpy(), payload.cpu().numpy()
    i = np.lexsort((payload, keys))
    return keys[i], payload[i]


def lab_agree(name, card, cpu, inputs):
    """(held, the largest difference) of a lab piece's card output against
    its CPU output: exact for gathers, transposes, integer scatters and
    cumsums and the sorts' keys; the sorts' payloads (and a sort's
    indices) as a multiset for each key; a float32 cumsum within
    `r3_micro.cumsum_tolerance` at each output, a regroup within
    `pack_lab.regroup_tolerance` at each gaussian (each 8·2^-24 times the
    rounding scale of the scan or the segment sum: about 0.06 at the end of
    the cumsum's 786,432 rows, at most about 0.0065 on the bench frame's
    regroup)."""
    from contextgs_tpu_torch.scripts import pack_lab, r3_micro

    if isinstance(card, tuple):           # (sorted keys, payload or index)
        keys_equal = torch.equal(card[0].cpu(), cpu[0])
        a, b = sorted_pairs(*card), sorted_pairs(*cpu)
        return (keys_equal and all(np.array_equal(x, y)
                                   for x, y in zip(a, b))), None
    card = card.cpu()
    if card.dtype != cpu.dtype or card.shape != cpu.shape:
        return False, None
    if not card.is_floating_point() or not ("cumsum" in name
                                            or "regroup" in name):
        return torch.equal(card, cpu), None
    err = (card.double() - cpu.double()).abs()
    xs = [x.cpu() for x in inputs]
    if "regroup" in name:
        bound = pack_lab.regroup_tolerance(xs[0], xs[1], card.shape[0])
    else:
        bound = r3_micro.cumsum_tolerance(xs[0], 0)
    return bool((err <= bound).all()), float(err.max())


def hold_pieces(pieces):
    """{piece: {"held", "max_abs"}} of each (name, fn, inputs) on the card
    against the same piece on the CPU, on the same inputs."""
    out = {}
    for name, fn, xs in pieces:
        with torch.no_grad():
            card = fn(*xs)
            cpu = fn(*[x.cpu() for x in xs])
        held, err = lab_agree(name, card, cpu, xs)
        out[name] = dict(held=held, max_abs=err)
        del card, cpu
    return out


def glue_labs_phase(dev):
    """scripts.r3_micro and scripts.pack_lab on the card (their tables,
    each piece timed by CUDA events), every piece held against the same
    piece on the CPU on the same inputs, pack_lab's frame on the card
    against the same frame on the CPU (instances, depth order and ranks,
    monotone fractions exactly) and its demand against the JAX package's
    count."""
    from contextgs_tpu_torch.scripts import pack_lab, r3_micro

    t_phase = time.perf_counter()
    tables = {}
    for lab, run in (("r3_micro", lambda: r3_micro.measure(dev)),
                     ("pack_lab", lambda: pack_lab.measure(dev))):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = run()
        tables[lab] = res
        emit(phase="glue_labs", lab=lab, table=out.getvalue().splitlines())
        torch.cuda.empty_cache()
    micro = hold_pieces(r3_micro.pieces(dev))
    torch.cuda.empty_cache()
    card = pack_lab.frame(dev)
    cpu = pack_lab.frame("cpu")
    frame_equal = dict(
        demand=card.inst.demand == cpu.inst.demand,
        gauss_ids=torch.equal(card.inst.gauss_ids.cpu(),
                              cpu.inst.gauss_ids),
        tile_bounds=torch.equal(card.inst.tile_bounds.cpu(),
                                cpu.inst.tile_bounds),
        order=torch.equal(card.order.cpu(), cpu.order),
        rank=torch.equal(card.rank.cpu(), cpu.rank),
        grads=torch.equal(card.grads.cpu(), cpu.grads))
    mono = pack_lab.monotone_fraction
    monotone = dict(gauss_ids=(mono(card.inst.gauss_ids),
                               mono(cpu.inst.gauss_ids)),
                    depth_rank=(mono(card.rank), mono(cpu.rank)))
    rows_off = float((card.rows.cpu() - cpu.rows).abs().max())
    packed = hold_pieces(pack_lab.pieces(card))
    del card, cpu
    emit(phase="glue_labs", check="card against the CPU",
         r3_micro=micro, pack_lab=packed, frame_equal=frame_equal,
         monotone=monotone, rows_max_abs_card_cpu=rows_off,
         demand=tables["pack_lab"]["demand"],
         jax_demand=PACK_LAB_DEMAND, b_pad=tables["pack_lab"]["b_pad"],
         seconds=time.perf_counter() - t_phase)
    for name, res in {**micro, **packed}.items():
        check(res["held"], f"glue_labs: {name} on the card = on the CPU")
    check(len(micro) == 19 and len(packed) == 9, "glue_labs: every piece")
    check(all(frame_equal.values()), f"pack_lab frame: {frame_equal}")
    check(all(a == b for a, b in monotone.values()),
          "pack_lab: the monotone fractions")
    check(tables["pack_lab"]["demand"] == PACK_LAB_DEMAND,
          "pack_lab: the demand is the JAX package's count")
    check(all(ms > 0 for t in (tables["r3_micro"], tables["pack_lab"]["ms"])
              for ms in t.values()), "glue_labs: every piece timed")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from contextgs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                            PipelineConfig, TrainConfig)
    from contextgs_tpu_torch.evaluation import (evaluate_images,
                                                make_decoded_renderer,
                                                render_set)
    from contextgs_tpu_torch.compression import coder
    from contextgs_tpu_torch.models import renderer as trenderer
    from contextgs_tpu_torch.models import state as tst
    from contextgs_tpu_torch.ops import carry, cuda_build, scan
    from contextgs_tpu_torch.ops.rasterize import projection as tproj
    from contextgs_tpu_torch.ops.rasterize import reference, tile_kernel
    from contextgs_tpu_torch.ops.rasterize import sorting as tsort
    from contextgs_tpu_torch.scripts import kvariants, xpose_lab
    from contextgs_tpu_torch.scripts.fps_bench import decoded_scene

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device + build ----
    begin("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    prev = prev_kernels()
    prev_offset = prev_offset_sources()
    knockouts = k2_knockout_sources()
    geometry, geometry_sources = k1_geometry_sources()
    prev_k4 = PREV_K4 if os.path.exists(PREV_K4) else None
    check(reference.FWD_WARP == k1_warp(geometry),
          "reference.FWD_WARP is the warp of K1's source")
    t0 = time.perf_counter()
    cuda_build.build(tile_kernel.SOURCES + (scan.SOURCE, kvariants.SOURCE,
                                            xpose_lab.SOURCE, tproj.SOURCE,
                                            tsort.SOURCE, carry.SOURCE)
                     + (tuple(prev.values()) if prev else ())
                     + (tuple(prev_offset.values()) if prev_offset else ())
                     + tuple(knockouts.values())
                     + tuple(geometry_sources.values())
                     + ((prev_k4,) if prev_k4 else ()))
    build_s = time.perf_counter() - t0
    coder.library()                      # the range coder, host C++
    k1_geometries = {name: k1_from(src)
                     for name, src in geometry_sources.items()}
    old_k4 = k4_from(prev_k4) if prev_k4 else None

    def ptxas(stem):
        out = cuda_build.build_log.get(stem, {}).get("ptxas", "")
        return [ln.strip() for ln in out.splitlines() if "Used" in ln]

    emit(phase="device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, k1_ptxas=ptxas("blend_forward"),
         k2_ptxas=ptxas("blend_backward"), k3_ptxas=ptxas("scan"),
         k4_ptxas=ptxas("kvariants"), k56_ptxas=ptxas("xpose"),
         projection_ptxas=ptxas("projection"), carry_ptxas=ptxas("carry"),
         binning_ptxas={name: lines for name, lines
                        in ptxas_kernels("binning").items()
                        if not name.startswith("_ZN3cub")},
         prev_sources=prev, k2_prev_ptxas=ptxas("blend_backward_prev"),
         k2_knockouts=sorted(knockouts), k1_geometry=geometry,
         k1_other_geometries=sorted(geometry_sources),
         range_coder=coder.build_info,
         pil_imports=module_imports("PIL"),
         torchvision_imports=module_imports("torchvision"))
    k4_levels = {f"v{lv}": {"ptxas": next(
        (v for k, v in ptxas_kernels("kvariants").items() if f"ILi{lv}E" in k),
        None), "blocks_per_sm": kvariants.blocks_per_sm(lv)}
        for lv in K4_LEVELS}
    if prev_k4:
        for lv in K4_LEVELS:
            k4_levels[f"v{lv}"]["previous_design_ptxas"] = next(
                (v for k, v in ptxas_kernels("kvariants_prev").items()
                 if f"ILi{lv}E" in k), None)
    emit(phase="k4_ptxas", levels=k4_levels, previous_design=prev_k4)
    emit(phase="k1_ptxas", k1=ptxas_kernels("blend_forward"),
         k4_v4=k4_levels["v4"]["ptxas"],
         other_geometries={name: ptxas_kernels(f"blend_forward_{name}")
                           for name in geometry_sources},
         k2=ptxas_kernels("blend_backward"),
         before_row_offset=prev_offset and dict(
             k1=ptxas_kernels("blend_forward_nooffset"),
             k2=ptxas_kernels("blend_backward_nooffset")))
    k4_sass = sass_summary(kvariants.SOURCE)
    if k4_sass is None:
        emit(phase="k4_sass", cuobjdump=None)
    else:
        check_k4_sass(k4_sass, sass_summary(tile_kernel.SOURCE))

    # ---- 2. K1 against its plain version ----
    begin("kernel_checks")
    for name, (rows, ids, bounds, w, h) in (list(golden_cases(dev))
                                            + list(cull_cases(dev))):
        res = compare_k1(rows, ids, bounds, w, h)
        emit(phase="k1_check", case=name, **res)
        check(res["finite"] and res["max_abs"] <= 2e-5, f"K1 {name}")
        check(res["last_contrib_mismatch"] == 0, f"K1 last_contrib {name}")
    got_g = tile_kernel.blend_forward(*next(iter(
        c for n, c in golden_cases(dev) if n == "chunk_boundary")))[0][1]
    check(float(got_g.abs().max()) == 0.0, "chunk-boundary green must be 0")
    for i, (name, (rows, ids, bounds, w, h)) in enumerate(
            list(golden_cases(dev)) + list(cull_cases(dev))):
        check_k2(name, compare_k2(rows, ids, bounds, w, h,
                                  *cotangents(w, h, 30 + i, dev)))
    scan.launches = 0
    k3_err = check_k3(dev)
    k3_check_launches = scan.launches
    carry.launches = 0
    carry_res = carry_check(dev)
    carry_check_launches = carry.launches
    for name, case in list(golden_cases(dev)) + list(cull_cases(dev)):
        check_k4(name, *case)
    tiles_x, tiles_y = kvariants.TILES_X, kvariants.TILES_Y
    k4_err = check_k4("lab_1x3600", *kvariants.lab_inputs(
        1, tiles_x * tiles_y, device=dev), 16 * tiles_x, 16 * tiles_y,
        big=True)
    # K1 bit-equal to K4's level 4, and so is every other geometry of
    # K1's; and to the previous design's level 4 where its copy is present
    for name, case in (list(golden_cases(dev)) + list(cull_cases(dev))
                       + [("lab_1x3600", (*kvariants.lab_inputs(
                           1, tiles_x * tiles_y, device=dev), 16 * tiles_x,
                           16 * tiles_y))]):
        k1_equals_v4(name, *case, others=k1_geometries, old_k4=old_k4)
    k56_err = check_k56(dev)

    cfg = TrainConfig(model=ModelConfig())
    mcfg = cfg.model
    bg = np.zeros(3, np.float32)
    dec20 = decoded_scene(20_000, 20, mcfg, dev)
    rows, ids, bounds = render_keeping_k1(
        make_decoded_renderer(dec20, cfg, W, H), orbit_cameras(1, W, H, 20)[0],
        bg)[:3]
    res = compare_k1(rows, ids, bounds, W, H)
    emit(phase="k1_check", case="decoded_20k_1280x720",
         n_gauss=int(rows.shape[0]), n_instances=int(ids.numel()),
         n_vis=int(torch.unique(ids).numel()), **res)
    check(res["finite"] and res["max_abs"] <= 2e-4
          and res["mean_abs"] <= 1e-6, "K1 at 1280x720, 20k anchors")
    check_k2("decoded_20k_1280x720",
             compare_k2(rows, ids, bounds, W, H, *cotangents(W, H, 40, dev)))
    del dec20, rows, ids, bounds

    # ---- 3. the main path: serve a 100k-anchor decoded scene ----
    begin("serve")
    import contextgs_tpu_torch.ops.rasterize as trz

    dec = decoded_scene(100_000, 0, mcfg, dev)
    cams = orbit_cameras(N_VIEWS, W, H, 1)
    render = make_decoded_renderer(dec, cfg, W, H)
    render(cams[0].as_device_dict(), bg)        # allocator warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_kept, sort_kept, view_ms = {}, {}, []
    proj_kept, cull_kept = {}, {}
    with wrapped(trz, "blend_forward", keep_args(k1_kept)), \
            wrapped(trz, "expand_and_sort", keep_args(sort_kept)), \
            wrapped(trz, "project_gaussians", keep_call(proj_kept)), \
            wrapped(trz, "visible_filter", keep_call(cull_kept)):
        tile_kernel.launches = scan.launches = 0
        tproj.launches = tproj.cull_launches = 0
        tsort.launches = 0
        renders, gts, fps = render_set(render, cams, bg, view_ms=view_ms)
        torch.cuda.synchronize()
        k1_launches, k3_serve = tile_kernel.launches, scan.launches
        proj_serve = dict(serve=tproj.launches,
                          serve_cull=tproj.cull_launches)
        bin_serve = tsort.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = evaluate_images(renders, gts)
    timed = view_ms[WARMUP:]
    serve_ms = 1e3 / fps
    emit(phase="serve", views=N_VIEWS, timed_views=len(timed), width=W,
         height=H, anchors=100_000, ms_per_view=serve_ms, fps=fps,
         view_ms_median=float(np.median(timed)), view_ms_min=min(timed),
         view_ms_max=max(timed), k1_launches=k1_launches,
         k3_launches=k3_serve,
         peak_mem_gib=peak_gib, PSNR=metrics["PSNR"], SSIM=metrics["SSIM"],
         LPIPS=metrics["LPIPS"])
    check(k1_launches == N_VIEWS, "K1 launches on the main path != views")
    check(proj_serve == dict(serve=N_VIEWS, serve_cull=N_VIEWS),
          "one projection and one cull launch a view")
    check(bin_serve == 2 * N_VIEWS, "two binning launches a view")
    check(all(tuple(r.shape) == (3, H, W) and bool(torch.isfinite(r).all())
              for r in renders), "renders finite [3,H,W]")
    check(math.isfinite(metrics["PSNR"]) and math.isfinite(metrics["SSIM"]),
          "PSNR/SSIM finite")

    # stage split: the orbit again, CUDA events around the renderer's
    # module-level calls (these K1 launches are not the main path's)
    log, split_view_ms = [], []
    with contextlib.ExitStack() as stack:
        for module, name in stage_targets():
            stack.enter_context(wrapped(module, name, timed_call(
                name, log, STAGE_COUNTS.get(name, lambda out: None))))
        split_renders, _, _ = render_set(render, cams, bg,
                                         view_ms=split_view_ms)
    torch.cuda.synchronize()
    check(len(log) == len(STAGES) * N_VIEWS, "one call of each stage a view")
    check(all(float((a - b).abs().max()) <= 1e-6
              for a, b in zip(renders, split_renders)),
          "the timed pass renders what the main path rendered")
    del split_renders
    views = [log[i:i + len(STAGES)] for i in range(0, len(log), len(STAGES))]
    split = {f"{n}_ms": 0.0 for n in STAGES}
    for view in views[WARMUP:]:
        for name, start, end, _ in view:
            split[f"{name}_ms"] += start.elapsed_time(end) / len(timed)
    split["view_ms"] = float(np.mean(split_view_ms[WARMUP:]))
    split["other_ms"] = split["view_ms"] - sum(split[f"{n}_ms"]
                                               for n in STAGES)
    by_name = [{name: out for name, _, _, out in view} for view in views]
    emit(phase="serve_split", **split,
         n_gauss=[v["decode_neural_gaussians"] for v in by_name],
         n_instances=[v["expand_and_sort"][0] for v in by_name],
         n_vis=[int(v["expand_and_sort"][1]) for v in by_name])
    del log, views, by_name

    # K1 on the main path's inputs (last view): check, time, bound
    rows, ids, bounds, _, _, t_eps = k1_kept["args"][:6]
    k1_res = compare_k1(rows, ids, bounds, W, H, t_eps)
    emit(phase="k1_check", case="serve_100k_1280x720", **k1_res)
    check(k1_res["finite"] and k1_res["max_abs"] <= 2e-4
          and k1_res["mean_abs"] <= 1e-6, "K1 on the main path's inputs")
    k1_ms = cuda_ms(lambda: tile_kernel.blend_forward(rows, ids, bounds, W, H,
                                                      t_eps), 20)
    plain_ms = cuda_ms(lambda: reference.blend_tiles_reference(
        rows, ids, bounds, W, H, W // 16, t_eps=t_eps), 3)
    pairs = reference.blend_tiles_reference(rows, ids, bounds, W, H, W // 16,
                                            t_eps=t_eps, count_pairs=True)[3]
    k1_bound = k1_bound_of(rows, ids, bounds, W, H, pairs)
    emit(phase="k1_bound", case="serve_100k_1280x720", pairs=pairs,
         pairs_listed=256 * int(ids.numel()), **k1_bound, k1_ms=k1_ms,
         plain_ms=plain_ms, share_of_bound=k1_bound["bound_ms"] / k1_ms,
         share_of_bound_walked=k1_bound["bound_walked_ms"] / k1_ms)
    proj_serve_res = projection_check("serve_100k_1280x720",
                                      proj_kept["call"], cull_kept["call"],
                                      dev)
    bin_serve_res = binning_check("serve_100k_1280x720", sort_kept["args"])
    del proj_kept, cull_kept
    # K2 on the serve view's K1 inputs with seeded cotangents: a denser
    # list than training's; checked here, timed against the previous K2
    # after training
    serve_k2 = (rows, ids, bounds,
                *tile_kernel.blend_forward(rows, ids, bounds, W, H, t_eps),
                *cotangents(W, H, 50, dev), W, H, t_eps)
    k2_serve_res = compare_k2(rows, ids, bounds, W, H, *serve_k2[6:8], t_eps)
    check_k2("serve_100k_1280x720", k2_serve_res)
    k2_serve_bound = k2_bound_of(rows, ids, bounds, W, H, pairs)
    # K4 on the same inputs: check, then the stage split of K1's time
    check_k4("serve_100k_1280x720", rows, ids, bounds, W, H, t_eps, big=True)
    emit(**k4_decompose(
        "serve_100k_1280x720", [kvariants.run_variant(lv, rows, ids, bounds,
                                                      W, H)
                                for lv in K4_LEVELS],
        (rows, ids, bounds), W, H, t_eps, old_k4),
        tile_lengths=tile_lengths(bounds))
    # the last view's per-gaussian tile counts in depth order: the input of
    # the first prefix sum of ops/rasterize/sorting.py, K3's shape (a)
    proj = sort_kept["args"][0]
    counts_g = proj.n_tiles.to(torch.int64)
    order = torch.sort(torch.where(counts_g > 0, proj.depths, float("inf")),
                       stable=True).indices
    tile_counts = counts_g[order].to(torch.int32)[None].contiguous()
    del sort_kept, proj, counts_g, order

    # CPU-vs-card check of the whole decoded-render path at a small size
    small_cfg = TrainConfig(model=ModelConfig())
    dec_s = decoded_scene(2_000, 5, small_cfg.model, dev)
    cam_s = orbit_cameras(1, 128, 96, 5)[0].as_device_dict()
    img_gpu = make_decoded_renderer(dec_s, small_cfg, 128, 96)(cam_s, bg)
    dec_cpu = dec_s._replace(**{k: getattr(dec_s, k).cpu() for k in
                                ("anchor", "feat", "scaling", "offsets",
                                 "masks", "hyper")},
                             mlps=dec_s.mlps.cpu())
    img_cpu = make_decoded_renderer(dec_cpu, small_cfg, 128, 96,
                                    device="cpu")(cam_s, bg)
    d = (img_gpu.cpu() - img_cpu).abs()
    emit(phase="e2e_small_cpu_vs_card", max_abs=float(d.max()),
         mean_abs=float(d.mean()), nonzero=float(img_cpu.abs().sum()))
    check(float(d.max()) <= 2e-3 and float(d.mean()) <= 1e-5
          and float(img_cpu.abs().sum()) > 1.0, "small render CPU vs card")

    # render(phase="plain") from the port's own init over a 100k-point cloud
    rng = np.random.default_rng(7)
    pts = rng.uniform(-2, 2, (100_000, 3))
    model, voxel = tst.init_scene_model(
        pts, mcfg, generator=torch.Generator().manual_seed(7))
    p = model.params
    n_cap = p.anchor.shape[0]
    p = p._replace(
        anchor_feat=torch.from_numpy(rng.normal(
            size=(n_cap, mcfg.feat_dim)).astype(np.float32) * 0.3).to(dev),
        offsets=torch.from_numpy(rng.normal(
            size=(n_cap, mcfg.n_offsets, 3)).astype(np.float32)).to(dev))
    tile_kernel.launches = 0
    with torch.no_grad():
        out = trenderer.render(p, model.buffers, mcfg, OptimizationConfig(),
                               PipelineConfig(), cams[0].as_device_dict(), W,
                               H, torch.zeros(3, device=dev), phase="plain")
    torch.cuda.synchronize()
    plain_launches = tile_kernel.launches
    emit(phase="render_plain", anchors=int(model.buffers.alive.sum()),
         capacity=n_cap, voxel_size=voxel, k1_launches=plain_launches,
         n_instances=out.n_instances, n_vis=int(out.n_vis),
         image_sum=float(out.image.sum()),
         finite=bool(torch.isfinite(out.image).all()))
    check(plain_launches == 1, "render(phase='plain') launched K1 once")
    check(bool(torch.isfinite(out.image).all())
          and float(out.image.abs().sum()) > 1.0, "render_plain image")

    # ---- 4. the SSIM gradient in full float32 ----
    begin("ssim_grad")
    res = ssim_grad(dev)
    emit(phase="ssim_grad", width=W, height=H, **res)
    check(res["rel_err"] <= 1e-5, "SSIM gradient on the card vs float64")

    # ---- 5. the main path of training ----
    begin("train")
    import contextgs_tpu_torch.train.loop as tloop
    import contextgs_tpu_torch.train.optim as toptim
    import contextgs_tpu_torch.train.step as tstep

    scene = train_scene(dec, renders, orbit_cameras(N_VIEWS, W, H, 1))
    del render, renders, split_view_ms, k1_kept, rows, ids, bounds
    tcfg = TrainConfig(model=ModelConfig(), opt=OptimizationConfig(
        iterations=TRAIN_STEPS, noise_from=TRAIN_PHASES["plain"][1],
        context_from=TRAIN_PHASES["noise"][1], start_stat=5, update_from=10,
        update_interval=10, update_until=75),
        test_iterations=(), save_iterations=(), log_every=10 ** 9)
    log, losses, bpps, step_ms, k2_kept, level_calls = [], [], [], [], {}, []
    proj_kept, cull_kept, adam_kept, bin_kept = {}, {}, {}, {}
    t_prev = [time.perf_counter()]

    def mark_step(it, ts, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - t_prev[0]) * 1e3)
        t_prev[0] = now
        losses.append(metrics.loss)
        bpps.append(metrics.bit_per_param)
        log.append(("step", it, None, None))

    def keep_level_counts(fn):
        def call(anchors, member, *args):
            maps = fn(anchors, member, *args)
            level_calls.append((member.sum(), maps.counts.sum()))
            return maps
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(tstep, "build_level_maps",
                                    keep_level_counts))
        for module, name, stage in train_split_targets():
            summary = ((lambda r: (r.n_grown, r.n_pruned))
                       if stage == "densify" else lambda out: None)
            stack.enter_context(wrapped(module, name,
                                        timed_call(stage, log, summary)))
        stack.enter_context(wrapped(trz, "blend_backward",
                                    keep_args(k2_kept)))
        stack.enter_context(wrapped(trz, "project_gaussians",
                                    keep_call(proj_kept)))
        stack.enter_context(wrapped(trz, "visible_filter",
                                    keep_call(cull_kept)))
        stack.enter_context(wrapped(tstep, "adam_update",
                                    keep_call(adam_kept)))
        stack.enter_context(wrapped(trz, "expand_and_sort",
                                    keep_args(bin_kept)))
        tile_kernel.launches = tile_kernel.backward_launches = 0
        tsort.launches = 0
        scan.launches = 0
        tproj.launches = tproj.cull_launches = tproj.backward_launches = 0
        toptim.launches = 0
        carry.launches = 0
        t_prev[0] = time.perf_counter()
        ts = tloop.train(tcfg, scene, callback=mark_step)
        torch.cuda.synchronize()
        carry_train = carry.launches
        train_k1 = tile_kernel.launches
        train_k2 = tile_kernel.backward_launches
        k3_train = scan.launches
        proj_train = dict(train=tproj.launches,
                          train_cull=tproj.cull_launches,
                          train_backward=tproj.backward_launches)
        adam_train = toptim.launches
        bin_train = tsort.launches
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    bpps = [float(x) for x in bpps]
    level_calls = [(int(a), int(b)) for a, b in level_calls]

    def phase_at(it):
        return next(ph for ph, (a, b) in TRAIN_PHASES.items() if a <= it <= b)

    split = {ph: {f"{st}_ms": 0.0 for st in TRAIN_STAGES}
             for ph in TRAIN_PHASES}
    n_split = {ph: b - max(a, SPLIT_FROM) + 1
               for ph, (a, b) in TRAIN_PHASES.items()}
    densified, it = [], 0
    for name, start, end, out in log:
        if name == "step":
            it = start
            continue
        if name == "densify":
            densified.append(dict(step=it + 1, grown=int(out[0]),
                                  pruned=int(out[1])))
        if it + 1 >= SPLIT_FROM:          # entries after step it's mark
            ph = phase_at(it + 1)
            split[ph][f"{name}_ms"] += start.elapsed_time(end) / n_split[ph]
    for ph, (a, b) in TRAIN_PHASES.items():
        ms = step_ms[max(a, SPLIT_FROM) - 1:b]
        split[ph]["step_ms_median"] = float(np.median(ms))
        split[ph]["step_ms_min"] = min(ms)
        split[ph]["step_ms_max"] = max(ms)
        split[ph]["other_ms"] = float(np.mean(ms)) - sum(
            split[ph][f"{st}_ms"] for st in TRAIN_STAGES if st != "context")
    ctx_from = TRAIN_PHASES["context"][0]
    emit(phase="train", steps=TRAIN_STEPS, width=W, height=H,
         anchors_init=int(dec.anchor.shape[0]),
         anchors_final=int(ts.model.buffers.alive.sum()),
         capacity=int(ts.model.buffers.alive.shape[0]),
         k1_launches=train_k1, k2_launches=train_k2, k3_launches=k3_train,
         adam_launches=adam_train, carry_launches=carry_train,
         ms_per_step_median={ph: split[ph]["step_ms_median"]
                             for ph in TRAIN_PHASES},
         split=split, densify=densified, peak_mem_gib=train_peak,
         level_scales=ts.level_scales, level_calls=len(level_calls),
         kept_and_level_counts_last=level_calls[-1] if level_calls else None,
         loss_first5=losses[:5], loss_last5=losses[-5:],
         bpp_context_first5=bpps[ctx_from - 1:ctx_from + 4],
         bpp_last5=bpps[-5:])
    check(train_k2 == TRAIN_STEPS, "K2 launches on the training path != steps")
    check(train_k1 == TRAIN_STEPS, "K1 launches on the training path != steps")
    check(proj_train == dict(train=TRAIN_STEPS, train_cull=TRAIN_STEPS,
                             train_backward=TRAIN_STEPS),
          "one projection, cull and backward launch a training step")
    check(adam_train == TRAIN_STEPS, "one Adam launch a training step")
    check(bin_train == 2 * TRAIN_STEPS, "two binning launches a training step")
    check(carry_train == (tcfg.model.level_num - 1) * len(level_calls)
          + tcfg.model.update_depth * len(densified),
          "one carry launch a level above 0 of each level map and one a "
          "depth of each densify round")
    proj_train_res = projection_check(
        "train_last_step_1280x720", proj_kept["call"], cull_kept["call"], dev,
        backward_seed=60)
    (_, adam_grads, _, adam_opt, adam_it, adam_scale), _ = adam_kept["call"]
    adam_res = adam_check("train_last_step", ts.model.params, adam_grads,
                          ts.adam, adam_opt, adam_it + 1, adam_scale)
    bin_train_res = binning_check("train_last_step_1280x720",
                                  bin_kept["args"])
    del proj_kept, cull_kept, adam_kept, adam_grads, bin_kept
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          "training losses finite")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]), "training loss falls")
    check(all(math.isfinite(b) and b > 0 for b in bpps[ctx_from - 1:]),
          "bit_per_param finite and above 0 on every context step")
    check(ts.level_scales is not None and len(ts.level_scales) == 2,
          "level scales searched at the context transition")
    check(len(level_calls) == TRAIN_STEPS - ctx_from + 1
          and all(a == b for a, b in level_calls),
          "one level map a context step, its counts summing to the kept set")
    check(len(densified) == 6, "densify ran at steps 20 to 70")
    for ph in ("noise", "context"):
        emit(phase="train_profile", **profile_train_steps(
            ts, tcfg, scene, dev, ph))

    # the context phase's eval render of the final state, twice; the size
    begin("context_eval")
    run = tstep.make_eval_render(tcfg, W, H, "context", ts.level_scales,
                                 ts.voxel_size)
    cam = scene.train_cameras[0].as_device_dict()
    bg_t = torch.zeros(3, device=dev)
    tile_kernel.launches = 0
    images = [run(ts.model.params, ts.model.buffers, cam, bg_t)
              for _ in range(2)]
    torch.cuda.synchronize()
    size_mb = tloop.estimate_bits(ts.model, tcfg, ts)
    emit(phase="context_eval", k1_launches=tile_kernel.launches,
         finite=bool(torch.isfinite(images[0]).all()),
         identical=bool(torch.equal(images[0], images[1])),
         image_mean=float(images[0].mean()), size_mb=size_mb)
    check(tile_kernel.launches == 2 and bool(torch.isfinite(images[0]).all())
          and torch.equal(images[0], images[1]),
          "context eval render finite and bit-identical")
    check(all(math.isfinite(v) and v >= 0 for v in size_mb.values())
          and size_mb["total"] > 0, "size estimate")
    del images

    # ---- 5b. the live viewer on the trained model (K1) ----
    begin("viewer")
    viewer_k1 = viewer_phase(ts, tcfg)

    # ---- 6. the codec: encode the trained model, decode, serve (K1) ----
    begin("codec")
    codec_k1, cdf = codec_phase(ts, tcfg, scene, run, size_mb, serve_ms, dev)
    single = dict(losses=losses, densify=densified,
                  anchors_final=int(ts.model.buffers.alive.sum()))
    del ts, dec, log

    # ---- 6b. the drivers from disk, and the rasterizer bench ----
    begin("drivers")
    from contextgs_tpu_torch.compression import cdf_rows
    cdf_rows.launches = 0
    drivers_k1, drivers_k2, drivers_psnr = drivers_phase(dev)
    cdf["launches_by_path"]["drivers"] = cdf_rows.launches
    check(cdf_rows.launches > 0, "the drivers' codec built its CDF rows on "
          "the card")
    begin("k1_k2_bounds")

    kept = k2_kept["args"]
    k2_res = compare_k2(*kept[:3], W, H, *kept[6:8], kept[10])
    check_k2("train_last_step_1280x720", k2_res)

    cpu_losses, card_losses = train_small_cpu_vs_card(dev)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    emit(phase="train_small_cpu_vs_card", cpu=cpu_losses, card=card_losses,
         max_rel=rel)
    check(rel <= 1e-3, "small training run CPU vs card")

    (cpu_l, cpu_b), (card_l, card_b) = context_small_cpu_vs_card(dev)
    rel_l = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    rel_b = max(abs(a - b) / abs(b) for a, b in zip(card_b, cpu_b))
    emit(phase="context_small_cpu_vs_card", cpu_loss=cpu_l, card_loss=card_l,
         cpu_bpp=cpu_b, card_bpp=card_b, max_rel_loss=rel_l,
         max_rel_bpp=rel_b)
    check(rel_l <= 1e-3 and rel_b <= 1e-3 and min(cpu_b) > 0,
          "small context run CPU vs card")

    # K2 on the main path's last inputs: time, bound
    k2_ms = cuda_ms(lambda: tile_kernel.blend_backward(*kept), 20)
    k2_plain_ms = cuda_ms(
        lambda: reference.blend_tiles_backward_reference(*kept), 3)
    rows, ids, bounds = kept[:3]
    pairs = reference.blend_tiles_reference(rows, ids, bounds, W, H, W // 16,
                                            t_eps=kept[10],
                                            count_pairs=True)[3]
    k2_bound = k2_bound_of(rows, ids, bounds, W, H, pairs)
    # K1 on the same inputs: the training path's forward of its last step
    k1_train_ms = cuda_ms(lambda: tile_kernel.blend_forward(
        rows, ids, bounds, W, H, kept[10]), 20)
    k1_train_bound = k1_bound_of(rows, ids, bounds, W, H, pairs)
    emit(phase="k1_bound", case="train_last_step_1280x720",
         **k1_train_bound, k1_ms=k1_train_ms,
         share_of_bound=k1_train_bound["bound_ms"] / k1_train_ms)
    # K4 on the training path's last inputs: check, then the stage split
    check_k4("train_last_step_1280x720", rows, ids, bounds, W, H, kept[10],
             big=True)
    emit(**k4_decompose(
        "train_last_step_1280x720", [kvariants.run_variant(
            lv, rows, ids, bounds, W, H) for lv in K4_LEVELS],
        (rows, ids, bounds), W, H, kept[10], old_k4),
        tile_lengths=tile_lengths(bounds))
    # K1 against K4's level 4: bit-equal, then in turns
    k1_turns = {}
    for case, args in (("serve_100k_1280x720", (*serve_k2[:3], W, H,
                                                serve_k2[10])),
                       ("train_last_step_1280x720", (rows, ids, bounds, W, H,
                                                     kept[10]))):
        k1_equals_v4(case, *args, others=k1_geometries, old_k4=old_k4)
        k1_turns[case] = k1_old_new(case, args, k1_geometries)
    # K2 against the previous one, in turns on the same inputs: the last
    # step's and the serve view's
    k2_serve_ms = cuda_ms(lambda: tile_kernel.blend_backward(*serve_k2), 20)
    k2_turns = {}
    if prev:
        old = k2_from(prev["k2"], banded=False)
        for case, args in (("train_last_step_1280x720", kept),
                           ("serve_100k_1280x720", serve_k2)):
            k2_turns[case] = in_turns(
                lambda a=args: old(*a),
                lambda a=args: tile_kernel.blend_backward(*a),
                lambda f: cuda_ms(f, 20))
            got, was = tile_kernel.blend_backward(*args), old(*args)
            k2_turns[case]["max_abs_diff_of_max_grad"] = float(
                (got - was).abs().max() / was.abs().max())
    for case, ms, bound, res, bpairs in (
            ("train_last_step_1280x720", k2_ms, k2_bound, k2_res, pairs),
            ("serve_100k_1280x720", k2_serve_ms, k2_serve_bound,
             k2_serve_res, None)):
        turns = k2_turns.get(case)
        emit(phase="k2_bound", case=case, pairs=bpairs, **bound, k2_ms=ms,
             plain_ms=k2_plain_ms if bpairs else None,
             share_of_bound=bound["bound_ms"] / ms,
             share_of_bound_walked=bound["bound_walked_ms"] / ms,
             max_abs_err=res["max_abs"],
             k2_prev_ms=turns["prev_ms"] if turns else None,
             k2_new_ms=turns["ms"] if turns else None, turns=turns,
             faster_than_prev=turns["ms"] < turns["prev_ms"] if turns
             else None)
    emit(phase="k2_knockouts", case="serve_100k_1280x720",
         **k2_knockouts(knockouts, serve_k2))

    # ---- 6b'. the scripts that measure the rasterizer, and r3_suite ----
    begin("raster_tools")
    root = tempfile.mkdtemp(prefix="contextgs_raster_tools_")
    try:
        raster_launches = raster_tools_phase(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    raster_k1 = {k: v[0] for k, v in raster_launches.items()}
    raster_k2 = {k: v[1] for k, v in raster_launches.items() if v[1]}

    # ---- 6b''. the glue labs: r3_micro and pack_lab ----
    begin("glue_labs")
    glue_labs_phase(dev)

    # ---- 6c. sharded: bands, two ranks on the card, NCCL at one ----
    begin("sharded")
    sharded_k1, sharded_k2 = sharded_phase(
        tcfg, scene, single, (*serve_k2[:3], W, H, serve_k2[10]),
        (rows, ids, bounds, W, H, kept[10]), dev, drivers_psnr, prev_offset)
    del kept, rows, ids, bounds, serve_k2, scene

    # ---- 6d. the sharded path's harnesses: growth_parity, scaling ----
    begin("growth_parity")
    growth_phase()
    begin("scaling")
    scaling_k1, scaling_k2 = scaling_phase(dev)

    # ---- 7. K3 timed against torch.cumsum and its byte bound ----
    begin("k3_bound")
    scan.launches = 0
    k3_prev = prev["k3"] if prev else None
    k3_times = dict(
        tile_counts=time_k3(tile_counts, k3_prev),
        packed_grad=time_k3(torch.randn(
            (16, 1 << 20), generator=torch.Generator(dev).manual_seed(13),
            device=dev), k3_prev))
    k3_bound_launches = scan.launches
    for name, res in k3_times.items():
        emit(phase="k3_bound", case=name, **res,
             share_of_bound=res["bound_ms"] / res["k3_ms"],
             no_slower_than_library=res["k3_ms"] <= res["library_ms"])
    k3_main = k3_times["tile_counts"]

    # ---- 8. the kernel labs: K4's stages of K1, K5 and K6 ----
    begin("kernel_labs")
    lab_kernels = kernel_labs(dev, k4_err, k56_err, old_k4)

    # ---- 9. kernels line, card line, result ----
    begin("result")
    def contract_label(bound):        # the kernels line says bytes or ops
        return "bytes" if bound["bound_by"] == "bytes" else "operations"

    kernels = [
        dict(name="blend_forward", route="cuda",
             source="contextgs_tpu_torch/ops/rasterize/csrc/blend_forward.cu",
             replaces="contextgs_tpu/ops/rasterize/tile_kernel.py:317",
             launches=(k1_launches + train_k1 + viewer_k1 + codec_k1
                       + sum(drivers_k1.values())
                       + sum(sharded_k1.values()) + scaling_k1
                       + sum(raster_k1.values())),
             launches_by_path=dict(serve=k1_launches, train=train_k1,
                                   viewer=viewer_k1, codec=codec_k1,
                                   **drivers_k1, **sharded_k1,
                                   scaling_bench=scaling_k1, **raster_k1),
             max_abs_err=k1_res["max_abs"], ms=k1_ms, plain_ms=plain_ms,
             bound_ms=k1_bound["bound_ms"],
             bound_by=contract_label(k1_bound),
             bound_term=k1_bound["bound_by"], library_ms=None,
             bound_walked_ms=k1_bound["bound_walked_ms"],
             train_ms=k1_train_ms, train_bound_ms=k1_train_bound["bound_ms"],
             train_bound_by=contract_label(k1_train_bound),
             train_bound_walked_ms=k1_train_bound["bound_walked_ms"],
             geometry=geometry,
             k4_v4_ms={case: t["v4_ms"]
                              for case, t in k1_turns.items()},
             other_geometries_kernel_ms={
                 case: {n: g["ms"] for n, g in t["geometries"].items()}
                 for case, t in k1_turns.items()}),
        dict(name="blend_backward", route="cuda",
             source="contextgs_tpu_torch/ops/rasterize/csrc/blend_backward.cu",
             replaces="contextgs_tpu/ops/rasterize/tile_kernel.py:548",
             launches=(train_k2 + sum(drivers_k2.values())
                       + sum(sharded_k2.values()) + scaling_k2
                       + sum(raster_k2.values())),
             launches_by_path=dict(train=train_k2, **drivers_k2,
                                   **sharded_k2, scaling_bench=scaling_k2,
                                   **raster_k2),
             max_abs_err=k2_res["max_abs"], ms=k2_ms, plain_ms=k2_plain_ms,
             bound_ms=k2_bound["bound_ms"],
             bound_by=contract_label(k2_bound),
             bound_term=k2_bound["bound_by"], library_ms=None,
             bound_walked_ms=k2_bound["bound_walked_ms"],
             k2_prev_ms=k2_turns.get("train_last_step_1280x720", {}).get(
                 "prev_ms"), serve_ms=k2_serve_ms,
             serve_bound_ms=k2_serve_bound["bound_ms"],
             serve_k2_prev_ms=k2_turns.get("serve_100k_1280x720", {}).get(
                 "prev_ms")),
        dict(name="lane_cumsum", route="cuda",
             source="contextgs_tpu_torch/ops/csrc/scan.cu",
             replaces="contextgs_tpu/ops/scan.py:61",
             launches=k3_serve + k3_train,
             launches_by_path=dict(serve=k3_serve, train=k3_train,
                                   k3_check=k3_check_launches,
                                   k3_bound=k3_bound_launches),
             max_abs_err=k3_err, ms=k3_main["k3_ms"],
             plain_ms=k3_main["plain_ms"], bound_ms=k3_main["bound_ms"],
             bound_by="bytes", bound_term="bytes",
             library_ms=k3_main["library_ms"],
             device_ms=k3_main["k3_device_ms"],
             library_device_ms=k3_main["library_device_ms"],
             shape=k3_main["shape"], dtype=k3_main["dtype"],
             k3_prev_ms=k3_main.get("k3_prev_ms"),
             packed_grad_ms=k3_times["packed_grad"]["k3_ms"],
             packed_grad_k3_prev_ms=k3_times["packed_grad"].get(
                 "k3_prev_ms"))]
    kernels.append(dict(
        name="projection", route="cuda",
        source="contextgs_tpu_torch/ops/rasterize/csrc/projection.cu",
        replaces=None,
        replaces_xla=("contextgs_tpu/ops/rasterize/projection.py::"
                      "project_gaussians, visible_filter"),
        launches=sum(proj_serve.values()) + sum(proj_train.values()),
        launches_by_path=dict(**proj_serve, **proj_train),
        max_abs_err=0.0 if proj_serve_res["means2d_bit_equal"] else None,
        ms=proj_serve_res["ms"], card_ms=proj_serve_res["card_ms"],
        plain_ms=proj_serve_res["plain_ms"],
        bound_ms=proj_serve_res["bound_ms"], bound_by="bytes",
        bound_term="bytes", library_ms=None,
        n_gaussians=proj_serve_res["n_gaussians"],
        cull_ms=proj_serve_res["cull_ms"],
        cull_card_ms=proj_serve_res["cull_card_ms"],
        cull_plain_ms=proj_serve_res["cull_plain_ms"],
        cull_bound_ms=proj_serve_res["cull_bound_ms"],
        n_anchors=proj_serve_res["n_anchors"],
        train_ms=proj_train_res["ms"],
        train_plain_ms=proj_train_res["plain_ms"],
        train_bound_ms=proj_train_res["bound_ms"],
        backward_ms=proj_train_res["backward_ms"],
        backward_card_ms=proj_train_res["backward_card_ms"],
        backward_bound_ms=proj_train_res["backward_bound_ms"],
        fwd_bwd_ms=proj_train_res["fwd_bwd_ms"],
        fwd_bwd_plain_ms=proj_train_res["fwd_bwd_plain_ms"],
        train_n_gaussians=proj_train_res["n_gaussians"],
        shape="the serve orbit's last view; the last training step"))
    kernels.append(dict(
        name="binning", route="cuda",
        source="contextgs_tpu_torch/ops/rasterize/csrc/binning.cu",
        replaces=None,
        replaces_xla="contextgs_tpu/ops/rasterize/sorting.py::expand_and_sort",
        launches=bin_serve + bin_train + bin_serve_res["launches"]
        + bin_train_res["launches"],
        launches_by_path=dict(serve=bin_serve, train=bin_train,
                              check=bin_serve_res["launches"]
                              + bin_train_res["launches"]),
        max_abs_err=0.0 if all(bin_serve_res["equal"].values()) else None,
        ms=bin_serve_res["kernel"]["events_ms"],
        card_ms=bin_serve_res["kernel"]["device_ms"],
        plain_ms=bin_serve_res["chain"]["events_ms"],
        plain_device_ms=bin_serve_res["chain"]["device_ms"],
        bound_ms=bin_serve_res["bound_ms"], bound_by="bytes",
        bound_term="bytes", library_ms=None,
        wrapper_ms=bin_serve_res["kernel"]["host_ms"],
        kernels_a_call=bin_serve_res["kernel"]["kernels"],
        plain_kernels_a_call=bin_serve_res["chain"]["kernels"],
        instances=bin_serve_res["instances"],
        n_gaussians=bin_serve_res["n_gaussians"],
        train_ms=bin_train_res["kernel"]["events_ms"],
        train_card_ms=bin_train_res["kernel"]["device_ms"],
        train_plain_ms=bin_train_res["chain"]["events_ms"],
        train_bound_ms=bin_train_res["bound_ms"],
        train_instances=bin_train_res["instances"],
        shape="the serve orbit's last view; the last training step"))
    kernels.append(dict(
        name="adam", route="cuda",
        source="contextgs_tpu_torch/train/csrc/adam.cu", replaces=None,
        replaces_xla="contextgs_tpu/train/optim.py::adam_update",
        launches=adam_train + adam_res["launches"],
        launches_by_path=dict(train=adam_train, check=adam_res["launches"]),
        max_abs_err=0.0 if adam_res["differ"] == 0 else None,
        ms=adam_res["kernel"]["device_ms"],
        card_ms=adam_res["kernel"]["device_ms"],
        plain_ms=adam_res["chain"]["events_ms"], bound_ms=adam_res["bound_ms"],
        bound_by="bytes", bound_term="bytes",
        library_ms=adam_res["foreach"]["events_ms"],
        wrapper_ms=adam_res["kernel"]["host_ms"],
        elements=adam_res["elements"], shape="the last training step's leaves"))
    kernels.append(dict(
        name="cdf_rows", route="cuda",
        source="contextgs_tpu_torch/compression/csrc/cdf_rows.cu",
        replaces=None,
        replaces_host=("contextgs_tpu/compression/codec.py::"
                       "_windowed_cdf_rows + compression/coder.py::"
                       "quantize_cdf"),
        launches=sum(cdf["launches_by_path"].values()),
        launches_by_path=cdf["launches_by_path"],
        max_abs_err=0.0, u16_differ=cdf["u16_differ"], f64_differ=cdf["f64_differ"],
        ms=cdf["ms"], plain_ms=cdf["plain_ms"], bound_ms=cdf["bound_ms"],
        bound_by="bytes" if cdf["bound_by"] == "bytes" else "operations",
        bound_term=cdf["bound_by"], library_ms=None,
        wrapper_ms=cdf["wrapper_ms"], calls=cdf["calls"],
        symbols=cdf["symbols"], shape="the first codec encode's calls"))
    carry_main = carry_res["round_26.4M"]
    kernels.append(dict(
        name="carry", route="cuda",
        source="contextgs_tpu_torch/ops/csrc/carry.cu", replaces=None,
        replaces_xla="contextgs_tpu/models/levels.py::segmented_carry",
        launches=carry_train + carry_check_launches,
        launches_by_path=dict(train=carry_train, check=carry_check_launches),
        max_abs_err=0.0,
        ms=carry_main["kernel"]["events_ms"],
        card_ms=carry_main["device_ms_a_launch"],
        plain_ms=carry_main["chain"]["events_ms"],
        plain_device_ms=carry_main["chain"]["device_ms"],
        bound_ms=carry_main["bound_ms"], bound_by="bytes",
        bound_term="bytes", library_ms=None,
        wrapper_ms=carry_main["kernel"]["host_ms"],
        level_map_card_ms=carry_res["level_map_2.4M"]["device_ms_a_launch"],
        level_map_plain_ms=carry_res["level_map_2.4M"]["chain"]["events_ms"],
        shape="a densify round's 26.4M keys at the city's size"))
    kernels += lab_kernels
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run() -> int:
    """main(); where it raises (a failed check included), one JSON line
    names the phase it was in and the message, and the exit code is 1."""
    try:
        return main()
    except Exception as exc:     # the script's boundary: report, then fail
        traceback.print_exc()
        emit(phase="failed", failed_in=PROGRESS["phase"],
             last_printed=PROGRESS["last_printed"],
             error=f"{type(exc).__name__}: {exc}")
        return 1


if __name__ == "__main__":
    sys.exit(run())

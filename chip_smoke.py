#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (it never
runs on the CPU: without a card it exits non-zero before printing any
result). Phases, each printing lines tagged with the card's name and power
limit:

1. device: the card, `nvidia-smi` name and power limit, TF32 off;
2. build: `nvcc` builds `mst_tpu_torch/csrc/*.cu` (timed); `-Xptxas -v`
   for the kernels of `ln_gemm.cu`, `gemm_dgrad.cu` (with `ln_pullback`),
   `ln_gemm_i8.cu`, `gemm_i8_residual.cu`, `quant_rows.cu`, `gemm_wgrad.cu`,
   `gemm_residual.cu`, `mhsa.cu`, `mhsa_bwd.cu`, `flash_fwd.cu`,
   `flash_sal.cu` and
   `flash_bwd.cu` (registers, no spills, no "wgmma serialized" line; a
   source compiled on its own for
   the log where the library was built before the run), their wgmma / TMA
   instructions in the SASS (`cuobjdump`: HGMMA, UTMALDG; no WMMA /
   mma.sync HMMA left in `gemm_dgrad` / `gemm_wgrad` / `gemm_residual` /
   `gemm_dls` / `mhsa_bwd` / the flash kernels, HMMA in `mhsa` only in its
   one-pass instances' mma.sync P.V; the int8 GEMMs of `ln_gemm_i8` and
   `gemm_i8_residual` on the int8 wgmma, IGMMA with UTMALDG and no IMMA;
   `quant_rows` on bulk copies, UBLKCP or UTMALDG),
   `fused_block.ln_gemm_launch` (at the card's SM count),
   `gemm_dgrad_launch`, `gemm_wgrad_launch`, `gemm_residual_launch`,
   `ln_pullback_launch`, `fused_int8.ln_gemm_i8_launch`, `mhsa_launch` and
   `attention.flash_launch` against the kernels' own launch geometry
   (`mst_gemm_geometry`, `mst_dgrad_geometry`, `mst_wgrad_geometry`,
   `mst_residual_geometry`, `mst_ln_pullback_geometry`,
   `mst_gemm_i8_geometry`, `mst_mhsa_geometry`, `mst_mhsa_bwd_geometry`,
   `mst_flash_geometry`),
   and the layout probes of `gemm_wgrad.cu` and `ln_gemm_i8.cu`: a bare
   product with B K-major (dgrad's) and with A MN-major (wgrad's) against
   `torch.matmul`, and an int8 one with both operands K-major against the
   exact integer product, each beside a planted instance with its leading
   and stride byte offsets swapped that must fail;
3. kernels: each hand-written kernel and each fused sub-layer against its
   plain PyTorch version at the ViT-S path shapes ([256, 257, 384] bf16,
   6 heads, O(1) LayerScale, tanh and erf GELU);
4. forward: MST-DINOv2 ViT-S/14 on [8, 1, 32, 224, 224], built as
   `python -m mst_tpu_torch.serve --params_npz` builds it from seeded
   random weights (`build_model`): kernel path vs plain path (with and
   without a key-padding mask), launch counts per forward;
5. server: `build_server` (`BatchingPredictor` + `serve_http` on
   127.0.0.1) answers concurrent POSTs (a padded tail batch included) and
   `/healthz`; the kernel launch counts are read around this run;
6. times: kernels vs plain versions (CUDA events, median; the attention
   core's in phase 43), end-to-end vol/s at B=8, peak device memory;
7. train kernels: each kernel of the train step (the residual-saving modes
   of `ln_gemm` and `mhsa`, `gemm_dls`, `gemm_wgrad`, `gemm_dgrad`,
   `mhsa_bwd`, with `ln_pullback` after `gemm_dgrad`'s f32 product) and
   each train sub-layer's forward residuals and backward outputs against
   their plain versions at the path shapes, each kernel twice for the same
   bits;
8. train step: ViT-S/14 at B=8 built by `python -m mst_tpu_torch.train`'s
   own builders from seeded weights with O(1) LayerScale; loss and every
   parameter's grad on the kernels vs the same step on the plain train
   sub-layers, launch counts per step, then K AdamW steps on one batch on
   both paths (the loss must fall, and the paths must agree);
9. trainer: `Trainer.fit` for 2 epochs on LIDC-shaped Synthetic data; the
   run folder's files (`last` among them, its write timed); the best
   checkpoint served by
   `python -m mst_tpu_torch.serve`'s `build_model` gives the eval step's
   probs;
10. train times: the train kernels vs their plain versions (the backward
   GEMMs in phase 41, `mhsa` / `mhsa_bwd` in phase 43), the train step on the kernels and on the plain
   sub-layers (ms, vol/s), its peak
   memory, and a `torch.profiler` breakdown of one step;
11. saliency kernels: the CLS-row, rollout-carry (two chained blocks, so
   that a carry that is not one-hot is fed back) and Abnar-factor outputs
   of `mhsa`, and their sub-layers, against their plain versions at the
   path shapes, each run twice for the same bits;
12. saliency forward: `fused_mst_saliency` at B=8 in the plane modes
   `last`, `rollout` and `rollout_abnar`, with and without a key-padding
   mask, against the plain path and an f32 plain forward, launch counts
   per forward, and the `MST_NO_CHEAP_LAST` row against the cheap one;
13. predict CLI: `python -m mst_tpu_torch.predict`'s `main` with
   `--use_tta --use_rollout --save_saliency` on phase 9's run folder and
   LIDC-shaped Synthetic test volumes; `results.csv` and the NIfTI volumes
   against the predictor;
14. saliency times: the saliency sub-layers vs their plain versions (the
   saliency forms of `mhsa` in phase 43), vol/s per plane mode at B=8 against the forward without
   saliency, the per-volume latency of batch-1 TTA with saliency, peak
   memory, and a `torch.profiler` breakdown of each mode's forward.

Phases 15-20 drive MST-DINOv3 ViT-S/16 (4 registers, 2D RoPE, LN eps 1e-5;
S = 201 at 224 px) on the same volumes:

15. RoPE kernels: the RoPE forms of `mhsa` (o and LSE, CLS row, rollout
   carry over two chained blocks, Abnar factor) and `mhsa_bwd`, the RoPE
   sub-layers and the RoPE train sub-layer against their plain versions at
   [256, 201, 384], each run twice for the same bits;
16. forward: `dino_v3_classifier_slice` at B=8 from seeded weights, kernel
   path vs plain path and an f32 plain forward, with and without a mask,
   launch counts per forward;
17. saliency: the three plane modes and `MST_NO_CHEAP_LAST`, as phase 12;
18. train step: built by `python -m mst_tpu_torch.train --model
   DinoV3ClassifierSlice`'s builders; loss and grads vs the plain
   sub-layers and the f32 step pooled over 4 batches, launch counts, AdamW
   steps on one batch;
19. CLI: that trainer's one-epoch run folder, served by `python -m
   mst_tpu_torch.serve --run_folder` (probs equal to the eval step's) and
   scored by `python -m mst_tpu_torch.predict --use_tta --use_rollout
   --save_saliency`;
20. times: the RoPE sub-layers and the other kernels of the RoPE chains at
   S = 201 against their plain versions and library yardsticks (the
   backward GEMMs in phase 41, the RoPE forms of `mhsa` / `mhsa_bwd` in
   phase 43), so that each chain's time, bound and library cover the
   same work; B=8
   vol/s of serving and each plane mode, the train step, peak memory, a
   `torch.profiler` breakdown of a forward and a step.

Phases 21-25 drive MST-DINOv2-giant2 (E 1536, 40 blocks, 24 heads, SwiGLU
FFN with F = 4096; S = 257), built by `python -m mst_tpu_torch.train
--model_size giant2 --freeze`'s build functions from one seeded draw of its
1.14 B parameters:

21. kernels: `ln_gemm_swiglu` (LN + w12 + SiLU gate), `gemm_residual` at
   K = 4096, `ln_gemm`, `mhsa` at 24 heads, and the SwiGLU and attention
   sub-layers at E = 1536 against their plain versions at the B=8 path
   shape [256, 257, 1536], each run twice for the same bits;
22. forward: kernel path vs plain path and an f32 plain forward at B=4,
   with and without a mask, launch counts per forward;
23. saliency: the three plane modes and `MST_NO_CHEAP_LAST` at B=4, as
   phase 12;
24. frozen training: the B=8 step's loss and every trainable grad vs the
   plain path and the f64 step pooled over 4 batches (the loss: the kernel
   path's distance from the f64 loss at most 1.5x the plain path's), a
   planted fault the loss rule must see, no backward kernel launched; FIT_STEPS AdamW steps leave every encoder parameter bit for
   bit as it was; then the CLI's `train` -> run folder -> `serve
   --run_folder` -> `predict --use_tta --use_rollout --save_saliency`;
25. times: the SwiGLU and E = 1536 attention kernels (`mhsa` in phase
   43) and chains at the B=8 path shape against their plain versions, bounds and library calls;
   B=8 vol/s of serving, each plane mode and the frozen train step, peak
   memory, a `torch.profiler` breakdown of a forward.

Phases 26-30 drive unfrozen encoder training at the widths the reference
fine-tunes: DINOv2 ViT-B/14 (E 768, 12 heads), ViT-L/14 (E 1024, 16 heads,
24 blocks) and giant2 with `--remat`:

26. kernels: queue B row 6 (`ln_gemm_swiglu`'s train mode: h, h12 and the
   gate of the rounded h12), `gemm_dgrad`'s SiLU-gate epilogue, the LN
   pullback at K = 768, 1024 and 1536 (the GEMM's f32 dh, then
   `ln_pullback`), the rest of the SwiGLU backward chain, the SwiGLU train
   sub-layer and the attention and MLP train sub-layers at E = 768 / 1024
   (attention also at 1536) against their plain versions at the B=8 path
   shapes [256, 257, E], each run twice for the same bits; C1: `mhsa_abnar`
   with and without RoPE at S = 442 (ViT-S/14 on 294 px slices, the
   two-pass forward) and the `rollout_abnar` saliency forward there vs
   plain;
   then the times of row 6's kernels and chain and those sub-layers
   against their plain versions, bounds and library calls (timed here, so
   that the steps after have the room of their inputs; the backward GEMMs
   are timed in phase 41);
27. the unfrozen ViT-B and ViT-L steps at B=8, built by the train CLI's
   builders: loss and grads vs the plain sub-layers and the f64 oracle
   (the plain step in f64), pooled over 4 batches, launch counts, AdamW
   steps on one batch;
28. the unfrozen giant2 step with remat from phase 22's draw: the same
   checks at B=2 with a planted SwiGLU fault (the loss held by phase
   24's rule), launch counts with each
   block's forward run twice, the B=8 step and its peak memory;
29. `train --model_size giant2 --remat` for one epoch -> run folder ->
   `serve --run_folder` gives the eval step's probs;
30. times: the B=8 steps of ViT-B, ViT-L and giant2 (remat): ms, vol/s,
   peak memory, a `torch.profiler` breakdown of each.

Phases 31-33 drive W8A8 int8 serving (queue B rows 9-11, `serve --int8`
and `predict --int8 [--int8_calib N]`):

31. int8 kernels: `ln_gemm_i8` in each epilogue mode (bf16 qkv, f32 GELU,
   static int8 GELU; the gated `ln_gemm_i8_swiglu` in f32 and int8),
   dynamic and static, its LN half `ln_quant_rows` (codes and row scales),
   `quant_rows` on the bf16 attention output and the
   f32 hidden, `gemm_i8_residual` with and without LayerScale, and the int8
   attention sub-layer in its plain, CLS-row, rollout-carry (two chained
   blocks), Abnar and RoPE forms, the int8 MLP and SwiGLU sub-layers, at
   [256, 257, 384] ([256, 201, 384] for RoPE; [256, 257, 1536] with
   F = 4096 for the SwiGLU and an E = 1536 attention), against their plain
   versions, each run twice for the same bits;
32. ViT-S/14 int8 at B=8, phase 4's weights quantized by `serve --int8`'s
   `build_model`, dynamic and static (calibrated on 8 volumes of the
   generator of the checked ones): kernel path vs the plain int8 path and
   vs the bf16 kernel path (probs, argmax), launch counts, the three
   saliency modes (the kernel path's distance from the plain int8 path in
   f64 at most 1.5x the bf16 plain path's, with a planted fault that must
   break it); `serve --int8 [--int8_calib 8] --run_folder` on
   phase 9's run folder answers a POST, and its model (static: calibrated
   on the run's val split) holds the same bar against the run's bf16 model
   on the run's test split; `predict --int8 --int8_calib 4 --use_tta
   --use_rollout` writes results.csv;
33. giant2 int8: phase 28's unfrozen giant2 quantized on the card, its B=4
   forward vs its bf16 kernel path, launch counts; then the int8 kernels'
   and chains' times against their plain versions, bounds and library
   calls (`torch._int_mm` between the same LN, quantization and
   dequantization in torch ops; the two int8 products are timed in phases
   45 and 46, `quant_rows` in phase 47), B=8 vol/s of ViT-S dynamic and static and of giant2 beside
   the bf16 path, peak memory, `torch.profiler` tables. Phase 32 holds the
   int8 kernel path's saliency to the oracle rule with each distance
   pooled over the batch's volumes (ROADMAP C5).

Phases 34-37 drive slices above 512 tokens (queue B rows 12-16), which
take the composed path (`DinoSliceClassifier.forward`: every block in
full, plain products, the flash kernels): 518 px ViT-S/14 slices, S =
1370; 560 px, S = 1601; DINOv3 ViT-S/16 at 512 px, S = 1029:

34. kernels: `flash_fwd` with and without the LSE at the B=8 serving shape
   [256, 6, 1370, 64] (the head views of a packed qkv), and with
   `flash_bwd_dq` / `flash_bwd_dkv` (dq, delta, dk, dv) at the B=2 step
   shape [64, 6, 1370, 64], S = 1601, a ragged S = 77, DINOv3's S = 1029
   (RoPE'd contiguous q, k beside a viewed v) and 12 / 16 / 24 heads at S
   = 1370, against their plain versions (run FLASH_CHUNK slices at a time),
   each twice for the same bits; planted faults (a wrong sm_scale, a stale
   ring stage, query rows past S from the next slice with their LSE left
   at 0) that must break the limits; each kernel first in a fresh host
   thread; C3: `mhsa`'s two-pass forward with the LSE and `mhsa_bwd` at
   [64, 442, 384];
35. serving: phase 4's ViT-S/14 on [8, 1, 32, 518, 518] against the plain
   composed path (with and without a mask) and an f32 plain forward, 12
   `flash_fwd` and no other launch per forward; the HTTP server on
   concurrent 518 px POSTs (a padded tail batch included); a batch-1 TTA
   forward; one [1, 1, 32, 560, 560] forward; DINOv3 at [2, 1, 32, 512,
   512] (RoPE in torch ops); `serve --int8` answering a 518 px POST with
   HTTP 400;
36. training: the train CLI's ViT-S/14 at [2, 1, 32, 518, 518]: loss and
   grads against the plain composed step and the f64 oracle pooled over 4
   batches, with a planted fault (every head reading the next head's keys
   and values) that the loss limit must see; the same step with remat (the same loss and grads, 24
   forward launches) and frozen (forward launches only); a B=1 step at 560
   px; AdamW steps on one batch on both paths;
37. times: 518 px vol/s at B=8 and the B=2 train step, peak memory,
   `torch.profiler` tables of both (the flash kernels' own times: phase
   44).

Phases 38-39 drive the port's counterparts of the `tools/` experiments
(queue B rows 17-21, `python -m mst_tpu_torch.tools.<name>`), at the
tools' own shapes:

38. kernels and chains: each experiment's chain (row 18: the five softmax
   forms, 12 layers at [128, 257, 384]; row 21: 12 base and 12 split-CLS
   cores; row 19: the three int8 variants, 24 damped layers at ViT-S,
   DINOv3-S and giant2 shapes; row 20's bf16 production chain; row 17: 12
   blocks split and fused) with its launch counts read around a run in
   which every launch is held to its plain version on that launch's own
   inputs, again for the same bits, and against the plain chain (printed:
   it compounds over the layers); variant D and `mhsa` each within the
   kernel limit of the same plain `mhsa`,
   variant E's bf16 probabilities within 1 bf16 ulp, row 20's variants
   against the plain f32-softmax mirror, one block of each row-17 layout
   against the tool's plain block, and a planted fault per kernel that must
   break its limit. First (`tools_attn_phase`), the cores of rows 18 and
   19, redesigned on TMA + wgmma with the scores in registers: each entry
   launched first in a fresh host thread (the same bits), every variant at
   TOOLS_S18 (A-E) and TOOLS_S19 (B, C; tool-range and narrow codes)
   within 2 bf16 ulps of its plain version and twice for the same bits, D
   bit for bit against `mhsa` at [128, 257] and [256, 201], C's P codes
   against the plain codes (differing only at .5 ties); then
   (`tools_rest_phase`) row 21's split-CLS core and row 17's `block_tail`,
   redesigned on TMA + wgmma: each first in a fresh host thread (the same
   bits), the split core at every S = 1 + P, P = 64 .. 384, and
   `block_tail` at M = 32,896, 771 and 1, within 2 bf16 ulps of plain and
   twice for the same bits;
39. times: each tool's `main()` (the experiment's own timings), then each
   new kernel against its plain version, bound and library call (SDPA for
   the attention cores, LN + matmul + GELU for `block_tail`; the cores of
   rows 18, 19 and 21 and `block_tail` beside the WMMA kernels' recorded
   times, `WMMA_TOOLS_MS`, and replayed from a CUDA graph, kernel and
   library alike; row 19's also at DINOv3's S = 201 and giant2's shape),
   and the chains' plain, bound and library times.

Phase 40 holds the Hopper form of `ln_gemm` / `ln_gemm_swiglu` (`ln_rows`,
then a TMA + wgmma GEMM on the normalised rows) on its own: `ln_rows` and
both kernels in every mode (act none / GELU tanh / GELU erf, train, gated,
gated train) at K = 384, 768, 1024, 1536 with their path widths (N = 3E,
4E; 2F = 8192) at the B=8 rows and at a ragged M = 771 and M = 1, within 2
bf16 ulps of plain (h within 1), twice for the same bits; a planted fault
per kernel (statistics from the neighbouring row, a stale ring stage, the
gated h2 panel one column over) that must break its limit; then the times
at the path shapes beside the WMMA kernels' recorded times: the chain, each
kernel alone and the library calls taken in turn over 10 rounds of 10
calls per pair of CUDA events, with the SM clock and power draw sampled
meanwhile. Every launch count check of the earlier phases also holds
`ln_rows` to one launch per `ln_gemm` / `ln_gemm_swiglu` call
(`check_launches`).

Phase 41 holds `gemm_dgrad` and `gemm_wgrad` on the wgmma GEMM the same
way: every dgrad epilogue (plain, GELU' tanh / erf, the SiLU gate, f32 dh
then `ln_pullback` at K = 384, 768, 1024, 1536) and every wgrad product of
the paths at M = 65,792 (B=8), 51,456 (DINOv3 B=8), 16,448 (giant2 B=2),
8,224 (B=1) and 771, against plain under phase 7's limits, twice for the
same bits; then each product at its path shape beside the WMMA kernel's
recorded time, timed in turn with the library calls for the same work
(the product plus the GELU' product, the gate's derivative or the LN
pullback in torch ops, and the column sums for db), with the SM clock.

Phase 42 holds `gemm_residual` and `gemm_dls`, now on the same mainloop
(x or g read into the staging tile by `cp.async` while the product runs;
dls summed per 64 rows in a fixed order, then `sum_partials`), the same
way: each of `gemm_residual`'s four kernels (the residual with and without
LayerScale, the product alone with and without it) and `gemm_dls` at
every (K, N) of the paths (proj and fc2 of ViT-S / B / L, giant2's proj
and w3) against plain under phase 3 / 7's limits, twice for the same bits,
ViT-S at M = 65,792, 51,456, 16,448, 8,224, 771 and 1, the wider widths at
16,448, 771 and 1 (one f32 plain product per shape, shared by the modes:
`shared_product`); three planted faults (x from the next 64-row slab, the
LayerScale one column over, dls with the rows past a ragged M unmasked)
that must break their limits; each TMA GEMM launched first in a fresh host
thread (the same bits: the thread has no current context until the
tensor-map encoding binds one); then each product at its path shape beside
the WMMA kernel's recorded time (`WMMA_RES_MS`), timed in turn with the
library calls for the same work (`residual_library`: `torch.addmm` then
`torch.addcmul`; `dls_library`: `addmm`, g * ls and the f32 column sums of
g * z), with the SM clock. The kernels line's library times of
`gemm_residual` / `gemm_dls` are those same-work calls; their errors are
the main path's readings of phases 3, 7, 15, 21 and 26.

Phase 43 holds `mhsa` and `mhsa_bwd`, redesigned on TMA + wgmma with the
scores in registers (a block walks the query, or key, tiles of a head with
the other operand resident; the forward in one pass up to S = 272, its P.V
by mma.sync, in two wgmma passes above), the same way: every form (plain,
LSE, CLS row, the rollout carry over two chained blocks, Abnar factor;
with RoPE at S = 201 and 442; `mhsa_bwd`'s dq with delta and dk / dv) at
6, 12, 16 and 24 heads at S = 257 (B=8: 256 slices), S = 201, a ragged
S = 77 and C3's 442 and 512 (64 slices), against plain under phase 3 /
7's limits, twice for the same bits; three planted faults (the LSE with
the neighbouring row's max, keys 64..127 from a stale chunk, V of the next
head in the backward) that must break their limits; each kernel launched
first in a fresh host thread (the same bits); then each form at its path
shape timed in turn with SDPA or its backward (with RoPE in torch ops
first; none for the CLS row, carry or Abnar factor) beside the WMMA
kernel's time (`WMMA_ATTN_MS`), with the SM clock (`attn_times`, which
reads only `fused_block`, so it times another tree's kernels as well). The
kernels line's attention times and library times are phase 43's; phases
6, 10, 14, 20 and 25 no longer time these kernels.

Phase 44 times the flash kernels, redesigned on TMA + wgmma (one block an
SM: a producer warpgroup streams 64-row K / V, or Q / dO, boxes through a
8-stage ring into two consumer warpgroups of 64 rows each, `setmaxnreg`;
phase 34 checks them): each kernel at its path shape (the B=8 518 px
forward, the B=2 step's forward with the LSE, dq, dk / dv and the pair,
560 px and DINOv3's 1029 tokens) timed in turn with SDPA or its backward,
beside the mma.sync kernel's time (`MMA_FLASH_MS`) and the SM clock, with
TFLOP/s of the function's work (the backward's five products; the pair's
seven executed products beside) (`flash_times`, which reads only
`attention`, so it times another tree's kernels as well). The kernels
line's flash times are phase 44's.

Phase 45 holds the redesigned `ln_pullback` (one pass over the rows, a
lane owning the same columns of every row, then one fixed-order pass over
the blocks' column sums) and `ln_gemm_i8` / `ln_gemm_i8_swiglu`
(`ln_quant_rows`, then the int8 TMA + wgmma GEMM on the K-major `q8t`)
the same way: the pullback at K = 384, 768, 1024, 1536 on the path rows
(65,792; DINOv3's 51,456 at 384; giant2's B=2 16,448 at 1536) and ragged
ones (771, 1) within phase 7's limits; every int8 first product, dynamic
and static (the identity codes of the qkv too), at ViT-S and giant2
widths within phase 31's, its GEMM also alone on the kernel's own codes;
each first in a fresh host thread, then again for the same bits; planted
faults (a neighbour row's rstd, the rows of one partial block dropped, a
neighbour row's scale, the h1 / h2 panels swapped) that must break their
limits; then the times at the path shapes, interleaved with the library
calls for the same work (`native_layer_norm_backward`; LN, quantization,
`torch._int_mm` and dequantization in torch ops), beside the replaced
kernels' times (`OLD_PB_MS`, `OLD_I8_MS`). The kernels line's times of
both are phase 45's (phases 26, 33 and 41 no longer time them).

Phase 46 holds the redesigned `gemm_i8_residual` (the int8 TMA + wgmma
mainloop on the codes and the K-major `q8t`, x read into the staging tile
by `cp.async` while the product runs, the dequantization, LayerScale and
residual rounded op by op) the same way: `gemm_i8_residual_launch` against
the kernel's `mst_i8_residual_geometry` at every K from 128 to 4096 on this
card's SM count; ViT-S proj / fc2 and giant2 proj / w3 at M = 65,792, 771
and 1, dynamic and static, with and without LayerScale, against
`_gemm_i8_residual_ref` with 0 difference, each first in a fresh host
thread, then again for the same bits; two planted faults (the second W box
64 rows further down, each row's scale from the row before) that must
break it; then the times at the path shapes interleaved with the library
call for the same function (`torch._int_mm`, dequantization, `addcmul`)
beside the WMMA kernel's times (`OLD_I8R_MS`), with the SM clock. The
kernels line's times of `gemm_i8_residual` are phase 46's (phase 33 no
longer times it).

Phase 47 holds the redesigned `quant_rows` (persistent blocks stage whole
rows in shared memory by 1D TMA bulk copies on an `mbarrier` ring and read
each row once: the amax from the staged copy, then the codes) the same way:
`quant_rows_launch` against the kernel's `mst_quant_rows_geometry` at the
path widths, a row of two stages and one wider than the ring, on this
card's SM count, 132 and 114; ViT-S o (bf16, K = 384) and u (f32, 1536),
giant2 o (bf16, 1536) and g (f32, 4096) and a row wider than a stage (f32,
9216) at M = 65,792, 771 and 1, a row wider than the ring (f32, 32,768) at
771 and 1, dynamic and static, against `_quant_rows_ref` with 0 difference
in codes and scales, each first in a fresh host thread, then again for the
same bits; two planted faults (a neighbour row's amax, a stale ring stage)
that must break it; then the times at the path shapes interleaved with the
library call (the same quantization in torch ops), with the bound's
share, TB/s and the SM clock, each beside the parent commit's time read
the same way (`OLD_QR_MS`); and, as an extra reading, its time per call
replayed from a CUDA graph (`graph_ms`). The kernels line's times of
`quant_rows` are phase 47's event times, as every other kernel's (phase 33
no longer times it); its entry also carries `graph_ms`.

Phase 48 drives the host data path (queue A #5; no kernel of its own):
`data/native_io` builds `native/`'s reader with g++ into `build/
mst_tpu_torch/` inside the phase, and every NIfTI of 16 LIDC cases (HU
crops [256, 256, 32] with a nodule and two raters, as
`scripts/preprocessing/lidc/step4_crop_or_pad.py` writes them) and 16
MRNet stacks (256 x 256, 20-44 slices, so that some are padded) reads the
same bits through it as through the numpy reader, and the committed DUKE
fixture through h5lite as its seeded arrays; each device op of the
augmentation (clamp, rescale, z-norm at (0.5, 99.5) and (0, 100), the
MRNet resize with its mask, rotation at three angles with its mask, flips,
inversion) on the card against the same function on the CPU in f64 at
fixed draws, each within its limit, and three planted faults (an angle off
by 1e-2, a flip axis swapped, the fill taken as 0) that must break theirs;
`train` at B=8 (ViT-S, one epoch) through the CLI's builders on the LIDC
and MRNet folders (launch counts as phase 8's, finite losses), MRNet's
`src_key_padding_mask` against the slice counts and its fused probs the
same bits when the padded slices' voxels change, `predict --save_saliency`
on the MRNet run folder (the NIfTI affine's diagonal is the spacing), one
DUKE eval batch at B=8, then the loader's host seconds per batch and the
B=8 train loop's vol/s and device idle share on the LIDC files and on
phase 9's in-memory Synthetic data.

Phase 49 drives the train CLI's remaining single-card options (queue A #4
and #5's rest; no kernel of its own) through its builders at ViT-S width
and B=8: the decoded-volume disk cache (`--decode_cache`) on phase 48's
LIDC and MRNet folders and the DUKE fixture (the host ms of one batch
decoded, first cached and read from the cache; the loader's and the
profiled train loop's vol/s and the device's idle share in a cold and a
warm epoch; the cache's files and bytes; the augmented batches of two
epochs with the cache equal to those without, bit for bit); `train
--dataset DUKE --decode_cache` for one epoch, then `predict --run_folder
--decode_cache`; `--resume`: two epochs against one epoch and `--resume`
for the second on LIDC-shaped Synthetic data under `--lr_schedule
warmup_cosine`, the `last` parameters, AdamW moments and steps equal bit
for bit, in the same run folder (were they not, two uninterrupted runs
would give the spread the resumed one is held to, with the arrays that
differ), the launches of phase 8's train kernels, the `--profile_dir`
trace of epoch 1 with its CUDA kernels; the rate of each step under
`cosine` and `warmup_cosine` read back against optax's formulas (the
first warmup step at rate 0 leaves the weights); `--pretrained_path
--freeze` from a seeded torch.hub DINOv2 ViT-S/14 state dict (grid 37)
and an HF DINOv3 ViT-S/16 one (4 registers, no pos-embed): the encoder
after one epoch equal to the converted state dict bit for bit, the
hparams' inferred config, the serving kernels launched and no backward
one, `serve --run_folder` giving the eval step's probs. Phases 9, 24 and
29 print the seconds and bytes of their `last` train-state write.

Phase 50 drives the CLIs' remaining single-card options (queue A #6, #12
and #11's rest; no kernel of its own) at ViT-S width and B=8: `train
--optimizer adafactor --accumulate_grad_batches 2` through the train
CLI's builders on LIDC-shaped Synthetic data, one window on the kernel
path and on the plain train sub-layers from the same weights (the
parameters bit for bit after each first micro-batch, the losses and the
window's mean grads within phase 8's limits, twice phase 8's launches, the
Adafactor state factored where optax factors, its bytes beside AdamW's
moments); `--resume` in the middle of an `--accumulate_grad_batches 3`
window against two uninterrupted epochs, bit for bit; phase 28's unfrozen
giant2 `--remat` model at B=8, one AdamW step and two Adafactor steps, each
with its peak device memory and state bytes; `train --freeze --int8
--int8_calib 8` for one epoch on phase 48's LIDC folder (the int8 kernels
launched, no bf16 encoder kernel and no backward one, the encoder in the
model and the best checkpoint equal to the seeded draw bit for bit, the
step's logits equal to the int8 serving forward of the same quantized
encoder, the int8 and bf16 frozen steps' rates and the int8 loop's vol/s
and idle share on the files); `predict --get_segmentation --save_saliency
--get_attention` on that run folder in the `last` (int8) and `rollout`
modes (results_seg.csv's Dice and IoU finite, the ASSD finite where the
mask has voxels, seg.nii.gz and the positives' PNGs read back, the ms a
case of the saliency forward, the metrics and the NIfTI and PNG writes)
and `--int8 --ensemble RUN RUN` (its results.csv within 1e-4 of the single
run's).

Phase 51 drives the last two model families of the registry (queue A #8,
#9; no kernel of its own) at B=8 on [8, 1, 32, 224, 224] volumes. The 3D
ResNet50 (`--model ResNet`) and MST-ResNet34 (`--model ResNetSliceTrans`),
built by the train CLI's builders from seeded weights: two AdamW steps on
Synthetic batches in bf16 against the same steps in f32 (TF32 off; the
losses and the flax-semantics BN running statistics), then the serving
forward and Grad-CAM++ saliency with the 8-flip TTA in one batch against
the f32 model (MST-ResNet with a key-padding mask: padded slices get no
map and move no probs), each with its readings, and the step's vol/s and
peak memory, the serving forward's and a Grad-CAM++ predict case's ms
(cuDNN's default heuristics, no autotuning). ViT-S/14 with the `average`,
`linear`, `RoPE` and `LiRE` slice fusions: the serving forward and the
`last` saliency on the fused kernels against the plain sub-layers (phase
4's and 12's limits and launch counts), and the unfrozen train step over 4
batches against plain and the f32 step as phase 18 holds DINOv3's, with
phase 8's launch counts. Then `train ->
predict --run_folder --use_tta --get_attention -> serve --run_folder` for
MST-ResNet34 and a `--rotary LiRE` ViT-S/14.

Phase 52 drives the serving artifacts (queue A #14; no kernel of its
own): `python -m mst_tpu_torch.export`'s `main` on phase 9's run folder
(ViT-S/14 bf16 at buckets 1 and 8; `rollout` saliency with the 8-flip TTA
at bucket 1; int8 dynamic and static, calibrated on the run's val split,
at bucket 8; 518 px slices at bucket 1, the composed path), and
`save_exported` of a seeded MST-DINOv3 ViT-S/16 at bucket 8 and of a
seeded 3D ResNet50 with BatchNorm statistics of its own, its Grad-CAM++
program with the TTA at bucket 1. Each loaded program's graph calls the
registered kernel ops (`torch.ops.mst_tpu_torch.*`) as many times as the
live forward launches their kernels, and no node where a sub-layer or the
composed attention core is called computes in aten ops (the node stack
traces); its probs and maps, uncaptured and replayed from its CUDA graph
twice, are the live model's bits, and the uncaptured call launches the
live forward's kernels. A fresh `python -X importtime -m
mst_tpu_torch.serve --exported` process (booting while the rest of the
phase runs) answers a POST with the live model's bits on the same padded
batch and imports no `mst_tpu_torch.models` and no JAX; the phase prints
the seconds from its start to that answer, asked as soon as it listened,
and of them those to its "ready" line and those of the POST. The bf16 and
int8 artifacts re-pointed at another seeded tree give a live model's bits
of that tree (every `q8t == q8.T`). Then, at ViT-S B=8 bf16 and int8
static, the median of 5 host-timed calls with their spread (and the
allocator's retries, the garbage collections and the other threads' CPU
seconds in them, beside the host's load): the live forward, the loaded
program without a graph, and the graph replay; and each artifact's files'
bytes.

Phase 53 drives saliency above 512 tokens (queue A #16) on the composed
path: `flash_fwd` keeps its LSE and one hand-written kernel per block
(csrc/flash_sal.cu, TMA + wgmma) rebuilds what the plane mode needs from
it and the same q, k; `rollout_abnar` keeps each block's q, k, LSE and row
normaliser (`flash_abnar`) and carries the CLS row back through the blocks
with one `flash_carry` a block, no factor and no [S, S] product made.
`attention.flash_sal_launch` against the kernels' own
`mst_flash_sal_geometry` at every S up to 2048 and the path shapes; the
CLS row (`flash_row`), the rollout carry over two chained blocks
(`flash_carry`, the second fed the first's carry) and the row normaliser
(`flash_abnar`) against their plain versions within 2e-5 of the largest
value, each twice for the same bits, at the B=8 518 px shape [256, 6,
1370, 64], DINOv3's S = 1029 with RoPE'd q, k and 24 heads at S = 1370,
with two planted faults per kernel that must break the limit (each row's
LSE from the row before; keys 64..127 read in reverse order, or for the
row normaliser, whose sums no key order changes, the keys past S
counted); `fused_mst_saliency` on 518 px ViT-S/14 volumes at B=8 and on
512 px DINOv3 ViT-S/16 ones at B=2 in the three plane modes, with and
without a key-padding mask, against the plain composed path and an f32
plain forward (phase 12's limits), its probs equal to the forward without
saliency, with each forward's launch counts (12 `flash_fwd` and 1
`flash_row`, 12 `flash_carry`, or 12 `flash_abnar` and 12 `flash_carry`);
the 518 px `--with_saliency` program of `mst_tpu_torch.export` in the
`rollout_abnar` mode at bucket 1, its graph's op nodes against the live
launches and its CUDA graph replays the live forward's bits; then each
kernel's time beside its plain version and bound, 518 px B=8 vol/s per
mode beside the forward without saliency, the batch-1 TTA latency, peak
memory per mode (`rollout_abnar` below 10 GiB above what is held, with no
tensor [.., S, S] made and no product of [S, S] operands in the forward,
as the ops it dispatches and the profiler's recorded shapes show) and a
`torch.profiler` table per mode.

Each phase prints its wall time. The line before the last is `{"kernels":
[...]}`: per kernel its launches on the main path, its largest error, its
time and its plain version's, the bound (the least time the card could
take for the same work) and the PyTorch library call's time where one
computes the same function; the last line is `{"ok": true, "device":
{...}}`. Any failed check raises (exit code != 0).
"""

from __future__ import annotations

import contextlib
import ctypes
import csv
import datetime
import functools
import gc
import gzip
import hashlib
import inspect
import io
import itertools
import json
import math
import shutil
import os
import re
import signal
import socket
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
N_SLICES, S, E, HEADS = 256, 257, 384, 6  # B=8 x D=32 slices, ViT-S/14
BATCH, DEPTH_SLICES, PX = 8, 32, 224
SEED = 0
# Limits on probabilities, each a few times the largest difference measured
# on an H100 with these seeded inputs (the readings are in PERF.md). Each
# phase also checks that the volumes' own probs lie further apart than its
# limit, so a row served from the wrong volume or slot cannot pass.
PROB_TOL = 0.01  # kernel path vs plain path, both bf16 (phase 4)
F32_TOL = 0.015  # bf16 kernel path vs f32 plain path (phase 4)
SERVE_TOL = 1e-3  # server rows vs one direct batch (phase 5)
# Train phases (7-10). Limits are a few times the largest reading on an
# H100 with these seeded inputs (the readings are in PERF.md). bf16
# outputs use the 2-ulp limit of phase 3; f32 grads a limit relative to
# the grad's largest magnitude, because their sums run in another order.
KERNEL_GRAD_REL = 2e-5  # one kernel's f32 outputs vs its plain version
SUBLAYER_GRAD_REL = 3e-3  # a sub-layer's f32 grads, kernel vs plain chain
# Phase 8: the B=8 step of a random-weight ViT-S with O(1) LayerScale in
# bf16 moves its grads by a few percent under any change of rounding, so
# both bf16 paths are also held against the same step in f32 (plain
# sub-layers): the kernel path must be as close to it as the plain path.
STEP_LOSS_TOL = 2e-3  # |loss kernel path - loss plain path|
STEP_GRAD_REL = 0.5  # a grad, kernel vs plain path, / its |plain|max
STEP_F32_RATIO = 1.5  # kernel path's error vs f32 / the plain path's
FIT_STEPS, FIT_LR = 8, 1e-4  # AdamW steps on one batch
FIT_DROP = 10.0  # the loss must fall by this factor over those steps
FIT_TRACK_TOL = 0.15  # |loss kernel - loss plain| at every one of them
# Phase 18 holds the DINOv3 step to the same limits pooled over
# STEP_BATCHES batches (the mean |loss| difference, the summed medians and
# maxima of the grads' errors vs f32; phase 8 reads one batch): on one
# batch the kernel / plain ratio of those errors falls on either side of 1
# from batch to batch (each batch's reading is printed), since bf16 noise
# decides which path lands nearer the f32 step.
STEP_BATCHES = 4
# Phase 24 holds the frozen giant2 step to phase 8's grad limits, pooled
# over STEP_BATCHES_G batches, and its loss as the grads are held: the
# kernel path's mean |loss - f64 loss| over the batches may be at most
# STEP_F32_RATIO times the plain path's. A limit on kernel vs plain alone
# cannot be set by a rule: the bf16 noise of 40 blocks moves the loss of
# either bf16 path ~0.01 from the f64 step, and any change of summation
# order moves it about as far (PERF.md §6, PR 10). On an H100 the rule read
# 0.91 (1.02 over the first four batches), and a planted fault (the SwiGLU
# gate off by one column) 19.7: every run must read the fault above the
# limit. The kernel-vs-plain distance is still printed. Four batches since
# PR 23 (eight before), to keep the run inside its limit with phase 51: over
# the first four of eight the rule read 0.73 and the fault 15x.
STEP_BATCHES_G = 4
# Unfrozen steps (phases 27-28) are held against the plain step in f64 (the
# oracle), pooled over STEP_BATCHES batches: ViT-B and ViT-L at B=8 to
# phase 8's limits; giant2 (with remat) at B=STEP_B_G, which keeps its f64
# oracle short, to the ratio limit STEP_F32_RATIO on its grads and on its
# loss (as phase 24) and to a limit of its own on the grads' kernel-vs-plain
# spread. At B=2 either bf16 path lies 0.028-0.031 from the f64 loss and up
# to 1.0 x |grad|max from the f64 grads of the fusion layer's linear1 (its
# ReLU flips between any two bf16 paths): on an H100 the kernel path's worst
# grad read 1.09 from plain, its loss 1.24 x the plain path's distance
# from f64, and the planted SwiGLU-gate fault 16.5 x (the readings are in
# PERF.md). FIT_STEPS_U AdamW steps at
# FIT_LR_U on one batch must lower the loss (at phase 8's 1e-4 ViT-L's
# loss oscillates: 0.93, 8.5, 0.33, 5.2).
STEP_B_G = 2
GIANT2_U_GRAD_REL = 2.0
FIT_STEPS_U, FIT_LR_U = 4, 1e-5
# Saliency phases (11-14). A saliency map is compared relative to its
# largest value; the limits are a few times the largest reading on an H100
# with these seeded inputs (the readings are in PERF.md).
SAL_REL = 0.05  # saliency, kernel path vs plain path, both bf16
SAL_F32_REL = 0.05  # saliency, bf16 kernel path vs f32 plain path
SAL_CHEAP_REL = 0.01  # saliency, MST_NO_CHEAP_LAST row vs the cheap row
# Phase 32 holds the int8 kernel path's saliency as phases 24 and 28 hold
# giant2's losses (ROADMAP C2, C5): against the oracle, the plain int8 path
# in f64, its distance at most SAL_I8_RATIO times the bf16 plain int8
# path's. A fixed limit on kernel vs plain could not be set: static int8
# codes move by whole steps wherever a bf16 rounding flips, and over six
# seeded weight draws the kernel-vs-plain distance of the `last` map read
# 0.036-0.088 (ROADMAP C5; PERF.md §6 records both rules' spread). The
# distance is pooled as C2 pools the losses over batches: each volume's
# max |saliency - oracle| relative to that volume's largest oracle value,
# averaged over the batch's volumes (the batch's single worst volume, the
# rule's first statistic, read the ratio 0.71-1.57 over six draws, one of
# 24 readings above the limit). A planted fault (each slice's saliency data
# from the neighbouring slice) must break the rule in every plane mode; the
# worst-volume ratio and the kernel-vs-plain distance are printed.
SAL_I8_RATIO = 1.5
PLANE_MODES = ("last", "rollout", "rollout_abnar")
N_CASES = 8  # Synthetic test volumes the predict CLI scores
# ... and those phase 13's `predict --save_saliency` writes as NIfTI (~3.7 s
# a case, gzip level 9): 4 since phase 52 came, 8 before, to keep the run
# inside its limit
N_CASES_SAL = 4
# DINOv3 phases (15-20): ViT-S/16, 4 registers, 14 x 14 patches at 224 px.
MODEL3 = "DinoV3ClassifierSlice"
S3, GRID3, PREFIX3, EPS3 = 201, (14, 14), 5, 1e-5
N_CASES3 = 2  # Synthetic test volumes its predict CLI run scores
# giant2 (phases 21-25): the fewest test volumes whose predict.log has an
# AUC (both classes)
N_CASES_G = 2
# Bounds: the H100 SXM's published dense bf16 and int8 tensor-core rates
# and HBM3 bandwidth (NVIDIA data sheet, at its 700 W limit).
PEAK_FLOPS, PEAK_INT8, PEAK_BYTES = 989e12, 1979e12, 3.35e12
# Int8 phases (31-33). A kernel's int8 codes may differ from its plain
# version's where an f32 LN or GELU, summed in another order, lands on the
# other side of a .5 tie: at most CODE_FRAC of them, each by one.
CODE_FRAC = 1e-4
# The int8 forward against the bf16 kernel path: the JAX suite's bar
# (tests/test_fused_int8.py:91-94), probs within I8_TOL, argmax agreeing on
# every volume whose bf16 probs lie further than I8_TOL from the class
# boundary (a move within the limit may cross it: on an H100 one of phase
# 32's volumes read 0.4954 in bf16 and 0.5061 in int8), and at least half
# of the volumes so far from it.
I8_TOL = 0.05
# The tools phases (38-39) hold `ln_gemm_i8`'s int8 qkv codes (the code
# output of its ACT_NONE mode, clip(round(qkv))) apart: each is a K-wide
# product of the LN codes, so one LN code at a .5 tie moves many codes of
# its row. On an H100 giant2's (K = 1536) read 1.08e-4 differing, by up to
# 2; ViT-S's 2.0e-5, by 1. Their limit lies a few times above; a planted
# unit scale 1% off must break it.
QKV_CODE_FRAC, QKV_CODE_STEP = 1e-3, 3
# Long-slice phases (34-37): the composed path above 512 tokens. 518 px
# ViT-S/14 slices give S = 1 + 37 x 37 = 1370 tokens, 560 px 1601 (above
# the Pallas whole-sequence limit of 1536), DINOv3 ViT-S/16 at 512 px
# 5 + 32 x 32 = 1029. The plain attention runs over FLASH_CHUNK slices at a
# time, so that its [chunk, heads, S, S] f32 scores bound its memory.
PX_LONG, PX_1601, PX3_LONG = 518, 560, 512
LONG_B = 2  # the train CLI's default --batch_size
FLASH_CHUNK = 16
# The 518 px step at B=2 is held to the plain composed step and the f64
# oracle pooled over STEP_BATCHES batches with phase 8's grad limits, but
# its loss to a limit of its own: the mean CE of two volumes moves further
# with bf16 noise than phase 8's mean of eight. On an H100 the kernel
# path's mean distance from the plain path read 0.0020 and 0.0029 over 4
# batches of two weight draws (largest batch 0.0023 and 0.0041), nearer
# the f64 loss than the plain path (0.0009 / 0.0017 against 0.0020 /
# 0.0046); a planted head-offset fault (every head reads the next head's
# keys and values) read 0.23 (smallest batch 0.11). The limit lies between;
# a fault of the softmax scale 25% off read only 0.0078 (smallest batch
# 0.0002), too weak to plant.
LONG_LOSS_TOL = 0.01
# Phase 40: `ln_rows` + the wgmma GEMM at the widths of ViT-S / B / L and
# giant2 (K = E), giant2's gate width, and two ragged row counts (3 x 257,
# and 1). The WMMA kernels' times (PERF.md §6, earlier runs on an H100
# 80GB HBM3 at 700 W), printed beside the new ones.
LN_GEMM_WIDTHS = (384, 768, 1024, 1536)
LN_GEMM_F = 4096
RAGGED_M = (771, 1)
# Phase 40's times: PAIR_ROUNDS rounds of PER_PAIR calls per pair of CUDA
# events (one call per pair let the order of the calls, and the card's
# state, move a reading by 5-25%). Six rounds since phase 52 came, ten
# before, to keep the run inside its limit; `time_ms` takes 10 calls (20
# before) for the same reason.
PAIR_ROUNDS, PER_PAIR = 6, 10
WMMA_MS = {"ln_gemm[qkv,E=1536]": 18.926, "ln_gemm_swiglu[w12]": 34.879,
           "ln_gemm_swiglu_train[w12]": 35.183, "ln_gemm[qkv]": 0.938,
           "ln_gemm[fc1,gelu_tanh]": 1.272}
# Phase 41: `gemm_dgrad` / `gemm_wgrad` at the path row counts: B=8 of
# 257 tokens, DINOv3's B=8 (S = 201), giant2's B=2, B=1 and 3 x 257. The
# WMMA kernels' times at the path shapes (PR 10's final run, PERF.md §6, on
# an H100 80GB HBM3 at 700 W), printed beside the new ones.
BWD_M = (65_792, 51_456, 16_448, 8_224, 771)
BWD_GEMMS = ("gemm_wgrad", "gemm_dgrad")
WMMA_BWD_MS = {
    "gemm_wgrad[proj]": 0.2504, "gemm_wgrad[qkv]": 0.6135,
    "gemm_wgrad[fc2]": 0.7603, "gemm_wgrad[fc1]": 0.7759,
    "gemm_dgrad[proj]": 0.1799, "gemm_dgrad[fc2,gelu_tanh]": 0.7696,
    "gemm_dgrad[fc2,gelu_erf]": 0.8265, "gemm_dgrad[qkv,ln]": 0.8126,
    "gemm_dgrad[fc1,ln]": 0.9556, "gemm_wgrad[proj,S=201]": 0.2634,
    "gemm_dgrad[proj,S=201]": 0.1766, "gemm_wgrad[qkv,S=201]": 0.5644,
    "gemm_dgrad[qkv,ln,S=201]": 0.7566, "gemm_wgrad[w3]": 6.7711,
    "gemm_dgrad_swiglu[w3]": 5.8107, "gemm_wgrad[w12]": 13.8015,
    "gemm_dgrad[w12,ln]": 11.2080, "gemm_dgrad[fc1,ln,E=768]": 2.4768,
    "gemm_dgrad[fc1,ln,E=1024]": 4.0803}
# Phase 42: `gemm_residual` / `gemm_dls` on the wgmma GEMM at the path row
# counts (RES_M: BWD_M and one row). The WMMA kernels' times at the path
# shapes (PERF.md §6: the mean of two readings by `residual_times` of the
# tree before the rewrite, on an H100 80GB HBM3 at 700 W), printed beside
# the new ones.
RES_M = BWD_M + (1,)
RES_GEMMS = ("gemm_residual", "gemm_dls")
# Phase 43 times every form of `mhsa` / `mhsa_bwd` (names that start so);
# the earlier phases check them but leave their times to it.
ATTN = ("mhsa",)
# Phase 45 times `ln_pullback` at every width (phases 26 and 41 check it).
PULLBACK = ("ln_pullback",)
WMMA_RES_MS = {"gemm_residual[proj,ls]": 0.1933, "gemm_dls[proj]": 0.2171,
    "gemm_residual[fc2,ls]": 0.5839, "gemm_dls[fc2]": 0.6227,
    "gemm_residual[proj,E=768,ls]": 0.6316, "gemm_dls[proj,E=768]": 0.6704,
    "gemm_residual[fc2,E=768,ls]": 2.1733, "gemm_dls[fc2,E=768]": 2.2330,
    "gemm_residual[proj,E=1024,ls]": 1.0684, "gemm_dls[proj,E=1024]": 1.1053,
    "gemm_residual[fc2,E=1024,ls]": 3.8703, "gemm_dls[fc2,E=1024]": 3.9402,
    "gemm_residual[proj,E=1536,ls]": 2.2914, "gemm_dls[proj,E=1536]": 2.3350,
    "gemm_residual[w3,ls]": 5.8576, "gemm_dls[w3]": 5.9022,
    "gemm_residual[proj,ls,S=201]": 0.1630, "gemm_dls[proj,S=201]": 0.1825}
T0 = time.perf_counter()


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def stamp(tag, phase: str) -> None:
    """Print the wall time since the start of the run at a phase's start."""
    print(f"{tag} phase {phase} starts at {time.perf_counter() - T0:.1f} s")


def mm_cost(m, k, n, extra=0):
    """(FLOPs, bytes) of a bf16 [m, k] @ [k, n] product that reads each
    operand once and writes a bf16 [m, n] result, plus `extra` bytes."""
    return 2 * m * k * n, 2 * (m * k + k * n + m * n) + extra


def wgrad_cost(m, k, n):
    """(FLOPs, bytes) of a [m, k]^T @ [m, n] weight grad to f32 [k, n] and
    its f32 column sums [n]."""
    return 2 * m * k * n, 2 * (m * k + m * n) + 4 * (k * n + n)


def residual_library(a, w, b, ls, x):
    """The library calls for `gemm_residual`'s work: torch.addmm with the
    bias, then x + ls * y (torch.addcmul), all in bf16."""
    bw, lw = b.to(a.dtype), ls.to(a.dtype)
    return lambda: torch.addcmul(x, torch.addmm(bw, a, w), lw)


def dls_library(a, w, b, ls, g):
    """The library calls for `gemm_dls`'s work: z = torch.addmm with the
    bias, g * ls, and the column sums of g * z in f32."""
    bw, lw = b.to(a.dtype), ls.to(a.dtype)

    def library():
        z = torch.addmm(bw, a, w)
        return g * lw, (g * z).sum(0, dtype=torch.float32)
    return library


def attn_cost(n, s, extra=0, bwd=False, heads=HEADS):
    """(FLOPs, bytes) of the attention core over n slices of s tokens and
    `heads` heads of 64: q.k^T and p.v per (slice, head) forward; the
    backward needs s, dp, dv, dq and dk (five products). Bytes: qkv in and
    o out (the backward also o, do and the LSE rows in, dqkv out), plus
    `extra`."""
    m, e = n * s, 64 * heads
    if bwd:
        return (10 * n * heads * s * s * 64,
                2 * (2 * m * 3 * e + 2 * m * e) + 4 * m * heads + extra)
    return 4 * n * heads * s * s * 64, 2 * (m * 3 * e + m * e) + extra


def i8_cost(m, k, n, a_bytes=1, out_bytes=2, extra=0):
    """(FLOPs, bytes, int8 operations) of an int8 [m, k] @ [k, n] product
    whose A arrives at `a_bytes` per element (codes 1, a bf16 row that the
    kernel normalises and quantizes itself 2), whose int8 W is read once and
    whose result leaves at `out_bytes` per element, plus `extra` bytes."""
    return 0, a_bytes * m * k + k * n + out_bytes * m * n + extra, 2 * m * k * n


def bound(costs):
    """(ms, "operations" | "bytes"): the least time the card could take
    for calls of these (FLOPs, bytes[, int8 operations]), at the published
    peaks: bf16 FLOPs at PEAK_FLOPS plus int8 operations at PEAK_INT8,
    against bytes at PEAK_BYTES."""
    t_op = sum(c[0] / PEAK_FLOPS + (c[2] if len(c) > 2 else 0) / PEAK_INT8
               for c in costs) * 1e3
    t_by = sum(c[1] for c in costs) / PEAK_BYTES * 1e3
    return max(t_op, t_by), "operations" if t_op >= t_by else "bytes"


def heads_of(qkv, n, s, heads=HEADS):
    """q, k, v [n, heads, s, 64] contiguous from a packed qkv [n*s, 3E]."""
    t = qkv.reshape(n, s, 3, heads, 64).permute(2, 0, 3, 1, 4)
    return tuple(u.contiguous() for u in t)


def check_launches(got: dict, want: dict, what: str) -> None:
    """Hold launch counts `got` to `want` with the `ln_rows` launches that
    `want` implies, one per `ln_gemm` / `ln_gemm_swiglu` call (their LN
    half), and the `ln_quant_rows` launches, one per `ln_gemm_i8` /
    `ln_gemm_i8_swiglu` call. A `want` that lists only the kernels it
    launches (phases 38-39) gains a key only where it is not 0."""
    n = sum(want.get(k, 0) for k in ("ln_gemm", "ln_gemm_swiglu",
                                     "ln_gemm_swiglu_train"))
    if n or "ln_rows" in want:
        want = {**want, "ln_rows": n}
    n8 = sum(want.get(k, 0) for k in ("ln_gemm_i8", "ln_gemm_i8_swiglu"))
    if n8 or "ln_quant_rows" in want:
        want = {**want, "ln_quant_rows": n8}
    check(got == want, f"{what}: launches {got} != {want}")


def ulp_bf16(x: float) -> float:
    """bf16 spacing at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def row_gaps(probs) -> np.ndarray:
    """[n, n] max-abs distances between the rows of [n, classes] probs."""
    p = np.asarray(probs, np.float64)
    return np.abs(p[:, None] - p[None]).max(-1)


def min_row_gap(probs) -> float:
    """Smallest distance between two rows of [n, classes] probs."""
    g = row_gaps(probs)
    return float(g[np.triu_indices(len(g), 1)].min())


def padding_mask(b: int) -> np.ndarray:
    """The [b, D] key-padding mask of the forward checks: volume 1 loses its
    last 8 slices, volume min(5, b - 1) its last 2."""
    m = np.zeros((b, DEPTH_SLICES), bool)
    m[1, 24:] = True
    m[min(5, b - 1), 30:] = True
    return m


def candidate_volumes(rng, pool: int) -> np.ndarray:
    """`pool` seeded [1, D, H, W] volumes, each noise of its own scale,
    offset and 56-pixel block pattern."""
    f32, one = np.float32, (pool, 1, 1, 1, 1)
    cand = rng.standard_normal((pool, 1, DEPTH_SLICES, PX, PX), dtype=f32)
    cand *= rng.uniform(0.25, 2.0, one).astype(f32)
    cand += rng.uniform(-1.5, 1.5, one).astype(f32)
    blocks = rng.standard_normal((pool, 1, DEPTH_SLICES, 4, 4), dtype=f32)
    blocks *= rng.uniform(0.0, 2.0, one).astype(f32)
    cand += np.repeat(np.repeat(blocks, PX // 4, axis=3), PX // 4, axis=4)
    return cand


def batched_probs(predict, vols) -> np.ndarray:
    """`predict`'s probs of `vols`, BATCH volumes per call."""
    return np.concatenate([predict(vols[i:i + BATCH], None)[0].cpu().numpy()
                           for i in range(0, len(vols), BATCH)])


def pick_spread(gaps, probs, n: int) -> list:
    """n indices kept greedily from [pool, pool] distances `gaps`, each the
    one furthest from those already kept, starting at the lowest class-0
    prob of `probs`."""
    keep = [int(np.argmin(probs[:, 0]))]
    while len(keep) < n:
        nearest = gaps[:, keep].min(axis=1)
        nearest[keep] = -1.0
        keep.append(int(np.argmax(nearest)))
    return keep


def spread_volumes(rng, predict, n: int, pool: int = 48) -> np.ndarray:
    """n seeded [1, D, H, W] volumes whose probs lie far apart.

    A random-weight model gives noise volumes nearly equal probs, and then
    a limit on |probs - reference| cannot tell a row of the wrong volume or
    slot. So `pool` candidates are drawn (`candidate_volumes`) and n are
    kept (`pick_spread`) on the probs of the kernel path."""
    cand = candidate_volumes(rng, pool)
    probs = batched_probs(predict, cand)
    return cand[pick_spread(row_gaps(probs), probs, n)]


class HostDraw:
    """`random_flax_params(build(), seed)` on a host thread, started while
    the card works on earlier phases: the same arrays as a draw in line
    (the draw's generator is its own), without its host seconds in the
    phase that uses it (numpy fills and scales the arrays with the
    interpreter lock released). `wait()` joins it -> seconds waited;
    `result()` waits -> (flat dict, seconds waited) and lets go of the
    dict; `span` is when the draw ran, (start, end) in seconds of the
    run."""

    def __init__(self, build, seed: int):
        self._out = self._err = None
        self.span = (time.perf_counter() - T0, None)
        self._thread = threading.Thread(target=self._run, args=(build, seed),
                                        daemon=True)
        self._thread.start()

    def _run(self, build, seed):
        from mst_tpu_torch.models.convert import random_flax_params
        try:
            self._out = random_flax_params(build(), seed)
        except BaseException as e:  # raised again by result()
            self._err = e
        self.span = (self.span[0], time.perf_counter() - T0)

    def wait(self) -> float:
        """Join the draw -> seconds waited."""
        t1 = time.perf_counter()
        self._thread.join()
        return time.perf_counter() - t1

    def result(self):
        waited = self.wait()
        if self._err is not None:
            raise self._err
        out, self._out = self._out, None
        return out, waited


def time_ms(fn, n: int = 10, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class ClockSampler:
    """The card's SM clock and power draw, sampled by `nvidia-smi -lms` in a
    process of its own while the block runs; `within(windows)` gives the
    medians of the samples read inside those host-time windows (a sample
    is stamped when it is read, a few ms after nvidia-smi took it)."""

    def __enter__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                mhz, watts = (float(v) for v in line.split(",")[:2])
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), mhz, watts))

    def within(self, windows):
        got = [(m, w) for t, m, w in list(self.samples)
               if any(a <= t <= b for a, b in windows)]
        if not got:
            return SimpleNamespace(mhz="not sampled", watts="not sampled",
                                   samples=0)
        return SimpleNamespace(mhz=statistics.median(m for m, _ in got),
                               watts=statistics.median(w for _, w in got),
                               samples=len(got))

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)
        return False


def time_interleaved(fns: dict, clocks: ClockSampler) -> dict:
    """Per name of `fns`: the median over PAIR_ROUNDS rounds of the mean
    device time of PER_PAIR calls between two CUDA events (`.ms`, with each
    round's reading in `.each` and their range `.lo`-`.hi`), the calls of
    all names taken in turn in each round, in reverse order every other
    round, so that neither the order nor the card's warming favours one;
    with the SM clock and power sampled while it ran (`.mhz`, `.watts`,
    `.samples`)."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    each = {name: [] for name in fns}
    windows = {name: [] for name in fns}
    names = list(fns)
    for r in range(PAIR_ROUNDS):
        for name in names if r % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(PER_PAIR):
                fns[name]()
            end.record()
            end.synchronize()
            windows[name].append((t0, time.perf_counter()))
            each[name].append(start.elapsed_time(end) / PER_PAIR)
    return {name: SimpleNamespace(ms=statistics.median(each[name]),
                                  lo=min(each[name]), hi=max(each[name]),
                                  each=each[name],
                                  **vars(clocks.within(windows[name])))
            for name in names}


def check_outputs(tag, name, kern, plain, rel) -> float:
    """Hold a tuple of outputs against its plain version: bf16 ones within
    2 bf16 ulps at the plain output's largest magnitude, f32 ones within
    `rel` times it. Prints each reading beside its limit; returns the
    largest absolute error."""
    kern = kern if isinstance(kern, (tuple, list)) else (kern,)
    plain = plain if isinstance(plain, (tuple, list)) else (plain,)
    check(len(kern) == len(plain), f"{name}: {len(kern)} != {len(plain)}")
    worst = 0.0
    for i, (k, pl) in enumerate(zip(kern, plain)):
        label = f"{name}[{i}]"
        if pl is None:
            check(k is None, f"{label}: unexpected output")
            continue
        check(tuple(k.shape) == tuple(pl.shape) and k.dtype == pl.dtype,
              f"{label}: {tuple(k.shape)} {k.dtype} != {tuple(pl.shape)} "
              f"{pl.dtype}")
        check(bool(torch.isfinite(k.float()).all()), f"{label}: non-finite")
        scale = pl.float().abs().max().item()
        err = (k.float() - pl.float()).abs().max().item()
        lim = 2 * ulp_bf16(scale) if k.dtype == torch.bfloat16 else rel * scale
        print(f"{tag} {label}: {list(k.shape)} {str(k.dtype)[6:]} "
              f"max_abs_err={err:.6g} limit={lim:.6g} (|plain|max={scale:.6g})")
        check(err <= lim, f"{label}: max_abs_err {err} > {lim}")
        worst = max(worst, err)
    return worst


def argmax_agreement(probs, ref):
    """(agreeing, held): per volume whether the argmax of `probs` is that of
    `ref`, and whether that volume is held to it (its `ref` top-two margin
    exceeds 2 * I8_TOL, i.e. its probs lie further than I8_TOL from the
    boundary); half of the volumes at least must be held."""
    top2 = ref.topk(2, -1).values
    held = ((top2[:, 0] - top2[:, 1]) > 2 * I8_TOL).tolist()
    agree = (probs.argmax(-1) == ref.argmax(-1)).tolist()
    check(2 * sum(held) >= len(held), f"only {sum(held)} of {len(held)} "
          f"volumes lie further than {I8_TOL} from the class boundary")
    return agree, held


def code_diff(a, b):
    """(how many, largest step, share) of int8 codes a that differ from b."""
    d = (a.int() - b.int()).abs()
    nd = int((d > 0).sum())
    return nd, int(d.max()), nd / d.numel()


def check_int8(tag, name, kern, plain, rel=None) -> float:
    """`check_outputs` for the int8 kernels and chains: int8 codes may
    differ from the plain version's at .5 ties (at most CODE_FRAC of them,
    each by one); bf16 outputs within 2 bf16 ulps at the plain output's
    largest magnitude; f32 outputs within `rel` times it, or with `rel`
    None within 2 bf16 ulps (a row scale, or the FFN hidden, where a code
    flipped upstream moves a whole row by one product step, ~1e-3 of its
    largest value). The hidden is next quantized per token, so its codes
    under the plain `_quant_rows` are held as the kernels' codes are, and
    a hidden rounded to bf16 first (planted) must break that limit.
    Returns the largest absolute error (codes in steps)."""
    from mst_tpu_torch.ops.fused_int8 import _quant_rows_ref

    kern = tuple(kern) if isinstance(kern, (tuple, list)) else (kern,)
    plain = tuple(plain) if isinstance(plain, (tuple, list)) else (plain,)
    check(len(kern) == len(plain), f"{name}: {len(kern)} != {len(plain)}")
    worst = 0.0
    for i, (k, pl) in enumerate(zip(kern, plain)):
        label = f"{name}[{i}]"
        check(tuple(k.shape) == tuple(pl.shape) and k.dtype == pl.dtype,
              f"{label}: {tuple(k.shape)} {k.dtype} != {tuple(pl.shape)} "
              f"{pl.dtype}")
        if k.dtype == torch.int8:
            nd, top, frac = code_diff(k, pl)
            print(f"{tag} {label}: {list(k.shape)} int8 codes differing "
                  f"{nd} of {k.numel()} ({frac:.3g}, limit {CODE_FRAC}), by "
                  f"at most {top} (limit 1)")
            check(top <= 1 and frac <= CODE_FRAC, f"{label}: {nd} codes "
                  f"differ, by up to {top}")
            worst = max(worst, float(top))
        elif k.dtype == torch.float32 and rel is None:
            check(bool(torch.isfinite(k).all()), f"{label}: non-finite")
            scale = pl.abs().max().item()
            err = (k - pl).abs().max().item()
            lim = 2 * ulp_bf16(scale)
            print(f"{tag} {label}: {list(k.shape)} float32 max_abs_err="
                  f"{err:.6g} limit={lim:.6g} (2 bf16 ulps; |plain|max="
                  f"{scale:.6g})")
            check(err <= lim, f"{label}: max_abs_err {err} > {lim}")
            worst = max(worst, err)
            if k.dim() == 2:  # the FFN hidden
                rows = int(((k - pl).abs() > KERNEL_GRAD_REL * scale).any(-1)
                           .sum())
                want = _quant_rows_ref(pl)[0]
                nd, top, frac = code_diff(_quant_rows_ref(k)[0], want)
                nf, _, ffrac = code_diff(
                    _quant_rows_ref(pl.to(torch.bfloat16))[0], want)
                print(f"{tag} {label}: rows with an element further than "
                      f"{KERNEL_GRAD_REL} x |plain|max from plain {rows} of "
                      f"{k.shape[0]}; its per-token codes differing {nd} of "
                      f"{k.numel()} ({frac:.3g}, limit {CODE_FRAC}), by at "
                      f"most {top} (limit 1); the plain hidden rounded to "
                      f"bf16 first (planted) {nf} ({ffrac:.3g}, must exceed "
                      f"the limit)")
                check(top <= 1 and frac <= CODE_FRAC < ffrac,
                      f"{label}: hidden codes {nd} / planted {nf} differ")
        else:
            worst = max(worst, check_outputs(tag, label, k, pl, rel))
    return worst


def int8_cases(dev, rng, fb, fq, layers):
    """Phase 31's cases: {name: (kernel thunk, plain thunk, f32 limit)},
    {name: cost}, {name: library thunk}. Each int8 kernel in every mode and
    each int8 sub-layer in every flag form, at the ViT-S B=8 path shapes
    [256, 257, 384] (RoPE at [256, 201, 384]) and giant2's [256, 257, 1536]
    with F = 4096, on seeded weights quantized on the card. The static
    inputs are folded as `_fold_static_scales` folds, from this data's own
    abs-maxima with the calibration margin 1.05. The library thunks are
    the same function in torch ops around `torch._int_mm` (LN, quantization,
    the integer product, dequantization), timed as a yardstick only
    (`gemm_i8_residual`'s in phase 46, `quant_rows`'s in phase 47)."""
    bf, eps, rel = torch.bfloat16, 1e-6, 3e-3  # rel: a chain's f32 outputs
    E4, EG, FG, HG = 4 * E, 1536, 4096, 24
    M = N_SLICES * S

    def rand(*shape, scale=1.0, off=0.0, dtype=torch.float32):
        arr = off + scale * rng.standard_normal(shape)
        return torch.from_numpy(arr.astype(np.float32)).to(dev, dtype)

    def node(k, n):
        q, sc = fq.quantize_weight_int8(rand(k, n, scale=k ** -0.5))
        return layers.QDense(q, sc, rand(n, scale=0.1))

    def folded(nd, colmul, a_inv=None):
        """nd with its dequant scale and bias times `colmul`."""
        return layers.QDense(nd.q8, nd.scale * colmul, nd.bias * colmul,
                             None if a_inv is None else
                             torch.full((1, 1), a_inv, device=dev))

    def margin_scale(v):  # the calibration's per-tensor scale
        return v.float().abs().max().item() * 1.05 / 127.0

    def pair(kern, plain, *args, **kw):
        return (functools.partial(kern, *args, **kw),
                functools.partial(plain, *args, **kw))

    cases, cost, library = {}, {}, {}

    def add(name, kern, plain, *args, f32_rel=None, **kw):
        cases[name] = (*pair(kern, plain, *args, **kw), f32_rel)

    def lib_first(x2, ln_s, ln_b, nd, act):
        k = x2.shape[1]
        q, sc = lib_quant(F.layer_norm(x2.float(), (k,), ln_s, ln_b, eps))
        v = torch._int_mm(q, nd.q8).float() * sc * nd.scale + nd.bias
        if act == "swiglu":
            h1, h2 = v.chunk(2, dim=-1)
            return F.silu(h1) * h2
        return v.to(bf) if act is None else F.gelu(v, approximate=act)

    # -- ViT-S: [256, 257, 384] ------------------------------------------
    x = rand(N_SLICES, S, E, dtype=bf)
    xb = rand(N_SLICES, S, E, dtype=bf)  # the second rollout block's input
    x2 = x.reshape(M, E)
    ln_s, ln_b = rand(E, scale=0.1, off=1.0), rand(E, scale=0.1)
    ls = rand(E, scale=0.1, off=1.0)
    qkv, proj, fc1, fc2 = node(E, 3 * E), node(E, E), node(E, E4), node(E4, E)
    t_qkv = fq._ln_gemm_i8_ref(x2, ln_s, ln_b, qkv.q8, qkv.scale, qkv.bias,
                               fb.ACT_NONE, eps)
    o = fb._mhsa_ref(t_qkv, N_SLICES, S, HEADS)
    oq, osc = fq._quant_rows_ref(o)
    u = fq._ln_gemm_i8_ref(x2, ln_s, ln_b, fc1.q8, fc1.scale, fc1.bias,
                           fb.ACT_GELU_TANH, eps)
    uq, us = fq._quant_rows_ref(u)
    a_in = margin_scale(fb._ln(x2, ln_s, ln_b, eps))
    a_out, b_hid = margin_scale(o), margin_scale(u)
    ln_s8, ln_b8 = ln_s / a_in, ln_b / a_in
    colmul = torch.ones(3 * E, device=dev)
    colmul[2 * E:] = 1.0 / a_out
    qkv8, proj8 = folded(qkv, colmul * a_in), folded(proj, a_out)
    fc18, fc28 = folded(fc1, a_in), folded(fc2, b_hid, 1.0 / b_hid)
    o8 = fb._mhsa_ref(fq._ln_gemm_i8_ref(
        x2, ln_s8, ln_b8, qkv8.q8, qkv8.scale, qkv8.bias, fb.ACT_NONE, eps,
        True), N_SLICES, S, HEADS)
    oq8 = fq._quant_rows_ref(o8, True)
    uq8 = fq._ln_gemm_i8_ref(x2, ln_s8, ln_b8, fc18.q8, fc18.scale,
                             fc18.bias, fb.ACT_GELU_TANH, eps, True,
                             fc28.a_inv)
    first = (fq.ln_gemm_i8, fq._ln_gemm_i8_ref)
    add("ln_gemm_i8[qkv]", *first, x2, ln_s, ln_b, qkv.q8, qkv.scale,
        qkv.bias, fb.ACT_NONE, eps, q8t=qkv.q8t)
    add("ln_gemm_i8[qkv,static]", *first, x2, ln_s8, ln_b8, qkv8.q8,
        qkv8.scale, qkv8.bias, fb.ACT_NONE, eps, True, q8t=qkv8.q8t)
    for act, code in (("gelu_tanh", fb.ACT_GELU_TANH),
                      ("gelu_erf", fb.ACT_GELU_ERF)):
        add(f"ln_gemm_i8[fc1,{act}]", *first, x2, ln_s, ln_b, fc1.q8,
            fc1.scale, fc1.bias, code, eps, q8t=fc1.q8t)
    add("ln_gemm_i8[fc1,gelu_tanh,static]", *first, x2, ln_s8, ln_b8,
        fc18.q8, fc18.scale, fc18.bias, fb.ACT_GELU_TANH, eps, True,
        fc28.a_inv, q8t=fc18.q8t)
    # the LN half of `ln_gemm_i8` alone: its codes (and row scales)
    def codes(fn):
        return lambda *a: fn(*a)[0]

    add("ln_quant_rows[E=384]", fq.ln_quant_rows, fq._quantize_ln, x2, ln_s,
        ln_b, eps)
    add("ln_quant_rows[E=384,static]", codes(fq.ln_quant_rows),
        codes(fq._quantize_ln), x2, ln_s8, ln_b8, eps, True)
    quant = (fq.quant_rows, fq._quant_rows_ref)
    add("quant_rows[o]", *quant, o)
    add("quant_rows[o,static]", *quant, o8, True)
    add("quant_rows[u]", *quant, u)
    second = (fq.gemm_i8_residual, fq._gemm_i8_residual_ref)
    add("gemm_i8_residual[proj,ls]", *second, oq, osc, proj.q8, proj.scale,
        proj.bias, ls, x2, q8t=proj.q8t)
    add("gemm_i8_residual[proj,no_ls]", *second, oq, osc, proj.q8,
        proj.scale, proj.bias, None, x2, q8t=proj.q8t)
    add("gemm_i8_residual[proj,ls,static]", *second, oq8, None, proj8.q8,
        proj8.scale, proj8.bias, ls, x2, q8t=proj8.q8t)
    add("gemm_i8_residual[fc2,ls]", *second, uq, us, fc2.q8, fc2.scale,
        fc2.bias, ls, x2, q8t=fc2.q8t)
    add("gemm_i8_residual[fc2,ls,static]", *second, uq8, None, fc28.q8,
        fc28.scale, fc28.bias, ls, x2, q8t=fc28.q8t)
    cost.update({
        "ln_gemm_i8[qkv]": i8_cost(M, E, 3 * E, 2, 2, 4 * 5 * E),
        "ln_gemm_i8[qkv,static]": i8_cost(M, E, 3 * E, 2, 2, 4 * 5 * E),
        "ln_gemm_i8[fc1,gelu_tanh]": i8_cost(M, E, E4, 2, 4, 4 * 6 * E),
        "ln_gemm_i8[fc1,gelu_tanh,static]": i8_cost(M, E, E4, 2, 1,
                                                    4 * 6 * E),
        "gemm_i8_residual[proj,ls]": i8_cost(M, E, E, 1, 2,
                                             2 * M * E + 4 * (M + 3 * E)),
        "gemm_i8_residual[proj,ls,static]": i8_cost(M, E, E, 1, 2,
                                                    2 * M * E + 4 * 3 * E),
        "gemm_i8_residual[fc2,ls]": i8_cost(M, E4, E, 1, 2,
                                            2 * M * E + 4 * (M + 3 * E)),
        "gemm_i8_residual[fc2,ls,static]": i8_cost(M, E4, E, 1, 2,
                                                   2 * M * E + 4 * 3 * E),
    })
    library.update({
        "ln_gemm_i8[qkv]": functools.partial(lib_first, x2, ln_s, ln_b, qkv,
                                             None),
        "ln_gemm_i8[fc1,gelu_tanh]": functools.partial(lib_first, x2, ln_s,
                                                       ln_b, fc1, "tanh"),
    })

    # the sub-layers (f32 outputs: rows, carry, Abnar factor within `rel`)
    attn = (fq.fused_attention_sublayer_i8, fq._attn_i8_ref)
    args, args8 = (x, ln_s, ln_b, qkv, proj), (x, ln_s8, ln_b8, qkv8, proj8)
    e0 = torch.zeros(N_SLICES, HEADS, S, device=dev)
    e0[:, :, 0] = 1.0  # the rollout chain starts at the CLS token
    add("attention_sublayer_i8[ls]", *attn, *args, ls, HEADS)
    add("attention_sublayer_i8[no_ls]", *attn, *args, None, HEADS)
    add("attention_sublayer_i8[ls,static]", *attn, *args8, ls, HEADS,
        static=True)
    add("attention_sublayer_i8[ls,row]", *attn, *args, ls, HEADS,
        want_row=True, f32_rel=rel)
    add("attention_sublayer_i8[ls,static,row]", *attn, *args8, ls, HEADS,
        static=True, want_row=True, f32_rel=rel)
    add("attention_sublayer_i8[ls,abnar]", *attn, *args, ls, HEADS,
        abnar=True, f32_rel=rel)

    def rollout2(fn, static):
        """Two blocks of the int8 rollout sub-layer, the second fed the
        first's carry (not one-hot) on an input of its own."""
        a = args8 if static else args
        y1, c1 = fn(*a, ls, HEADS, static=static, carry=e0)
        return (y1, c1, *fn(xb, *a[1:], ls, HEADS, static=static, carry=c1,
                            want_row=True))

    for static in (False, True):
        name = f"attention_sublayer_i8[ls,{'static,' * static}rollout,2 blocks]"
        cases[name] = (functools.partial(rollout2, attn[0], static),
                       functools.partial(rollout2, attn[1], static), rel)
    mlp = (fq.fused_mlp_sublayer_i8, fq._mlp_i8_ref)
    add("mlp_sublayer_i8[tanh,ls]", *mlp, x, ln_s, ln_b, fc1, fc2, ls, True)
    add("mlp_sublayer_i8[erf,no_ls]", *mlp, x, ln_s, ln_b, fc1, fc2, None,
        False)
    add("mlp_sublayer_i8[tanh,ls,static]", *mlp, x, ln_s8, ln_b8, fc18, fc28,
        ls, True)

    # -- DINOv3's RoPE form at [256, 201, 384] -----------------------------
    from mst_tpu_torch.ops.rotary import rope_tables

    cos3, sin3 = rope_tables(GRID3, 64, PREFIX3, 100.0, True, dev)
    x3 = rand(N_SLICES, S3, E, dtype=bf)
    for static in (False, True):
        a = args8 if static else args
        for flag, kw in (("", {}), (",row", dict(want_row=True)),
                         (",abnar", dict(abnar=True))):
            add(f"attention_sublayer_i8[ls,{'static,' * static}rope{flag},"
                f"S=201]", *attn, x3, *a[1:], ls, HEADS, EPS3, cos3, sin3,
                static=static, f32_rel=rel, **kw)

    # -- giant2: [256, 257, 1536], 24 heads, F = 4096 ---------------------
    xg = rand(N_SLICES, S, EG, dtype=bf)
    xg2 = xg.reshape(M, EG)
    lng_s, lng_b = rand(EG, scale=0.1, off=1.0), rand(EG, scale=0.1)
    lsg = rand(EG, scale=0.1, off=1.0)
    w12, w3 = node(EG, 2 * FG), node(FG, EG)
    qkvg, projg = node(EG, 3 * EG), node(EG, EG)
    g = fq._ln_gemm_i8_swiglu_ref(xg2, lng_s, lng_b, w12.q8, w12.scale,
                                  w12.bias, eps)
    gq, gs = fq._quant_rows_ref(g)
    a_g, b_g = margin_scale(fb._ln(xg2, lng_s, lng_b, eps)), margin_scale(g)
    lng_s8, lng_b8 = lng_s / a_g, lng_b / a_g
    w128, w38 = folded(w12, a_g), folded(w3, b_g, 1.0 / b_g)
    gq8 = fq._ln_gemm_i8_swiglu_ref(xg2, lng_s8, lng_b8, w128.q8, w128.scale,
                                    w128.bias, eps, True, w38.a_inv)
    add("ln_quant_rows[E=1536]", fq.ln_quant_rows, fq._quantize_ln, xg2,
        lng_s, lng_b, eps)
    gated = (fq.ln_gemm_i8_swiglu, fq._ln_gemm_i8_swiglu_ref)
    add("ln_gemm_i8_swiglu[w12]", *gated, xg2, lng_s, lng_b, w12.q8,
        w12.scale, w12.bias, eps, q8t=w12.q8t)
    add("ln_gemm_i8_swiglu[w12,static]", *gated, xg2, lng_s8, lng_b8,
        w128.q8, w128.scale, w128.bias, eps, True, w38.a_inv, q8t=w128.q8t)
    add("quant_rows[g]", *quant, g)
    add("gemm_i8_residual[w3,ls]", *second, gq, gs, w3.q8, w3.scale, w3.bias,
        lsg, xg2, q8t=w3.q8t)
    add("gemm_i8_residual[w3,ls,static]", *second, gq8, None, w38.q8,
        w38.scale, w38.bias, lsg, xg2, q8t=w38.q8t)
    swiglu = (fq.fused_swiglu_sublayer_i8, fq._swiglu_i8_ref)
    add("swiglu_sublayer_i8[ls]", *swiglu, xg, lng_s, lng_b, w12, w3, lsg)
    add("swiglu_sublayer_i8[ls,static]", *swiglu, xg, lng_s8, lng_b8, w128,
        w38, lsg)
    add("attention_sublayer_i8[ls,E=1536]", *attn, xg, lng_s, lng_b, qkvg,
        projg, lsg, HG)
    cost.update({
        "ln_gemm_i8_swiglu[w12]": i8_cost(M, EG, 2 * FG, 2, 0,
                                          4 * M * FG + 4 * (2 * EG + 4 * FG)),
        "ln_gemm_i8_swiglu[w12,static]": i8_cost(
            M, EG, 2 * FG, 2, 0, M * FG + 4 * (2 * EG + 4 * FG)),
        "gemm_i8_residual[w3,ls]": i8_cost(M, FG, EG, 1, 2,
                                           2 * M * EG + 4 * (M + 3 * EG)),
        "gemm_i8_residual[w3,ls,static]": i8_cost(
            M, FG, EG, 1, 2, 2 * M * EG + 4 * 3 * EG),
    })
    library.update({
        "ln_gemm_i8_swiglu[w12]": functools.partial(lib_first, xg2, lng_s,
                                                    lng_b, w12, "swiglu"),
    })
    return cases, cost, library


def read_nifti_f32(path) -> np.ndarray:
    """The data of a float32 NIfTI-1 file that `utils.nifti.write_nifti`
    wrote (352-byte header and extension flag, then Fortran order)."""
    with gzip.open(path, "rb") as f:
        raw = f.read()
    ndim = struct.unpack_from("<h", raw, 40)[0]
    dims = struct.unpack_from(f"<{ndim}h", raw, 42)
    check(struct.unpack_from("<h", raw, 70)[0] == 16, f"{path}: not float32")
    return np.frombuffer(raw[352:], np.float32).reshape(dims, order="F")


def profile_device(tag, label, fn, top: int, record_shapes: bool = False):
    """Print the device's busy and idle share over one call of `fn` and its
    `top` kernels by device time (`torch.profiler`). One call runs as the
    profiler's warm-up step first: without it the trace of a short call
    (a 50 ms ViT-S forward) lost about the first half of its kernels. With
    `record_shapes`, returns the (op, input shapes) of every CPU-side op of
    the trace (else an empty list)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        prof.step()
    # kernels only: a CPU-side entry also carries its kernels' device time,
    # and a GPU user annotation (the optimizer step's) spans its kernels
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e3  # ms
    print(f"{tag} profile of {label}: wall {wall * 1e3:.3f} ms "
          f"(profiler on), device busy {busy:.3f} ms, idle "
          f"{max(0.0, 1 - busy / (wall * 1e3)) * 100:.1f}%")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:5d}x  {e.key[:110]}")
    if not record_shapes:
        return []
    return [(e.key, e.input_shapes) for e in
            prof.key_averages(group_by_input_shape=True)
            if e.device_type == torch.autograd.DeviceType.CPU]


def flash_cost(n, s, heads=HEADS, part="fwd", lse=False):
    """(FLOPs, bytes) of the flash kernels over q, k, v [n, heads, s, 64]:
    the forward's two products (q.k^T, p.v), reading q, k, v and writing o
    (and the f32 LSE rows); the backward's five, the work the function
    needs as `attn_cost` counts it: s and dp (the dq kernel forms them
    first) and dq for the dq kernel, reading q, k, v, o, do and the LSE,
    writing dq and delta; dv and dk for the dk/dv kernel, reading q, k, v,
    do, the LSE and delta, writing dk, dv. The pair runs seven products,
    each kernel forming s and dp (`FLASH_PAIR_PRODUCTS`)."""
    m, rows = n * heads * s * 64, n * heads * s
    prod = 2 * n * heads * s * s * 64
    if part == "fwd":
        return 2 * prod, 2 * 4 * m + (4 * rows if lse else 0)
    if part == "dq":
        return 3 * prod, 2 * 6 * m + 8 * rows
    return 2 * prod, 2 * 6 * m + 8 * rows


# Products of S^2 hd the backward pair executes (s, dp and dq; s, dp, dv and
# dk) against the five the function needs: the executed rate's numerator.
FLASH_PAIR_PRODUCTS = 7


def host_seconds(fn, n: int = 5) -> float:
    """Median host time of `fn()` ending in a synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t1)
    return statistics.median(ts)


def train_sublayer_outputs(fb, kind, ops, x, args, g):
    """(y, residuals, dx, every argument's grad) of one train sub-layer on
    `ops` (fb.KERNELS or fb.PLAIN), `args` after x with f32 matrices; the
    RoPE sub-layer ("attn_rope") takes the tables after ls and gives them
    no grad."""
    fn, fwd = {"attn": (fb.fused_attention_sublayer_train, fb._attn_train_fwd),
               "attn_rope": (fb.fused_attention_sublayer_train_rope,
                             fb._attn_train_fwd),
               "mlp": (fb.fused_mlp_sublayer_train, fb._mlp_train_fwd),
               "swiglu": (fb.fused_swiglu_sublayer_train,
                          fb._swiglu_train_fwd)}[kind]
    tables = args[7:9] if kind == "attn_rope" else ()
    xx = x.clone().requires_grad_(True)
    aa = [a if any(a is t for t in tables) else
          a.clone().requires_grad_(True) if torch.is_tensor(a) else a
          for a in args]
    fn(xx, *aa, ops=ops).backward(g)
    cast = [a.to(x.dtype) if torch.is_tensor(a) and a.dim() == 2 else a
            for a in args]
    if kind == "attn_rope":  # the tables go last and stay f32
        y, res = fwd(ops, x, *cast[:7], *args[9:], *tables)
    else:
        y, res = fwd(ops, x, *cast)
    grads = [a.grad for a in aa
             if torch.is_tensor(a) and not any(a is t for t in tables)]
    return (y, *res, xx.grad, *grads)


# -- phases 38-39: the tools/ experiments (queue B rows 17-21) ---------------


# Phase 38's lengths for the redesigned cores of rows 18-19: a ragged 77
# (one full chunk and a 13-key one), DINOv3's 201, ViT-S's 257 (one pass),
# and the longest the WMMA kernel took, 400 (row 18), or 512 (row 19; two
# passes), TOOLS_N slices at ViT-S's 6 heads.
TOOLS_S18 = (77, 201, 257, 400)
TOOLS_S19 = (77, 201, 257, 512)
TOOLS_N = 32
# The WMMA kernels' times at the tools' shapes (row 18: [128, 6, 257, 64];
# row 19: ViT-S [256, 6, 257, 64]; row 21: [128, 6, 257, 64]; row 17: M =
# 32,896; PERF.md §6 rows 17-21, phase 39 on an H100 80GB HBM3 at 700 W),
# printed beside the redesigned ones.
WMMA_TOOLS_MS = {"attn_variant[A]": 0.8313, "attn_variant[B]": 0.7225,
                 "attn_variant[C]": 0.7496, "attn_variant[D]": 0.6585,
                 "attn_variant[E]": 0.6812, "attn_i8[B]": 1.0490,
                 "attn_i8[C]": 0.9960, "attn_split_cls": 0.5444,
                 "block_tail": 1.2276}
# Phase 38's lengths for row 21's split-CLS core: every S = 1 + P it takes
# (P = 64 .. 384; one pass up to P = 256), and row 17's `block_tail` rows:
# the tool's M = 128 x 257, a ragged 771 and 1.
TOOLS_S21 = tuple(1 + p for p in range(64, 385, 64))
TOOLS_M17 = (32_896, 771, 1)


def i8_plain_codes(q8, n, s, nh, scale, log2_127):
    """Variant C's plain p (f32) and codes rint(p), [n, heads, s, s], as
    `bench_attn_i8.core_i8_ref` computes them."""
    t = q8.reshape(n, s, 3, nh, 64).permute(2, 0, 3, 1, 4)
    sc = torch.matmul(t[0].double(), t[1].double().transpose(-1, -2)
                      ).float() * scale
    p = torch.exp2((sc - sc.amax(-1, keepdim=True)) + log2_127)
    return p, torch.round(p)


def tools_attn_phase(tag, dev, fb, sm, bi):
    """Phase 38's hold on the redesigned cores of rows 18 and 19
    (`attn_variants.cu` variants A-E, `attn_i8.cu` B and C, on TMA +
    wgmma): each entry first in a fresh host thread, every variant at
    TOOLS_S18 / TOOLS_S19 within 2 bf16 ulps of its plain version and twice
    for the same bits, D bit for bit against `mhsa`, C's P codes against
    the plain codes."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    bf = torch.bfloat16
    n = TOOLS_N

    def qkv_of(n_, s):
        return torch.randn(n_ * s, 3 * E, generator=gen, device=dev).to(bf)

    def codes_of(s, amp):
        q8c = torch.randint(-amp, amp + 1, (n * s, 3 * E), generator=gen,
                            device=dev, dtype=torch.int32).to(torch.int8)
        v8 = torch.randn(n * s, E, generator=gen, device=dev).to(bf)
        return q8c[:, :2 * E].contiguous(), v8, q8c

    def within(name, k, p):
        scale = p.float().abs().max().item()
        err = (k.float() - p.float()).abs().max().item()
        lim = 2 * ulp_bf16(scale)
        check(bool(torch.isfinite(k.float()).all()), f"{name}: non-finite")
        return err, lim

    print(f"{tag} tools cores on TMA + wgmma (rows 18-19): each entry first "
          f"in a fresh host thread; variants A-E at S = {TOOLS_S18}, int8 B "
          f"/ C at S = {TOOLS_S19} (codes in [-127, 127] and [-3, 3]), "
          f"{n} slices x {HEADS} heads, within 2 bf16 ulps of plain, twice "
          f"for the same bits; D against mhsa bit for bit; C's codes against "
          f"the plain codes")
    with torch.inference_mode():
        firsts = []
        for s18, s19 in ((257, 257), (TOOLS_S18[-1], TOOLS_S19[-1])):
            qkv = qkv_of(n, s18)
            q8b, v8, q8c = codes_of(s19, 127)
            firsts += [(f"attn_variant[{v}] S={s18}", functools.partial(
                sm.attn_variant, qkv, n, s18, HEADS, v)) for v in sm.VARIANTS]
            firsts += [(f"attn_i8[B] S={s19}", functools.partial(
                bi.attn_i8, q8b, v8, n, s19, HEADS)),
                (f"attn_i8[C] S={s19}", functools.partial(
                    bi.attn_i8, q8c, None, n, s19, HEADS))]
        for name, fn in firsts:
            there, here = fresh_thread(fn), fn()
            torch.cuda.synchronize()
            same = torch.equal(there, here)
            print(f"{tag} {name} launched first in a fresh host thread: the "
                  f"same bits as on the main thread: {same}")
            check(same, f"{name} in a fresh thread differs")
        del firsts, qkv, q8b, v8, q8c

        for s in TOOLS_S18:
            qkv = qkv_of(n, s)
            for v in sm.VARIANTS:
                o1, pk = sm.attn_variant(qkv, n, s, HEADS, v, want_p=True)
                o2 = sm.attn_variant(qkv, n, s, HEADS, v)
                ref, pref = sm.core_ref(qkv, n, s, HEADS, v, want_p=True)
                torch.cuda.synchronize()
                err, lim = within(f"attn_variant[{v}] S={s}", o1, ref)
                perr = (pk.float() - pref.float()).abs().max().item()
                same = torch.equal(o1, o2)
                print(f"{tag} attn_variant[{v}] S={s}: max_abs_err={err:.6g} "
                      f"limit={lim:.6g}; P max|kernel - plain| {perr:.4g}; "
                      f"two runs equal {same}")
                check(err <= lim, f"attn_variant[{v}] S={s}: {err} vs {lim}")
                check(same, f"attn_variant[{v}] S={s}: two runs differ")
                del o1, o2, pk, ref, pref
            del qkv
        for n_, s in ((128, 257), (256, 201)):
            qkv = qkv_of(n_, s)
            d, m = sm.attn_variant(qkv, n_, s, HEADS, "D"), fb.mhsa(qkv, n_, s,
                                                                    HEADS)
            torch.cuda.synchronize()
            same = torch.equal(d, m)
            print(f"{tag} attn_variant[D] at [{n_}, {s}] against mhsa: bit "
                  f"for bit {same} (max diff "
                  f"{(d.float() - m.float()).abs().max().item():.4g})")
            check(same, f"attn_variant[D] at [{n_}, {s}] is not mhsa's bits")
            del qkv, d, m

        for s in TOOLS_S19:
            for amp in (127, 3):
                q8b, v8, q8c = codes_of(s, amp)
                for var, q8, v in (("B", q8b, v8), ("C", q8c, None)):
                    o2 = bi.attn_i8(q8, v, n, s, HEADS)
                    o1, pk = ((bi.attn_i8(q8, v, n, s, HEADS, want_p=True))
                              if var == "C" else (bi.attn_i8(q8, v, n, s,
                                                             HEADS), None))
                    ref = bi.core_i8_ref(q8, v, n, s, HEADS, bf)
                    torch.cuda.synchronize()
                    name = f"attn_i8[{var}] S={s} codes +-{amp}"
                    err, lim = within(name, o1, ref)
                    same = torch.equal(o1, o2)
                    extra = ""
                    if var == "C":
                        p, pq = i8_plain_codes(q8, n, s, HEADS, bi.SCALE,
                                               bi.LOG2_127)
                        diff = pk.float() != pq
                        tie = (p - p.floor() - 0.5).abs() <= 2.0 ** -12
                        off = int((diff & ~tie).sum())
                        extra = (f"; P codes differing from plain "
                                 f"{int(diff.sum())} of {diff.numel()}, "
                                 f"{off} not at a .5 tie")
                        check(off == 0, f"{name}: {off} codes off a tie")
                        del p, pq, diff, tie
                    print(f"{tag} {name}: max_abs_err={err:.6g} "
                          f"limit={lim:.6g}; two runs equal {same}{extra}")
                    check(err <= lim, f"{name}: {err} vs {lim}")
                    check(same, f"{name}: two runs differ")
                    del o1, o2, pk, ref
                del q8b, v8, q8c
    torch.cuda.empty_cache()


def tools_rest_phase(tag, dev, sc, bf):
    """Phase 38's hold on row 21's split-CLS core and row 17's
    `block_tail`, redesigned on TMA + wgmma: each first in a fresh host
    thread, the split core at TOOLS_S21 and `block_tail` at TOOLS_M17
    within 2 bf16 ulps of plain and twice for the same bits."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    bf16 = torch.bfloat16
    n = TOOLS_N
    p17 = bf.params(dev, bf.E)
    # nonzero biases and LN operands, so that each one is checked
    for name in ("bproj", "ln2b", "b1", "b2"):
        t = getattr(p17, name)
        t.copy_(0.1 * torch.randn(t.shape, generator=gen, device=dev))
    p17.ln2s.copy_(1 + 0.1 * torch.randn(bf.E, generator=gen, device=dev))

    def tail_args(m):
        o, x = (0.3 * torch.randn(2, m, bf.E, generator=gen, device=dev)).to(bf16)
        return (o, x, p17.wproj, p17.bproj, p17.ln2s, p17.ln2b, p17.w1, p17.b1,
                p17.w2, p17.b2)

    print(f"{tag} tools cores on TMA + wgmma (rows 21 and 17): each entry "
          f"first in a fresh host thread; attn_split_cls at S = {TOOLS_S21}, "
          f"{n} slices x {HEADS} heads; block_tail at M = {TOOLS_M17}; "
          f"within 2 bf16 ulps of plain, twice for the same bits")
    with torch.inference_mode():
        cases = []
        for s in TOOLS_S21:
            qkv = torch.randn(n * s, 3 * E, generator=gen, device=dev).to(bf16)
            cases.append((f"attn_split_cls S={s}",
                          functools.partial(sc.attn_split_cls, qkv, n, s, HEADS),
                          functools.partial(sc.split_ref, qkv, n, s, HEADS)))
        for m in TOOLS_M17:
            args = tail_args(m)
            cases.append((f"block_tail M={m}",
                          functools.partial(bf.block_tail, *args),
                          functools.partial(bf.block_tail_ref, *args)))
        # the first launches: the one-pass and two-pass split instances
        # (S = 257, 385) and block_tail at the tool's M
        firsts = {"attn_split_cls S=257", "attn_split_cls S=385",
                  f"block_tail M={TOOLS_M17[0]}"}
        for name, kern, plain in [c_ for c_ in cases if c_[0] in firsts]:
            there, here = fresh_thread(kern), kern()
            torch.cuda.synchronize()
            same = torch.equal(there, here)
            print(f"{tag} {name} launched first in a fresh host thread: the "
                  f"same bits as on the main thread: {same}")
            check(same, f"{name} in a fresh thread differs")
        for name, kern, plain in cases:
            k1, k2, ref = kern(), kern(), plain()
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            err = (k1.float() - ref.float()).abs().max().item()
            lim = 2 * ulp_bf16(scale)
            same = torch.equal(k1, k2)
            print(f"{tag} {name}: max_abs_err={err:.6g} limit={lim:.6g}; two "
                  f"runs equal {same}")
            check(bool(torch.isfinite(k1.float()).all()), f"{name}: non-finite")
            check(err <= lim, f"{name}: {err} vs {lim}")
            check(same, f"{name}: two runs differ")
            del k1, k2, ref
        del cases
    torch.cuda.empty_cache()


def tool_wrappers(fb, fq, c, sm, sc, bi, bf):
    """(module, name, plain version) of each kernel wrapper the experiment
    chains launch; each plain version takes its wrapper's arguments."""
    def gemm_ref(a, w):
        return fb._mm(a, w).to(a.dtype)

    def attn_i8_ref(q8, v, n, s, nh, scale=bi.SCALE,
                    out_dtype=torch.bfloat16):
        return bi.core_i8_ref(q8, v, n, s, nh, out_dtype, scale)

    return [(fb, "ln_gemm", fb._ln_gemm_ref), (fb, "mhsa", fb._mhsa_ref),
            (fb, "gemm_residual", fb._gemm_residual_ref),
            (c, "gemm", gemm_ref), (sm, "attn_variant", sm.core_ref),
            (sc, "attn_variant", sm.core_ref),
            (sc, "attn_split_cls", sc.split_ref),
            (bi, "attn_i8", attn_i8_ref),
            (fq, "ln_gemm_i8", fq._ln_gemm_i8_ref),
            (fq, "quant_rows", fq._quant_rows_ref),
            (fq, "gemm_i8_residual", fq._gemm_i8_residual_ref),
            (bf, "block_tail", bf.block_tail_ref)]


class StandIn:
    """Takes a kernel wrapper's module name: calls `fn`, and forwards every
    attribute to the wrapper (which bumps its launch counts through that
    name)."""

    def __init__(self, wrapper, fn):
        object.__setattr__(self, "_wrapper", wrapper)
        object.__setattr__(self, "_fn", fn)

    def __call__(self, *args, **kw):
        return self._fn(*args, **kw)

    def __getattr__(self, name):
        return getattr(self._wrapper, name)

    def __setattr__(self, name, value):
        setattr(self._wrapper, name, value)


@contextlib.contextmanager
def swapped(table, make):
    """Each wrapper of `table` replaced by make(name, wrapper, plain) while
    the block runs (the tools look their wrappers up when they call)."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in table]
    try:
        for (m, n, plain), (_, _, kern) in zip(table, saved):
            setattr(m, n, StandIn(kern, make(n, kern, plain)))
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


class LaunchCheck:
    """Runs each wrapper's kernel and its plain version on the same
    arguments and passes the kernel's result on, so that every launch of a
    chain is held to its plain version on its own inputs: bf16 outputs
    within 2 bf16 ulps at the plain output's largest magnitude, int8 codes
    by phase 31's rule (at most CODE_FRAC of them differing, by one), the
    qkv codes of `ln_gemm_i8` by QKV_CODE_FRAC / QKV_CODE_STEP.
    `stats[name]` = [launches, worst error / limit, max abs error (codes:
    largest step), largest share of differing codes]."""

    def __init__(self):
        self.stats = {}

    def wrap(self, name, kern, plain):
        def run(*args, **kw):
            k, p = kern(*args, **kw), plain(*args, **kw)
            self.compare(name, k, p)
            return k
        return run

    def compare(self, name, kern, plain):
        st = self.stats.setdefault(name, [0, 0.0, 0.0, 0.0])
        st[0] += 1
        kern = kern if isinstance(kern, tuple) else (kern,)
        plain = plain if isinstance(plain, tuple) else (plain,)
        for k, p in zip(kern, plain):
            check(tuple(k.shape) == tuple(p.shape) and k.dtype == p.dtype,
                  f"{name}: {tuple(k.shape)} {k.dtype} != {tuple(p.shape)} "
                  f"{p.dtype}")
            if k.dtype == torch.int8:
                _, top, frac = code_diff(k, p)
                step, share = ((QKV_CODE_STEP, QKV_CODE_FRAC)
                               if name == "ln_gemm_i8" else (1, CODE_FRAC))
                ratio, err = max(top / step, frac / share), float(top)
                st[3] = max(st[3], frac)
            else:
                check(bool(torch.isfinite(k.float()).all()),
                      f"{name}: non-finite")
                scale = p.float().abs().max().item()
                err = (k.float() - p.float()).abs().max().item()
                ratio = err / (2 * ulp_bf16(scale))
            st[1], st[2] = max(st[1], ratio), max(st[2], err)


def p_ulps(pk, pref, d):
    """E's P against the plain P on the same qkv: the largest error in
    bf16 ulps over its elements, each taking the plain p at d = bf16(s - m)
    or at the bf16 step either side of it (the f32 scores, summed in
    another order, can move s - m across a bf16 rounding boundary); and how
    many elements needed a neighbouring step. Where the plain p lies below
    the smallest normal f32, the card's p (ex2.approx.ftz flushes) must lie
    there too."""
    tiny = 2.0 ** -126
    pk = pk.float()
    bits = d.to(torch.bfloat16).view(torch.int16)
    cands = [pref.float()] + [
        torch.exp2((bits + step).view(torch.bfloat16).float())
        .to(torch.bfloat16).float() for step in (-1, 1)]
    errs = []
    for ref in cands:
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(tiny)))
                         - 7)
        e = (pk - ref).abs() / ulp
        errs.append(torch.where((ref < tiny) & (pk < tiny),
                                torch.zeros_like(e), e))
    worst = torch.fmin(errs[0], torch.fmin(errs[1], errs[2]))
    return worst.max().item(), int(((errs[0] > 1) & (worst <= 1)).sum())


def tools_phases(tag, dev):
    """Phases 38-39: each tools/ experiment's kernels and chains at the
    tool's shapes against their plain versions (38), then their times
    (39). Returns the kernels line's entries for the new kernels."""
    from mst_tpu_torch.ops import fused_block as fb
    from mst_tpu_torch.ops import fused_int8 as fq
    from mst_tpu_torch.tools import _common as c
    from mst_tpu_torch.tools import bench_attn_i8 as bi
    from mst_tpu_torch.tools import bench_attn_softmax as sm
    from mst_tpu_torch.tools import bench_attn_split_cls as sc
    from mst_tpu_torch.tools import bench_block_fusion as bf
    from mst_tpu_torch.tools import debug_attn_i8 as dbg

    bf16 = torch.bfloat16
    table = tool_wrappers(fb, fq, c, sm, sc, bi, bf)

    def plain_mode(name, kern, plain):
        return plain

    # -- 38. kernels and chains vs plain ---------------------------------
    stamp(tag, "38")
    print(f"{tag} tools: every launch of each experiment chain is held to "
          f"its plain version on that launch's own inputs (bf16 within 2 "
          f"bf16 ulps of the plain output's largest magnitude, int8 codes "
          f"differing in at most {CODE_FRAC} of them, by one, the qkv codes "
          f"of ln_gemm_i8 in {QKV_CODE_FRAC}, by up to {QKV_CODE_STEP}); the "
          f"chain "
          f"is run again for the same bits, and its end-to-end distance "
          f"from the plain chain is printed (it compounds over the layers: "
          f"no LN in row 18, one-hot softmax rows in row 19)")
    tools_attn_phase(tag, dev, fb, sm, bi)
    tools_rest_phase(tag, dev, sc, bf)
    counts, stats = {}, {}

    def drive(label, fn, want):
        """The chain `fn` (an experiment's main path): launch counts read
        around a run in which every launch is checked, then the same bits
        again and the plain chain's distance."""
        checker = LaunchCheck()
        fb.reset_launch_counts()
        with torch.inference_mode(), swapped(table, checker.wrap):
            out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in fb.launch_counts().items() if v}
        with torch.inference_mode():
            again = fn()
            with swapped(table, plain_mode):
                ref = fn()
        torch.cuda.synchronize()
        drift = ((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max()).item()
        for name, (n_, ratio, err, frac) in sorted(checker.stats.items()):
            print(f"{tag} {label} {name}: {n_} launches, worst error / limit "
                  f"{ratio:.4g}, max_abs_err {err:.6g}"
                  + (f", codes differing {frac:.3g}" if frac else ""))
            check(ratio <= 1.0, f"{label} {name}: error / limit {ratio}")
        print(f"{tag} {label}: launches {got}; bit for bit on repeat "
              f"{torch.equal(out, again)}; end-to-end max|chain - plain "
              f"chain| / |plain|max = {drift:.4g}")
        check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite")
        check(torch.equal(out, again), f"{label}: not bit for bit")
        check_launches(got, want, label)
        counts[label], stats[label] = got, checker.stats
        return out

    def one(label, kern, plain, fault=False):
        """One launch against its plain version; a planted fault must break
        the 2-ulp limit."""
        with torch.inference_mode():
            k, p = kern(), plain()
        torch.cuda.synchronize()
        scale = p.float().abs().max().item()
        err = (k.float() - p.float()).abs().max().item()
        lim = 2 * ulp_bf16(scale)
        print(f"{tag} {label}: max_abs_err={err:.6g} limit={lim:.6g} "
              f"(|plain|max={scale:.6g}, error / |plain|max {err / scale:.3g})"
              + (" (planted fault: must break the limit)" if fault else ""))
        check(err > lim if fault else err <= lim, f"{label}: {err} vs {lim}")

    # row 18: softmax forms, N = 128, S = 257, 12 layers
    x18, wqkv18, wproj18 = sm.inputs(dev, sm.N, sm.S, sm.E)
    m18 = sm.N * sm.S
    qkv18 = c.gemm(x18.reshape(m18, sm.E), wqkv18)
    for v in sm.VARIANTS:
        drive(f"18 softmax {v}",
              functools.partial(sm.chain, x18, wqkv18, wproj18, sm.H, v,
                                sm.DEPTH),
              {"gemm": sm.DEPTH, "attn_variant": sm.DEPTH,
               "gemm_residual": sm.DEPTH})
        with torch.inference_mode():
            o, pk = sm.attn_variant(qkv18, sm.N, sm.S, sm.H, v, want_p=True)
            o2 = sm.attn_variant(qkv18, sm.N, sm.S, sm.H, v)
            ref, pref = sm.core_ref(qkv18, sm.N, sm.S, sm.H, v, want_p=True)
        torch.cuda.synchronize()
        check(torch.equal(o, o2), f"variant {v}: p_out changes o")
        one(f"attn_variant[{v}] at [{sm.N}, {sm.S}]", lambda: o, lambda: ref)
        if v == "D":
            # D kept the math of the WMMA `mhsa`; the shipped kernel (now
            # TMA + wgmma) sums in another order, so both are held to the
            # same plain version under the kernel limit
            ref_d = fb._mhsa_ref(qkv18, sm.N, sm.S, sm.H)
            shipped = fb.mhsa(qkv18, sm.N, sm.S, sm.H)
            torch.cuda.synchronize()
            check_outputs(tag, "attn_variant[D] vs the plain mhsa", o, ref_d,
                          KERNEL_GRAD_REL)
            check_outputs(tag, "mhsa vs the same plain mhsa", shipped, ref_d,
                          KERNEL_GRAD_REL)
            del ref_d, shipped
        if v == "E":
            qh, kh, _ = c.head_views(qkv18, sm.N, sm.S, 3, sm.H)
            s_ = fb._mm(qh, kh.transpose(-1, -2)) * sm.scale_of("E")
            worst, moved = p_ulps(pk, pref, s_ - s_.amax(-1, keepdim=True))
            del s_
            print(f"{tag} attn_variant[E] P (h2exp2 of bf16(s - m)) vs plain "
                  f"bf16(exp2(f32 d)): worst {worst:.4g} bf16 ulps (limit "
                  f"1), {moved} of {pk.numel()} elements at a d one bf16 "
                  f"step from the plain d")
            check(worst <= 1.0, f"variant E P: {worst} ulps")
        del o, o2, pk, ref, pref
    one("planted fault: attn_variant[D] with the scale 1.25x",
        lambda: sm.attn_variant(qkv18, sm.N, sm.S, sm.H, "D",
                                scale=1.25 * sm.scale_of("D")),
        lambda: sm.core_ref(qkv18, sm.N, sm.S, sm.H, "D"), fault=True)
    one("planted fault: gemm with W's columns rolled by one",
        lambda: c.gemm(x18.reshape(m18, sm.E), wqkv18.roll(1, 1)),
        lambda: fb._mm(x18.reshape(m18, sm.E), wqkv18).to(bf16), fault=True)
    # row 21: split-CLS, 12 cores on the same qkv
    qkv21 = sc.inputs(dev, sc.N, sc.S, sc.E)
    for layout, kern in (("base", "attn_variant"), ("split", "attn_split_cls")):
        drive(f"21 {layout}", functools.partial(sc.chain, qkv21, layout, sc.N,
                                                 sc.S, sc.H, sc.DEPTH),
              {kern: sc.DEPTH})
    one("planted fault: attn_split_cls with the scale 1.25x",
        lambda: sc.attn_split_cls(qkv21, sc.N, sc.S, sc.H, 1.25 * sc.SCALE),
        lambda: sc.split_ref(qkv21, sc.N, sc.S, sc.H), fault=True)
    # rows 19-20: int8 attention, 24 damped layers at the tool's three shapes
    i8 = {}
    for label, n, s, e, nh in bi.SHAPES:
        p19 = bi.params(dev, *bi.weights(e))
        x19 = bi.inputs(dev, n, s, e)
        i8[label] = (n, s, e, nh, p19, x19)
        for v in bi.VARIANTS:
            want = {"ln_gemm_i8": bi.DEPTH * (2 if v == "B" else 1),
                    "quant_rows": bi.DEPTH, "gemm_i8_residual": bi.DEPTH,
                    "mhsa" if v == "A" else "attn_i8": bi.DEPTH}
            drive(f"19 {label.split(' (')[0]} {v}",
                  functools.partial(bi.chain, x19, p19, nh, v, bi.DEPTH),
                  want)
    n, s, e, nh, p19, x19 = i8[bi.SHAPES[0][0]]
    x2 = x19.reshape(n * s, e)
    for v, dense in (("B", p19.qk), ("C", p19.qkv)):
        q8 = bi._ln_i8(x2, p19, dense, True)
        v8 = bi._ln_i8(x2, p19, p19.v, False) if v == "B" else None
        one(f"planted fault: attn_i8[{v}] with the scale 1.25x",
            lambda: bi.attn_i8(q8, v8, n, s, nh, 1.25 * bi.SCALE),
            lambda: bi.core_i8_ref(q8, v8, n, s, nh, bf16), fault=True)
    del q8, v8
    with torch.inference_mode():
        planted = fq.ln_gemm_i8(x2, p19.ln_s, p19.ln_b, p19.qkv.q8,
                                p19.qkv.scale, p19.qkv.bias, fb.ACT_NONE,
                                bi.EPS, static=True, a_inv=1.01 * p19.one,
                                q8t=p19.qkv.q8t)
        _, top, frac = code_diff(planted, bi._ln_i8(x2, p19, p19.qkv, True))
    print(f"{tag} planted fault: ln_gemm_i8 qkv codes with a unit scale of "
          f"1.01: codes differing {frac:.4g} (limit {QKV_CODE_FRAC}), by up "
          f"to {top} (limit {QKV_CODE_STEP}); must break a limit")
    check(frac > QKV_CODE_FRAC or top > QKV_CODE_STEP, "qkv-code fault")
    del planted, x2
    dn, ds, de, dh = dbg.N, dbg.S, dbg.E, dbg.H
    pd = bi.params(dev, *bi.weights(de))
    xd = bi.inputs(dev, dn, ds, de)
    with torch.inference_mode():
        mirror = dbg.plain_mirror(xd, pd, dh)
        rels = {v: dbg.rel_err(bi.sublayer(xd, pd, dh, v), mirror)
                for v in bi.VARIANTS}
    print(f"{tag} 20 debug_attn_i8 at [{dn}, {ds}, {de}]: rel|out - plain "
          f"mirror (f32 softmax)| {rels}")
    check(all(math.isfinite(r) for r in rels.values()), "row 20 non-finite")
    drive("20 production bf16", functools.partial(dbg.production, xd, pd, dh, dbg.DEPTH),
          {"ln_gemm": dbg.DEPTH, "mhsa": dbg.DEPTH,
           "gemm_residual": dbg.DEPTH})
    # row 17: 12 blocks, split (5 launches a block) and block (3)
    p17, x17 = bf.params(dev, bf.E), bf.inputs(dev, bf.N, bf.S, bf.E)
    d17 = bf.DEPTH
    for layout, want in (("split", {"ln_gemm": 2 * d17, "mhsa": d17,
                                    "gemm_residual": 2 * d17}),
                         ("block", {"ln_gemm": d17, "mhsa": d17,
                                    "block_tail": d17})):
        drive(f"17 {layout}", functools.partial(
            bf.chain, x17, p17, layout, bf.DEPTH, bf.H), want)
        with torch.inference_mode():
            one1 = bf.chain(x17, p17, layout, 1, bf.H)
            ref1 = bf.chain(x17, p17, "plain", 1, bf.H)
        one(f"17 {layout}: one block vs the tool's plain block "
            f"(`_mlp_half` rounds fc1 + b1 before the GELU)", lambda: one1,
            lambda: ref1)
    m17 = bf.N * bf.S
    with torch.inference_mode():
        xq = x17.reshape(m17, bf.E)
        o17 = fb.mhsa(fb.ln_gemm(xq, p17.ln1s, p17.ln1b, p17.wqkv, p17.bqkv,
                                 fb.ACT_NONE, bf.EPS), bf.N, bf.S, bf.H)
    tail_args = (o17, xq, p17.wproj, p17.bproj, p17.ln2s, p17.ln2b, p17.w1,
                 p17.b1, p17.w2, p17.b2)
    one("planted fault: block_tail with LN2 eps 0.1",
        lambda: bf.block_tail(*tail_args, eps=0.1),
        lambda: bf.block_tail_ref(*tail_args), fault=True)

    # -- 39. times -----------------------------------------------------------
    stamp(tag, "39")
    mains = {"18": sm.main(), "21": sc.main(), "19": bi.main(),
             "20": dbg.main(), "17": bf.main()}
    heads18 = c.head_views(qkv18, sm.N, sm.S, 3, sm.H)
    n, s, e, nh, p19, x19 = i8[bi.SHAPES[0][0]]
    x2 = x19.reshape(n * s, e)
    q8b, v8 = bi._ln_i8(x2, p19, p19.qk, True), bi._ln_i8(x2, p19, p19.v, False)
    q8c = bi._ln_i8(x2, p19, p19.qkv, True)
    hq_b = [u.to(bf16) for u in c.head_views(q8b, n, s, 2, nh)]
    hv_b = c.head_views(v8, n, s, 1, nh)[0]
    hq_c = [u.to(bf16) for u in c.head_views(q8c, n, s, 3, nh)]
    mi = n * s
    core_ops = 2 * n * nh * s * s * 64  # one product of the i8 cores
    cases = {
        # name: (kernel thunk, plain thunk, (FLOPs, bytes[, int8 ops]),
        #        library thunk or None)
        "gemm[qkv]": (lambda: c.gemm(x18.reshape(m18, sm.E), wqkv18),
                      lambda: fb._mm(x18.reshape(m18, sm.E), wqkv18).to(bf16),
                      mm_cost(m18, sm.E, 3 * sm.E),
                      lambda: torch.matmul(x18.reshape(m18, sm.E), wqkv18)),
        "attn_split_cls": (
            lambda: sc.attn_split_cls(qkv21, sc.N, sc.S, sc.H),
            lambda: sc.split_ref(qkv21, sc.N, sc.S, sc.H),
            attn_cost(sc.N, sc.S, heads=sc.H),
            functools.partial(F.scaled_dot_product_attention,
                              *c.head_views(qkv21, sc.N, sc.S, 3, sc.H))),
        "attn_i8[B]": (
            lambda: bi.attn_i8(q8b, v8, n, s, nh),
            lambda: bi.core_i8_ref(q8b, v8, n, s, nh, bf16),
            (core_ops, mi * 2 * e + 2 * mi * e + 2 * mi * e, core_ops),
            functools.partial(F.scaled_dot_product_attention, *hq_b, hv_b,
                              scale=1 / 8)),
        "attn_i8[C]": (
            lambda: bi.attn_i8(q8c, None, n, s, nh),
            lambda: bi.core_i8_ref(q8c, None, n, s, nh, bf16),
            (0, mi * 3 * e + 2 * mi * e, 2 * core_ops),
            functools.partial(F.scaled_dot_product_attention, *hq_c,
                              scale=1 / 8)),
    }
    for v in sm.VARIANTS:
        cases[f"attn_variant[{v}]"] = (
            functools.partial(sm.attn_variant, qkv18, sm.N, sm.S, sm.H, v),
            functools.partial(sm.core_ref, qkv18, sm.N, sm.S, sm.H, v),
            attn_cost(sm.N, sm.S, heads=sm.H),
            functools.partial(F.scaled_dot_product_attention, *heads18))
    # row 19's cores at DINOv3's S = 201 and giant2's shape, on the codes
    # their chains make
    for label, key in ((bi.SHAPES[1][0], "S=201"), (bi.SHAPES[2][0], "giant2")):
        n_, s_, e_, nh_, p_, x_ = i8[label]
        xs = x_.reshape(n_ * s_, e_)
        qb_, vb_ = bi._ln_i8(xs, p_, p_.qk, True), bi._ln_i8(xs, p_, p_.v, False)
        qc_ = bi._ln_i8(xs, p_, p_.qkv, True)
        ops_, m_ = 2 * n_ * nh_ * s_ * s_ * 64, n_ * s_
        hb_ = [u.to(bf16) for u in c.head_views(qb_, n_, s_, 2, nh_)]
        hc_ = [u.to(bf16) for u in c.head_views(qc_, n_, s_, 3, nh_)]
        cases[f"attn_i8[B,{key}]"] = (
            functools.partial(bi.attn_i8, qb_, vb_, n_, s_, nh_),
            functools.partial(bi.core_i8_ref, qb_, vb_, n_, s_, nh_, bf16),
            (ops_, m_ * 2 * e_ + 2 * m_ * e_ + 2 * m_ * e_, ops_),
            functools.partial(F.scaled_dot_product_attention, *hb_,
                              c.head_views(vb_, n_, s_, 1, nh_)[0],
                              scale=1 / 8))
        cases[f"attn_i8[C,{key}]"] = (
            functools.partial(bi.attn_i8, qc_, None, n_, s_, nh_),
            functools.partial(bi.core_i8_ref, qc_, None, n_, s_, nh_, bf16),
            (0, m_ * 3 * e_ + 2 * m_ * e_, 2 * ops_),
            functools.partial(F.scaled_dot_product_attention, *hc_,
                              scale=1 / 8))
    e17, f17 = bf.E, bf.FF
    ln2 = (p17.ln2s, p17.ln2b)

    def tail_library():
        x1 = torch.addmm(xq, o17, p17.wproj)
        h = F.layer_norm(x1, (e17,), *[t.to(bf16) for t in ln2], bf.EPS)
        a = F.gelu(torch.matmul(h, p17.w1), approximate="tanh")
        return torch.addmm(x1, a, p17.w2)

    cases["block_tail"] = (
        lambda: bf.block_tail(*tail_args), lambda: bf.block_tail_ref(*tail_args),
        (2 * m17 * (e17 * e17 + 2 * e17 * f17),
         3 * 2 * m17 * e17 + 2 * (e17 * e17 + 2 * e17 * f17)
         + 4 * (3 * e17 + f17)),
        tail_library)
    times = {}
    with torch.inference_mode():
        for name, (kern, plain, cost_, lib) in cases.items():
            km, pm_ = time_ms(kern), time_ms(plain, n=5, warmup=1)
            lm = time_ms(lib) if lib is not None else None
            b_ms, b_by = bound([cost_])
            times[name] = (km, pm_, b_ms, b_by, lm)
            ops = cost_[0] + (cost_[2] if len(cost_) > 2 else 0)
            # the redesigned kernels also replayed from a CUDA graph, kernel
            # and library alike: per-call events hold the wrapper's host time
            redesigned = name.startswith(("attn_variant", "attn_i8",
                                          "attn_split_cls", "block_tail"))
            gm, gl = ((graph_ms(kern), graph_ms(lib)) if redesigned
                      else (None, None))
            old = WMMA_TOOLS_MS.get(name)
            print(f"{tag} time {name}: kernel {km:.4f} ms ({ops / km / 1e9:.2f}"
                  f" T product operations/s), plain {pm_:.4f} ms,"
                  f" bound {b_ms:.4f} ms by {b_by}, library "
                  + (f"{lm:.4f} ms" if lm is not None else "none")
                  + (f" ({km / lm:.3f}x)" if lm else "")
                  + (f"; replayed from a CUDA graph: kernel {gm:.4f} ms, "
                     f"library {gl:.4f} ms ({gm / gl:.3f}x)" if gm else "")
                  + (f"; the WMMA kernel {old} ms (PERF.md §6, not re-timed;"
                     f" {old / km:.2f}x)" if old else ""))
    # the chains' plain and library times, and bounds (PERF.md row table)
    chain_cost18 = [mm_cost(m18, sm.E, 3 * sm.E),
                    attn_cost(sm.N, sm.S, heads=sm.H),
                    mm_cost(m18, sm.E, sm.E, 2 * m18 * sm.E)]
    with torch.inference_mode(), swapped(table, plain_mode):
        plain_chain = {
            "18": time_ms(functools.partial(sm.chain, x18, wqkv18, wproj18,
                                            sm.H, "D", sm.DEPTH), n=3,
                          warmup=1),
            "21": time_ms(functools.partial(sc.chain, qkv21, "split", sc.N,
                                            sc.S, sc.H, sc.DEPTH), n=3,
                          warmup=1),
            "19": time_ms(functools.partial(bi.chain, x19, p19, nh, "C",
                                            bi.DEPTH), n=3, warmup=1),
            "17": time_ms(functools.partial(bf.chain, x17, p17, "block",
                                            bf.DEPTH, bf.H), n=3, warmup=1)}
    lib18 = time_ms(lambda: torch.addmm(
        x18.reshape(m18, sm.E), c.merge_heads(F.scaled_dot_product_attention(
            *c.head_views(torch.matmul(x18.reshape(m18, sm.E), wqkv18), sm.N,
                          sm.S, 3, sm.H)), sm.N, sm.S), wproj18)) * sm.DEPTH
    b18, by18 = bound(chain_cost18 * sm.DEPTH)
    print(f"{tag} row 18 chains ({sm.DEPTH} layers at [{sm.N}, {sm.S}, "
          f"{sm.E}]): kernels {mains['18']} ms; plain (D) {plain_chain['18']:.4f}"
          f" ms; bound {b18:.4f} ms by {by18}; library {lib18:.4f} ms "
          f"({sm.DEPTH} x matmul + SDPA + addmm)")
    b21, by21 = bound([attn_cost(sc.N, sc.S, heads=sc.H)] * sc.DEPTH)
    print(f"{tag} row 21 chains ({sc.DEPTH} cores): kernels {mains['21']} ms;"
          f" plain (split) {plain_chain['21']:.4f} ms; bound {b21:.4f} ms by "
          f"{by21}; library {sc.DEPTH * times['attn_split_cls'][4]:.4f} ms "
          f"({sc.DEPTH} x SDPA)")
    def lib19():
        """One static int8 sub-layer in torch ops around `torch._int_mm`."""
        h = F.layer_norm(x2.float(), (e,), p19.ln_s, p19.ln_b, bi.EPS)
        q = torch.clamp(torch.round(h), -127, 127).to(torch.int8)
        t = (torch._int_mm(q, p19.qkv.q8).float() * p19.qkv.scale
             + p19.qkv.bias).to(bf16)
        o = c.merge_heads(F.scaled_dot_product_attention(
            *c.head_views(t, n, s, 3, nh)), n, s)
        oq = torch.clamp(torch.round(o.float()), -127, 127).to(torch.int8)
        y = torch._int_mm(oq, p19.proj.q8).float() * p19.proj.scale
        return (x2.float() + y + p19.proj.bias).to(bf16)

    with torch.inference_mode():
        lib19_ms = time_ms(lib19) * bi.DEPTH
    b19, by19 = bound([(0, 2 * mi * e + 3 * e * e, 2 * mi * e * 3 * e),
                       (core_ops, 2 * mi * 4 * e, core_ops),
                       (0, 2 * mi * e + e * e + 2 * mi * e,
                        2 * mi * e * e)] * bi.DEPTH)
    chains19 = {f"{k[0].split(' (')[0]} {k[1]}": round(v, 4)
                for k, v in mains["19"].items()}
    print(f"{tag} row 19 chains ({bi.DEPTH} layers): kernels {chains19} ms; "
          f"plain (ViT-S, C) {plain_chain['19']:.4f} ms; bound (ViT-S, "
          f"A-B) {b19:.4f} ms by {by19}; library (ViT-S) {lib19_ms:.4f} ms "
          f"({bi.DEPTH} x LN + quantization + _int_mm + SDPA + _int_mm); "
          f"row 20 {mains['20']}")
    row20_yardsticks(tag, dev, dbg.N, dbg.S, dbg.E, dbg.H, dbg.DEPTH, bi.EPS)
    def lib17():
        """One block in torch ops: LN + matmul, SDPA, then the tail's."""
        h = F.layer_norm(xq, (e17,), p17.ln1s.to(bf16), p17.ln1b.to(bf16),
                         bf.EPS)
        t = torch.matmul(h, p17.wqkv)
        o = c.merge_heads(F.scaled_dot_product_attention(
            *c.head_views(t, bf.N, bf.S, 3, bf.H)), bf.N, bf.S)
        x1 = torch.addmm(xq, o, p17.wproj)
        h = F.layer_norm(x1, (e17,), *[t.to(bf16) for t in ln2], bf.EPS)
        return torch.addmm(x1, F.gelu(torch.matmul(h, p17.w1),
                                      approximate="tanh"), p17.w2)

    with torch.inference_mode():
        lib17_ms = time_ms(lib17) * bf.DEPTH
    b17, by17 = bound([mm_cost(m17, e17, 3 * e17, 4 * 5 * e17),
                       attn_cost(bf.N, bf.S, heads=bf.H),
                       cases["block_tail"][2]] * bf.DEPTH)
    print(f"{tag} row 17 chains ({bf.DEPTH} blocks): kernels {mains['17']} ms;"
          f" plain (block) {plain_chain['17']:.4f} ms; bound {b17:.4f} ms by "
          f"{by17}; library {lib17_ms:.4f} ms ({bf.DEPTH} x LN + matmul + "
          f"SDPA + addmm + LN + matmul + GELU + addmm)")

    # the kernels line's entries: launches from the chains above (each
    # chain's run between a reset and a read of the counts)
    def launches(prefix, name):
        return sum(counts[k].get(name, 0) for k in counts
                   if k.startswith(prefix))

    def max_err(prefix, name):
        return max(st[name][2] for k, st in stats.items()
                   if k.startswith(prefix) and name in st)

    also = "tools/bench_attn_split_cls.py:{}".format
    rows = [(f"attn_variant_{v}", "attn_variants",
             ["tools/bench_attn_softmax.py:34"], f"18 softmax {v}",
             "attn_variant", f"attn_variant[{v}]") for v in sm.VARIANTS]
    rows += [
        ("attn_split_cls", "attn_variants", [also(104), also(64)], "21 split",
         "attn_split_cls", "attn_split_cls"),
        ("attn_i8_B", "attn_i8", ["tools/bench_attn_i8.py:57",
                                  "tools/debug_attn_i8.py:53"], "19 ",
         "attn_i8", "attn_i8[B]"),
        ("attn_i8_C", "attn_i8", ["tools/bench_attn_i8.py:57",
                                  "tools/debug_attn_i8.py:53"], "19 ",
         "attn_i8", "attn_i8[C]"),
        ("block_tail", "block_tail", ["tools/bench_block_fusion.py:75",
                                      "tools/bench_block_fusion.py:67",
                                      "tools/bench_block_fusion.py:71"],
         "17 block", "block_tail", "block_tail"),
        ("gemm_no_residual", "gemm_residual",
         ["tools/bench_attn_softmax.py:34"], "18 softmax", "gemm",
         "gemm[qkv]"),
    ]
    entries = []
    for name, source, replaces, chain_label, wrapper, case in rows:
        if name.startswith("attn_i8_"):  # B's and C's chains, all shapes
            v = name[-1]
            n_ = sum(counts[k].get(wrapper, 0) for k in counts
                     if k.startswith("19 ") and k.endswith(f" {v}"))
            err = max(st[wrapper][2] for k, st in stats.items()
                      if k.startswith("19 ") and k.endswith(f" {v}"))
        else:
            n_, err = (launches(chain_label, wrapper),
                       max_err(chain_label, wrapper))
        km, pm_, b_ms, b_by, lm = times[case]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"mst_tpu_torch/csrc/{source}.cu",
            "replaces": replaces[0], "also_replaces": replaces[1:],
            "launches": n_, "max_abs_err": err, "ms": km, "plain_ms": pm_,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lm})
    return entries


def row20_yardsticks(tag, dev, n, s, e, h, depth, eps) -> None:
    """Row 20 (`tools/debug_attn_i8.py:53`, no kernel of its own) times
    `depth` damped layers of the production bf16 attention sub-layer and of
    `bench_attn_i8`'s variant A at [n, s, e] (its `main`). Their bounds, each
    kernel's work counted as rows 1 and 19 count it, and the library calls
    for the bf16 chain's work (LN + addmm + SDPA + addmm a layer, in bf16);
    variant A has none: no PyTorch call computes an int8 attention core."""
    m = n * s
    bf16_chain = [mm_cost(m, e, 3 * e), attn_cost(n, s, heads=h),
                  mm_cost(m, e, e, 2 * m * e)] * depth
    i8_chain = [i8_cost(m, e, 3 * e, a_bytes=2), attn_cost(n, s, heads=h),
                (0, 2 * m * e + m * e + 4 * m),
                i8_cost(m, e, e, extra=2 * m * e)] * depth
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def rand(*shape, scale=0.05):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)
    x0, wq, bq, wp, bp = (rand(n, s, e, scale=1.0), rand(e, 3 * e),
                          rand(3 * e), rand(e, e), rand(e))
    lns, lnb = rand(e) + 1.0, rand(e)

    def library():
        x = x0
        for _ in range(depth):
            t = torch.addmm(bq, F.layer_norm(x, (e,), lns, lnb, eps).reshape(
                m, e), wq).reshape(n, s, 3, h, 64).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(t[0], t[1], t[2])
            x = (x + torch.addmm(bp, o.transpose(1, 2).reshape(m, e),
                                 wp).reshape(n, s, e)) * 0.5
        return x

    with torch.inference_mode():
        lib_ms = time_ms(library)
    (b1, by1), (b2, by2) = bound(bf16_chain), bound(i8_chain)
    print(f"{tag} row 20 chains ({depth} layers at [{n}, {s}, {e}]): bound "
          f"bf16 production {b1:.4f} ms by {by1}, variant A {b2:.4f} ms by "
          f"{by2}; library bf16 {lib_ms:.4f} ms ({depth} x LN + addmm + SDPA "
          f"+ addmm), variant A none (no PyTorch call computes an int8 "
          f"attention core)")


# The kernels of the wgmma sources, and their entries in `-Xptxas -v`:
# source -> {kernel: instances}. Their SASS must hold wgmma and TMA loads;
# those of `gemm_dgrad`, `gemm_wgrad`, `gemm_residual`, `gemm_dls`,
# `mhsa_bwd` and the flash kernels no WMMA / mma.sync HMMA either; the int8
# GEMMs of `ln_gemm_i8.cu` and `gemm_i8_residual.cu` (SASS_I8) the int8
# wgmma (IGMMA) and no IMMA (int8 WMMA / mma.sync) or HGMMA. ptxas must not
# serialize their wgmma ("wgmma.mma_async instructions are serialized": a
# `Potential Performance Loss` line of `-Xptxas -v`).
PTXAS_ENTRIES = {
    "ln_gemm.cu": {"gemm_ln_kernel": 4, "ln_rows_kernel": 5},
    "gemm_dgrad.cu": {"gemm_dgrad_kernel": 4, "ln_pullback_kernel": 6,
                      "ln_pullback_sum_kernel": 1},
    "ln_gemm_i8.cu": {"gemm_i8_kernel": 5, "probe_i8_kernel": 2,
                      "ln_quant_rows_kernel": 5},
    "gemm_i8_residual.cu": {"gemm_i8_residual_kernel": 1},
    "quant_rows.cu": {"quant_rows_ring_kernel": 8},
    "gemm_wgrad.cu": {"gemm_wgrad_kernel": 1, "probe_kernel": 4},
    "gemm_residual.cu": {"gemm_residual_kernel": 4, "gemm_dls_kernel": 1},
    "mhsa.cu": {"mhsa_kernel": 20},
    "mhsa_bwd.cu": {"mhsa_bwd_dq_kernel": 2, "mhsa_bwd_dkv_kernel": 2},
    "flash_fwd.cu": {"flash_fwd_kernel": 1},
    "flash_sal.cu": {"flash_sal_carry_kernel": 2, "flash_sal_abnar_kernel": 1},
    "flash_bwd.cu": {"flash_bwd_dq_kernel": 1, "flash_bwd_dkv_kernel": 1},
    "attn_variants.cu": {"variant_kernel": 10, "split_cls_kernel": 2},
    "attn_i8.cu": {"attn_i8_kernel": 6},
    "block_tail.cu": {"block_tail_kernel": 1},
}
SASS_GEMMS = {"gemm_ln_kernel": 4, "gemm_dgrad_kernel": 4,
              "gemm_wgrad_kernel": 1, "probe_kernel": 4,
              "gemm_residual_kernel": 4, "gemm_dls_kernel": 1,
              "mhsa_kernel": 20, "mhsa_bwd_dq_kernel": 2,
              "mhsa_bwd_dkv_kernel": 2, "flash_fwd_kernel": 1,
              "flash_bwd_dq_kernel": 1, "flash_bwd_dkv_kernel": 1,
              "flash_sal_carry_kernel": 2, "flash_sal_abnar_kernel": 1,
              "block_tail_kernel": 1}
SASS_I8 = {"gemm_i8_kernel": 5, "probe_i8_kernel": 2,
           "gemm_i8_residual_kernel": 1}
# The kernels that stage their rows by bulk copies (1D TMA: UBLKCP; a
# tensor-map load would read UTMALDG), and how many instances each has.
SASS_BULK = {"quant_rows_ring_kernel": 8}
# The tools/ cores of rows 18, 19 and 21 (`variant_kernel<V, TWO>`,
# `attn_i8_kernel<INT8_PV, TWO, P_OUT>`, P_OUT the check's copy of C's
# codes, `split_cls_kernel<TWO>`) and their instances: the scores are wgmma
# on TMA boxes (HGMMA; IGMMA in the int8 one) in every instance; P.V is
# mma.sync where the design puts it, as in `mhsa`: bf16 HMMA in the
# one-pass instances of rows 18 and 21 and of row 19's B, int8 IMMA
# (m16n8k32) in C's; register-A HGMMA in the two-pass ones of rows 18 and
# 21 and B; nothing else. (Row 17's `block_tail_kernel` is in SASS_GEMMS:
# HGMMA and UTMALDG, no HMMA.)
SASS_TOOLS = {"variant_kernel": 10, "attn_i8_kernel": 6,
              "split_cls_kernel": 2}
# mhsa's one-pass instances (template flag TWO false) run P.V by mma.sync
# (HMMA: 17 k steps x 8 n tiles a warp at S = 257); every other instance
# of these kernels has no HMMA.
ONE_PASS_MHSA = "mhsa_kernelILb0E"


def check_machine_code(tag, build_log, build_mod, lib_path) -> None:
    """The compiler's word on the wgmma sources (`PTXAS_ENTRIES`):
    registers and spills of each kernel from `-Xptxas -v` (the build's log,
    or where the library was built before this run a compile of the
    source on its own), and the wgmma and TMA instructions (HGMMA,
    UTMALDG) counted in their SASS (`cuobjdump -sass`). No spills, both
    instructions present, and no HMMA (WMMA / mma.sync) in the backward
    GEMMs, `gemm_residual` / `gemm_dls` and `mhsa_bwd`; in `mhsa` HMMA
    exactly in the one-pass instances (their P.V); in the int8 GEMM and
    its probe the int8 wgmma (IGMMA, its opcodes printed) with UTMALDG and
    no IMMA, HMMA or HGMMA; in `quant_rows` bulk copies (UBLKCP or
    UTMALDG); no "wgmma ... serialized" line for any kernel of these
    sources."""
    entry = r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)"
    for src, want in PTXAS_ENTRIES.items():
        def mine(log):
            return [(n, b) for n, b in re.findall(entry, log, re.S)
                    if any(k in n for k in want) and src.split(".")[0] in n]
        log = build_log
        blocks = mine(log)
        if not blocks:
            print(f"{tag} ptxas: the library was built before this run; "
                  f"compiling {src} on its own for its -Xptxas -v log")
            log = build_mod.ptxas_log(src)
            blocks = mine(log)
        # the line names the function; it also lies in its entry's block
        serial = sorted({ln.strip() for text in [log] + [b for _, b in blocks]
                         for ln in text.splitlines()
                         if "wgmma" in ln and "serializ" in ln
                         and (text is not log or src.split(".")[0] in ln)})
        for ln in serial:
            print(f"{tag} ptxas {src}: {ln[:300]}")
        print(f"{tag} ptxas {src}: {len(serial)} \"wgmma serialized\" lines")
        check(not serial, f"{src}: ptxas serialized wgmma ({len(serial)} "
              f"lines)")
        found = {k: sum(k in n for n, _ in blocks) for k in want}
        check(found == want, f"-Xptxas -v entries of {src}: {found}")
        for name, body in blocks:
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", body)
            stack = re.search(r"(\d+) bytes stack frame", body)
            short = re.search(r"(?:%s)(?:I\w*?E)?(?=E)" % "|".join(want),
                              name)
            print(f"{tag} ptxas {short.group(0) if short else name}: "
                  f"{regs.group(1) if regs else '?'} registers, stack frame "
                  f"{stack.group(1) if stack else '?'} bytes, spill stores / "
                  f"loads {spill.groups() if spill else '?'}")
            check(spill is not None and spill.groups() == ("0", "0"),
                  f"{name}: register spills "
                  f"{spill.groups() if spill else '?'}")
    nvcc = build_mod._nvcc()
    sass = subprocess.run(
        [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(lib_path)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    # the SASS split into (function, body) once for the checks below
    functions = re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass,
                           re.S)
    counts = {k: {} for k in SASS_GEMMS}
    for fn, body in functions:
        for k in SASS_GEMMS:
            if k in fn:
                counts[k][fn] = (body.count("HGMMA"), body.count("UTMALDG"),
                                 body.count("HMMA"))
    for k, fns in counts.items():
        for fn, (hgmma, utmaldg, hmma) in fns.items():
            short = re.search(r"%s(?:I\w*?E)?(?=E)" % k, fn)
            print(f"{tag} SASS {short.group(0) if short else fn}: {hgmma} "
                  f"HGMMA, {utmaldg} UTMALDG, {hmma} HMMA")
            check(hgmma > 0 and utmaldg > 0, f"{fn}: no wgmma or no TMA load")
            if k == "mhsa_kernel":
                check((hmma > 0) == (ONE_PASS_MHSA in fn),
                      f"{fn}: {hmma} HMMA (mma.sync) instructions")
            else:
                check(hmma == 0 or k == "gemm_ln_kernel",
                      f"{fn}: {hmma} HMMA (WMMA / mma.sync) instructions left")
        check(len(fns) == SASS_GEMMS[k], f"{k} instances in SASS: {len(fns)}")
    i8 = {k: {} for k in SASS_I8}
    for fn, body in functions:
        for k in SASS_I8:
            if k in fn:
                i8[k][fn] = body
    for k, fns in i8.items():
        for fn, body in fns.items():
            short = re.search(r"%s(?:I\w*?E)?(?=E)" % k, fn)
            n = {op: body.count(op) for op in ("IGMMA", "UTMALDG", "IMMA",
                                               "HMMA", "HGMMA")}
            ops = sorted(set(re.findall(r"\bIGMMA[.\w]*", body)))
            print(f"{tag} SASS {short.group(0) if short else fn}: "
                  + ", ".join(f"{v} {op}" for op, v in n.items())
                  + f"; opcodes {ops}")
            check(n["IGMMA"] > 0 and n["UTMALDG"] > 0
                  and n["IMMA"] == n["HMMA"] == n["HGMMA"] == 0,
                  f"{fn}: not the int8 wgmma on TMA loads ({n})")
        check(len(fns) == SASS_I8[k], f"{k} instances in SASS: {len(fns)}")
    bulk = {k: {} for k in SASS_BULK}
    for fn, body in functions:
        for k in SASS_BULK:
            if k in fn:
                bulk[k][fn] = {op: body.count(op) for op in ("UBLKCP",
                                                             "UTMALDG")}
    for k, fns in bulk.items():
        for fn, n in fns.items():
            short = re.search(r"%s(?:I\w*?E)?(?=E)" % k, fn)
            print(f"{tag} SASS {short.group(0) if short else fn}: "
                  + ", ".join(f"{v} {op}" for op, v in n.items()))
            check(n["UBLKCP"] + n["UTMALDG"] > 0,
                  f"{fn}: no bulk copy or TMA load ({n})")
        check(len(fns) == SASS_BULK[k], f"{k} instances in SASS: {len(fns)}")
    tools = {k: {} for k in SASS_TOOLS}
    for fn, body in functions:
        for k in SASS_TOOLS:
            if k in fn:
                tools[k][fn] = {op: body.count(op) for op in (
                    "HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")}
    for k, fns in tools.items():
        for fn, n in fns.items():
            args = re.search(k + r"I(.*?)EEv", fn).group(1) + "E"
            # V or INT8_PV, TWO[, P_OUT]; the split core's TWO alone
            flags = re.findall(r"L[bi](\d+)E", args)
            if k == "split_cls_kernel":
                flags = ["0"] + flags
            c8, two = flags[0] == "1", flags[1] == "1"
            print(f"{tag} SASS {k}<{args}>: "
                  + ", ".join(f"{v} {op}" for op, v in n.items()))
            if k in ("variant_kernel", "split_cls_kernel"):
                want = (n["HGMMA"] > 0 and n["IGMMA"] == n["IMMA"] == 0
                        and (n["HMMA"] > 0) != two)
            elif c8:
                want = (n["IGMMA"] > 0 and n["IMMA"] > 0
                        and n["HGMMA"] == n["HMMA"] == 0)
            else:
                want = (n["IGMMA"] > 0 and n["IMMA"] == 0
                        and (n["HMMA"] > 0) != two and (n["HGMMA"] > 0) == two)
            check(want and n["UTMALDG"] > 0,
                  f"{fn}: not its wgmma scores on TMA loads with its P.V ({n})")
        check(len(fns) == SASS_TOOLS[k], f"{k} instances in SASS: {len(fns)}")


def check_tools_attn_geometry(tag, lib) -> None:
    """`bench_attn_softmax.variant_launch` and `bench_attn_i8.i8_launch`
    (the plans the wrappers check and the CPU tests read) against the
    kernels' own, `mst_attn_variant_geometry` and `mst_attn_i8_geometry`,
    at every S from 1 to 512; `bench_attn_split_cls.split_launch` against
    `mst_attn_split_cls_geometry` at every S it takes (the kernel refuses
    the rest), and `bench_block_fusion.block_tail_launch` against
    `mst_block_tail_geometry` at M = 1 .. 200, 771, 32,896 and 65,792 on
    this card's SM count, 132 and 114."""
    from mst_tpu_torch.tools import bench_attn_i8 as bi
    from mst_tpu_torch.tools import bench_attn_softmax as sm
    from mst_tpu_torch.tools import bench_attn_split_cls as sc
    from mst_tpu_torch.tools import bench_block_fusion as bf
    for s in range(1, 513):
        geo = (ctypes.c_int * 7)()
        err = lib.mst_attn_split_cls_geometry(s, geo)
        try:
            g = sc.split_launch(s)
        except ValueError:
            check(err != 0, f"mst_attn_split_cls_geometry takes S={s}")
            continue
        check(err == 0, f"split geometry at S={s}: {err}")
        want = (g.tile, g.tiles, g.tiles_per_block, g.threads, g.passes,
                g.boxes, g.smem)
        check(tuple(geo) == want, f"attn_split_cls geometry at S={s}: "
              f"kernel {tuple(geo)}, mirror {want}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (*range(1, 201), 771, 32_896, 65_792):
        for n_sm in sorted({sms, 132, 114}):
            g, geo = bf.block_tail_launch(m, n_sm), (ctypes.c_int * 9)()
            check(lib.mst_block_tail_geometry(m, n_sm, geo) == 0,
                  f"block_tail geometry at M={m}")
            want = (g.rows, g.units, g.grid, g.threads, g.consumers, g.ring,
                    g.stage, g.unit_stages, g.smem)
            check(tuple(geo) == want, f"block_tail geometry at M={m}, "
                  f"{n_sm} SMs: kernel {tuple(geo)}, mirror {want}")
    print(f"{tag} tools geometry: split_launch equals "
          f"mst_attn_split_cls_geometry at S = 65 .. 385 (others refused by "
          f"both; S = 257: {sc.split_launch(257).smem} bytes); "
          f"block_tail_launch equals mst_block_tail_geometry at M = 1 .. "
          f"65,792 ({bf.block_tail_launch(32_896, sms).grid} CTAs of "
          f"{bf.block_tail_launch(1).threads} threads, "
          f"{bf.block_tail_launch(1).smem} bytes, at M = 32,896 on this "
          f"card's {sms} SMs)")
    for s in range(1, 513):
        g, geo = sm.variant_launch(s), (ctypes.c_int * 8)()
        check(lib.mst_attn_variant_geometry(s, geo) == 0, f"geometry at S={s}")
        want = (g.tile, g.tiles, g.tiles_per_block, g.threads, g.passes,
                g.chunks64, g.tail16, g.smem)
        check(tuple(geo) == want, f"attn_variant geometry at S={s}: kernel "
              f"{tuple(geo)}, mirror {want}")
        for code, v in ((1, "B"), (2, "C")):
            g, geo = bi.i8_launch(s, v), (ctypes.c_int * 9)()
            check(lib.mst_attn_i8_geometry(s, code, geo) == 0,
                  f"geometry at S={s}")
            want = (g.tile, g.tiles, g.tiles_per_block, g.threads, g.passes,
                    g.chunks64, g.tail16, g.vt_ld, g.smem)
            check(tuple(geo) == want, f"attn_i8[{v}] geometry at S={s}: "
                  f"kernel {tuple(geo)}, mirror {want}")
    print(f"{tag} tools attention geometry: variant_launch / i8_launch equal "
          f"mst_attn_variant_geometry / mst_attn_i8_geometry at every S <= "
          f"512 (S = 257: {sm.variant_launch(257).smem} / "
          f"{bi.i8_launch(257, 'B').smem} / {bi.i8_launch(257, 'C').smem} "
          f"bytes of shared memory)")


def check_gemm_geometry(tag, fb, lib) -> None:
    """`fused_block.ln_gemm_launch`, `gemm_dgrad_launch`,
    `gemm_wgrad_launch` and `gemm_residual_launch` (the geometry the CPU
    tests read) against the kernels' own, `mst_gemm_geometry`,
    `mst_dgrad_geometry`, `mst_wgrad_geometry` and `mst_residual_geometry`,
    on this card: tiles or work units, grid, threads, stages, shared memory
    (and the backward GEMMs' splits, rows per split, workspace bytes;
    `gemm_dls`'s rows of partials), at the path's widths and row counts."""
    m_path = N_SLICES * S
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (m_path, *RAGGED_M):
        for k in LN_GEMM_WIDTHS:
            for n, gated in ((3 * k, False), (4 * k, False),
                             (LN_GEMM_F, True)):
                geo = (ctypes.c_int * 5)()
                err = lib.mst_gemm_geometry(m, k, n, int(gated), geo)
                check(err == 0, f"mst_gemm_geometry({m}, {k}, {n}): {err}")
                mine = fb.ln_gemm_launch(m, k, n, gated, sms)
                want = (mine.tiles, mine.grid, mine.threads, mine.stages,
                        mine.smem)
                check(tuple(geo) == want, f"GEMM geometry at [{m}, {k}] -> "
                      f"{n} (gated {gated}): kernel {tuple(geo)}, "
                      f"ln_gemm_launch {want}")
    geo = fb.ln_gemm_launch(m_path, 1536, LN_GEMM_F, True, sms)
    print(f"{tag} GEMM geometry: ln_gemm_launch equals the kernel's "
          f"mst_gemm_geometry at K = {LN_GEMM_WIDTHS}, M = {m_path} and "
          f"{RAGGED_M} on {sms} SMs (giant2 w12: {geo.tiles} tiles on "
          f"{geo.grid} CTAs of {geo.threads} threads, {geo.stages} stages, "
          f"{geo.smem} bytes of shared memory)")
    # the backward GEMMs: every product of the paths at every row count
    f_ = LN_GEMM_F
    for m in BWD_M:
        for e in LN_GEMM_WIDTHS:
            # (K, N) of a [m, K]^T @ b [m, N]: proj, qkv, fc2, fc1 (and
            # giant2's w3, w12); dgrad (R, K) of dy [m, R] @ w [K, R]^T
            shapes = [(e, e), (e, 3 * e), (4 * e, e), (e, 4 * e)]
            if e == LN_GEMM_WIDTHS[-1]:
                shapes += [(f_, e), (e, 2 * f_)]
            for k, n in shapes:
                for name, fn, mine in (
                        ("mst_wgrad_geometry", lib.mst_wgrad_geometry,
                         fb.gemm_wgrad_launch(m, k, n, sms)),
                        ("mst_dgrad_geometry", lib.mst_dgrad_geometry,
                         fb.gemm_dgrad_launch(m, n, k, sms))):
                    geo = (ctypes.c_longlong * 8)()
                    err = fn(m, k, n, geo) if "wgrad" in name else fn(
                        m, n, k, geo)
                    check(err == 0, f"{name} at M={m}, {k} x {n}: {err}")
                    want = (mine.units, mine.grid, mine.threads, mine.stages,
                            mine.smem, mine.splits, mine.rows, mine.workspace)
                    check(tuple(geo) == want, f"{name} at M={m}, {k} x {n}: "
                          f"kernel {tuple(geo)}, mirror {want}")
    w12 = fb.gemm_wgrad_launch(m_path, 1536, 2 * f_, sms)
    proj = fb.gemm_wgrad_launch(m_path, 384, 384, sms)
    print(f"{tag} GEMM geometry: gemm_dgrad_launch / gemm_wgrad_launch equal "
          f"the kernels' mst_dgrad_geometry / mst_wgrad_geometry at K = "
          f"{LN_GEMM_WIDTHS}, M = {BWD_M} on {sms} SMs (giant2 w12 wgrad: "
          f"{w12.units} units of {w12.rows} rows, {w12.splits} splits, "
          f"{w12.workspace} bytes of workspace; ViT-S proj: {proj.units} "
          f"units, {proj.splits} splits of {proj.rows} rows)")
    # gemm_residual / gemm_dls: proj and fc2 (giant2: w3) at every width
    for m in RES_M:
        for e in LN_GEMM_WIDTHS:
            for k in (e, f_ if e == LN_GEMM_WIDTHS[-1] else 4 * e):
                geo = (ctypes.c_int * 6)()
                err = lib.mst_residual_geometry(m, k, e, geo)
                check(err == 0, f"mst_residual_geometry({m}, {k}, {e}): {err}")
                mine = fb.gemm_residual_launch(m, k, e, sms)
                want = (mine.tiles, mine.grid, mine.threads, mine.stages,
                        mine.smem, mine.work_rows)
                check(tuple(geo) == want, f"mst_residual_geometry at M={m}, "
                      f"{k} x {e}: kernel {tuple(geo)}, mirror {want}")
    w3 = fb.gemm_residual_launch(m_path, f_, 1536, sms)
    print(f"{tag} GEMM geometry: gemm_residual_launch equals the kernels' "
          f"mst_residual_geometry at K x N = E x E, 4E x E (giant2 {f_} x "
          f"1536), E = {LN_GEMM_WIDTHS}, M = {RES_M} on {sms} SMs (giant2 "
          f"w3: {w3.tiles} tiles on {w3.grid} CTAs, {w3.work_rows} rows of "
          f"dls partials)")
    # the int8 GEMM: qkv and fc1 at every width, giant2's w12 (gated)
    from mst_tpu_torch.ops import fused_int8 as fq

    for m in (*BWD_M, 1):
        for e in LN_GEMM_WIDTHS:
            for n, gated in ((3 * e, False), (4 * e, False), (f_, True)):
                geo = (ctypes.c_int * 8)()
                err = lib.mst_gemm_i8_geometry(m, e, n, int(gated), geo)
                check(err == 0, f"mst_gemm_i8_geometry({m}, {e}, {n}): {err}")
                mine = fq.ln_gemm_i8_launch(m, e, n, gated, sms)
                want = (mine.tiles, mine.grid, mine.threads, mine.stages,
                        mine.smem, mine.k_tiles, mine.second_box,
                        mine.quant_blocks)
                check(tuple(geo) == want, f"mst_gemm_i8_geometry at M={m}, "
                      f"{e} -> {n} (gated {gated}): kernel {tuple(geo)}, "
                      f"mirror {want}")
    w12 = fq.ln_gemm_i8_launch(m_path, 1536, f_, True, sms)
    print(f"{tag} GEMM geometry: ln_gemm_i8_launch equals the int8 GEMM's "
          f"mst_gemm_i8_geometry at K = {LN_GEMM_WIDTHS}, N = 3K, 4K and "
          f"gated F = {f_}, M = {BWD_M} and 1 on {sms} SMs (giant2 w12: "
          f"{w12.tiles} tiles on {w12.grid} CTAs, {w12.k_tiles} k tiles of "
          f"128, the h2 box at W^T row {w12.second_box})")
    # the LN pullback at every width it takes
    for m in (*BWD_M, 1):
        for k in range(32, fb.LN_PULLBACK_MAX_K + 1, 32):
            geo = (ctypes.c_longlong * 8)()
            err = lib.mst_ln_pullback_geometry(m, k, geo)
            check(err == 0, f"mst_ln_pullback_geometry({m}, {k}): {err}")
            mine = fb.ln_pullback_launch(m, k, sms)
            want = (mine.grid, mine.threads, mine.warps_a_row, mine.chunks,
                    mine.smem, mine.workspace, mine.sum_blocks,
                    mine.sum_threads)
            check(tuple(geo) == want, f"mst_ln_pullback_geometry at M={m}, "
                  f"K={k}: kernel {tuple(geo)}, mirror {want}")
    pb = fb.ln_pullback_launch(m_path, 1536, sms)
    print(f"{tag} LN pullback geometry: ln_pullback_launch equals the "
          f"kernel's mst_ln_pullback_geometry at every K % 32 == 0 up to "
          f"{fb.LN_PULLBACK_MAX_K}, M = {BWD_M} and 1 on {sms} SMs (K = "
          f"1536: {pb.grid} blocks, {pb.warps_a_row} warps a row, "
          f"{pb.workspace} bytes of partials, {pb.sum_blocks} second-pass "
          f"blocks)")


def check_layout_probes(tag, dev, lib) -> dict:
    """The operand layouts the backward GEMMs add to the wgmma mainloop,
    each alone in a bare product (`mst_gemm_probe`) against torch.matmul
    in f32 at a path shape of its kernel and a ragged one: B K-major
    (gemm_dgrad's W^T), A MN-major (gemm_wgrad's X^T). Within
    KERNEL_GRAD_REL of |matmul|max; the planted instance with the
    descriptors' leading and stride byte offsets swapped must break it.
    Returns {name: max_abs_err}."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    stream = torch.cuda.current_stream().cuda_stream
    errs = {}
    # (layout, M, N, K, rows of the reduction that hold data): dgrad's fc1
    # product at B=8 and a ragged one; one M chunk of wgrad's qkv product
    # at B=8 (its splits' rows: an unsplit 65,792-row chain reads ~4x the
    # limit, as `_WGRAD_MAX_ROWS` says) and a ragged one
    for layout, m, n, k, live in ((1, N_SLICES * S, 384, 1536, 1536),
                                  (1, 771, 1536, 384, 384),
                                  (2, 384, 1152, 7360, 7360),
                                  (2, 1536, 384, 832, 771)):
        a = torch.randn((m, k) if layout == 1 else (k, m), generator=gen)
        b = torch.randn((n, k) if layout == 1 else (k, n), generator=gen)
        if layout == 2:  # a ragged reduction: rows past `live` are zeros
            a[live:], b[live:] = 0, 0
        a, b = a.to(dev, torch.bfloat16), b.to(dev, torch.bfloat16)
        want = (a.float() @ b.float().t() if layout == 1
                else a.float().t() @ b.float())
        scale = want.abs().max().item()
        lim = KERNEL_GRAD_REL * scale
        name = (f"probe[{'B K-major' if layout == 1 else 'A MN-major'},"
                f"{m}x{n}x{k}]")
        for swap in (0, 1):
            c = torch.empty(m, n, device=dev)
            rc = lib.mst_gemm_probe(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    m, n, k, layout, swap, stream)
            check(rc == 0, f"{name}: launch failed ({rc})")
            torch.cuda.synchronize()
            err = (c - want).abs().max().item()
            if swap:
                print(f"{tag} planted fault: {name} with LBO and SBO swapped: "
                      f"max_abs_err={err:.6g} against the limit {lim:.6g} "
                      f"({err / lim:.4g}x); must break it")
                check(err > lim, f"{name}: the swapped descriptors pass")
            else:
                print(f"{tag} {name}: max_abs_err={err:.6g} limit={lim:.6g} "
                      f"({KERNEL_GRAD_REL} x |matmul|max={scale:.6g})")
                check(err <= lim and bool(torch.isfinite(c).all()),
                      f"{name}: max_abs_err {err} > {lim}")
                errs[name] = err
    # the int8 layout (ln_gemm_i8's: both operands K-major, the B boxes 64
    # rows each) against the exact integer product: equal, and the planted
    # swapped LBO / SBO far from it
    for m, n, k in ((N_SLICES * S, 1536, 384), (771, 8192, 1536)):
        a = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        b = torch.randint(-127, 128, (n, k), generator=gen,
                          dtype=torch.int8).to(dev)
        want = a.double() @ b.double().t()
        name = f"probe[int8 K-major pair,{m}x{n}x{k}]"
        for swap in (0, 1):
            c = torch.empty(m, n, dtype=torch.int32, device=dev)
            rc = lib.mst_gemm_i8_probe(a.data_ptr(), b.data_ptr(),
                                       c.data_ptr(), m, n, k, swap, stream)
            check(rc == 0, f"{name}: launch failed ({rc})")
            torch.cuda.synchronize()
            err = (c.double() - want).abs().max().item()
            if swap:
                print(f"{tag} planted fault: {name} with LBO and SBO swapped: "
                      f"max_abs_err={err:.6g}; must not be 0")
                check(err > 0, f"{name}: the swapped descriptors pass")
            else:
                print(f"{tag} {name}: max_abs_err={err:.6g} (exact: 0)")
                check(err == 0, f"{name}: max_abs_err {err}")
                errs[name] = err
        del a, b, c, want
    return errs


# -- phase 40: `ln_gemm` / `ln_gemm_swiglu` as `ln_rows` + the wgmma GEMM ---


def ln_gemm_phase(tag, dev, fb, build_lib):
    """Phase 40: `ln_rows` and the TMA + wgmma GEMM of `ln_gemm` /
    `ln_gemm_swiglu` in every mode at K = LN_GEMM_WIDTHS with their path
    widths (N = 3E, 4E; 2F = 2 * LN_GEMM_F) at the B=8 rows and at the
    ragged RAGGED_M, each run twice for the same bits, a planted fault per
    kernel, then the times. Returns (errs, timed, cost, lib_ms) for the
    kernels line."""
    stamp(tag, "40")
    gen = np.random.default_rng(SEED + 40)
    bf = torch.bfloat16
    m_path = N_SLICES * S
    eps = 1e-6

    def rand(*shape, scale=1.0, off=0.0, dtype=torch.float32):
        return torch.from_numpy(
            (off + scale * gen.standard_normal(shape)).astype(np.float32)
        ).to(dev, dtype)

    def weights(k, n):
        return rand(k, n, scale=k ** -0.5, dtype=bf), rand(n, scale=0.1)

    errs = {}

    def hold(name, kern, plain, ulps):
        """Each output of `kern` within ulps[i] bf16 ulps of the plain
        output's largest magnitude, and the same bits on a second run."""
        with torch.inference_mode():
            k1, k2, pl = kern(), kern(), plain()
        torch.cuda.synchronize()
        k1, k2, pl = ((t,) if not isinstance(t, tuple) else t
                      for t in (k1, k2, pl))
        worst = 0.0
        for i, (a, b, c, u) in enumerate(zip(k1, k2, pl, ulps)):
            if c is None:
                check(a is None, f"{name}[{i}]: unexpected output")
                continue
            check(tuple(a.shape) == tuple(c.shape) and a.dtype == c.dtype,
                  f"{name}[{i}]: {tuple(a.shape)} {a.dtype} != "
                  f"{tuple(c.shape)} {c.dtype}")
            check(bool(torch.isfinite(a.float()).all()), f"{name}: non-finite")
            scale = c.float().abs().max().item()
            err = (a.float() - c.float()).abs().max().item()
            lim = u * ulp_bf16(scale)
            same = torch.equal(a, b)
            print(f"{tag} {name}[{i}]: {list(a.shape)} max_abs_err={err:.6g} "
                  f"limit={lim:.6g} ({u} ulp at |plain|max={scale:.6g}); "
                  f"bit for bit on repeat {same}")
            check(err <= lim, f"{name}[{i}]: max_abs_err {err} > {lim}")
            check(same, f"{name}[{i}]: not bit for bit")
            worst = max(worst, err)
        errs[name] = worst

    print(f"{tag} ln_gemm redesign: ln_rows (h) within 1 bf16 ulp of plain, "
          f"every GEMM output within 2 (at the plain output's largest "
          f"magnitude), the same bits on a second run; K = {LN_GEMM_WIDTHS}, "
          f"M = {m_path} and the ragged {RAGGED_M}")
    F_ = LN_GEMM_F
    tanh, erf, none = fb.ACT_GELU_TANH, fb.ACT_GELU_ERF, fb.ACT_NONE
    for k in LN_GEMM_WIDTHS:
        ln_s, ln_b = rand(k, scale=0.1, off=1.0), rand(k, scale=0.1)
        wq, bq = weights(k, 3 * k)
        w1, b1 = weights(k, 4 * k)
        w12, b12 = weights(k, 2 * F_)
        for m in (m_path, *RAGGED_M):
            x = rand(m, k, dtype=bf)
            at = f"E={k},M={m}"
            hold(f"ln_rows[{at}]", lambda: fb.ln_rows(x, ln_s, ln_b, eps),
                 lambda: fb._ln_rows_ref(x, ln_s, ln_b, eps), (1,))
            for label, w, b, act in (("qkv", wq, bq, none),
                                     ("fc1,gelu_tanh", w1, b1, tanh),
                                     ("fc1,gelu_erf", w1, b1, erf)):
                args = (x, ln_s, ln_b, w, b, act, eps)
                hold(f"ln_gemm[{label},{at}]", lambda: fb.ln_gemm(*args),
                     lambda: fb._ln_gemm_ref(*args), (2,))
                hold(f"ln_gemm_train[{label},{at}]",
                     lambda: fb.ln_gemm(*args, train=True),
                     lambda: fb._ln_gemm_ref(*args, train=True), (2, 1, 2))
            gargs = (x, ln_s, ln_b, w12, b12, eps)
            hold(f"ln_gemm_swiglu[w12,{at}]", lambda: fb.ln_gemm_swiglu(*gargs),
                 lambda: fb._ln_gemm_swiglu_ref(*gargs), (2,))
            hold(f"ln_gemm_swiglu_train[w12,{at}]",
                 lambda: fb.ln_gemm_swiglu(*gargs, train=True),
                 lambda: fb._ln_gemm_swiglu_ref(*gargs, train=True), (2, 1, 2))
            del x

    # planted faults at giant2's width: each must break its limit
    k = LN_GEMM_WIDTHS[-1]
    x = rand(m_path, k, dtype=bf)
    ln_s, ln_b = rand(k, scale=0.1, off=1.0), rand(k, scale=0.1)
    wq, bq = weights(k, 3 * k)
    w12, b12 = weights(k, 2 * F_)

    def broken(name, kern, fault, ulps):
        scale = fault.float().abs().max().item()
        err = (kern.float() - fault.float()).abs().max().item()
        lim = ulps * ulp_bf16(scale)
        print(f"{tag} planted fault: {name}: max_abs_err={err:.6g} against "
              f"the limit {lim:.6g} ({err / lim:.4g}x); must break it")
        check(err > lim, f"planted fault {name} passes the limit")

    with torch.inference_mode():
        h = fb.ln_rows(x, ln_s, ln_b, eps)
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        stale = ((xf - mean.roll(1, 0)) * torch.rsqrt(var.roll(1, 0) + eps)
                 * ln_s + ln_b).to(bf)
        broken("ln_rows with each row's statistics from the row before", h,
               stale, 1)
        h_stale = h.clone()
        h_stale[:, k - 64:] = h[:, k - 128:k - 64]
        broken("ln_gemm[qkv] whose last ring stage holds the previous K tile "
               "of h", fb.ln_gemm(x, ln_s, ln_b, wq, bq, none, eps),
               fb._gemm_act_ref(h_stale, wq, bq, none), 2)
        w12_f, b12_f = w12.clone(), b12.clone()
        w12_f[:, F_:] = w12[:, F_:].roll(-1, 1)
        b12_f[F_:] = b12[F_:].roll(-1)
        broken("ln_gemm_swiglu[w12] with its h2 panel one column over",
               fb.ln_gemm_swiglu(x, ln_s, ln_b, w12, b12, eps),
               fb._gemm_swiglu_ref(h, w12_f, b12_f), 2)
    del h, xf, mean, var, stale, h_stale, w12_f, b12_f

    # times at the path shapes (B=8 rows): the wrapper (ln_rows + GEMM),
    # each kernel alone and the library calls taken in turn (in reverse
    # every other round), beside the SM clock and power draw meanwhile;
    # then the plain version and the bound
    stream = torch.cuda.current_stream().cuda_stream
    lib = build_lib()
    timed, cost, lib_ms = {}, {}, {}
    print(f"{tag} times: median over {PAIR_ROUNDS} rounds of the mean of "
          f"{PER_PAIR} calls between two CUDA events, the calls of one shape "
          f"taken in turn, in reverse order every other round; SM clock "
          f"(MHz) and power (W): medians of nvidia-smi samples read while "
          f"each was timed; chain = ln_rows + GEMM (the wrapper); WMMA = the "
          f"earlier single kernel's time (PERF.md §6)")
    with ClockSampler() as clocks:
        for k in LN_GEMM_WIDTHS:
            x = rand(m_path, k, dtype=bf)
            ln_s, ln_b = rand(k, scale=0.1, off=1.0), rand(k, scale=0.1)
            ln_w, ln_bias = ln_s.to(bf), ln_b.to(bf)
            h = fb.ln_rows(x, ln_s, ln_b, eps)
            sub = "" if k == 384 else f",E={k}"
            rows_name = f"ln_rows[E={k}]"
            cost[rows_name] = (0, 2 * 2 * m_path * k + 4 * 2 * k)

            def rows():
                return fb.ln_rows(x, ln_s, ln_b, eps)

            def layer_norm():
                return F.layer_norm(x, (k,), ln_w, ln_bias, eps)

            shapes = [(f"ln_gemm[qkv{sub}]", 3 * k, none, False),
                      (f"ln_gemm[fc1,gelu_tanh{sub}]", 4 * k, tanh, False)]
            if k == LN_GEMM_WIDTHS[-1]:
                shapes += [("ln_gemm_swiglu[w12]", 2 * F_, none, False),
                           ("ln_gemm_swiglu_train[w12]", 2 * F_, none, True)]
            for name, n, act, train in shapes:
                w, b = weights(k, n)
                bw = b.to(bf)
                gated = name.startswith("ln_gemm_swiglu")
                if gated:
                    out = torch.empty(m_path, n // 2, dtype=bf, device=dev)
                    h12 = (torch.empty(m_path, n, dtype=bf, device=dev)
                           if train else None)

                    def gemm_only():
                        return lib.mst_gemm_swiglu(
                            h.data_ptr(), w.data_ptr(), b.data_ptr(),
                            out.data_ptr(), None if h12 is None else
                            h12.data_ptr(), m_path, k, n // 2, stream)

                    def wrapper():
                        return fb.ln_gemm_swiglu(x, ln_s, ln_b, w, b, eps,
                                                 train=train)

                    def plain():
                        return fb._ln_gemm_swiglu_ref(x, ln_s, ln_b, w, b, eps,
                                                      train=train)

                    def library():
                        h1, h2 = torch.addmm(bw, layer_norm(), w).chunk(
                            2, dim=-1)
                        return F.silu(h1) * h2
                    outs = 2 * m_path * (n // 2) + (2 * m_path * (n + k)
                                                    if train else 0)
                    cost[name] = (2 * m_path * k * n, 2 * (m_path * k + k * n)
                                  + outs + 4 * (2 * k + n))
                else:
                    out = torch.empty(m_path, n, dtype=bf, device=dev)

                    def gemm_only():
                        return lib.mst_gemm_act(
                            h.data_ptr(), w.data_ptr(), b.data_ptr(),
                            out.data_ptr(), None, m_path, k, n, act, stream)

                    def wrapper():
                        return fb.ln_gemm(x, ln_s, ln_b, w, b, act, eps)

                    def plain():
                        return fb._ln_gemm_ref(x, ln_s, ln_b, w, b, act, eps)

                    def library():
                        y = torch.addmm(bw, layer_norm(), w)
                        return F.gelu(y, approximate="tanh") if act else y
                    cost[name] = mm_cost(m_path, k, n, 4 * (2 * k + n))
                check(gemm_only() == 0, f"{name}: the GEMM's launch failed")
                with torch.inference_mode():  # the f32 plain version last
                    t = time_interleaved(
                        {"chain": wrapper, "ln_rows": rows, "GEMM": gemm_only,
                         "library": library, "F.layer_norm": layer_norm},
                        clocks)
                    pm_ = time_ms(plain)
                km, gm, rm = t["chain"].ms, t["GEMM"].ms, t["ln_rows"].ms
                if rows_name not in timed:  # the first shape's reading
                    timed[rows_name] = (rm, time_ms(lambda: fb._ln_rows_ref(
                        x, ln_s, ln_b, eps)))
                    lib_ms[rows_name] = t["F.layer_norm"].ms
                timed[name] = (km, pm_)
                lib_ms[name] = t["library"].ms
                b_ms, b_by = bound([cost[name]])
                flop = cost[name][0]
                wmma = WMMA_MS.get(name)
                below = sum(g < c for g, c in zip(t["GEMM"].each,
                                                  t["chain"].each))
                print(f"{tag} time {name} [{m_path}, {k}] -> {n}: chain "
                      f"{km:.4f} ms ({flop / km / 1e9:.1f} TFLOP/s; rounds "
                      f"{t['chain'].lo:.4f}-{t['chain'].hi:.4f}); ln_rows "
                      f"{rm:.4f} + GEMM alone {gm:.4f} = {rm + gm:.4f} ms "
                      f"(GEMM {flop / gm / 1e9:.1f} TFLOP/s; rounds "
                      f"{t['GEMM'].lo:.4f}-{t['GEMM'].hi:.4f}); GEMM alone "
                      f"below the chain in {below} of {PAIR_ROUNDS} rounds; "
                      f"plain {pm_:.4f} ms; bound {b_ms:.4f} ms by {b_by}; "
                      f"library {lib_ms[name]:.4f} ms ({lib_ms[name] / km:.3f}x "
                      f"the chain); WMMA "
                      + (f"{wmma} ms ({wmma / km:.2f}x)" if wmma else
                         "not recorded"))
                print(f"{tag} clocks {name}: " + "; ".join(
                    f"{label} {v.mhz} MHz, {v.watts} W ({v.samples} samples)"
                    for label, v in t.items()))
                del out, w, b
            rb, rby = bound([cost[rows_name]])
            print(f"{tag} time {rows_name} [{m_path}, {k}]: "
                  f"{timed[rows_name][0]:.4f} ms, plain "
                  f"{timed[rows_name][1]:.4f} ms, bound {rb:.4f} ms by {rby} "
                  f"({cost[rows_name][1] / timed[rows_name][0] / 1e6:.1f} "
                  f"GB/s), library (F.layer_norm, bf16 weights) "
                  f"{lib_ms[rows_name]:.4f} ms")
            del x, h
    torch.cuda.empty_cache()
    return errs, timed, cost, lib_ms


# -- phase 41: `gemm_dgrad` / `gemm_wgrad` on the wgmma GEMM ----------------


def bwd_gemm_phase(tag, dev, fb):
    """Phase 41: every `gemm_dgrad` epilogue and `gemm_wgrad` product of the
    train paths (ViT-S / B / L blocks at E = 384 / 768 / 1024, giant2's at
    1536 with the SwiGLU FFN) against plain under phase 7's limits, twice
    for the same bits, at the row counts BWD_M (ViT-S at all of them, the
    wider ones at their B=8 rows and the ragged ones); then each product at
    its path shape (B=8; DINOv3's S = 201 attention products) timed in turn
    with the library calls for the same work, beside the WMMA kernel's
    recorded time and the SM clock. Returns (errs, timed, cost, lib_ms) for
    the kernels line."""
    stamp(tag, "41")
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    bf, f32 = torch.bfloat16, torch.float32
    eps = 1e-6
    tanh, erf = fb.ACT_GELU_TANH, fb.ACT_GELU_ERF

    def rand(*shape, scale=1.0, off=0.0, dtype=bf):
        return (off + scale * torch.randn(shape, generator=gen, device=dev,
                                          dtype=f32)).to(dtype)

    def wgrad(a, b):
        """(kernel, plain, library, cost) of a^T @ b and b's column sums."""
        m, k = a.shape
        return (lambda: fb.gemm_wgrad(a, b), lambda: fb._gemm_wgrad_ref(a, b),
                lambda: (torch.matmul(a.t(), b), b.sum(0, dtype=f32)),
                wgrad_cost(m, k, b.shape[1]))

    def dgrad(dy, w, a=None, act=fb.ACT_NONE, ln=None):
        """(kernel, plain, library, cost) of dy @ w^T with its epilogue; the
        library: the bf16 matmul, then the GELU' product (`gelu_backward`),
        the gate's derivative in torch ops, or the LN backward from the
        saved statistics (`native_layer_norm_backward`) plus the residual."""
        m, r = dy.shape
        k = w.shape[0]
        kern = lambda: fb.gemm_dgrad(dy, w, a, act, ln)  # noqa: E731
        plain = lambda: fb._gemm_dgrad_ref(dy, w, a, act, ln)  # noqa: E731
        if ln is not None:
            x, g, lns, _ = ln
            xf = x.float()
            _, mean, rstd = torch.ops.aten.native_layer_norm(xf, (k,), lns,
                                                             None, eps)
            zero = torch.zeros_like(lns)

            def library():
                dx, dlns, dlnb = torch.ops.aten.native_layer_norm_backward(
                    torch.matmul(dy, w.t()).float(), xf, (k,), mean, rstd,
                    lns, zero, [True, True, True])
                return (dx + g).to(bf), dlns, dlnb
            return kern, plain, library, mm_cost(m, r, k, 4 * m * k + 12 * k)
        if act == fb.ACT_SWIGLU:
            def library():
                du = torch.matmul(dy, w.t())
                h1, h2 = a.chunk(2, dim=-1)
                sg = torch.sigmoid(h1)
                silu = h1 * sg
                return torch.cat([du * h2 * (sg + silu * (1 - sg)),
                                  du * silu], -1)
            return (kern, plain, library,
                    mm_cost(m, r, k, 2 * m * 2 * k + 2 * m * k))
        if a is not None:
            approx = "tanh" if act == tanh else "none"
            return (kern, plain, lambda: torch.ops.aten.gelu_backward(
                torch.matmul(dy, w.t()), a, approximate=approx),
                mm_cost(m, r, k, 2 * m * k))
        return kern, plain, lambda: torch.matmul(dy, w.t()), mm_cost(m, r, k)

    def block_cases(m, e, swiglu):
        """{name: (kernel, plain, library, cost)}: the backward products of
        one block at rows m, width e (the SwiGLU FFN at F = LN_GEMM_F)."""
        f = LN_GEMM_F
        x, g, o, h = (rand(m, e) for _ in range(4))
        lns = rand(e, scale=0.1, off=1.0, dtype=f32)
        ln = (x, g, lns, eps)
        dqkv = rand(m, 3 * e)
        wproj = rand(e, e, scale=e ** -0.5)
        wqkv = rand(e, 3 * e, scale=e ** -0.5)
        c = {"gemm_wgrad[proj]": wgrad(o, g), "gemm_wgrad[qkv]": wgrad(h, dqkv),
             "gemm_dgrad[proj]": dgrad(g, wproj),
             "gemm_dgrad[qkv,ln]": dgrad(dqkv, wqkv, ln=ln)}
        if swiglu:
            gate, h12, dh12 = rand(m, f), rand(m, 2 * f), rand(m, 2 * f)
            w3 = rand(f, e, scale=f ** -0.5)
            w12 = rand(e, 2 * f, scale=e ** -0.5)
            c.update({
                "gemm_wgrad[w3]": wgrad(gate, g),
                "gemm_dgrad_swiglu[w3]": dgrad(g, w3, h12, fb.ACT_SWIGLU),
                "gemm_wgrad[w12]": wgrad(h, dh12),
                "gemm_dgrad[w12,ln]": dgrad(dh12, w12, ln=ln)})
        else:
            u, a, da = rand(m, 4 * e), rand(m, 4 * e), rand(m, 4 * e)
            w1 = rand(e, 4 * e, scale=e ** -0.5)
            w2 = rand(4 * e, e, scale=(4 * e) ** -0.5)
            c.update({
                "gemm_wgrad[fc2]": wgrad(u, g), "gemm_wgrad[fc1]": wgrad(h, da),
                "gemm_dgrad[fc2,gelu_tanh]": dgrad(g, w2, a, tanh),
                "gemm_dgrad[fc2,gelu_erf]": dgrad(g, w2, a, erf),
                "gemm_dgrad[fc1,ln]": dgrad(da, w1, ln=ln)})
        return c

    def named(base, m, e):
        """The kernels line's name of a product: ViT-S at B=8 as phase 7
        names it, DINOv3's S = 201 and the wider widths as phases 15 and 26
        do (giant2's w3 / w12 products without the width), else the rows."""
        tags = []
        if e != 384 and not ("w3" in base or "w12" in base):
            tags.append(f"E={e}")
        if m == N_SLICES * S3:
            tags.append("S=201")
        elif m != N_SLICES * S:
            tags.append(f"M={m}")
        return base[:-1] + "".join("," + t for t in tags) + "]"

    m_path, m3 = N_SLICES * S, N_SLICES * S3
    groups = [(384, False, BWD_M), (768, False, (m_path, 771)),
              (1024, False, (m_path, 771)),
              (LN_GEMM_WIDTHS[-1], True, (m_path, 16_448, 771))]
    print(f"{tag} backward GEMMs on the wgmma mainloop: every gemm_dgrad "
          f"epilogue and gemm_wgrad product of the ViT-S / B / L and giant2 "
          f"blocks, bf16 outputs within 2 bf16 ulps of plain and f32 within "
          f"{KERNEL_GRAD_REL} x |plain|max (phase 7's limits), the same bits "
          f"on a second run; rows {BWD_M}")
    errs, timed, cost, lib_ms = {}, {}, {}, {}
    timing = {}
    for e, swiglu, rows in groups:
        for m in rows:
            for base, (kern, plain, library, c) in block_cases(
                    m, e, swiglu).items():
                name = named(base, m, e)
                with torch.inference_mode():
                    k1, pl, k2 = kern(), plain(), kern()
                torch.cuda.synchronize()
                errs[name] = check_outputs(tag, f"bwd {name}", k1, pl,
                                           KERNEL_GRAD_REL)
                k1, k2 = ((k1, k2) if isinstance(k1, tuple)
                          else ((k1,), (k2,)))
                same = all(torch.equal(a, b) for a, b in zip(k1, k2))
                print(f"{tag} bwd {name}: two runs equal bit for bit: {same}")
                check(same, f"{name}: two runs differ")
                del k1, k2, pl
                attn = base.startswith(("gemm_wgrad[proj", "gemm_wgrad[qkv",
                                        "gemm_dgrad[proj", "gemm_dgrad[qkv"))
                if m == m_path or (m == m3 and attn):  # a path shape
                    cost[name] = c
                    timing[name] = (kern, plain, library)
            if not timing:
                continue
            # time this group's path shapes now, while their inputs live
            with ClockSampler() as clocks, torch.inference_mode():
                for name, (kern, plain, library) in timing.items():
                    t = time_interleaved({"kernel": kern,
                                          "library": library}, clocks)
                    pm_ = time_ms(plain, n=5, warmup=1)
                    km, lm = t["kernel"].ms, t["library"].ms
                    timed[name], lib_ms[name] = (km, pm_), lm
                    b_ms, b_by = bound([cost[name]])
                    flop = cost[name][0]
                    wmma = WMMA_BWD_MS.get(name)
                    print(f"{tag} time {name}: kernel {km:.4f} ms "
                          f"({flop / km / 1e9:.1f} TFLOP/s; rounds "
                          f"{t['kernel'].lo:.4f}-{t['kernel'].hi:.4f}; "
                          f"{t['kernel'].mhz} MHz, {t['kernel'].watts} W); "
                          f"library for the same work {lm:.4f} ms (kernel / "
                          f"library {km / lm:.3f}; {t['library'].mhz} MHz); "
                          f"plain {pm_:.4f} ms; bound {b_ms:.4f} ms by {b_by}; "
                          f"WMMA " + (f"{wmma} ms ({wmma / km:.2f}x)" if wmma
                                      else "not recorded"))
            timing.clear()
            torch.cuda.empty_cache()
    # `ln_pullback` alone at ViT-S's width, on its path (768 / 1024 / 1536:
    # phase 26; its times at every width: phase 45)
    e = 384
    x, g = rand(m_path, e), rand(m_path, e)
    dh = rand(m_path, e, dtype=f32)
    lns = rand(e, scale=0.1, off=1.0, dtype=f32)
    name = "ln_pullback[E=384]"
    with torch.inference_mode():
        k1, pl, k2 = (fb.ln_pullback(dh, x, g, lns, eps),
                      fb._ln_pullback_ref(dh, x, g, lns, eps),
                      fb.ln_pullback(dh, x, g, lns, eps))
    errs[name] = check_outputs(tag, f"bwd {name}", k1, pl, KERNEL_GRAD_REL)
    same = all(torch.equal(a, b) for a, b in zip(k1, k2))
    print(f"{tag} bwd {name}: two runs equal bit for bit: {same}")
    check(same, f"{name}: two runs differ")
    del x, g, dh, k1, k2, pl
    torch.cuda.empty_cache()
    return errs, timed, cost, lib_ms


# -- phase 42: `gemm_residual` / `gemm_dls` on the wgmma GEMM ---------------


@contextlib.contextmanager
def shared_product(fb):
    """Within the block, the plain versions' f32 product `fb._mm(a, w)` is
    computed once for each (a, w) and handed to every plain version that
    asks for it again (phase 42's modes share one product per shape)."""
    real, memo = fb._mm, {}

    def mm(a, b):
        key = (a.data_ptr(), b.data_ptr(), tuple(a.shape), tuple(b.shape),
               a.stride(), b.stride(), a.dtype, b.dtype)
        if key not in memo:
            memo.clear()
            memo[key] = real(a, b)
        return memo[key]
    fb._mm = mm
    try:
        yield
    finally:
        fb._mm = real
        memo.clear()


def residual_products(e):
    """(label, K) of the products that end in a residual at width e: proj
    and fc2, or giant2's proj and w3."""
    if e == LN_GEMM_WIDTHS[-1]:
        return [("proj", e), ("w3", LN_GEMM_F)]
    return [("proj", e), ("fc2", 4 * e)]


def residual_name(kind, label, e, m, mode="ls"):
    """The kernels line's name of a `gemm_residual` / `gemm_dls` case
    (phases 3, 7, 15, 21 and 26 name the same products so): the width
    unless ViT-S or w3, the mode, S=201 for DINOv3's B=8 rows, else the rows
    unless B=8."""
    tags = [label]
    if e != 384 and label != "w3":
        tags.append(f"E={e}")
    if kind == "gemm_residual":
        tags.append(mode)
    if m == N_SLICES * S3:
        tags.append("S=201")
    elif m != N_SLICES * S:
        tags.append(f"M={m}")
    return f"{kind}[{','.join(tags)}]"


def residual_gemm_phase(tag, dev, fb):
    """Phase 42: `gemm_residual` in each of its four kernels (residual with
    and without LayerScale; the product alone with and without it, the
    latter through `tools/_common.gemm`) and `gemm_dls`, at every (K, N) of
    the paths (proj and fc2 of ViT-S / B / L, giant2's proj and w3),
    against their plain versions under phase 3 / 7's limits, twice for the
    same bits, at the row counts RES_M (ViT-S at all of them, the wider
    widths at the train CLI's B=2 rows and the ragged ones); three planted
    faults. The kernels line keeps the main path's readings of the same
    names (phases 3, 7, 15, 21, 26); the times: `residual_times`."""
    from mst_tpu_torch.ops import _build
    from mst_tpu_torch.tools import _common

    stamp(tag, "42")
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    bf = torch.bfloat16
    m_path = N_SLICES * S
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream

    def rand(*shape, scale=1.0, off=0.0, dtype=bf):
        return (off + scale * torch.randn(shape, generator=gen, device=dev,
                                          dtype=torch.float32)).to(dtype)

    def product_ls(a, w, b, ls):
        """The product alone with LayerScale (x = NULL): the kernel through
        the entry point, as no wrapper of the paths asks for it."""
        out = torch.empty(a.shape[0], w.shape[1], dtype=bf, device=dev)
        err = lib.mst_gemm_residual(a.data_ptr(), w.data_ptr(), b.data_ptr(),
                                    ls.data_ptr(), None, out.data_ptr(),
                                    a.shape[0], a.shape[1], w.shape[1],
                                    stream)
        check(err == 0, f"mst_gemm_residual (no residual): error {err}")
        return out

    def hold(name, kern, plain, rel=KERNEL_GRAD_REL):
        """Outputs of `kern` against `plain` (bf16 within 2 bf16 ulps, f32
        within `rel` of the plain output's largest magnitude), and the same
        bits on a second run."""
        with torch.inference_mode():
            k1, pl, k2 = kern(), plain(), kern()
        torch.cuda.synchronize()
        check_outputs(tag, f"res {name}", k1, pl, rel)
        k1, k2 = (k1, k2) if isinstance(k1, tuple) else ((k1,), (k2,))
        same = all(torch.equal(a, b) for a, b in zip(k1, k2))
        print(f"{tag} res {name}: two runs equal bit for bit: {same}")
        check(same, f"{name}: two runs differ")

    print(f"{tag} gemm_residual / gemm_dls on the wgmma mainloop: each "
          f"kernel at every (K, N) of the paths, bf16 outputs within 2 bf16 "
          f"ulps of plain and dls within {KERNEL_GRAD_REL} x |plain|max "
          f"(phase 3 / 7's limits), the same bits on a second run; ViT-S at "
          f"rows {RES_M}, the wider widths at {RES_M[2]}, {RES_M[-2]} and "
          f"{RES_M[-1]}")
    for e in LN_GEMM_WIDTHS:
        rows = RES_M if e == 384 else (RES_M[2], RES_M[-2], RES_M[-1])
        for label, k in residual_products(e):
            w = rand(k, e, scale=k ** -0.5)
            b = rand(e, scale=0.1, dtype=torch.float32)
            ls = rand(e, scale=0.1, off=1.0, dtype=torch.float32)
            for m in rows:
                a, x, g = rand(m, k), rand(m, e), rand(m, e)
                with shared_product(fb):
                    hold(residual_name("gemm_residual", label, e, m),
                         lambda: fb.gemm_residual(a, w, b, ls, x),
                         lambda: fb._gemm_residual_ref(a, w, b, ls, x))
                    hold(residual_name("gemm_residual", label, e, m, "no_ls"),
                         lambda: fb.gemm_residual(a, w, b, None, x),
                         lambda: fb._gemm_residual_ref(a, w, b, None, x))
                    hold(residual_name("gemm_residual", label, e, m, "no_x"),
                         lambda: product_ls(a, w, b, ls),
                         lambda: ((fb._mm(a, w) + b) * ls).to(bf))
                    hold(residual_name("gemm_residual", label, e, m, "no_x,no_ls"),
                         lambda: _common.gemm(a, w),
                         lambda: fb._mm(a, w).to(bf))
                    hold(residual_name("gemm_dls", label, e, m),
                         lambda: fb.gemm_dls(a, w, b, ls, g),
                         lambda: fb._gemm_dls_ref(a, w, b, ls, g))
                del a, x, g
    torch.cuda.empty_cache()

    # planted faults, each of which must break its limit
    def broken(name, kern, fault, rel=None):
        scale = fault.float().abs().max().item()
        err = (kern.float() - fault.float()).abs().max().item()
        lim = 2 * ulp_bf16(scale) if rel is None else rel * scale
        print(f"{tag} planted fault: {name}: max_abs_err={err:.6g} against "
              f"the limit {lim:.6g} ({err / lim:.4g}x); must break it")
        check(err > lim, f"planted fault {name} passes the limit")

    e = k = 384
    w = rand(k, e, scale=k ** -0.5)
    b = rand(e, scale=0.1, dtype=torch.float32)
    ls = rand(e, scale=0.1, off=1.0, dtype=torch.float32)
    with torch.inference_mode():
        a, x = rand(m_path, k), rand(m_path, e)
        x_next = torch.zeros_like(x)
        x_next[:-64] = x[64:]
        broken("gemm_residual[proj,ls] reading x from the next 64-row slab",
               fb.gemm_residual(a, w, b, ls, x),
               fb._gemm_residual_ref(a, w, b, ls, x_next))
        broken("gemm_residual[proj,ls] with the LayerScale one column over",
               fb.gemm_residual(a, w, b, ls, x),
               fb._gemm_residual_ref(a, w, b, ls.roll(-1), x))
        for m in RAGGED_M:
            a, g = rand(m, k), rand(m, e)
            # the rows past M unmasked: the slab copy holds row M - 1 there
            # and a's rows are zeros (z = b), so each row past M of the last
            # 64-row slab that starts below M adds g[M - 1] * b (a slab past
            # M writes no partial)
            pad = -(-m // 64) * 64 - m
            _, dls = fb._gemm_dls_ref(a, w, b, ls, g)
            broken(f"gemm_dls[proj,M={m}] with its {pad} rows past M "
                   f"unmasked", fb.gemm_dls(a, w, b, ls, g)[1],
                   dls + pad * g[-1].float() * b, KERNEL_GRAD_REL)
    del a, x, x_next, g

    # each TMA GEMM's entry as the first call of a fresh host thread, which
    # has no current context (as PyTorch's autograd worker before its first
    # launch): the same bits as on this thread
    m = RAGGED_M[0]
    a, x, o = rand(m, k), rand(m, e), rand(m, 3 * e)
    w3e = rand(e, 3 * e, scale=e ** -0.5)
    with torch.inference_mode():
        for name, fn in (
                ("gemm_residual", lambda: fb.gemm_residual(a, w, b, ls, x)),
                ("gemm_dls", lambda: fb.gemm_dls(a, w, b, ls, x)),
                ("gemm_dgrad", lambda: fb.gemm_dgrad(o, w3e)),
                ("gemm_wgrad", lambda: fb.gemm_wgrad(a, o))):
            there, here = fresh_thread(fn), fn()
            torch.cuda.synchronize()
            there, here = ((there, here) if isinstance(here, tuple)
                           else ((there,), (here,)))
            same = all(torch.equal(u, v) for u, v in zip(there, here))
            print(f"{tag} {name} launched first in a fresh host thread: the "
                  f"same bits as on the main thread: {same}")
            check(same, f"{name} in a fresh thread differs")


def residual_times(tag, dev, fb):
    """Phase 42's times: each `gemm_residual` / `gemm_dls` product at its
    path shape (B=8; DINOv3's proj at S = 201) timed in turn with the
    library calls for the same work, beside the WMMA kernel's recorded time
    and the SM clock; then the plain version and the bound. Returns
    (timed, cost, lib_ms)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 142)
    bf = torch.bfloat16
    m_path, m3 = N_SLICES * S, N_SLICES * S3

    def rand(*shape, scale=1.0, off=0.0, dtype=bf):
        return (off + scale * torch.randn(shape, generator=gen, device=dev,
                                          dtype=torch.float32)).to(dtype)

    timed, cost, lib_ms = {}, {}, {}
    print(f"{tag} times: median over {PAIR_ROUNDS} rounds of the mean of "
          f"{PER_PAIR} calls between two CUDA events, kernel and library "
          f"taken in turn; library: torch.addmm, then torch.addcmul for "
          f"x + ls * y (gemm_dls: g * ls and the f32 column sums of g * z); "
          f"WMMA = the kernel before this rewrite (PERF.md §6)")
    shapes = [(e, label, k, m_path) for e in LN_GEMM_WIDTHS
              for label, k in residual_products(e)] + [(384, "proj", 384, m3)]
    with ClockSampler() as clocks, torch.inference_mode():
        for e, label, k, m in shapes:
            a, x, g = rand(m, k), rand(m, e), rand(m, e)
            w = rand(k, e, scale=k ** -0.5)
            b = rand(e, scale=0.1, dtype=torch.float32)
            ls = rand(e, scale=0.1, off=1.0, dtype=torch.float32)
            for kind, kern, plain, library, extra in (
                    ("gemm_residual", lambda: fb.gemm_residual(a, w, b, ls, x),
                     lambda: fb._gemm_residual_ref(a, w, b, ls, x),
                     residual_library(a, w, b, ls, x), 2 * m * e + 4 * 2 * e),
                    ("gemm_dls", lambda: fb.gemm_dls(a, w, b, ls, g),
                     lambda: fb._gemm_dls_ref(a, w, b, ls, g),
                     dls_library(a, w, b, ls, g), 2 * m * e + 4 * 3 * e)):
                name = residual_name(kind, label, e, m)
                cost[name] = mm_cost(m, k, e, extra)
                t = time_interleaved({"kernel": kern, "library": library},
                                     clocks)
                pm_ = time_ms(plain, n=5, warmup=1)
                km, lm = t["kernel"].ms, t["library"].ms
                timed[name], lib_ms[name] = (km, pm_), lm
                b_ms, b_by = bound([cost[name]])
                flop = cost[name][0]
                wmma = WMMA_RES_MS.get(name)
                print(f"{tag} time {name} [{m}, {k}] -> {e}: kernel "
                      f"{km:.4f} ms ({flop / km / 1e9:.1f} TFLOP/s, "
                      f"{cost[name][1] / km / 1e6:.1f} GB/s; rounds "
                      f"{t['kernel'].lo:.4f}-{t['kernel'].hi:.4f}; "
                      f"{t['kernel'].mhz} MHz, {t['kernel'].watts} W); "
                      f"library for the same work {lm:.4f} ms (kernel / "
                      f"library {km / lm:.3f}; {t['library'].mhz} MHz); "
                      f"plain {pm_:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
                      f"({b_ms / km:.3f} of it); WMMA "
                      + (f"{wmma} ms ({wmma / km:.2f}x)" if wmma
                         else "not recorded"))
            del a, x, g
    torch.cuda.empty_cache()
    return timed, cost, lib_ms


# Phase 43: `mhsa` / `mhsa_bwd` on TMA + wgmma with the scores in
# registers, at the path widths (ViT-S / B / L, giant2: 6 / 12 / 16 / 24
# heads at S = 257), DINOv3's S = 201 with RoPE, a ragged S = 77 and C3's
# 442 / 512 (the two-pass forward). The WMMA kernels' times (the mean of
# two readings by `attn_times` on the tree before this redesign, in the
# call that read this tree's twice, on an H100 80GB HBM3 at 700 W; PERF.md
# §6), printed beside the new ones.
ATTN_HEADS = (6, 12, 16, 24)
ATTN_LONG = (442, 512)
ATTN_RAGGED = 77
WMMA_ATTN_MS = {
    "mhsa": 1.0528, "mhsa_train": 1.0541, "mhsa_bwd": 3.0792,
    "mhsa_with_row": 1.1327, "mhsa_rollout[block1,row]": 1.2183,
    "mhsa_abnar": 1.5449, "mhsa_rope": 0.7708, "mhsa_rope_train": 0.7801,
    "mhsa_bwd_rope": 2.6864, "mhsa_with_row_rope": 0.8102,
    "mhsa_rollout_rope[block1,row]": 0.9543, "mhsa_abnar_rope": 1.1965,
    "mhsa[E=768]": 2.0499, "mhsa_bwd[E=768]": 6.1075,
    "mhsa[E=1024]": 2.7235, "mhsa_bwd[E=1024]": 8.1577,
    "mhsa[E=1536]": 4.0761, "mhsa_bwd[E=1536]": 12.2266,
    "mhsa[S=442]": 2.4437, "mhsa_bwd[S=442]": 8.5906}


def attn_name(form, heads=HEADS, s=S, rope=False, n=N_SLICES):
    """The kernels line's name of a `mhsa` / `mhsa_bwd` case (phases 3, 7,
    11, 15, 21 name the same cases so): the form, `_rope` before the
    train suffix or the bracket, then the width unless ViT-S, S unless 257
    or DINOv3's 201, the slices unless B=8."""
    base, _, rest = form.partition("[")
    if rope:
        base = (base[:-len("_train")] + "_rope_train" if base.endswith("_train")
                else base + "_rope")
    tags = [rest[:-1]] if rest else []
    if heads != HEADS:
        tags.append(f"E={64 * heads}")
    if s not in (S, S3):
        tags.append(f"S={s}")
    if n != N_SLICES:
        tags.append(f"N={n}")
    return base + (f"[{','.join(tags)}]" if tags else "")


def attn_tables(s, dev):
    """The RoPE tables of a length the paths have (DINOv3 ViT-S/16 at 224
    px: S = 201; ViT-S/14's grid at 294 px: 442), else None."""
    from mst_tpu_torch.ops.rotary import rope_tables
    grids = {S3: (GRID3, PREFIX3), 442: ((21, 21), 1)}
    if s not in grids:
        return None
    grid, prefix = grids[s]
    return rope_tables(grid, 64, prefix, 100.0, True, dev)


def fresh_thread(fn):
    """fn() as the first call of a new host thread, which has no current
    context (as PyTorch's autograd worker before its first launch)."""
    got = {}

    def run():
        try:
            got["out"] = fn()
        except Exception as exc:  # noqa: BLE001 - re-raised below
            got["exc"] = exc
    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "exc" in got:
        raise got["exc"]
    return got["out"]


def check_attn_geometry(tag, fb, lib) -> None:
    """`fused_block.mhsa_launch` (the geometry the CPU tests read) against
    the kernels' own, `mst_mhsa_geometry` and `mst_mhsa_bwd_geometry`, at
    every S from 1 to 512."""
    for s in range(1, 513):
        g = fb.mhsa_launch(s)
        fwd, bwd = (ctypes.c_int * 10)(), (ctypes.c_int * 7)()
        check(lib.mst_mhsa_geometry(s, fwd) == 0
              and lib.mst_mhsa_bwd_geometry(s, bwd) == 0, f"geometry at S={s}")
        want_f = (g.tile, g.tiles, g.tiles_per_block, g.threads, g.passes,
                  g.chunks64, g.tail16, g.score_regs, g.smem, g.abnar_smem)
        want_b = (g.tile, g.tiles, g.bwd_tiles_per_block, g.threads,
                  g.chunks64, g.tail16, g.bwd_smem)
        check(tuple(fwd) == want_f and tuple(bwd) == want_b,
              f"attention geometry at S={s}: kernel {tuple(fwd)} / "
              f"{tuple(bwd)}, mirror {want_f} / {want_b}")
    g = fb.mhsa_launch(S)
    print(f"{tag} attention geometry: fused_block.mhsa_launch equals "
          f"mst_mhsa_geometry / mst_mhsa_bwd_geometry at every S <= 512 (S "
          f"= {S}: {g.tiles} tiles of {g.tile}, {g.tiles_per_block} / "
          f"{g.bwd_tiles_per_block} a block, {g.passes} pass, "
          f"{g.chunks64} key chunks of 64 + {g.tail16} of 16, "
          f"{g.score_regs} score registers, {g.smem} / {g.abnar_smem} / "
          f"{g.bwd_smem} bytes of shared memory)")


def attn_phase(tag, dev, fb):
    """Phase 43: every form of `mhsa` (plain, LSE, CLS row, the rollout
    carry over two chained blocks, Abnar factor; each with RoPE where the
    length has tables) and `mhsa_bwd` (dq with delta, dk / dv) against
    their plain versions under phase 3 / 7's limits, twice for the same
    bits, at ATTN_HEADS x S = 257, S3 = 201 with RoPE, S = ATTN_RAGGED and
    ATTN_LONG; three planted faults; each TMA kernel first in a fresh host
    thread. Its readings stay out of the kernels line, which keeps the main
    path's readings of the same names (phases 3, 7, 11, 15, 21); the times:
    `attn_times`."""
    stamp(tag, "43")
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    bf = torch.bfloat16

    def rand(*shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float32)).to(dtype)

    def hold(name, kern, plain):
        """kern() against plain() (bf16 within 2 bf16 ulps, f32 within
        KERNEL_GRAD_REL of the plain output's largest magnitude), and the
        same bits on a second run."""
        with torch.inference_mode():
            k1, pl, k2 = kern(), plain(), kern()
        torch.cuda.synchronize()
        check_outputs(tag, f"attn {name}", k1, pl, KERNEL_GRAD_REL)
        k1, k2 = (k1, k2) if isinstance(k1, tuple) else ((k1,), (k2,))
        same = all(torch.equal(a, b) for a, b in zip(k1, k2))
        print(f"{tag} attn {name}: two runs equal bit for bit: {same}")
        check(same, f"{name}: two runs differ")

    print(f"{tag} mhsa / mhsa_bwd on TMA + wgmma: every form against plain, "
          f"bf16 outputs within 2 bf16 ulps and f32 ones within "
          f"{KERNEL_GRAD_REL} x |plain|max (phase 3 / 7's limits), the same "
          f"bits on a second run; {ATTN_HEADS} heads at S = {S}, S = {S3} "
          f"with RoPE, S = {ATTN_RAGGED} and {ATTN_LONG}")
    cases = [(N_SLICES, S, h) for h in ATTN_HEADS] + [(N_SLICES, S3, HEADS)]
    cases += [(64, ATTN_RAGGED, HEADS)] + [(64, s, HEADS) for s in ATTN_LONG]
    for n, s, h in cases:
        qkv = rand(n * s, 3 * 64 * h)
        do = rand(n * s, 64 * h)
        tables = attn_tables(s, dev)
        # DINOv3's length with RoPE only (its name without is ViT-S's)
        for rope in ((True,) if s == S3 else (False, True) if tables is not None
                     else (False,)):
            rt = (dict(rope_cos=tables[0], rope_sin=tables[1]) if rope
                  else {})

            def nm(form):
                return attn_name(form, h, s, rope, n)
            e0 = torch.zeros(n, h, s, device=dev)
            e0[:, :, 0] = 1.0  # the rollout chain starts at the CLS token
            with torch.inference_mode():
                c1 = fb._mhsa_ref(qkv, n, s, h, carry=e0, **rt)[1]
                o, lse = fb._mhsa_ref(qkv, n, s, h, want_lse=True, **rt)
            hold(nm("mhsa"), lambda: fb.mhsa(qkv, n, s, h, **rt),
                 lambda: fb._mhsa_ref(qkv, n, s, h, **rt))
            hold(nm("mhsa_train"),
                 lambda: fb.mhsa(qkv, n, s, h, want_lse=True, **rt),
                 lambda: fb._mhsa_ref(qkv, n, s, h, want_lse=True, **rt))
            hold(nm("mhsa_with_row"),
                 lambda: fb.mhsa_with_row(qkv, n, s, h, **rt),
                 lambda: fb._mhsa_ref(qkv, n, s, h, want_row=True, **rt))
            hold(nm("mhsa_rollout[block0]"),
                 lambda: fb.mhsa_rollout(qkv, e0, n, s, h, **rt),
                 lambda: fb._mhsa_ref(qkv, n, s, h, carry=e0, **rt))
            hold(nm("mhsa_rollout[block1,row]"),
                 lambda: fb.mhsa_rollout(qkv, c1, n, s, h, want_row=True,
                                         **rt),
                 lambda: fb._mhsa_ref(qkv, n, s, h, want_row=True, carry=c1,
                                      **rt))
            hold(nm("mhsa_abnar"), lambda: fb.mhsa_abnar(qkv, n, s, h, **rt),
                 lambda: fb._mhsa_ref(qkv, n, s, h, want_abnar=True, **rt))
            hold(nm("mhsa_bwd"),
                 lambda: fb.mhsa_bwd(qkv, o, do, lse, n, s, h, **rt),
                 lambda: fb._mhsa_bwd_ref(qkv, o, do, lse, n, s, h, **rt))
            del e0, c1, o, lse
        del qkv, do
        torch.cuda.empty_cache()

    # planted faults, each of which must break its limit
    def broken(name, kern, fault, rel=None):
        scale = fault.float().abs().max().item()
        err = (kern.float() - fault.float()).abs().max().item()
        lim = 2 * ulp_bf16(scale) if rel is None else rel * scale
        print(f"{tag} planted fault: {name}: max_abs_err={err:.6g} against "
              f"the limit {lim:.6g} ({err / lim:.4g}x); must break it")
        check(err > lim, f"planted fault {name} passes the limit")

    n, s, h = N_SLICES, S, HEADS
    qkv, do = rand(n * s, 3 * 64 * h), rand(n * s, 64 * h)
    with torch.inference_mode():
        o, lse = fb.mhsa(qkv, n, s, h, want_lse=True)
        # the row max of the neighbouring row in the LSE: m_{q+1} + log2 l_q
        t = qkv.reshape(n, s, 3, h, 64).permute(2, 0, 3, 1, 4)
        sc = fb._mm(t[0], t[1].transpose(-1, -2)) * (fb._LOG2E / 8.0)
        m = sc.amax(-1)
        l_ = torch.exp2(sc - m[..., None]).sum(-1)
        m_next = torch.cat([m[..., 1:], m[..., :1]], -1)
        lse_fault = (m_next + torch.log2(l_)).permute(0, 2, 1).reshape(n * s, h)
        broken("mhsa_train: the LSE with the row max of the neighbouring row",
               lse, lse_fault, KERNEL_GRAD_REL)
        del sc, m, l_, m_next, lse_fault
        # a stale key chunk: keys and values 64..127 of each slice read from
        # the chunk before
        stale = qkv.reshape(n, s, 3 * 64 * h).clone()
        stale[:, 64:128, 64 * h:] = stale[:, 0:64, 64 * h:]
        broken("mhsa: keys 64..127 from a stale chunk (0..63)", o,
               fb._mhsa_ref(stale.reshape(n * s, -1), n, s, h))
        del stale
        # V of the next head in the backward
        vnext = qkv.reshape(n * s, 3, h, 64).clone()
        vnext[:, 2] = vnext[:, 2].roll(-1, dims=1)
        broken("mhsa_bwd: V of the next head",
               fb.mhsa_bwd(qkv, o, do, lse, n, s, h),
               fb._mhsa_bwd_ref(vnext.reshape(n * s, -1), o, do, lse, n, s,
                                h))
        del vnext

    # each TMA kernel's entry as the first call of a fresh host thread: the
    # same bits as on this thread
    with torch.inference_mode():
        for name, fn in (("mhsa", lambda: fb.mhsa(qkv, n, s, h, want_lse=True)),
                         ("mhsa_bwd",
                          lambda: fb.mhsa_bwd(qkv, o, do, lse, n, s, h))):
            there, here = fresh_thread(fn), fn()
            torch.cuda.synchronize()
            there, here = ((there, here) if isinstance(here, tuple)
                           else ((there,), (here,)))
            same = all(torch.equal(u, v) for u, v in zip(there, here))
            print(f"{tag} {name} launched first in a fresh host thread: the "
                  f"same bits as on the main thread: {same}")
            check(same, f"{name} in a fresh thread differs")
    del qkv, do, o, lse
    torch.cuda.empty_cache()


def attn_times(tag, dev, fb):
    """Phase 43's times: each `mhsa` / `mhsa_bwd` form at its path shape
    (B=8: 256 slices) timed in turn with the PyTorch call for the same
    function where there is one (SDPA, its backward; with RoPE the rotation
    in torch ops first), beside the WMMA kernel's time and the SM clock;
    then the plain version and the bound (`attn_cost`). Reads only `fb`, so
    that it can time another tree's kernels. Returns (timed, cost,
    lib_ms)."""
    from mst_tpu_torch.ops.rotary import apply_rope_tables

    gen = torch.Generator(device=dev).manual_seed(SEED + 143)
    bf = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(bf)

    def sdpa(qkv, n, s, h, rope):
        q, k, v = heads_of(qkv, n, s, h)
        if rope is None:
            return functools.partial(F.scaled_dot_product_attention, q, k, v)
        return lambda: F.scaled_dot_product_attention(
            apply_rope_tables(q, *rope), apply_rope_tables(k, *rope), v)

    def sdpa_bwd(qkv, do, n, s, h, rope):
        leaves = [u.requires_grad_(True) for u in heads_of(qkv, n, s, h)]
        q, k, v = leaves
        if rope is not None:
            q, k = (apply_rope_tables(u, *rope) for u in (q, k))
        out = F.scaled_dot_product_attention(q, k, v)
        do_h = do.reshape(n, s, h, 64).permute(0, 2, 1, 3).contiguous()
        return functools.partial(torch.autograd.grad, out, leaves, do_h,
                                 retain_graph=True)

    timed, cost, lib_ms = {}, {}, {}
    print(f"{tag} times: median over {PAIR_ROUNDS} rounds of the mean of "
          f"{PER_PAIR} calls between two CUDA events, kernel and library "
          f"taken in turn; library: SDPA or its backward (with RoPE in torch "
          f"ops first), none for the CLS row, carry or Abnar factor; WMMA = "
          f"the kernel before this rewrite (PERF.md §6)")
    n = N_SLICES
    shapes = [(S, HEADS, False), (S3, HEADS, True)]
    shapes += [(S, h, False) for h in ATTN_HEADS[1:]] + [(ATTN_LONG[0], HEADS, False)]
    with ClockSampler() as clocks:
        for s, h, rope in shapes:
            qkv, do = rand(n * s, 3 * 64 * h), rand(n * s, 64 * h)
            tables = attn_tables(s, dev) if rope else None
            rt = (dict(rope_cos=tables[0], rope_sin=tables[1]) if rope
                  else {})
            tab = 2 * 4 * s * 64 if rope else 0
            m_rows = n * s
            with torch.no_grad():
                o, lse = fb.mhsa(qkv, n, s, h, want_lse=True, **rt)
            carry = torch.rand((n, h, s), generator=gen, device=dev)
            lib_f = sdpa(qkv, n, s, h, tables)
            lib_b = sdpa_bwd(qkv.clone(), do.clone(), n, s, h, tables)
            forms = [
                ("mhsa", lambda: fb.mhsa(qkv, n, s, h, **rt),
                 lambda: fb._mhsa_ref(qkv, n, s, h, **rt), lib_f,
                 attn_cost(n, s, tab, heads=h)),
                ("mhsa_bwd", lambda: fb.mhsa_bwd(qkv, o, do, lse, n, s, h, **rt),
                 lambda: fb._mhsa_bwd_ref(qkv, o, do, lse, n, s, h, **rt),
                 lib_b, attn_cost(n, s, tab, bwd=True, heads=h))]
            if h == HEADS and s in (S, S3):
                forms += [
                    ("mhsa_train",
                     lambda: fb.mhsa(qkv, n, s, h, want_lse=True, **rt),
                     lambda: fb._mhsa_ref(qkv, n, s, h, want_lse=True, **rt),
                     lib_f, attn_cost(n, s, tab + 4 * m_rows * h)),
                    ("mhsa_with_row",
                     lambda: fb.mhsa_with_row(qkv, n, s, h, **rt),
                     lambda: fb._mhsa_ref(qkv, n, s, h, want_row=True, **rt),
                     None, attn_cost(n, s, tab + 4 * n * h * s)),
                    ("mhsa_rollout[block1,row]",
                     lambda: fb.mhsa_rollout(qkv, carry, n, s, h,
                                             want_row=True, **rt),
                     lambda: fb._mhsa_ref(qkv, n, s, h, want_row=True,
                                          carry=carry, **rt),
                     None, attn_cost(n, s, tab + 3 * 4 * n * h * s)),
                    ("mhsa_abnar", lambda: fb.mhsa_abnar(qkv, n, s, h, **rt),
                     lambda: fb._mhsa_ref(qkv, n, s, h, want_abnar=True, **rt),
                     None, attn_cost(n, s, tab + 4 * n * s * s))]
            for form, kern, plain, library, c_ in forms:
                name = attn_name(form, h, s, rope)
                cost[name] = c_
                fns = {"kernel": kern}
                if library is not None:
                    fns["library"] = library
                t = time_interleaved(fns, clocks)
                with torch.no_grad():
                    pm_ = time_ms(plain, n=5, warmup=1)
                km = t["kernel"].ms
                lm = t["library"].ms if library is not None else None
                timed[name] = (km, pm_)
                if lm is not None:
                    lib_ms[name] = lm
                b_ms, b_by = bound([c_])
                wmma = WMMA_ATTN_MS.get(name)
                print(f"{tag} time {name} [{n}, {h}, {s}, 64]: kernel "
                      f"{km:.4f} ms ({c_[0] / km / 1e9:.1f} TFLOP/s, "
                      f"{c_[1] / km / 1e6:.1f} GB/s; rounds "
                      f"{t['kernel'].lo:.4f}-{t['kernel'].hi:.4f}; "
                      f"{t['kernel'].mhz} MHz, {t['kernel'].watts} W); "
                      + (f"library {lm:.4f} ms (kernel / library "
                         f"{km / lm:.3f}; {t['library'].mhz} MHz); "
                         if lm is not None else "library none; ")
                      + f"plain {pm_:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
                      f"({b_ms / km:.3f} of it); WMMA "
                      + (f"{wmma} ms ({wmma / km:.2f}x)" if wmma
                         else "not recorded"))
            del qkv, do, o, lse, carry, lib_f, lib_b, forms
            torch.cuda.empty_cache()
    return timed, cost, lib_ms



# Phases 34 and 44: the flash kernels (queue B rows 12-16) on TMA + wgmma.
# FLASH_HEADS: ViT-B, ViT-L and giant2 above 512 tokens (C3's head counts),
# at S = 1370 on 16 slices. MMA_FLASH_MS: the mma.sync kernels' times before
# this redesign (the mean of two readings by `flash_times` of the parent
# tree, in the call that read this tree's twice, on an H100 80GB HBM3 at 700
# W; PERF.md §6), printed beside the new ones.
FLASH_HEADS = (12, 16, 24)
MMA_FLASH_MS = {
    "flash_fwd[B8,S=1370]": 4.4807, "flash_fwd_train[B2,S=1370]": 1.1417,
    "flash_fwd[S=1601]": 0.8003, "flash_fwd[S=1029]": 0.7028,
    "flash_bwd_dq[B2,S=1370]": 1.3786, "flash_bwd_dkv[B2,S=1370]": 1.8389,
    "flash_bwd[B2,S=1370]": 3.2045}


def flash_chunked(fn):
    """`fn` (a plain attention function) over FLASH_CHUNK rows of the
    leading axis of its tensor arguments at a time, outputs joined, so that
    its [chunk, heads, S, S] f32 scores bound its memory."""
    def run(*a, **kw):
        n = next(x for x in a if torch.is_tensor(x)).shape[0]
        outs = [fn(*[x[i:i + FLASH_CHUNK] if torch.is_tensor(x) else x
                     for x in a], **kw)
                for i in range(0, n, FLASH_CHUNK)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(z) for z in zip(*outs))
        return torch.cat(outs)
    return run


def flash_plain_ops(fa):
    """The plain versions of the three flash kernels, FLASH_CHUNK slices at
    a time, in the shape of `fa.KERNELS`."""
    return SimpleNamespace(fwd=flash_chunked(fa.attention_reference),
                           bwd_dq=flash_chunked(fa._flash_bwd_dq_ref),
                           bwd_dkv=flash_chunked(fa._flash_bwd_dkv_ref))


def packed_heads(gen, dev, n, s, heads=HEADS):
    """q, k, v [n, heads, s, 64] bf16: the head views of one packed [n, s,
    3 * 64 * heads] qkv, as the composed `Attention` hands them over."""
    qkv = torch.randn(n, s, 3 * 64 * heads, generator=gen, device=dev).to(
        torch.bfloat16)
    return tuple(u.transpose(1, 2)
                 for u in qkv.view(n, s, 3, heads, 64).unbind(2))


def rope_heads(dev, q, k):
    """q, k rotated by DINOv3 ViT-S/16's RoPE tables at 512 px (32 x 32
    patches, 4 registers) as the composed `Attention` rotates its head
    views: dense [n, s, heads, 64] tensors, with other strides than the
    packed view v."""
    from mst_tpu_torch.ops.rotary import apply_rope_tables, rope_tables
    cos, sin = rope_tables((32, 32), 64, PREFIX3, 100.0, True, dev)
    return apply_rope_tables(q, cos, sin), apply_rope_tables(k, cos, sin)


def planted(tag, name, kern, fault, rel=None) -> None:
    """A planted fault: the kernel's output against the plain version of a
    faulty kernel must break the limit (2 bf16 ulps, or `rel` x |fault|max
    for f32)."""
    scale = fault.float().abs().max().item()
    err = (kern.float() - fault.float()).abs().max().item()
    lim = 2 * ulp_bf16(scale) if rel is None else rel * scale
    print(f"{tag} planted fault: {name}: max_abs_err={err:.6g} against the "
          f"limit {lim:.6g} ({err / lim:.4g}x); must break it")
    check(err > lim, f"planted fault {name} passes the limit")


def ring_stale(t, stages):
    """t [n, h, s, 64] with rows 64 * stages .. + 63 (box `stages`) read
    from rows 0..63: the box a ring of `stages` stages held before, had its
    stage been refilled before its empty barrier fired."""
    t = t.clone()
    t[:, :, 64 * stages:64 * stages + 64] = t[:, :, :64]
    return t


def flash_pad_fault(fa, q, k, v, do, lse, delta, sm):
    """(dk, dv) of a dk/dv kernel whose query rows past S in the last 64-row
    box came from the next slice (a map whose row extent is not S) with
    their LSE and delta left at 0, in the plain version's arithmetic."""
    pad = -q.shape[2] % 64

    def ext(t, fill=None):
        more = (t.roll(-1, 0)[:, :, :pad] if fill is None
                else torch.full(t.shape[:2] + (pad,), fill, dtype=t.dtype,
                                device=t.device))
        return torch.cat([t, more], 2)
    qe, de, le, dle = ext(q), ext(do), ext(lse, 0.0), ext(delta, 0.0)
    p = torch.exp2(fa._mm(qe, k.transpose(-1, -2)) * (sm * fa.LOG2E)
                   - le[..., None])
    dv = fa._mm(p.to(q.dtype).transpose(-1, -2), de).to(q.dtype)
    ds = (p * (fa._mm(de, v.transpose(-1, -2)) - dle[..., None])
          * sm).to(q.dtype)
    return fa._mm(ds.transpose(-1, -2), qe).to(q.dtype), dv


def check_flash_geometry(tag, fa, lib) -> None:
    """`attention.flash_launch` (the geometry the CPU tests read) against
    the kernels' own, `mst_flash_geometry`, on this card: every S from 1 to
    2048 on one (slice, head), and the path shapes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(1, 1, s) for s in range(1, 2049)]
    shapes += [(N_SLICES, HEADS, 1370), (LONG_B * DEPTH_SLICES, HEADS, 1370),
               (DEPTH_SLICES, HEADS, 1601),
               (LONG_B * DEPTH_SLICES, HEADS, 1029),
               (64, HEADS, 77)] + [(16, h, 1370) for h in FLASH_HEADS]
    for b, h, s in shapes:
        for part_i, part in enumerate(fa.FLASH_PARTS):
            geo = (ctypes.c_int * 9)()
            err = lib.mst_flash_geometry(b, h, s, part_i, geo)
            g = fa.flash_launch(b, h, s, part, sms)
            want = (g.rows, g.box, g.tiles, g.boxes, g.units, g.grid,
                    g.threads, g.stages, g.smem)
            check(err == 0 and tuple(geo) == want,
                  f"flash geometry {part} at [{b}, {h}, {s}]: kernel "
                  f"{tuple(geo)} ({err}), flash_launch {want}")
    g = fa.flash_launch(N_SLICES, HEADS, 1370, "dkv", sms)
    print(f"{tag} flash geometry: flash_launch equals mst_flash_geometry at "
          f"every S <= 2048 and the path shapes on {sms} SMs ([{N_SLICES}, "
          f"{HEADS}, 1370]: {g.units} units of {g.rows} rows on {g.grid} "
          f"blocks of {g.threads} threads, {g.boxes} boxes of {g.box} rows "
          f"through {g.stages} stages; dk/dv {g.smem} bytes of shared "
          f"memory)")


def flash_phase(tag, dev, fa, errs) -> SimpleNamespace:
    """Phase 34: `flash_fwd` (with and without the LSE), `flash_bwd_dq`
    (dq, delta) and `flash_bwd_dkv` (dk, dv) against their plain versions
    (FLASH_CHUNK slices at a time) under phase 3's limits, each twice for
    the same bits, at the B=8 serving shape [256, 6, 1370, 64] (forward),
    the B=2 step's [64, 6, 1370, 64], S = 1601, a ragged S = 77, DINOv3's S
    = 1029 with RoPE'd contiguous q, k beside a viewed v, and FLASH_HEADS at
    S = 1370; planted faults (sm_scale 0.13 for 1 / 8, a stale ring stage,
    padded query rows from the next slice with their LSE left at 0) that
    must break the limits; each kernel launched first in a fresh host
    thread. Records each case's largest error in `errs`; returns the plain
    versions for phases 35-36."""
    stamp(tag, "34")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sm = 1.0 / 8  # 1 / sqrt(64)
    plain = flash_plain_ops(fa)
    print(f"{tag} flash tolerance: bf16 outputs within 2 bf16 ulps of the "
          f"plain version's largest magnitude, f32 LSE / delta within "
          f"{KERNEL_GRAD_REL} x it (as phase 3); the plain version runs "
          f"{FLASH_CHUNK} slices at a time; each kernel twice for the same "
          f"bits; planted faults must break the limit")
    cases = [("B8,S=1370", N_SLICES, 1370, HEADS, False),
             ("B2,S=1370", LONG_B * DEPTH_SLICES, 1370, HEADS, False),
             ("S=1601", DEPTH_SLICES, 1601, HEADS, False),
             ("S=77", 64, 77, HEADS, False),
             ("S=1029,rope", LONG_B * DEPTH_SLICES, 1029, HEADS, True)]
    cases += [(f"E={64 * h},S=1370", 16, 1370, h, False) for h in FLASH_HEADS]
    for label, n, s, h, rope in cases:
        q, k, v = packed_heads(gen, dev, n, s, h)
        if rope:  # DINOv3 at 512 px: q, k rotated as the composed path does
            q, k = rope_heads(dev, q, k)
            check(q.stride() == k.stride() != v.stride(),
                  f"RoPE'd q, k {q.stride()} beside a viewed v {v.stride()}")
        o, lse = fa.flash_fwd(q, k, v, want_lse=True)
        o_serve = fa.flash_fwd(q, k, v)
        again = fa.flash_fwd(q, k, v, want_lse=True)
        torch.cuda.synchronize()
        po, plse = plain.fwd(q, k, v, sm, want_lse=True)
        name = f"flash_fwd[{label}]"
        errs[name] = check_outputs(tag, f"kernel {name}", (o, lse),
                                   (po, plse), KERNEL_GRAD_REL)
        check(torch.equal(o_serve, o) and torch.equal(again[0], o)
              and torch.equal(again[1], lse),
              f"{name}: the serving form or a second run gave other bits")
        planted(tag, f"{name}: sm_scale 0.13 for 1 / 8",
                fa.flash_fwd(q, k, v, sm_scale=0.13), po)
        del again, o_serve
        if label == "B8,S=1370":  # the serving shape: forward only
            continue
        do = torch.randn(o.shape, generator=gen, device=dev).to(o.dtype)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
        dq2, delta2 = fa.flash_bwd_dq(q, k, v, o, do, lse)
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        pdq, pdelta = plain.bwd_dq(q, k, v, o, do, lse, sm)
        pdk, pdv = plain.bwd_dkv(q, k, v, do, lse, delta, sm)
        for part, kern_, plain_ in (("dq", (dq, delta), (pdq, pdelta)),
                                    ("dkv", (dk, dv), (pdk, pdv))):
            name = f"flash_bwd_{part}[{label}]"
            errs[name] = check_outputs(tag, f"kernel {name}", kern_, plain_,
                                       KERNEL_GRAD_REL)
        check(all(torch.equal(a_, b_) for a_, b_ in (
            (dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2))),
            f"flash_bwd[{label}]: a second run gave other bits")
        del dq2, delta2, dk2, dv2, pdq, pdelta, pdk, pdv
        if label == "B2,S=1370":
            # a ring stage refilled before its empty barrier fired: box
            # STAGES read as box 0 (K, V; Q, dO with their LSE and delta)
            st = fa.FLASH_STAGES
            planted(tag, f"flash_fwd[{label}]: keys {64 * st}..{64 * st + 63}"
                    f" from a stale ring stage", o,
                    plain.fwd(q, ring_stale(k, st), ring_stale(v, st), sm))
            planted(tag, f"flash_bwd_dq[{label}]: a stale ring stage", dq,
                    plain.bwd_dq(q, ring_stale(k, st), ring_stale(v, st), o,
                                 do, lse, sm)[0])
            sdk, sdv = plain.bwd_dkv(
                ring_stale(q, st), k, v, ring_stale(do, st),
                ring_stale(lse[..., None], st)[..., 0],
                ring_stale(delta[..., None], st)[..., 0], sm)
            planted(tag, f"flash_bwd_dkv[{label}]: a stale ring stage (dk)",
                    dk, sdk)
            planted(tag, f"flash_bwd_dkv[{label}]: a stale ring stage (dv)",
                    dv, sdv)
            del sdk, sdv
            # each kernel's first launch in a fresh host thread (no current
            # context until the tensor-map encoding binds one)
            for kname, fn, here in (
                    ("flash_fwd", lambda: fa.flash_fwd(q, k, v, want_lse=True),
                     (o, lse)),
                    ("flash_bwd_dq",
                     lambda: fa.flash_bwd_dq(q, k, v, o, do, lse),
                     (dq, delta)),
                    ("flash_bwd_dkv",
                     lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
                     (dk, dv))):
                there = fresh_thread(fn)
                torch.cuda.synchronize()
                same = all(torch.equal(a_, b_) for a_, b_ in zip(there, here))
                print(f"{tag} {kname} launched first in a fresh host thread: "
                      f"the same bits as on the main thread: {same}")
                check(same, f"{kname} in a fresh thread differs")
        if label == "S=77":
            fdk, fdv = flash_pad_fault(fa, q, k, v, do, lse, delta, sm)
            planted(tag, f"flash_bwd_dkv[{label}]: query rows past S from "
                    f"the next slice, their LSE left at 0 (dk)", dk, fdk)
            planted(tag, f"flash_bwd_dkv[{label}]: the same (dv)", dv, fdv)
            del fdk, fdv
        del q, k, v, o, lse, po, plse, do, dq, delta, dk, dv
        torch.cuda.empty_cache()
    return plain


def flash_times(tag, dev, fa):
    """Phase 44: each flash kernel at its path shape timed in turn with the
    PyTorch call for the same function (SDPA; SDPA's backward, which gives
    dq, dk and dv in one call, for the backward kernels and their pair),
    beside the mma.sync kernel's time (`MMA_FLASH_MS`) and the SM clock;
    then the plain version and the bound (`flash_cost`: the backward's five
    products; the pair's seven executed products give its executed rate).
    Reads only `fa`, so that it can time another tree's kernels. Returns
    (timed, cost, lib_ms)."""
    stamp(tag, "44")
    gen = torch.Generator(device=dev).manual_seed(SEED + 144)
    sm = 1.0 / 8
    plain = flash_plain_ops(fa)
    timed, cost, lib_ms = {}, {}, {}
    print(f"{tag} flash times: median over {PAIR_ROUNDS} rounds of the mean "
          f"of {PER_PAIR} calls between two CUDA events, kernel and library "
          f"taken in turn; library: SDPA, or its backward (dq, dk, dv in one "
          f"call) for each backward kernel and the pair; bound: the "
          f"function's products (the backward's five); mma.sync = the kernel "
          f"before this redesign (PERF.md §6)")
    nb = LONG_B * DEPTH_SLICES
    with ClockSampler() as clocks:
        forms = []
        for label, n, s, lse in (("B8,S=1370", N_SLICES, 1370, False),
                                 ("B2,S=1370", nb, 1370, True),
                                 ("S=1601", DEPTH_SLICES, 1601, False),
                                 ("S=1029", nb, 1029, False)):
            q, k, v = packed_heads(gen, dev, n, s)
            if label == "S=1029":  # DINOv3: RoPE'd q, k, dense [n, s, h, 64]
                q, k = rope_heads(dev, q, k)
            name = f"flash_fwd{'_train' if lse else ''}[{label}]"
            forms.append((name, functools.partial(fa.flash_fwd, q, k, v,
                                                  want_lse=lse),
                          functools.partial(plain.fwd, q, k, v, sm,
                                            want_lse=lse),
                          functools.partial(F.scaled_dot_product_attention,
                                            q, k, v),
                          flash_cost(n, s, lse=lse), None))
        q, k, v = packed_heads(gen, dev, nb, 1370)
        o, lse = fa.flash_fwd(q, k, v, want_lse=True)
        do = torch.randn(o.shape, generator=gen, device=dev).to(o.dtype)
        _, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
        leaves = [u.detach().requires_grad_(True) for u in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        sdpa_bwd = functools.partial(torch.autograd.grad, out, leaves, do,
                                     retain_graph=True)

        def pair():
            dq_, delta_ = fa.flash_bwd_dq(q, k, v, o, do, lse)
            return dq_, fa.flash_bwd_dkv(q, k, v, do, lse, delta_)

        def plain_pair():
            dq_, delta_ = plain.bwd_dq(q, k, v, o, do, lse, sm)
            return dq_, plain.bwd_dkv(q, k, v, do, lse, delta_, sm)

        c_dq, c_dkv = (flash_cost(nb, 1370, part=p_) for p_ in ("dq", "dkv"))
        executed = FLASH_PAIR_PRODUCTS * 2 * nb * HEADS * 1370 ** 2 * 64
        forms += [
            ("flash_bwd_dq[B2,S=1370]",
             functools.partial(fa.flash_bwd_dq, q, k, v, o, do, lse),
             functools.partial(plain.bwd_dq, q, k, v, o, do, lse, sm),
             sdpa_bwd, c_dq, 3 * 2 * nb * HEADS * 1370 ** 2 * 64),
            ("flash_bwd_dkv[B2,S=1370]",
             functools.partial(fa.flash_bwd_dkv, q, k, v, do, lse, delta),
             functools.partial(plain.bwd_dkv, q, k, v, do, lse, delta, sm),
             sdpa_bwd, c_dkv, 4 * 2 * nb * HEADS * 1370 ** 2 * 64),
            ("flash_bwd[B2,S=1370]", pair, plain_pair, sdpa_bwd,
             (c_dq[0] + c_dkv[0], c_dq[1] + c_dkv[1]), executed)]
        for name, kern, plain_fn, library, c_, ran in forms:
            t = time_interleaved({"kernel": kern, "library": library}, clocks)
            with torch.no_grad():
                pm_ = time_ms(plain_fn, n=3, warmup=1)
            km, lm = t["kernel"].ms, t["library"].ms
            if name != "flash_bwd[B2,S=1370]":
                timed[name], cost[name], lib_ms[name] = (km, pm_), c_, lm
            b_ms, b_by = bound([c_])
            mma = MMA_FLASH_MS.get(name)
            print(f"{tag} time {name}: kernel {km:.4f} ms "
                  f"({c_[0] / km / 1e9:.1f} TFLOP/s of the function's work"
                  + (f", {ran / km / 1e9:.1f} executed" if ran else "")
                  + f"; rounds {t['kernel'].lo:.4f}-{t['kernel'].hi:.4f}; "
                  f"{t['kernel'].mhz} MHz, {t['kernel'].watts} W); library "
                  f"{lm:.4f} ms (kernel / library {km / lm:.3f}; "
                  f"{t['library'].mhz} MHz); plain {pm_:.4f} ms; bound "
                  f"{b_ms:.4f} ms by {b_by} ({b_ms / km:.3f} of it); mma.sync "
                  + (f"{mma} ms ({mma / km:.2f}x)" if mma else "not recorded"))
        del forms, q, k, v, o, lse, do, delta, leaves, out, sdpa_bwd
        torch.cuda.empty_cache()
    return timed, cost, lib_ms


# -- phase 45: `ln_pullback` and `ln_gemm_i8` redesigned --------------------

# The kernels they replace, timed at the path shapes by this script on an
# H100 80GB HBM3 at 700 W before the redesign (PERF.md §6): the earlier
# `ln_pullback` (a row-block kernel and two `sum_partials` passes) and the
# one-kernel `ln_gemm_i8` (LN + quantization in every column block, int8
# WMMA), printed beside the new times.
OLD_PB_MS = {"ln_pullback[E=384]": 0.3308, "ln_pullback[E=768]": 0.5331,
             "ln_pullback[E=1024]": 0.6883, "ln_pullback[E=1536]": 0.9359}
OLD_I8_MS = {"ln_gemm_i8[qkv]": 1.2149, "ln_gemm_i8[qkv,static]": 1.0015,
             "ln_gemm_i8[fc1,gelu_tanh]": 1.5015,
             "ln_gemm_i8[fc1,gelu_tanh,static]": 1.3104,
             "ln_gemm_i8_swiglu[w12]": 28.8196,
             "ln_gemm_i8_swiglu[w12,static]": 23.1355}
# Phase 46: the WMMA `gemm_i8_residual`'s times at the path shapes (PERF.md
# §6: the mean of two readings by `i8_residual_times` of the tree before
# the rewrite, in the call that timed the new kernel, on an H100 80GB HBM3
# at 700 W), printed beside the new ones.
OLD_I8R_MS = {"gemm_i8_residual[proj,ls]": 0.2443,
              "gemm_i8_residual[proj,ls,static]": 0.2274,
              "gemm_i8_residual[fc2,ls]": 0.6538,
              "gemm_i8_residual[fc2,ls,static]": 0.6462,
              "gemm_i8_residual[proj,E=1536,ls]": 2.3709,
              "gemm_i8_residual[proj,E=1536,ls,static]": 2.3734,
              "gemm_i8_residual[w3,ls]": 5.8193,
              "gemm_i8_residual[w3,ls,static]": 5.8272}


def inference(fn):
    """fn run under torch.inference_mode() (a thread's own setting)."""
    def run():
        with torch.inference_mode():
            return fn()
    return run


def pullback_i8_phase(tag, dev, fb, fq, layers):
    """Phase 45: `ln_pullback` at K = 384 / 768 / 1024 / 1536 and every
    `ln_gemm_i8` / `ln_gemm_i8_swiglu` mode, dynamic and static, at the
    ViT-S and giant2 shapes, against their plain versions under phase 7's
    and phase 31's limits: each first in a fresh host thread, then again
    for the same bits; the int8 GEMM also alone against its plain version
    on the kernel's own codes; four planted faults that must break their
    limits; then the times at the path shapes beside the library calls and
    the kernels these replace. Returns (timed, cost, lib_ms) for the
    kernels line."""
    stamp(tag, "45")
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 45)
    bf, eps = torch.bfloat16, 1e-6
    m_path = N_SLICES * S
    timed, cost, lib_ms = {}, {}, {}

    def rand(*shape, scale=1.0, off=0.0, dtype=torch.float32):
        return torch.from_numpy((off + scale * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev, dtype)

    def twice(name, kern):
        """kern() first in a fresh host thread, then here: the same bits."""
        k1 = fresh_thread(inference(kern))
        k2 = inference(kern)()
        torch.cuda.synchronize()
        t1, t2 = ((k if isinstance(k, tuple) else (k,)) for k in (k1, k2))
        same = all(torch.equal(a, b) for a, b in zip(t1, t2)
                   if a is not None)
        print(f"{tag} {name}: first in a fresh thread, then again: the same "
              f"bits {same}")
        check(same, f"{name}: two runs differ")
        return k1

    def broken(name, err, lim):
        print(f"{tag} planted fault: {name}: max_abs_err={err:.6g} against "
              f"the limit {lim:.6g} ({err / lim:.4g}x); must break it")
        check(err > lim, f"planted fault {name} passes the limit")

    # -- the LN pullback ----------------------------------------------------
    print(f"{tag} LN pullback redesign: dx within 2 bf16 ulps of plain, "
          f"dln_s / dln_b within {KERNEL_GRAD_REL} x |plain|max (phase 7's "
          f"limits), at K = {LN_GEMM_WIDTHS} on the path rows and ragged ones")
    pb = {}
    for k in LN_GEMM_WIDTHS:
        rows = [m_path, 771, 1] + ([N_SLICES * S3] if k == 384 else []) + (
            [STEP_B_G * 32 * S] if k == LN_GEMM_WIDTHS[-1] else [])
        for m in rows:
            x, g = rand(m, k, dtype=bf), rand(m, k, dtype=bf)
            dh, lns = rand(m, k), rand(k, scale=0.1, off=1.0)
            name = f"ln_pullback[E={k},M={m}]"
            kern = twice(name, lambda: fb.ln_pullback(dh, x, g, lns, eps))
            with torch.inference_mode():
                plain = fb._ln_pullback_ref(dh, x, g, lns, eps)
            check_outputs(tag, name, kern, plain, KERNEL_GRAD_REL)
            if m == m_path:
                pb[k] = (x, g, dh, lns, kern)
            del kern, plain
    # planted faults at K = 384: each row's rstd from the row before; the
    # column sums without the rows of the grid's first block
    x, g, dh, lns, (dx, dlns, _) = pb[384]
    with torch.inference_mode():
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
        xhat = (xf - mean) * rstd
        dxhat = dh * lns
        r1 = rstd.roll(1, 0)
        xh1 = (xf - mean) * r1
        dx_f = (r1 * (dxhat - dxhat.mean(-1, keepdim=True) - xh1 * (
            dxhat * xh1).mean(-1, keepdim=True)) + g.float()).to(bf)
        geo = fb.ln_pullback_launch(m_path, 384,
                                    torch.cuda.get_device_properties(dev)
                                    .multi_processor_count)
        groups = 8 // geo.warps_a_row
        keep = (torch.arange(m_path, device=dev) % (geo.grid * groups)
                ) >= groups
        dlns_f = (dh * xhat)[keep].sum(0)
    broken("ln_pullback[E=384] dx with each row's rstd from the row before",
           (dx.float() - dx_f.float()).abs().max().item(),
           2 * ulp_bf16(dx_f.float().abs().max().item()))
    broken(f"ln_pullback[E=384] dln_s without the rows of block 0 of "
           f"{geo.grid}", (dlns - dlns_f).abs().max().item(),
           KERNEL_GRAD_REL * dlns_f.abs().max().item())
    del xf, mean, rstd, xhat, dxhat, r1, xh1, dx_f, keep, dlns_f
    # times at the path shapes, beside the library call for the same work
    with ClockSampler() as clocks, torch.inference_mode():
        for k, (x, g, dh, lns, _) in pb.items():
            name = f"ln_pullback[E={k}]"
            xf = x.float()
            _, mean, rstd = torch.ops.aten.native_layer_norm(xf, (k,), lns,
                                                             None, eps)
            zero = torch.zeros_like(lns)
            t = time_interleaved({
                "kernel": lambda: fb.ln_pullback(dh, x, g, lns, eps),
                "library": lambda: torch.ops.aten.native_layer_norm_backward(
                    dh, xf, (k,), mean, rstd, lns, zero, [True, True, True])},
                clocks)
            pm_ = time_ms(lambda: fb._ln_pullback_ref(dh, x, g, lns, eps),
                          n=5, warmup=1)
            km, lm = t["kernel"].ms, t["library"].ms
            cost[name] = (10 * m_path * k, 4 * m_path * k
                          + 3 * 2 * m_path * k + 4 * 3 * k)
            timed[name], lib_ms[name] = (km, pm_), lm
            b_ms, b_by = bound([cost[name]])
            print(f"{tag} time {name} [{m_path}, {k}]: kernel {km:.4f} ms "
                  f"({cost[name][1] / km / 1e9:.3f} TB/s, {b_ms / km:.3f} of "
                  f"the bound; rounds {t['kernel'].lo:.4f}-"
                  f"{t['kernel'].hi:.4f}; {t['kernel'].mhz} MHz, "
                  f"{t['kernel'].watts} W); library "
                  f"(native_layer_norm_backward) {lm:.4f} ms (kernel / "
                  f"library {km / lm:.3f}; {t['library'].mhz} MHz); plain "
                  f"{pm_:.4f} ms; bound {b_ms:.4f} ms by {b_by}; before "
                  f"{OLD_PB_MS[name]} ms ({OLD_PB_MS[name] / km:.2f}x)")
            del xf, mean, rstd
    del pb, x, g, dh
    torch.cuda.empty_cache()

    # -- the int8 first products --------------------------------------------
    def node(k, n):
        q, sc = fq.quantize_weight_int8(rand(k, n, scale=k ** -0.5))
        return layers.QDense(q, sc, rand(n, scale=0.1))

    def margin(v):  # the calibration's per-tensor scale
        return v.float().abs().max().item() * 1.05 / 127.0

    print(f"{tag} int8 first products redesigned (ln_quant_rows + the int8 "
          f"wgmma GEMM): codes may differ from plain at .5 ties (at most "
          f"{CODE_FRAC}, by one), bf16 / f32 outputs within 2 bf16 ulps "
          f"(phase 31's limits); the GEMM alone on the kernel's own codes "
          f"under the same limits")
    faults = {}
    for e, label_e in ((E, ""), (1536, ",E=1536")):
        x = rand(m_path, e, dtype=bf)
        ln_s, ln_b = rand(e, scale=0.1, off=1.0), rand(e, scale=0.1)
        a_in = margin(fb._ln(x, ln_s, ln_b, eps))
        ln_s8, ln_b8 = ln_s / a_in, ln_b / a_in
        firsts = [("qkv", node(e, 3 * e), fb.ACT_NONE, False)]
        if e == E:
            firsts += [("fc1,gelu_tanh", node(e, 4 * e), fb.ACT_GELU_TANH,
                        False),
                       ("fc1,gelu_erf", node(e, 4 * e), fb.ACT_GELU_ERF,
                        False)]
        else:
            firsts += [("w12", node(e, 2 * LN_GEMM_F), None, True)]
        for label, nd, act, gated in firsts:
            # the static tree: LN and the dequant scale folded by a_in, the
            # FFN hidden quantized by a_inv (its calibrated scale)
            nd8 = layers.QDense(nd.q8, nd.scale * a_in, nd.bias)
            with torch.inference_mode():
                hid = (fq._ln_gemm_i8_swiglu_ref(x, ln_s, ln_b, nd.q8,
                                                 nd.scale, nd.bias, eps)
                       if gated else None if act == fb.ACT_NONE else
                       fq._ln_gemm_i8_ref(x, ln_s, ln_b, nd.q8, nd.scale,
                                          nd.bias, act, eps))
            a_inv = (None if hid is None else
                     torch.full((1, 1), 1.0 / margin(hid), device=dev))
            del hid
            forms = [(False, ln_s, ln_b, nd, None)]
            if "gelu_erf" not in label:
                forms.append((True, ln_s8, ln_b8, nd8, a_inv))
            if label == "qkv" and e == E:  # the codes of the identity
                forms.append((True, ln_s8, ln_b8, nd8,
                              torch.ones((1, 1), device=dev)))
            for static, ls_, lb_, nd_, ai in forms:
                # the kernels line's names: giant2's w12 without its width
                codes_form = ai is not None and act == fb.ACT_NONE
                name = (f"ln_gemm_i8_swiglu[{label}" if gated else
                        f"ln_gemm_i8[{label}{label_e}") + (
                    ",static" if static else "") + (
                    ",codes]" if codes_form else "]")
                if gated:
                    def kern(ls_=ls_, lb_=lb_, nd_=nd_, static=static, ai=ai):
                        return fq.ln_gemm_i8_swiglu(
                            x, ls_, lb_, nd_.q8, nd_.scale, nd_.bias, eps,
                            static, ai, q8t=nd_.q8t)

                    def plain(ls_=ls_, lb_=lb_, nd_=nd_, static=static,
                              ai=ai):
                        return fq._ln_gemm_i8_swiglu_ref(
                            x, ls_, lb_, nd_.q8, nd_.scale, nd_.bias, eps,
                            static, ai)
                else:
                    def kern(ls_=ls_, lb_=lb_, nd_=nd_, static=static, ai=ai):
                        return fq.ln_gemm_i8(
                            x, ls_, lb_, nd_.q8, nd_.scale, nd_.bias, act,
                            eps, static, ai, q8t=nd_.q8t)

                    def plain(ls_=ls_, lb_=lb_, nd_=nd_, static=static,
                              ai=ai):
                        return fq._ln_gemm_i8_ref(
                            x, ls_, lb_, nd_.q8, nd_.scale, nd_.bias, act,
                            eps, static, ai)
                out = twice(name, kern)
                with torch.inference_mode():
                    hq, hs = fq.ln_quant_rows(x, ls_, lb_, eps, static)
                    pq, ps = fq._quantize_ln(x, ls_, lb_, eps, static)
                    check_int8(tag, f"{name} ln_quant_rows", (hq,) if static
                               else (hq, hs), (pq,) if static else (pq, ps))
                    sc, bi = nd_.scale.reshape(-1), nd_.bias.reshape(-1)
                    ainv = None if ai is None else ai.reshape(1)
                    g_out = torch.empty_like(out)
                    mode = (fq.OUT_I8 if out.dtype == torch.int8 else
                            fq.OUT_BF16 if out.dtype == bf else fq.OUT_F32)
                    fq._gemm_i8(hq, hs, nd_.q8t, sc, bi, ainv, g_out, mode,
                                act or fb.ACT_NONE, gated)
                    g_ref = (fq._gemm_i8_swiglu_ref(hq, hs, nd_.q8t, sc, bi,
                                                    x.dtype, static, ai)
                             if gated else
                             fq._gemm_i8_ref(hq, hs, nd_.q8t, sc, bi, act,
                                             x.dtype, static, ai))
                    torch.cuda.synchronize()
                    check_int8(tag, f"{name} GEMM alone on the kernel's "
                               f"codes", g_out, g_ref)
                    check_int8(tag, name, out, plain())
                    if name == "ln_gemm_i8[qkv]":
                        faults["rows"] = (out, hq, hs, nd_, sc, bi)
                    if name == "ln_gemm_i8_swiglu[w12]":
                        faults["panels"] = (out, hq, hs, nd_, sc, bi)
                del out, hq, hs, pq, ps, g_out, g_ref
        # planted faults: a neighbour row's scale (qkv); the h1 / h2 panels
        # of w12 swapped (gated)
        with torch.inference_mode():
            if "rows" in faults:
                out, hq, hs, nd_, sc, bi = faults.pop("rows")
                f_ = fq._gemm_i8_ref(hq, hs.roll(1, 0), nd_.q8t, sc, bi,
                                     fb.ACT_NONE, bf)
                broken("ln_gemm_i8[qkv] with each row's scale from the row "
                       "before", (out.float() - f_.float()).abs().max().item(),
                       2 * ulp_bf16(f_.float().abs().max().item()))
                del out, hq, hs, f_
            if "panels" in faults:
                out, hq, hs, nd_, sc, bi = faults.pop("panels")
                f2 = LN_GEMM_F
                f_ = fq._gemm_i8_swiglu_ref(
                    hq, hs, torch.cat([nd_.q8t[f2:], nd_.q8t[:f2]]),
                    torch.cat([sc[f2:], sc[:f2]]),
                    torch.cat([bi[f2:], bi[:f2]]), bf)
                broken("ln_gemm_i8_swiglu[w12] with its h1 and h2 panels "
                       "swapped", (out - f_).abs().max().item(),
                       2 * ulp_bf16(f_.abs().max().item()))
                del out, hq, hs, f_
        check(not faults, f"planted int8 faults not run: {sorted(faults)}")
        del x
        torch.cuda.empty_cache()

    # times at the path shapes (B=8 rows): the wrapper (ln_quant_rows +
    # GEMM), each kernel alone and the library calls for the same work (LN,
    # quantization, `torch._int_mm`, dequantization in torch ops; dynamic
    # forms), in turn
    print(f"{tag} int8 times: median over {PAIR_ROUNDS} rounds of the mean "
          f"of {PER_PAIR} calls between two CUDA events, taken in turn; "
          f"chain = ln_quant_rows + GEMM (the wrapper); before = the "
          f"one-kernel ln_gemm_i8 (PERF.md §6)")
    shapes = [("ln_gemm_i8[qkv]", E, 3 * E, fb.ACT_NONE, False, False),
              ("ln_gemm_i8[qkv,static]", E, 3 * E, fb.ACT_NONE, False, True),
              ("ln_gemm_i8[fc1,gelu_tanh]", E, 4 * E, fb.ACT_GELU_TANH,
               False, False),
              ("ln_gemm_i8[fc1,gelu_tanh,static]", E, 4 * E,
               fb.ACT_GELU_TANH, False, True),
              ("ln_gemm_i8[qkv,E=1536]", 1536, 4608, fb.ACT_NONE, False,
               False),
              ("ln_gemm_i8_swiglu[w12]", 1536, 2 * LN_GEMM_F, None, True,
               False),
              ("ln_gemm_i8_swiglu[w12,static]", 1536, 2 * LN_GEMM_F, None,
               True, True)]
    with ClockSampler() as clocks, torch.inference_mode():
        for name, k, n, act, gated, static in shapes:
            x = rand(m_path, k, dtype=bf)
            ln_s, ln_b = rand(k, scale=0.1, off=1.0), rand(k, scale=0.1)
            if static:
                a_in = margin(fb._ln(x, ln_s, ln_b, eps))
                ln_s, ln_b = ln_s / a_in, ln_b / a_in
            nd = node(k, n)
            sc, bi = nd.scale.reshape(-1), nd.bias.reshape(-1)
            ai = (torch.full((1,), 0.02, device=dev)
                  if static and act != fb.ACT_NONE or static and gated
                  else None)
            n_out = n // 2 if gated else n
            hq, hs = fq.ln_quant_rows(x, ln_s, ln_b, eps, static)
            mode = (fq.OUT_I8 if ai is not None else fq.OUT_BF16
                    if act == fb.ACT_NONE else fq.OUT_F32)
            out = torch.empty(m_path, n_out, device=dev, dtype={
                fq.OUT_I8: torch.int8, fq.OUT_BF16: bf,
                fq.OUT_F32: torch.float32}[mode])
            if gated:
                def chain():
                    return fq.ln_gemm_i8_swiglu(x, ln_s, ln_b, nd.q8, nd.scale,
                                                nd.bias, eps, static, ai,
                                                q8t=nd.q8t)

                def plain():
                    return fq._ln_gemm_i8_swiglu_ref(x, ln_s, ln_b, nd.q8,
                                                     nd.scale, nd.bias, eps,
                                                     static, ai)
            else:
                def chain():
                    return fq.ln_gemm_i8(x, ln_s, ln_b, nd.q8, nd.scale,
                                         nd.bias, act, eps, static, ai,
                                         q8t=nd.q8t)

                def plain():
                    return fq._ln_gemm_i8_ref(x, ln_s, ln_b, nd.q8, nd.scale,
                                              nd.bias, act, eps, static, ai)

            def quant():
                return fq.ln_quant_rows(x, ln_s, ln_b, eps, static)

            def gemm():
                return fq._gemm_i8(hq, hs, nd.q8t, sc, bi, ai, out, mode,
                                   act or fb.ACT_NONE, gated)

            def library():
                h = F.layer_norm(x.float(), (k,), ln_s, ln_b, eps)
                if static:  # the fixed scale, folded into ln_s / ln_b
                    q, s_ = torch.round(h).clamp(-127, 127).to(torch.int8), 1.0
                else:
                    s_ = (h.abs().amax(-1, keepdim=True).clamp_min(1e-12)
                          / 127.0)
                    q = torch.round(h / s_).to(torch.int8)
                v = torch._int_mm(q, nd.q8).float() * s_ * nd.scale + nd.bias
                if gated:
                    h1, h2 = v.chunk(2, dim=-1)
                    v = F.silu(h1) * h2
                elif act == fb.ACT_NONE:
                    return v.to(bf)
                else:
                    v = F.gelu(v, approximate="tanh")
                if ai is None:
                    return v
                return torch.round(v * ai).clamp(-127, 127).to(torch.int8)
            fns = {"chain": chain, "ln_quant_rows": quant, "GEMM": gemm,
                   "library": library}
            t = time_interleaved(fns, clocks)
            pm_ = time_ms(plain, n=5, warmup=1)
            out_bytes = {fq.OUT_I8: 1, fq.OUT_BF16: 2, fq.OUT_F32: 4}[mode]
            cost[name] = i8_cost(m_path, k, n, 2, 0, out_bytes * m_path *
                                 n_out + 4 * (2 * k + 2 * n))
            km, gm, qm = t["chain"].ms, t["GEMM"].ms, t["ln_quant_rows"].ms
            timed[name] = (km, pm_)
            ops = 2 * m_path * k * n
            b_ms, b_by = bound([cost[name]])
            old = OLD_I8_MS.get(name)
            lib_ms[name] = t["library"].ms
            lib = (f"; library {t['library'].ms:.4f} ms (chain / library "
                   f"{km / t['library'].ms:.3f})")
            print(f"{tag} time {name} [{m_path}, {k}] -> {n}: chain "
                  f"{km:.4f} ms ({ops / km / 1e9:.1f} TOP/s; rounds "
                  f"{t['chain'].lo:.4f}-{t['chain'].hi:.4f}); ln_quant_rows "
                  f"{qm:.4f} + GEMM alone {gm:.4f} ms (GEMM {ops / gm / 1e9:.1f}"
                  f" TOP/s, {ops / gm / 1e9 / (PEAK_INT8 / 1e12):.3f} of the "
                  f"int8 peak; {t['GEMM'].mhz} MHz, {t['GEMM'].watts} W)"
                  f"{lib}; plain {pm_:.4f} ms; bound {b_ms:.4f} ms by {b_by}; "
                  f"before "
                  + (f"{old} ms ({old / km:.2f}x)" if old else "not recorded"))
            if not static and not gated:
                qname = f"ln_quant_rows[E={k}]"
                if qname not in timed:
                    timed[qname] = (qm, time_ms(lambda: fq._quantize_ln(
                        x, ln_s, ln_b, eps, False), n=5, warmup=1))
                    cost[qname] = (0, 3 * m_path * k + 4 * m_path + 8 * k)
                    qb, qby = bound([cost[qname]])
                    print(f"{tag} time {qname} [{m_path}, {k}]: {qm:.4f} ms "
                          f"({cost[qname][1] / qm / 1e9:.3f} TB/s), plain "
                          f"{timed[qname][1]:.4f} ms, bound {qb:.4f} ms by "
                          f"{qby}, library none (no one call quantizes)")
            del x, nd, hq, hs, out
            torch.cuda.empty_cache()
    return timed, cost, lib_ms


# -- phase 46: `gemm_i8_residual` on the int8 TMA + wgmma mainloop ---------

# (label, K, N) of the int8 second products: ViT-S proj and fc2, giant2
# proj and w3
I8R_SHAPES = (("proj", E, E), ("fc2", 4 * E, E), ("proj,E=1536", 1536, 1536),
              ("w3", LN_GEMM_F, 1536))


def i8r_inputs(dev, fq, layers, m, k, n, seed):
    """Seeded inputs of `gemm_i8_residual` at codes [m, k] -> [m, n]: the
    per-token codes and row scales of a standard normal hidden (dynamic),
    its static codes under a calibrated per-tensor scale (abs-max x 1.05 /
    127, folded into the column scale), x bf16, a quantized weight and a
    LayerScale. -> (dynamic (a, rs, node), static (a, None, node), x,
    ls)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(m, k, generator=gen, device=dev)
    a, rs = fq._quant_rows_ref(h)
    s_ = h.abs().max().item() * 1.05 / 127.0
    a8 = fq._quant_rows_ref(h / s_, True)
    del h
    q, sc = fq.quantize_weight_int8(
        torch.randn(k, n, generator=gen, device=dev) * k ** -0.5)
    nd = layers.QDense(q, sc, 0.1 * torch.randn(n, generator=gen, device=dev))
    nd8 = layers.QDense(q, sc * s_, nd.bias)
    x = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
    ls = 1.0 + 0.1 * torch.randn(n, generator=gen, device=dev)
    return (a, rs, nd), (a8, None, nd8), x, ls


def i8r_call(fq, a, rs, nd, ls, x):
    """`fq.gemm_i8_residual` on these operands, with the K-major weights
    where the wrapper takes them (an earlier tree's wrapper read q8)."""
    kw = ({"q8t": nd.q8t} if "q8t" in inspect.signature(
        fq.gemm_i8_residual).parameters else {})
    return fq.gemm_i8_residual(a, rs, nd.q8, nd.scale, nd.bias, ls, x, **kw)


def i8_residual_phase(tag, dev, fq, layers, lib):
    """Phase 46: `gemm_i8_residual` at every path shape (I8R_SHAPES) at the
    B=8 rows and the ragged 771 and 1, dynamic and static, with and without
    LayerScale, against `_gemm_i8_residual_ref` with 0 difference (the
    integer product is exact and the epilogue rounds as the plain version's
    ops do): each first in a fresh host thread, then again for the same
    bits; two planted faults (the second W box 64 rows further down, each
    row's scale from the row before) that must break it; and
    `fq.gemm_i8_residual_launch` against the kernel's
    `mst_i8_residual_geometry` on this card."""
    stamp(tag, "46")
    torch.cuda.empty_cache()
    m_path = N_SLICES * S
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m in (*BWD_M, 1):
        for k in range(fq.I8_BK, 4096 + 1, fq.I8_BK):
            for n in (384, 1536):
                geo = (ctypes.c_int * 7)()
                err = lib.mst_i8_residual_geometry(m, k, n, geo)
                check(err == 0, f"mst_i8_residual_geometry({m}, {k}, {n}): "
                      f"{err}")
                mine = fq.gemm_i8_residual_launch(m, k, n, sms)
                want = (mine.tiles, mine.grid, mine.threads, mine.stages,
                        mine.smem, mine.k_tiles, mine.second_box)
                check(tuple(geo) == want, f"mst_i8_residual_geometry at "
                      f"M={m}, {k} -> {n}: kernel {tuple(geo)}, mirror {want}")
    w3 = fq.gemm_i8_residual_launch(m_path, LN_GEMM_F, 1536, sms)
    print(f"{tag} gemm_i8_residual geometry: gemm_i8_residual_launch equals "
          f"the kernel's mst_i8_residual_geometry at K = 128 .. 4096, N = 384 "
          f"and 1536, M = {BWD_M} and 1 on {sms} SMs (giant2 w3: {w3.tiles} "
          f"tiles on {w3.grid} CTAs, {w3.k_tiles} k tiles of 128)")
    print(f"{tag} gemm_i8_residual redesigned (int8 TMA + wgmma, x read by "
          f"cp.async during the product): against the plain version on the "
          f"same codes with 0 difference, at M = {m_path} / 771 / 1")
    for si, (label, k, n) in enumerate(I8R_SHAPES):
        dyn, sta, x, ls = i8r_inputs(dev, fq, layers, m_path, k, n,
                                     SEED + 46 + si)
        for m in (m_path, *RAGGED_M):
            for static, (a, rs, nd) in ((False, dyn), (True, sta)):
                a, rs, xm = a[:m], None if rs is None else rs[:m], x[:m]
                for lsv in (ls, None):
                    name = (f"gemm_i8_residual[{label},"
                            f"{'ls' if lsv is not None else 'no_ls'}"
                            f"{',static' if static else ''},M={m}]")

                    def kern(a=a, rs=rs, nd=nd, lsv=lsv, xm=xm):
                        return i8r_call(fq, a, rs, nd, lsv, xm)
                    k1 = fresh_thread(inference(kern))
                    k2 = inference(kern)()
                    with torch.inference_mode():
                        plain = fq._gemm_i8_residual_ref(
                            a, rs, nd.q8, nd.scale, nd.bias, lsv, xm)
                    torch.cuda.synchronize()
                    same = torch.equal(k1, k2)
                    err = (k1.float() - plain.float()).abs().max().item()
                    print(f"{tag} {name}: max_abs_err={err:.6g} (limit 0); "
                          f"first in a fresh thread, then again: the same "
                          f"bits {same}")
                    check(same, f"{name}: two runs differ")
                    check(k1.shape == plain.shape and k1.dtype == plain.dtype
                          and torch.equal(k1, plain),
                          f"{name}: max_abs_err {err}")
                    if si == 0 and m == m_path and not static and lsv is ls:
                        fault_in = (k1, a, rs, nd, lsv, xm)
                    del k1, k2, plain
        del dyn, sta, x, a, rs, xm
        torch.cuda.empty_cache()
    # planted faults on ViT-S proj (dynamic, LayerScale): each tile's second
    # W box read 64 rows further down W^T (columns 64..127 of every
    # 128-column panel from the next 64); each row's scale from the row
    # before
    out, a, rs, nd, lsv, xm = fault_in
    n = nd.q8.shape[1]
    idx = torch.arange(n, device=dev)
    shifted = torch.where(idx % 128 >= 64, (idx + 64) % n, idx)
    with torch.inference_mode():
        for what, f_ in (
                ("the second W box 64 rows further down",
                 fq._gemm_i8_residual_ref(a, rs, nd.q8[:, shifted], nd.scale,
                                          nd.bias, lsv, xm)),
                ("each row's scale from the row before",
                 fq._gemm_i8_residual_ref(a, rs.roll(1, 0), nd.q8, nd.scale,
                                          nd.bias, lsv, xm))):
            err = (out.float() - f_.float()).abs().max().item()
            print(f"{tag} planted fault: gemm_i8_residual[proj,ls] with {what}"
                  f": max_abs_err={err:.6g} against the limit 0; must break "
                  f"it")
            check(err > 0, f"planted fault {what} passes the limit")
    del fault_in, out, a, rs, xm
    torch.cuda.empty_cache()


def i8_residual_times(tag, dev, fq, layers):
    """Phase 46's times: `gemm_i8_residual` at each path shape (B=8 rows,
    with LayerScale, dynamic and static) interleaved with the library call
    for the same function (`torch._int_mm`, the dequantization, then
    `torch.addcmul` of the residual), with the SM clock, beside the bound
    and the plain version. It reads only `fq` and `layers`, so a scratch
    script can time another tree's kernel with it. Returns (timed, cost,
    lib_ms) for the kernels line."""
    m = N_SLICES * S
    timed, cost, lib_ms = {}, {}, {}
    print(f"{tag} gemm_i8_residual times: median over {PAIR_ROUNDS} rounds "
          f"of the mean of {PER_PAIR} calls between two CUDA events, kernel "
          f"and library in turn; library = torch._int_mm, dequant, addcmul")
    with ClockSampler() as clocks, torch.inference_mode():
        for si, (label, k, n) in enumerate(I8R_SHAPES):
            dyn, sta, x, ls = i8r_inputs(dev, fq, layers, m, k, n,
                                         SEED + 46 + si)
            for static, (a, rs, nd) in ((False, dyn), (True, sta)):
                name = f"gemm_i8_residual[{label},ls{',static' * static}]"

                def library(a=a, rs=rs, nd=nd):
                    y = torch._int_mm(a, nd.q8).float()
                    if rs is not None:
                        y = y * rs[:, None]
                    y = y * nd.scale + nd.bias
                    return torch.addcmul(x.float(), y, ls).to(torch.bfloat16)
                t = time_interleaved({
                    "kernel": lambda a=a, rs=rs, nd=nd: i8r_call(
                        fq, a, rs, nd, ls, x),
                    "library": library}, clocks)
                pm_ = time_ms(lambda a=a, rs=rs, nd=nd:
                              fq._gemm_i8_residual_ref(a, rs, nd.q8, nd.scale,
                                                       nd.bias, ls, x),
                              n=5, warmup=1)
                km, lm = t["kernel"].ms, t["library"].ms
                cost[name] = i8_cost(m, k, n, 1, 2, 2 * m * n + 4 * (
                    3 * n + (0 if static else m)))
                timed[name], lib_ms[name] = (km, pm_), lm
                b_ms, b_by = bound([cost[name]])
                ops = 2 * m * k * n
                old = OLD_I8R_MS.get(name)
                print(f"{tag} time {name} [{m}, {k}] -> {n}: kernel {km:.4f} "
                      f"ms ({ops / km / 1e9:.1f} TOP/s, "
                      f"{ops / km / 1e9 / (PEAK_INT8 / 1e12):.3f} of the int8 "
                      f"peak; {cost[name][1] / km / 1e9:.3f} TB/s; "
                      f"{b_ms / km:.3f} of the bound; rounds "
                      f"{t['kernel'].lo:.4f}-{t['kernel'].hi:.4f}; "
                      f"{t['kernel'].mhz} MHz, {t['kernel'].watts} W); "
                      f"library {lm:.4f} ms (kernel / library {km / lm:.3f}; "
                      f"{t['library'].mhz} MHz); plain {pm_:.4f} ms; bound "
                      f"{b_ms:.4f} ms by {b_by}; before "
                      + (f"{old} ms ({old / km:.2f}x)" if old
                         else "not recorded"))
            del dyn, sta, x, a, rs, nd
            torch.cuda.empty_cache()
    return timed, cost, lib_ms



# -- phase 47: `quant_rows` on a ring of TMA bulk copies ---------------------

# (label, K, dtype) of the quantizer's inputs on the path: ViT-S o (bf16)
# and its f32 GELU hidden u, giant2 o and its f32 gate output g; and a row
# wider than one ring stage (f32, 36 KB: two stages). QR_STREAMED_K: a row
# wider than the whole ring (f32, 128 KB), which streams through it twice.
QR_SHAPES = (("o", E, torch.bfloat16), ("u", 4 * E, torch.float32),
             ("o,E=1536", 1536, torch.bfloat16),
             ("g", LN_GEMM_F, torch.float32), ("wide", 9216, torch.float32))
QR_STREAMED_K = 32768
# The modes each input is quantized in on the path (static trees quantize
# the FFN hidden in `ln_gemm_i8`'s epilogue) and timed in.
QR_TIMED = {"o": (False, True), "u": (False,), "o,E=1536": (False, True),
            "g": (False,), "wide": (False,)}
# The parent commit's `quant_rows` (one warp a row, each row read twice):
# (CUDA events around back-to-back calls, replayed from a CUDA graph) ms a
# call, read by `quant_rows_times` on its tree in turn with this tree's in
# one call, on an H100 80GB HBM3 at 700 W, the mean of two readings;
# printed beside the new times, each beside its own method's.
OLD_QR_MS = {"quant_rows[o]": (0.0448, 0.0307),
             "quant_rows[o,static]": (0.0399, 0.0289),
             "quant_rows[u]": (0.2997, 0.2839),
             "quant_rows[o,E=1536]": (0.1481, 0.1305),
             "quant_rows[o,E=1536,static]": (0.1182, 0.1039),
             "quant_rows[g]": (0.8242, 0.8081),
             "quant_rows[wide]": (1.8437, 1.8267)}


def lib_quant(v):
    """The library calls for `quant_rows`' dynamic work: amax, scale and
    rounding in torch ops."""
    sc = v.float().abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(v.float() / sc).to(torch.int8), sc


def lib_quant_static(v):
    """The library calls for `quant_rows`' static work."""
    return torch.round(v.float()).clamp(-127, 127).to(torch.int8)


def qr_name(label, static=False, m=None):
    return (f"quant_rows[{label}{',static' if static else ''}"
            + (f",M={m}]" if m is not None else "]"))


def qr_inputs(dev, m, k, dtype, seed):
    """Seeded inputs of `quant_rows` [m, k] in `dtype`: rows of normal
    values at magnitudes spread over three decades, each row's amax in its
    first column and values near .5 ties of its scale in the next four
    (dynamic); and the static
    input, the same values over a calibrated per-tensor scale (abs-max x
    1.05 / 127) times 1.3, so that some clip at +-127."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mag = 10.0 ** (3.0 * torch.rand(m, 1, generator=gen, device=dev) - 2.0)
    h = torch.randn(m, k, generator=gen, device=dev) * mag
    h[:, 0] = h.abs().amax(1)  # amax sits at column 0 (sign +)
    s_ = (h[:, :1] / 127.0).float()
    h[:, 1:5] = torch.tensor([0.5, 1.5, -2.5, 63.5], device=dev) * s_
    v = h.to(dtype)
    v8 = (h * (1.3 * 127.0 / (h.abs().max() * 1.05))).to(dtype)
    return v, v8


def quant_rows_phase(tag, dev, fq, lib, errs):
    """Phase 47: `quant_rows` at every path input (QR_SHAPES) at the B=8
    rows and the ragged 771 and 1, and a row wider than the ring at 771
    and 1, dynamic and static, against `_quant_rows_ref` with 0 difference
    in codes and scales (the kernel rounds as the plain version's ops do):
    each first in a fresh host thread, then again for the same bits; two
    planted faults (each row quantized with its neighbour's amax; the rows
    of a ring stage's second occupant read as its first occupant's) that
    must break it; and `fq.quant_rows_launch` against the kernel's
    `mst_quant_rows_geometry` on this card's SM count, 132 and 114."""
    stamp(tag, "47")
    torch.cuda.empty_cache()
    m_path = N_SLICES * S
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    widths = sorted({k for _, k, _ in QR_SHAPES} | {768, 3072, QR_STREAMED_K})
    for n_sm in sorted({sms, 132, 114}):
        for m in (m_path, *RAGGED_M):
            for k in widths:
                for dtype in (torch.bfloat16, torch.float32):
                    for static in (False, True):
                        geo = (ctypes.c_int * 12)()
                        err = lib.mst_quant_rows_geometry(
                            m, k, int(dtype == torch.float32), int(static),
                            n_sm, geo)
                        check(err == 0, f"mst_quant_rows_geometry({m}, {k}):"
                              f" {err}")
                        g = fq.quant_rows_launch(m, k, n_sm, dtype, static)
                        want = (g.grid, g.threads, g.smem, g.rows, g.chunks,
                                g.passes, g.streamed, g.wpr, g.groups, g.vec,
                                g.stage, g.stages)
                        check(tuple(geo) == want, f"mst_quant_rows_geometry "
                              f"at M={m}, K={k}, {dtype}, static={static}, "
                              f"{n_sm} SMs: kernel {tuple(geo)}, mirror "
                              f"{want}")
    geos = {label: fq.quant_rows_launch(m_path, k, sms, dt)
            for label, k, dt in QR_SHAPES}
    print(f"{tag} quant_rows geometry: quant_rows_launch equals the kernel's "
          f"mst_quant_rows_geometry at K = {widths}, bf16 and f32, dynamic "
          f"and static, M = {m_path} / 771 / 1 on {sorted({sms, 132, 114})} "
          f"SMs; on this card's {sms}: "
          + "; ".join(f"{lb}: {g.rows} rows x {g.chunks} stage(s) a group, "
                      f"{g.wpr} warps a row, {g.groups} groups on {g.grid} "
                      f"blocks" for lb, g in geos.items()))
    print(f"{tag} quant_rows redesigned (rows read once through a ring of "
          f"{geos['o'].stages} x {geos['o'].stage} B TMA bulk-copy stages, "
          f"{fq.QR_BLOCKS_PER_SM} persistent blocks an SM): against the plain "
          f"version with 0 difference in codes and scales")
    cases = [(label, k, dt, (m_path, *RAGGED_M)) for label, k, dt in QR_SHAPES]
    cases.append(("streamed", QR_STREAMED_K, torch.float32, RAGGED_M))
    fault_in = None
    for si, (label, k, dtype, ms) in enumerate(cases):
        v, v8 = qr_inputs(dev, max(ms), k, dtype, SEED + 47 + si)
        for m in ms:
            for static in (False, True):
                vm = (v8 if static else v)[:m]
                name = qr_name(label, static, m)

                def kern(vm=vm, static=static):
                    return fq.quant_rows(vm, static)
                k1 = fresh_thread(inference(kern))
                k2 = inference(kern)()
                with torch.inference_mode():
                    plain = fq._quant_rows_ref(vm, static)
                torch.cuda.synchronize()
                k1, k2, plain = ((t,) if static else t
                                 for t in (k1, k2, plain))
                same = all(torch.equal(a, b) for a, b in zip(k1, k2))
                nd = int((k1[0] != plain[0]).sum())
                step = int((k1[0].int() - plain[0].int()).abs().max())
                sc_err = (0.0 if static else
                          (k1[1] - plain[1]).abs().max().item())
                print(f"{tag} {name} {str(dtype).split('.')[-1]}: codes "
                      f"differing {nd} of {vm.numel()} (by at most {step}), "
                      f"scales max_abs_err={sc_err:.6g} (limit 0); first in "
                      f"a fresh thread, then again: the same bits {same}")
                check(same, f"{name}: two runs differ")
                check(all(a.shape == b.shape and a.dtype == b.dtype
                          and torch.equal(a, b) for a, b in zip(k1, plain)),
                      f"{name}: {nd} codes differ (by {step}), scales by "
                      f"{sc_err}")
                errs[name] = float(step)
                if label == "u" and m == m_path and not static:
                    fault_in = (k1[0], vm, fq.quant_rows_launch(m, k, sms,
                                                                dtype))
                del k1, k2, plain, vm
        del v, v8
        torch.cuda.empty_cache()
    # planted faults on ViT-S u (f32, dynamic): each row quantized with the
    # next row's amax; the rows of the group that takes ring stage 0 of
    # block 0 for the second time read as its first group's rows
    out, vm, geo = fault_in
    g2 = geo.stages * geo.grid  # block 0's (stages + 1)-th group: stage 0
    check(g2 < geo.groups, f"no second occupant of stage 0: {geo}")
    stale = vm.clone()
    stale[g2 * geo.rows:(g2 + 1) * geo.rows] = vm[:geo.rows]
    with torch.inference_mode():
        vf = vm.float()
        nscale = fq._quant_rows_ref(vm)[1].roll(-1, 0)
        for what, f_ in (
                ("each row with its neighbour's amax",
                 torch.round(vf * torch.reciprocal(nscale)[:, None])
                 .clamp(-128, 127).to(torch.int8)),
                (f"the rows of group {g2} (ring stage 0's second occupant in "
                 f"block 0) read as group 0's", fq._quant_rows_ref(stale)[0])):
            nd = int((out != f_).sum())
            print(f"{tag} planted fault: quant_rows[u] with {what}: codes "
                  f"differing {nd} against the limit 0; must break it")
            check(nd > 0, f"planted fault {what} passes the limit")
    del fault_in, out, vm, stale, vf, nscale
    torch.cuda.empty_cache()


def graph_ms(fn, n=10, reps=5):
    """The time of one call of fn with no host gaps: n calls captured in a
    CUDA graph, the graph replayed `reps` times between two CUDA events,
    the median over n. (CUDA events around back-to-back calls also hold
    the host's time where the host is slower than the kernels.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    each = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        each.append(start.elapsed_time(end) / n)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(each)


def quant_rows_times(tag, dev, fq):
    """Phase 47's times: `quant_rows` at each path input (B=8 rows) in the
    modes the path runs (QR_TIMED) and the row wider than a stage,
    interleaved with the library calls for the same function (`lib_quant`,
    `lib_quant_static`), with the SM clock, beside the bound, the plain
    version, and, as an extra reading, the kernel's time per call replayed
    from a CUDA graph (`graph_ms`: no host time between calls); each of
    the kernel's times beside the parent commit's read the same way
    (OLD_QR_MS); and the sha256 of its codes and scales. It reads only
    `fq`, so a scratch script can time another tree's kernel with it, and
    equal digests on two trees mean the same bits on these inputs. Returns (timed, cost, lib_ms, graph) for the
    kernels line: its times the event times, as every other kernel's."""
    m = N_SLICES * S
    timed, cost, lib_ms, graph = {}, {}, {}, {}
    print(f"{tag} quant_rows times: median over {PAIR_ROUNDS} rounds of the "
          f"mean of {PER_PAIR} calls between two CUDA events, kernel and "
          f"library in turn; library = the same quantization in torch ops")
    with ClockSampler() as clocks, torch.inference_mode():
        for si, (label, k, dtype) in enumerate(QR_SHAPES):
            v, v8 = qr_inputs(dev, m, k, dtype, SEED + 47 + si)
            es = v.element_size()
            for static in QR_TIMED[label]:
                vin = v8 if static else v
                name = qr_name(label, static)
                t = time_interleaved({
                    "kernel": lambda vin=vin, st=static: fq.quant_rows(vin, st),
                    "library": functools.partial(
                        lib_quant_static if static else lib_quant, vin)},
                    clocks)
                pm_ = time_ms(lambda vin=vin, st=static:
                              fq._quant_rows_ref(vin, st), n=5, warmup=1)
                km, lm = t["kernel"].ms, t["library"].ms
                dm = graph_ms(lambda vin=vin, st=static: fq.quant_rows(vin, st))
                cost[name] = (0, es * m * k + m * k + (0 if static else 4 * m))
                timed[name], lib_ms[name], graph[name] = (km, pm_), lm, dm
                out = fq.quant_rows(vin, static)
                bits = hashlib.sha256()
                for t_ in (out,) if static else out:
                    bits.update(t_.cpu().numpy().tobytes())
                del out
                b_ms, b_by = bound([cost[name]])
                old_km, old_dm = OLD_QR_MS.get(name, (None, None))
                print(f"{tag} time {name} [{m}, {k}] "
                      f"{str(dtype).split('.')[-1]}: kernel {km:.4f} ms "
                      f"({cost[name][1] / km / 1e9:.3f} TB/s; "
                      f"{b_ms / km:.3f} of the bound; rounds "
                      f"{t['kernel'].lo:.4f}-{t['kernel'].hi:.4f}; "
                      f"{t['kernel'].mhz} MHz, {t['kernel'].watts} W); "
                      f"graph-replayed {dm:.4f} ms a call ("
                      f"{b_ms / dm:.3f} of the bound); "
                      f"library {lm:.4f} ms (kernel / library {km / lm:.3f}; "
                      f"{t['library'].mhz} MHz); plain {pm_:.4f} ms; bound "
                      f"{b_ms:.4f} ms by {b_by}; parent's kernel "
                      + (f"{old_km} ms ({old_km / km:.2f}x), graph-replayed "
                         f"{old_dm} ms ({old_dm / dm:.2f}x)" if old_km
                         else "not recorded")
                      + f"; codes and scales sha256 {bits.hexdigest()[:32]}")
            del v, v8, vin
            torch.cuda.empty_cache()
    return timed, cost, lib_ms, graph


# Phase 48: the host data path. Limits of each device op, CUDA f32 vs the
# same function on the CPU in f64, as max |diff| / max |reference|: a
# few times the f32 rounding each op can gather (the z-norm's and resize's
# sums over 1.6 M voxels; the rotation's f32 source coordinates, one ulp
# at radius 112 px) and far below what each planted fault moves.
DATA_LIMITS = {"clamp": 0.0, "rescale": 1e-6, "znorm": 1e-5, "resize": 1e-5,
               "rotate": 1e-4, "flip": 0.0, "invert": 0.0}
# a rotated mask: voxels whose nearest tap sits on the plane's edge within
# f32 rounding may differ from the f64 reference
DATA_MASK_FRAC = 1e-4
DATA_ANGLES = (0.3, 0.8, 1.3)
DATA_CASES = 16
LOOP_SAMPLES = 64  # an epoch of the timed train loops: 8 batches of 8
MRNET_AFFINE = np.diag([3.0, 0.45, 0.5, 1.0])  # slice axis x: 3 mm


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, on the CPU in f64."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def mask_frac(got, ref) -> float:
    return float((got.cpu() != ref.cpu()).float().mean())


def loop_seconds(dm, step, dev, profile=False):
    """One train epoch of `dm` through `step` (loader, copy, augmentation
    and step overlapped as `Trainer.fit` runs them; no step: the loader
    alone) -> (volumes, wall s, device busy s or None). With `profile` the
    device's busy time comes from `torch.profiler` over the same loop."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    ctx = (tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profile else contextlib.nullcontext())
    n = 0
    with ctx as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for batch in dm.train_dataloader():
            tgt = torch.from_numpy(batch["target"]).pin_memory().to(
                dev, torch.long, non_blocking=True)
            if step is not None:
                step(batch["source"], tgt, batch.get("src_key_padding_mask"))
            n += len(batch["uid"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    busy = None
    if profile:
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation) / 1e6
    return n, wall, busy


def data_phase(tag, dev, fb, per_step) -> None:
    """Phase 48: the host data path end to end on the card (see the module
    docstring); `per_step` is phase 8's launch counts of one B=8 step."""
    stamp(tag, "48")
    from mst_tpu_torch import predict as predict_cli
    from mst_tpu_torch.data import fixtures, native_io
    from mst_tpu_torch.data import transforms as T
    from mst_tpu_torch.data.datamodule import DataModule, _collate
    from mst_tpu_torch.data.datasets.base import load_volume_dhw
    from mst_tpu_torch.data.datasets.duke import DUKE_Dataset3D
    from mst_tpu_torch.data.datasets.lidc import LIDC_Dataset3D
    from mst_tpu_torch.data.datasets.mrnet import MRNet_Dataset3D
    from mst_tpu_torch.models.vit_fast import mst_logits
    from mst_tpu_torch.train import cli
    from mst_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from mst_tpu_torch.utils.nifti import read_nifti

    torch.cuda.empty_cache()
    base = ROOT / "build" / "chip_smoke_data"  # gitignored
    shutil.rmtree(base, ignore_errors=True)

    # -- decode: the native reader built here, against the numpy reader ----
    t1 = time.perf_counter()
    lib_path = native_io.build()
    native_io.lib()
    sec_build = time.perf_counter() - t1
    t1 = time.perf_counter()
    splits = ("train", "train", "val", "test")  # 8 / 4 / 4 cases
    lidc_root = fixtures.write_lidc(base / "lidc", DATA_CASES, seed=SEED,
                                    splits=splits)
    mrnet_root, slices = fixtures.write_mrnet(
        base / "mrnet", DATA_CASES, seed=SEED, splits=splits,
        affine=MRNET_AFFINE)
    sec_write = time.perf_counter() - t1
    paths = sorted(base.rglob("*.nii.gz"))
    threads = max(1, min(8, (os.cpu_count() or 1) - 1))
    t1 = time.perf_counter()
    native = native_io.read_nifti_batch(paths, num_threads=threads)
    sec_native = time.perf_counter() - t1
    t1 = time.perf_counter()
    plain = [load_volume_dhw(q, native=False) for q in paths]
    sec_plain = time.perf_counter() - t1
    differ = [q.name for q, (v, a), (pv, pa) in zip(paths, native, plain)
              if not (v.dtype == pv.dtype and np.array_equal(v, pv)
                      and np.array_equal(a, pa))]
    mb = sum(v.nbytes for v, _ in native) / 1e6
    print(f"{tag} data: native reader built in {sec_build:.2f} s -> "
          f"{lib_path.relative_to(ROOT)}; {DATA_CASES} LIDC cases and "
          f"{DATA_CASES} MRNet stacks written in {sec_write:.2f} s; "
          f"{len(paths)} NIfTI files ({mb:.1f} MB decoded f32): native "
          f"batch read ({threads} threads) {sec_native:.3f} s, numpy reader "
          f"{sec_plain:.3f} s; files whose volume or affine differ: {differ} "
          f"(must be none)")
    check(not differ, f"native vs numpy NIfTI reads differ: {differ}")
    want = fixtures.duke_arrays()
    h5 = fixtures.DUKE_FIXTURE / "data_compressed.h5"
    items = [(h5, f"{pid}/{k}") for pid in want for k in ("sub",
                                                          "sub_affine")]
    outs = native_io.h5_read_batch(items, num_threads=threads)
    bad = [pid for (pid, (v, a)), ov, oa in zip(want.items(), outs[::2],
                                                outs[1::2])
           if not (ov.dtype == v.dtype and np.array_equal(ov, v)
                   and np.array_equal(oa, a))]
    print(f"{tag} data: h5lite on the DUKE fixture ({h5.stat().st_size} "
          f"bytes, gzip + shuffle chunks): {len(want)} volumes and affines "
          f"vs the seeded arrays, differing: {bad} (must be none)")
    check(not bad, f"h5lite vs the DUKE fixture's arrays: {bad}")

    # -- the device ops on the card vs the CPU in f64 -----------------------
    lidc_val = LIDC_Dataset3D(lidc_root, split="train")
    mrnet_val = MRNet_Dataset3D(mrnet_root, split="train")
    hb = _collate([lidc_val[i] for i in range(4)])
    mbt = _collate([mrnet_val[i] for i in range(4)])
    hu = torch.from_numpy(hb["source"])
    mvol = torch.from_numpy(mbt["source"])
    mmask = torch.from_numpy(mbt["mask"])
    angles = torch.tensor(DATA_ANGLES + (0.55,), dtype=torch.float32)
    flags = torch.tensor([[1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0]],
                         dtype=torch.bool)
    invert = torch.tensor([True, False, True, False])
    cpu64 = torch.device("cpu")

    def both(fn, *args):
        """fn on the card in f32 and on the CPU in f64 (tensors moved)."""
        on = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        ref = [a.to(cpu64, torch.float64) if torch.is_tensor(a)
               and a.is_floating_point() else a for a in args]
        return fn(*on), fn(*ref)

    errs = {}
    got, ref = both(lambda x: T.clamp(x, -1000.0, 1000.0), hu)
    errs["clamp"] = rel_err(got, ref)
    lidc_r = T.rescale_intensity(T.clamp(hu, -1000.0, 1000.0))
    got, ref = both(T.rescale_intensity, T.clamp(hu, -1000.0, 1000.0))
    errs["rescale"] = rel_err(got, ref)
    got, ref = both(lambda x: T.znorm_percentile(x, (0.5, 99.5)), hu)
    errs["znorm[0.5,99.5]"] = rel_err(got, ref)
    got, ref = both(T.resize_trilinear, mvol, (32, 224, 224))
    errs["resize"] = rel_err(got, ref)
    mres = T.resize_trilinear(mmask.to(dev).float(), (32, 224, 224)) > 0.5
    mres_ref = T.resize_trilinear(mmask.double(), (32, 224, 224)) > 0.5
    errs["resize mask"] = mask_frac(mres, mres_ref)
    big = got.float().cpu()  # the resized MRNet volumes
    got, ref = both(lambda x: T.znorm_percentile(x, (0.0, 100.0)), big)
    errs["znorm[0,100]"] = rel_err(got, ref)
    zn = ref.float()
    got, ref = both(T.rotate_z, zn, angles)
    errs["rotate"] = rel_err(got, ref)
    rmask = T.rotate_z(mres.to(dev).float(), angles.to(dev), fill=0.0,
                       nearest=True) > 0.5
    rmask_ref = T.rotate_z(mres_ref.double(), angles, fill=0.0,
                           nearest=True) > 0.5
    errs["rotate mask"] = mask_frac(rmask, rmask_ref)
    got, ref = both(T.apply_flips, zn, flags)
    errs["flip"] = rel_err(got, ref)
    fm = T.apply_flips(mres.to(dev), flags.to(dev))
    errs["flip mask"] = mask_frac(fm, T.apply_flips(mres_ref, flags))
    got, ref = both(lambda x, f: T.apply_augment(T.AugmentConfig(), x, None,
                                                 {"invert": f})[0],
                    lidc_r, invert)
    errs["invert"] = rel_err(got, ref)
    limit_of = {"clamp": DATA_LIMITS["clamp"],
                "rescale": DATA_LIMITS["rescale"],
                "znorm[0.5,99.5]": DATA_LIMITS["znorm"],
                "znorm[0,100]": DATA_LIMITS["znorm"],
                "resize": DATA_LIMITS["resize"], "resize mask": 0.0,
                "rotate": DATA_LIMITS["rotate"],
                "rotate mask": DATA_MASK_FRAC, "flip": DATA_LIMITS["flip"],
                "flip mask": 0.0, "invert": DATA_LIMITS["invert"]}
    print(f"{tag} data ops on the card in f32 vs the CPU in f64: LIDC HU "
          f"crops {list(hu.shape)} (clamp, rescale, z-norm, inversion), "
          f"MRNet crops {list(mvol.shape)} resized to 224 px (resize, "
          f"z-norm, then rotation at {list(DATA_ANGLES)} and 0.55 rad, "
          f"flips); max |diff| / max |f64|, for a mask the share of voxels "
          f"that differ")
    for name, err in errs.items():
        print(f"{tag} data op {name}: {err:.6g} (limit "
              f"{limit_of[name]:.3g})")
        check(err <= limit_of[name], f"data op {name}: {err}")
    # planted faults, each against the op's own reference
    zn_dev = zn.to(dev)
    faults = {
        "rotate, the angle off by 1e-2": (rel_err(T.rotate_z(
            zn_dev, angles.to(dev) + 1e-2), ref_rot := T.rotate_z(
            zn.double(), angles)), DATA_LIMITS["rotate"]),
        "rotate, the fill taken as 0": (rel_err(T.rotate_z(
            zn_dev, angles.to(dev), fill=0.0), ref_rot),
            DATA_LIMITS["rotate"]),
        "flip, the D and H flags swapped": (rel_err(T.apply_flips(
            zn_dev, flags[:, [1, 0, 2]].to(dev)), T.apply_flips(
            zn.double(), flags)), DATA_LIMITS["flip"]),
        "rotated mask, the angle off by 1e-2": (mask_frac(T.rotate_z(
            mres.to(dev).float(), angles.to(dev) + 1e-2, fill=0.0,
            nearest=True) > 0.5, rmask_ref), DATA_MASK_FRAC),
    }
    for name, (err, limit) in faults.items():
        print(f"{tag} data planted fault: {name}: {err:.6g} (must exceed "
              f"the limit {limit:.3g})")
        check(err > limit, f"the limit {limit} would pass: {name}")
    del big, zn, zn_dev, got, ref, ref_rot

    # -- train at B=8 through the CLI's builders, predict -------------------
    runs = {}
    for name, root in (("LIDC", lidc_root), ("MRNet", mrnet_root)):
        targs = cli.parse_args(["--dataset", name, "--path_root", str(root),
                                "--batch_size", str(BATCH), "--max_epochs",
                                "1", "--num_train_samples", "16", "--seed",
                                str(SEED)])
        dm = cli.build_datamodule(targs, dev)
        model = cli.build_model(targs)
        run = base / "runs" / name
        t1 = time.perf_counter()
        _, result = cli.train(targs, model, dm, cli.build_trainer(
            targs, dm, run_dir=run))
        sec_fit = time.perf_counter() - t1
        hist = [json.loads(line) for line in
                (run / "history.jsonl").read_text().splitlines()]
        batch = next(iter(dm.train_dataloader()))
        src, pad = batch["source"], batch.get("src_key_padding_mask")
        tgt = torch.from_numpy(batch["target"]).to(dev, torch.long)
        step = make_train_step(TrainState(model, make_optimizer(
            model.parameters(), 0.0)))
        fb.reset_launch_counts()
        loss, _ = step(src, tgt, pad)
        torch.cuda.synchronize()
        counts = fb.launch_counts()
        print(f"{tag} data: train --dataset {name} B={BATCH} one epoch "
              f"({len(dm.ds_train)} train / {len(dm.ds_val)} val cases, "
              f"16 samples): {sec_fit:.2f} s, history "
              f"{[{k: v for k, v in r.items() if not k.startswith('perf/')} for r in hist]}; "
              f"a train batch {list(src.shape)} {src.dtype}, loss "
              f"{loss.item():.6g}, launches {counts}")
        check(tuple(src.shape) == (BATCH, 1, DEPTH_SLICES, PX, PX)
              and src.device == dev, f"{name} batch {tuple(src.shape)}")
        check(all(math.isfinite(r["train_loss"]) for r in hist)
              and math.isfinite(loss.item()), f"{name}: non-finite loss")
        check_launches(counts, per_step, f"{name} train step")
        runs[name] = (run, model, dm, batch)

    # MRNet's padding mask: the slice counts, and probs blind to the pad,
    # on the train split's 8 cases in order (the odd IDs are padded)
    run, model, dm, _ = runs["MRNet"]
    batch = next(iter(DataModule(ds_val=dm.ds_train, batch_size=BATCH,
                                 device=dev).val_dataloader()))
    pad = batch["src_key_padding_mask"]
    real = [min(DEPTH_SLICES, slices[u]) for u in batch["uid"]]
    got_real = (~pad).sum(1).tolist()
    print(f"{tag} data: MRNet batch uids {batch['uid']}, slices "
          f"{[slices[u] for u in batch['uid']]}: real slices by "
          f"src_key_padding_mask {got_real} (must be {real})")
    check(pad.dtype == torch.bool and tuple(pad.shape) == (BATCH, DEPTH_SLICES)
          and got_real == real and bool(pad.any()),
          f"src_key_padding_mask {got_real} != {real}")
    src = batch["source"]
    noisy = src.clone()
    sel = pad[:, None, :, None, None].expand_as(noisy)
    noisy[sel] = torch.randn(int(sel.sum()), device=dev,
                             generator=torch.Generator(dev).manual_seed(SEED))
    with torch.inference_mode():
        p1 = torch.softmax(mst_logits(model, src, pad).float(), -1)
        p2 = torch.softmax(mst_logits(model, noisy, pad).float(), -1)
        p3 = torch.softmax(mst_logits(model, noisy, None).float(), -1)
    leak = (p3 - p1).abs().max().item()
    print(f"{tag} data: MRNet B={BATCH} fused probs with the padded slices' "
          f"voxels replaced: max |diff| {(p2 - p1).abs().max().item():.6g} "
          f"(must be 0: the same bits); without the mask they move "
          f"{leak:.6g} (must be > 0)")
    check(torch.equal(p1, p2), "padded slices' voxels reach the probs")
    check(leak > 0, "the padding check would pass a dropped mask")
    out = base / "predict_mrnet"
    t1 = time.perf_counter()
    predict_cli.main(["--run_folder", str(run), "--output_dir", str(out),
                      "--save_saliency"])
    sec_pred = time.perf_counter() - t1
    with (out / "results.csv").open() as f:
        rows = list(csv.DictReader(f))
    case = rows[0]["uid"]
    sal, aff = read_nifti(out / f"case_{case}" / "saliency.nii.gz")
    sp = MRNet_Dataset3D(mrnet_root, split="test")[0]["spacing_dhw"]
    want_diag = np.asarray(sp, np.float32)[::-1]
    print(f"{tag} data: predict --save_saliency on the MRNet run folder: "
          f"{len(rows)} test cases in {sec_pred:.2f} s; case_{case}/"
          f"saliency.nii.gz {sal.shape}, affine diagonal "
          f"{np.diag(aff)[:3].tolist()} (must be the spacing "
          f"{want_diag.tolist()})")
    check(len(rows) == len(MRNet_Dataset3D(mrnet_root, split="test")),
          f"{len(rows)} result rows")
    check(np.array_equal(np.diag(aff)[:3].astype(np.float32), want_diag)
          and np.isfinite(sal).all(), f"saliency NIfTI affine {aff}")

    # -- DUKE: one eval batch at B=8 from the fixture -----------------------
    duke = DUKE_Dataset3D(fixtures.DUKE_FIXTURE)
    ddm = DataModule(ds_val=duke, batch_size=BATCH, device=dev)
    dbatch = next(iter(ddm.val_dataloader()))
    with torch.inference_mode():
        dlogits = mst_logits(model, dbatch["source"]).float()
    print(f"{tag} data: DUKE eval batch {list(dbatch['source'].shape)} "
          f"{dbatch['source'].dtype} from the fixture (uids "
          f"{dbatch['uid']}), logits finite: "
          f"{bool(torch.isfinite(dlogits).all())}")
    check(tuple(dbatch["source"].shape) == (BATCH, 1, DEPTH_SLICES, PX, PX)
          and bool(torch.isfinite(dbatch["source"]).all())
          and bool(torch.isfinite(dlogits).all()), "DUKE eval batch")

    # -- times: the loader on the host, the train loop on the card ----------
    for name, ldm in (("LIDC", runs["LIDC"][2]), ("MRNet", runs["MRNet"][2])):
        ds, chunk = ldm.ds_train, list(range(BATCH))
        parts = {"decode": [], "crop": [], "collate": [], "stage": []}
        for _ in range(3):
            t1 = time.perf_counter()
            ds.prefetch_decode(chunk)
            t2 = time.perf_counter()
            samples = [ds[i] for i in chunk]
            t3 = time.perf_counter()
            batch = _collate(samples)
            t4 = time.perf_counter()
            ldm._stage(ds, batch, True)
            t5 = time.perf_counter()
            for k, v in zip(parts, (t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                parts[k].append(v)
        ms = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
        paths = [q for i in chunk for q in ds.nifti_paths(i)]
        t1 = time.perf_counter()
        native_io.read_nifti_batch(paths, num_threads=1)
        one = (time.perf_counter() - t1) * 1e3
        print(f"{tag} time data loader {name} B={BATCH}, host: decode "
              f"(native pool, {threads} threads) {ms['decode']:.1f} ms "
              f"(one thread {one:.1f} ms) + crop {ms['crop']:.1f} ms + "
              f"collate {ms['collate']:.1f} ms + pinned staging (f16 for "
              f"LIDC) {ms['stage']:.1f} ms = {sum(ms.values()):.1f} ms per "
              f"batch ({BATCH * 1e3 / sum(ms.values()):.1f} vol/s) in turn")
    sargs = cli.parse_args(["--dataset", "Synthetic", "--batch_size",
                            str(BATCH), "--num_train_samples", "32",
                            "--seed", str(SEED)])
    loops = {
        "LIDC files": cli.build_datamodule(
            cli.parse_args(["--dataset", "LIDC", "--path_root",
                            str(lidc_root), "--batch_size", str(BATCH),
                            "--num_train_samples", "32", "--seed",
                            str(SEED)]), dev),
        "Synthetic in memory": cli.build_datamodule(
            sargs, dev, num_samples=32,
            shape_cdhw=(1, DEPTH_SLICES, PX, PX)),
    }
    for ldm in loops.values():
        ldm.num_train_samples = LOOP_SAMPLES
    model = runs["LIDC"][1]
    step = make_train_step(TrainState(model, make_optimizer(
        model.parameters(), 0.0)))  # lr 0: the same work, the same weights
    src8 = runs["LIDC"][3]["source"]
    tgt8 = torch.from_numpy(runs["LIDC"][3]["target"]).to(dev, torch.long)
    sec_step = host_seconds(lambda: step(src8, tgt8, None))
    print(f"{tag} time train step B={BATCH} alone (one batch on the card, "
          f"no loader): {sec_step * 1e3:.3f} ms = {BATCH / sec_step:.2f} "
          f"vol/s")
    for name, ldm in loops.items():  # the CLI runs above warmed the step
        n, wall, _ = loop_seconds(ldm, None, dev)
        print(f"{tag} time loader alone B={BATCH} on {name}: {n} volumes "
              f"in {wall:.3f} s = {n / wall:.2f} vol/s (decode, crop, "
              f"collate, pinned copy, transfer and augmentation)")
        n, wall, _ = loop_seconds(ldm, step, dev)
        _, pwall, busy = loop_seconds(ldm, step, dev, profile=True)
        print(f"{tag} time train loop B={BATCH} on {name}: {n} volumes in "
              f"{wall:.3f} s = {n / wall:.2f} vol/s (loader, copy, "
              f"augmentation and step overlapped); profiled epoch {pwall:.3f} "
              f"s wall, device busy {busy:.3f} s, idle "
              f"{max(0.0, 1 - busy / pwall) * 100:.1f}%")
    del runs, loops, step, model
    torch.cuda.empty_cache()


# Phase 49: the train CLI's remaining single-card options (queue A #4 and
# #5's rest): the decode cache, `--resume`, LR schedules,
# `--pretrained_path`, `--profile_dir`, a DUKE run.
OPT_SAMPLES = 16  # Synthetic volumes per split: two B=8 steps an epoch
CACHE_LOOP_SAMPLES = 32  # a timed epoch on cached files: 4 batches of 8
SCHED_STEPS, SCHED_WARMUP, SCHED_LR = 6, 2, 1e-4


def optax_lr(name, lr, total, warmup, count) -> float:
    """optax's `cosine_decay_schedule(lr, total)` and
    `warmup_cosine_decay_schedule(0, lr, warmup, total)` at `count`, from
    their definitions (alpha 0, exponent 1)."""
    if name == "warmup_cosine" and count < warmup:
        return lr * count / warmup
    steps = total if name == "cosine" else total - warmup
    c = min(count if name == "cosine" else count - warmup, steps)
    return lr * 0.5 * (1 + math.cos(math.pi * c / steps))


def seeded_hub_sd(seed, embed=E, depth=12, grid=37, patch=14):
    """A torch.hub-layout DINOv2 ViT-S/14 state dict drawn at a trained
    model's scales (kernels N(0, 1 / fan_in), LayerScale 0.1, LN near 1)."""
    rng = np.random.default_rng(seed)

    def lin(o, i):
        return rng.standard_normal((o, i)) / math.sqrt(i)

    def vec(n, s=0.02, base=0.0):
        return base + s * rng.standard_normal(n)

    sd = {"cls_token": vec((1, 1, embed)),
          "pos_embed": vec((1, grid * grid + 1, embed)),
          "mask_token": vec((1, embed)),
          "patch_embed.proj.weight": rng.standard_normal(
              (embed, 3, patch, patch)) / math.sqrt(3 * patch * patch),
          "patch_embed.proj.bias": vec(embed),
          "norm.weight": vec(embed, 0.1, 1.0), "norm.bias": vec(embed)}
    for i in range(depth):
        p = f"blocks.{i}"
        sd.update({
            f"{p}.norm1.weight": vec(embed, 0.1, 1.0),
            f"{p}.norm1.bias": vec(embed),
            f"{p}.attn.qkv.weight": lin(3 * embed, embed),
            f"{p}.attn.qkv.bias": vec(3 * embed),
            f"{p}.attn.proj.weight": lin(embed, embed),
            f"{p}.attn.proj.bias": vec(embed),
            f"{p}.ls1.gamma": vec(embed, 0.01, 0.1),
            f"{p}.ls2.gamma": vec(embed, 0.01, 0.1),
            f"{p}.norm2.weight": vec(embed, 0.1, 1.0),
            f"{p}.norm2.bias": vec(embed),
            f"{p}.mlp.fc1.weight": lin(4 * embed, embed),
            f"{p}.mlp.fc1.bias": vec(4 * embed),
            f"{p}.mlp.fc2.weight": lin(embed, 4 * embed),
            f"{p}.mlp.fc2.bias": vec(embed)})
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in sd.items()}


def seeded_hf_v3_sd(seed, embed=E, depth=12, patch=16, registers=4):
    """An HF DINOv3ViTModel ViT-S/16 state dict (4 registers, no pos-embed,
    no k bias, the plain up / down MLP) at the same scales."""
    rng = np.random.default_rng(seed)

    def lin(o, i):
        return rng.standard_normal((o, i)) / math.sqrt(i)

    def vec(n, s=0.02, base=0.0):
        return base + s * rng.standard_normal(n)

    sd = {"embeddings.cls_token": vec((1, 1, embed)),
          "embeddings.mask_token": vec((1, 1, embed)),
          "embeddings.register_tokens": vec((1, registers, embed)),
          "embeddings.patch_embeddings.weight": rng.standard_normal(
              (embed, 3, patch, patch)) / math.sqrt(3 * patch * patch),
          "embeddings.patch_embeddings.bias": vec(embed),
          "norm.weight": vec(embed, 0.1, 1.0), "norm.bias": vec(embed)}
    for i in range(depth):
        p, a = f"layer.{i}", f"layer.{i}.attention"
        sd.update({
            f"{a}.q_proj.weight": lin(embed, embed),
            f"{a}.q_proj.bias": vec(embed),
            f"{a}.k_proj.weight": lin(embed, embed),
            f"{a}.v_proj.weight": lin(embed, embed),
            f"{a}.v_proj.bias": vec(embed),
            f"{a}.o_proj.weight": lin(embed, embed),
            f"{a}.o_proj.bias": vec(embed),
            f"{p}.norm1.weight": vec(embed, 0.1, 1.0),
            f"{p}.norm1.bias": vec(embed),
            f"{p}.norm2.weight": vec(embed, 0.1, 1.0),
            f"{p}.norm2.bias": vec(embed),
            f"{p}.layer_scale1.lambda1": vec(embed, 0.01, 0.1),
            f"{p}.layer_scale2.lambda1": vec(embed, 0.01, 0.1),
            f"{p}.mlp.up_proj.weight": lin(4 * embed, embed),
            f"{p}.mlp.up_proj.bias": vec(4 * embed),
            f"{p}.mlp.down_proj.weight": lin(embed, 4 * embed),
            f"{p}.mlp.down_proj.bias": vec(embed)})
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in sd.items()}


def busy_loop(dm, step, dev):
    """One train epoch of `dm` through `step` under `torch.profiler` with
    CUDA activity only (a lighter trace than `loop_seconds`' CPU + CUDA
    one) -> (volumes, wall s, device busy s, s spent reading the trace)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    n = 0
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for batch in dm.train_dataloader():
            tgt = torch.from_numpy(batch["target"]).pin_memory().to(
                dev, torch.long, non_blocking=True)
            step(batch["source"], tgt, batch.get("src_key_padding_mask"))
            n += len(batch["uid"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    t1 = time.perf_counter()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e6
    return n, wall, busy, time.perf_counter() - t1


def cache_stats(cache: Path):
    files = [f for f in cache.iterdir() if f.suffix == ".npy"]
    return len(files), sum(f.stat().st_size for f in files)


def last_state(run: Path) -> dict:
    out = {}
    for name in ("params.npz", "optimizer.npz"):
        with np.load(run / "last" / name, allow_pickle=False) as z:
            out.update({f"{name}:{k}": z[k] for k in z.files})
    return out


def print_last_saves(tag, what, records) -> None:
    """The `last` writes of a fit (`Trainer.state_writer.records`)."""
    for r in records:
        print(f"{tag} {what}: `last` train state {r['bytes'] / 1e9:.3f} GB: "
              f"device-to-host copy {r['copy_s']:.3f} s on the loop's "
              f"thread, write {r['write_s']:.3f} s on the writer thread")


def train_options_phase(tag, dev, fb, per_step, per_fwd3) -> None:
    """Phase 49: the train CLI's remaining single-card options on the card
    (see the module docstring); `per_step` is phase 8's launch counts of
    one B=8 step, `per_fwd3` phase 16's of one DINOv3 forward."""
    stamp(tag, "49")
    t_phase = time.perf_counter()
    from mst_tpu_torch import predict as predict_cli
    from mst_tpu_torch.data import fixtures
    from mst_tpu_torch.data.datasets.base import Dataset3D
    from mst_tpu_torch.models import convert
    from mst_tpu_torch.registry import get_dataset
    from mst_tpu_torch.serve import build_model as serve_model
    from mst_tpu_torch.serve import parse_args as serve_args
    from mst_tpu_torch.train import cli
    from mst_tpu_torch.train.predictor import make_predict_fn
    from mst_tpu_torch.train.trainer import (
        TrainState,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from mst_tpu_torch.utils import checkpoint as ckpt

    torch.cuda.empty_cache()
    base = ROOT / "build" / "chip_smoke_opts"  # gitignored
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    data = ROOT / "build" / "chip_smoke_data"  # phase 48's folders
    roots = {"LIDC": data / "lidc", "MRNet": data / "mrnet",
             "DUKE": fixtures.DUKE_FIXTURE}
    synth = dict(num_samples=OPT_SAMPLES,
                 shape_cdhw=(1, DEPTH_SLICES, PX, PX))

    def ds_args(name, cache, samples):
        args = cli.parse_args(
            ["--dataset", name, "--path_root", str(roots[name]),
             "--batch_size", str(BATCH), "--num_train_samples", str(samples),
             "--max_epochs", "1", "--seed", str(SEED)]
            + (["--decode_cache", str(cache)] if cache else []))
        if not cache:
            args.decode_cache = False  # and not $MST_DECODE_CACHE
        return args

    def dm_of(name, cache, samples):
        """The CLI's DataModule drawing `samples` a train epoch (the CLI
        caps the draws at the split's size: 8 LIDC / MRNet and 3 DUKE
        cases here; the reference's splits hold hundreds)."""
        dm = cli.build_datamodule(ds_args(name, cache, samples), dev)
        dm.num_train_samples = samples
        return dm

    # -- the decoded-volume disk cache -------------------------------------
    smodel = cli.build_model(cli.parse_args(["--dataset", "Synthetic"]))
    convert.params_from_flax(smodel, convert.random_flax_params(smodel, SEED))
    step = make_train_step(TrainState(smodel, make_optimizer(
        smodel.parameters(), 0.0)))  # lr 0: the same work every epoch
    for name in roots:
        t1 = time.perf_counter()
        # the host's work for one batch of distinct cases: decode (or cache
        # read) and crop
        ds_plain = dm_of(name, None, BATCH).ds_train
        chunk = list(range(min(BATCH, len(ds_plain))))

        def host_ms(ds):
            t2 = time.perf_counter()
            ds.prefetch_decode(chunk)
            _ = [ds[i] for i in chunk]
            return (time.perf_counter() - t2) * 1e3

        cold, flush, warm = [], [], []
        for rep in range(3):
            cache = base / f"cache_{name}_host{rep}"
            cold.append(host_ms(dm_of(name, cache, BATCH).ds_train))
            t2 = time.perf_counter()
            Dataset3D.flush_cache_writes()
            flush.append((time.perf_counter() - t2) * 1e3)
            warm.append(host_ms(dm_of(name, cache, BATCH).ds_train))
        plain_ms = statistics.median(host_ms(ds_plain) for _ in range(3))
        cold_ms, flush_ms, warm_ms = (statistics.median(v)
                                      for v in (cold, flush, warm))
        n_files, n_bytes = cache_stats(cache)
        print(f"{tag} decode cache {name}: host ms for one batch of "
              f"{len(chunk)} distinct cases (prefetch_decode + crop; median "
              f"of 3): uncached {plain_ms:.1f} ms; first read with the "
              f"cache {cold_ms:.1f} ms (decode, the writes queued) + "
              f"{flush_ms:.1f} ms until the write-behind thread is done; "
              f"from the cache {warm_ms:.1f} ms; cache {n_files} files, "
              f"{n_bytes / 1e6:.2f} MB")
        check(n_files > 0, f"{name}: nothing cached")
        # the loader alone and the train loop, a cold epoch then a warm one
        rows = {}
        t2 = time.perf_counter()
        for what in ("loader", "loop"):
            dm = dm_of(name, base / f"cache_{name}_{what}",
                       CACHE_LOOP_SAMPLES)
            for epoch in ("cold", "warm"):
                if what == "loader":
                    n, wall, _ = loop_seconds(dm, None, dev)
                    busy = read_s = None
                else:
                    n, wall, busy, read_s = busy_loop(dm, step, dev)
                Dataset3D.flush_cache_writes()
                rows[(what, epoch)] = (n, wall, busy, read_s, *cache_stats(
                    dm.ds_train._cache_dir))
        for epoch in ("cold", "warm"):
            n, wall, _, _, files, size = rows[("loader", epoch)]
            ln, lwall, busy, read_s, _, _ = rows[("loop", epoch)]
            print(f"{tag} time decode cache {name} B={BATCH}, {epoch} epoch "
                  f"({n} volumes): loader alone {n / wall:.2f} vol/s; train "
                  f"loop (CUDA-profiled) {ln / lwall:.2f} vol/s, device busy "
                  f"{busy:.3f} of {lwall:.3f} s, idle "
                  f"{max(0.0, 1 - busy / lwall) * 100:.1f}% (the trace read "
                  f"in {read_s:.2f} s); cache after the epoch {files} files, "
                  f"{size / 1e6:.2f} MB")
        print(f"{tag} decode cache {name}: the four timed epochs took "
              f"{time.perf_counter() - t2:.1f} s")
        # the warm epoch's batches against an uncached run's, bit for bit
        dms = {c: dm_of(name, c, OPT_SAMPLES)
               for c in (None, base / f"cache_{name}_same")}
        got = {}
        hits = 0
        for c, dm in dms.items():
            got[c] = []
            for epoch in (0, 1):
                if c is not None and epoch == 1:
                    Dataset3D.flush_cache_writes()
                    dm.set_epoch(1)
                    idx = dm._train_indices()
                    ds = dm.ds_train
                    hits = sum(all(ds._cached(p) for p in ds.nifti_paths(i))
                               and all(ds._cached(p, d)
                                       for p, d in ds.h5_items(i))
                               for i in idx)
                dm.set_epoch(epoch)
                for b in dm.train_dataloader():
                    got[c].append((epoch, b["uid"], b["target"].tolist(),
                                   b["source"].cpu(),
                                   b.get("src_key_padding_mask")))
        same = len(got[None]) == len(got[base / f"cache_{name}_same"]) and all(
            a[:3] == b[:3] and torch.equal(a[3], b[3])
            and (a[4] is None) == (b[4] is None)
            and (a[4] is None or torch.equal(a[4].cpu(), b[4].cpu()))
            for a, b in zip(got[None], got[base / f"cache_{name}_same"]))
        print(f"{tag} decode cache {name}: {len(got[None])} train batches "
              f"(epochs 0 and 1, {OPT_SAMPLES} samples each) with the cache "
              f"vs without, the augmented batches on the card bit for bit: "
              f"{same}; epoch 1 read {hits} of {OPT_SAMPLES} samples from "
              f"the cache ({time.perf_counter() - t1:.1f} s)")
        check(same and len(got[None]) == 4,
              f"{name}: cached batches differ from uncached ones")
        check(hits > 0, f"{name}: the warm epoch read no cached sample")
        del dms, got
    del step

    # -- DUKE: one epoch with the cache, then predict ----------------------
    t1 = time.perf_counter()
    dcache = base / "cache_DUKE_run"
    dargs = ds_args("DUKE", dcache, OPT_SAMPLES)
    ddm = dm_of("DUKE", dcache, OPT_SAMPLES)
    dmodel = cli.build_model(dargs)
    drun = base / "runs" / "DUKE"
    fb.reset_launch_counts()
    _, dres = cli.train(dargs, dmodel, ddm, cli.build_trainer(
        dargs, ddm, run_dir=drun))
    torch.cuda.synchronize()
    dcounts = fb.launch_counts()
    out = base / "predict_duke"
    predict_cli.main(["--run_folder", str(drun), "--decode_cache",
                      str(dcache), "--output_dir", str(out)])
    with (out / "results.csv").open() as f:
        drows = list(csv.DictReader(f))
    n_test = len(get_dataset("DUKE", "test", path_root=roots["DUKE"]))
    print(f"{tag} DUKE: train --decode_cache one epoch B={BATCH} on the "
          f"fixture ({len(ddm.ds_train)} train / {len(ddm.ds_val)} val "
          f"cases, {OPT_SAMPLES} draws): train loss "
          f"{dres.history[0]['train_loss']:.6g}, cache "
          f"{cache_stats(dcache)[0]} files; predict --run_folder "
          f"--decode_cache: {len(drows)} rows (test split {n_test}), "
          f"{time.perf_counter() - t1:.1f} s")
    check(math.isfinite(dres.history[0]["train_loss"]), "DUKE train loss")
    check(len(drows) == n_test and all(0.0 <= float(r["NN_pred"]) <= 1.0
                                       for r in drows), f"DUKE rows {drows}")
    check(all(dcounts[k] > 0 for k, v in per_step.items() if v),
          f"DUKE train: launches {dcounts}")
    del dmodel, ddm

    # -- --resume: two epochs against one epoch and --resume ----------------
    t1 = time.perf_counter()
    prof = base / "profile"
    common = ["--dataset", "Synthetic", "--batch_size", str(BATCH),
              "--num_train_samples", str(OPT_SAMPLES), "--seed", str(SEED),
              "--lr", "1e-4", "--lr_schedule", "warmup_cosine"]
    fb.reset_launch_counts()
    run_a, _ = cli.main(common + ["--max_epochs", "2", "--run_dir",
                                  str(base / "a"), "--profile_dir",
                                  str(prof)], **synth)
    torch.cuda.synchronize()
    rcounts = fb.launch_counts()
    run_b, _ = cli.main(common + ["--max_epochs", "1", "--run_dir",
                                  str(base / "b")], **synth)
    run_c, res_c = cli.main(common + ["--max_epochs", "2", "--run_dir",
                                      str(base / "c"), "--resume",
                                      str(run_b)], **synth)
    la, lc = last_state(run_a), last_state(run_c)
    differ = sorted(k for k in la if not np.array_equal(la[k], lc.get(k)))
    print(f"{tag} resume: 2 epochs in {run_a.name} vs 1 epoch + --resume "
          f"in {run_c.name} (run folder {run_b.name} -> {run_c.name}): "
          f"{len(la)} arrays of params, exp_avg, exp_avg_sq, step and the "
          f"update count {int(lc['optimizer.npz:state_step'])}; differing: "
          f"{differ[:6]}{'...' if len(differ) > 6 else ''} (must be none)")
    check(run_c == run_b and not (base / "c").exists()
          and res_c.epochs_run == 1, f"resume folder {run_c} != {run_b}")
    check(la.keys() == lc.keys(), "resume: different arrays")
    if differ:
        run_a2, _ = cli.main(common + ["--max_epochs", "2", "--run_dir",
                                       str(base / "a2")], **synth)
        la2 = last_state(run_a2)
        spread = {k: float(np.abs(la[k].astype(np.float64)
                                  - la2[k]).max()) for k in la}
        gap = {k: float(np.abs(la[k].astype(np.float64) - lc[k]).max())
               for k in la}
        moved = sorted((v, k) for k, v in spread.items() if v)[-6:]
        print(f"{tag} resume: two uninterrupted runs differ in "
              f"{sum(v > 0 for v in spread.values())} arrays (the largest: "
              f"{moved}); resumed vs uninterrupted at most that spread: "
              f"{all(gap[k] <= spread[k] for k in la)}")
        check(all(gap[k] <= spread[k] for k in la),
              "resume: the resumed run leaves the two runs' spread")
    check(all(rcounts[k] > 0 for k, v in per_step.items() if v),
          f"resume run: launches {rcounts}")
    traces = sorted(prof.glob("trace_*.json"))
    kernels = set()
    if traces:
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    print(f"{tag} --profile_dir: {[q.name for q in traces]} "
          f"({sum(q.stat().st_size for q in traces) / 1e6:.2f} MB), "
          f"{len(kernels)} distinct CUDA kernels, among them "
          f"{sorted(k for k in kernels if 'mst' in k or 'gemm' in k)[:4]}")
    check(len(traces) == 1 and any("gemm" in k for k in kernels),
          "profiler trace of epoch 1")
    print(f"{tag} resume and profiler: {time.perf_counter() - t1:.1f} s")

    # -- LR schedules: the rate of every step, read back -------------------
    t1 = time.perf_counter()
    batch = next(iter(cli.build_datamodule(cli.parse_args(
        ["--dataset", "Synthetic", "--batch_size", str(BATCH)]), dev,
        **synth).train_dataloader()))
    src = batch["source"]
    tgt = torch.from_numpy(batch["target"]).to(dev, torch.long)
    for name in ("cosine", "warmup_cosine"):
        state = TrainState(smodel, make_optimizer(
            smodel.parameters(), SCHED_LR, schedule=name,
            total_steps=SCHED_STEPS, warmup_steps=SCHED_WARMUP))
        sstep = make_train_step(state)
        lrs, frozen = [], None
        for i in range(SCHED_STEPS + 1):
            before = smodel.head.kernel.detach().clone()
            sstep(src, tgt)
            lrs.append(state.optimizer.param_groups[0]["lr"])
            if i == 0:
                frozen = torch.equal(before, smodel.head.kernel.detach())
        want = [optax_lr(name, SCHED_LR, SCHED_STEPS, SCHED_WARMUP, i)
                for i in range(SCHED_STEPS + 1)]
        err = max(abs(a - b) / SCHED_LR for a, b in zip(lrs, want))
        print(f"{tag} --lr_schedule {name} (lr {SCHED_LR}, {SCHED_STEPS} "
              f"steps, warmup {SCHED_WARMUP}): the rate of each of "
              f"{len(lrs)} steps {[f'{v:.6g}' for v in lrs]} vs optax's "
              f"formula: max |diff| / lr {err:.3g} (limit 1e-12); the first "
              f"step left the head as it was: {frozen} (lr 0: "
              f"{name == 'warmup_cosine'})")
        check(err <= 1e-12, f"{name} rates {lrs} != {want}")
        check(frozen == (name == "warmup_cosine"), f"{name}: step 0 lr 0")
    print(f"{tag} schedules: {time.perf_counter() - t1:.1f} s")
    del smodel, state, sstep

    # -- --pretrained_path: hub DINOv2 and HF DINOv3 encoders ---------------
    for label, model_name, sd, fwd in (
            ("hub DINOv2 ViT-S/14", "DinoV2ClassifierSlice",
             seeded_hub_sd(SEED), {"ln_gemm", "mhsa", "gemm_residual"}),
            ("HF DINOv3 ViT-S/16", MODEL3, seeded_hf_v3_sd(SEED),
             {k for k, v in per_fwd3.items() if v})):
        t1 = time.perf_counter()
        pth = base / f"{model_name}.pth"
        torch.save(sd, pth)
        pargs = cli.parse_args(["--dataset", "Synthetic", "--model",
                                model_name, "--batch_size", str(BATCH),
                                "--num_train_samples", str(OPT_SAMPLES),
                                "--max_epochs", "1", "--seed", str(SEED),
                                "--lr", "1e-4", "--freeze",
                                "--pretrained_path", str(pth)])
        pre = cli.pretrained_state_dict(pargs)
        pmodel = cli.build_model(pargs, pre)
        pdm = cli.build_datamodule(pargs, dev, **synth)
        prun = base / "runs" / model_name
        fb.reset_launch_counts()
        _, pres = cli.train(pargs, pmodel, pdm, cli.build_trainer(
            pargs, pdm, run_dir=prun), pre)
        torch.cuda.synchronize()
        pcounts = fb.launch_counts()
        conv = convert.convert_any_dinov2(
            {k: v.numpy() for k, v in sd.items()}, 12,
            num_heads=pmodel.encoder.num_heads)
        best = ckpt.load_best_params(prun)
        live = convert.flax_params_from_torch(pmodel)
        enc_diff = [k for k, v in conv.items()
                    if not (np.array_equal(best[f"encoder/{k}"], v)
                            and np.array_equal(live[f"encoder/{k}"], v))]
        hp = ckpt.load_hparams(prun)
        served = serve_model(serve_args(["--run_folder", str(prun)]))
        vbatch = next(iter(pdm.val_dataloader()))
        p_served, _ = make_predict_fn(served, with_saliency=False)(
            vbatch["source"], None)
        p_eval = torch.softmax(make_eval_step(pmodel)(
            vbatch["source"]).float(), -1)
        d_ck = (p_served - p_eval).abs().max().item()
        print(f"{tag} --pretrained_path {label} --freeze: one epoch, train "
              f"loss {pres.history[0]['train_loss']:.6g}; encoder arrays "
              f"not equal to the converted state dict (best checkpoint and "
              f"live model): {enc_diff[:4]} of {len(conv)} (must be none); "
              f"hparams patch {hp['patch_size']}, grid {hp['pos_embed_grid']}"
              f", registers {hp['num_register_tokens']}, pos-embed "
              f"{hp['use_pos_embed']}, RoPE {hp['use_rope_2d']}; `serve "
              f"--run_folder` probs vs the eval step's: max |diff| "
              f"{d_ck:.6g} (must be 0); launches {pcounts} "
              f"({time.perf_counter() - t1:.1f} s)")
        check(not enc_diff and math.isfinite(pres.history[0]["train_loss"]),
              f"{label}: encoder {enc_diff[:4]}")
        check(d_ck == 0.0, f"{label}: served probs differ by {d_ck}")
        check(all(pcounts[k] > 0 for k in fwd)
              and pcounts["gemm_wgrad"] == 0 and pcounts["mhsa_bwd"] == 0,
              f"{label}: launches {pcounts}")
        if model_name == MODEL3:
            check(hp["patch_size"] == 16 and hp["num_register_tokens"] == 4
                  and hp["use_pos_embed"] is False and hp["use_rope_2d"],
                  f"{label} hparams {hp}")
        else:
            check(hp["pos_embed_grid"] == 37 and hp["patch_size"] == 14,
                  f"{label} hparams {hp}")
        del pmodel, served, pre, sd
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"{tag} phase 49: {time.perf_counter() - t_phase:.1f} s")


# Phase 50: the CLIs' remaining single-card options (queue A #6, #12 and
# #11's rest): Adafactor, gradient accumulation, frozen int8 training, and
# the predict CLI's segmentation scores, PNGs and ensembles.
ACC_STEPS = 2  # micro-batches a window in the kernel-vs-plain check
ACC_RESUME = 3  # two micro-batches an epoch: epoch 0 ends mid-window
ADAFACTOR_LR = 1e-4


def state_bytes(opt) -> int:
    """Bytes of an optimizer's per-parameter state tensors."""
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if torch.is_tensor(v))


def csv_rows(path: Path) -> list:
    with path.open() as f:
        return list(csv.DictReader(f))


def cli_options_phase(tag, dev, fb, per_step, plain_train_sublayers,
                      giant2) -> None:
    """Phase 50 (see the module docstring); `per_step` is phase 8's launch
    counts of one B=8 step, `plain_train_sublayers` phase 8's routing of
    the train sub-layers to their plain versions, `giant2` phase 28's
    (unfrozen giant2 `--remat` model, B=8 source, targets)."""
    stamp(tag, "50")
    t_phase = time.perf_counter()
    from mst_tpu_torch import predict as predict_cli
    from mst_tpu_torch.models import convert
    from mst_tpu_torch.registry import model_entry
    from mst_tpu_torch.train import cli
    from mst_tpu_torch.train.trainer import (
        TrainState,
        factored_dims,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from mst_tpu_torch.utils.checkpoint import load_best_params
    from mst_tpu_torch.utils.functions import read_png
    from mst_tpu_torch.utils.nifti import read_nifti

    torch.cuda.empty_cache()
    base = ROOT / "build" / "chip_smoke_cli_options"  # gitignored
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    synth = dict(num_samples=OPT_SAMPLES,
                 shape_cdhw=(1, DEPTH_SLICES, PX, PX))
    entry = model_entry("DinoV2ClassifierSlice")

    # -- Adafactor with accumulation, through the train CLI's builders -----
    t1 = time.perf_counter()
    common = ["--dataset", "Synthetic", "--batch_size", str(BATCH),
              "--num_train_samples", str(OPT_SAMPLES), "--seed", str(SEED),
              "--lr", str(ADAFACTOR_LR), "--optimizer", "adafactor"]
    args = cli.parse_args(common + ["--accumulate_grad_batches",
                                    str(ACC_STEPS), "--max_epochs", "1"])
    model = cli.build_model(args)
    dm = cli.build_datamodule(args, dev, **synth)
    cli.build_trainer(args, dm, run_dir=base / "window").init_state(
        model, seed=SEED)
    rng = np.random.default_rng(SEED)
    with torch.no_grad():  # O(1) LayerScale: every block counts
        for name, prm in model.named_parameters():
            if name.endswith(".gamma"):
                prm.copy_(torch.from_numpy(1.0 + 0.1 * rng.standard_normal(
                    tuple(prm.shape))).to(prm))
    start = {n: q.detach().clone() for n, q in model.named_parameters()}
    batches = [(b["source"], torch.from_numpy(b["target"]).to(dev,
                                                              torch.long))
               for b in dm.train_dataloader()][:ACC_STEPS]

    def window(plain: bool):
        """One window of ACC_STEPS micro-batches from `start` -> (losses,
        the mean grads the update read, the params after, whether every
        micro-batch but the last left the params bit for bit, launches,
        the optimizer)."""
        with torch.no_grad():
            for n, q in model.named_parameters():
                q.copy_(start[n])
        opt = make_optimizer(model.parameters(), ADAFACTOR_LR,
                             entry.weight_decay, optimizer=args.optimizer,
                             accumulate_steps=args.accumulate_grad_batches)
        step = make_train_step(TrainState(model, opt))
        losses, kept = [], []
        fb.reset_launch_counts()
        with plain_train_sublayers() if plain else contextlib.nullcontext():
            for i, (bs, bt) in enumerate(batches):
                before = [q.detach().clone() for q in model.parameters()]
                losses.append(float(step(bs, bt)[0]))
                if i < ACC_STEPS - 1:
                    kept.append(all(torch.equal(a, q.detach()) for a, q in
                                    zip(before, model.parameters())))
        torch.cuda.synchronize()
        counts = fb.launch_counts()
        grads = {n: q.grad.detach().clone()
                 for n, q in model.named_parameters() if q.grad is not None}
        after = {n: q.detach().clone() for n, q in model.named_parameters()}
        return losses, grads, after, all(kept), counts, opt

    loss_k, grads_k, after_k, kept_k, counts_k, opt_k = window(False)
    loss_p, grads_p, after_p, kept_p, _, _ = window(True)
    rel = {n: ((g - grads_p[n]).abs().max() / grads_p[n].abs().max().clamp_min(
        1e-30)).item() for n, g in grads_k.items()}
    worst = max(rel, key=rel.get)
    moved = {n: (after_k[n] - start[n]).abs().max().item() for n in start}
    upd = {n: ((after_k[n] - after_p[n]).abs().max() / (
        after_p[n] - start[n]).abs().max().clamp_min(1e-30)).item()
        for n in start if factored_dims(tuple(start[n].shape))}
    held = opt_k.held()
    fact = [factored_dims(tuple(q.shape)) is not None for q in held]
    layout = all(set(opt_k.state[q]) == ({"v_row", "v_col"} if f else {"v"})
                 for q, f in zip(held, fact))
    ada_b = state_bytes(opt_k.inner)
    adamw_b = 2 * sum(q.numel() * 4 for q in held)  # exp_avg, exp_avg_sq
    print(f"{tag} --optimizer adafactor --accumulate_grad_batches "
          f"{ACC_STEPS}, B={BATCH} {list(batches[0][0].shape)}: losses "
          f"kernel path {loss_k}, plain path {loss_p} (limit "
          f"{STEP_LOSS_TOL}); params after each first micro-batch bit for "
          f"bit: kernel {kept_k}, plain {kept_p}; the window's mean grads "
          f"kernel vs plain: worst {rel[worst]:.4g} ({worst}), median "
          f"{statistics.median(rel.values()):.4g} (limit {STEP_GRAD_REL}); "
          f"the update moved a parameter by up to "
          f"{max(moved.values()):.4g}; factored leaves' update, kernel vs "
          f"plain / the plain update: worst {max(upd.values()):.4g}, median "
          f"{statistics.median(upd.values()):.4g}; launches {counts_k}")
    print(f"{tag} Adafactor state: {sum(fact)} of {len(held)} leaves "
          f"factored (v_row + v_col), the rest full (v), {ada_b / 2**20:.2f} "
          f"MiB against AdamW's two moments {adamw_b / 2**20:.2f} MiB "
          f"({ada_b / adamw_b * 100:.2f}%); update count "
          f"{opt_k.count}, mini-step {opt_k.mini_step}")
    check(kept_k and kept_p, "a first micro-batch moved the parameters")
    check(max(moved.values()) > 0, "the window's update moved nothing")
    check(all(abs(a - b) <= STEP_LOSS_TOL for a, b in zip(loss_k, loss_p)),
          f"accumulation losses {loss_k} vs {loss_p}")
    check(rel[worst] <= STEP_GRAD_REL, f"accumulated grads {worst}: "
          f"{rel[worst]}")
    check_launches(counts_k, {k: v * ACC_STEPS for k, v in per_step.items()},
                   "adafactor window")
    check(layout and sum(fact) > 0 and ada_b * 10 < adamw_b,
          f"Adafactor state not factored: {ada_b} vs {adamw_b}")
    check(opt_k.count == 1 and opt_k.mini_step == 0, "one update a window")
    del batches, grads_k, grads_p, after_k, after_p, start, opt_k
    print(f"{tag} adafactor window: {time.perf_counter() - t1:.1f} s")

    # --resume in the middle of a window, against an uninterrupted run
    t1 = time.perf_counter()
    acc = ["--accumulate_grad_batches", str(ACC_RESUME)]
    run_a, _ = cli.main(common + acc + ["--max_epochs", "2", "--run_dir",
                                        str(base / "a")], **synth)
    run_b, _ = cli.main(common + acc + ["--max_epochs", "1", "--run_dir",
                                        str(base / "b")], **synth)
    mid = last_state(run_b)
    run_c, res_c = cli.main(common + acc + ["--max_epochs", "2", "--run_dir",
                                            str(base / "c"), "--resume",
                                            str(run_b)], **synth)
    la, lc = last_state(run_a), last_state(run_c)
    differ = sorted(k for k in la if not np.array_equal(la[k], lc.get(k)))
    print(f"{tag} --resume mid-window (--accumulate_grad_batches "
          f"{ACC_RESUME}, 2 micro-batches an epoch): epoch 0 ended at "
          f"mini-step {int(mid['optimizer.npz:mini_step'])}, update count "
          f"{int(mid['optimizer.npz:count'])}; 2 epochs vs 1 + --resume: "
          f"{len(la)} arrays (params, v_row / v_col / v, acc_grads, counts); "
          f"differing {differ[:6]} (must be none) "
          f"({time.perf_counter() - t1:.1f} s)")
    check(int(mid["optimizer.npz:mini_step"]) == 2 and run_c == run_b
          and res_c.epochs_run == 1, "resume mid-window")
    check(la.keys() == lc.keys() and not differ, f"resume differs {differ}")
    del model, dm

    # -- two Adafactor steps of unfrozen giant2 --remat, beside AdamW ------
    t1 = time.perf_counter()
    gmodel, gsrc, gtgt = giant2
    n_par = sum(q.numel() for q in gmodel.parameters())
    mem = {}
    for name in ("adamw", "adafactor"):
        gmodel.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_g = torch.cuda.memory_allocated()
        opt = make_optimizer(gmodel.parameters(), entry.learning_rate,
                             entry.weight_decay, optimizer=name)
        step = make_train_step(TrainState(gmodel, opt))
        fb.reset_launch_counts()
        losses, ms = [], []
        for _ in range(2):  # the first step also allocates the state
            t2 = time.perf_counter()
            losses.append(float(step(gsrc, gtgt)[0]))
            ms.append((time.perf_counter() - t2) * 1e3)
        counts = fb.launch_counts()
        mem[name] = torch.cuda.max_memory_allocated()
        sb = state_bytes(opt)
        print(f"{tag} unfrozen giant2 --remat B={BATCH} {list(gsrc.shape)}, "
              f"two {name} steps: losses {losses}, wall ms {ms[0]:.1f} (the "
              f"state allocated) and {ms[1]:.1f}; peak device memory "
              f"{mem[name] / 2**30:.2f} GiB "
              f"({held_g / 2**30:.2f} GiB held before); optimizer state "
              f"{sb / 2**30:.3f} GiB for {n_par / 1e9:.3f} G parameters; "
              f"gemm_wgrad launches {counts['gemm_wgrad']}")
        check(all(map(math.isfinite, losses)) and counts["gemm_wgrad"] > 0,
              f"giant2 {name} steps {losses}")
        if name == "adafactor":
            check(sb * 10 < n_par * 4, f"giant2 Adafactor state {sb}")
        del opt, step
    gmodel.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    print(f"{tag} giant2 peak memory, Adafactor / AdamW: "
          f"{mem['adafactor'] / 2**30:.2f} / {mem['adamw'] / 2**30:.2f} GiB "
          f"({time.perf_counter() - t1:.1f} s)")
    check(mem["adafactor"] < mem["adamw"], "Adafactor's peak is not below")

    # -- train --freeze --int8 --int8_calib 8 on the LIDC fixture ----------
    t1 = time.perf_counter()
    lidc = ROOT / "build" / "chip_smoke_data" / "lidc"  # phase 48's
    iargs = cli.parse_args(["--dataset", "LIDC", "--path_root", str(lidc),
                            "--batch_size", str(BATCH), "--max_epochs", "1",
                            "--seed", str(SEED), "--lr", "1e-4", "--freeze",
                            "--int8", "--int8_calib", str(BATCH)])
    idm = cli.build_datamodule(iargs, dev)
    idm.num_train_samples = 2 * BATCH  # the fixture's train split is small
    imodel = cli.build_model(iargs)
    irun = base / "runs" / "int8"
    itrainer = cli.build_trainer(iargs, idm, run_dir=irun)
    seeded = convert.random_flax_params(imodel, SEED)
    fb.reset_launch_counts()
    _, ires = cli.train(iargs, imodel, idm, itrainer)
    torch.cuda.synchronize()
    icounts = fb.launch_counts()
    t_fit = time.perf_counter() - t1
    live = convert.flax_params_from_torch(imodel)
    best = load_best_params(irun)
    enc_diff = [k for k, v in seeded.items() if k.startswith("encoder/")
                and not (np.array_equal(live[k], v)
                         and np.array_equal(best[k], v))]
    idm.set_epoch(0)  # the calibration's draws again: the same tree
    enc8 = itrainer.int8_encoder(imodel, idm)
    vb = next(iter(idm.val_dataloader()))
    vt = torch.from_numpy(vb["target"]).to(dev, torch.long)
    istep = make_train_step(TrainState(imodel, make_optimizer(
        imodel.parameters(), 0.0, 0.0)), enc8)
    _, logits_step = istep(vb["source"], vt)
    logits_serve = make_eval_step(imodel, enc8)(vb["source"])
    same = torch.equal(logits_step.float(), logits_serve.float())
    n8 = ("ln_gemm_i8", "quant_rows", "gemm_i8_residual")
    bwd = ("gemm_dls", "gemm_wgrad", "gemm_dgrad", "mhsa_bwd", "ln_pullback")
    print(f"{tag} train --freeze --int8 --int8_calib {BATCH} on the LIDC "
          f"fixture, one epoch of {idm.num_train_samples // BATCH} B={BATCH} "
          f"steps: {t_fit:.1f} s, train loss "
          f"{ires.history[0]['train_loss']:.6g}, val/AUC "
          f"{ires.history[0]['val/AUC_ROC']:.4g}; launches {icounts}; "
          f"encoder arrays not equal to the seeded draw (live model and best "
          f"checkpoint): {enc_diff[:4]} of "
          f"{sum(k.startswith('encoder/') for k in seeded)} (must be none); "
          f"the step's logits vs the int8 serving forward of the same tree: "
          f"bit for bit {same}")
    check(all(icounts[k] > 0 for k in n8) and all(icounts[k] == 0 for k in
                                                  bwd + ("ln_gemm",)),
          f"frozen int8 launches {icounts}")
    check(not enc_diff and same
          and math.isfinite(ires.history[0]["train_loss"]),
          f"frozen int8: encoder {enc_diff[:4]}, logits equal {same}")
    # the step's rate: int8 against bf16 frozen on one batch, then the loop
    sec_i8 = host_seconds(lambda: istep(vb["source"], vt))
    bstep = make_train_step(TrainState(imodel, make_optimizer(
        imodel.parameters(), 0.0, 0.0)))
    sec_bf = host_seconds(lambda: bstep(vb["source"], vt))
    n, wall, busy, _ = busy_loop(idm, istep, dev)
    print(f"{tag} time frozen step B={BATCH}: int8 encoder "
          f"{sec_i8 * 1e3:.3f} ms = {BATCH / sec_i8:.2f} vol/s, bf16 encoder "
          f"{sec_bf * 1e3:.3f} ms = {BATCH / sec_bf:.2f} vol/s; the int8 "
          f"train loop on the LIDC files ({n} volumes): {n / wall:.2f} vol/s, "
          f"device busy {busy:.3f} of {wall:.3f} s, idle "
          f"{max(0.0, 1 - busy / wall) * 100:.1f}%")
    del istep, bstep, enc8, imodel, idm

    # -- predict on that run folder: segmentation, PNGs, ensembles ---------
    n_test = None
    single = None
    for label, flags in (("last --int8", ["--int8"]),
                         ("rollout", ["--use_rollout"])):
        t1 = time.perf_counter()
        out = base / f"predict_{label.split()[0]}"
        times = {}
        fb.reset_launch_counts()
        predict_cli.main(["--run_folder", str(irun), "--output_dir", str(out),
                          "--get_segmentation", "--save_saliency",
                          "--get_attention", *flags], times=times)
        torch.cuda.synchronize()
        pcounts = fb.launch_counts()
        rows = csv_rows(out / "results.csv")
        seg = csv_rows(out / "results_seg.csv")
        n_test = len(rows)
        if single is None:
            single = rows
        pngs, empty, positives = 0, 0, 0
        for r, s in zip(rows, seg):
            case = out / f"case_{r['uid']}"
            mask, _ = read_nifti(case / "seg.nii.gz")
            check(mask.dtype == np.uint8 and mask.shape == (PX, PX,
                                                            DEPTH_SLICES),
                  f"seg.nii.gz {mask.dtype} {mask.shape}")
            empty += not mask.any()
            check(math.isfinite(float(s["Dice"])) and math.isfinite(float(
                s["IoU"])) and (math.isfinite(float(s["ASSD"] or "nan"))
                                == bool(mask.any())),
                  f"{label}: metrics {s} with {int(mask.sum())} voxels")
            names = (["input.png", "attention.png", "ground_truth.png"]
                     if r["GT"] == "1" else [])
            positives += bool(names)
            for name in names:
                img = read_png(case / name)
                check(img.shape == (4 * PX, 8 * PX, 4) and img.any(),
                      f"{name} {img.shape}")
                pngs += 1
            check(sorted(q.name for q in case.glob("*.png")) == sorted(names),
                  f"{case.name}: PNGs {list(case.glob('*.png'))}")
        # "last" takes its row from the CLS-only last block (plain ops)
        form = "mhsa" if label.startswith("last") else "mhsa_rollout"
        per = {k: v / (positives if k == "png" else n_test) * 1e3
               for k, v in times.items()}
        log_ = [ln for ln in (out / "predict.log").read_text().splitlines()
                if ln.startswith(("Dice", "IoU", "ASSD"))]
        print(f"{tag} predict {label} --get_segmentation --save_saliency "
              f"--get_attention on the int8 run folder: {n_test} cases, "
              f"{pngs} PNGs read back, {empty} empty masks; ms a case: "
              f"saliency forward {per.get('forward', 0):.1f}, Dice / IoU / "
              f"ASSD {per.get('segmentation', 0):.1f}, NIfTI writes "
              f"{per.get('nifti', 0):.1f}, PNG writes {per.get('png', 0):.1f} "
              f"a positive case ({positives}); log {log_}; launches {pcounts} "
              f"({time.perf_counter() - t1:.1f} s)")
        check(len(seg) == n_test > 0 and pcounts[form] > 0 and len(log_) == 3
              and (pcounts["ln_gemm_i8"] > 0) == ("--int8" in flags),
              f"predict {label}: {len(seg)} rows, launches {pcounts}")
    t1 = time.perf_counter()
    out = base / "predict_ensemble"
    fb.reset_launch_counts()
    predict_cli.main(["--run_folder", str(irun), "--output_dir", str(out),
                      "--int8", "--get_segmentation", "--ensemble",
                      str(irun), str(irun)])
    torch.cuda.synchronize()
    ecounts = fb.launch_counts()
    rows = csv_rows(out / "results.csv")
    gap = max(abs(float(a["NN_pred"]) - float(b["NN_pred"]))
              for a, b in zip(rows, single))
    print(f"{tag} predict --int8 --get_segmentation --ensemble RUN RUN: "
          f"{len(rows)} rows, |NN_pred - the single run's| max {gap:.3g} "
          f"(limit 1e-4); launches {ecounts} "
          f"({time.perf_counter() - t1:.1f} s)")
    check(len(rows) == n_test and gap <= 1e-4
          and [r["uid"] for r in rows] == [r["uid"] for r in single],
          f"ensemble rows {rows} vs {single}")
    check(ecounts["ln_gemm_i8"] > 0, f"ensemble launches {ecounts}")
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"{tag} phase 50: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 51: the last two model families of the registry (queue A #8, #9):
# the 3D ResNet50 baseline and MST-ResNet34 (BatchNorm, Grad-CAM++; their
# convolutions are cuDNN's, as JAX leaves them to XLA: no hand-written
# kernel) and ViT-S/14 with the slice-fusion options (average, linear,
# RoPE, LiRE) on the fused encoder kernels.
# ---------------------------------------------------------------------------
FAM_SAMPLES = 16  # Synthetic volumes per split: two B=8 steps an epoch
# The ResNets' bf16 paths against the same model in f32 on the card (TF32
# off): limits a few times the largest readings on an H100 with these
# seeded inputs (the readings are in PERF.md).
RESNET_PROB_TOL = 0.005  # probs, serving and Grad-CAM++ with TTA
# The seeded MST-ResNet's volumes give probs within 0.0009 of each other
# (its CLS token, init normal(1), outweighs the pooled slice features),
# under the bf16 noise (0.0011): no probs limit can tell a row of the wrong
# slot there, so the phase holds each volume's Grad-CAM++ map nearest its
# own f32 map (both models), and the volumes' probs further apart than
# RESNET_PROB_TOL for the 3D ResNet only.
RESNET_SAL_REL = 0.05  # Grad-CAM++ saliency, of the f32 map's largest value
RESNET_LOSS_TOL = 0.1  # |loss bf16 - loss f32| at each of two steps
RESNET_STATS_REL = 0.1  # BN running statistics after two steps: a
# mean's error in its channel's running std, a variance's relative
# Batches the fusion steps pool: over 4 the linear fusion's loss rule read
# 1.71 once (0.73 over 8 in the same call, the grads' rules 0.99-1.23)
FUSION_STEP_BATCHES = 8
FAM_CLI_SAMPLES = 8  # Synthetic volumes per split of the CLI round trips
FUSIONS = {"average": dict(slice_fusion="average"),
           "linear": dict(slice_fusion="linear", num_slices=DEPTH_SLICES),
           "RoPE": dict(rotary="RoPE"), "LiRE": dict(rotary="LiRE")}


def sal_rel_err(a, b) -> float:
    """max |a - b| relative to b's largest magnitude (0 where both are
    0)."""
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


@contextlib.contextmanager
def computing_in(model, dtype):
    """`model` computes in `dtype` inside the block (its parameters stay
    as they are)."""
    saved = model.dtype
    model.dtype = dtype
    try:
        yield
    finally:
        model.dtype = saved


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def post_volume(port: int, vol: np.ndarray) -> dict:
    buf = io.BytesIO()
    np.save(buf, vol)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def family_cli_round_trip(tag, dev, what, argv, base, synth) -> None:
    """`train` (one epoch through the CLI's `main`) -> `predict --run_folder
    --use_tta --get_attention` -> `serve --run_folder` (one POST against the
    served model's predict fn, its BN statistics those of the best
    checkpoint)."""
    from mst_tpu_torch import predict as predict_cli
    from mst_tpu_torch import serve
    from mst_tpu_torch.models import convert
    from mst_tpu_torch.registry import get_dataset
    from mst_tpu_torch.train import cli
    from mst_tpu_torch.train.predictor import make_predict_fn
    from mst_tpu_torch.utils.checkpoint import load_best_batch_stats

    t0 = time.perf_counter()
    run, result = cli.main(argv + ["--run_dir", str(base / "runs"),
                                   "--max_epochs", "1"], device=dev, **synth)
    t_train = time.perf_counter() - t0
    times = {}
    out = predict_cli.main(["--run_folder", str(run), "--use_tta",
                            "--get_attention", "--output_dir",
                            str(base / f"{what}_predict")], device=dev,
                           times=times, **synth)
    rows = csv_rows(out / "results.csv")
    pos = [r["uid"] for r in rows if r["GT"] == "1"]
    pngs = sorted(q.relative_to(out).as_posix() for q in
                  out.glob("case_*/*.png"))
    want = sorted(f"case_{u}/{f}.png" for u in pos  # Synthetic has masks
                  for f in ("attention", "ground_truth", "input"))
    check(len(rows) == synth["num_samples"] and all(
        math.isfinite(float(r["NN_pred"])) for r in rows),
        f"{what} predict rows {rows}")
    check(pngs == want, f"{what} predict PNGs {pngs} != {want}")
    sargs = serve.parse_args(["--run_folder", str(run), "--port", "0",
                              "--batch_size", "4", "--max_wait_ms", "1"])
    smodel = serve.build_model(sargs, device=dev)
    stats = load_best_batch_stats(run)
    if stats is not None:
        got = convert.flax_batch_stats_from_torch(smodel)
        check(set(got) == set(stats) and all(
            np.array_equal(got[k], stats[k]) for k in stats),
            f"{what}: the served model's BN statistics are not the run's")
    vol = np.asarray(get_dataset("Synthetic", "test", **synth)[0]["source"],
                     np.float32)
    direct, _ = make_predict_fn(smodel, with_saliency=False)(vol[None], None)
    server, predictor = serve.build_server(sargs, smodel)
    try:
        res = post_volume(server.server_address[1], vol)
    finally:
        server.shutdown()
        server.server_close()
        predictor.close()
    d = float(np.abs(np.asarray(res["probs"]) - direct[0].cpu().numpy()
                     ).max())
    print(f"{tag} {what} CLIs: train {result.epochs_run} epoch in "
          f"{t_train:.1f} s -> {run.name}; predict --use_tta --get_attention "
          f"{len(rows)} cases, {len(pos)} positives' PNGs, forward "
          f"{times.get('forward', 0.0) * 1e3 / len(rows):.1f} ms a case; "
          f"serve --run_folder POST vs its predict fn: {d:.6g} (limit "
          f"{SERVE_TOL})")
    check(d <= SERVE_TOL, f"{what} served probs {d}")
    del smodel


def model_families_phase(tag, dev, fb, per_fwd, per_step, plain_sublayers,
                         plain_train_sublayers) -> None:
    """Phase 51 (see the module docstring); `per_fwd` / `per_step` are
    phase 4's and phase 8's launch counts of a ViT-S B=8 forward and train
    step, `plain_sublayers` / `plain_train_sublayers` their routings of
    the serving and train sub-layers to the plain versions."""
    stamp(tag, "51")
    t_phase = time.perf_counter()
    from mst_tpu_torch.models import convert
    from mst_tpu_torch.models.vit_fast import mst_logits
    from mst_tpu_torch.registry import get_model, model_entry
    from mst_tpu_torch.train import cli
    from mst_tpu_torch.train.predictor import make_predict_fn
    from mst_tpu_torch.train.trainer import (
        TrainState,
        cross_entropy_loss,
        make_optimizer,
        make_train_step,
    )

    torch.cuda.empty_cache()
    base = ROOT / "build" / "chip_smoke_families"  # gitignored
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    synth = dict(num_samples=FAM_SAMPLES,
                 shape_cdhw=(1, DEPTH_SLICES, PX, PX))
    rng = np.random.default_rng(SEED + 51)
    bf, f32 = torch.bfloat16, torch.float32
    check(not torch.backends.cudnn.benchmark,
          "cuDNN autotuning is on; the phase reads its default heuristics")
    print(f"{tag} ResNet limits, bf16 vs the same model in f32 (TF32 off): "
          f"probs {RESNET_PROB_TOL}, Grad-CAM++ saliency {RESNET_SAL_REL} of "
          f"the f32 map's largest value, loss {RESNET_LOSS_TOL}, BN "
          f"statistics {RESNET_STATS_REL} (a mean's error in its channel's "
          f"running std, a variance's relative)")

    # -- the ResNets, through the train CLI's builders ----------------------
    for name in ("ResNet", "ResNetSliceTrans"):
        t1 = time.perf_counter()
        args = cli.parse_args(["--dataset", "Synthetic", "--model", name,
                               "--batch_size", str(BATCH),
                               "--num_train_samples", str(FAM_SAMPLES),
                               "--seed", str(SEED)])
        dm = cli.build_datamodule(args, dev, **synth)
        model = cli.build_model(args, device=dev, dm=dm)
        check(model.dtype == bf and model.variant == (
            50 if name == "ResNet" else 34), f"{name}: {model.variant}")
        cli.build_trainer(args, dm, run_dir=base / name).init_state(
            model, seed=SEED)
        batches = [(b["source"], torch.from_numpy(b["target"]).to(
            dev, torch.long)) for b in dm.train_dataloader()][:2]
        entry = model_entry(name)
        check(len(batches) == 2 and tuple(batches[0][0].shape) == (
            BATCH, 1, DEPTH_SLICES, PX, PX), f"{name} batches")
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}

        def two_steps(dtype):
            """Two AdamW steps from `start` computing in `dtype` -> (losses,
            BN statistics after)."""
            model.load_state_dict(start)
            with computing_in(model, dtype):
                step = make_train_step(TrainState(model, make_optimizer(
                    model.parameters(), entry.learning_rate,
                    entry.weight_decay)))
                losses = [float(step(s, t)[0]) for s, t in batches]
            return losses, convert.flax_batch_stats_from_torch(model)

        # serving and Grad-CAM++ with TTA at B=8 on the seeded weights (the
        # statistics at init), bf16 vs f32
        pred = make_predict_fn(model, with_saliency=False)
        vols = spread_volumes(rng, pred, BATCH)
        mask = padding_mask(BATCH) if name == "ResNetSliceTrans" else None
        pk, _ = pred(vols, mask)
        with computing_in(model, f32):
            p32, _ = pred(vols, mask)
        d_p, gap = (pk - p32).abs().max().item(), min_row_gap(p32.cpu())
        spred = make_predict_fn(model, tta=True)
        torch.cuda.reset_peak_memory_stats()
        sp, sk = spred(vols, mask)
        peak_s = torch.cuda.max_memory_allocated()
        with computing_in(model, f32):
            sp32, s32 = spred(vols, mask)
        d_sp, d_s = (sp - sp32).abs().max().item(), sal_rel_err(sk, s32)
        # each volume's bf16 map nearest its own f32 map: the slot guard
        # where the volumes' probs lie closer than the bf16 noise
        own = [min(range(BATCH), key=lambda j: sal_rel_err(sk[i], s32[j]))
               for i in range(BATCH)]
        print(f"{tag} {name} serving B={BATCH} {list(vols.shape)}: probs[0] "
              f"{pk[0].tolist()}, |bf16 - f32| {d_p:.6g}, min gap between "
              f"volumes (f32) {gap:.6g}; Grad-CAM++ with TTA ({8 * BATCH} "
              f"volumes a batch): |probs bf16 - f32| {d_sp:.6g}, saliency "
              f"{list(sk.shape)} vs f32 {d_s:.6g} of its largest value "
              f"{s32.abs().max().item():.6g}, each map nearest its own "
              f"f32 map: {own == list(range(BATCH))}, peak memory "
              f"{peak_s / 2**30:.2f} GiB")
        check(tuple(sk.shape) == (BATCH, DEPTH_SLICES, PX, PX) and bool(
            torch.isfinite(sk).all() and torch.isfinite(pk).all()),
            f"{name} outputs")
        check(d_p <= RESNET_PROB_TOL and d_sp <= RESNET_PROB_TOL,
              f"{name} probs {d_p} / {d_sp}")
        if name == "ResNet":  # MST-ResNet: see RESNET_PROB_TOL's note
            check(gap > RESNET_PROB_TOL, f"{name}: volumes {gap} apart")
        check(d_s <= RESNET_SAL_REL, f"{name} saliency {d_s}")
        check(own == list(range(BATCH)), f"{name}: maps of other slots {own}")
        if mask is not None:  # padded slices: no slice attention, no map
            m = torch.from_numpy(mask).to(dev)
            leak = sk[m].abs().max().item()
            vols2 = vols.copy()
            vols2[1, :, m[1].cpu().numpy()] = 100.0
            d_pad = (pred(vols2, mask)[0][1] - pk[1]).abs().max().item()
            print(f"{tag} {name}: padded slices' saliency {leak:.6g}, "
                  f"perturbing them moves probs by {d_pad:.6g}")
            check(leak == 0.0 and d_pad <= 1e-6, f"{name} padding leaks")

        loss_k, stats_k = two_steps(bf)
        loss_32, stats_32 = two_steps(f32)
        model.load_state_dict(start)
        stats0 = convert.flax_batch_stats_from_torch(model)
        moved = max(float(np.abs(v - stats0[k]).max())
                    for k, v in stats_32.items())
        d_loss = max(abs(a - b) for a, b in zip(loss_k, loss_32))
        # a running mean's error in its channel's running std (a mean near
        # 0 has no relative error to speak of), a variance's relative
        d_stats = {}
        for k, v in stats_32.items():
            scale = (np.sqrt(stats_32[k[:-len("mean")] + "var"])
                     if k.endswith("/mean") else np.abs(v))
            d_stats[k] = float((np.abs(stats_k[k] - v) / scale).max())
        worst = max(d_stats, key=d_stats.get)
        print(f"{tag} {name}: two AdamW steps at lr {entry.learning_rate} "
              f"B={BATCH}: losses bf16 {loss_k}, f32 {loss_32}, max |diff| "
              f"{d_loss:.6g}; BN statistics ({len(stats_k)} arrays, moved by "
              f"up to {moved:.4g}) bf16 vs f32, means in running "
              f"stds, variances relative: worst {d_stats[worst]:.6g} "
              f"({worst}), median {statistics.median(d_stats.values()):.6g}")
        check(all(math.isfinite(v) for v in loss_k + loss_32),
              f"{name} losses {loss_k} {loss_32}")
        check(moved > 0.0, f"{name}: the steps left the BN statistics")
        check(d_loss <= RESNET_LOSS_TOL, f"{name} loss {d_loss}")
        check(d_stats[worst] <= RESNET_STATS_REL,
              f"{name} BN statistics {d_stats[worst]}")

        # times: the train step, one predict-CLI case of Grad-CAM++ + TTA
        step0 = make_train_step(TrainState(model, make_optimizer(
            model.parameters(), 0.0)))  # lr 0: the same work
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        sec = host_seconds(lambda: step0(*batches[0]), 3)
        peak = torch.cuda.max_memory_allocated() - held
        sec_case = host_seconds(lambda: spred(vols[:1], None), 3)
        sec_fwd = host_seconds(lambda: pred(vols, None), 3)
        n_params = sum(q.numel() for q in model.parameters())
        print(f"{tag} {name} ({n_params / 1e6:.2f} M parameters) B={BATCH} "
              f"bf16: train step (forward, CE, backward, AdamW) "
              f"{sec * 1e3:.3f} ms = {BATCH / sec:.3f} vol/s, peak memory "
              f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held; "
              f"serving forward {sec_fwd * 1e3:.3f} ms = "
              f"{BATCH / sec_fwd:.3f} vol/s; a Grad-CAM++ predict case (one "
              f"volume, 8 flips) {sec_case * 1e3:.3f} ms; phase part "
              f"{time.perf_counter() - t1:.1f} s")
        del model, pred, spred, step0, dm
        torch.cuda.empty_cache()

    # -- ViT-S/14 with the slice-fusion options on the fused kernels --------
    # Serving and `last` saliency as phases 4 and 12 hold them; the
    # unfrozen step as phase 18 holds DINOv3's, over FUSION_STEP_BATCHES
    # batches: kernel vs plain grads within STEP_GRAD_REL (each parameter's
    # summed max distance over its summed max magnitude), and against the
    # f32 step
    # (plain sub-layers) the kernel path as close as the plain path (the
    # mean |loss - f32 loss| and the summed medians and maxima of the grads'
    # errors each at most STEP_F32_RATIO times the plain path's): on one
    # batch the kernel-vs-plain loss distance of a random-weight ViT-S read
    # 0.0038 (linear) and 0.0023 (RoPE), above phase 8's 2e-3, while the
    # plain path lay as far from f32, and over 4 batches the kernel path's
    # mean distance from f32 0.0034 against plain's 0.0020 (linear), 0.73x
    # over 8.
    vols8 = candidate_volumes(rng, BATCH)
    mask8 = padding_mask(BATCH)
    tgt8 = torch.arange(BATCH, device=dev) % 2
    step_srcs = [torch.from_numpy(candidate_volumes(rng, BATCH)).to(dev)
                 for _ in range(FUSION_STEP_BATCHES)]

    def loss_and_grads(mdl, src, dtype=None):
        mdl.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(mst_logits(mdl, src, None, train=True,
                                             dtype=dtype), tgt8)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: q.grad.detach().clone()
                             for n, q in mdl.named_parameters()}

    def rels(grads, ref):
        return {n: ((g - ref[n]).abs().max().item()
                    / max(ref[n].abs().max().item(), 1e-30))
                for n, g in grads.items()}

    for label, kw in FUSIONS.items():
        t1 = time.perf_counter()
        model = get_model("DinoV2ClassifierSlice", dtype=bf, **kw).to(dev)
        flat = convert.random_flax_params(model, SEED)
        for k in flat:  # O(1) LayerScale: every block counts
            if k.endswith("/gamma"):
                flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                           ).astype(np.float32)
        convert.params_from_flax(model, flat)
        pred = make_predict_fn(model, with_saliency=False)
        spred = make_predict_fn(model)
        fb.reset_launch_counts()
        pk, _ = pred(vols8, mask8)
        torch.cuda.synchronize()
        c_fwd = fb.launch_counts()
        fb.reset_launch_counts()
        sp, sk = spred(vols8, mask8)
        torch.cuda.synchronize()
        c_sal = fb.launch_counts()
        with plain_sublayers():
            pp, _ = pred(vols8, mask8)
            spp, spl = spred(vols8, mask8)
        d_p = max((pk - pp).abs().max().item(), (sp - spp).abs().max().item())
        d_s = sal_rel_err(sk, spl)
        d_kp, e_k, e_p, num, den = [], [], [], {}, {}
        med_k = med_p = max_k = max_p = 0.0
        for i, src in enumerate(step_srcs):
            fb.reset_launch_counts()
            loss_k, g_k = loss_and_grads(model, src)
            if i == 0:
                c_step = fb.launch_counts()
            with plain_train_sublayers():
                loss_p, g_p = loss_and_grads(model, src)
                loss_32, g_32 = loss_and_grads(model, src, f32)
            d_kp.append(abs(loss_k - loss_p))
            e_k.append(abs(loss_k - loss_32))
            e_p.append(abs(loss_p - loss_32))
            for n, g in g_k.items():
                num[n] = num.get(n, 0.0) + (g - g_p[n]).abs().max().item()
                den[n] = den.get(n, 0.0) + g_p[n].abs().max().item()
            r_k, r_p = rels(g_k, g_32), rels(g_p, g_32)
            med_k += statistics.median(r_k.values())
            med_p += statistics.median(r_p.values())
            max_k += max(r_k.values())
            max_p += max(r_p.values())
        # kernel vs plain per parameter, pooled: a 2-entry head bias whose
        # grad nearly cancels over one batch has no scale of its own
        pooled = {n: num[n] / max(den[n], 1e-30) for n in num}
        worst_name = max(pooled, key=pooled.get)
        worst_rel = pooled[worst_name]
        loss_ratio = statistics.mean(e_k) / max(statistics.mean(e_p), 1e-12)
        med_ratio, max_ratio = med_k / med_p, max_k / max_p
        extra = ""
        if label == "LiRE":
            gen = "fusion_0.self_attn.liere_generators"
            extra = (f", LiRE generators' grad vs plain "
                     f"{rels(g_k, g_p)[gen]:.6g} (last batch)")
        print(f"{tag} ViT-S/14 {label} fusion B={BATCH} (key-padding mask): "
              f"|probs kernel - plain| {d_p:.6g} (limit {PROB_TOL}), `last` "
              f"saliency vs plain {d_s:.6g} (limit {SAL_REL}); unfrozen "
              f"step over {len(step_srcs)} batches: |loss kernel - plain| "
              f"{[round(v, 6) for v in d_kp]} (mean "
              f"{statistics.mean(d_kp):.6g}"
              f"; phase 8's one-batch limit {STEP_LOSS_TOL}, printed), vs "
              f"f32: kernel {[round(v, 6) for v in e_k]}, plain "
              f"{[round(v, 6) for v in e_p]}, means' ratio "
              f"{loss_ratio:.4g}; worst "
              f"pooled grad vs plain {worst_rel:.6g} ({worst_name}; limit "
              f"{STEP_GRAD_REL}); grads vs f32 kernel / plain: medians "
              f"{med_ratio:.4g}, maxima {max_ratio:.4g} (limit "
              f"{STEP_F32_RATIO}){extra}; launches: forward "
              f"{nonzero(c_fwd)}, saliency {nonzero(c_sal)}, step "
              f"{nonzero(c_step)}; {time.perf_counter() - t1:.1f} s")
        check(bool(torch.isfinite(sk).all()) and tuple(sk.shape) == (
            BATCH, DEPTH_SLICES, PX, PX), f"{label} saliency")
        check(d_p <= PROB_TOL and d_s <= SAL_REL,
              f"{label} serving {d_p} / {d_s}")
        check(worst_rel <= STEP_GRAD_REL, f"{label} grads {worst_rel}")
        check(loss_ratio <= STEP_F32_RATIO and med_ratio <= STEP_F32_RATIO
              and max_ratio <= STEP_F32_RATIO,
              f"{label} step vs f32: {loss_ratio} / {med_ratio} / "
              f"{max_ratio}")
        check_launches(c_fwd, per_fwd, f"{label} forward")
        check_launches(c_sal, per_fwd, f"{label} `last` saliency")
        check_launches(c_step, per_step, f"{label} train step")
        if label in ("average", "linear"):  # uniform slice weights
            check(bool((sk.sum(dim=(2, 3)) > 0).all()),
                  f"{label}: a slice without saliency")
        del model, pred, spred, g_k, g_p, g_32
        torch.cuda.empty_cache()

    # -- the CLIs: train -> predict -> serve --------------------------------
    common = ["--dataset", "Synthetic", "--batch_size", str(BATCH),
              "--num_train_samples", str(FAM_CLI_SAMPLES), "--seed",
              str(SEED)]
    synth_cli = dict(synth, num_samples=FAM_CLI_SAMPLES)
    family_cli_round_trip(tag, dev, "ResNetSliceTrans",
                          common + ["--model", "ResNetSliceTrans"], base,
                          synth_cli)
    family_cli_round_trip(tag, dev, "ViT-S/14 --rotary LiRE",
                          common + ["--rotary", "LiRE"], base, synth_cli)
    print(f"{tag} phase 51: {time.perf_counter() - t_phase:.1f} s")


# The registered serving ops (`torch.ops.mst_tpu_torch.<op>`) and the kernel
# wrappers whose launches each op's node stands for.
OP_WRAPPERS = {
    "ln_rows": ("ln_rows",), "gemm_act": ("ln_gemm",),
    "gemm_swiglu": ("ln_gemm_swiglu",),
    "mhsa": tuple(f"{w}{r}" for w in ("mhsa", "mhsa_with_row",
                                     "mhsa_rollout", "mhsa_abnar")
                  for r in ("", "_rope")),
    "gemm_residual": ("gemm_residual",), "ln_quant_rows": ("ln_quant_rows",),
    "gemm_i8": ("ln_gemm_i8", "ln_gemm_i8_swiglu"),
    "quant_rows": ("quant_rows",), "gemm_i8_residual": ("gemm_i8_residual",),
    "flash_fwd": ("flash_fwd",)}
# Nodes that only reshape, cast or unpack, allowed beside the registered ops
# where a fused sub-layer or the composed attention core is called.
SHAPE_OPS = ("getitem", "aten.to.", "aten.reshape.", "aten.view.",
             "aten.transpose.", "aten.unbind.", "aten.select.",
             "aten._assert_tensor_metadata.", "aten.expand.")


def host_spread(fn, n: int = 5):
    """(median, min, max) host ms of `fn()` ending in a synchronize, after
    one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(ts), min(ts), max(ts)


def kernel_sites():
    """{(file, line)} of the lines that call a fused sub-layer
    (`layers.Block.forward` / `_forward_i8`) or the composed path's
    attention core (`layers.Attention.forward`): there a graph node must be
    a registered op or a shape op."""
    from mst_tpu_torch.models import layers

    sites = set()
    for fn in (layers.Block.forward, layers.Block._forward_i8,
               layers.Attention.forward):
        lines, first = inspect.getsourcelines(fn)
        sites |= {(inspect.getsourcefile(fn), first + i)
                  for i in range(len(lines))}
    return sites


def graph_ops(ep, sites) -> tuple:
    """(registered op -> node count, nodes at `sites` that compute in aten
    ops, i.e. a sub-layer or attention core in its plain version, and the
    registered op nodes whose stack trace does not lead to `sites`)."""
    ops, plain, unsited = {}, [], 0
    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        target = str(node.target)
        frames = re.findall(r'File "([^"]+)", line (\d+)',
                            node.meta.get("stack_trace") or "")
        at_site = bool(frames) and (frames[-1][0],
                                    int(frames[-1][1])) in sites
        if target.startswith("mst_tpu_torch."):
            op = target.split(".")[1]
            ops[op] = ops.get(op, 0) + 1
            unsited += not at_site
        elif (at_site and not target.startswith(SHAPE_OPS)
              and not target.endswith("getitem>")):
            plain.append(target)
    return ops, plain, unsited


def first_answer(proc, port: int, vol, out) -> None:
    """POST `vol` to the server `proc` as soon as it listens on `port`
    (within 300 s): sets `out.answer`, `out.seconds` (the POST's own) and
    `out.t_answer` (its `time.perf_counter()`)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 300 and proc.poll() is None:
        t_post = time.perf_counter()
        try:
            out.answer = post_volume(port, vol)
        except OSError:  # not listening yet
            time.sleep(0.2)
            continue
        out.t_answer = time.perf_counter()
        out.seconds = out.t_answer - t_post
        return


def export_phase(tag, dev, fb, run_dir) -> None:
    """Phase 52 (see the module docstring): the serving artifacts."""
    stamp(tag, "52")
    t_phase = time.perf_counter()
    base = ROOT / "build" / "chip_smoke_export"  # gitignored
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    server = SimpleNamespace(proc=None, log=None)
    try:
        export_checks(tag, dev, fb, run_dir, base, server)
    finally:  # however the phase ended
        stop_server(server)
    print(f"{tag} phase 52: {time.perf_counter() - t_phase:.1f} s")


def stop_server(server) -> None:
    """Stop the `serve --exported` process `server.proc` (Ctrl-C, then a
    kill after 60 s), once."""
    if server.proc is None:
        return
    server.proc.send_signal(signal.SIGINT)
    try:
        server.proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        server.proc.kill()
        server.proc.wait()
    server.log.close()
    server.proc = None

def export_checks(tag, dev, fb, run_dir, base, server) -> None:
    """Phase 52's exports and checks; `server.proc` is the `serve
    --exported` process it starts (`server.log` its log file)."""
    from mst_tpu_torch import export as ex
    from mst_tpu_torch.models.convert import (
        initial_batch_stats,
        params_from_flax,
        random_flax_params,
    )
    from mst_tpu_torch.ops import fused_int8 as fq
    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.serve import build_model, calibration_volumes, parse_args
    from mst_tpu_torch.train.predictor import make_predict_fn

    synth = dict(shape_cdhw=(1, DEPTH_SLICES, PX, PX), num_samples=BATCH)
    run = ["--run_folder", str(run_dir)]
    rng = np.random.default_rng(SEED + 52)
    vols = candidate_volumes(rng, BATCH)
    first = SimpleNamespace(answer=None, seconds=None, t_answer=None)
    # -- export: phase 9's run folder through the CLI, DINOv3 by the API --
    exports = {
        "bf16": (["--batch_sizes", "1,8"], {}),
        "rollout_tta": (["--batch_sizes", "1", "--with_saliency",
                         "--plane_mode", "rollout", "--use_tta"], {}),
        "int8": (["--batch_sizes", "8", "--int8"], {}),
        "int8_static": (["--batch_sizes", "8", "--int8", "--int8_calib",
                         str(BATCH)], synth),
        "518px": (["--batch_sizes", "1", "--hw", str(PX_LONG)], {}),
    }
    arts, secs = {}, {}
    log_path = base / "serve_exported.log"
    for name, (argv, kw) in exports.items():
        t1 = time.perf_counter()
        arts[name] = ex.main(run + ["--out", str(base / name), *argv], **kw)
        secs[name] = time.perf_counter() - t1
        if server.proc is None:
            # `serve --exported` boots in a fresh process while the other
            # exports and the checks below run
            with socket.socket() as s_:
                s_.bind(("127.0.0.1", 0))
                port = s_.getsockname()[1]
            server.log = open(log_path, "w")
            t_start, wall_start = time.perf_counter(), time.time()
            server.proc = subprocess.Popen(
                [sys.executable, "-X", "importtime", "-m",
                 "mst_tpu_torch.serve", "--exported", str(arts[name]),
                 "--port", str(port), "--batch_size", str(BATCH),
                 "--max_wait_ms", "1"],
                cwd=ROOT, stdout=server.log, stderr=subprocess.STDOUT)
            # ... and is asked as soon as it listens
            poster = threading.Thread(
                target=first_answer, args=(server.proc, port, vols[0], first),
                daemon=True)
            poster.start()
    proc = server.proc
    # phase 16's seeded MST-DINOv3 ViT-S/16, O(1) LayerScale
    flat3 = random_flax_params(get_model(MODEL3), SEED)
    for key in flat3:
        if key.endswith("/gamma"):
            flat3[key] = (1.0 + 0.1 * rng.standard_normal(flat3[key].shape)
                          ).astype(np.float32)
    model3 = params_from_flax(get_model(MODEL3, dtype=torch.bfloat16),
                              flat3).to(dev).eval()
    t1 = time.perf_counter()
    arts["dinov3"] = ex.save_exported(base / "dinov3", model3,
                                      batch_sizes=[BATCH])
    secs["dinov3"] = time.perf_counter() - t1
    # phase 51's 3D ResNet50, seeded, with BatchNorm statistics of its own:
    # the Grad-CAM++ program (its gradient in closed form) with the TTA
    resnet = get_model("ResNet", dtype=torch.bfloat16)
    stats = {k: (v + 0.1 * rng.standard_normal(v.shape) if k.endswith(
        "/mean") else v * (1.0 + 0.5 * np.abs(rng.standard_normal(v.shape)))
                 ).astype(np.float32)
             for k, v in initial_batch_stats(resnet).items()}
    resnet = params_from_flax(resnet, random_flax_params(resnet, SEED),
                              stats).to(dev).eval()
    t1 = time.perf_counter()
    arts["resnet3d"] = ex.save_exported(base / "resnet3d", resnet,
                                        batch_sizes=[1], with_saliency=True,
                                        tta=True)
    secs["resnet3d"] = time.perf_counter() - t1
    print(f"{tag} export seconds (python -m mst_tpu_torch.export's main on "
          f"phase 9's run folder; DINOv3 ViT-S/16 and the 3D ResNet50 by "
          f"save_exported): "
          f"{ {k: round(v, 3) for k, v in secs.items()} }")
    t_phase = time.perf_counter()
    for name, art in arts.items():
        sizes = {f.name: f.stat().st_size for f in sorted(art.iterdir())}
        print(f"{tag} artifact {name}: bytes {sizes}")
        check(all(sizes[f] < sizes["params.npz"] / 10 for f in sizes
                  if f.endswith(".pt2")), f"{name}: a .pt2 holds weights")

    # -- the live models the artifacts were exported from ------------------
    live = build_model(parse_args(run))
    live8 = fq.quantize_mst_int8(live)
    live8s = fq.quantize_mst_int8(live, calibration_volumes(run_dir, BATCH,
                                                            **synth))
    src8 = torch.from_numpy(vols).to(dev)
    long1 = torch.from_numpy(rng.standard_normal(
        (1, 1, DEPTH_SLICES, PX_LONG, PX_LONG), dtype=np.float32)).to(dev)
    cases = {  # name: (artifact, live predict fn, bucket, volumes)
        "bf16 b8": ("bf16", make_predict_fn(live, with_saliency=False), 8,
                    src8),
        "bf16 b1": ("bf16", make_predict_fn(live, with_saliency=False), 1,
                    src8[:1]),
        "rollout_tta b1": ("rollout_tta", make_predict_fn(
            live, tta=True, plane_mode="rollout"), 1, src8[:1]),
        "int8 b8": ("int8", make_predict_fn(live8, with_saliency=False), 8,
                    src8),
        "int8_static b8": ("int8_static", make_predict_fn(
            live8s, with_saliency=False), 8, src8),
        "dinov3 b8": ("dinov3", make_predict_fn(model3, with_saliency=False),
                      8, src8),
        "518px b1": ("518px", make_predict_fn(live, with_saliency=False), 1,
                     long1),
        "resnet3d gradcam++_tta b1": ("resnet3d", make_predict_fn(
            resnet, tta=True), 1, src8[:1]),
    }
    sites = kernel_sites()
    loaded = {}
    for label, (name, live_fn, b, src) in cases.items():
        if name not in loaded:  # with CUDA graphs, and without
            graph_p = ex.load_exported(arts[name])
            plain_p = ex.load_exported(arts[name], cuda_graphs=False)
            plain_p._programs = graph_p._programs  # one load of each program
            loaded[name] = graph_p, plain_p
        graph_p, plain_p = loaded[name]
        fb.reset_launch_counts()
        ref_p, ref_s = live_fn(src, None)
        torch.cuda.synchronize()
        want = nonzero(fb.launch_counts())
        ref_p = ref_p.float().cpu().numpy()
        ref_s = None if ref_s is None else ref_s.float().cpu().numpy()
        ops, plain, unsited = graph_ops(graph_p._program(b), sites)
        want_ops = {op: sum(want.get(w, 0) for w in ws)
                    for op, ws in OP_WRAPPERS.items()}
        print(f"{tag} export {label}: graph ops {ops}; the live forward's "
              f"launches {want}; aten compute nodes where a sub-layer or "
              f"the attention core is called: {plain}")
        check(ops == nonzero(want_ops), f"{label}: graph ops {ops} != the "
              f"live launches {nonzero(want_ops)}")
        check(not plain, f"{label}: plain sub-layer ops in the graph {plain}")
        check(unsited == 0, f"{label}: {unsited} registered op nodes whose "
              f"stack trace does not reach a sub-layer call")
        fb.reset_launch_counts()
        outs = [plain_p.predict(src)]
        torch.cuda.synchronize()
        got = nonzero(fb.launch_counts())
        outs += [graph_p.predict(src), graph_p.predict(src)]
        for i, (p_, s_) in enumerate(outs):
            what = ("uncaptured", "graph replay", "graph replay again")[i]
            same = np.array_equal(p_, ref_p) and (
                ref_s is None or np.array_equal(s_, ref_s))
            d_p = float(np.abs(p_ - ref_p).max())
            d_s = None if ref_s is None else float(np.abs(s_ - ref_s).max())
            print(f"{tag} export {label} {what}: probs[0] {p_[0].tolist()} "
                  f"max|loaded - live| probs {d_p:.6g} maps {d_s}; the same "
                  f"bits {same}")
            check(same, f"{label} {what}: not the live model's bits "
                  f"({d_p}, {d_s})")
        print(f"{tag} export {label}: the uncaptured call's launches {got} "
              f"({time.perf_counter() - t_phase:.1f} s into the checks)")
        check(got == want, f"{label}: loaded program launches {got} != "
              f"{want}")

    # -- re-pointed artifacts ------------------------------------------------
    flat1 = random_flax_params(live, SEED + 1)
    for key in flat1:
        if key.endswith("/gamma"):
            flat1[key] = (1.0 + 0.1 * rng.standard_normal(
                flat1[key].shape)).astype(np.float32)
    npz1 = base / "other_params.npz"
    np.savez(npz1, **flat1)
    live1 = build_model(parse_args(["--params_npz", str(npz1)]))
    live1_8 = fq.quantize_mst_int8(live1)
    for name, mdl, params in (
            ("bf16", live1, flat1),
            ("int8", live1_8, ex._program_tree(live1_8)[0])):
        graph_p = loaded[name][0]
        ref_p, _ = make_predict_fn(mdl, with_saliency=False)(src8, None)
        p_, _ = graph_p.predict(src8, params=params)
        same = np.array_equal(p_, ref_p.float().cpu().numpy())
        inputs = graph_p.program_inputs(params)
        q8t = [k for k in inputs if k.endswith("/q8t")]
        q8t_ok = all(torch.equal(inputs[k], inputs[k[:-1]].t()) for k in q8t)
        print(f"{tag} export {name} re-pointed at another seeded tree: "
              f"probs[:, 1] {p_[:, 1].tolist()}, the same bits as a live "
              f"model of that tree {same}; {len(q8t)} q8t == q8.T {q8t_ok}")
        check(same and q8t_ok, f"re-pointed {name}: {same}, q8t {q8t_ok}")
        back, _ = graph_p.predict(src8)  # and back to the artifact's own
        check(np.array_equal(back, loaded[name][1].predict(src8)[0]),
              f"{name}: back on its own tree")
    for name in ("int8_static",):
        inputs = loaded[name][0].program_inputs()
        q8t = [k for k in inputs if k.endswith("/q8t")]
        check(q8t and all(torch.equal(inputs[k], inputs[k[:-1]].t())
                          for k in q8t), f"{name}: q8t != q8.T after load")

    # -- serve --exported in a fresh process over HTTP ----------------------
    # Its cold start: the seconds from its start to its first answer, asked
    # as soon as it listened (the first POST loads the bucket's program and
    # captures its graph), all beside the work above.
    poster.join(timeout=max(1.0, 300 - (time.perf_counter() - t_start)))
    answer = first.answer
    check(answer is not None, "serve --exported: no answer in 300 s: "
          + log_path.read_text()[-2000:])
    check(proc.poll() is None, "serve --exported exited: "
          + log_path.read_text()[-2000:])
    cold = first.t_answer - t_start
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=60) as r:
        health = json.loads(r.read())
    lines = log_path.read_text().splitlines()
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in lines
                if ln.startswith("import time:")]
    banned = [m for m in imported if m.startswith("mst_tpu_torch.models")
              or m.split(".")[0] in ("jax", "jaxlib", "mst_tpu")]
    pad8 = np.repeat(vols[:1], BATCH, axis=0)
    ref_srv, _ = cases["bf16 b8"][1](pad8, None)
    ref_srv = ref_srv[0].float().cpu().numpy()
    same = np.array_equal(np.asarray(answer["probs"], np.float32), ref_srv)
    logged = [ln for ln in lines if ln[:2] == "20"]  # its logging lines
    ready = [ln for ln in logged if "ready" in ln]
    check(len(ready) == 1, f"serve --exported logged {logged}")
    boot = datetime.datetime.strptime(
        ready[0][:23], "%Y-%m-%d %H:%M:%S,%f").timestamp() - wall_start
    print(f"{tag} serve --exported (a fresh process, booting while the "
          f"other exports and the checks above ran): first answer "
          f"{cold:.3f} s after its start: ready {boot:.3f} s after its "
          f"start, then its first POST (the program's load and graph "
          f"capture, and the forward) {first.seconds:.3f} s: {answer}; its "
          f"log {logged}; the "
          f"live model on the same padded batch {ref_srv.tolist()}, the "
          f"same bits {same}; "
          f"healthz {health}; {len(imported)} modules imported, of "
          f"mst_tpu_torch.models / jax: {banned}")
    check(same and not banned and health["exported"] == str(arts["bf16"])
          and health["int8"] is None
          and health["model"] == "DinoSliceClassifier",
          f"serve --exported: {answer}, {health}, {banned}")
    check(len(imported) > 100 and "mst_tpu_torch.export" in imported,
          "serve --exported: the import log is not the server's")

    stop_server(server)  # the times below run on a quiet host

    # -- times: ViT-S B=8, bf16 and int8 static ------------------------------
    # Beside each: the caching allocator's retries (a cudaFree of its cache
    # and a new cudaMalloc), Python's garbage collections, and the CPU
    # seconds this process's other threads took, in its calls.
    def diagnosed(fn):
        retries = torch.cuda.memory_stats()["num_alloc_retries"]
        collections = sum(g["collections"] for g in gc.get_stats())
        cpu, own = time.process_time(), time.thread_time()
        spread = host_spread(fn)
        return (*spread,
                torch.cuda.memory_stats()["num_alloc_retries"] - retries,
                sum(g["collections"] for g in gc.get_stats()) - collections,
                time.process_time() - cpu - (time.thread_time() - own))

    print(f"{tag} time export: device memory held "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB; the host's load "
          f"average {os.getloadavg()}; this process's threads "
          f"{sorted(t.name for t in threading.enumerate())}")
    for name, mdl in (("bf16", live), ("int8_static", live8s)):
        pred = make_predict_fn(mdl, with_saliency=False)
        graph_p, plain_p = loaded[name]
        times = {
            "live forward": diagnosed(lambda: pred(src8, None)),
            "loaded program, no graph": diagnosed(
                lambda: plain_p.predict(src8)),
            "CUDA graph replay": diagnosed(lambda: graph_p.predict(src8)),
        }
        for what, (med, lo, hi, retries, collections, others) in (
                times.items()):
            print(f"{tag} time export {name} B={BATCH} {what}: {med:.3f} ms "
                  f"(median of 5; {lo:.3f}-{hi:.3f}) = "
                  f"{BATCH / med * 1e3:.3f} vol/s; allocator retries "
                  f"{retries}, garbage collections {collections}, the other "
                  f"threads' CPU {others:.3f} s")


# -- phase 53: saliency above 512 tokens (queue A #16) ----------------------

# The saliency kernels (csrc/flash_sal.cu) hold their f32 outputs to
# KERNEL_GRAD_REL x the plain output's largest value, as any one kernel's.
SAL_LONG_PX3_B = LONG_B  # DINOv3 at 512 px: B=2, as phase 35's forward
SAL_PEAK_ABOVE_HELD = 10 * 2**30  # rollout_abnar at 518 px, B=8


def sal_cost(n, s, part, heads=HEADS):
    """(FLOPs, bytes) of one saliency kernel over q, k [n, heads, s, 64]
    and the f32 LSE rows, as the function needs them: the CLS row reads
    q's row 0, K and the LSE of row 0 and writes [n, heads, s] (its scores
    2 s hd per head); the carry reads q, k, the LSE and the carry and writes
    [n, heads, s] (2 s^2 hd per head); the row normaliser reads q, k and
    the LSE and writes [n, s] f32 (2 s^2 hd per head)."""
    rows, qk = n * heads * s, n * heads * s * 64 * 2
    if part == "row":
        return 2 * n * heads * s * 64, qk // s + qk + 4 * n * heads + 4 * rows
    if part == "carry":
        return 2 * n * heads * s * s * 64, 2 * qk + 3 * 4 * rows
    return 2 * n * heads * s * s * 64, 2 * qk + 4 * rows + 4 * n * s


def sal_exp2_ms(n, s, mhz, heads=HEADS):
    """The exp2 unit's floor of the carry and the row normaliser: n heads
    s^2 exponentials at 16 a clock on each SM at an SM clock of `mhz`."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n * heads * s * s / (16 * sms * mhz * 1e6) * 1e3


def max_sm_mhz() -> float:
    """The card's top SM clock (`nvidia-smi` clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0])


def sal_plain_ops(fa):
    """The plain versions of the composed path's saliency attention
    (`attention.flash_attention_saliency`'s ops), FLASH_CHUNK slices at a
    time."""
    return SimpleNamespace(fwd=flash_chunked(fa.attention_reference),
                           row=flash_chunked(fa._flash_row_ref),
                           carry=flash_chunked(fa._flash_carry_ref),
                           abnar=flash_chunked(fa._flash_abnar_ref))


def long_volumes(dev, gen, pool, px):
    """`pool` seeded [1, D, px, px] volumes drawn on the card as
    `candidate_volumes` draws them: noise of its own scale and offset and a
    4 x 4 block pattern."""
    one = (pool, 1, 1, 1, 1)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(one, generator=gen, device=dev)

    cand = torch.randn((pool, 1, DEPTH_SLICES, px, px), generator=gen,
                       device=dev) * u(0.25, 2.0) + u(-1.5, 1.5)
    blocks = torch.randn((pool, DEPTH_SLICES, 4, 4), generator=gen,
                         device=dev) * u(0.0, 2.0)[:, 0]
    return cand + F.interpolate(blocks, size=(px, px))[:, None]


def spread_long(dev, gen, probs_of, n, px, pool):
    """n of `pool` seeded volumes at px (`long_volumes`) whose probs lie far
    apart: `pick_spread` on `probs_of`'s probs, BATCH volumes a call."""
    cand = long_volumes(dev, gen, pool, px)
    with torch.inference_mode():
        probs = torch.cat([probs_of(cand[i:i + BATCH])
                           for i in range(0, pool, BATCH)]).cpu().numpy()
    return cand[pick_spread(row_gaps(probs), probs, n)]


def check_sal_geometry(tag, fa, lib) -> None:
    """`attention.flash_sal_launch` (what the CPU tests read) against the
    kernels' own `mst_flash_sal_geometry` at every S up to 2048 and the
    path shapes, on this card's SM count."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(1, 1, s) for s in range(1, 2049)]
    shapes += [(N_SLICES, HEADS, 1370), (LONG_B * DEPTH_SLICES, HEADS, 1029),
               (DEPTH_SLICES, HEADS, 1601), (16, 24, 1370)]
    for b, h, s in shapes:
        for part_i, part in enumerate(fa.SAL_PARTS):
            geo = (ctypes.c_int * len(fa.SAL_GEOMETRY))()
            err = lib.mst_flash_sal_geometry(b, h, s, part_i, geo)
            g = fa.flash_sal_launch(b, h, s, part, sms)
            want = tuple(getattr(g, k) for k in fa.SAL_GEOMETRY)
            check(err == 0 and tuple(geo) == want,
                  f"saliency geometry {part} at [{b}, {h}, {s}]: kernel "
                  f"{tuple(geo)} ({err}), flash_sal_launch {want}")
    g = fa.flash_sal_launch(N_SLICES, HEADS, 1370, "abnar", sms)
    c = fa.flash_sal_launch(N_SLICES, HEADS, 1370, "carry", sms)
    print(f"{tag} saliency geometry: flash_sal_launch equals "
          f"mst_flash_sal_geometry at every S <= 2048 and the path shapes "
          f"([{N_SLICES}, {HEADS}, 1370]: the carry {c.units} units of "
          f"{c.walks} ring stages, the row normaliser {g.units} of "
          f"{g.walks}, on {g.grid} blocks of {g.threads} threads; "
          f"{c.smem} / {g.smem} bytes of shared memory)")


def keys_reversed(out):
    """The plain output of the CLS row or the carry with keys 64..127 (one
    key box) read in reverse order: its entries 64..127 reversed."""
    out = out.clone()
    tile = out[..., 64:128]
    tile.copy_(tile.flip(-1))
    return out


def keys_past_s_counted(q, lse, sm):
    """The plain row normaliser's error where the keys past S, which the
    TMA map reads as zeros (score 0), are not masked: (1 / H) sum_h (the
    stages' rows past S) exp2(-lse_h[q])."""
    s, heads = q.shape[2], q.shape[1]
    pad = -(-s // 128) * 128 - s
    return pad * torch.exp2(-lse.float()).sum(1) / heads


def sal_kernel_cases(tag, dev, fa, errs) -> None:
    """The CLS row, the carry over two chained blocks (the second fed the
    first's carry, not one-hot) and the row normaliser against their plain
    versions on the flash forward's LSE, each twice for the same bits: at
    the B=8 518 px shape [256, 6, 1370, 64] (head views of a packed qkv),
    DINOv3's S = 1029 with RoPE'd q, k, and 24 heads at S = 1370. Two
    planted faults per kernel must break the limit: the LSE of the
    neighbouring row, and keys 64..127 read in reverse order (the row
    normaliser sums its keys in any order alike, so its second fault is
    the keys past S counted, which the last stage masks)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 153)
    sm = 1.0 / 8
    cases = [("B8,S=1370", N_SLICES, 1370, HEADS, False),
             ("S=1029,rope", LONG_B * DEPTH_SLICES, 1029, HEADS, True),
             ("E=1536,S=1370", 16, 1370, 24, False)]
    for label, n, s, h, rope in cases:
        layers_ = []
        for _ in range(2):
            q, k, v = packed_heads(gen, dev, n, s, h)
            if rope:
                q, k = rope_heads(dev, q, k)
            layers_.append((q, k, fa.flash_fwd(q, k, v, want_lse=True)[1]))
        (q, k, lse), (q2, k2, lse2) = layers_
        e0 = torch.zeros(n, h, s, device=dev)
        e0[:, :, 0] = 1.0
        c1_plain = fa._flash_carry_ref(q, k, lse, e0, sm)
        forms = {
            "flash_row": (lambda: fa.flash_row(q, k, lse),
                          lambda: fa._flash_row_ref(q, k, lse, sm)),
            "flash_carry": (
                lambda: (fa.flash_carry(q, k, lse, e0),
                         fa.flash_carry(q2, k2, lse2, c1_plain)),
                lambda: (c1_plain,
                         fa._flash_carry_ref(q2, k2, lse2, c1_plain, sm))),
            "flash_abnar": (lambda: fa.flash_abnar(q, k, lse),
                            lambda: fa._flash_abnar_ref(q, k, lse, sm)),
        }
        rolled = lse.roll(1, 2)  # each row's LSE from the row before
        faults = {"flash_row": lambda: fa._flash_row_ref(q, k, rolled, sm),
                  "flash_carry": lambda: fa._flash_carry_ref(q, k, rolled,
                                                             e0, sm),
                  "flash_abnar": lambda: fa._flash_abnar_ref(q, k, rolled,
                                                             sm)}
        for form, (kern, plain) in forms.items():
            got, again = kern(), kern()
            torch.cuda.synchronize()
            ref = plain()
            name = f"{form}[{label}]"
            errs[name] = check_outputs(tag, f"kernel {name}", got, ref,
                                       KERNEL_GRAD_REL)
            got_t = got if isinstance(got, tuple) else (got,)
            again_t = again if isinstance(again, tuple) else (again,)
            ref_t = ref if isinstance(ref, tuple) else (ref,)
            same = all(torch.equal(a_, b_) for a_, b_ in zip(got_t, again_t))
            print(f"{tag} kernel {name}: two runs equal bit for bit: {same}")
            check(same, f"{name}: two runs differ")
            planted(tag, f"{name}: the LSE of the row before",
                    got_t[0], faults[form](), rel=KERNEL_GRAD_REL)
            if form == "flash_abnar":
                planted(tag, f"{name}: the keys past S counted", got_t[0],
                        ref_t[0] + keys_past_s_counted(q, lse, sm),
                        rel=KERNEL_GRAD_REL)
            else:
                planted(tag, f"{name}: keys 64..127 in reverse order",
                        got_t[0], keys_reversed(ref_t[0]),
                        rel=KERNEL_GRAD_REL)
            del got, again, ref, got_t, again_t, ref_t
        del layers_, q, k, lse, q2, k2, lse2, e0, c1_plain, rolled
        torch.cuda.empty_cache()


class SquareWatch(TorchDispatchMode):
    """The ops dispatched inside: each output with trailing dims [S, S] and
    each product (mm, bmm, matmul, addmm, baddbmm) with an [S, S] operand,
    by name and shape."""

    PRODUCTS = ("aten.mm", "aten.bmm", "aten.matmul", "aten.addmm",
                "aten.baddbmm")

    def __init__(self, s):
        super().__init__()
        self.s, self.made, self.products, self.ops = s, [], [], 0

    def _square(self, t):
        return (isinstance(t, torch.Tensor) and t.dim() >= 2
                and tuple(t.shape[-2:]) == (self.s, self.s))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        name = str(func.overloadpacket)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.made += [f"{name} {tuple(o.shape)}" for o in outs
                      if self._square(o)]
        if name in self.PRODUCTS and any(self._square(a) for a in args):
            self.products.append(f"{name} " + str([
                tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]))
        return out


def long_saliency_phase(tag, dev):
    """Phase 53: saliency above 512 tokens (queue A #16) on the composed
    path. Returns (errs, timed, cost, counts per plane mode) for the
    kernels line."""
    from mst_tpu_torch import export as ex
    from mst_tpu_torch.models import layers
    from mst_tpu_torch.models import vit as vit_mod
    from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
    from mst_tpu_torch.models.vit_fast import fused_mst_saliency, mst_logits
    from mst_tpu_torch.ops import _build
    from mst_tpu_torch.ops import attention as fa
    from mst_tpu_torch.ops import fused_block as fb
    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.serve import MODEL
    from mst_tpu_torch.train.predictor import make_predict_fn

    stamp(tag, "53")
    t_phase = time.perf_counter()
    errs, timed, cost = {}, {}, {}
    check_sal_geometry(tag, fa, _build.lib())
    print(f"{tag} long saliency tolerance: the kernels' f32 outputs within "
          f"{KERNEL_GRAD_REL} x the plain version's largest value, twice "
          f"for the same bits; the forward's probs as phase 4, its maps "
          f"within {SAL_REL} of the plain path's largest value and "
          f"{SAL_F32_REL} of the f32 plain path's (phase 12)")
    with torch.inference_mode():
        sal_kernel_cases(tag, dev, fa, errs)
    print(f"{tag} phase 53 kernels: {time.perf_counter() - t_phase:.1f} s")

    plain_flash_ops, plain_sal_ops = flash_plain_ops(fa), sal_plain_ops(fa)

    @contextlib.contextmanager
    def plain_long():
        """The composed blocks' attention, its saliency outputs and the
        Abnar rollout's sweep back on their plain versions on the card."""
        saved = (layers.flash_attention, layers.flash_attention_saliency,
                 vit_mod.abnar_rollout_row)
        layers.flash_attention = functools.partial(fa.flash_attention,
                                                   ops=plain_flash_ops)
        layers.flash_attention_saliency = functools.partial(
            fa.flash_attention_saliency, ops=plain_sal_ops)
        vit_mod.abnar_rollout_row = functools.partial(fa.abnar_rollout_row,
                                                      ops=plain_sal_ops)
        try:
            yield
        finally:
            (layers.flash_attention, layers.flash_attention_saliency,
             vit_mod.abnar_rollout_row) = saved

    def seeded(name):
        rng_ = np.random.default_rng(SEED)
        flat_ = random_flax_params(get_model(name), SEED)
        for key in flat_:
            if key.endswith("/gamma"):
                flat_[key] = (1.0 + 0.1 * rng_.standard_normal(
                    flat_[key].shape)).astype(np.float32)
        return params_from_flax(get_model(name, dtype=torch.bfloat16),
                                flat_).to(dev).eval()

    def saliency(mdl, src, mode, m=None, dtype=None):
        with torch.inference_mode():
            out = fused_mst_saliency(mdl, src, m, dtype=dtype,
                                     plane_mode=mode)
        torch.cuda.synchronize()
        return out

    zero = {k: 0 for k in fb.launch_counts()}
    depth = 12
    want_mode = {
        "last": {**zero, "flash_fwd": depth, "flash_row": 1},
        "rollout": {**zero, "flash_fwd": depth, "flash_carry": depth},
        "rollout_abnar": {**zero, "flash_fwd": depth, "flash_abnar": depth,
                          "flash_carry": depth}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    model = seeded(MODEL)
    model3 = seeded(MODEL3)
    counts = {}
    for what, mdl, px, nb in (("518 px ViT-S/14", model, PX_LONG, BATCH),
                              ("512 px DINOv3 ViT-S/16", model3, PX3_LONG,
                               SAL_LONG_PX3_B)):
        src = spread_long(dev, gen, lambda x: torch.softmax(
            mst_logits(mdl, x), -1), nb, px, 2 * nb)
        with torch.inference_mode():
            p_fwd = torch.softmax(mst_logits(mdl, src), -1)
        mask_t = torch.from_numpy(padding_mask(nb)).to(dev)
        for mode in PLANE_MODES:
            for label, m in (("no mask", None), ("key-padding mask", mask_t)):
                fb.reset_launch_counts()
                pk, sk = saliency(mdl, src, mode, m)
                got = fb.launch_counts()
                with plain_long():
                    pp_, sp_ = saliency(mdl, src, mode, m)
                    p32, s32 = saliency(mdl, src, mode, m, torch.float32)
                check(tuple(sk.shape) == (nb, DEPTH_SLICES, px, px)
                      and sk.dtype == torch.float32, f"{what} {sk.shape}")
                check(bool(torch.isfinite(sk).all()
                           and torch.isfinite(pk).all()),
                      f"{what} {mode}: non-finite output")
                d_p, d_p32 = ((pk - pp_).abs().max().item(),
                              (pk - p32).abs().max().item())
                d_s, d_s32 = sal_rel_err(sk, sp_), sal_rel_err(sk, s32)
                d_fwd = ((pk - p_fwd).abs().max().item() if m is None
                         else 0.0)
                print(f"{tag} long saliency {what} {mode} [{label}] "
                      f"{list(sk.shape)}: |probs - plain| {d_p:.6g}, |probs "
                      f"- f32| {d_p32:.6g}, |probs - forward without "
                      f"saliency| {d_fwd:.6g}; saliency vs plain {d_s:.6g}, "
                      f"vs f32 {d_s32:.6g} (of the largest value "
                      f"{sp_.abs().max().item():.6g}); plain vs f32 "
                      f"{sal_rel_err(sp_, s32):.6g}; launches {nonzero(got)}")
                check(d_p <= PROB_TOL and d_p32 <= F32_TOL,
                      f"{what} {mode} probs: {d_p} / {d_p32}")
                check(d_s <= SAL_REL and d_s32 <= SAL_F32_REL,
                      f"{what} {mode} saliency: {d_s} / {d_s32}")
                check(d_fwd <= 1e-6, f"{what} {mode}: probs moved by {d_fwd}")
                if m is not None:  # padded slices get no slice attention
                    leak = sk[mask_t].abs().max().item()
                    check(leak == 0.0, f"{what} {mode}: padded slices' "
                          f"saliency {leak}")
                check_launches(got, want_mode[mode], f"{what} {mode}")
                if mdl is model and m is None:
                    counts[mode] = got
                del pk, sk, pp_, sp_, p32, s32
            print(f"{tag} phase 53 {what} {mode}: "
                  f"{time.perf_counter() - t_phase:.1f} s")
        if mdl is model:
            src518 = src
    del model3

    # -- export: the 518 px saliency program, replayed bit for bit -----------
    # One mode on the card, `rollout_abnar` (its graph holds the most
    # saliency ops: a row normaliser and a carry a block; three modes took
    # 34 s of the run, one 19 s); the CPU tests export all three
    # (tests/test_torch_export.py)
    base = ROOT / "build" / "chip_smoke_long_saliency"  # gitignored
    shutil.rmtree(base, ignore_errors=True)
    t1 = time.perf_counter()
    art = ex.save_exported(base, model, batch_sizes=[1], depth=DEPTH_SLICES,
                           hw=PX_LONG, with_saliency=True,
                           plane_mode="rollout_abnar")
    secs = time.perf_counter() - t1
    ops = {}
    for node in torch.export.load(art / "program_b1.pt2").graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("mst_tpu_torch."):
            op = target.split(".")[1]
            ops[op] = ops.get(op, 0) + 1
    live = make_predict_fn(model, plane_mode="rollout_abnar")
    fb.reset_launch_counts()
    ref_p, ref_s = live(src518[:1], None)
    torch.cuda.synchronize()
    want = nonzero(fb.launch_counts())
    print(f"{tag} long saliency export rollout_abnar: {secs:.1f} s; graph ops "
          f"{ops}; the live forward's launches {want}")
    check(ops.get("flash_fwd", 0) + ops.get("flash_fwd_lse", 0)
          == want.get("flash_fwd", 0)
          and ops.get("flash_abnar", 0) == want.get("flash_abnar", 0)
          == ops.get("flash_fwd_lse", 0)
          and ops.get("flash_carry", 0) == want.get("flash_carry", 0) > 0,
          f"rollout_abnar: graph ops {ops} != the live launches {want}")
    ref_p, ref_s = ref_p.float().cpu().numpy(), ref_s.float().cpu().numpy()
    loaded = ex.load_exported(art)
    for what in ("graph replay", "graph replay again"):
        p_, s_ = loaded.predict(src518[:1])
        same = np.array_equal(p_, ref_p) and np.array_equal(s_, ref_s)
        print(f"{tag} long saliency export rollout_abnar {what}: max|loaded - "
              f"live| probs {float(np.abs(p_ - ref_p).max()):.6g} maps "
              f"{float(np.abs(s_ - ref_s).max()):.6g}; the same bits {same}")
        check(same, f"long saliency export rollout_abnar {what}: not the live "
              f"model's bits")
    del loaded
    torch.cuda.empty_cache()
    shutil.rmtree(base, ignore_errors=True)
    print(f"{tag} phase 53 export: {time.perf_counter() - t_phase:.1f} s")

    # -- times: the kernels, vol/s, B=1 TTA latency, peak memory, profiles --
    with torch.inference_mode(), ClockSampler() as clocks:
        q, k, v = packed_heads(gen, dev, N_SLICES, 1370)
        _, lse = fa.flash_fwd(q, k, v, want_lse=True)
        carry = torch.rand(N_SLICES, HEADS, 1370, generator=gen, device=dev)
        sm = 1.0 / 8
        plain = sal_plain_ops(fa)
        forms = {"flash_row": ((fa.flash_row, q, k, lse),
                               (plain.row, q, k, lse, sm), "row"),
                 "flash_carry": ((fa.flash_carry, q, k, lse, carry),
                                 (plain.carry, q, k, lse, carry, sm),
                                 "carry"),
                 "flash_abnar": ((fa.flash_abnar, q, k, lse),
                                 (plain.abnar, q, k, lse, sm), "abnar")}
        for form, (kern, plain_call, part) in forms.items():
            name = f"{form}[B8,S=1370]"
            t1 = time.perf_counter()
            km = time_ms(lambda: kern[0](*kern[1:]))
            mhz = clocks.within([(t1, time.perf_counter())]).mhz
            pm_ = time_ms(lambda: plain_call[0](*plain_call[1:]), n=3,
                          warmup=1)
            cost[name] = sal_cost(N_SLICES, 1370, part)
            timed[name] = (km, pm_)
            b_ms, b_by = bound([cost[name]])
            top = max_sm_mhz()
            floor = ("" if part == "row" else
                     f"; the exp2 unit's floor "
                     f"{sal_exp2_ms(N_SLICES, 1370, top):.4f} ms at the "
                     f"card's top {top:.0f} MHz, " + (
                         f"{sal_exp2_ms(N_SLICES, 1370, mhz):.4f} ms at the "
                         f"{mhz:.0f} MHz read while timed"
                         if isinstance(mhz, float) else "SM clock not sampled"))
            print(f"{tag} time {name}: kernel {km:.4f} ms, plain {pm_:.4f} "
                  f"ms, bound {b_ms:.4f} ms by {b_by} ({b_ms / km:.3f} of "
                  f"it; {cost[name][0] / 1e9:.3f} GFLOP, "
                  f"{cost[name][1] / 1e6:.2f} MB){floor}, library none")
        del q, k, v, lse, carry
        torch.cuda.empty_cache()

    def seconds_and_memory(fn, n=3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        sec_ = host_seconds(fn, n)
        return sec_, torch.cuda.max_memory_allocated() - held

    predict = make_predict_fn(model, with_saliency=False)
    sec_fwd, mem_fwd = seconds_and_memory(lambda: predict(src518, None))
    print(f"{tag} e2e 518 px B={BATCH} without saliency: "
          f"{sec_fwd * 1e3:.3f} ms = {BATCH / sec_fwd:.4f} vol/s, peak "
          f"memory {mem_fwd / 2**20:.1f} MiB above the "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held")
    nsz = N_SLICES * 1370 * 1370 * 4
    for mode in PLANE_MODES:
        sec_m, mem_m = seconds_and_memory(
            lambda: saliency(model, src518, mode))
        tta = make_predict_fn(model, tta=True, plane_mode=mode)
        sec_1 = host_seconds(lambda: tta(src518[:1], None), 3)
        print(f"{tag} e2e 518 px saliency {mode} B={BATCH}: "
              f"{sec_m * 1e3:.3f} ms = {BATCH / sec_m:.4f} vol/s "
              f"({sec_m / sec_fwd:.3f}x the forward without saliency), peak "
              f"memory {mem_m / 2**20:.1f} MiB above what was held "
              f"({mem_m / nsz:.3f} x one [256, 1370, 1370] f32 matrix of "
              f"{nsz / 2**20:.1f} MiB); batch-1 8-flip TTA with saliency: "
              f"{sec_1 * 1e3:.3f} ms per volume")
        if mode == "rollout_abnar":
            # each block's q, k, LSE and row normaliser kept, never a
            # factor, a head's [S, S] probabilities or a chain's product
            check(mem_m < SAL_PEAK_ABOVE_HELD, f"rollout_abnar peak memory "
                  f"{mem_m} above what was held >= {SAL_PEAK_ABOVE_HELD}")
            with SquareWatch(1370) as watch:
                saliency(model, src518, mode)
            print(f"{tag} rollout_abnar's dispatched ops: {watch.ops}; "
                  f"outputs [.., 1370, 1370] {watch.made or 'none'}; "
                  f"products with a [1370, 1370] operand "
                  f"{watch.products or 'none'}")
            check(watch.ops > 0 and not watch.made and not watch.products,
                  f"rollout_abnar made {watch.made}, ran {watch.products}")
        shapes = profile_device(
            tag, f"one 518 px B={BATCH} saliency forward ({mode})",
            lambda: saliency(model, src518, mode), 8,
            record_shapes=mode == "rollout_abnar")
        if mode == "rollout_abnar":
            square = [(key, sh) for key, sh in shapes
                      if any(tuple(x[-2:]) == (1370, 1370) for x in sh
                             if len(x) >= 2)]
            products = [(key, sh) for key, sh in square
                        if key in ("aten::mm", "aten::bmm", "aten::matmul",
                                   "aten::addmm", "aten::baddbmm")]
            print(f"{tag} rollout_abnar's profile: {len(shapes)} ops with "
                  f"their input shapes, {len(square)} of them with an input "
                  f"[.., 1370, 1370], {len(products)} products")
            check(shapes and not square, f"rollout_abnar's profile: {square}")
    print(f"{tag} phase 53: {time.perf_counter() - t_phase:.1f} s")
    return errs, timed, cost, counts


def main() -> int:
    if not (ROOT / "mst_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (mst_tpu_torch/csrc not found)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))

    from mst_tpu_torch import predict as predict_cli
    from mst_tpu_torch.models import layers, vit_fast
    from mst_tpu_torch.models.convert import (
        flax_params_from_torch,
        params_from_flax,
        random_flax_params,
    )
    from mst_tpu_torch.models.vit_fast import (
        fused_mst_saliency,
        fused_seq_len_ok,
        mst_logits,
    )
    from mst_tpu_torch.ops import _build
    from mst_tpu_torch.ops import attention as fa
    from mst_tpu_torch.ops import fused_block as fb
    from mst_tpu_torch.ops import fused_int8 as fq
    from mst_tpu_torch.ops.rotary import apply_rope_tables, rope_tables
    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.serve import (
        MODEL,
        build_model,
        build_server,
        calibration_volumes,
        parse_args,
    )
    from mst_tpu_torch.train import cli
    from mst_tpu_torch.train.predictor import make_predict_fn
    from mst_tpu_torch.train.trainer import (
        TrainState,
        cross_entropy_loss,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from mst_tpu_torch.utils.checkpoint import best_params_path
    from mst_tpu_torch.utils.nifti import write_nifti

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    tag = f"[{smi}]"
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"{tag} device: {torch.cuda.get_device_name(0)} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"{tag} matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- 2. build ----------------------------------------------------------
    stamp(tag, "2")
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib_path = _build.build(verbose=True)  # -Xptxas -v: registers, spills
    print(log.getvalue(), end="")
    _build.lib()
    print(f"{tag} build: {time.perf_counter() - t0:.2f} s -> "
          f"{lib_path.relative_to(ROOT)}")
    # the largest seeded draws (phases 22 and 27: giant2, ViT-B, ViT-L, 46
    # s of host time a run) on host threads after the build (during it they
    # slow nvcc down), each with the train CLI's model built on the CPU for
    # its names and shapes; joined before phase 6, the first that times
    # anything
    def cli_model(*argv):
        return lambda: cli.build_model(cli.parse_args(
            ["--dataset", "Synthetic", *argv]), device="cpu")

    host_draws = {
        "giant2": HostDraw(cli_model("--model_size", "giant2", "--freeze"),
                           SEED),
        "base": HostDraw(cli_model("--model_size", "base"), SEED),
        "large": HostDraw(cli_model("--model_size", "large",
                                    "--fusion_heads", "16"), SEED)}
    check_machine_code(tag, log.getvalue(), _build, lib_path)
    check_gemm_geometry(tag, fb, _build.lib())
    check_attn_geometry(tag, fb, _build.lib())
    check_tools_attn_geometry(tag, _build.lib())
    check_flash_geometry(tag, fa, _build.lib())
    probe_errs = check_layout_probes(tag, dev, _build.lib())

    # -- 3. kernels vs plain at the path's shapes --------------------------
    stamp(tag, "3")
    rng = np.random.default_rng(SEED)

    def t(arr, dtype=torch.float32):
        return torch.from_numpy(np.asarray(arr, np.float32)).to(dev, dtype)

    def rand(*shape, scale=1.0, off=0.0, dtype=torch.float32):
        return t(off + scale * rng.standard_normal(shape), dtype)

    bf = torch.bfloat16
    M = N_SLICES * S
    x = rand(N_SLICES, S, E, dtype=bf)
    x2 = x.reshape(M, E)
    ln_s, ln_b = rand(E, scale=0.1, off=1.0), rand(E, scale=0.1)
    wqkv, bqkv = rand(E, 3 * E, scale=E ** -0.5, dtype=bf), rand(3 * E, scale=0.1)
    wproj, bproj = rand(E, E, scale=E ** -0.5, dtype=bf), rand(E, scale=0.1)
    w1, b1 = rand(E, 4 * E, scale=E ** -0.5, dtype=bf), rand(4 * E, scale=0.1)
    w2, b2 = rand(4 * E, E, scale=(4 * E) ** -0.5, dtype=bf), rand(E, scale=0.1)
    # O(1) LayerScale (the init value 1e-5 would hide the branch entirely)
    ls = rand(E, scale=0.1, off=1.0)
    qkv_in = fb._ln_gemm_ref(x2, ln_s, ln_b, wqkv, bqkv, fb.ACT_NONE, 1e-6)
    o_in = fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS)
    h_in = fb._ln_gemm_ref(x2, ln_s, ln_b, w1, b1, fb.ACT_GELU_TANH, 1e-6)

    print(f"{tag} kernel tolerance: max|kernel - plain| <= 2 bf16 ulps at "
          f"the output's largest magnitude (both sides round at the same "
          f"points; only the f32 summation order differs, which can flip "
          f"one bf16 rounding of an intermediate)")
    def pair(kernel_fn, plain_fn, *args):
        """A kernel wrapper and its plain version on the same arguments."""
        return (lambda: kernel_fn(*args)), (lambda: plain_fn(*args))

    eps = 1e-6
    cases = {
        "ln_gemm[qkv]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2, ln_s, ln_b,
                             wqkv, bqkv, fb.ACT_NONE, eps),
        "ln_gemm[fc1,gelu_tanh]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2, ln_s,
                                       ln_b, w1, b1, fb.ACT_GELU_TANH, eps),
        "ln_gemm[fc1,gelu_erf]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2, ln_s,
                                      ln_b, w1, b1, fb.ACT_GELU_ERF, eps),
        "mhsa": pair(fb.mhsa, fb._mhsa_ref, qkv_in, N_SLICES, S, HEADS),
        "gemm_residual[proj,ls]": pair(fb.gemm_residual, fb._gemm_residual_ref,
                                       o_in, wproj, bproj, ls, x2),
        "gemm_residual[proj,no_ls]": pair(fb.gemm_residual,
                                          fb._gemm_residual_ref, o_in, wproj,
                                          bproj, None, x2),
        "gemm_residual[fc2,ls]": pair(fb.gemm_residual, fb._gemm_residual_ref,
                                      h_in, w2, b2, ls, x2),
    }
    attn_args = (x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)
    mlp_args = (x, ln_s, ln_b, w1, b1, w2, b2)
    for label, lsv in (("ls", ls), ("no_ls", None)):
        cases[f"attention_sublayer[{label}]"] = pair(
            fb.fused_attention_sublayer, fb._attn_ref, *attn_args, lsv, HEADS)
    for label, lsv, approx in (("tanh,ls", ls, True), ("erf,ls", ls, False),
                               ("tanh,no_ls", None, True)):
        cases[f"mlp_sublayer[{label}]"] = pair(
            fb.fused_mlp_sublayer, fb._mlp_ref, *mlp_args, lsv, approx)
    errs = dict(probe_errs)
    for name, (kern, plain) in cases.items():
        k, p = kern(), plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k.float()).all()), f"{name}: non-finite")
        d = (k.float() - p.float()).abs()
        scale = p.float().abs().max().item()
        tol = 2 * ulp_bf16(scale)
        err = d.max().item()
        rel = err / scale
        errs[name] = err
        print(f"{tag} kernel {name}: shape={list(k.shape)} max_abs_err={err:.6g}"
              f" max_rel_err={rel:.6g} tol={tol:.6g} (|plain|max={scale:.6g})")
        check(err <= tol, f"{name}: max_abs_err {err} > {tol}")
    # What each timed kernel case must do, for its bound (FLOPs, bytes), and
    # the one PyTorch call that computes the same function (its library
    # time), where there is one; SDPA returns no LSE rows. The GEMMs with a
    # residual or of the backward are timed in turn with their library
    # calls for the same work in phases 41 and 42, not here.
    cost = {
        "ln_gemm[qkv]": mm_cost(M, E, 3 * E, 4 * 5 * E),
        "ln_gemm[fc1,gelu_tanh]": mm_cost(M, E, 4 * E, 4 * 6 * E),
        "mhsa": attn_cost(N_SLICES, S),
        "gemm_residual[proj,ls]": mm_cost(M, E, E, 2 * M * E + 4 * 2 * E),
        "gemm_residual[fc2,ls]": mm_cost(M, 4 * E, E, 2 * M * E + 4 * 2 * E),
    }
    ln_w, ln_bias = ln_s.to(bf), ln_b.to(bf)
    library = {
        "ln_gemm[qkv]": lambda: torch.addmm(
            bqkv.to(bf), F.layer_norm(x2, (E,), ln_w, ln_bias, eps), wqkv),
        "ln_gemm[fc1,gelu_tanh]": lambda: F.gelu(torch.addmm(
            b1.to(bf), F.layer_norm(x2, (E,), ln_w, ln_bias, eps), w1),
            approximate="tanh"),
        "mhsa": functools.partial(F.scaled_dot_product_attention,
                                  *heads_of(qkv_in, N_SLICES, S)),
    }

    # -- 4. full forward ---------------------------------------------------
    stamp(tag, "4")
    # The model is built as `python -m mst_tpu_torch.serve --params_npz`
    # builds it, from seeded random weights with O(1) LayerScale so that
    # every block counts.
    flat = random_flax_params(get_model(MODEL), SEED)
    for key in flat:
        if key.endswith("/gamma"):
            flat[key] = (1.0 + 0.1 * rng.standard_normal(flat[key].shape)
                         ).astype(np.float32)
    npz = ROOT / "build" / "chip_smoke_params.npz"  # gitignored
    npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez(npz, **flat)
    args = parse_args(["--params_npz", str(npz), "--port", "0",
                       "--batch_size", "4", "--max_wait_ms", "1000"])
    model = build_model(args)
    check(model.dtype == torch.bfloat16, f"serving dtype {model.dtype}")
    predict = make_predict_fn(model, with_saliency=False)
    vol = spread_volumes(rng, predict, BATCH)

    @contextlib.contextmanager
    def plain_sublayers():
        """Route the blocks' serving sub-layers (the saliency ones too)
        through the plain versions on the card."""
        plain = {"fused_attention_sublayer": fb._attn_ref,
                 "fused_mlp_sublayer": fb._mlp_ref,
                 "fused_swiglu_sublayer": fb._swiglu_ref,
                 "fused_attention_sublayer_with_row": fb._attn_with_row_ref,
                 "fused_attention_sublayer_rollout": fb._attn_rollout_ref,
                 "fused_attention_sublayer_abnar": fb._attn_abnar_ref,
                 "fused_attention_sublayer_rope": fb._attn_rope_ref,
                 "fused_attention_sublayer_rope_with_row":
                     fb._attn_rope_with_row_ref,
                 "fused_attention_sublayer_i8": fq._attn_i8_ref,
                 "fused_mlp_sublayer_i8": fq._mlp_i8_ref,
                 "fused_swiglu_sublayer_i8": fq._swiglu_i8_ref}
        saved = {k: getattr(layers, k) for k in plain}
        for k, fn in plain.items():
            setattr(layers, k, fn)
        try:
            yield
        finally:
            for k, fn in saved.items():
                setattr(layers, k, fn)

    print(f"{tag} forward tolerance: |probs kernel - probs plain| <= "
          f"{PROB_TOL} (bf16 roundings flipped by the summation order "
          f"compound over 11 blocks of a random-weight ViT-S)")
    n_blocks = 11  # block 11 is the CLS-only plain block
    zero = {k: 0 for k in fb.launch_counts()}
    zero_calls = {k: 0 for k in fb.sublayer_calls()}

    def check_forward(what, mdl, pred, vols, want, want_calls,
                      plain=plain_sublayers):
        """`pred` (mdl's predict fn) on the volumes `vols` (B=8, or fewer
        where the plain path is slow), with and without the key-padding
        mask, against the plain path (`plain` routes it) and an f32 plain
        forward, with each forward's launch counts; padded slices must not
        move the probs. Returns the counts of the forward without the
        mask."""
        nb = len(vols)
        mask = padding_mask(nb)
        for label, m in (("no mask", None), ("key-padding mask", mask)):
            fb.reset_launch_counts()
            pk, _ = pred(vols, m)
            torch.cuda.synchronize()
            counts, calls = fb.launch_counts(), fb.sublayer_calls()
            if m is None:
                first = counts
            with plain():
                pp, _ = pred(vols, m)
            torch.cuda.synchronize()
            check(tuple(pk.shape) == (nb, 2),
                  f"probs shape {tuple(pk.shape)}")
            check(bool(torch.isfinite(pk).all()), "non-finite probs")
            check(bool(torch.allclose(pk.sum(-1), torch.ones(
                nb, device=dev), atol=1e-5)), "probs do not sum to 1")
            err = (pk - pp).abs().max().item()
            gap = min_row_gap(pp.cpu())
            print(f"{tag} {what} [{label}] {list(vols.shape)}: probs[0]="
                  f"{pk[0].tolist()} max|kernel-plain|={err:.6g} "
                  f"min gap between volumes={gap:.6g} launches={counts} "
                  f"sublayer calls={calls}")
            check(err <= PROB_TOL, f"{what} [{label}]: {err} > {PROB_TOL}")
            check(gap > PROB_TOL, f"{what} [{label}]: volumes {gap} apart, "
                  f"within the tolerance {PROB_TOL}")
            check_launches(counts, want, f"{what} [{label}]")
            check(calls == want_calls,
                  f"sub-layer calls {calls} != {want_calls}")
        # padded slices must not move the masked volume's probs
        vols2 = vols.copy()
        vols2[1, :, 24:] = 100.0 * rng.standard_normal(vols2[1, :, 24:].shape)
        pm, _ = pred(vols, mask)
        pm2, _ = pred(vols2, mask)
        d_pad = (pm[1] - pm2[1]).abs().max().item()
        print(f"{tag} {what}: perturbing padded slices moves probs by "
              f"{d_pad:.6g}")
        check(d_pad <= 1e-6, f"padded slices leak into the result ({d_pad})")
        # the bf16 kernel path against the plain path in f32 on the card
        with plain(), torch.inference_mode():
            p32 = torch.softmax(mst_logits(
                mdl, torch.from_numpy(vols).to(dev), dtype=torch.float32), -1)
        pk, _ = pred(vols, None)
        d32 = (pk - p32).abs().max().item()
        gap32 = min_row_gap(p32.cpu())
        print(f"{tag} {what}: max|probs bf16 kernel path - probs f32 plain "
              f"path|={d32:.6g} (tol {F32_TOL}: bf16 end-to-end error of a "
              f"random-weight ViT with O(1) LayerScale); min gap between volumes "
              f"(f32)={gap32:.6g}")
        check(d32 <= F32_TOL, f"bf16 kernel path vs f32: {d32} > {F32_TOL}")
        check(gap32 > F32_TOL, f"f32 volumes {gap32} apart, within {F32_TOL}")
        return first

    per_fwd = {**zero, "ln_gemm": 2 * n_blocks, "mhsa": n_blocks,
               "gemm_residual": 2 * n_blocks}
    calls_per_fwd = {**zero_calls, "fused_attention_sublayer": n_blocks,
                     "fused_mlp_sublayer": n_blocks}
    check_forward("forward", model, predict, vol, per_fwd, calls_per_fwd)

    # -- 5. server (the main path; launch counts read around it) ----------
    stamp(tag, "5")
    n_req, bs = 6, args.batch_size
    vols = spread_volumes(rng, predict, n_req)
    direct, _ = predict(vols, None)
    direct = direct.cpu().numpy()
    gap = min_row_gap(direct)
    print(f"{tag} server: min gap between the {n_req} volumes' direct probs "
          f"{gap:.6g} (must exceed the tolerance {SERVE_TOL})")
    check(gap > SERVE_TOL, f"direct probs {gap} apart, within {SERVE_TOL}")
    fb.reset_launch_counts()
    server, bp = build_server(args, model)
    port = server.server_address[1]
    results, errors = [None] * n_req, []

    def post(i):
        try:
            buf = io.BytesIO()
            np.save(buf, vols[i])
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = json.loads(r.read())
        except Exception as e:  # reported below; the phase then fails
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(n_req)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        bp.close()
    torch.cuda.synchronize()
    served_counts, served_calls = fb.launch_counts(), fb.sublayer_calls()
    check(not errors and all(not th.is_alive() for th in threads),
          f"requests failed: {errors}")
    worst = max(float(np.abs(np.asarray(results[i]["probs"]) - direct[i]).max())
                for i in range(n_req))
    print(f"{tag} server: {n_req} concurrent POSTs, batch {bs}: "
          f"batches_run={bp.batches_run} healthz={health} "
          f"max|served-direct|={worst:.6g} (tol {SERVE_TOL}: the kernels "
          f"work row by row, but cuBLAS may pick another algorithm for "
          f"another batch size in the plain parts)")
    check(health["ok"] and health["volumes_served"] == n_req
          and health["model"] == MODEL, f"healthz {health}")
    check(bp.batches_run >= 2, "a batch of 4 cannot hold 6 volumes")
    check(worst <= SERVE_TOL, f"served probs differ from direct: {worst}")
    check(all(results[i]["pred"] == int(np.argmax(results[i]["probs"]))
              for i in range(n_req)), "pred is not argmax(probs)")
    want = {k: v * bp.batches_run for k, v in per_fwd.items()}
    want_calls = {k: v * bp.batches_run for k, v in calls_per_fwd.items()}
    print(f"{tag} server launches: {served_counts} sublayer calls: "
          f"{served_calls}")
    check_launches(served_counts, want, "server")
    check(served_calls == want_calls,
          f"server sub-layer calls {served_calls} != {want_calls}")

    # -- 6. times ----------------------------------------------------------
    stamp(tag, "6")
    waited = sum(draw.wait() for draw in host_draws.values())
    print(f"{tag} host draws joined before the first timed phase: waited "
          f"{waited:.1f} s; ran " + ", ".join(
              f"{size} {draw.span[0]:.1f}-{draw.span[1]:.1f} s"
              for size, draw in host_draws.items()) + " of the run")
    timed = {name: (time_ms(kern), time_ms(plain))
             for name, (kern, plain) in cases.items()
             if not name.startswith(RES_GEMMS + ATTN)}  # phases 42-43
    for name, (km, pm_) in timed.items():
        print(f"{tag} time {name}: kernel {km:.4f} ms, plain {pm_:.4f} ms")
    lib_ms = {name: time_ms(fn) for name, fn in library.items()
              if not name.startswith(ATTN)}

    src8 = torch.from_numpy(vol).to(dev)

    def e2e():
        return host_seconds(lambda: predict(src8, None))

    torch.cuda.reset_peak_memory_stats()
    sec = e2e()
    peak = torch.cuda.max_memory_allocated()
    with plain_sublayers():
        sec_plain = e2e()
    print(f"{tag} e2e B={BATCH} {list(vol.shape)} bf16: kernel path "
          f"{sec * 1e3:.3f} ms = {BATCH / sec:.3f} vol/s; plain path "
          f"{sec_plain * 1e3:.3f} ms = {BATCH / sec_plain:.3f} vol/s; "
          f"peak memory (kernel path) {peak / 2**20:.1f} MiB")

    # -- 7. train kernels vs plain at the path's shapes --------------------
    stamp(tag, "7")
    print(f"{tag} train tolerance: bf16 outputs <= 2 bf16 ulps at |plain|max "
          f"(as phase 3); f32 outputs <= {KERNEL_GRAD_REL} x |plain|max for "
          f"one kernel (its sums run in another order), <= "
          f"{SUBLAYER_GRAD_REL} x for a sub-layer's chain (a bf16 rounding "
          f"that the order flips upstream moves the f32 sums after it)")
    tanh, erf = fb.ACT_GELU_TANH, fb.ACT_GELU_ERF
    g2 = rand(M, E, dtype=bf)  # upstream gradient
    qkv_t, h_t, _ = fb._ln_gemm_ref(x2, ln_s, ln_b, wqkv, bqkv, fb.ACT_NONE,
                                    eps, train=True)
    o_t, lse_t = fb._mhsa_ref(qkv_t, N_SLICES, S, HEADS, want_lse=True)
    a_t, h2_t, u_t = fb._ln_gemm_ref(x2, ln_s, ln_b, w1, b1, tanh, eps,
                                     train=True)
    do_t = fb._gemm_dgrad_ref(g2, wproj)
    dqkv_t = fb._mhsa_bwd_ref(qkv_t, o_t, do_t, lse_t, N_SLICES, S, HEADS)
    da_t = fb._gemm_dgrad_ref(g2, w2, a=a_t, act=tanh)
    ln_t = (x2, g2, ln_s, eps)
    tcases = {
        "ln_gemm_train[qkv]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2, ln_s, ln_b,
                                   wqkv, bqkv, fb.ACT_NONE, eps, True),
        "ln_gemm_train[fc1,gelu_tanh]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2,
                                             ln_s, ln_b, w1, b1, tanh, eps,
                                             True),
        "ln_gemm_train[fc1,gelu_erf]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2,
                                            ln_s, ln_b, w1, b1, erf, eps,
                                            True),
        "mhsa_train": pair(fb.mhsa, fb._mhsa_ref, qkv_t, N_SLICES, S, HEADS,
                           True),
        "gemm_dls[proj]": pair(fb.gemm_dls, fb._gemm_dls_ref, o_t, wproj,
                               bproj, ls, g2),
        "gemm_dls[fc2]": pair(fb.gemm_dls, fb._gemm_dls_ref, u_t, w2, b2, ls,
                              g2),
        "gemm_wgrad[proj]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, o_t, g2),
        "gemm_wgrad[qkv]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, h_t,
                                dqkv_t),
        "gemm_wgrad[fc2]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, u_t, g2),
        "gemm_wgrad[fc1]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, h2_t,
                                da_t),
        "gemm_dgrad[proj]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref, g2,
                                 wproj),
        "gemm_dgrad[fc2,gelu_tanh]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref,
                                          g2, w2, a_t, tanh),
        "gemm_dgrad[fc2,gelu_erf]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref,
                                         g2, w2, a_t, erf),
        "gemm_dgrad[qkv,ln]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref, dqkv_t,
                                   wqkv, None, fb.ACT_NONE, ln_t),
        "gemm_dgrad[fc1,ln]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref, da_t,
                                   w1, None, fb.ACT_NONE, ln_t),
        "mhsa_bwd": pair(fb.mhsa_bwd, fb._mhsa_bwd_ref, qkv_t, o_t, do_t,
                         lse_t, N_SLICES, S, HEADS),
    }
    for name, (kern, plain) in tcases.items():
        k, pl, again = kern(), plain(), kern()
        torch.cuda.synchronize()
        errs[name] = check_outputs(tag, f"kernel {name}", k, pl,
                                   KERNEL_GRAD_REL)
        k, again = ((k, again) if isinstance(k, tuple) else ((k,), (again,)))
        same = all(torch.equal(a, b) for a, b in zip(k, again)
                   if a is not None)
        print(f"{tag} kernel {name}: two runs equal bit for bit: {same}")
        check(same, f"{name}: two runs differ")
    del k, pl, again
    cost.update({
        # the train forward also writes h [M, E] (and for fc1 the bf16
        # pre-activation beside its GELU), and the LSE rows
        "ln_gemm_train[qkv]": mm_cost(M, E, 3 * E, 4 * 5 * E + 2 * M * E),
        "ln_gemm_train[fc1,gelu_tanh]": mm_cost(
            M, E, 4 * E, 4 * 6 * E + 2 * M * E + 2 * M * 4 * E),
        "mhsa_train": attn_cost(N_SLICES, S, 4 * M * HEADS),
        "gemm_dls[proj]": mm_cost(M, E, E, 2 * M * E + 4 * 3 * E),
        "gemm_dls[fc2]": mm_cost(M, 4 * E, E, 2 * M * E + 4 * 3 * E),
        "gemm_wgrad[proj]": wgrad_cost(M, E, E),
        "gemm_wgrad[qkv]": wgrad_cost(M, E, 3 * E),
        "gemm_wgrad[fc2]": wgrad_cost(M, 4 * E, E),
        "gemm_wgrad[fc1]": wgrad_cost(M, E, 4 * E),
        "gemm_dgrad[proj]": mm_cost(M, E, E),
        "gemm_dgrad[fc2,gelu_tanh]": mm_cost(M, E, 4 * E, 2 * M * 4 * E),
        "gemm_dgrad[qkv,ln]": mm_cost(M, 3 * E, E, 4 * M * E + 4 * 3 * E),
        "gemm_dgrad[fc1,ln]": mm_cost(M, 4 * E, E, 4 * M * E + 4 * 3 * E),
        "mhsa_bwd": attn_cost(N_SLICES, S, bwd=True),
    })

    def sdpa_backward(qkv, do, n, s, rope=None):
        """The SDPA backward of the attention core (`torch.autograd.grad` of
        F.scaled_dot_product_attention; with `rope` = (cos, sin) through the
        rotation in torch ops too) on the saved qkv and an upstream do."""
        leaves = [u.detach().requires_grad_(True) for u in heads_of(qkv, n, s)]
        q, k, v = leaves
        if rope is not None:
            q, k = (apply_rope_tables(u, *rope) for u in (q, k))
        out = F.scaled_dot_product_attention(q, k, v)
        do_h = do.reshape(n, s, HEADS, 64).permute(0, 2, 1, 3).contiguous()
        return functools.partial(torch.autograd.grad, out, leaves, do_h,
                                 retain_graph=True)

    library.update({
        "ln_gemm_train[qkv]": library["ln_gemm[qkv]"],
        "ln_gemm_train[fc1,gelu_tanh]": library["ln_gemm[fc1,gelu_tanh]"],
        "mhsa_train": library["mhsa"],
        "mhsa_bwd": sdpa_backward(qkv_t, do_t, N_SLICES, S),
    })
    g3 = g2.reshape(N_SLICES, S, E)
    sub = {
        "attention_sublayer_train[ls]": ("attn", (ln_s, ln_b, wqkv.float(),
                                                  bqkv, wproj.float(), bproj,
                                                  ls, HEADS, eps)),
        "attention_sublayer_train[no_ls]": ("attn", (ln_s, ln_b, wqkv.float(),
                                                     bqkv, wproj.float(),
                                                     bproj, None, HEADS, eps)),
    }
    for label, lsv, approx in (("tanh,ls", ls, True), ("erf,ls", ls, False),
                               ("tanh,no_ls", None, True)):
        sub[f"mlp_sublayer_train[{label}]"] = (
            "mlp", (ln_s, ln_b, w1.float(), b1, w2.float(), b2, lsv, approx,
                    eps))
    print(f"{tag} train sub-layers: outputs (y, residuals, dx, grads) of "
          f"the kernel chain vs the same chain on the plain versions "
          f"(attention: y h qkv o lse dx dln_s dln_b dwqkv dbqkv dwproj "
          f"dbproj [dls]; MLP: y h a u dx dln_s dln_b dw1 db1 dw2 db2 [dls])")
    for name, (kind, sargs) in sub.items():
        k = train_sublayer_outputs(fb, kind, fb.KERNELS, x, sargs, g3)
        pl = train_sublayer_outputs(fb, kind, fb.PLAIN, x, sargs, g3)
        torch.cuda.synchronize()
        errs[name] = check_outputs(tag, f"sublayer {name}", k, pl,
                                   SUBLAYER_GRAD_REL)
    del qkv_t, h_t, o_t, lse_t, a_t, h2_t, u_t, do_t, dqkv_t, da_t

    # -- 8. one train step at full width -----------------------------------
    stamp(tag, "8")
    # Built by `python -m mst_tpu_torch.train`'s builders; seeded weights,
    # then O(1) LayerScale so that every block counts.
    targs = cli.parse_args(["--dataset", "Synthetic", "--batch_size",
                            str(BATCH), "--max_epochs", "2",
                            "--num_train_samples", "16", "--seed",
                            str(SEED)])
    tmodel = cli.build_model(targs)
    check(tmodel.dtype == torch.bfloat16, f"train dtype {tmodel.dtype}")
    tdm = cli.build_datamodule(targs, dev, num_samples=16,
                               shape_cdhw=(1, DEPTH_SLICES, PX, PX))
    run_dir = ROOT / "build" / "chip_smoke_run"  # gitignored
    shutil.rmtree(run_dir, ignore_errors=True)
    trainer = cli.build_trainer(targs, tdm, run_dir=run_dir)
    trainer.init_state(tmodel, seed=SEED)
    with torch.no_grad():
        for name, prm in tmodel.named_parameters():
            if name.endswith(".gamma"):
                prm.copy_(torch.from_numpy(1.0 + 0.1 * rng.standard_normal(
                    tuple(prm.shape))).to(prm))
    batch = next(iter(tdm.train_dataloader()))
    src = batch["source"]
    tgt = torch.from_numpy(batch["target"]).to(dev, torch.long)
    check(tuple(src.shape) == (BATCH, 1, DEPTH_SLICES, PX, PX)
          and src.device == dev, f"train batch {tuple(src.shape)}")

    @contextlib.contextmanager
    def plain_train_sublayers():
        """Route the blocks' train sub-layers to the plain chain on the card."""
        names = ("fused_attention_sublayer_train",
                 "fused_attention_sublayer_train_rope",
                 "fused_mlp_sublayer_train", "fused_swiglu_sublayer_train")
        saved = {k: getattr(layers, k) for k in names}
        for k in names:
            setattr(layers, k, functools.partial(getattr(fb, k), ops=fb.PLAIN))
        try:
            yield
        finally:
            for k, fn in saved.items():
                setattr(layers, k, fn)

    def loss_and_grads(m_, src_, tgt_, dtype=None):
        """(loss, every grad) of one train step's forward and backward; in
        f64 (the oracle) the CE stays in f64."""
        m_.zero_grad(set_to_none=True)
        logits = mst_logits(m_, src_, None, train=True, dtype=dtype)
        loss = (F.cross_entropy(logits, tgt_) if dtype == torch.float64
                else cross_entropy_loss(logits, tgt_))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: q.grad.detach().clone()
                             for n, q in m_.named_parameters()
                             if q.requires_grad}

    def rel_errs(grads, ref):
        """Per parameter: max |grad - ref| / max |ref|."""
        out = {}
        for name, gr in grads.items():
            check(bool(torch.isfinite(gr).all()), f"grad {name}: non-finite")
            scale = ref[name].abs().max().item()
            out[name] = ((gr - ref[name]).abs().max().item() / scale
                         if scale else 0.0)
        return out

    def summary(rel):
        worst = sorted(rel.items(), key=lambda kv: -kv[1])
        return (f"max {worst[0][1]:.6g} ({worst[0][0]}), median "
                f"{statistics.median(rel.values()):.6g}; worst five: "
                + ", ".join(f"{n}={v:.3g}" for n, v in worst[:5]))

    def check_step(what, mdl, batches, want, want_calls,
                   plain=plain_train_sublayers, loss_tol=STEP_LOSS_TOL,
                   fault=None, oracle=torch.float32, grad_tol=STEP_GRAD_REL,
                   loss_vs_oracle=False):
        """The train step's loss and every grad on the kernels against the
        plain sub-layers (`plain`: the train ones, or for a frozen encoder
        the serving ones) and the oracle, the plain step in `oracle` (f32,
        or f64 with the model's residuals rebuilt block by block, remat,
        so that it fits), over `batches` [(src, tgt)] pooled: the mean
        |loss| difference (at most `loss_tol`; with `loss_vs_oracle`
        printed only, and the kernel path's mean |loss - oracle loss| held
        to STEP_F32_RATIO times the plain path's instead), the worst grad
        difference, and the summed medians and maxima of each path's grad
        errors vs the oracle. `fault`, a routing of the plain path with a
        planted fault, must break the loss limit on average: the limit
        would fail a wrong kernel. Returns the launch counts of the first
        step (the main path)."""
        oname = str(oracle)[6:]
        d_loss, d_k32, d_p32, worst_rel, meds, maxes = [], [], [], 0.0, [], []
        d_fault = []
        for i, (bsrc, btgt) in enumerate(batches):
            fb.reset_launch_counts()
            loss_k, grads_k = loss_and_grads(mdl, bsrc, btgt)
            counts, calls = fb.launch_counts(), fb.sublayer_calls()
            if i == 0:
                first = counts
            with plain():
                loss_p, grads_p = loss_and_grads(mdl, bsrc, btgt)
                remat = mdl.remat
                mdl.remat = remat or oracle == torch.float64
                try:
                    loss_32, grads_32 = loss_and_grads(mdl, bsrc, btgt,
                                                       oracle)
                finally:
                    mdl.remat = remat
            faulty = ""
            if fault is not None:
                with fault(), torch.no_grad():
                    loss_f = cross_entropy_loss(mst_logits(
                        mdl, bsrc, None, train=True), btgt).item()
                d_fault.append(abs(loss_f - (loss_32 if loss_vs_oracle
                                             else loss_p)))
                faulty = f", plain path with the planted fault {loss_f:.6g}"
            rel = rel_errs(grads_k, grads_p)
            rel_k32 = rel_errs(grads_k, grads_32)
            rel_p32 = rel_errs(grads_p, grads_32)
            d_loss.append(abs(loss_k - loss_p))
            d_k32.append(abs(loss_k - loss_32))
            d_p32.append(abs(loss_p - loss_32))
            worst_rel = max(worst_rel, max(rel.values()))
            meds.append((statistics.median(rel_k32.values()),
                         statistics.median(rel_p32.values())))
            maxes.append((max(rel_k32.values()), max(rel_p32.values())))
            print(f"{tag} {what} {list(bsrc.shape)}, batch {i}: "
                  f"loss kernel path {loss_k:.6g}, plain path {loss_p:.6g}, "
                  f"{oname} plain path {loss_32:.6g}{faulty}; launches "
                  f"{counts}; sublayer calls {calls}")
            print(f"{tag} {what} grads, batch {i}, |kernel - plain| / "
                  f"|plain|max: {summary(rel)}; vs the {oname} step: kernel path "
                  f"{summary(rel_k32)}; plain path {summary(rel_p32)}; kernel "
                  f"/ plain: median {meds[-1][0] / meds[-1][1]:.4g}, max "
                  f"{maxes[-1][0] / maxes[-1][1]:.4g}")
            check(math.isfinite(loss_k), f"{what}: non-finite loss")
            check_launches(counts, want, what)
            check(calls == want_calls,
                  f"{what} sub-layer calls {calls} != {want_calls}")
            del grads_k, grads_p, grads_32
        d_mean = statistics.mean(d_loss)
        med_ratio = sum(k for k, _ in meds) / sum(p_ for _, p_ in meds)
        max_ratio = sum(k for k, _ in maxes) / sum(p_ for _, p_ in maxes)
        held = "not held" if loss_vs_oracle else f"limit {loss_tol}"
        print(f"{tag} {what} over {len(batches)} batch(es): mean |loss "
              f"kernel - plain| {d_mean:.6g} ({held}; largest "
              f"batch {max(d_loss):.6g}); mean |loss "
              f"- {oname} loss| kernel path {statistics.mean(d_k32):.6g}, "
              f"plain path {statistics.mean(d_p32):.6g}; worst "
              f"grad kernel vs plain {worst_rel:.6g} (limit {grad_tol}); "
              f"grads vs {oname}, kernel / plain path, pooled: median "
              f"{med_ratio:.4g}, max {max_ratio:.4g} (limit {STEP_F32_RATIO} "
              f"each)")
        if loss_vs_oracle:
            ratio = statistics.mean(d_k32) / statistics.mean(d_p32)
            print(f"{tag} {what}: loss vs {oname}, kernel / plain path, "
                  f"pooled: {ratio:.4g} (limit {STEP_F32_RATIO})")
            check(ratio <= STEP_F32_RATIO, f"{what} loss vs {oname}: kernel "
                  f"/ plain {ratio}: {d_k32} / {d_p32}")
        else:
            check(d_mean <= loss_tol, f"{what} loss: {d_loss}")
        if fault is not None:
            f_mean = statistics.mean(d_fault)
            if loss_vs_oracle:
                f_ratio = f_mean / statistics.mean(d_p32)
                print(f"{tag} {what}: {fault.__doc__} lies {f_mean:.6g} from "
                      f"the {oname} loss on average, {f_ratio:.4g} x the "
                      f"plain path's distance (smallest batch "
                      f"{min(d_fault):.6g}; must exceed the limit "
                      f"{STEP_F32_RATIO})")
                check(f_ratio > STEP_F32_RATIO, f"{what}: the loss rule "
                      f"would pass a planted fault: {d_fault}")
            else:
                print(f"{tag} {what}: {fault.__doc__} moves the loss from the "
                      f"plain path's by {f_mean:.6g} on average (smallest "
                      f"batch {min(d_fault):.6g}; must exceed the limit "
                      f"{loss_tol})")
                check(f_mean > loss_tol, f"{what}: the loss limit {loss_tol} "
                      f"would pass a planted fault: {d_fault}")
        check(worst_rel <= grad_tol,
              f"{what} grads vs plain {worst_rel} > {grad_tol}")
        check(med_ratio <= STEP_F32_RATIO and max_ratio <= STEP_F32_RATIO,
              f"{what} grads vs {oname}: kernel / plain {med_ratio} / "
              f"{max_ratio}")
        return first

    per_step = {**zero, "ln_gemm": 2 * n_blocks, "mhsa": n_blocks,
                "gemm_residual": 2 * n_blocks, "gemm_dls": 2 * n_blocks,
                "gemm_wgrad": 4 * n_blocks, "gemm_dgrad": 4 * n_blocks,
                "mhsa_bwd": n_blocks, "ln_pullback": 2 * n_blocks}
    calls_per_step = {**zero_calls,
                      "fused_attention_sublayer_train": n_blocks,
                      "fused_mlp_sublayer_train": n_blocks}
    step_counts = check_step("train step", tmodel, [(src, tgt)], per_step,
                             calls_per_step)

    def fit_losses(m_, src_, tgt_, steps=FIT_STEPS, lr=FIT_LR):
        """`steps` AdamW steps at `lr` on the one batch from m_'s weights,
        which are put back afterwards."""
        start = {n: q.detach().clone() for n, q in m_.named_parameters()}
        step = make_train_step(TrainState(m_, make_optimizer(
            m_.parameters(), lr)))
        losses = [float(v) for v in [step(src_, tgt_)[0]
                                     for _ in range(steps)]]
        with torch.no_grad():
            for n, q in m_.named_parameters():
                q.copy_(start[n])
        return losses

    def check_fit(what, mdl, src_, tgt_):
        """FIT_STEPS AdamW steps on one batch on both paths: the loss must
        fall, and the paths must agree at every step."""
        fit_k = fit_losses(mdl, src_, tgt_)
        with plain_train_sublayers():
            fit_p = fit_losses(mdl, src_, tgt_)
        track = max(abs(a - b) for a, b in zip(fit_k, fit_p))
        print(f"{tag} {what}, {FIT_STEPS} AdamW steps at lr {FIT_LR}: "
              f"kernel path {[round(v, 5) for v in fit_k]}, plain path "
              f"{[round(v, 5) for v in fit_p]}; max |kernel - plain| "
              f"{track:.6g} (limit {FIT_TRACK_TOL}); fall "
              f"{fit_k[0] / fit_k[-1]:.4g}x (must be >= {FIT_DROP}x)")
        check(fit_k[-1] * FIT_DROP <= fit_k[0], f"{what}: loss fell only "
              f"{fit_k}")
        check(track <= FIT_TRACK_TOL,
              f"{what}: kernel path leaves the plain path: {track}")

    check_fit("fit one batch", tmodel, src, tgt)

    # -- 9. the trainer end to end, and the checkpoint it writes, served ---
    stamp(tag, "9")
    tdm.set_epoch(0)
    state, result = cli.train(targs, tmodel, tdm, trainer)
    print_last_saves(tag, "trainer (ViT-S/14)", trainer.state_writer.records)
    hist = [json.loads(line) for line in
            (run_dir / "history.jsonl").read_text().splitlines()]
    best_npz = best_params_path(run_dir)
    print(f"{tag} trainer: {result.epochs_run} epochs, best val/AUC_ROC "
          f"{result.best_metric:.4g} @ epoch {result.best_epoch}, "
          f"{state.step} steps; history {[{k: v for k, v in r.items() if not k.startswith('perf/')} for r in hist]}; "
          f"files {sorted(q.name for q in run_dir.iterdir())}")
    check(result.epochs_run == 2 and len(hist) == 2, "two epochs")
    check(all(math.isfinite(r["train_loss"]) for r in hist), "train loss")
    check(best_npz.exists() and (run_dir / "best_checkpoint.json").exists()
          and best_npz.parent.name == f"epoch={result.best_epoch}",
          f"best checkpoint {best_npz}")
    check(len(list(run_dir.glob("epoch=*/"))) == 1, "top-1 policy")
    served = build_model(parse_args(["--params_npz", str(best_npz)]))
    vbatch = next(iter(tdm.val_dataloader()))
    p_served, _ = make_predict_fn(served, with_saliency=False)(
        vbatch["source"], None)
    with np.load(best_npz) as z:
        params_from_flax(tmodel, {k: z[k] for k in z.files})
    p_eval = torch.softmax(make_eval_step(tmodel)(vbatch["source"]).float(),
                           -1)
    d_ck = (p_served - p_eval).abs().max().item()
    print(f"{tag} trainer: the served best checkpoint's probs vs the eval "
          f"step's on {tuple(vbatch['source'].shape)} val volumes: max |diff| "
          f"{d_ck:.6g} (must be 0: the same weights through the same kernels)")
    check(d_ck == 0.0, f"served checkpoint differs from the eval step: {d_ck}")
    del served

    # -- 10. train times ----------------------------------------------------
    stamp(tag, "10")
    ttimed = {name: (time_ms(kern), time_ms(plain))
              for name, (kern, plain) in tcases.items()
              if not name.startswith(BWD_GEMMS + RES_GEMMS + ATTN)}  # 41-43
    for name, (km, pm_) in ttimed.items():
        print(f"{tag} time {name}: kernel {km:.4f} ms, plain {pm_:.4f} ms")
    lib_ms.update({name: time_ms(fn) for name, fn in library.items()
                   if name not in lib_ms and not name.startswith(ATTN)})
    for name, (kind, sargs) in sub.items():
        fn = (fb.fused_attention_sublayer_train if kind == "attn"
              else fb.fused_mlp_sublayer_train)
        for label, ops in (("kernel", fb.KERNELS), ("plain", fb.PLAIN)):
            ms = time_ms(lambda: fn(x.detach().requires_grad_(True), *sargs,
                                    ops=ops).backward(g3), n=5)
            print(f"{tag} time {name} forward + backward: {label} "
                  f"{ms:.4f} ms")

    def step_seconds(m_, src_, tgt_, n=5):
        step = make_train_step(TrainState(m_, make_optimizer(
            m_.parameters(), 0.0)))  # lr 0: same work, same weights
        return host_seconds(lambda: step(src_, tgt_), n), step

    torch.cuda.reset_peak_memory_stats()
    sec_t, kstep = step_seconds(tmodel, src, tgt)
    peak_t = torch.cuda.max_memory_allocated()
    with plain_train_sublayers():
        sec_tp, _ = step_seconds(tmodel, src, tgt)
    print(f"{tag} train step B={BATCH} {list(src.shape)} bf16 (forward, CE, "
          f"backward, AdamW): kernel path {sec_t * 1e3:.3f} ms = "
          f"{BATCH / sec_t:.3f} vol/s; plain sub-layers {sec_tp * 1e3:.3f} "
          f"ms = {BATCH / sec_tp:.3f} vol/s; peak memory (kernel path) "
          f"{peak_t / 2**20:.1f} MiB")
    profile_device(tag, "one train step", lambda: kstep(src, tgt), 16)

    # -- 11. saliency kernels vs plain at the path's shapes ----------------
    stamp(tag, "11")
    print(f"{tag} saliency kernel tolerance: bf16 outputs <= 2 bf16 ulps, "
          f"f32 outputs (CLS row, carry, Abnar factor) <= {KERNEL_GRAD_REL} "
          f"x |plain|max for one kernel, <= {SUBLAYER_GRAD_REL} x for a "
          f"sub-layer chain (as phase 7); every kernel repeats bit for bit")
    e0 = torch.zeros(N_SLICES, HEADS, S, device=dev)
    e0[:, :, 0] = 1.0  # the rollout chain starts at the CLS token
    c1_plain = fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS, carry=e0)[1]

    xb = rand(N_SLICES, S, E, dtype=bf)  # the second block's input

    def rollout2(fn):
        """Two blocks of the rollout sub-layer, the second fed the first's
        carry (not one-hot) on an input of its own."""
        y1, c1 = fn(*attn_args, ls, e0, HEADS, eps)
        return (y1, c1, *fn(xb, *attn_args[1:], ls, c1, HEADS, eps,
                            want_row=True))

    scases = {
        "mhsa_with_row": (lambda: fb.mhsa_with_row(qkv_in, N_SLICES, S, HEADS),
                          lambda: fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS,
                                               want_row=True)),
        "mhsa_rollout[block0]": (
            lambda: fb.mhsa_rollout(qkv_in, e0, N_SLICES, S, HEADS),
            lambda: fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS, carry=e0)),
        "mhsa_rollout[block1,row]": (
            lambda: fb.mhsa_rollout(qkv_in, c1_plain, N_SLICES, S, HEADS,
                                    want_row=True),
            lambda: fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS, want_row=True,
                                 carry=c1_plain)),
        "mhsa_abnar": (lambda: fb.mhsa_abnar(qkv_in, N_SLICES, S, HEADS),
                       lambda: fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS,
                                            want_abnar=True)),
    }
    cost.update({
        "mhsa_with_row": attn_cost(N_SLICES, S, 4 * N_SLICES * HEADS * S),
        "mhsa_rollout[block1,row]": attn_cost(N_SLICES, S,
                                              3 * 4 * N_SLICES * HEADS * S),
        "mhsa_abnar": attn_cost(N_SLICES, S, 4 * N_SLICES * S * S),
    })
    ssub = {
        "attention_sublayer_with_row[ls]": pair(
            fb.fused_attention_sublayer_with_row, fb._attn_with_row_ref,
            *attn_args, ls, HEADS),
        "attention_sublayer_rollout[ls,2 blocks]": (
            lambda: rollout2(fb.fused_attention_sublayer_rollout),
            lambda: rollout2(fb._attn_rollout_ref)),
        "attention_sublayer_abnar[ls]": pair(
            fb.fused_attention_sublayer_abnar, fb._attn_abnar_ref,
            *attn_args, ls, HEADS),
        "attention_sublayer_abnar[no_ls]": pair(
            fb.fused_attention_sublayer_abnar, fb._attn_abnar_ref,
            *attn_args, None, HEADS),
    }
    with torch.inference_mode():
        for name, (kern, plain) in {**scases, **ssub}.items():
            k, pl = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            rel = KERNEL_GRAD_REL if name in scases else SUBLAYER_GRAD_REL
            errs[name] = check_outputs(tag, f"saliency {name}", k, pl, rel)
            same = all(torch.equal(a, b) for a, b in zip(k, again))
            print(f"{tag} saliency {name}: two runs equal bit for bit: {same}")
            check(same, f"{name}: two runs differ")
        del k, pl, again

    # -- 12. the saliency forward at B=8 (each mode: counts read around it) -
    stamp(tag, "12")
    n_full = n_blocks + 1  # rollout / abnar run block 11 on the kernels too

    def block_counts(nb, attn_kernel, attn_sublayer, swiglu=False):
        """(launches, sub-layer calls) of nb encoder blocks on the serving
        kernels: the attention chain through `attn_kernel`, then the MLP or
        SwiGLU chain."""
        counts, calls = dict(zero), dict(zero_calls)
        counts["ln_gemm"] += nb
        counts["ln_gemm_swiglu" if swiglu else "ln_gemm"] += nb
        counts["gemm_residual"] += 2 * nb
        counts[attn_kernel] += nb
        calls[attn_sublayer] += nb
        calls["fused_swiglu_sublayer" if swiglu else "fused_mlp_sublayer"] += nb
        return counts, calls

    def added(a, b):
        return {k: a[k] + b[k] for k in a}

    def saliency(mode, m=None, dtype=None, mdl=model, vols=src8):
        with torch.inference_mode():
            out = fused_mst_saliency(mdl, vols, m, dtype=dtype,
                                     plane_mode=mode)
        torch.cuda.synchronize()
        return out

    def sal_rel(a, b):
        """max |a - b| relative to b's largest value."""
        return (a - b).abs().max().item() / b.abs().max().item()

    def sal_pooled(a, b):
        """`sal_rel` of each volume's map (the first dim), averaged over the
        batch (phase 32's int8 rule, ROADMAP C5)."""
        a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        return ((a - b).abs().amax(1) / b.abs().amax(1)).mean().item()

    def check_saliency(what, mdl, pred, vols, want_last, want_last_calls,
                       rope=False, depth=n_full, swiglu=False):
        """`fused_mst_saliency` on `vols` (B=8, or fewer where the plain
        path is slow) in each plane mode, with and without the key-padding
        mask, against the plain path and an f32 plain forward, with each
        forward's launch counts; then the row of MST_NO_CHEAP_LAST (the last
        of the `depth` blocks in full) against the CLS-only block's. `rope`:
        the model's attention runs the RoPE kernels; `swiglu`: its FFN the
        SwiGLU chain. Returns the launch counts of each mode and of
        "with_row"."""
        kern = ("mhsa_{}_rope" if rope else "mhsa_{}").format
        row_sublayer = ("fused_attention_sublayer_rope_with_row" if rope
                        else "fused_attention_sublayer_with_row")
        nb = vols.shape[0]
        mask_t = torch.from_numpy(padding_mask(nb)).to(dev)
        found = {}
        for mode in PLANE_MODES:
            if mode == "last":
                want, want_calls = want_last, want_last_calls
            else:
                attn = {"rollout": "rollout", "rollout_abnar": "abnar"}[mode]
                want, want_calls = block_counts(
                    depth, kern(attn), f"fused_attention_sublayer_{attn}",
                    swiglu)
            for label, m in (("no mask", None), ("key-padding mask", mask_t)):
                fb.reset_launch_counts()
                pk, sk = saliency(mode, m, mdl=mdl, vols=vols)
                counts, calls = fb.launch_counts(), fb.sublayer_calls()
                with plain_sublayers():
                    pp, sp_ = saliency(mode, m, mdl=mdl, vols=vols)
                    p32, s32 = saliency(mode, m, torch.float32, mdl=mdl,
                                        vols=vols)
                check(tuple(sk.shape) == (nb, DEPTH_SLICES, PX, PX)
                      and sk.dtype == torch.float32,
                      f"{what} {tuple(sk.shape)}")
                check(bool(torch.isfinite(sk).all()
                           and torch.isfinite(pk).all()),
                      f"{what} {mode}: non-finite output")
                d_p, d_p32 = ((pk - pp).abs().max().item(),
                              (pk - p32).abs().max().item())
                d_s, d_s32 = sal_rel(sk, sp_), sal_rel(sk, s32)
                d_fwd = (pk - pred(vols, m)[0]).abs().max().item()
                print(f"{tag} {what} {mode} [{label}] {list(sk.shape)}: "
                      f"|probs - plain| {d_p:.6g}, |probs - f32| "
                      f"{d_p32:.6g}, |probs - forward without saliency| "
                      f"{d_fwd:.6g}; saliency vs plain {d_s:.6g}, vs f32 "
                      f"{d_s32:.6g} (of the largest value "
                      f"{sp_.abs().max().item():.6g}); plain vs f32 "
                      f"{sal_rel(sp_, s32):.6g}; launches {counts}; sub-layer "
                      f"calls {calls}")
                check(d_p <= PROB_TOL and d_p32 <= F32_TOL,
                      f"{what} {mode} probs: {d_p} / {d_p32}")
                check(d_s <= SAL_REL and d_s32 <= SAL_F32_REL,
                      f"{what} {mode} saliency: {d_s} / {d_s32}")
                if mode == "last":  # the same kernels as the forward without
                    check(d_fwd <= 1e-6, f"last-mode probs moved by {d_fwd}")
                if m is not None:  # padded slices get no slice attention
                    leak = sk[mask_t].abs().max().item()
                    check(leak == 0.0, f"{what} {mode}: padded slices' "
                          f"saliency {leak}")
                check_launches(counts, want, f"{what} {mode}")
                check(calls == want_calls,
                      f"{what} {mode} calls {calls} != {want_calls}")
                found[mode] = counts
        # MST_NO_CHEAP_LAST: block 11 in full, its row from the row kernel
        os.environ["MST_NO_CHEAP_LAST"] = "1"
        try:
            fb.reset_launch_counts()
            p_full, s_full = saliency("last", mdl=mdl, vols=vols)
            counts, calls = fb.launch_counts(), fb.sublayer_calls()
        finally:
            del os.environ["MST_NO_CHEAP_LAST"]
        p_cheap, s_cheap = saliency("last", mdl=mdl, vols=vols)
        d_p, d_s = ((p_full - p_cheap).abs().max().item(),
                    sal_rel(s_full, s_cheap))
        one_more, one_more_calls = block_counts(1, kern("with_row"),
                                                row_sublayer, swiglu)
        want = added(want_last, one_more)
        want_calls = added(want_last_calls, one_more_calls)
        print(f"{tag} {what} last, MST_NO_CHEAP_LAST=1 vs the CLS-only last "
              f"block: |probs| {d_p:.6g}, saliency {d_s:.6g} (limit "
              f"{SAL_CHEAP_REL}); launches {counts}; sub-layer calls {calls}")
        check(d_p <= PROB_TOL and d_s <= SAL_CHEAP_REL,
              f"{what} MST_NO_CHEAP_LAST: probs {d_p}, saliency {d_s}")
        check_launches(counts, want, f"{what} MST_NO_CHEAP_LAST")
        check(calls == want_calls, f"calls {calls} != {want_calls}")
        found["with_row"] = counts
        return found

    print(f"{tag} saliency tolerance: probs as phase 4; a saliency map within "
          f"{SAL_REL} of the plain path's largest value, {SAL_F32_REL} of the "
          f"f32 plain path's (bf16 rounding through 12 blocks of a "
          f"random-weight ViT-S moves a CLS attention row by a few percent)")
    sal_counts = check_saliency("saliency", model, predict, src8, per_fwd,
                                calls_per_fwd)

    # -- 13. the predict CLI on phase 9's run folder ------------------------
    stamp(tag, "13")
    def check_predict_cli(what, run, out, n_cases, want):
        """`python -m mst_tpu_torch.predict --use_tta --use_rollout
        --save_saliency` on the run folder `run` and n_cases LIDC-shaped
        Synthetic test volumes: results.csv and the NIfTI maps against the
        predictor on the same batches, predict.log, the launch counts."""
        shutil.rmtree(out, ignore_errors=True)
        data_kw = dict(shape_cdhw=(1, DEPTH_SLICES, PX, PX),
                       num_samples=n_cases)
        pargv = ["--run_folder", str(run), "--output_dir", str(out),
                 "--use_tta", "--use_rollout", "--save_saliency"]
        fb.reset_launch_counts()
        t1 = time.perf_counter()
        predict_cli.main(pargv, **data_kw)
        torch.cuda.synchronize()
        cli_sec = time.perf_counter() - t1
        cli_counts = fb.launch_counts()
        with (out / "results.csv").open() as f:
            rows = list(csv.DictReader(f))
        pargs = predict_cli.parse_args(pargv)
        pfn = make_predict_fn(predict_cli.build_model(pargs, dev), tta=True,
                              plane_mode="rollout")
        worst_p = worst_s = 0.0
        batches = predict_cli.build_datamodule(pargs, dev, **data_kw)
        for r, b in zip(rows, batches.test_dataloader()):
            pb, sb = pfn(b["source"], None)
            check(r["uid"] == b["uid"][0]
                  and int(r["GT"]) == int(b["target"][0]),
                  f"row {r} is not case {b['uid'][0]}")
            check(int(r["NN"]) == int(pb[0].argmax()), f"NN of {r['uid']}")
            worst_p = max(worst_p, abs(float(r["NN_pred"]) - pb[0, 1].item()))
            got = read_nifti_f32(out / f"case_{r['uid']}" / "saliency.nii.gz")
            want_s = sb[0].cpu().numpy().transpose(2, 1, 0)
            check(got.shape == want_s.shape, f"NIfTI {got.shape}")
            worst_s = max(worst_s, float(np.abs(got - want_s).max()
                                         / np.abs(want_s).max()))
        log_text = (out / "predict.log").read_text()
        t1 = time.perf_counter()
        write_nifti(out / "timing.nii.gz", got)
        sec_nii = time.perf_counter() - t1
        t1 = time.perf_counter()
        write_nifti(out / "timing.nii.gz", b["source"][0, 0].cpu().numpy())
        sec_nii_in = time.perf_counter() - t1
        print(f"{tag} {what} --use_tta --use_rollout --save_saliency on "
              f"{n_cases} cases {list(data_kw['shape_cdhw'])}: {cli_sec:.3f} "
              f"s (one saliency.nii.gz write {sec_nii:.3f} s, one "
              f"input.nii.gz write {sec_nii_in:.3f} s); launches "
              f"{cli_counts}; results.csv vs the predictor: |NN_pred| "
              f"{worst_p:.6g}, saliency.nii.gz {worst_s:.6g} (both must be "
              f"<= 1e-6: the same kernels on the same batches); predict.log: "
              f"{log_text.strip().splitlines()}")
        check(len(rows) == n_cases, f"{len(rows)} result rows")
        check(worst_p <= 1e-6 and worst_s <= 1e-6,
              f"{what} vs predictor: {worst_p} / {worst_s}")
        check("AUC=" in log_text and "Youden point" in log_text, "predict.log")
        check_launches(cli_counts, want, what)

    check_predict_cli(
        "predict CLI", run_dir, ROOT / "build" / "chip_smoke_predict",
        N_CASES_SAL,
        {**zero, "ln_gemm": 2 * n_full * N_CASES_SAL,
         "mhsa_rollout": n_full * N_CASES_SAL,
         "gemm_residual": 2 * n_full * N_CASES_SAL})

    # -- 14. saliency times ---------------------------------------------------
    stamp(tag, "14")
    # the plain-flags sub-layer again, beside them in time (phase 43 times
    # the saliency forms of `mhsa` themselves)
    reference = {"attention_sublayer[ls,plain flags]":
                 cases["attention_sublayer[ls]"]}
    with torch.inference_mode():
        stimed = {name: (time_ms(kern), time_ms(plain)) for name, (kern, plain)
                  in {**reference, **ssub}.items()}
    for name, (km, pm_) in stimed.items():
        print(f"{tag} time {name}: kernel {km:.4f} ms, plain {pm_:.4f} ms")
    def seconds_and_memory(fn, n=5):
        """(median seconds of n calls of fn, its peak device memory above
        what was held before it)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        sec_ = host_seconds(fn, n)
        return sec_, torch.cuda.max_memory_allocated() - held

    sec_fwd, mem_fwd = seconds_and_memory(lambda: predict(src8, None))
    print(f"{tag} e2e B={BATCH} {list(vol.shape)} bf16 without saliency: "
          f"{sec_fwd * 1e3:.3f} ms = {BATCH / sec_fwd:.3f} vol/s, peak "
          f"memory {mem_fwd / 2**20:.1f} MiB above the "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held")
    vol1 = src8[:1]
    for mode in PLANE_MODES:
        sec_m, mem_m = seconds_and_memory(lambda: saliency(mode))
        tta = make_predict_fn(model, tta=True, plane_mode=mode)
        sec_1 = host_seconds(lambda: tta(vol1, None))
        print(f"{tag} e2e saliency {mode} B={BATCH}: {sec_m * 1e3:.3f} ms = "
              f"{BATCH / sec_m:.3f} vol/s ({sec_m / sec_fwd:.3f}x the forward "
              f"without saliency), peak memory {mem_m / 2**20:.1f} MiB above "
              f"what was held; batch-1 8-flip TTA with saliency: "
              f"{sec_1 * 1e3:.3f} ms per volume")
        profile_device(tag, f"one B={BATCH} saliency forward ({mode})",
                       lambda: saliency(mode), 8)


    # ======================================================================
    # MST-DINOv3 ViT-S/16: 4 registers, normalised 2D RoPE (theta 100), no
    # learned pos-embed, LN eps 1e-5; S = 1 + 4 + 14 x 14 = 201 at 224 px.
    # ======================================================================
    # -- 15. the RoPE kernels and sub-layers vs plain at [256, 201, 384] ---
    stamp(tag, "15")
    cos3, sin3 = rope_tables(GRID3, 64, PREFIX3, 100.0, True, dev)
    rope3 = dict(rope_cos=cos3, rope_sin=sin3)
    M3 = N_SLICES * S3
    x3 = rand(N_SLICES, S3, E, dtype=bf)
    x3b = rand(N_SLICES, S3, E, dtype=bf)  # the second rollout block's input
    g3 = rand(M3, E, dtype=bf)  # upstream gradient
    qkv3 = fb._ln_gemm_ref(x3.reshape(M3, E), ln_s, ln_b, wqkv, bqkv,
                           fb.ACT_NONE, EPS3)
    o3, lse3 = fb._mhsa_ref(qkv3, N_SLICES, S3, HEADS, want_lse=True, **rope3)
    do3 = fb._gemm_dgrad_ref(g3, wproj)
    e03 = torch.zeros(N_SLICES, HEADS, S3, device=dev)
    e03[:, :, 0] = 1.0
    c13 = fb._mhsa_ref(qkv3, N_SLICES, S3, HEADS, carry=e03, **rope3)[1]
    print(f"{tag} DINOv3 RoPE tables: cos, sin {list(cos3.shape)} f32 "
          f"(grid {GRID3}, {PREFIX3} prefix rows at angle 0, normalised, "
          f"theta 100); tolerances as phases 3, 7 and 11, every output "
          f"repeated bit for bit")
    rcases = {
        "mhsa_rope": (
            lambda: fb.mhsa(qkv3, N_SLICES, S3, HEADS, **rope3),
            lambda: fb._mhsa_ref(qkv3, N_SLICES, S3, HEADS, **rope3)),
        "mhsa_rope_train": (
            lambda: fb.mhsa(qkv3, N_SLICES, S3, HEADS, True, **rope3),
            lambda: fb._mhsa_ref(qkv3, N_SLICES, S3, HEADS, True, **rope3)),
        "mhsa_with_row_rope": (
            lambda: fb.mhsa_with_row(qkv3, N_SLICES, S3, HEADS, **rope3),
            lambda: fb._mhsa_ref(qkv3, N_SLICES, S3, HEADS, want_row=True,
                                 **rope3)),
        "mhsa_rollout_rope[block0]": (
            lambda: fb.mhsa_rollout(qkv3, e03, N_SLICES, S3, HEADS, **rope3),
            lambda: fb._mhsa_ref(qkv3, N_SLICES, S3, HEADS, carry=e03,
                                 **rope3)),
        "mhsa_rollout_rope[block1,row]": (
            lambda: fb.mhsa_rollout(qkv3, c13, N_SLICES, S3, HEADS,
                                    want_row=True, **rope3),
            lambda: fb._mhsa_ref(qkv3, N_SLICES, S3, HEADS, want_row=True,
                                 carry=c13, **rope3)),
        "mhsa_abnar_rope": (
            lambda: fb.mhsa_abnar(qkv3, N_SLICES, S3, HEADS, **rope3),
            lambda: fb._mhsa_ref(qkv3, N_SLICES, S3, HEADS, want_abnar=True,
                                 **rope3)),
        "mhsa_bwd_rope": pair(fb.mhsa_bwd, fb._mhsa_bwd_ref, qkv3, o3, do3,
                              lse3, N_SLICES, S3, HEADS, cos3, sin3),
    }
    table_bytes = 2 * 4 * S3 * 64
    cost.update({
        "mhsa_rope": attn_cost(N_SLICES, S3, table_bytes),
        "mhsa_with_row_rope": attn_cost(N_SLICES, S3, table_bytes
                                        + 4 * N_SLICES * HEADS * S3),
        "mhsa_rollout_rope[block1,row]": attn_cost(
            N_SLICES, S3, table_bytes + 3 * 4 * N_SLICES * HEADS * S3),
        "mhsa_abnar_rope": attn_cost(N_SLICES, S3, table_bytes
                                     + 4 * N_SLICES * S3 * S3),
        "mhsa_bwd_rope": attn_cost(N_SLICES, S3, table_bytes, bwd=True),
    })
    q3, k3, v3 = heads_of(qkv3, N_SLICES, S3)

    def rope_sdpa():
        """The RoPE in torch ops, then SDPA: the library yardstick."""
        return F.scaled_dot_product_attention(
            apply_rope_tables(q3, cos3, sin3),
            apply_rope_tables(k3, cos3, sin3), v3)

    library.update({"mhsa_rope": rope_sdpa,
                    "mhsa_bwd_rope": sdpa_backward(qkv3, do3, N_SLICES, S3,
                                                   (cos3, sin3))})
    attn3_args = (x3, ln_s, ln_b, wqkv, bqkv, wproj, bproj)

    def rollout2_rope(fn):
        """Two RoPE rollout blocks, the second fed the first's carry."""
        y1, c1 = fn(*attn3_args, ls, e03, HEADS, EPS3, **rope3)
        return (y1, c1, *fn(x3b, *attn3_args[1:], ls, c1, HEADS, EPS3,
                            want_row=True, **rope3))

    rsub = {
        "attention_sublayer_rope[ls]": pair(
            fb.fused_attention_sublayer_rope, fb._attn_rope_ref, *attn3_args,
            ls, cos3, sin3, HEADS, EPS3),
        "attention_sublayer_rope[no_ls]": pair(
            fb.fused_attention_sublayer_rope, fb._attn_rope_ref, *attn3_args,
            None, cos3, sin3, HEADS, EPS3),
        "attention_sublayer_rope_with_row[ls]": pair(
            fb.fused_attention_sublayer_rope_with_row,
            fb._attn_rope_with_row_ref, *attn3_args, ls, cos3, sin3, HEADS,
            EPS3),
        "attention_sublayer_rollout_rope[ls,2 blocks]": (
            lambda: rollout2_rope(fb.fused_attention_sublayer_rollout),
            lambda: rollout2_rope(fb._attn_rollout_ref)),
        "attention_sublayer_abnar_rope[ls]": pair(
            fb.fused_attention_sublayer_abnar, fb._attn_abnar_ref,
            *attn3_args, ls, HEADS, EPS3, cos3, sin3),
        "mlp_sublayer[S=201,eps=1e-5,tanh,ls]": pair(
            fb.fused_mlp_sublayer, fb._mlp_ref, x3, ln_s, ln_b, w1, b1, w2,
            b2, ls, True, EPS3),
    }
    def chain(*costs):
        """(FLOPs, bytes) of a chain of kernel calls."""
        return tuple(map(sum, zip(*costs)))

    cost.update({
        "attention_sublayer_rope[ls]": chain(
            mm_cost(M3, E, 3 * E, 4 * 5 * E),
            attn_cost(N_SLICES, S3, table_bytes),
            mm_cost(M3, E, E, 2 * M3 * E + 4 * 2 * E)),
        "mlp_sublayer[S=201,eps=1e-5,tanh,ls]": chain(
            mm_cost(M3, E, 4 * E, 4 * 6 * E),
            mm_cost(M3, 4 * E, E, 2 * M3 * E + 4 * 2 * E)),
    })
    # The other kernels of the RoPE chains (queue B rows 1, 1'a-c, 4, 7 with
    # RoPE) at S = 201, so that each chain's time, bound and library time
    # cover the same work.
    x32 = x3.reshape(M3, E)
    h3 = fb._ln(x32, ln_s, ln_b, EPS3).to(bf)
    dqkv3 = fb._mhsa_bwd_ref(qkv3, o3, do3, lse3, N_SLICES, S3, HEADS, cos3,
                             sin3)
    rchain = {
        "ln_gemm[qkv,S=201]": pair(fb.ln_gemm, fb._ln_gemm_ref, x32, ln_s,
                                   ln_b, wqkv, bqkv, fb.ACT_NONE, EPS3),
        "ln_gemm_train[qkv,S=201]": pair(fb.ln_gemm, fb._ln_gemm_ref, x32,
                                         ln_s, ln_b, wqkv, bqkv, fb.ACT_NONE,
                                         EPS3, True),
        "gemm_residual[proj,ls,S=201]": pair(
            fb.gemm_residual, fb._gemm_residual_ref, o3, wproj, bproj, ls,
            x32),
        "gemm_dls[proj,S=201]": pair(fb.gemm_dls, fb._gemm_dls_ref, o3, wproj,
                                     bproj, ls, g3),
        "gemm_wgrad[proj,S=201]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, o3,
                                       g3),
        "gemm_dgrad[proj,S=201]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref, g3,
                                       wproj),
        "gemm_wgrad[qkv,S=201]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, h3,
                                      dqkv3),
        "gemm_dgrad[qkv,ln,S=201]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref,
                                         dqkv3, wqkv, None, fb.ACT_NONE,
                                         (x32, g3, ln_s, EPS3)),
    }
    cost.update({
        "ln_gemm[qkv,S=201]": mm_cost(M3, E, 3 * E, 4 * 5 * E),
        "ln_gemm_train[qkv,S=201]": mm_cost(M3, E, 3 * E,
                                            4 * 5 * E + 2 * M3 * E),
        "mhsa_rope_train": attn_cost(N_SLICES, S3, table_bytes
                                     + 4 * M3 * HEADS),
        "gemm_residual[proj,ls,S=201]": mm_cost(M3, E, E,
                                                2 * M3 * E + 4 * 2 * E),
        "gemm_dls[proj,S=201]": mm_cost(M3, E, E, 2 * M3 * E + 4 * 3 * E),
        "gemm_wgrad[proj,S=201]": wgrad_cost(M3, E, E),
        "gemm_dgrad[proj,S=201]": mm_cost(M3, E, E),
        "gemm_wgrad[qkv,S=201]": wgrad_cost(M3, E, 3 * E),
        "gemm_dgrad[qkv,ln,S=201]": mm_cost(M3, 3 * E, E,
                                            4 * M3 * E + 4 * 3 * E),
    })
    ln_w3, ln_b3 = ln_s.to(bf), ln_b.to(bf)
    library.update({
        "ln_gemm[qkv,S=201]": lambda: torch.addmm(
            bqkv.to(bf), F.layer_norm(x32, (E,), ln_w3, ln_b3, EPS3), wqkv),
        "mhsa_rope_train": rope_sdpa,
    })
    library["ln_gemm_train[qkv,S=201]"] = library["ln_gemm[qkv,S=201]"]
    library["mlp_sublayer[S=201,eps=1e-5,tanh,ls]"] = lambda: torch.addmm(
        b2.to(bf), F.gelu(torch.addmm(b1.to(bf), F.layer_norm(
            x32, (E,), ln_w3, ln_b3, EPS3), w1), approximate="tanh"), w2)
    with torch.inference_mode():
        for name, (kern, plain) in {**rcases, **rsub, **rchain}.items():
            k, pl = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            rel = SUBLAYER_GRAD_REL if name in rsub else KERNEL_GRAD_REL
            errs[name] = check_outputs(tag, f"rope {name}", k, pl, rel)
            k, again = ((k, again) if isinstance(k, tuple)
                        else ((k,), (again,)))
            same = all(torch.equal(a, b) for a, b in zip(k, again)
                       if a is not None)
            print(f"{tag} rope {name}: two runs equal bit for bit: {same}")
            check(same, f"{name}: two runs differ")
        del k, pl, again
    g33 = g3.reshape(N_SLICES, S3, E)
    rtrain = {
        f"attention_sublayer_train_rope[{label}]": (
            ln_s, ln_b, wqkv.float(), bqkv, wproj.float(), bproj, lsv, cos3,
            sin3, HEADS, EPS3)
        for label, lsv in (("ls", ls), ("no_ls", None))}
    for name, sargs in rtrain.items():
        k = train_sublayer_outputs(fb, "attn_rope", fb.KERNELS, x3, sargs, g33)
        again = train_sublayer_outputs(fb, "attn_rope", fb.KERNELS, x3, sargs,
                                       g33)
        pl = train_sublayer_outputs(fb, "attn_rope", fb.PLAIN, x3, sargs, g33)
        torch.cuda.synchronize()
        errs[name] = check_outputs(tag, f"rope sublayer {name}", k, pl,
                                   SUBLAYER_GRAD_REL)
        same = all(torch.equal(a, b) for a, b in zip(k, again)
                   if a is not None)
        print(f"{tag} rope sublayer {name}: two runs equal bit for bit: "
              f"{same}")
        check(same, f"{name}: two runs differ")
    del k, pl, again

    # -- 16. the DINOv3 forward at B=8 ------------------------------------
    stamp(tag, "16")
    flat3 = random_flax_params(get_model(MODEL3), SEED)
    for key in flat3:
        if key.endswith("/gamma"):
            flat3[key] = (1.0 + 0.1 * rng.standard_normal(flat3[key].shape)
                          ).astype(np.float32)
    model3 = params_from_flax(get_model(MODEL3, dtype=bf), flat3).to(
        dev).eval()
    check(model3.num_register_tokens == 4 and model3.patch_size == 16
          and not hasattr(model3.encoder, "pos_embed"),
          f"DINOv3 config {model3.config}")
    predict3 = make_predict_fn(model3, with_saliency=False)
    vol3 = spread_volumes(rng, predict3, BATCH)
    src3 = torch.from_numpy(vol3).to(dev)
    per_fwd3 = {**zero, "ln_gemm": 2 * n_blocks, "mhsa_rope": n_blocks,
                "gemm_residual": 2 * n_blocks}
    calls_per_fwd3 = {**zero_calls, "fused_attention_sublayer_rope": n_blocks,
                      "fused_mlp_sublayer": n_blocks}
    fwd3_counts = check_forward("DINOv3 forward", model3, predict3, vol3,
                                per_fwd3, calls_per_fwd3)

    # -- 17. DINOv3 saliency ----------------------------------------------
    stamp(tag, "17")
    sal3_counts = check_saliency("DINOv3 saliency", model3, predict3, src3,
                                 per_fwd3, calls_per_fwd3, rope=True)

    # -- 18. the DINOv3 train step at B=8 ---------------------------------
    stamp(tag, "18")
    targs3 = cli.parse_args(["--dataset", "Synthetic", "--model", MODEL3,
                             "--batch_size", str(BATCH), "--max_epochs", "1",
                             "--num_train_samples", str(BATCH), "--seed",
                             str(SEED)])
    tmodel3 = cli.build_model(targs3)
    check(tmodel3.dtype == torch.bfloat16
          and tmodel3.num_register_tokens == 4, f"train {tmodel3.config}")
    tdm3 = cli.build_datamodule(targs3, dev, num_samples=STEP_BATCHES * BATCH,
                                shape_cdhw=(1, DEPTH_SLICES, PX, PX))
    run3 = ROOT / "build" / "chip_smoke_run_dinov3"  # gitignored
    shutil.rmtree(run3, ignore_errors=True)
    trainer3 = cli.build_trainer(targs3, tdm3, run_dir=run3)
    trainer3.init_state(tmodel3, seed=SEED)
    with torch.no_grad():
        for name, prm in tmodel3.named_parameters():
            if name.endswith(".gamma"):
                prm.copy_(torch.from_numpy(1.0 + 0.1 * rng.standard_normal(
                    tuple(prm.shape))).to(prm))
    batch3 = next(iter(tdm3.train_dataloader()))
    tsrc3 = batch3["source"]
    ttgt3 = torch.from_numpy(batch3["target"]).to(dev, torch.long)
    # the train batch, then validation batches of the same shape
    step_batches = [(tsrc3, ttgt3)] + [
        (b["source"], torch.from_numpy(b["target"]).to(dev, torch.long))
        for b in itertools.islice(tdm3.val_dataloader(), STEP_BATCHES - 1)]
    check(len(step_batches) == STEP_BATCHES, f"{len(step_batches)} batches")
    per_step3 = {**zero, "ln_gemm": 2 * n_blocks, "mhsa_rope": n_blocks,
                 "gemm_residual": 2 * n_blocks, "gemm_dls": 2 * n_blocks,
                 "gemm_wgrad": 4 * n_blocks, "gemm_dgrad": 4 * n_blocks,
                 "mhsa_bwd_rope": n_blocks, "ln_pullback": 2 * n_blocks}
    calls_per_step3 = {**zero_calls,
                       "fused_attention_sublayer_train_rope": n_blocks,
                       "fused_mlp_sublayer_train": n_blocks}
    step3_counts = check_step("DINOv3 train step", tmodel3, step_batches,
                              per_step3, calls_per_step3)
    check_fit("DINOv3 fit one batch", tmodel3, tsrc3, ttgt3)

    # -- 19. the DINOv3 CLIs: train -> run folder -> serve, predict --------
    stamp(tag, "19")
    tdm3.set_epoch(0)
    _, result3 = cli.train(targs3, tmodel3, tdm3, trainer3)
    hp3 = json.loads((run3 / f"epoch={result3.best_epoch}.hparams.json"
                      ).read_text())
    print(f"{tag} DINOv3 trainer: {result3.epochs_run} epoch(s), files "
          f"{sorted(q.name for q in run3.iterdir())}; hparams {hp3}")
    check(hp3["model"] == MODEL3 and hp3["num_register_tokens"] == 4
          and hp3["use_rope_2d"] and not hp3["use_pos_embed"],
          f"DINOv3 hparams {hp3}")
    served3 = build_model(parse_args(["--run_folder", str(run3)]))
    check(served3.config == tmodel3.config, f"served {served3.config}")
    vbatch3 = next(iter(tdm3.val_dataloader()))
    p_served, _ = make_predict_fn(served3, with_saliency=False)(
        vbatch3["source"], None)
    with np.load(best_params_path(run3)) as z:
        params_from_flax(tmodel3, {k: z[k] for k in z.files})
    p_eval = torch.softmax(make_eval_step(tmodel3)(vbatch3["source"]).float(),
                           -1)
    d_ck = (p_served - p_eval).abs().max().item()
    print(f"{tag} DINOv3: `serve --run_folder` probs vs the eval step's on "
          f"{tuple(vbatch3['source'].shape)}: max |diff| {d_ck:.6g} (must "
          f"be 0)")
    check(d_ck == 0.0, f"served DINOv3 run differs from the eval step: {d_ck}")
    del served3
    check_predict_cli(
        "DINOv3 predict CLI", run3, ROOT / "build" /
        "chip_smoke_predict_dinov3", N_CASES3,
        {**zero, "ln_gemm": 2 * n_full * N_CASES3,
         "mhsa_rollout_rope": n_full * N_CASES3,
         "gemm_residual": 2 * n_full * N_CASES3})

    # -- 20. DINOv3 times ---------------------------------------------------
    stamp(tag, "20")
    with torch.inference_mode():
        rtimed = {name: (time_ms(kern), time_ms(plain)) for name, (kern, plain)
                  in {**rcases, **rsub, **rchain}.items()
                  if not name.startswith(BWD_GEMMS + RES_GEMMS + ATTN)}
    lib_ms.update({name: time_ms(fn) for name, fn in library.items()
                   if name not in lib_ms and not name.startswith(ATTN)})
    for name, (km, pm_) in rtimed.items():
        extra = (f", library {lib_ms[name]:.4f} ms" if name in lib_ms
                 else "")
        print(f"{tag} time {name}: kernel {km:.4f} ms, plain {pm_:.4f} ms"
              f"{extra}")
    for name, sargs in rtrain.items():
        for label, ops in (("kernel", fb.KERNELS), ("plain", fb.PLAIN)):
            ms = time_ms(lambda: fb.fused_attention_sublayer_train_rope(
                x3.detach().requires_grad_(True), *sargs, ops=ops).backward(
                    g33), n=5)
            print(f"{tag} time {name} forward + backward: {label} "
                  f"{ms:.4f} ms")
    sec3, mem3 = seconds_and_memory(lambda: predict3(src3, None))
    print(f"{tag} e2e DINOv3 B={BATCH} {list(vol3.shape)} bf16: "
          f"{sec3 * 1e3:.3f} ms = {BATCH / sec3:.3f} vol/s, peak memory "
          f"{mem3 / 2**20:.1f} MiB above the "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held")
    profile_device(tag, f"one DINOv3 B={BATCH} forward",
                   lambda: predict3(src3, None), 8)
    for mode in PLANE_MODES:
        sec_m, mem_m = seconds_and_memory(
            lambda: saliency(mode, mdl=model3, vols=src3))
        print(f"{tag} e2e DINOv3 saliency {mode} B={BATCH}: "
              f"{sec_m * 1e3:.3f} ms = {BATCH / sec_m:.3f} vol/s "
              f"({sec_m / sec3:.3f}x the forward without saliency), peak "
              f"memory {mem_m / 2**20:.1f} MiB above what was held")
    del model3, predict3
    torch.cuda.reset_peak_memory_stats()
    held3 = torch.cuda.memory_allocated()
    sec_t3, kstep3 = step_seconds(tmodel3, tsrc3, ttgt3)
    peak_t3 = torch.cuda.max_memory_allocated() - held3
    with plain_train_sublayers():
        sec_tp3, _ = step_seconds(tmodel3, tsrc3, ttgt3)
    print(f"{tag} DINOv3 train step B={BATCH} bf16 (forward, CE, backward, "
          f"AdamW): kernel path {sec_t3 * 1e3:.3f} ms = {BATCH / sec_t3:.3f} "
          f"vol/s; plain sub-layers {sec_tp3 * 1e3:.3f} ms = "
          f"{BATCH / sec_tp3:.3f} vol/s; peak memory (kernel path) "
          f"{peak_t3 / 2**20:.1f} MiB above the {held3 / 2**20:.1f} MiB held")
    profile_device(tag, "one DINOv3 train step", lambda: kstep3(tsrc3, ttgt3),
                   16)
    del tmodel3, kstep3

    # ======================================================================
    # MST-DINOv2-giant2: E 1536, 40 blocks, 24 heads of 64, SwiGLU FFN
    # (F = 4096), patch 14, S = 257; the encoder trains frozen.
    # ======================================================================
    # -- 21. the SwiGLU kernel and the E = 1536 chains vs plain -----------
    stamp(tag, "21")
    EG, HG, FG, DEPTH_G = 1536, 24, 4096, 40
    MG = N_SLICES * S  # the B=8 path shape [256, 257, 1536]
    xg = rand(N_SLICES, S, EG, dtype=bf)
    xg2 = xg.reshape(MG, EG)
    lng_s, lng_b = rand(EG, scale=0.1, off=1.0), rand(EG, scale=0.1)
    w12, b12 = (rand(EG, 2 * FG, scale=EG ** -0.5, dtype=bf),
                rand(2 * FG, scale=0.1))
    w3, b3 = rand(FG, EG, scale=FG ** -0.5, dtype=bf), rand(EG, scale=0.1)
    wqkvg, bqkvg = (rand(EG, 3 * EG, scale=EG ** -0.5, dtype=bf),
                    rand(3 * EG, scale=0.1))
    wpg, bpg = rand(EG, EG, scale=EG ** -0.5, dtype=bf), rand(EG, scale=0.1)
    lsg = rand(EG, scale=0.1, off=1.0)  # O(1) LayerScale
    # each kernel's input from the plain version of the kernel before it
    g_in = fb._ln_gemm_swiglu_ref(xg2, lng_s, lng_b, w12, b12, eps)
    qkvg = fb._ln_gemm_ref(xg2, lng_s, lng_b, wqkvg, bqkvg, fb.ACT_NONE, eps)
    og = fb._mhsa_ref(qkvg, N_SLICES, S, HG)
    gcases = {
        "ln_gemm_swiglu[w12]": pair(fb.ln_gemm_swiglu, fb._ln_gemm_swiglu_ref,
                                    xg2, lng_s, lng_b, w12, b12, eps),
        "gemm_residual[w3,ls]": pair(fb.gemm_residual, fb._gemm_residual_ref,
                                     g_in, w3, b3, lsg, xg2),
        "swiglu_sublayer[ls]": pair(fb.fused_swiglu_sublayer, fb._swiglu_ref,
                                    xg, lng_s, lng_b, w12, b12, w3, b3, lsg),
        "ln_gemm[qkv,E=1536]": pair(fb.ln_gemm, fb._ln_gemm_ref, xg2, lng_s,
                                    lng_b, wqkvg, bqkvg, fb.ACT_NONE, eps),
        "mhsa[E=1536]": pair(fb.mhsa, fb._mhsa_ref, qkvg, N_SLICES, S, HG),
        "gemm_residual[proj,E=1536,ls]": pair(
            fb.gemm_residual, fb._gemm_residual_ref, og, wpg, bpg, lsg, xg2),
        "attention_sublayer[E=1536,ls]": pair(
            fb.fused_attention_sublayer, fb._attn_ref, xg, lng_s, lng_b,
            wqkvg, bqkvg, wpg, bpg, lsg, HG),
        "swiglu_sublayer[no_ls]": pair(fb.fused_swiglu_sublayer,
                                       fb._swiglu_ref, xg, lng_s, lng_b, w12,
                                       b12, w3, b3, None),
    }
    print(f"{tag} giant2 kernels at the B=8 path shape [{N_SLICES}, {S}, "
          f"{EG}] bf16 (F = {FG}, {HG} heads, LN eps {eps}, O(1) "
          f"LayerScale): bf16 outputs within 2 bf16 ulps of the plain "
          f"version, every output repeated bit for bit")
    with torch.inference_mode():
        for name, (kern, plain) in gcases.items():
            k, pl = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            errs[name] = check_outputs(tag, f"giant2 {name}", k, pl,
                                       SUBLAYER_GRAD_REL)
            same = torch.equal(k, again)
            print(f"{tag} giant2 {name}: two runs equal bit for bit: {same}")
            check(same, f"{name}: two runs differ")
        del k, pl, again
    gtimes = {n: c for n, c in gcases.items() if n != "swiglu_sublayer[no_ls]"}
    swiglu_cost = (2 * MG * EG * 2 * FG,  # g [M, F] out, not h12 [M, 2F]
                   2 * (MG * EG + EG * 2 * FG + MG * FG) + 4 * 2 * (EG + FG))
    cost.update({
        "ln_gemm_swiglu[w12]": swiglu_cost,
        "gemm_residual[w3,ls]": mm_cost(MG, FG, EG, 2 * MG * EG + 4 * 2 * EG),
        "ln_gemm[qkv,E=1536]": mm_cost(MG, EG, 3 * EG, 4 * 5 * EG),
        "mhsa[E=1536]": attn_cost(N_SLICES, S, heads=HG),
        "gemm_residual[proj,E=1536,ls]": mm_cost(MG, EG, EG,
                                                 2 * MG * EG + 4 * 2 * EG),
    })
    cost["swiglu_sublayer[ls]"] = chain(cost["ln_gemm_swiglu[w12]"],
                                        cost["gemm_residual[w3,ls]"])
    cost["attention_sublayer[E=1536,ls]"] = chain(
        cost["ln_gemm[qkv,E=1536]"], cost["mhsa[E=1536]"],
        cost["gemm_residual[proj,E=1536,ls]"])
    lng_w, lng_bias = lng_s.to(bf), lng_b.to(bf)

    def swiglu_library():
        """F.layer_norm -> torch.addmm -> F.silu(h1) * h2."""
        h1, h2 = torch.addmm(b12.to(bf), F.layer_norm(
            xg2, (EG,), lng_w, lng_bias, eps), w12).chunk(2, dim=-1)
        return F.silu(h1) * h2

    def qkv_library():
        return torch.addmm(bqkvg.to(bf), F.layer_norm(
            xg2, (EG,), lng_w, lng_bias, eps), wqkvg)

    def attention_library():
        """LN + qkv -> SDPA -> proj: the chain's library calls."""
        q, k, v = qkv_library().reshape(N_SLICES, S, 3, HG, 64).permute(
            2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return torch.addmm(bpg.to(bf), o.permute(0, 2, 1, 3).reshape(MG, EG),
                           wpg)

    library.update({
        "ln_gemm_swiglu[w12]": swiglu_library,
        "swiglu_sublayer[ls]": lambda: torch.addmm(b3.to(bf),
                                                   swiglu_library(), w3),
        "ln_gemm[qkv,E=1536]": qkv_library,
        "mhsa[E=1536]": functools.partial(F.scaled_dot_product_attention,
                                          *heads_of(qkvg, N_SLICES, S, HG)),
        "attention_sublayer[E=1536,ls]": attention_library,
    })

    # -- 22. the giant2 forward ------------------------------------------
    stamp(tag, "22")
    # One model for phases 22-24, built by `python -m mst_tpu_torch.train
    # --model_size giant2 --freeze`'s build functions (a frozen encoder
    # serves as any other), holding one seeded draw of its 1.14 B
    # parameters with O(1) LayerScale; the plain paths run on the same
    # model through the `layers` routing, so nothing is built or drawn
    # twice.
    gargs = cli.parse_args(["--dataset", "Synthetic", "--model_size",
                            "giant2", "--freeze", "--batch_size", str(BATCH),
                            "--max_epochs", "1", "--num_train_samples",
                            str(BATCH), "--seed", str(SEED)])
    t1 = time.perf_counter()
    gmodel = cli.build_model(gargs)
    t_build = time.perf_counter() - t1
    t1 = time.perf_counter()
    drawg = host_draws.pop("giant2")
    flatg, t_wait = drawg.result()
    check(sorted(flatg) == sorted(k.replace(".", "/") for k, _ in
                                  gmodel.named_parameters()),
          "the giant2 host draw's keys are not the model's")
    for key in flatg:
        if key.endswith("/gamma"):
            flatg[key] = (1.0 + 0.1 * rng.standard_normal(flatg[key].shape)
                          ).astype(np.float32)
    t_draw = time.perf_counter() - t1
    t1 = time.perf_counter()
    params_from_flax(gmodel, flatg)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t1
    gmodel.eval()
    n_params = sum(p.numel() for p in gmodel.parameters())
    print(f"{tag} giant2: {n_params} parameters ({n_params * 4 / 2**30:.2f} "
          f"GiB f32) built in {t_build:.1f} s, drawn on a host thread from "
          f"{drawg.span[0]:.1f} to {drawg.span[1]:.1f} s of the run (waited "
          f"{t_wait:.1f} s; {t_draw:.1f} s with the O(1) LayerScale), "
          f"copied to the card in {t_load:.1f} s; config {gmodel.config}")
    check(gmodel.dtype == torch.bfloat16 and gmodel.freeze
          and gmodel.ffn_layer == "swiglu" and gmodel.encoder.depth == DEPTH_G
          and tuple(gmodel.encoder.blocks_0.mlp.w3.kernel.shape) == (FG, EG),
          f"giant2 config {gmodel.config}")
    predict_g = make_predict_fn(gmodel, with_saliency=False)
    volg = spread_volumes(rng, predict_g, BATCH, pool=24)
    volg4 = volg[:4]  # the first 4 picks lie furthest apart
    srcg, srcg4 = (torch.from_numpy(v).to(dev) for v in (volg, volg4))
    nbg = DEPTH_G - 1  # the last block is the CLS-only plain block
    per_fwd_g, calls_per_fwd_g = block_counts(
        nbg, "mhsa", "fused_attention_sublayer", swiglu=True)
    fwdg_counts = check_forward("giant2 forward", gmodel, predict_g, volg4,
                                per_fwd_g, calls_per_fwd_g)

    # -- 23. giant2 saliency ----------------------------------------------
    stamp(tag, "23")
    salg_counts = check_saliency("giant2 saliency", gmodel, predict_g, srcg4,
                                 per_fwd_g, calls_per_fwd_g, depth=DEPTH_G,
                                 swiglu=True)

    # -- 24. frozen training and the CLIs -----------------------------------
    stamp(tag, "24")
    gdm = cli.build_datamodule(gargs, dev, num_samples=STEP_BATCHES_G * BATCH,
                               shape_cdhw=(1, DEPTH_SLICES, PX, PX))
    bg = next(iter(gdm.train_dataloader()))
    tsrcg = bg["source"]
    ttgtg = torch.from_numpy(bg["target"]).to(dev, torch.long)
    step_batches_g = [(tsrcg, ttgtg)] + [
        (b["source"], torch.from_numpy(b["target"]).to(dev, torch.long))
        for b in itertools.islice(gdm.val_dataloader(), STEP_BATCHES_G - 1)]
    # AdamW over the slice fusion and head: a frozen encoder requires no grad
    gstate = TrainState(gmodel, make_optimizer(gmodel.parameters(), FIT_LR))
    trainable = [n for n, q in gmodel.named_parameters() if q.requires_grad]
    check(trainable and not any(n.startswith("encoder.") for n in trainable),
          f"trainable {trainable}")

    def swiglu_gate_off_by_one(x_, ln_s_, ln_b_, w12_, b12_, w3_, b3_, ls_,
                               eps_=1e-6):
        """The plain SwiGLU sub-layer with h1's column c gated by h2's
        column c + 1 (an epilogue indexing fault)."""
        f = w3_.shape[0]
        nxt = torch.arange(f, device=w12_.device).roll(-1)
        return fb._swiglu_ref(
            x_, ln_s_, ln_b_, torch.cat([w12_[:, :f], w12_[:, f:][:, nxt]], 1),
            torch.cat([b12_[:f], b12_[f:][nxt]]), w3_, b3_, ls_, eps_)

    @contextlib.contextmanager
    def gate_fault():
        """the plain path with the SwiGLU gate off by one column"""
        with plain_sublayers():  # which puts the kernel sub-layer back
            layers.fused_swiglu_sublayer = swiglu_gate_off_by_one
            yield

    stepg_counts = check_step("giant2 frozen train step", gmodel,
                              step_batches_g, per_fwd_g, calls_per_fwd_g,
                              plain=plain_sublayers,
                              fault=gate_fault, oracle=torch.float64,
                              loss_vs_oracle=True)
    # FIT_STEPS AdamW steps on one batch: the loss falls, the encoder stays
    start = {n: q.detach().clone() for n, q in gmodel.named_parameters()}
    fstep = make_train_step(gstate)
    fit_g = [float(fstep(tsrcg, ttgtg)[0]) for _ in range(FIT_STEPS)]
    enc_same = all(torch.equal(q, start[n])
                   for n, q in gmodel.named_parameters()
                   if n.startswith("encoder."))
    moved = sum(not torch.equal(q, start[n])
                for n, q in gmodel.named_parameters()
                if not n.startswith("encoder."))
    print(f"{tag} giant2 frozen fit, {FIT_STEPS} AdamW steps at lr {FIT_LR} "
          f"on one batch: losses {[round(v, 5) for v in fit_g]}; every "
          f"encoder parameter bit for bit as before: {enc_same}; "
          f"{moved} of {len(trainable)} trainable parameters moved")
    check(enc_same, "a frozen encoder parameter moved")
    check(moved == len(trainable), f"only {moved} trainable parameters moved")
    check(fit_g[-1] < fit_g[0], f"giant2 frozen fit: the loss rose {fit_g}")
    with torch.no_grad():
        for n, q in gmodel.named_parameters():
            q.copy_(start[n])
    del start, fstep, gstate

    # `python -m mst_tpu_torch.train --model_size giant2 --freeze`'s own
    # `train` for one step: the trainer's draw is phase 22's (the same seed;
    # drawing 1.14 B numbers twice would only cost time), and the
    # checkpoint write is timed.
    from mst_tpu_torch.train import trainer as trainer_mod

    gdm_fit = cli.build_datamodule(gargs, dev, num_samples=BATCH,
                                   shape_cdhw=(1, DEPTH_SLICES, PX, PX))
    rung = ROOT / "build" / "chip_smoke_run_giant2"  # gitignored
    shutil.rmtree(rung, ignore_errors=True)
    gtrainer = cli.build_trainer(gargs, gdm_fit, run_dir=rung)
    saves = []
    saved_draw, saved_save = (trainer_mod.random_flax_params,
                              trainer_mod.save_checkpoint)

    def phase22_draw(m_, seed):
        check(m_ is gmodel and seed == SEED, "an unexpected draw")
        return flatg

    def timed_save(*a, **kw):
        t1 = time.perf_counter()
        out = saved_save(*a, **kw)
        saves.append(time.perf_counter() - t1)
        return out

    trainer_mod.random_flax_params = phase22_draw
    trainer_mod.save_checkpoint = timed_save
    try:
        t1 = time.perf_counter()
        _, resultg = cli.train(gargs, gmodel, gdm_fit, gtrainer)
        t_fit = time.perf_counter() - t1
    finally:
        trainer_mod.random_flax_params = saved_draw
        trainer_mod.save_checkpoint = saved_save
    print_last_saves(tag, "giant2 trainer (--freeze)",
                     gtrainer.state_writer.records)
    shutil.rmtree(rung / "last", ignore_errors=True)  # disk: 4.6 GB
    npz_g = best_params_path(rung)
    hpg = json.loads((rung / f"epoch={resultg.best_epoch}.hparams.json"
                      ).read_text())
    print(f"{tag} giant2 trainer: {resultg.epochs_run} epoch(s), "
          f"{t_fit:.1f} s; params.npz {npz_g.stat().st_size / 2**30:.2f} GiB "
          f"written in {saves} s; hparams {hpg}")
    check(resultg.epochs_run == 1 and resultg.best_epoch == 0 and len(saves)
          == 1, f"giant2 fit {resultg}")
    check(hpg["model_size"] == "giant2" and hpg["freeze"] is True
          and hpg["ffn_layer"] == "swiglu", f"giant2 hparams {hpg}")
    served_g = build_model(parse_args(["--run_folder", str(rung)]))
    check(served_g.config == gmodel.config, f"served {served_g.config}")
    vbg = next(iter(gdm_fit.val_dataloader()))
    p_served, _ = make_predict_fn(served_g, with_saliency=False)(
        vbg["source"], None)
    p_eval = torch.softmax(make_eval_step(gmodel)(vbg["source"]).float(), -1)
    d_ck = (p_served - p_eval).abs().max().item()
    print(f"{tag} giant2: `serve --run_folder` probs vs the eval step's on "
          f"{tuple(vbg['source'].shape)}: max |diff| {d_ck:.6g} (must be 0)")
    check(d_ck == 0.0, f"served giant2 run differs from the eval step: {d_ck}")
    del served_g
    rollout_g = block_counts(DEPTH_G, "mhsa_rollout",
                             "fused_attention_sublayer_rollout", swiglu=True)
    check_predict_cli("giant2 predict CLI", rung, ROOT / "build" /
                      "chip_smoke_predict_giant2", N_CASES_G,
                      {k: v * N_CASES_G for k, v in rollout_g[0].items()})

    # -- 25. giant2 times ---------------------------------------------------
    stamp(tag, "25")
    with torch.inference_mode():
        gtimed = {name: (time_ms(kern), time_ms(plain))
                  for name, (kern, plain) in gtimes.items()
                  if not name.startswith(RES_GEMMS + ATTN)}  # phases 42-43
    lib_ms.update({name: time_ms(fn) for name, fn in library.items()
                   if name not in lib_ms and not name.startswith(ATTN)})
    for name, (km, pm_) in gtimed.items():
        print(f"{tag} time giant2 {name}: kernel {km:.4f} ms, plain "
              f"{pm_:.4f} ms, library {lib_ms[name]:.4f} ms")
    secg, memg = seconds_and_memory(lambda: predict_g(srcg, None), n=3)
    print(f"{tag} e2e giant2 B={BATCH} {list(volg.shape)} bf16: "
          f"{secg * 1e3:.3f} ms = {BATCH / secg:.4f} vol/s, peak memory "
          f"{memg / 2**20:.1f} MiB above the "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held")
    profile_device(tag, f"one giant2 B={BATCH} forward",
                   lambda: predict_g(srcg, None), 8)
    for mode in PLANE_MODES:
        sec_m, mem_m = seconds_and_memory(
            lambda: saliency(mode, mdl=gmodel, vols=srcg), n=3)
        print(f"{tag} e2e giant2 saliency {mode} B={BATCH}: "
              f"{sec_m * 1e3:.3f} ms = {BATCH / sec_m:.4f} vol/s "
              f"({sec_m / secg:.3f}x the forward without saliency), peak "
              f"memory {mem_m / 2**20:.1f} MiB above what was held")
    torch.cuda.reset_peak_memory_stats()
    heldg = torch.cuda.memory_allocated()
    sec_tg, kstepg = step_seconds(gmodel, tsrcg, ttgtg, n=3)
    peak_tg = torch.cuda.max_memory_allocated() - heldg
    print(f"{tag} giant2 frozen train step B={BATCH} bf16 (encoder forward "
          f"under no_grad, CE, backward through fusion + head, AdamW): "
          f"{sec_tg * 1e3:.3f} ms = {BATCH / sec_tg:.4f} vol/s; peak memory "
          f"{peak_tg / 2**20:.1f} MiB above the {heldg / 2**20:.1f} MiB held")
    del kstepg


    # ======================================================================
    # Unfrozen encoder training: DINOv2 ViT-B/14 (E 768, 12 heads, 12
    # blocks), ViT-L/14 (E 1024, 16 heads, 24 blocks) and giant2 with
    # --remat; queue B row 6 and the LN pullback at E != 384.
    # ======================================================================
    # -- 26. row 6, the new gemm_dgrad modes, the train sub-layers at E =
    # 768 / 1024 / 1536 vs plain; C1: mhsa_abnar at S = 442; their times --
    stamp(tag, "26")
    del gmodel, predict_g  # phase 28 builds the unfrozen giant2 anew
    torch.cuda.empty_cache()
    # row 6 at the giant2 B=8 path shape, each input from the plain chain
    h12_in, hg_in, gate_in = fb._ln_gemm_swiglu_ref(xg2, lng_s, lng_b, w12,
                                                    b12, eps, True)
    gzg = rand(MG, EG, dtype=bf)  # upstream gradient
    dh12_in = fb._gemm_dgrad_ref(gzg, w3, h12_in, fb.ACT_SWIGLU)
    dhg_in = fb._mm(dh12_in, w12.t())  # the f32 dh of the wide LN route
    ucases = {
        "ln_gemm_swiglu_train[w12]": pair(
            fb.ln_gemm_swiglu, fb._ln_gemm_swiglu_ref, xg2, lng_s, lng_b, w12,
            b12, eps, True),
        "gemm_dls[w3]": pair(fb.gemm_dls, fb._gemm_dls_ref, gate_in, w3, b3,
                             lsg, gzg),
        "gemm_wgrad[w3]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, gate_in,
                               gzg),
        "gemm_dgrad_swiglu[w3]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref, gzg,
                                      w3, h12_in, fb.ACT_SWIGLU),
        "gemm_wgrad[w12]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, hg_in,
                                dh12_in),
        "gemm_dgrad[w12,ln]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref,
                                   dh12_in, w12, None, fb.ACT_NONE,
                                   (xg2, gzg, lng_s, eps)),
        "ln_pullback[E=1536]": pair(fb.ln_pullback, fb._ln_pullback_ref,
                                    dhg_in, xg2, gzg, lng_s, eps),
    }
    cost.update({
        # + h [M, E] and h12 [M, 2F] written beside g
        "ln_gemm_swiglu_train[w12]": (
            swiglu_cost[0], swiglu_cost[1] + 2 * MG * (EG + 2 * FG)),
        "gemm_dls[w3]": mm_cost(MG, FG, EG, 2 * MG * EG + 4 * 3 * EG),
        "gemm_wgrad[w3]": wgrad_cost(MG, FG, EG),
        "gemm_dgrad_swiglu[w3]": mm_cost(MG, EG, FG, 2 * MG * 2 * FG
                                         + 2 * MG * FG),
        "gemm_wgrad[w12]": wgrad_cost(MG, EG, 2 * FG),
        "gemm_dgrad[w12,ln]": mm_cost(MG, 2 * FG, EG,
                                      4 * MG * EG + 4 * 3 * EG),
        # dh f32 in, x and g in, dx out, dln_s and dln_b out
        "ln_pullback[E=1536]": (10 * MG * EG, 4 * MG * EG + 3 * 2 * MG * EG
                                + 4 * 3 * EG),
    })

    def ln_backward_library(dh, x_, lns_):
        """`native_layer_norm_backward` (dx, dln_s, dln_b from dh and the
        saved statistics): the one library call of the LN pullback."""
        xf = x_.float()
        _, mean, rstd = torch.ops.aten.native_layer_norm(
            xf, (x_.shape[1],), lns_, None, eps)
        return functools.partial(torch.ops.aten.native_layer_norm_backward,
                                 dh, xf, (x_.shape[1],), mean, rstd, lns_,
                                 torch.zeros_like(lns_), [True, True, True])

    library.update({
        "ln_gemm_swiglu_train[w12]": swiglu_library,
        "ln_pullback[E=1536]": ln_backward_library(dhg_in, xg2, lng_s),
    })
    # the LN pullback of the MLP backward at ViT-B / ViT-L widths (the fused
    # route keeps K = 384), and each train sub-layer at its model's width
    usub = {}
    for e_, heads_ in ((768, 12), (1024, 16)):
        xw = rand(N_SLICES, S, e_, dtype=bf)
        gw = rand(N_SLICES, S, e_, dtype=bf)
        lw_s, lw_b = rand(e_, scale=0.1, off=1.0), rand(e_, scale=0.1)
        w1w, b1w = (rand(e_, 4 * e_, scale=e_ ** -0.5, dtype=bf),
                    rand(4 * e_, scale=0.1))
        w2w, b2w = (rand(4 * e_, e_, scale=(4 * e_) ** -0.5, dtype=bf),
                    rand(e_, scale=0.1))
        wqw, bqw = (rand(e_, 3 * e_, scale=e_ ** -0.5, dtype=bf),
                    rand(3 * e_, scale=0.1))
        wpw, bpw = rand(e_, e_, scale=e_ ** -0.5, dtype=bf), rand(e_, scale=0.1)
        lsw = rand(e_, scale=0.1, off=1.0)
        x2w, g2w = xw.reshape(MG, e_), gw.reshape(MG, e_)
        aw, _, _ = fb._ln_gemm_ref(x2w, lw_s, lw_b, w1w, b1w, tanh, eps,
                                   train=True)
        daw = fb._gemm_dgrad_ref(g2w, w2w, a=aw, act=tanh)
        lnw = (x2w, g2w, lw_s, eps)
        ucases[f"gemm_dgrad[fc1,ln,E={e_}]"] = pair(
            fb.gemm_dgrad, fb._gemm_dgrad_ref, daw, w1w, None, fb.ACT_NONE,
            lnw)
        cost[f"gemm_dgrad[fc1,ln,E={e_}]"] = mm_cost(
            MG, 4 * e_, e_, 4 * MG * e_ + 4 * 3 * e_)
        dhw = fb._mm(daw, w1w.t())
        ucases[f"ln_pullback[E={e_}]"] = pair(
            fb.ln_pullback, fb._ln_pullback_ref, dhw, *lnw)
        library[f"ln_pullback[E={e_}]"] = ln_backward_library(dhw, x2w, lw_s)
        cost[f"ln_pullback[E={e_}]"] = (10 * MG * e_, 4 * MG * e_
                                        + 3 * 2 * MG * e_ + 4 * 3 * e_)
        usub[f"attention_sublayer_train[E={e_},ls]"] = (
            "attn", xw, gw, (lw_s, lw_b, wqw.float(), bqw, wpw.float(), bpw,
                             lsw, heads_, eps))
        usub[f"mlp_sublayer_train[E={e_},tanh,ls]"] = (
            "mlp", xw, gw, (lw_s, lw_b, w1w.float(), b1w, w2w.float(), b2w,
                            lsw, True, eps))
        del aw, daw, dhw
    gzg3 = gzg.reshape(N_SLICES, S, EG)
    usub["attention_sublayer_train[E=1536,ls]"] = (
        "attn", xg, gzg3, (lng_s, lng_b, wqkvg.float(), bqkvg, wpg.float(),
                           bpg, lsg, HG, eps))
    for label, lsv in (("ls", lsg), ("no_ls", None)):
        usub[f"swiglu_sublayer_train[{label}]"] = (
            "swiglu", xg, gzg3, (lng_s, lng_b, w12.float(), b12, w3.float(),
                                 b3, lsv, eps))
    print(f"{tag} unfrozen-training kernels at the B=8 path shapes [{N_SLICES},"
          f" {S}, E], E = 768 / 1024 / 1536 (12 / 16 / 24 heads; giant2 F = "
          f"{FG}): tolerances as phase 7 (bf16 2 ulps; f32 {KERNEL_GRAD_REL} "
          f"x |plain|max for one kernel, {SUBLAYER_GRAD_REL} x for a "
          f"sub-layer's chain), every output repeated bit for bit")
    for name, (kern, plain) in ucases.items():
        k, pl = kern(), plain()
        again = kern()
        torch.cuda.synchronize()
        errs[name] = check_outputs(tag, f"unfrozen {name}", k, pl,
                                   KERNEL_GRAD_REL)
        k, again = ((k, again) if isinstance(k, tuple) else ((k,), (again,)))
        same = all(torch.equal(a, b) for a, b in zip(k, again))
        print(f"{tag} unfrozen {name}: two runs equal bit for bit: {same}")
        check(same, f"{name}: two runs differ")
    del k, pl, again
    print(f"{tag} unfrozen train sub-layers: (y, residuals, dx, grads) of the "
          f"kernel chain vs the plain chain (SwiGLU: y h h12 g dx dln_s dln_b "
          f"dw12 db12 dw3 db3 [dls])")
    for name, (kind, xw, gw, sargs) in usub.items():
        k = train_sublayer_outputs(fb, kind, fb.KERNELS, xw, sargs, gw)
        again = train_sublayer_outputs(fb, kind, fb.KERNELS, xw, sargs, gw)
        pl = train_sublayer_outputs(fb, kind, fb.PLAIN, xw, sargs, gw)
        torch.cuda.synchronize()
        errs[name] = check_outputs(tag, f"unfrozen sublayer {name}", k, pl,
                                   SUBLAYER_GRAD_REL)
        same = all(torch.equal(a, b) for a, b in zip(k, again)
                   if a is not None)
        print(f"{tag} unfrozen sublayer {name}: two runs equal bit for bit: "
              f"{same}")
        check(same, f"{name}: two runs differ")
        del k, pl, again
    # C1: the Abnar factor at S = 442 (ViT-S/14 on 294 px slices), where the
    # two-pass forward takes over (its head sum in the factor rows; the
    # query tile is 64 rows at every S)
    s442, px442 = 442, 294
    check(fb.abnar_query_tile(s442) == 64 and fb.mhsa_launch(s442).passes == 2,
          "the S = 442 Abnar tile")
    qkv442 = rand(N_SLICES * s442, 3 * E, dtype=bf)
    cos442, sin442 = rope_tables((21, 21), 64, 1, 100.0, True, dev)
    c1cases = {
        "mhsa_abnar[S=442]": (
            lambda: fb.mhsa_abnar(qkv442, N_SLICES, s442, HEADS),
            lambda: fb._mhsa_ref(qkv442, N_SLICES, s442, HEADS,
                                 want_abnar=True)),
        "mhsa_abnar_rope[S=442]": (
            lambda: fb.mhsa_abnar(qkv442, N_SLICES, s442, HEADS, cos442,
                                  sin442),
            lambda: fb._mhsa_ref(qkv442, N_SLICES, s442, HEADS,
                                 want_abnar=True, rope_cos=cos442,
                                 rope_sin=sin442)),
    }
    with torch.inference_mode():
        for name, (kern, plain) in c1cases.items():
            k, pl = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            errs[name] = check_outputs(tag, f"C1 {name}", k, pl,
                                       KERNEL_GRAD_REL)
            same = all(torch.equal(a, b) for a, b in zip(k, again))
            print(f"{tag} C1 {name}: two runs equal bit for bit: {same}")
            check(same, f"{name}: two runs differ")
        del k, pl, again, qkv442
        vols442 = torch.from_numpy(rng.standard_normal(
            (2, 1, DEPTH_SLICES, px442, px442), dtype=np.float32)).to(dev)
        fb.reset_launch_counts()
        pk, sk = saliency("rollout_abnar", vols=vols442)
        counts = fb.launch_counts()
        with plain_sublayers():
            pp, sp_ = saliency("rollout_abnar", vols=vols442)
    want442, _ = block_counts(n_full, "mhsa_abnar",
                              "fused_attention_sublayer_abnar")
    d_p, d_s = (pk - pp).abs().max().item(), sal_rel(sk, sp_)
    print(f"{tag} C1 rollout_abnar saliency at S = {s442} "
          f"{list(vols442.shape)}: |probs - plain| {d_p:.6g} (limit "
          f"{PROB_TOL}), saliency vs plain {d_s:.6g} (limit {SAL_REL}); "
          f"launches {counts}")
    check(tuple(sk.shape) == (2, DEPTH_SLICES, px442, px442)
          and bool(torch.isfinite(sk).all()), f"C1 saliency {sk.shape}")
    check(d_p <= PROB_TOL and d_s <= SAL_REL, f"C1 saliency: {d_p} / {d_s}")
    check_launches(counts, want442, "C1")
    del vols442, pk, sk, pp, sp_
    # their times here, so that the steps of phases 27-30 have the room of
    # these inputs (the ViT-L step's checks peak near 70 GiB)
    utimed = {name: (time_ms(kern), time_ms(plain))
              for name, (kern, plain) in ucases.items()
              if not name.startswith(BWD_GEMMS + RES_GEMMS + ATTN
                                     + PULLBACK)}  # phases 41-43, 45
    lib_ms.update({name: time_ms(fn) for name, fn in library.items()
                   if name not in lib_ms
                   and not name.startswith(ATTN + PULLBACK)})
    for name, (km, pm_) in utimed.items():
        lib = f", library {lib_ms[name]:.4f} ms" if name in lib_ms else ""
        print(f"{tag} time {name}: kernel {km:.4f} ms, plain {pm_:.4f} ms"
              f"{lib}")
    for name, (kind, xw, gw, sargs) in usub.items():
        fn = {"attn": fb.fused_attention_sublayer_train,
              "mlp": fb.fused_mlp_sublayer_train,
              "swiglu": fb.fused_swiglu_sublayer_train}[kind]
        for label, ops in (("kernel", fb.KERNELS), ("plain", fb.PLAIN)):
            ms = time_ms(lambda: fn(xw.detach().requires_grad_(True), *sargs,
                                    ops=ops).backward(gw), n=5)
            print(f"{tag} time {name} forward + backward: {label} "
                  f"{ms:.4f} ms")
    del (usub, ucases, h12_in, hg_in, gate_in, gzg, dh12_in, dhg_in, gzg3,
         xw, gw, x2w, g2w, lnw, sargs)
    library.clear()
    torch.cuda.empty_cache()

    # -- 27. the unfrozen ViT-B/14 and ViT-L/14 steps at B=8 --------------
    stamp(tag, "27")

    def unfrozen_counts(nb, swiglu=False, remat=False):
        """(launches, sub-layer calls) of one unfrozen train step over nb
        kernel blocks (the LN pullback through `ln_pullback`);
        with remat the backward runs each block's forward again, whose FFN
        sub-layer launches its kernels but returns no call: the checkpoint
        stops the recompute as that sub-layer saves the block's last
        residual (torch's early stop)."""
        fwd = 2 if remat else 1
        counts, calls = dict(zero), dict(zero_calls)
        counts.update({"ln_gemm": fwd * nb * (1 if swiglu else 2),
                       "mhsa": fwd * nb, "gemm_residual": 2 * fwd * nb,
                       "gemm_dls": 2 * nb, "gemm_wgrad": 4 * nb,
                       "gemm_dgrad": (3 if swiglu else 4) * nb,
                       "mhsa_bwd": nb, "ln_pullback": 2 * nb})
        if swiglu:
            counts["ln_gemm_swiglu_train"] = fwd * nb
            counts["gemm_dgrad_swiglu"] = nb
        calls["fused_attention_sublayer_train"] = fwd * nb
        calls["fused_swiglu_sublayer_train" if swiglu
              else "fused_mlp_sublayer_train"] = nb
        return counts, calls

    def unfrozen_model(size, extra=()):
        """The train CLI's model at --model_size `size` from a seeded draw,
        O(1) LayerScale, and STEP_BATCHES B=8 batches of its data module."""
        uargs = cli.parse_args(["--dataset", "Synthetic", "--model_size", size,
                                "--batch_size", str(BATCH), "--max_epochs",
                                "1", "--num_train_samples", str(BATCH),
                                "--seed", str(SEED), *extra])
        m_ = cli.build_model(uargs)
        draw = host_draws.pop(size)
        flat_, waited = draw.result()  # random_flax_params(m_, SEED)
        print(f"{tag} ViT-{size}: drawn on a host thread from "
              f"{draw.span[0]:.1f} to {draw.span[1]:.1f} s of the run "
              f"(waited {waited:.1f} s)")
        params_from_flax(m_, flat_)
        del flat_
        with torch.no_grad():
            for n_, q in m_.named_parameters():
                if n_.endswith(".gamma"):
                    q.copy_(torch.from_numpy(1.0 + 0.1 * rng.standard_normal(
                        tuple(q.shape))).to(q))
        dm_ = cli.build_datamodule(uargs, dev, num_samples=STEP_BATCHES * BATCH,
                                   shape_cdhw=(1, DEPTH_SLICES, PX, PX))
        b0 = next(iter(dm_.train_dataloader()))
        batches = [(b0["source"], torch.from_numpy(b0["target"]).to(
            dev, torch.long))] + [
            (b["source"], torch.from_numpy(b["target"]).to(dev, torch.long))
            for b in itertools.islice(dm_.val_dataloader(), STEP_BATCHES - 1)]
        return uargs, m_, batches

    def check_unfrozen_fit(what, mdl, src_, tgt_):
        """FIT_STEPS_U AdamW steps on one batch on the kernels: the loss
        falls."""
        fit = fit_losses(mdl, src_, tgt_, FIT_STEPS_U, FIT_LR_U)
        print(f"{tag} {what}, {FIT_STEPS_U} AdamW steps at lr {FIT_LR_U} on "
              f"one batch: losses {[round(v, 5) for v in fit]}")
        check(all(map(math.isfinite, fit)) and fit[-1] < fit[0],
              f"{what}: the loss did not fall: {fit}")

    print(f"{tag} unfrozen steps: grads against the plain step in f64 (the "
          f"oracle; its residuals rebuilt block by block so that it fits), "
          f"pooled over {STEP_BATCHES} batches; limits as phase 8")
    uruns = {}
    for size, extra, nb_u in (("base", (), 11),
                              ("large", ("--fusion_heads", "16"), 23)):
        t1 = time.perf_counter()
        uargs, um, ubatches = unfrozen_model(size, extra)
        check(not um.freeze and um.encoder.embed_dim == {"base": 768,
                                                         "large": 1024}[size]
              and um.encoder.depth == nb_u + 1, f"{size} config {um.config}")
        print(f"{tag} ViT-{size}: {sum(q.numel() for q in um.parameters())} "
              f"parameters, built and drawn in {time.perf_counter() - t1:.1f} "
              f"s; config {um.config}")
        want_u, want_calls_u = unfrozen_counts(nb_u)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_u = torch.cuda.memory_allocated()
        check_step(f"unfrozen ViT-{size} step", um, ubatches, want_u,
                   want_calls_u, oracle=torch.float64)
        print(f"{tag} unfrozen ViT-{size}: peak device memory of the checks "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the "
              f"{held_u / 2**30:.2f} GiB held before them included)")
        check_unfrozen_fit(f"unfrozen ViT-{size} fit", um, *ubatches[0])
        uruns[size] = (um, ubatches[0])
        del ubatches

    # -- 28. the unfrozen giant2 step with --remat ------------------------
    stamp(tag, "28")
    # The train CLI's model with --remat, holding phase 22's draw (the
    # fusion and head as drawn: phase 24 trained the frozen model's)
    gargs_u = cli.parse_args(["--dataset", "Synthetic", "--model_size",
                              "giant2", "--remat", "--batch_size", str(BATCH),
                              "--max_epochs", "1", "--num_train_samples",
                              str(BATCH), "--seed", str(SEED)])
    gmodel_u = cli.build_model(gargs_u)
    params_from_flax(gmodel_u, flatg)
    check(gmodel_u.remat and not gmodel_u.freeze
          and gmodel_u.config["remat"] is True, f"giant2 {gmodel_u.config}")
    gbatches = [(b[:STEP_B_G], t_[:STEP_B_G]) for b, t_ in step_batches_g[
        :STEP_BATCHES]]

    def swiglu_train_gate_off_by_one(x_, ln_s_, ln_b_, w12_, b12_, w3_, b3_,
                                     ls_, eps_=1e-6):
        """The plain SwiGLU train sub-layer with h1's column c gated by
        h2's column c + 1 (an epilogue indexing fault)."""
        f = w3_.shape[0]
        nxt = torch.arange(f, device=w12_.device).roll(-1)
        return fb.fused_swiglu_sublayer_train(
            x_, ln_s_, ln_b_, torch.cat([w12_[:, :f], w12_[:, f:][:, nxt]], 1),
            torch.cat([b12_[:f], b12_[f:][nxt]]), w3_, b3_, ls_, eps_,
            ops=fb.PLAIN)

    @contextlib.contextmanager
    def train_gate_fault():
        """the plain path with the SwiGLU gate off by one column"""
        with plain_train_sublayers():
            layers.fused_swiglu_sublayer_train = swiglu_train_gate_off_by_one
            yield

    want_g, want_calls_g = unfrozen_counts(nbg, swiglu=True, remat=True)
    stepu_counts = check_step(
        f"unfrozen giant2 step with remat, B={STEP_B_G},", gmodel_u, gbatches,
        want_g, want_calls_g, fault=train_gate_fault, oracle=torch.float64,
        grad_tol=GIANT2_U_GRAD_REL, loss_vs_oracle=True)
    del gbatches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_u = torch.cuda.memory_allocated()
    loss8, _ = loss_and_grads(gmodel_u, tsrcg, ttgtg)
    peak8 = torch.cuda.max_memory_allocated()
    print(f"{tag} unfrozen giant2 step with remat at B={BATCH} "
          f"{list(tsrcg.shape)}: loss {loss8:.6g}; peak device memory "
          f"{peak8 / 2**30:.2f} GiB ({(peak8 - held_u) / 2**30:.2f} GiB above "
          f"the {held_u / 2**30:.2f} GiB held: parameters and the earlier "
          f"phases' tensors; grads and AdamW moments not yet allocated)")
    check(math.isfinite(loss8) and peak8 < 80 * 10**9,
          f"giant2 B=8 step: loss {loss8}, peak {peak8}")
    gmodel_u.zero_grad(set_to_none=True)

    # -- 29. train --model_size giant2 --remat -> run folder -> serve -----
    stamp(tag, "29")
    # One unfrozen epoch of one B=8 step through the CLI's own `train`; its
    # draw is phase 22's (the same seed), as in phase 24.
    rung_u = ROOT / "build" / "chip_smoke_run_giant2_remat"  # gitignored
    shutil.rmtree(rung_u, ignore_errors=True)
    gtrainer_u = cli.build_trainer(gargs_u, gdm_fit, run_dir=rung_u)

    def phase22_draw_u(m_, seed):
        check(m_ is gmodel_u and seed == SEED, "an unexpected draw")
        return flatg

    trainer_mod.random_flax_params = phase22_draw_u
    try:
        t1 = time.perf_counter()
        _, result_u = cli.train(gargs_u, gmodel_u, gdm_fit, gtrainer_u)
        t_fit = time.perf_counter() - t1
    finally:
        trainer_mod.random_flax_params = saved_draw
    print_last_saves(tag, "unfrozen giant2 trainer (--remat)",
                     gtrainer_u.state_writer.records)
    shutil.rmtree(rung_u / "last", ignore_errors=True)  # disk: 13.8 GB
    del flatg, phase22_draw_u  # 4.3 GiB of host memory
    hpu = json.loads((rung_u / f"epoch={result_u.best_epoch}.hparams.json"
                      ).read_text())
    hist_u = json.loads((rung_u / "history.jsonl").read_text().splitlines()[0])
    print(f"{tag} unfrozen giant2 trainer (--remat): {result_u.epochs_run} "
          f"epoch(s), {t_fit:.1f} s, train loss {hist_u['train_loss']:.6g}; "
          f"hparams {hpu}")
    check(result_u.epochs_run == 1 and math.isfinite(hist_u["train_loss"])
          and hpu["remat"] is True and hpu["freeze"] is False
          and hpu["model_size"] == "giant2", f"giant2 remat run {hpu}")
    served_u = build_model(parse_args(["--run_folder", str(rung_u)]))
    check(served_u.config == gmodel_u.config and served_u.remat,
          f"served {served_u.config}")
    p_served, _ = make_predict_fn(served_u, with_saliency=False)(
        vbg["source"], None)
    p_eval = torch.softmax(make_eval_step(gmodel_u)(vbg["source"]).float(),
                           -1)
    d_ck = (p_served - p_eval).abs().max().item()
    print(f"{tag} unfrozen giant2: `serve --run_folder` probs vs the eval "
          f"step's on {tuple(vbg['source'].shape)}: max |diff| {d_ck:.6g} "
          f"(must be 0)")
    check(d_ck == 0.0, f"served giant2 remat run differs: {d_ck}")
    del served_u

    # -- 30. unfrozen-training times ----------------------------------------
    stamp(tag, "30")
    gmodel_u.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    for size, (um, (usrc, utgt)) in list(uruns.items()) + [
            ("giant2 (remat)", (gmodel_u, (tsrcg, ttgtg)))]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_s = torch.cuda.memory_allocated()
        sec_u, kstep_u = step_seconds(um, usrc, utgt,
                                      n=2 if um is gmodel_u else 3)
        peak_u = torch.cuda.max_memory_allocated()
        print(f"{tag} unfrozen {size} train step B={BATCH} bf16 (forward, CE, "
              f"backward, AdamW): {sec_u * 1e3:.3f} ms = {BATCH / sec_u:.4f} "
              f"vol/s; peak device memory {peak_u / 2**30:.2f} GiB (the "
              f"{held_s / 2**30:.2f} GiB held before it included)")
        profile_device(tag, f"one unfrozen {size} train step",
                       lambda: kstep_u(usrc, utgt), 16)
        del kstep_u, um
        uruns.pop(size, None)
        torch.cuda.empty_cache()


    # ======================================================================
    # W8A8 int8 serving: queue B rows 9-11 (`_attn_i8_kernel`,
    # `_mlp_i8_kernel`, `_swiglu_i8_kernel`) on `ln_gemm_i8`, `quant_rows`
    # and `gemm_i8_residual`, the attention core on `mhsa`.
    # ======================================================================
    # -- 31. the int8 kernels and sub-layers vs plain ----------------------
    stamp(tag, "31")
    print(f"{tag} int8 tolerance: int8 codes may differ from the plain "
          f"version's at .5 ties of an f32 LN / GELU summed in another order "
          f"(at most {CODE_FRAC} of them, each by one); bf16 outputs and the "
          f"f32 FFN hidden within 2 bf16 ulps at the largest magnitude, the "
          f"hidden's per-token codes as the kernels' codes; the chains' f32 "
          f"rows, carries and Abnar factors within 3e-3 x it (as phase 11); "
          f"every kernel repeats bit for bit")
    with torch.inference_mode():
        icases, icost, ilibrary = int8_cases(dev, rng, fb, fq, layers)
        for name, (kern, plain, rel) in icases.items():
            k, pl = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            errs[name] = check_int8(tag, f"int8 {name}", k, pl, rel)
            k, again = ((u if isinstance(u, tuple) else (u,))
                        for u in (k, again))
            same = all(torch.equal(a, b) for a, b in zip(k, again))
            print(f"{tag} int8 {name}: two runs equal bit for bit: {same}")
            check(same, f"{name}: two runs differ")
            del k, pl, again
    cost.update(icost)
    library.update(ilibrary)

    # -- 32. ViT-S/14 int8 serving at B=8 -----------------------------------
    stamp(tag, "32")

    def i8_counts(nb, attn_kernel="mhsa", static=False, swiglu=False):
        """(launches, sub-layer calls) of nb int8 blocks: the attention
        chain through `attn_kernel`, then the MLP or SwiGLU chain; a static
        tree quantizes o in `quant_rows` and the hidden in `ln_gemm_i8`."""
        counts, calls = dict(zero), dict(zero_calls)
        counts["ln_gemm_i8"] += nb
        counts["ln_gemm_i8_swiglu" if swiglu else "ln_gemm_i8"] += nb
        counts["quant_rows"] += nb if static else 2 * nb
        counts["gemm_i8_residual"] += 2 * nb
        counts[attn_kernel] += nb
        calls["fused_attention_sublayer_i8"] += nb
        calls["fused_swiglu_sublayer_i8" if swiglu
              else "fused_mlp_sublayer_i8"] += nb
        return counts, calls

    @contextlib.contextmanager
    def sal_slice_fault():
        """The kernel path with each slice's saliency data (the last block's
        CLS row, the rollout carry, every block's Abnar factor) read from
        the neighbouring slice."""
        saved = vit_fast.fused_vit_cls

        def faulty(*a, **kw):
            feats, data = saved(*a, **kw)
            if isinstance(data, list):
                return feats, [f.roll(1, 0) for f in data]
            return feats, data.roll(1, 0)
        vit_fast.fused_vit_cls = faulty
        try:
            yield
        finally:
            vit_fast.fused_vit_cls = saved

    # `serve --params_npz --int8`'s build_model: phase 4's weights quantized
    # on the card (dynamic). The static copy is calibrated on 8 volumes of
    # the generator the checked volumes come from (phase 4's, the volumes
    # it will serve; PTQ saturates activations outside the calibrated
    # range), and the 8 checked volumes are picked from 48 others, far apart
    # under the bf16, dynamic and static paths alike.
    synth = dict(shape_cdhw=(1, DEPTH_SLICES, PX, PX), num_samples=BATCH)
    model8 = build_model(parse_args(["--params_npz", str(npz), "--int8"]))
    pool8 = candidate_volumes(rng, 7 * BATCH)
    t1 = time.perf_counter()
    model8s = fq.quantize_mst_int8(model, pool8[:BATCH])
    torch.cuda.synchronize()
    print(f"{tag} int8 ViT-S: static scales calibrated on "
          f"{list(pool8[:BATCH].shape)} and folded in "
          f"{time.perf_counter() - t1:.2f} s")
    for m_ in (model8, model8s):
        check(isinstance(m_.encoder.blocks_0.attn.qkv, layers.QDense)
              and not isinstance(m_.encoder.blocks_11.attn.qkv,
                                 layers.QDense)
              and m_.dtype == torch.bfloat16, "int8 ViT-S structure")
    probs8 = [batched_probs(make_predict_fn(m_, with_saliency=False),
                            pool8[BATCH:]) for m_ in (model, model8, model8s)]
    vol = pool8[BATCH:][pick_spread(np.minimum.reduce(
        [row_gaps(p_) for p_ in probs8]), probs8[0], BATCH)]
    src8 = torch.from_numpy(vol).to(dev)
    pb16, _ = predict(vol, None)  # the bf16 kernel path
    # a static copy calibrated on Synthetic volumes (another generator, as
    # `serve --int8_calib` on phase 9's run folder calibrates), read against
    # the same volumes: how far out-of-distribution calibration moves it
    calib8 = calibration_volumes(run_dir, BATCH, **synth)
    p_syn, _ = make_predict_fn(fq.quantize_mst_int8(model, calib8),
                               with_saliency=False)(vol, None)
    print(f"{tag} int8 static, calibrated on {BATCH} Synthetic volumes "
          f"instead: |probs - bf16 kernel path| "
          f"{(p_syn - pb16).abs().max().item():.6g} on the checked volumes "
          f"(a reading, not held: those activations lie outside the "
          f"calibrated range)")
    del p_syn
    print(f"{tag} int8 forward tolerance: |probs kernel - probs plain| <= "
          f"{PROB_TOL} (as phase 4); against the bf16 kernel path |probs| <= "
          f"{I8_TOL} and the same argmax where the bf16 probs lie further "
          f"than {I8_TOL} from the class boundary (the JAX suite's bar); bf16 "
          f"probs of class 1: {pb16[:, 1].tolist()}")
    i8_runs = {}
    for label, mdl in (("dynamic", model8), ("static", model8s)):
        static = label == "static"
        pred8 = make_predict_fn(mdl, with_saliency=False)
        want, want_calls = i8_counts(n_blocks, static=static)
        fb.reset_launch_counts()
        pk, _ = pred8(vol, None)
        torch.cuda.synchronize()
        counts, calls = fb.launch_counts(), fb.sublayer_calls()
        with plain_sublayers():
            pp, _ = pred8(vol, None)
        d_p = (pk - pp).abs().max().item()
        d_b = (pk - pb16).abs().max().item()
        agree, held = argmax_agreement(pk, pb16)
        gap = min_row_gap(pp.cpu())
        print(f"{tag} int8 {label} forward {list(vol.shape)}: probs[:, 1] "
              f"{pk[:, 1].tolist()}; |kernel - plain| {d_p:.6g}, min gap "
              f"between volumes {gap:.6g}; |int8 - bf16 kernel path| "
              f"{d_b:.6g}, argmax agreeing {agree}, held {held}; launches "
              f"{counts}; sub-layer calls {calls}")
        check(bool(torch.isfinite(pk).all()), f"int8 {label}: non-finite")
        check(d_p <= PROB_TOL and gap > PROB_TOL,
              f"int8 {label} vs plain: {d_p} (gap {gap})")
        check(d_b <= I8_TOL and all(a for a, h in zip(agree, held) if h),
              f"int8 {label} vs bf16: {d_b}, argmax {agree}, held {held}")
        check_launches(counts, want, f"int8 {label}")
        check(calls == want_calls, f"int8 {label} calls {calls}")
        # the three saliency modes on the int8 blocks vs the plain int8 path
        for mode in PLANE_MODES:
            if mode == "last":
                want_m = (want, want_calls)
            else:
                attn_k = {"rollout": "rollout", "rollout_abnar": "abnar"}[mode]
                full = block_counts(1, f"mhsa_{attn_k}",
                                    f"fused_attention_sublayer_{attn_k}")
                part = i8_counts(n_blocks, f"mhsa_{attn_k}", static)
                want_m = (added(part[0], full[0]), added(part[1], full[1]))
            fb.reset_launch_counts()
            pk_s, sk = saliency(mode, mdl=mdl, vols=src8)
            counts_s, calls_s = fb.launch_counts(), fb.sublayer_calls()
            with plain_sublayers():
                pp_s, sp_ = saliency(mode, mdl=mdl, vols=src8)
                so = saliency(mode, dtype=torch.float64, mdl=mdl,
                              vols=src8)[1]  # the oracle
            with sal_slice_fault():
                sf = saliency(mode, mdl=mdl, vols=src8)[1]
            d_ps, d_s = (pk_s - pp_s).abs().max().item(), sal_rel(sk, sp_)
            d_k, d_p = sal_pooled(sk, so), sal_pooled(sp_, so)
            d_f = sal_pooled(sf, so)
            w_k, w_p = sal_rel(sk, so), sal_rel(sp_, so)
            print(f"{tag} int8 {label} saliency {mode} {list(sk.shape)}: "
                  f"|probs - plain| {d_ps:.6g}; saliency vs the f64 oracle, "
                  f"each volume's relative distance averaged over the "
                  f"{sk.shape[0]} volumes: kernel path {d_k:.6g}, plain path "
                  f"{d_p:.6g} (ratio {d_k / d_p:.4g}, limit {SAL_I8_RATIO}), "
                  f"planted fault (each slice's saliency data from the "
                  f"neighbouring slice) {d_f:.6g} ({d_f / d_p:.4g}x, must "
                  f"break the limit); the batch's worst volume (the former "
                  f"statistic, printed, not held): kernel {w_k:.6g}, plain "
                  f"{w_p:.6g} (ratio {w_k / w_p:.4g}); kernel vs plain "
                  f"{d_s:.6g} (the former limit {SAL_REL}, printed, not "
                  f"held); launches {counts_s}; sub-layer calls {calls_s}")
            check(bool(torch.isfinite(sk).all()), f"int8 {mode}: non-finite")
            check(d_ps <= PROB_TOL and d_k <= SAL_I8_RATIO * d_p,
                  f"int8 {label} {mode}: {d_ps} / {d_k} vs {d_p}")
            check(d_f > SAL_I8_RATIO * d_p,
                  f"int8 {label} {mode}: the planted fault passes ({d_f})")
            check_launches(counts_s, want_m[0], f"int8 {label} {mode}")
            check(calls_s == want_m[1],
                  f"int8 {label} {mode} calls {calls_s}")
        i8_runs[label] = (mdl, pred8, want)

    # `serve --int8 [--int8_calib 8] --run_folder` on phase 9's run folder
    # answers POSTs (the launch counts of the dynamic server are the int8
    # path's in the kernels line). The deployed contract: each int8 model
    # the CLI builds (static scales from the run's val split) against the
    # run's bf16 model on the test split of the run's own dataset, at the
    # JAX suite's bar with the boundary exemption above
    data_kw = dict(shape_cdhw=(1, DEPTH_SLICES, PX, PX), num_samples=N_CASES)
    pargs_run = predict_cli.parse_args(["--run_folder", str(run_dir)])
    test_vols = torch.cat([b["source"] for b in predict_cli.build_datamodule(
        pargs_run, dev, **data_kw).test_dataloader()])
    p_run16, _ = make_predict_fn(build_model(parse_args(
        ["--run_folder", str(run_dir)])), with_saliency=False)(test_vols, None)

    def post_one(port, volume):
        buf = io.BytesIO()
        np.save(buf, volume)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    for extra in ([], ["--int8_calib", str(BATCH)]):
        sargs = parse_args(["--run_folder", str(run_dir), "--int8", *extra,
                            "--port", "0", "--batch_size", "4",
                            "--max_wait_ms", "1"])
        smodel = build_model(sargs, **synth)
        spred = make_predict_fn(smodel, with_saliency=False)
        direct, _ = spred(vol[:1], None)
        p_run8, _ = spred(test_vols, None)
        d_run = (p_run8 - p_run16).abs().max().item()
        agree_r, held_r = argmax_agreement(p_run8, p_run16)
        print(f"{tag} serve --int8 {' '.join(extra)} --run_folder model on "
              f"the run's {len(test_vols)} test volumes: probs[:, 1] "
              f"{p_run8[:, 1].tolist()}, the run's bf16 model "
              f"{p_run16[:, 1].tolist()}; |int8 - bf16| {d_run:.6g} (limit "
              f"{I8_TOL}), argmax agreeing {agree_r}, held {held_r}")
        check(bool(torch.isfinite(p_run8).all()) and d_run <= I8_TOL
              and all(a for a, h in zip(agree_r, held_r) if h),
              f"serve --int8 {extra} vs the run's bf16 model: {d_run}, "
              f"argmax {agree_r}, held {held_r}")
        fb.reset_launch_counts()
        server, bp = build_server(sargs, smodel)
        try:
            got = post_one(server.server_address[1], vol[0])
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.server_address[1]}/healthz",
                    timeout=60) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            bp.close()
        torch.cuda.synchronize()
        counts = fb.launch_counts()
        d_srv = float(np.abs(np.asarray(got["probs"])
                             - direct[0].cpu().numpy()).max())
        want = i8_counts(n_blocks, static=bool(extra))[0]
        print(f"{tag} serve --int8 {' '.join(extra)} --run_folder: POST -> "
              f"{got}; |served - direct| {d_srv:.6g} (tol {SERVE_TOL}); "
              f"healthz {health}; launches {counts}")
        check(d_srv <= SERVE_TOL and health["int8"] == (
            "static" if extra else "dynamic") and bp.batches_run == 1,
              f"serve --int8 {extra}: {d_srv}, {health}")
        check_launches(counts, want, "serve --int8")
        if not extra:
            served8_counts = counts
        del smodel

    # `predict --int8 --int8_calib 4 --use_tta --use_rollout` on that run
    out8 = ROOT / "build" / "chip_smoke_predict_int8"
    shutil.rmtree(out8, ignore_errors=True)
    pargv = ["--run_folder", str(run_dir), "--output_dir", str(out8),
             "--int8", "--int8_calib", "4", "--use_tta", "--use_rollout"]
    fb.reset_launch_counts()
    t1 = time.perf_counter()
    predict_cli.main(pargv, **data_kw)
    torch.cuda.synchronize()
    cli_sec = time.perf_counter() - t1
    cli_counts = fb.launch_counts()
    with (out8 / "results.csv").open() as f:
        rows8 = list(csv.DictReader(f))
    pargs8 = predict_cli.parse_args(pargv)
    pdm8 = predict_cli.build_datamodule(pargs8, dev, **data_kw)
    qrun = predict_cli.quantize_model(
        pargs8, predict_cli.build_model(pargs8, dev), pdm8)
    pfn8 = make_predict_fn(qrun, tta=True, with_saliency=False)
    worst_p = 0.0
    for r, b in zip(rows8, pdm8.test_dataloader()):
        pbatch, _ = pfn8(b["source"], None)
        check(r["uid"] == b["uid"][0] and int(r["NN"]) == int(
            pbatch[0].argmax()), f"predict --int8 row {r}")
        worst_p = max(worst_p, abs(float(r["NN_pred"]) - pbatch[0, 1].item()))
    want = {k: v * N_CASES for k, v in i8_counts(n_blocks, static=True)[
        0].items()}
    print(f"{tag} predict --int8 --int8_calib 4 --use_tta --use_rollout on "
          f"{N_CASES} cases: {cli_sec:.3f} s; results.csv rows {len(rows8)}; "
          f"|NN_pred - predictor| {worst_p:.6g} (must be <= 1e-6); launches "
          f"{cli_counts}; predict.log "
          f"{(out8 / 'predict.log').read_text().strip().splitlines()}")
    check(len(rows8) == N_CASES and worst_p <= 1e-6,
          f"predict --int8: {len(rows8)} rows, {worst_p}")
    check_launches(cli_counts, want, "predict --int8")
    del qrun, pfn8

    # -- 33. giant2 int8, and the int8 times ------------------------------
    stamp(tag, "33")
    # The unfrozen giant2 of phases 28-30 (phase 22's seeded draw after
    # phase 29's one AdamW step), quantized on the card from its f32
    # parameters; its bf16 kernel path is the reference
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    qg = fq.quantize_mst_int8(gmodel_u)
    torch.cuda.synchronize()
    t_qg = time.perf_counter() - t1
    n_q8 = sum(b.numel() for n_, b in qg.named_buffers()
               if n_.endswith(".q8"))
    predict_gq = make_predict_fn(qg, with_saliency=False)
    predict_gb = make_predict_fn(gmodel_u, with_saliency=False)
    fb.reset_launch_counts()
    pgq, _ = predict_gq(srcg4, None)
    torch.cuda.synchronize()
    fwdg8_counts, callsg8 = fb.launch_counts(), fb.sublayer_calls()
    pgb, _ = predict_gb(srcg4, None)
    d_g = (pgq - pgb).abs().max().item()
    agree_g, held_g = argmax_agreement(pgq, pgb)
    want_g = i8_counts(DEPTH_G - 1, swiglu=True)
    print(f"{tag} giant2 int8: {n_q8} int8 weights quantized on the card in "
          f"{t_qg:.2f} s; forward {list(srcg4.shape)}: probs[:, 1] int8 "
          f"{pgq[:, 1].tolist()}, bf16 {pgb[:, 1].tolist()}; |int8 - bf16| "
          f"{d_g:.6g} (limit {I8_TOL}), argmax agreeing {agree_g}, held "
          f"{held_g}; launches {fwdg8_counts}; sub-layer calls {callsg8}")
    check(bool(torch.isfinite(pgq).all()) and d_g <= I8_TOL
          and all(a for a, h in zip(agree_g, held_g) if h),
          f"giant2 int8 vs bf16: {d_g}, {agree_g}, held {held_g}")
    check_launches(fwdg8_counts, want_g[0], "giant2 int8")
    check(callsg8 == want_g[1], f"giant2 int8 calls {callsg8}")

    # (the first products, `ln_gemm_i8` / `ln_gemm_i8_swiglu`: phase 45;
    # the second, `gemm_i8_residual`: phase 46; `quant_rows`: phase 47)
    timed_i8 = ("attention_sublayer_i8[ls]",
                "attention_sublayer_i8[ls,static]", "mlp_sublayer_i8[tanh,ls]",
                "mlp_sublayer_i8[tanh,ls,static]", "swiglu_sublayer_i8[ls]",
                "swiglu_sublayer_i8[ls,static]")
    with torch.inference_mode():
        itimed = {name: (time_ms(icases[name][0]),
                         time_ms(icases[name][1], n=5, warmup=1))
                  for name in timed_i8}
    lib_ms.update({name: time_ms(fn) for name, fn in library.items()
                   if name not in lib_ms and not name.startswith("ln_gemm_i8")})
    for name, (km, pm_) in itimed.items():
        lib = f"{lib_ms[name]:.4f} ms" if name in lib_ms else "none"
        print(f"{tag} time int8 {name}: kernel {km:.4f} ms, plain {pm_:.4f} "
              f"ms, library {lib}")
    del icases, ilibrary
    for name in ("dynamic", "static"):
        mdl, pred8, _ = i8_runs[name]
        sec8, mem8 = seconds_and_memory(lambda: pred8(src8, None))
        print(f"{tag} e2e int8 ({name}) B={BATCH} {list(vol.shape)}: "
              f"{sec8 * 1e3:.3f} ms = {BATCH / sec8:.3f} vol/s, peak memory "
              f"{mem8 / 2**20:.1f} MiB above the "
              f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held")
        profile_device(tag, f"one int8 ({name}) ViT-S B={BATCH} forward",
                       lambda: pred8(src8, None), 10)
    sec_b, mem_b = seconds_and_memory(lambda: predict(src8, None))
    print(f"{tag} e2e bf16 kernel path B={BATCH} (the same call, beside the "
          f"int8 ones): {sec_b * 1e3:.3f} ms = {BATCH / sec_b:.3f} vol/s, peak "
          f"memory {mem_b / 2**20:.1f} MiB")
    for label, pred_ in (("int8", predict_gq), ("bf16", predict_gb)):
        secg8, memg8 = seconds_and_memory(lambda: pred_(srcg, None), n=3)
        print(f"{tag} e2e giant2 {label} B={BATCH} {list(volg.shape)}: "
              f"{secg8 * 1e3:.3f} ms = {BATCH / secg8:.4f} vol/s, peak memory "
              f"{memg8 / 2**20:.1f} MiB above the "
              f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held")
    profile_device(tag, f"one giant2 int8 B={BATCH} forward",
                   lambda: predict_gq(srcg, None), 10)
    del qg, predict_gq, predict_gb, i8_runs, model8, model8s

    # ======================================================================
    # Long slices (queue B rows 12-16): above FUSED_MAX_TOKENS = 512 tokens
    # the callers route to the composed path (`mst_logits` ->
    # `DinoSliceClassifier.forward`), whose attention is `flash_attention`.
    # ======================================================================
    # -- 34. the flash kernels vs plain, and C3's mhsa regions at S = 442 --
    plain_ops = flash_phase(tag, dev, fa, errs)
    fgen = torch.Generator(device=dev).manual_seed(SEED)
    # C3: `mhsa`'s two-pass forward with the LSE (above S = 272 a row's
    # scores do not fit the registers) and `mhsa_bwd`, at S = 442 (ViT-S/14
    # on 294 px slices), [64, 442, 384]
    n442, s442 = 64, 442
    qkv442 = torch.randn(n442 * s442, 3 * E, generator=fgen, device=dev).to(bf)
    o442, lse442 = fb.mhsa(qkv442, n442, s442, HEADS, want_lse=True)
    again = fb.mhsa(qkv442, n442, s442, HEADS, want_lse=True)
    errs["mhsa[S=442,lse]"] = check_outputs(
        tag, "C3 mhsa[S=442,lse]", (o442, lse442),
        fb._mhsa_ref(qkv442, n442, s442, HEADS, want_lse=True),
        KERNEL_GRAD_REL)
    do442 = torch.randn(n442 * s442, E, generator=fgen, device=dev).to(bf)
    d442 = fb.mhsa_bwd(qkv442, o442, do442, lse442, n442, s442, HEADS)
    errs["mhsa_bwd[S=442]"] = check_outputs(
        tag, "C3 mhsa_bwd[S=442]", d442,
        fb._mhsa_bwd_ref(qkv442, o442, do442, lse442, n442, s442, HEADS),
        KERNEL_GRAD_REL)
    check(torch.equal(again[0], o442) and torch.equal(again[1], lse442)
          and torch.equal(fb.mhsa_bwd(qkv442, o442, do442, lse442, n442,
                                      s442, HEADS), d442),
          "C3 at S = 442: a second run gave other bits")
    del qkv442, o442, lse442, do442, d442, again

    # -- 35. 518 px serving on the composed path ---------------------------
    stamp(tag, "35")

    @contextlib.contextmanager
    def plain_flash():
        """Route the composed blocks' attention through the plain versions
        on the card (FLASH_CHUNK slices at a time)."""
        saved = layers.flash_attention
        layers.flash_attention = functools.partial(fa.flash_attention,
                                                   ops=plain_ops)
        try:
            yield
        finally:
            layers.flash_attention = saved

    def spread_long_np(pred, n, px, pool):
        """`spread_long` on `pred`'s probs, as numpy."""
        return spread_long(dev, fgen, lambda x: pred(x, None)[0], n, px,
                           pool).cpu().numpy()

    check(not fused_seq_len_ok(model, PX_LONG, PX_LONG)
          and not fused_seq_len_ok(model, PX_1601, PX_1601),
          "518 / 560 px slices must take the composed path")
    vol518 = spread_long_np(predict, BATCH, PX_LONG, 4 * BATCH)
    per_fwd_long = {**zero, "flash_fwd": n_blocks + 1}  # every block, full
    print(f"{tag} 518 px: S = 1370; the composed path runs all "
          f"{n_blocks + 1} blocks in full (no CLS-only block), one flash_fwd "
          f"each; tolerances as phase 4")
    long_fwd_counts = check_forward(f"518 px forward", model, predict,
                                    vol518, per_fwd_long, zero_calls,
                                    plain=plain_flash)

    # the HTTP server on 518 px POSTs, a padded tail batch included
    n_req = 6
    direct518, _ = predict(vol518[:n_req], None)
    direct518 = direct518.cpu().numpy()

    def post_all(port_, vols_):
        """POST each volume concurrently -> (results, errors)."""
        res, err_ = [None] * len(vols_), []

        def one(i):
            try:
                buf = io.BytesIO()
                np.save(buf, vols_[i])
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port_}/predict", data=buf.getvalue(),
                    method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    res[i] = (r.status, json.loads(r.read()))
            except urllib.error.HTTPError as e:
                res[i] = (e.code, json.loads(e.read()))
            except Exception as e:  # reported by the caller
                err_.append(f"request {i}: {type(e).__name__}: {e}")

        ths = [threading.Thread(target=one, args=(i,))
               for i in range(len(vols_))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=600)
        return res, err_ + [f"request {i} hung" for i, th in enumerate(ths)
                            if th.is_alive()]

    fb.reset_launch_counts()
    server, bp = build_server(args, model)
    try:
        res518, errors = post_all(server.server_address[1], vol518[:n_req])
    finally:
        server.shutdown()
        server.server_close()
        bp.close()
    torch.cuda.synchronize()
    served_long = fb.launch_counts()
    check(not errors and all(r[0] == 200 for r in res518),
          f"518 px requests failed: {errors} {res518}")
    worst = max(float(np.abs(np.asarray(res518[i][1]["probs"])
                             - direct518[i]).max()) for i in range(n_req))
    want = {k_: v_ * bp.batches_run for k_, v_ in per_fwd_long.items()}
    print(f"{tag} server: {n_req} concurrent 518 px POSTs, batch "
          f"{args.batch_size}: batches_run={bp.batches_run} "
          f"max|served-direct|={worst:.6g} (tol {SERVE_TOL}); launches "
          f"{served_long}")
    check(bp.batches_run >= 2 and worst <= SERVE_TOL,
          f"518 px server: {bp.batches_run} batches, {worst}")
    check_launches(served_long, want, "518 px server")

    # batch-1 8-flip TTA, and one S = 1601 volume (the Pallas blocked rows'
    # lengths), each against the plain path
    tta_long = make_predict_fn(model, tta=True, with_saliency=False)
    vol560 = long_volumes(dev, fgen, 1, PX_1601)
    for what, pred_, v_ in (("518 px batch-1 TTA", tta_long, vol518[:1]),
                            ("560 px (S = 1601) forward", predict, vol560)):
        fb.reset_launch_counts()
        pk, _ = pred_(v_, None)
        torch.cuda.synchronize()
        counts = fb.launch_counts()
        with plain_flash():
            pp, _ = pred_(v_, None)
        err = (pk - pp).abs().max().item()
        print(f"{tag} {what}: probs {pk[0].tolist()} max|kernel-plain|="
              f"{err:.6g} (tol {PROB_TOL}); launches {counts}")
        check(bool(torch.isfinite(pk).all()) and err <= PROB_TOL,
              f"{what}: {err}")
        check_launches(counts, per_fwd_long, what)

    # DINOv3 ViT-S/16 at 512 px (S = 1029; RoPE on q and k in torch ops)
    flat3 = random_flax_params(get_model(MODEL3), SEED)
    for key in flat3:
        if key.endswith("/gamma"):
            flat3[key] = (1.0 + 0.1 * rng.standard_normal(flat3[key].shape)
                          ).astype(np.float32)
    model3 = params_from_flax(get_model(MODEL3, dtype=bf), flat3).to(
        dev).eval()
    predict3 = make_predict_fn(model3, with_saliency=False)
    vol3 = spread_long_np(predict3, LONG_B, PX3_LONG, BATCH)
    check_forward("DINOv3 512 px forward", model3, predict3, vol3,
                  per_fwd_long, zero_calls, plain=plain_flash)
    del model3, predict3, flat3, vol3

    # `serve --int8`: a 518 px POST is the caller's fault (HTTP 400, the
    # predictor's ValueError: int8 needs the fused path)
    args8 = parse_args(["--params_npz", str(npz), "--int8", "--port", "0",
                        "--batch_size", "1", "--max_wait_ms", "1"])
    model8 = build_model(args8)
    server, bp = build_server(args8, model8)
    try:
        res8, errors = post_all(server.server_address[1], vol518[:1])
    finally:
        server.shutdown()
        server.server_close()
        bp.close()
    print(f"{tag} serve --int8, one 518 px POST: {res8[0]}")
    check(not errors and res8[0][0] == 400
          and "ValueError" in res8[0][1]["error"],
          f"serve --int8 on 518 px: {res8} {errors}")
    del model8

    # -- 36. the 518 px train step at B=2 ------------------------------------
    stamp(tag, "36")
    largs = cli.parse_args(["--dataset", "Synthetic", "--batch_size",
                            str(LONG_B), "--max_epochs", "1",
                            "--num_train_samples", str(STEP_BATCHES * LONG_B),
                            "--seed", str(SEED)])
    lmodel = cli.build_model(largs)
    params_from_flax(lmodel, random_flax_params(lmodel, SEED))
    with torch.no_grad():
        for name, prm in lmodel.named_parameters():
            if name.endswith(".gamma"):
                prm.copy_(torch.from_numpy(1.0 + 0.1 * rng.standard_normal(
                    tuple(prm.shape))).to(prm))
    ldm = cli.build_datamodule(largs, dev, num_samples=STEP_BATCHES * LONG_B,
                               shape_cdhw=(1, DEPTH_SLICES, PX_LONG, PX_LONG))
    lbatches = [(b_["source"], torch.from_numpy(b_["target"]).to(
        dev, torch.long)) for b_ in ldm.train_dataloader()]
    check(len(lbatches) == STEP_BATCHES and tuple(lbatches[0][0].shape) == (
        LONG_B, 1, DEPTH_SLICES, PX_LONG, PX_LONG), "518 px train batches")
    nl = n_blocks + 1
    per_step_long = {**zero, "flash_fwd": nl, "flash_bwd_dq": nl,
                     "flash_bwd_dkv": nl}

    @contextlib.contextmanager
    def flash_head_fault():
        """the plain path with every head reading the next head's keys and
        values (a head-offset fault)"""
        saved = layers.flash_attention
        layers.flash_attention = lambda q, k, v: fa.flash_attention(
            q, k.roll(1, 1), v.roll(1, 1), ops=plain_ops)
        try:
            yield
        finally:
            layers.flash_attention = saved

    long_step_counts = check_step(
        f"518 px train step, B={LONG_B},", lmodel, lbatches, per_step_long,
        zero_calls, plain=plain_flash, loss_tol=LONG_LOSS_TOL,
        fault=flash_head_fault, oracle=torch.float64)

    # --remat: the same loss and grads, each block's forward run twice
    src_l, tgt_l = lbatches[0]
    loss0, grads0 = loss_and_grads(lmodel, src_l, tgt_l)
    lmodel.remat = True
    try:
        fb.reset_launch_counts()
        loss_r, grads_r = loss_and_grads(lmodel, src_l, tgt_l)
        counts_r = fb.launch_counts()
    finally:
        lmodel.remat = False
    rel_r = rel_errs(grads_r, grads0)
    same = loss_r == loss0 and all(torch.equal(grads_r[n_], grads0[n_])
                                   for n_ in grads0)
    print(f"{tag} 518 px step with remat: loss {loss_r:.8g} (without "
          f"{loss0:.8g}); bit for bit: {same}; grads vs without: "
          f"{summary(rel_r)}; launches {counts_r}")
    check_launches(counts_r, {**per_step_long, "flash_fwd": 2 * nl}, "remat")
    check(abs(loss_r - loss0) <= 1e-6 * abs(loss0)
          and max(rel_r.values()) <= 1e-3,
          f"remat moved the step: {loss_r} vs {loss0}, {summary(rel_r)}")
    del grads0, grads_r

    # --freeze: the encoder under no_grad (forward kernels only), the fusion
    # and head against the plain path
    fargs = cli.parse_args(["--dataset", "Synthetic", "--batch_size",
                            str(LONG_B), "--freeze", "--seed", str(SEED)])
    fmodel = cli.build_model(fargs)
    params_from_flax(fmodel, flax_params_from_torch(lmodel))
    check(fmodel.freeze, f"frozen config {fmodel.config}")
    check_step(f"518 px frozen step, B={LONG_B},", fmodel, lbatches[:1],
               {**zero, "flash_fwd": nl}, zero_calls, plain=plain_flash,
               loss_tol=LONG_LOSS_TOL, oracle=torch.float64)
    del fmodel

    # one B=1 step at 560 px (S = 1601)
    src560 = long_volumes(dev, fgen, 1, PX_1601)
    tgt1 = tgt_l[:1]
    fb.reset_launch_counts()
    loss_k, grads_k = loss_and_grads(lmodel, src560, tgt1)
    counts560 = fb.launch_counts()
    with plain_flash():
        loss_p, grads_p = loss_and_grads(lmodel, src560, tgt1)
    rel560 = rel_errs(grads_k, grads_p)
    print(f"{tag} 560 px (S = 1601) step, B=1: loss kernel path {loss_k:.6g}, "
          f"plain path {loss_p:.6g} (limit {LONG_LOSS_TOL}); grads "
          f"|kernel - plain| / |plain|max: {summary(rel560)} (limit "
          f"{STEP_GRAD_REL}); launches {counts560}")
    check(abs(loss_k - loss_p) <= LONG_LOSS_TOL
          and max(rel560.values()) <= STEP_GRAD_REL, "560 px step")
    check_launches(counts560, per_step_long, "560 px")
    del grads_k, grads_p

    # AdamW steps on one batch: the loss falls, and the paths agree
    fit_k = fit_losses(lmodel, src_l, tgt_l)
    with plain_flash():
        fit_p = fit_losses(lmodel, src_l, tgt_l)
    track = max(abs(a_ - b_) for a_, b_ in zip(fit_k, fit_p))
    print(f"{tag} 518 px fit one batch, {FIT_STEPS} AdamW steps at lr "
          f"{FIT_LR}: kernel path {[round(v_, 5) for v_ in fit_k]}, plain "
          f"path {[round(v_, 5) for v_ in fit_p]}; max |kernel - plain| "
          f"{track:.6g} (limit {FIT_TRACK_TOL})")
    check(all(map(math.isfinite, fit_k)) and fit_k[-1] < fit_k[0],
          f"518 px fit: the loss did not fall: {fit_k}")
    check(track <= FIT_TRACK_TOL, f"518 px fit: the paths part: {track}")

    # -- 37. long-slice times (the flash kernels' own: phase 44) --------------
    stamp(tag, "37")
    src518 = torch.from_numpy(vol518).to(dev)
    sec_l, mem_l = seconds_and_memory(lambda: predict(src518, None), n=5)
    print(f"{tag} e2e 518 px B={BATCH} {list(src518.shape)} bf16: "
          f"{sec_l * 1e3:.3f} ms = {BATCH / sec_l:.4f} vol/s, peak memory "
          f"{mem_l / 2**20:.1f} MiB above the "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held")
    profile_device(tag, f"one 518 px B={BATCH} forward",
                   lambda: predict(src518, None), 10)
    lstep = make_train_step(TrainState(lmodel, make_optimizer(
        lmodel.parameters(), 1e-6)))
    sec_s, mem_s = seconds_and_memory(lambda: lstep(src_l, tgt_l), n=5)
    print(f"{tag} e2e 518 px train step B={LONG_B} {list(src_l.shape)}: "
          f"{sec_s * 1e3:.3f} ms = {LONG_B / sec_s:.4f} vol/s, peak memory "
          f"{mem_s / 2**20:.1f} MiB above the "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held")
    profile_device(tag, f"one 518 px B={LONG_B} train step",
                   lambda: lstep(src_l, tgt_l), 10)
    del lstep, lmodel, lbatches, ldm, src518, vol518, src560, vol560

    # ======================================================================
    # The tools/ experiments (queue B rows 17-21): their kernels and chains
    # ======================================================================
    tool_entries = tools_phases(tag, dev)

    # ======================================================================
    # Phase 40: `ln_gemm` / `ln_gemm_swiglu` redesigned (`ln_rows` + wgmma)
    # ======================================================================
    perrs, ptimed, pcost, plib = ln_gemm_phase(tag, dev, fb, _build.lib)
    errs.update(perrs)
    # the earlier phases' readings of the same cases stand in the kernels
    # line; phase 40 adds `ln_rows` and the other widths
    for mine, theirs in ((cost, pcost), (lib_ms, plib)):
        for key, val in theirs.items():
            mine.setdefault(key, val)

    # ======================================================================
    # Phase 41: `gemm_dgrad` / `gemm_wgrad` redesigned (the wgmma mainloop)
    # ======================================================================
    berrs, btimed, bcost, blib = bwd_gemm_phase(tag, dev, fb)
    errs.update(berrs)
    lib_ms.update(blib)  # the library calls for the same work
    for key, val in bcost.items():
        cost.setdefault(key, val)

    # ======================================================================
    # Phase 42: `gemm_residual` / `gemm_dls` redesigned (the wgmma mainloop)
    # ======================================================================
    residual_gemm_phase(tag, dev, fb)
    qtimed, qcost, qlib = residual_times(tag, dev, fb)
    lib_ms.update(qlib)  # the library calls for the same work
    for key, val in qcost.items():
        cost.setdefault(key, val)

    # ======================================================================
    # Phase 43: `mhsa` / `mhsa_bwd` redesigned (TMA + wgmma, scores in
    # registers); the kernels line's times of every attention form
    # ======================================================================
    attn_phase(tag, dev, fb)
    atimed, acost, alib = attn_times(tag, dev, fb)
    lib_ms.update(alib)
    for key, val in acost.items():
        cost.setdefault(key, val)

    # ======================================================================
    # Phase 44: the flash kernels redesigned (TMA + wgmma, K/V streamed);
    # the kernels line's flash times
    # ======================================================================
    ftimed, fcost, flib = flash_times(tag, dev, fa)
    lib_ms.update(flib)
    cost.update(fcost)

    # ======================================================================
    # Phase 45: `ln_pullback` and `ln_gemm_i8` redesigned (one-pass row
    # kernel; ln_quant_rows + the int8 wgmma GEMM); the kernels line's
    # times of both
    # ======================================================================
    ltimed, lcost, llib = pullback_i8_phase(tag, dev, fb, fq, layers)
    lib_ms.update(llib)
    cost.update(lcost)

    # ======================================================================
    # Phase 46: `gemm_i8_residual` redesigned (the int8 wgmma mainloop with
    # `gemm_residual`'s epilogue); the kernels line's times of it
    # ======================================================================
    i8_residual_phase(tag, dev, fq, layers, _build.lib())
    xtimed, xcost, xlib = i8_residual_times(tag, dev, fq, layers)
    lib_ms.update(xlib)
    cost.update(xcost)

    # ======================================================================
    # Phase 47: `quant_rows` redesigned (rows read once through a ring of
    # TMA bulk copies); the kernels line's times of it
    # ======================================================================
    quant_rows_phase(tag, dev, fq, _build.lib(), errs)
    qrtimed, qrcost, qrlib, qrgraph = quant_rows_times(tag, dev, fq)
    lib_ms.update(qrlib)
    cost.update(qrcost)

    # ======================================================================
    # Phase 48: the host data path (datasets, native decode, the device
    # augmentation, padding masks into the train step)
    # ======================================================================
    data_phase(tag, dev, fb, per_step)

    # ======================================================================
    # Phase 49: the train CLI's remaining single-card options (the decode
    # cache, --resume, LR schedules, --pretrained_path, --profile_dir)
    # ======================================================================
    train_options_phase(tag, dev, fb, per_step, per_fwd3)

    # ======================================================================
    # Phase 50: the CLIs' remaining single-card options (Adafactor,
    # accumulation, --freeze --int8, predict's segmentation, PNGs, ensembles)
    # ======================================================================
    cli_options_phase(tag, dev, fb, per_step, plain_train_sublayers,
                      (gmodel_u, tsrcg, ttgtg))

    # ======================================================================
    # Phase 51: the last two model families (the 3D ResNet50, MST-ResNet34;
    # ViT-S/14 with the average, linear, RoPE and LiRE slice fusions)
    # ======================================================================
    model_families_phase(tag, dev, fb, per_fwd, per_step, plain_sublayers,
                         plain_train_sublayers)

    # ======================================================================
    # Phase 52: the serving artifacts (`python -m mst_tpu_torch.export`,
    # `serve --exported`)
    # ======================================================================
    export_phase(tag, dev, fb, run_dir)

    # ======================================================================
    # Phase 53: saliency above 512 tokens (the composed path's CLS row,
    # rollout carry and Abnar factor on the flash forward's LSE)
    # ======================================================================
    serrs_l, stimed_l, scost_l, sal_long = long_saliency_phase(tag, dev)
    errs.update(serrs_l)
    cost.update(scost_l)

    # TPU kernels: _attn_any_kernel at fused_block.py:326, _mlp_kernel at
    # :400, their train forwards _attn_train_kernel :424 and
    # _mlp_train_kernel :470, the backwards _attn_bwd_kernel :680 and
    # _mlp_bwd_kernel :841. Each CUDA kernel replaces a part of several.
    site = "mst_tpu/ops/fused_block.py:{}".format
    isite = "mst_tpu/ops/fused_int8.py:{}".format
    asite = "mst_tpu/ops/attention.py:{}".format
    lsite = "mst_tpu/models/layers.py:{}".format
    ssite = "mst_tpu/ops/saliency.py:{}".format
    fwd_sites = [site(326), site(400), site(424), site(470)]
    bwd_sites = [site(680), site(841)]
    sites = {
        # name: (source, replaces, launches of its main path, timed cases)
        # `ln_gemm`'s times include its `ln_rows` launch; `ln_rows` (the LN
        # of every fused-block Pallas body) also stands alone, twice per
        # ViT-S block
        "ln_gemm": ("ln_gemm", fwd_sites, served_counts,
                    ["ln_gemm[qkv]", "ln_gemm[fc1,gelu_tanh]"]),
        "ln_rows": ("ln_gemm", fwd_sites + [site(534), site(498)],
                    served_counts, ["ln_rows[E=384]", "ln_rows[E=384]"]),
        "mhsa": ("mhsa", [site(326), site(424)], served_counts, ["mhsa"]),
        "gemm_residual": ("gemm_residual", fwd_sites, served_counts,
                          ["gemm_residual[proj,ls]", "gemm_residual[fc2,ls]"]),
        "gemm_dls": ("gemm_residual", bwd_sites, step_counts,
                     ["gemm_dls[proj]", "gemm_dls[fc2]"]),
        "gemm_wgrad": ("gemm_wgrad", bwd_sites, step_counts,
                       ["gemm_wgrad[proj]", "gemm_wgrad[qkv]",
                        "gemm_wgrad[fc2]", "gemm_wgrad[fc1]"]),
        "gemm_dgrad": ("gemm_dgrad", bwd_sites, step_counts,
                       ["gemm_dgrad[proj]", "gemm_dgrad[fc2,gelu_tanh]",
                        "gemm_dgrad[qkv,ln]", "gemm_dgrad[fc1,ln]"]),
        "mhsa_bwd": ("mhsa_bwd", [site(680)], step_counts, ["mhsa_bwd"]),
        # the saliency outputs of `mhsa` (flags of _attn_any_kernel), each
        # counted in the forward of the plane mode that runs it (phase 12)
        "mhsa_with_row": ("mhsa", [site(1479)], sal_counts["with_row"],
                          ["mhsa_with_row"]),
        "mhsa_rollout": ("mhsa", [site(1535)], sal_counts["rollout"],
                         ["mhsa_rollout[block1,row]"]),
        "mhsa_abnar": ("mhsa", [site(1503)], sal_counts["rollout_abnar"],
                       ["mhsa_abnar"]),
        # the RoPE forms (the `has_rope` flag), counted on the DINOv3 paths
        # (phases 16-18) at S = 201
        "mhsa_rope": ("mhsa", [site(396), site(1435), site(424)],
                      fwd3_counts, ["mhsa_rope"]),
        "mhsa_with_row_rope": ("mhsa", [site(1582)], sal3_counts["with_row"],
                               ["mhsa_with_row_rope"]),
        "mhsa_rollout_rope": ("mhsa", [site(1535)], sal3_counts["rollout"],
                              ["mhsa_rollout_rope[block1,row]"]),
        "mhsa_abnar_rope": ("mhsa", [site(1503)],
                            sal3_counts["rollout_abnar"], ["mhsa_abnar_rope"]),
        "mhsa_bwd_rope": ("mhsa_bwd", [site(680)], step3_counts,
                          ["mhsa_bwd_rope"]),
        # the gated mode of `ln_gemm`, counted on the giant2 serving forward
        # (phase 22) at E = 1536, F = 4096
        "ln_gemm_swiglu": ("ln_gemm", [site(534), site(1393)], fwdg_counts,
                           ["ln_gemm_swiglu[w12]"]),
        # row 6 and its backward's new kernels, counted on the unfrozen
        # giant2 step with remat (phase 28): the gated mode's train form
        # (`_swiglu_train_kernel`), the SiLU-gate epilogue of `gemm_dgrad`
        # (XLA's `_swiglu_train_bwd` :1284 in JAX) and the LN pullback of
        # every width but 384 (the last step of `_attn_bwd_kernel` and
        # `_mlp_bwd_kernel`, and of the XLA backwards at E > 1024)
        "ln_gemm_swiglu_train": ("ln_gemm", [site(498), site(1263)],
                                 stepu_counts, ["ln_gemm_swiglu_train[w12]"]),
        "gemm_dgrad_swiglu": ("gemm_dgrad", [site(498), site(1284)],
                              stepu_counts, ["gemm_dgrad_swiglu[w3]"]),
        "ln_pullback": ("gemm_dgrad", [site(680), site(841), site(1284)],
                        stepu_counts, ["ln_pullback[E=1536]"]),
        # queue B rows 9-11, counted on the `serve --int8 --run_folder`
        # server (dynamic scales, phase 32) and, for the gated mode, the
        # giant2 int8 forward (phase 33); one ViT-S block's calls timed
        "ln_gemm_i8": ("ln_gemm_i8", [isite(389), isite(471)], served8_counts,
                       ["ln_gemm_i8[qkv]", "ln_gemm_i8[fc1,gelu_tanh]"]),
        # the LN half of `ln_gemm_i8` / `ln_gemm_i8_swiglu` (the LN and
        # quantization of rows 9-11's bodies), twice per ViT-S block
        "ln_quant_rows": ("ln_gemm_i8", [isite(389), isite(471), isite(508)],
                          served8_counts, ["ln_quant_rows[E=384]",
                                           "ln_quant_rows[E=384]"]),
        "ln_gemm_i8_swiglu": ("ln_gemm_i8", [isite(508)], fwdg8_counts,
                              ["ln_gemm_i8_swiglu[w12]"]),
        "quant_rows": ("quant_rows", [isite(389), isite(471), isite(508)],
                       served8_counts, ["quant_rows[o]", "quant_rows[u]"]),
        "gemm_i8_residual": ("gemm_i8_residual",
                             [isite(389), isite(471), isite(508)],
                             served8_counts, ["gemm_i8_residual[proj,ls]",
                                              "gemm_i8_residual[fc2,ls]"]),
        # queue B rows 12-16, counted on the composed path above 512
        # tokens: the 518 px server's batches (phase 35) and the B=2 518 px
        # train step (phase 36); one flash_fwd call at B=8 and one backward
        # pair at B=2 timed
        "flash_fwd": ("flash_fwd", [asite(152), asite(96)], served_long,
                      ["flash_fwd[B8,S=1370]"]),
        "flash_bwd_dq": ("flash_bwd", [asite(340), asite(305)],
                         long_step_counts, ["flash_bwd_dq[B2,S=1370]"]),
        "flash_bwd_dkv": ("flash_bwd", [asite(372), asite(305)],
                          long_step_counts, ["flash_bwd_dkv[B2,S=1370]"]),
        # no TPU kernel: XLA's reductions of the probabilities that the
        # flax path sows above 512 tokens (`attention_reference` in
        # `Attention.__call__`), counted on the 518 px B=8 saliency forward
        # of their plane mode (phase 53)
        "flash_row": ("flash_sal", [lsite(148), ssite(44)], sal_long["last"],
                      ["flash_row[B8,S=1370]"]),
        "flash_carry": ("flash_sal", [lsite(148), ssite(89)],
                        sal_long["rollout"], ["flash_carry[B8,S=1370]"]),
        "flash_abnar": ("flash_sal", [lsite(148), ssite(119)],
                        sal_long["rollout_abnar"],
                        ["flash_abnar[B8,S=1370]"]),
    }
    alltimed = {**timed, **ttimed, **stimed, **rtimed, **gtimed, **utimed,
                **itimed, **ftimed}
    for key, val in ptimed.items():
        alltimed.setdefault(key, val)
    alltimed.update(btimed)
    alltimed.update(qtimed)
    alltimed.update(atimed)
    alltimed.update(ltimed)
    alltimed.update(xtimed)
    alltimed.update(qrtimed)
    alltimed.update(stimed_l)
    print(f"{tag} bound: the larger of FLOPs / {PEAK_FLOPS:.4g} FLOP/s + "
          f"int8 operations / {PEAK_INT8:.4g} OP/s and bytes / "
          f"{PEAK_BYTES:.4g} B/s (each input read once, each output written "
          f"once); library: the PyTorch call(s) of the same function (the "
          f"GEMMs' with their epilogues in torch ops, phases 41-42)")

    def work(costs):
        """'x GFLOP[, y G int8 operations], z MB' of summed costs."""
        ops = sum(c[2] for c in costs if len(c) > 2)
        return (f"{sum(c[0] for c in costs) / 1e9:.3f} GFLOP, "
                + (f"{ops / 1e9:.3f} G int8 operations, " if ops else "")
                + f"{sum(c[1] for c in costs) / 1e6:.2f} MB")

    for name in sorted(c for c in alltimed if c in cost):
        b_ms, b_by = bound([cost[name]])
        lib = f"{lib_ms[name]:.4f} ms" if name in lib_ms else "none"
        print(f"{tag} case {name}: kernel {alltimed[name][0]:.4f} ms, plain "
              f"{alltimed[name][1]:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
              f"({work([cost[name]])}), library {lib}")
    # queue B's rows: each TPU kernel's chain of CUDA kernels, one block at
    # B=8 (ViT-S at S = 257; DINOv3 ViT-S/16 at S = 201; giant2 at E = 1536)
    rows = {
        "1 attention sub-layer": ["ln_gemm[qkv]", "mhsa",
                                  "gemm_residual[proj,ls]"],
        "1'a + CLS row": ["ln_gemm[qkv]", "mhsa_with_row",
                          "gemm_residual[proj,ls]"],
        "1'b + rollout carry": ["ln_gemm[qkv]", "mhsa_rollout[block1,row]",
                                "gemm_residual[proj,ls]"],
        "1'c + Abnar factor": ["ln_gemm[qkv]", "mhsa_abnar",
                               "gemm_residual[proj,ls]"],
        "2 MLP sub-layer": ["ln_gemm[fc1,gelu_tanh]", "gemm_residual[fc2,ls]"],
        "4 attention train forward": ["ln_gemm_train[qkv]", "mhsa_train",
                                      "gemm_residual[proj,ls]"],
        "5 MLP train forward": ["ln_gemm_train[fc1,gelu_tanh]",
                                "gemm_residual[fc2,ls]"],
        "7 attention backward": ["gemm_dls[proj]", "gemm_wgrad[proj]",
                                 "gemm_dgrad[proj]", "mhsa_bwd",
                                 "gemm_wgrad[qkv]", "gemm_dgrad[qkv,ln]"],
        "8 MLP backward": ["gemm_dls[fc2]", "gemm_wgrad[fc2]",
                           "gemm_dgrad[fc2,gelu_tanh]", "gemm_wgrad[fc1]",
                           "gemm_dgrad[fc1,ln]"],
        "1-rope attention sub-layer (S = 201)": [
            "ln_gemm[qkv,S=201]", "mhsa_rope", "gemm_residual[proj,ls,S=201]"],
        "1'a-rope + CLS row": ["ln_gemm[qkv,S=201]", "mhsa_with_row_rope",
                               "gemm_residual[proj,ls,S=201]"],
        "1'b-rope + rollout carry": ["ln_gemm[qkv,S=201]",
                                     "mhsa_rollout_rope[block1,row]",
                                     "gemm_residual[proj,ls,S=201]"],
        "1'c-rope + Abnar factor": ["ln_gemm[qkv,S=201]", "mhsa_abnar_rope",
                                    "gemm_residual[proj,ls,S=201]"],
        "4-rope attention train forward": ["ln_gemm_train[qkv,S=201]",
                                           "mhsa_rope_train",
                                           "gemm_residual[proj,ls,S=201]"],
        "7-rope attention backward": [
            "gemm_dls[proj,S=201]", "gemm_wgrad[proj,S=201]",
            "gemm_dgrad[proj,S=201]", "mhsa_bwd_rope",
            "gemm_wgrad[qkv,S=201]", "gemm_dgrad[qkv,ln,S=201]"],
        "1 attention sub-layer, giant2 (E = 1536, 24 heads)": [
            "ln_gemm[qkv,E=1536]", "mhsa[E=1536]",
            "gemm_residual[proj,E=1536,ls]"],
        "3 SwiGLU sub-layer, giant2 (F = 4096)": ["ln_gemm_swiglu[w12]",
                                                  "gemm_residual[w3,ls]"],
        "6 SwiGLU train forward, giant2": ["ln_gemm_swiglu_train[w12]",
                                           "gemm_residual[w3,ls]"],
        "6 SwiGLU backward (the XLA _swiglu_train_bwd), giant2": [
            "gemm_dls[w3]", "gemm_wgrad[w3]", "gemm_dgrad_swiglu[w3]",
            "gemm_wgrad[w12]", "gemm_dgrad[w12,ln]"],
        "9 int8 attention sub-layer (dynamic)": [
            "ln_gemm_i8[qkv]", "mhsa", "quant_rows[o]",
            "gemm_i8_residual[proj,ls]"],
        "9 int8 attention sub-layer (static)": [
            "ln_gemm_i8[qkv,static]", "mhsa", "quant_rows[o,static]",
            "gemm_i8_residual[proj,ls,static]"],
        "10 int8 MLP sub-layer (dynamic)": [
            "ln_gemm_i8[fc1,gelu_tanh]", "quant_rows[u]",
            "gemm_i8_residual[fc2,ls]"],
        "10 int8 MLP sub-layer (static)": [
            "ln_gemm_i8[fc1,gelu_tanh,static]",
            "gemm_i8_residual[fc2,ls,static]"],
        "11 int8 SwiGLU sub-layer, giant2 (dynamic)": [
            "ln_gemm_i8_swiglu[w12]", "quant_rows[g]",
            "gemm_i8_residual[w3,ls]"],
        "11 int8 SwiGLU sub-layer, giant2 (static)": [
            "ln_gemm_i8_swiglu[w12,static]",
            "gemm_i8_residual[w3,ls,static]"],
        "12-13 flash forward, 518 px B=8 (S = 1370)": ["flash_fwd[B8,S=1370]"],
    }
    for label, chain in rows.items():
        b_ms, b_by = bound([cost[c] for c in chain])
        lib = (f"{sum(lib_ms[c] for c in chain):.4f} ms"
               if all(c in lib_ms for c in chain) else "none")
        print(f"{tag} row {label}: kernels {sum(alltimed[c][0] for c in chain):.4f}"
              f" ms, plain {sum(alltimed[c][1] for c in chain):.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by} ({work([cost[c] for c in chain])}), "
              f"library {lib} ({' + '.join(chain)})")
    kernels = []
    for name, (source, replaces, counts, per_block) in sites.items():
        checked = [c for c in errs if c.split("[")[0] in
                   (name, name + "_train")]
        steps = (step3_counts if name.endswith("_rope") else stepg_counts
                 if name == "ln_gemm_swiglu" else stepu_counts
                 if name in ("ln_gemm_swiglu_train", "gemm_dgrad_swiglu",
                             "ln_pullback") else long_step_counts
                 if name.startswith("flash") else step_counts)
        bound_ms, bound_by = bound([cost[c] for c in per_block])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mst_tpu_torch/csrc/{source}.cu",
            "replaces": replaces[0], "also_replaces": replaces[1:],
            "launches": counts[name],
            "launches_per_train_step": steps[name],
            "max_abs_err": max(errs[c] for c in checked),
            # one ViT-S block's calls of this kernel at B=8 (serving
            # forward for ln_gemm, mhsa, gemm_residual and the saliency
            # outputs, train backward for the rest)
            "ms": sum(alltimed[c][0] for c in per_block),
            "plain_ms": sum(alltimed[c][1] for c in per_block),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": (sum(lib_ms[c] for c in per_block)
                           if all(c in lib_ms for c in per_block) else None),
        })
        if name == "quant_rows":
            # the same calls replayed from a CUDA graph (phase 47)
            kernels[-1]["graph_ms"] = sum(qrgraph[c] for c in per_block)
    kernels += tool_entries
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

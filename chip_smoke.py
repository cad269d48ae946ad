#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this checkout; imports nothing of JAX or
of ``feartracker_tpu``. Phases, each printing its own lines:

1. the card: ``nvidia-smi`` name and power limit;
2. build the kernels from ``feartracker_tpu_torch/csrc``, one ``nvcc`` per
   source started together, and beside them the host codecs (``*.cpp``),
   one ``g++`` each (seconds, ptxas registers and spills);
3. K1 against its plain twins on the card: the batched step's decode
   region (``decode_step_cuda`` against ``decode_step_plain``) at S=1, 128
   and 300, with float32 and bfloat16 head outputs, both ``smooth`` modes
   and the edge cases of ``tests/test_torch_decode.py`` (a tie on the peak,
   a rescale on exactly .5, boxes past each frame edge and both min-side
   fix-ups, an all-NaN map), and a channel-first ``reg``: coords equal,
   frame boxes within 1 px (the count of boxes that differ at all printed),
   APCE rtol 1e-5; then the decode alone (``postprocess_cuda``) at S=128,
   both ``smooth`` modes and a tie-break case; 3b: K3 (the crop kernel)
   against its plain twin on the card, bit for bit, at S=128 on 1280x720
   frames (uint8, uint8 shared with stream stride 0, float32, uint8 at
   W-major strides) with ``tests/test_torch_crop_kernel.py``'s edge-case
   windows, -> 256² and 128², float32 and bfloat16 output; then its time
   beside its bound (bytes), its twin's and the "mm" and "gather" routes'
   (crop, normalize and cast as the tracker ran them);
4. K2 (fused inverted-residual block) against its plain twin on the card,
   every FEAR-XS block with expansion > 1 at its search (256²) and template
   (128²) shapes, S=8, in float32 and bfloat16 (bfloat16 at every tile that
   takes the shape, its shared memory equal to the planner's count); then
   every such block of the FEAR-M and FEAR-L trunks at both shapes, S=2;
   float32 also at S=1, each shape at the planner's chunk groups G, at G=1
   and at one chunk a group, its shared memory equal to the Python count;
5. the tracking slice with the packaged ``fear_xs.npz``: float32 at S=4,
   T=8 against the same port on the CPU; then bfloat16 at S=128, T=16, with
   the kernels' launch counts over ``init`` + one ``track`` and the time per
   ``track`` call; 5c: one ``track`` call traced, device time by kernel
   family, kernels per frame and the idle share (the profiler slows the
   host, so the traced span is longer than an untraced call);
6. each kernel's time beside its plain twin and its bound at the main
   path's shapes (S=128; K2 at every block's 256² and 128² shape in
   bfloat16, each also held against its plain twin there, with the
   planner's tile, the blocks per SM and the time at every tile that fits);
   K1's decode region (bf16 head outputs) and the decode alone (f32) beside
   the region's plain chain, its bound and the card's launch floor, an
   empty kernel on the same timer;
7. the dual-template path: float32 at S=4, T=8 against the port on the CPU
   in each update mode (``ema``; ``gated`` with ``fear_xs_gate.npz``;
   ``feature`` with ``fear_xs_feature_gate.npz`` and zoom-out recovery);
   then bfloat16 at S=128, T=16 in ``feature`` mode with
   ``update_interval=4`` and recovery, with the launch counts over ``init``
   + one ``track`` (a refresh frame runs K2 13 more times, at 128²), the
   time per ``track`` call, and (7c) one traced call by kernel family;
8. the ``StreamPool`` slot server at capacity 128 fed host numpy frames:
   128 ``add``s, three serial steps (with their own launch counts), three
   ``step_async`` calls back to back that must not wait for the card,
   pipelined = serial, ``step_chunk`` = ``track``, blank frames
   re-templated under ``reinit``, and a 3 s pipelined online run at 30 fps,
   depth 2;
9. the sequential tracker ``FEARTracker`` (S=1) on a 30-frame 480×256
   clip rendered with numpy: ``get_extended_crop`` on the card equal to the
   CPU byte for byte; 9c: K2 at all 26 FEAR-XS block shapes and K1 (the
   decode alone, both ``smooth`` modes) at S=1 against their plain twins,
   with their times and bounds (a line per float32 block: kernel and plain
   ms, the bound and its term, the kernel's share, G, blocks per SM), and
   K1's decode region at S=1 beside its plain chain, bound and the launch
   floor; 9d: float32 boxes within 1
   px of the CPU port in the static, dual-EMA (``update_interval=4``) and
   recovery configurations, with the launch counts over ``initialize`` +
   29 updates, and the static one again under torch's TF32 defaults; 9f:
   ``update`` wall p50/p99, device busy time and ``initialize`` time in
   float32 and bfloat16; 9g: the OPE, VOT and batched protocols on two
   24-frame clips, card against CPU, in float32; 9h: the bfloat16 path end
   to end: ``track`` at S=2, T=8 on the card against the port in bfloat16
   on the CPU and against the card's float32 boxes (``BF16_BOX_PX``), and
   9g's protocols in bfloat16, card against CPU (AO within 0.02, VOT
   failures within one);
10. ``scan_unroll`` (CUDA graphs of K steps) and the remaining entry points:
   10a the static path bf16 S=128 T=16 at K=4 and K=16 against eager, two
   chunks (boxes, confidence, every output and the state; call 1's outputs
   unchanged after call 2), then one more call counted from 0: its graphs'
   replays launch K1 T and K2 13·T times, the wrappers none (a wrapper's
   counter goes up at capture, where a kernel is recorded as a graph node
   and nothing runs); 10b the dual path of 7b at K=4 from ``start_step`` 0
   and 1; 10c float32 S=4 T=8 at K=4 (K2's chunk split, so its tickets,
   inside the graph) against the eager card run and the CPU; 10d ms per
   ``track`` eager against K=4 and K=16 in turns; 10e ``python -m
   feartracker_tpu_torch.bench`` with a short protocol in its own process;
   10f ``FEARTracker`` with ``native_preprocess`` on phase 9's clip (20
   updates), card against CPU, and its update's wall p50 and traced kernels
   beside the cv2-exact crop's;
11. the deployment surfaces: 11a both exported pairs (``convert/export.py``,
   float32 and bfloat16, exported on the card from ``fear_xs.npz``) against
   the eager folded path on seeded crops (equal bit for bit: both run the
   same kernels on the same folded weights), each exported call launching
   K2 13 times through its
   operator, the ms of an exported ``tracker`` call against the eager
   path's at S=1, and the operator's dispatcher cost per call against the
   wrapper's (the main path, 5b, calls the wrapper: no operator calls
   there); 11b ``ExportedTracker`` on phase 9's clip and two more seeds
   against ``FEARTracker`` on the card (each pair within 1 px of the
   tracker in its own dtype; the quantized pair within ``BF16_BOX_PX`` of
   the f32 tracker, the spread over the seeds printed), K1 once a frame;
   11c ``python -m feartracker_tpu_torch.demo --device cuda`` in its own
   process on that clip as ``.npy`` (the final box equal to
   ``FEARTracker``'s) and with two objects on ``--runtime scan`` (object 0
   within 1 px of it), each
   also run in-process for its launch counts; 11d a seeded reference-named
   state dict saved as a Lightning ``.ckpt``, loaded through
   ``load_variables``, ``track`` f32 at S=4, T=8 card against CPU (1 px);
12. training, which runs neither kernel (the step trains the unfolded model
   with BatchNorm in train mode), then hands its module to the tracker,
   which runs both: 12a one float32 Adam step of FEAR-XS from
   ``fear_xs.npz`` at B=8, 256²/128², card against CPU with TF32 off (loss
   rtol 1e-4, running statistics rtol 1e-4; the gradient, printed against
   the CPU's, held to the same step in float64 on the CPU: within 1e-3 of
   the gradient's max, 5e-2 of each tensor's own); 12b ``python -m feartracker_tpu_torch.tools.train_profile
   --batches 32,64,128`` in its own process, bfloat16 (its JSON lines
   printed; each loss finite and lower after 4 steps on its fixed batch
   than at the first); 12c the card's data path: a CSV dataset of
   numpy-rendered ``.npy`` frames → ``SiameseTrackingDataset`` in staged
   mode → ``BatchLoader`` → ``prefetch_to_device`` → the step with device
   augmentations, B=32, 4 steps, bfloat16 (neither kernel launched), the
   loader's host ms per batch beside the step's ms, and ``augment_batch``
   on the card against the CPU with the same drawn parameters (pixels rtol
   1e-4); 12d a checkpoint saved after 12c, restored into a fresh state,
   and one more step from each under ``cudnn.deterministic``: equal bit for
   bit; 12e the trained module in ``FEARTracker`` on the card, float32:
   K1 once and K2 13 times an update, boxes on phase 9's clip within 1 px
   of the same module on the CPU;
13. the training loop, ``train/loop.py``, at FEAR-XS's full width: 13a
   ``load_config`` with the overrides on the card host (no PyYAML;
   ``save_config`` reads back equal); 13b ``Trainer.fit``: backend gpu
   (bfloat16), warm start from ``fear_xs.npz`` (a full transfer), device
   augmentations over phase 12c's ``.npy`` clips on 8 loader threads,
   B=32, 3 steps an epoch, 2 epochs, the frame-offset curriculum from
   epoch 1, validation over three rendered 20-frame clips held in memory
   (each its own dataset; the sanity check runs all three): 6 steps with
   finite losses, launches 0/0 in the steps and K1 once and K2 13 times
   an update (K2 13 more an ``initialize``) in validation, the curriculum
   moved, ``train/loss`` at every step and ``valid/metrics/box_iou`` at
   every epoch in the event log, the top-2 checkpoints plus ``last``; the
   loop's ms a step beside 12b's step alone at B=32, the loader wait,
   validation ms an update, checkpoint save ms; 13c ``validate()`` card
   against a CPU ``Trainer`` on the warm start (per-sequence mean IoU
   within 0.02); 13d ``ScanTracker.set_variables`` bf16, eager and with
   ``scan_unroll=4`` graphs captured before the swap, each bit-equal to a
   fresh tracker on the new weights; 13e ``resume=True, max_epochs=3``:
   one more epoch, its epoch from the checkpoint's metadata; 13f
   ``_validate_batched`` at ``val_streams=2`` (K1 a frame, K2 13 a frame
   and an init; mean IoU within 0.1 of the sequential); 13g ``python -m
   feartracker_tpu_torch.train`` in its own process, 1 epoch of 2 steps;
14. data parallelism and stream sharding on the one card: 14a the
   data-parallel step (``make_train_step(mesh=group)``) over a group of one
   process on NCCL against the no-group step, bf16 B=32, 3 Adam steps on
   12c's staged batch under ``cudnn.deterministic``: equal bit for bit,
   launches 0/0, the step's ms beside the no-group step's; 14d
   ``ShardedScanTracker`` bf16 S=128 T=16 over ``[cuda:0]`` and ``[cuda:0,
   cuda:0]``, eager and ``scan_unroll=4``: N=1 bit-equal to ``ScanTracker``,
   N=2 within phase 9h's 6 px (f32 S=4 T=8 within 1e-3 px), K1 N and K2 13·N
   a frame, ms a call; ``StreamPool`` at capacity 128 over N=2 against the
   pool over ``ScanTracker``, 20 steps; then two processes on ``cuda:0``
   over Gloo (``python3 chip_smoke.py --dp-worker``; NCCL refuses two ranks
   on one card): 14b one float32 SGD step on the same 8 items each against
   one process's step (local BatchNorm statistics: atol 1e-6 / 2e-5; with
   cross-process statistics printed), bf16 Adam on different halves of 12c's
   batch for 3 steps, the ranks bit-identical; 14c ``Trainer.fit`` with
   ``backend=gpu_dp``, ``num_devices`` 2 (16 a process), 1 epoch of 3
   steps, the sanity check and validation over 13b's three clips as one
   dataset: launches 0/0 in the steps, K1/K2 summed over the ranks equal to
   one process's, the sanity rows gathered equal 13c's one-process rows,
   one event file and rank 0's checkpoints, the ranks bit-identical;
15. the measuring tools (``feartracker_tpu_torch/tools``) through their
   ``main`` in-process, FEAR-XS bf16 from ``fear_xs.npz`` at S=128, each
   counted into ``launches_by_path``: 15a ``roofline`` at T=16, eager and
   ``--scan_unroll 4`` (every share at most 100%; one step counted on the
   card with the xla trunk equal to the CPU's count × S), the bound and the
   unit that sets it; 15b ``recovery_throughput``, contexts 0 and 3,
   ``overhead_pct``; 15c ``fused_trunk_bench``: the xla and fused trunks'
   boxes on rendered clips (9g's and four more) at S=8 T=16 in bf16: each
   trunk on the card within 9h's 6 px of itself on the CPU (K2 against its
   twin); the fused trunk within 9h's 6 px of the card's f32 boxes and the
   trunks within 6 px of each other, unless the CPU's bf16 paths, which run
   no kernel of the port, are past 6 px there too (then printed as bf16's
   drift); f32 at S=4 T=8 within 1 px; both trunks timed at T=16 with K2
   launches a call 0 and 13·T; 15d
   ``ir_block_micro``, all 16 blocks, K2 against its twin (atol 0.15 or
   2^-5 of the block's max|out|), the sums beside phase 6's; 15e
   ``loader_throughput`` on 12c's clips, B=32, 8 threads, ``device_augs``
   with and without the cache (2 batches each), with ``--step``; 15f ``export_weights`` of
   12d's checkpoint, the ``.npz`` through ``build_scan_tracker`` against a
   tracker on the checkpoint's model: 0.0 px; and the xla trunk's
   ``scan_unroll=4`` graphs after ``set_variables`` to that model equal to a
   fresh tracker's;
16. the scenario suites and the ablation and probe tools
   (``feartracker_tpu_torch/tools``), each through its ``run`` on the card,
   FEAR-XS bf16 from ``fear_xs.npz`` unless named, each counted into
   ``launches_by_path``: 16a the numpy scenario generator writes drift,
   occlusion, pose and swap at seed 7 (one track and one val
   sequence of 24 frames each, 160×224) and drift again at 2× (320×448),
   with no cv2 or pandas, its seconds printed; 16b ``dual_template_ablation``,
   ``recovery_ablation`` (with the dual arms), ``gate_v2_ablation``,
   ``occlusion_signal_probe``, ``letterbox_penalty`` (160×224 canvas, 2×
   scenes), ``vot_recovery``, ``vot_unified``, ``tune_tracker`` (sequential
   float32 and batched bf16, as the JAX tool), ``family_pareto`` (FEAR-XS,
   -M and -L at their published widths) and ``quantized_quality`` (both
   pairs exported on the card, K2 through ``fear_port::ir_block``) on those
   roots, their rows printed, each launching K1 and K2; 16c the card against
   the port on the CPU on witness roots (seed 7, two 12-frame sequences):
   ``recovery_ablation`` and ``vot_recovery`` in float32 (AO, VOT accuracy and
   EAO within 0.01, failures equal) and bfloat16 (0.02, failures within one),
   and ``quantized_quality``'s float32 pair (0.01) and bfloat16 pair (0.02);
17. the dataset makers and the training drivers
   (``feartracker_tpu_torch/tools``), each through its ``run`` on the card
   host, which has no cv2 or pandas, each counted into ``launches_by_path``:
   17a ``make_class_dataset`` (12 classes × 8 images, 128²) and
   ``make_annotations`` over a numpy generator's GOT-10k tree (``.npy``
   frames) and hand-written COCO JSON and ImageNet-VID XML layouts (rows and
   frame shapes checked; no cv2 or pandas imported); 17b ``pretrain_trunk``
   of the FEAR-XS trunk on 17a's classes, 128², B=32, one epoch (loss
   finite, every exported encoder array transferred into FEAR-XS by
   ``transfer_variables``, launches 0/0); 17c the eight drivers at full
   width with cut depth (epochs, samples, tracks and arms, never widths;
   staged batches and device augmentations): ``train_run`` (1 epoch, then 1
   resumed: the step count continues), ``pretrain_chain`` (three arms),
   ``family_train`` (FEAR-XS scratch, FEAR-M warm-started, FEAR-L scratch),
   ``warm_start_comparison``, ``synthetic_e2e``, ``train_template_gate``,
   ``train_feature_gate`` (one seed a scenario, 2 sequences of 12 frames) and
   ``train_flagship`` (the JAX tool's smoke budget, the export and the
   quality gate), each one's K1/K2 launches equal to its validation and
   rollout schedule (K1 once an update or batched step; K2 once a fused
   block a step or update, and again an ``init`` or refresh); 17d the card
   against the port on the CPU, float32 with TF32 off, each side from the
   same initial values: the template gate's logit after 4 Adam steps on the
   same batches (1e-3), ``pretrain_trunk``'s loss after one epoch at lr 1e-5 (rtol
   1e-3), the feature-gate rollout's boxes (1 px) and ``train_mlp`` on the
   card's observations at 100 epochs (AUC within 0.005, parameters 1e-4;
   the tool's 3000 epochs printed);
18. the JAX trainer's Orbax checkpoints on the card host, which has no
   orbax, tensorstore or zstandard (``tests/fixtures/orbax_fear_xs``: the
   JAX ``CheckpointManager``'s save of ``fear_xs.npz`` with a fresh Adam
   state at step 1234, epoch 3): 18a the fixture read in Python and numpy
   through the experiment dir, the ``checkpoints`` root and
   ``last/state``, every array bit-equal to ``fear_xs.npz`` (each read's
   seconds, at most 30, the MB read, whether ``zstandard`` is importable,
   unused); 18b ``build_scan_tracker`` from the fixture dir, bf16 S=128
   T=16: ``init`` + one ``track`` bit-equal to the archive-built tracker's,
   K1 16 and K2 13·17 launches (``launches_by_path["orbax"]``); 18c the
   port's ``Trainer`` with ``resume=true`` on a copy of the fixture, B=8
   over 12c's ``.npy`` clips, 2 steps: step 1234, epoch 3 from
   ``meta.json``, the lr from the injected hyperparameter, finite losses;
   then 12a's float32 step from the restored state, card against CPU at
   12a's tolerances; 18d ``warp_affine_linear_u8``, ``rescale_crop`` and
   ``get_subwindow_tracking`` on the card for 32 seeded boxes: bytes equal
   to the CPU's;
19. JPEG and the host augmentations on the card host, which has no cv2:
   19a the codec (``csrc/jpeg.cpp``, built with g++ at first use) against
   the committed sha256s of cv2's bytes (``tests/fixtures/jpeg``): its
   encodes of seeded frames (``fixture_frame``) and its decodes of eleven
   cv2-made files (progressive, restart, 4:4:4, 4:2:2, 4:4:0, gray, 1x1,
   EXIF 6), and the ms of a 1280x720 4:2:0 q95 decode and encode on one
   core; 19b ``Trainer.fit`` at the default ``device_augs: false`` (host
   augmentations, 8 loader threads, B=32, 1 epoch x 3 steps) over a JPEG
   GOT-10k tree of 1280x720 frames that the port's generator writes there
   with ``--format jpg``, validated by ``FEARTracker`` over the JPEG frames:
   K1/K2 launches equal to the validation schedule, the loader alone's ms a
   batch, the mosaics mined and logged; 19c the GOT-10k OPE protocol over
   that tree's JPEG val sequences and over ``.npy`` frames of the same
   decoded pixels: every result equal; 19d 64 normal-mode items with each
   host transform forced on in turn against the digests of the JAX
   package's items made with cv2 (``tests/fixtures/host_items.json``):
   byte-equal, ISONoise's (whose noise follows numpy's float std) at worst
   within 1e-3 of each image's mean;
20. the other frame formats, the demo's video and traces by op: 20a
   ``data/imread.py`` (cv2 still blocked) against the sha256s of cv2's
   pixels of the 36 committed ``tests/fixtures/images`` (PNG of every colour
   type, Adam7, tRNS, eXIf; BMP 1-32 bits, RLE4/RLE8, top-down, OS/2;
   P1-P6; CMYK, YCCK, 4:1:1, 1x4 and 3x2 sampling, block-smoothed
   progressive JPEGs; a PNG named ``.JPEG``), the format still unread
   (AVIF) refused by name,
   and the decode ms of a 1280x720 PNG, BMP and CMYK JPEG on one core; 20b
   19c's OPE over its val frames rewritten as PNG and as 24-bit BMP under
   their ``.jpg`` names: every result equal to the ``.npy`` run, K1/K2 at the
   schedule; 20c ``pretrain_trunk`` over an ImageFolder of mixed formats
   (baseline, CMYK, YCCK, 4:1:1 JPEG, PNG, a PNG named ``.JPEG``, a BMP named
   ``.jpg``): a finite loss, no K1/K2 launch; 20d the demo over an mp4 that
   the host's cv2 writes (mp4v), mp4 out: its final box equal to
   ``FEARTracker``'s over the decoded frames, K1/K2 one a frame; 20e phase
   5c's trace through ``tools/parse_trace.py``: the top ten aten ops by
   device ms;
21. TIFF, WebP, GIF and the JPEG modes beyond Huffman, cv2 blocked (run
   before 20d, which imports the host's cv2): 21a ``data/tiff.py``,
   ``data/webp.py``, ``data/gif.py`` and ``csrc/jpeg.cpp``'s arithmetic and
   lossless paths against the sha256s of cv2's pixels of the 33 committed
   ``tests/fixtures/images/manifest_tiff_webp_gif.json`` files (TIFF
   strips, tiles, planes, BigTIFF, LZW/Deflate/PackBits/JPEG, 1-16 bits,
   palette, alpha, orientation; WebP lossy, lossless, alpha, animation,
   EXIF; GIF interlaced, local tables, transparency; arithmetic and
   lossless JPEG), and the decode ms of a 1280x720 TIFF LZW, TIFF JPEG,
   WebP q90, lossless WebP and GIF on one core; 21b 19c's OPE over its val
   frames rewritten as TIFF (LZW, predictor 2) and as lossless WebP
   (``tiff_lzw``, ``webp_lossless`` below): every result equal to the
   ``.npy`` run, K1/K2 at the schedule; 21c ``make_annotations`` over a
   GOT-10k and a YouTube-BB tree of TIFF, WebP and GIF frames: rows equal
   to the JPEG trees', no zero frame size;
22. JPEG 2000, PAM, PFM, Sun raster and Radiance HDR, cv2 blocked: 22a
   ``data/jp2.py`` + ``csrc/jp2.cpp``, ``data/hdr.py`` and
   ``data/imread.py``'s PAM, PFM and Sun raster readers against the
   sha256s of cv2's pixels of the 40 committed
   ``tests/fixtures/images/manifest_jp2_hdr_pam.json`` files (JPEG 2000
   5/3 and 9/7, layers, every progression, precincts, tiles, code-block
   sizes, resolutions, grey, 16-bit, 12-bit, RGBA, grey + alpha, no MCT,
   PLT, a raw codestream, sYCC, a palette, cdef; PAM types and maxvals; PFM
   both byte orders; Sun raster 1-32 bits, old type, colour maps; HDR
   run-length, flat, narrow, header lines), and the decode ms of a
   1280x720 JPEG 2000 9/7 and 5/3, HDR, Sun raster and PFM on one core;
   22b the GOT-10k OPE protocol (``FEARTracker`` FEAR-XS f32) over the
   committed JPEG 2000 val tree ``tests/fixtures/jp2_got10k`` (2 x 12
   frames of 1280x720, PIL's OpenJPEG 9/7 under ``.jpg`` names): every file
   at its recorded sha256, K1 22 / K2 312 launches, the result equal to the
   one recorded from the port on the CPU; 22c ``make_annotations`` over
   GOT-10k and YouTube-BB trees of PAM, PFM, HDR and Sun raster frames
   (``pam_rgb``, ``pfm_rgb``, ``hdr_flat``, ``sun_raster`` below) and of
   22b's JPEG 2000 frames: rows equal to the same trees in JPEG, no zero
   frame size, no launch.
23. CCITT fax, FillOrder 2, CMYK, CIELab and uncompressed YCbCr TIFF, cv2
   blocked: 23a ``data/tiff.py`` + ``csrc/imgcodecs.cpp`` (``tiff_fax``,
   ``tiff_cielab``) against the sha256s of cv2's pixels of the committed
   ``tests/fixtures/images/manifest_tiff_fax_cmyk.json`` files (Modified
   Huffman, RLEW, Group 3 1-D and 2-D, Group 4, strips and tiles, FillOrder
   2; CMYK through every codec, planar, JPEG; CIELab 8 and 16 bits, a white
   point, JPEG; YCbCr 1x1 to 4x4, tiles, ReferenceBlackWhite and
   coefficients, planar; signed samples), and the decode ms of a 1280x720
   Group 4 page, Group 3 2-D page, CMYK LZW, CIELab and YCbCr 2x2 frame on
   one core; 23b the GOT-10k OPE over 19c's val frames rewritten (i) as
   8-bit CMYK TIFF (``tiff_cmyk``: K = 0, so exact): the result equal to the
   ``.npy`` run's, and (ii) as uncompressed YCbCr 2x2 TIFF
   (``tiff_ycbcr22``, lossy): every file at the sha256 that
   ``tests/fixtures/tiff_ope_record.json`` records from the CPU, the boxes
   within 1 px and the AO within 0.01 of the CPU's there; K1 22 / K2 312
   each; 23c ``make_annotations`` over GOT-10k and YouTube-BB trees of
   Modified Huffman, CMYK, CIELab and YCbCr frames: rows equal to the same
   trees in JPEG, no zero frame size, no launch, and the Modified Huffman
   GOT-10k frames read back equal to their frames' thresholds.
24. VP8 WebP of 2, 4 and 8 token partitions and the JPEG 2000 coding modes,
   cv2 blocked: 24a ``data/webp.py`` + ``csrc/webp.cpp`` and ``data/jp2.py`` +
   ``csrc/jp2.cpp`` against the sha256s of cv2's pixels of the committed
   ``tests/fixtures/images/manifest_webp_parts_jp2_modes.json`` files
   (libwebp at methods 0-2 with 2, 4 and 8 partitions, fewer macroblock rows
   than partitions, VP8X; OpenJPEG's six code-block styles alone and
   together, ROI max-shift, two POC records, SOP/EPH, tile-parts by
   resolution, layer and component and in every progression), and the decode
   ms of a 1280x720 4-partition WebP and an all-styles JPEG 2000 frame on one
   core; 24b the GOT-10k OPE (``FEARTracker`` FEAR-XS f32) over the committed
   ``tests/fixtures/webp_parts_got10k`` (phase 19c's val sequences written by
   libwebp with 4 token partitions under their ``.jpg`` names): every file at
   its recorded sha256, K1 22 / K2 312 launches, the boxes within 1 px and
   the AO within 0.01 of the result recorded from the port on the CPU; 24c
   ``make_annotations`` over GOT-10k and YouTube-BB trees of 24b's WebP
   frames and of the JPEG 2000 mode fixtures: rows equal to the same trees in
   JPEG, no zero frame size, no launch.

Then the wall seconds of each phase, one JSON line of kernels (``launches``:
the static path's, phase 5b; ``launches_by_path``: each path's own count
over one run from 0, the K=16 graphs' one of 10a; K3's only on the paths
the benchmark runs, 5b, 7b, 8, 10a and the graphed 14d; K1's ``ms``: the decode
region at S=128 with bf16 head outputs, ``postprocess_ms`` the decode alone
in f32, ``floor_ms``: the empty kernel of phase 6; K2's ``op_dispatch_us``: the
operator's host cost per call over the wrapper's, 11a; ``bound_ms``: the least time
the card could take, from the H100's published peaks; ``tile``: K2's
bfloat16 tile per S=128 block shape; ``s1``: the times and bounds at S=1,
K2's with its practical floor of 13 launches at K1's S=1 time)
and, last,
``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no result.

Time budget: the whole run, the build included, must end within 1200 s; aim
for half of it. The ``[time]`` line before the kernels line gives each
phase's wall seconds (``1-2`` the build), their sum and the whole script's
seconds. Earlier phases run at a cut depth (clips, seeds, epochs, steps,
repetitions) so that a new phase fits; every check keeps its comparison and
tolerance. The host (CPU) side of the card-vs-CPU checks of 9d-9h, 12a,
16c, 17d and 18c runs in a process of its own (``--host-refs``), beside the
card's side, and none of it is timed.
"""

from __future__ import annotations

import atexit
import json
import subprocess
import sys
import tempfile
import time


def _random_block(gen, cin, spec, dtype, device):
    """Folded block weights at fan-in scale (unit-scale activations), packed
    for the kernel in bfloat16 as ``fold_fear_net`` packs them."""
    import torch

    from feartracker_tpu_torch.ops.cuda.ir_block import pack_block

    ce, k, cout = cin * spec.expansion, spec.kernel, spec.out_channels

    def mk(*shape, fan_in=1, dt=torch.float32):
        w = torch.randn(*shape, generator=gen, device=device) / fan_in ** 0.5
        return w.to(dt).contiguous()

    blk = {
        "expand": None if spec.expansion == 1 else {"w": mk(cin, ce, fan_in=cin, dt=dtype), "b": mk(ce) * 0.1},
        "dw": {"w": mk(k, k, ce, fan_in=k * k), "b": mk(ce) * 0.1},
        "project": {"w": mk(ce, cout, fan_in=ce, dt=dtype), "b": mk(cout) * 0.1},
    }
    if dtype == torch.bfloat16:
        blk["packed"] = pack_block(blk, cin, k)
    return blk


def _block_shapes(specs, crop: int):
    """(block index, spec, Cin, H) of every block, for a crop² input."""
    h, cin, out = crop // 2, 16, []
    for i, spec in enumerate(specs):
        out.append((i, spec, cin, h))
        h //= spec.stride
        cin = spec.out_channels
    return out


def _k1_bound(S: int, itemsize: int = 4, region: bool = True, n: int = 16) -> float:
    """ms to move K1's inputs and outputs once over the memory rate; its few
    FLOPs are far below. Inputs: cls and reg (S, n, n, 1 + 4) in their dtype
    (``itemsize`` bytes), the three (n, n) f32 tables, and the region's box
    and window (S, 4) or the decode's prev size (S, 2); outputs: the region's
    frame box, crop box, confidence and APCE or the decode's box and
    confidence, f32, and the (S, 2) int32 coords."""
    from feartracker_tpu_torch.evaluate.profiling import HBM_BYTES_PER_S

    head = S * n * n * 5 * itemsize + 3 * n * n * 4
    rest = S * 4 * ((8 + 10 + 2) if region else (2 + 5 + 2))
    return (head + rest) / HBM_BYTES_PER_S * 1e3


# the frame of phase 3's decode-region checks
K1_FRAME_HW = (120, 160)


def _k1_region_inputs(S: int, dtype, dev, seed: int = 0):
    """The decode region's inputs for S >= 8 streams, made with numpy as
    ``tests/test_torch_decode.py`` makes its own: stream 0 a tie on the peak
    (mirror cells of the symmetric window), 1 a rescale landing on exactly
    .5, 2 and 4 boxes past the left and top edges, 3 and 5 peaks whose frame
    box starts past the right and bottom edges (zero width / height, then
    the min-side fix-up), 6 an all-NaN map, the rest random → (cls (S, 16,
    16, 1), reg (S, 16, 16, 4)) in ``dtype``, state boxes and windows (S, 4)
    f32, on ``dev``."""
    import numpy as np
    import torch

    from feartracker_tpu_torch.ops.crop import extended_crop_window

    H, W = K1_FRAME_HW
    rng = np.random.RandomState(seed)
    cls = (rng.randn(S, 16, 16, 1) * 2).astype(np.float32)
    reg = (rng.rand(S, 16, 16, 4) * 60 + 2).astype(np.float32)
    state = np.stack([rng.uniform(0, W - 30, S), rng.uniform(0, H - 30, S),
                      rng.uniform(8, 40, S), rng.uniform(8, 40, S)], 1).astype(np.float32)
    cls[0] = -5.0
    cls[0, 4, 9] = cls[0, 11, 6] = 3.0
    reg[0] = 8.0
    cls[1] = -5.0
    cls[1, 7, 7] = 10.0
    reg[1, 7, 7] = (0.5, 0.5, 8.0, 9.0)
    state[1] = (40.0, 30.0, 51.2, 51.2)
    state[2, 0], state[4, 1] = -35.0, -35.0
    for i, cell, box in ((3, (8, 12), (W - 2.0, 50.0, 20.0, 20.0)), (5, (12, 8), (50.0, H - 2.0, 20.0, 20.0))):
        cls[i] = -5.0
        cls[(i, *cell)] = 10.0
        reg[(i, *cell)] = (1.0, 1.0, 50.0, 50.0)
        state[i] = box
    cls[6] = np.nan
    state = torch.from_numpy(state)
    windows = extended_crop_window(state, 2.0)
    return (torch.from_numpy(cls).to(dev, dtype), torch.from_numpy(reg).to(dev, dtype), state.to(dev),
            windows.to(dev))


def _region_diff(got, ref) -> dict:
    """K1's region against its plain twin: coords equal, crop box rtol 1e-5
    / atol 1e-4 (the decode's own), confidence rtol 1e-5, frame boxes within
    1 px, APCE rtol 1e-5 (a mean summed in another order); NaN where the
    twin has NaN. → max|err| of the crop box, the frame box's max|err| and
    the count of frame boxes that differ at all."""
    import torch

    res, bbox, apce = got
    rres, rbbox, rapce = ref
    if not torch.equal(res.pred_coords, rres.pred_coords):
        raise AssertionError("K1 region: coords differ from the plain twin")
    torch.testing.assert_close(res.bbox, rres.bbox, rtol=1e-5, atol=1e-4, equal_nan=True)
    torch.testing.assert_close(res.confidence, rres.confidence, rtol=1e-5, atol=0.0, equal_nan=True)
    torch.testing.assert_close(apce, rapce, rtol=1e-5, atol=0.0, equal_nan=True)
    same_nan = torch.equal(bbox.isnan(), rbbox.isnan())
    d = (bbox - rbbox).nan_to_num(0.0).abs()
    if not (same_nan and d.max().item() <= 1.0):
        raise AssertionError(f"K1 region: frame boxes {d.max().item()} px from the plain twin (NaN same: {same_nan})")
    crop = (res.bbox - rres.bbox).nan_to_num(0.0).abs().max().item()
    return {"crop_err": crop, "frame_px": d.max().item(), "boxes_differ": int((d > 0).any(-1).sum())}


def _phase_k1(card, dev) -> float:
    """Phase 3: K1 against its plain twins on the card → the largest crop-box
    max|err|."""
    import torch

    from feartracker_tpu_torch.core import postprocess as pp
    from feartracker_tpu_torch.ops.cuda.decode import decode_step_cuda, decode_step_plain, postprocess_cuda

    k1_err, n_checks, differ = 0.0, 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        batch8 = _k1_region_inputs(8, dtype, dev, seed=2)
        runs = [(f"S=1 stream {i}", tuple(t[i:i + 1] for t in batch8)) for i in range(8)]
        runs += [(f"S={S}", _k1_region_inputs(S, dtype, dev, seed=S)) for S in (128, 300)]
        cls, reg, state, windows = runs[-2][1]
        # channel-first memory behind the same NHWC view: the kernel takes strides
        runs.append(("S=128 channel-first reg", (cls, reg.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                                                 state, windows)))
        for smooth in (False, True):
            cfg = pp.PostprocessConfig(smooth=smooth)
            line = []
            for name, (cls, reg, state, windows) in runs:
                got = decode_step_cuda(cls, reg, cfg, state, windows, K1_FRAME_HW)
                ref = decode_step_plain(cls, reg, cfg, state, windows, K1_FRAME_HW)
                torch.cuda.synchronize()
                d = _region_diff(got, ref)
                if name == "S=1 stream 0" and got.result.pred_coords[0].tolist() != [4, 9]:
                    raise AssertionError("K1 region tie: not the row-major first match")
                if name == "S=1 stream 6" and got.result.pred_coords[0].tolist() != [0, 0]:
                    raise AssertionError("K1 region all-NaN map: not cell 0")
                k1_err = max(k1_err, d["crop_err"])
                differ += d["boxes_differ"]
                n_checks += 1
                if not name.startswith("S=1 stream"):
                    line.append(f"{name}: crop {d['crop_err']:.2e}, frame {d['frame_px']:.0f} px, "
                                f"{d['boxes_differ']} boxes differ")
            print(f"[3] K1 region {str(dtype)[6:]} smooth={smooth}: S=1 edge cases 0-7 ok; " + "; ".join(line),
                  flush=True)
    print(f"[3] K1 region: {n_checks} checks, coords equal, crop box max|err| {k1_err:.3e}, frame boxes within "
          f"1 px, {differ} frame boxes differ at all (0 expected: the operation order matches) [{card}]", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    S = 128
    reg = torch.rand(S, 16, 16, 4, generator=gen, device=dev) * 40 + 4
    logits = torch.randn(S, 16, 16, 1, generator=gen, device=dev)
    prev = torch.rand(S, 2, generator=gen, device=dev) * 60 + 20
    tie = torch.full((S, 16, 16, 1), -5.0, device=dev)
    tie[:, 4, 9, 0] = 3.0
    tie[:, 11, 2, 0] = 3.0
    for name, cls_in, smooth, dt in (("plain", logits, False, torch.float32), ("smooth", logits, True, torch.float32),
                                     ("tie", tie, False, torch.float32), ("bf16", logits, True, torch.bfloat16)):
        cfg = pp.PostprocessConfig(smooth=smooth)
        cls_in, reg_in = cls_in.to(dt), reg.to(dt)
        ref = pp.postprocess(cls_in, reg_in, cfg, prev_size=prev)
        got = postprocess_cuda(cls_in, reg_in, cfg, prev_size=prev)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.bbox, ref.bbox, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(got.confidence, ref.confidence, rtol=1e-5, atol=1e-6)
        if not torch.equal(got.pred_coords, ref.pred_coords):
            raise AssertionError(f"K1 {name}: coords differ from the plain twin")
        if name == "tie" and not (got.pred_coords == torch.tensor([4, 9], device=dev, dtype=torch.int32)).all():
            raise AssertionError("K1 tie: not the row-major first match")
        err = (got.bbox - ref.bbox).abs().max().item()
        k1_err = max(k1_err, err)
        print(f"[3] K1 decode alone {name:6s} S={S}: bbox max|err| {err:.3e}, coords exact", flush=True)
    return k1_err


# phase 3b's frames: the benchmark's 1280x720 at S=128; the first streams'
# windows are tests/test_torch_crop_kernel.py's edge cases at this size
# (inside, past the left, top, right and bottom edges, wholly outside,
# larger than the frame), the rest drawn, from 2 px to twice the frame
K3_FRAME_HW = (720, 1280)
K3_EDGE_WINDOWS = ((400, 200, 300, 250), (-150, 300, 400, 300), (500, -120, 300, 400), (1100, 300, 400, 300),
                   (300, 600, 300, 300), (2000, 1500, 200, 200), (-300, -200, 1900, 1100))


def _k3_inputs(S: int, dev, seed: int):
    """(uint8 frames (S, 720, 1280, 3), windows (S, 4), pad (S, 3)) on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    H, W = K3_FRAME_HW
    frames = torch.randint(0, 256, (S, H, W, 3), generator=gen, device=dev, dtype=torch.uint8)
    xy = torch.randint(-300, 1300, (S, 2), generator=gen, device=dev).float()
    wh = torch.exp(torch.rand(S, 2, generator=gen, device=dev) * 7.0).floor() + 2.0  # 2-1098 px, log-uniform
    windows = torch.cat([xy, wh], 1)
    windows[:len(K3_EDGE_WINDOWS)] = torch.tensor(K3_EDGE_WINDOWS, dtype=torch.float32, device=dev)
    pad = torch.rand(S, 3, generator=gen, device=dev) * 255.0
    return frames, windows, pad


def _k3_bound(frames, windows, out_size: int, itemsize: int) -> float:
    """ms to move K3's bytes once over the memory rate: the crops written in
    their dtype, the windows and pad colours read, and of each frame the
    distinct in-frame rows times the distinct in-frame columns its taps
    touch (each source byte read once, however many outputs read it)."""
    import torch

    from feartracker_tpu_torch.evaluate.profiling import HBM_BYTES_PER_S
    from feartracker_tpu_torch.ops.crop import _src_grid

    S, H, W, C = frames.shape

    def distinct(origin, size, n):
        s0 = torch.floor(_src_grid(origin, size, out_size)).long()
        taps = torch.cat([s0, s0 + 1], 1)
        hit = torch.zeros(S, n + 2, dtype=torch.bool, device=frames.device)
        hit.scatter_(1, taps.clamp(-1, n) + 1, True)
        return hit[:, 1:n + 1].sum(1)

    read = (distinct(windows[:, 1], windows[:, 3], H) * distinct(windows[:, 0], windows[:, 2], W)).sum().item()
    total = read * C * frames.element_size() + S * out_size * out_size * C * itemsize + S * (4 + 3) * 4
    return total / HBM_BYTES_PER_S * 1e3


def _phase_k3(card, dev) -> dict:
    """Phase 3b: K3 against its plain twin on the card, bit for bit, then
    its time beside its bound, the twin's and the "mm" and "gather" routes'
    at the benchmark's shapes → the times."""
    import torch

    from feartracker_tpu_torch.evaluate.profiling import time_ms
    from feartracker_tpu_torch.ops.crop import crop_resize, crop_resize_mm, normalize_imagenet
    from feartracker_tpu_torch.ops.cuda.crop import crop_cuda, crop_plain

    S = 128
    frames, windows, pad = _k3_inputs(S, dev, seed=26)
    gen = torch.Generator(device=dev).manual_seed(27)
    inputs = {
        "uint8": frames,
        "uint8 shared (stream stride 0)": frames[1].expand(S, *frames.shape[1:]),
        "float32": torch.rand(frames.shape, generator=gen, device=dev) * 255.0,
        "uint8 W-major strides": frames[:8].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
    }
    n_checks = 0
    for name, f in inputs.items():
        w, p = windows[:f.shape[0]], pad[:f.shape[0]]
        for out_size in (256, 128):
            ref = crop_plain(f, w, out_size, p, torch.float32)
            for dtype in (torch.float32, torch.bfloat16):
                got = crop_cuda(f, w, out_size, p, dtype)
                torch.cuda.synchronize()
                want = ref.to(dtype)
                if not torch.equal(got, want):
                    bad = got.float() != want.float()
                    raise AssertionError(f"K3 {name} -> {out_size}² {dtype}: {int(bad.sum())} of {bad.numel()} "
                                         f"values differ from the twin, max|err| "
                                         f"{(got.float() - want.float()).abs().max().item():.3e}, first at "
                                         f"{bad.nonzero()[0].tolist()}")
                n_checks += 1
        del ref, got, want
    del inputs
    print(f"[3b] K3 against its plain twin on the card: {n_checks} checks (uint8, uint8 shared with stream "
          f"stride 0, float32 and W-major uint8 frames of {K3_FRAME_HW[1]}x{K3_FRAME_HW[0]}, S=128 with "
          f"the edge-case windows, -> 256² and 128², float32 and bfloat16): every value equal, the bfloat16 crop "
          f"the float32 twin rounded once [{card}]", flush=True)

    times = {}
    for out_size in (256, 128):
        bf16 = torch.bfloat16
        t = {
            "ms": time_ms(lambda: crop_cuda(frames, windows, out_size, pad, bf16), iters=50),
            "bound_ms": _k3_bound(frames, windows, out_size, 2),
            "plain_ms": time_ms(lambda: crop_plain(frames, windows, out_size, pad, bf16), iters=10),
            "mm_ms": time_ms(lambda: normalize_imagenet(crop_resize_mm(frames, windows, out_size, pad)).to(bf16),
                             iters=10),
            "gather_ms": time_ms(lambda: normalize_imagenet(crop_resize(frames.float(), windows, out_size, pad))
                                 .to(bf16), iters=5),
        }
        times[out_size] = t
        print(f"[3b] K3 S={S} {K3_FRAME_HW[1]}x{K3_FRAME_HW[0]} uint8 -> {out_size}² bf16: kernel {t['ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms by bytes (kernel at {100 * t['bound_ms'] / t['ms']:.1f}% of it); "
              f"plain twin {t['plain_ms']:.4f} ms; the routes as the tracker ran them, crop + normalize + cast: "
              f"\"mm\" {t['mm_ms']:.4f} ms, \"gather\" {t['gather_ms']:.4f} ms [{card}]", flush=True)
    return times


def _trace_breakdown(fn, out_dir: str) -> dict:
    """Device time of one call of ``fn`` by kernel family, from the kernel,
    copy and memset rows of a ``torch.profiler`` trace (op rows repeat their
    kernels' time): busy, span and idle share, K2, K1, K3, GEMMs,
    convolutions, the rest."""
    import torch

    from feartracker_tpu_torch.evaluate.profiling import trace

    with trace(out_dir):
        fn()
        torch.cuda.synchronize()
    with open(f"{out_dir}/trace.json") as fh:
        rows = [e for e in json.load(fh)["traceEvents"] if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not rows:
        return {}
    fam = {"K2": 0.0, "K1": 0.0, "K3": 0.0, "gemm": 0.0, "conv": 0.0, "other": 0.0}
    for e in rows:
        name = e.get("name", "").lower()
        key = ("K2" if "ir_block" in name else "K1" if "decode_kernel" in name else "K3" if "crop_kernel" in name
               else "gemm" if ("gemm" in name or "xmma" in name or "cutlass" in name) else
               "conv" if ("conv" in name or "cudnn" in name) else "other")
        fam[key] += e.get("dur", 0) / 1e3
    busy = sum(e.get("dur", 0) for e in rows) / 1e3
    span = (max(e["ts"] + e.get("dur", 0) for e in rows) - min(e["ts"] for e in rows)) / 1e3
    return {"busy_ms": busy, "span_ms": span, "idle": 1 - busy / span, "kernels": len(rows), **fam}


def _max_err(a, b, key) -> float:
    return (a[key].float().cpu() - b[key].float().cpu()).abs().max().item()


def _stop(proc) -> None:
    """Kill ``proc`` (a ``subprocess.Popen``) if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _host_refs(kind: str, work: str = ""):
    """Start the host (CPU) side of phase ``kind``'s card-vs-CPU checks in
    a process of its own (``python3 chip_smoke.py --host-refs <kind> <work>
    <out>``; ``work`` the phase's directory where it reads or writes
    files), beside the card's side in this one; → a function that waits
    for it and returns its result."""
    import os

    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "result.pkl")
    log = open(os.path.join(tmp.name, "log.txt"), "w+")
    proc = subprocess.Popen([sys.executable, __file__, "--host-refs", kind, work or tmp.name, out], stdout=log,
                            stderr=subprocess.STDOUT)
    atexit.register(_stop, proc)  # should a check of the card's side raise first

    def result():
        import pickle

        try:
            rc = proc.wait(timeout=900)
        finally:
            _stop(proc)
        log.seek(0)
        text = log.read()
        log.close()
        if rc:
            raise AssertionError(f"the host side of phase {kind} exited {rc}:\n{text[-4000:]}")
        with open(out, "rb") as fh:
            got = pickle.load(fh)
        tmp.cleanup()
        return got

    return result


def _host_refs_main(kind: str, work: str, out: str) -> int:
    """``--host-refs``: the host side of 12a or 18c (the float64 and
    float32 steps on the CPU), or the CPU's run of phase 9's, 16c's or 17d's
    witness (``_seq_witness``, ``_scenario_witness``, ``_driver_witness``),
    pickled to ``out``."""
    import pickle

    import torch

    torch.set_num_threads(4)  # the card's side keeps the other cores
    if kind in ("12a", "18c"):
        model, opt_state = _f32_start(kind == "18c")
        result = {"f64": _f32_step(model, opt_state, "cpu", torch.float64),
                  "cpu": _f32_step(model, opt_state, "cpu", torch.float32)}
    else:
        result = {"9": _seq_witness, "16": _scenario_witness, "17": _driver_witness}[kind]("cpu", work)
    with open(out, "wb") as fh:
        pickle.dump(result, fh)
    return 0


def _zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def _read(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def _k1_times(cfg, S: int, dtype, dev) -> dict:
    """K1 at S streams on the package's device timer: the decode region with
    ``dtype`` head outputs (the batched step) against its plain chain and
    bound, the decode alone with f32 inputs (the sequential tracker's call)
    against ``pp.postprocess``, and an empty kernel (torch's spin kernel
    asked for 0 cycles, one thread) launched back to back: the card's
    launch floor."""
    import torch

    from feartracker_tpu_torch.core import postprocess as pp
    from feartracker_tpu_torch.evaluate.profiling import time_ms
    from feartracker_tpu_torch.ops.cuda.decode import decode_step_cuda, decode_step_plain, postprocess_cuda

    batch = _k1_region_inputs(max(S, 8), dtype, dev, seed=7)
    cls, reg, state, windows = (t[-S:] for t in batch)  # random streams
    prev = state[:, 2:] * 4.0
    c32, r32 = cls.float(), reg.float()
    iters = 200
    return {
        "ms": time_ms(lambda: decode_step_cuda(cls, reg, cfg, state, windows, K1_FRAME_HW), iters=iters),
        "plain_ms": time_ms(lambda: decode_step_plain(cls, reg, cfg, state, windows, K1_FRAME_HW), iters=iters),
        "bound_ms": _k1_bound(S, dtype.itemsize), "bound_by": "bytes",
        "postprocess_ms": time_ms(lambda: postprocess_cuda(c32, r32, cfg, prev_size=prev), iters=iters),
        "postprocess_plain_ms": time_ms(lambda: pp.postprocess(c32, r32, cfg, prev_size=prev), iters=iters),
        "postprocess_bound_ms": _k1_bound(S, 4, region=False),
        "floor_ms": time_ms(lambda: torch.cuda._sleep(0), iters=iters),
        "dtype": str(dtype)[6:],
    }


def _k1_line(t: dict) -> str:
    return (f"region ({t['dtype']} head outputs) kernel {t['ms']:.6f} ms, plain chain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.6f} ms by bytes; decode alone (f32) kernel {t['postprocess_ms']:.6f} ms, plain "
            f"{t['postprocess_plain_ms']:.4f} ms, bound {t['postprocess_bound_ms']:.6f} ms; an empty kernel back to "
            f"back {t['floor_ms']:.6f} ms (region at {t['ms'] / t['floor_ms']:.2f}x, decode alone at "
            f"{t['postprocess_ms'] / t['floor_ms']:.2f}x that floor)")


def _phase_dual(card, n_fused, counters):
    """Phase 7: the dual-template path (see the module docstring). Returns
    the launch counts of the bfloat16 run over ``init`` + one ``track`` and
    that tracker, for phase 8."""
    import torch

    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, synthetic_streams

    # thresholds 0 so the ema and gated blends run on every refresh frame
    feature_gate = "fear_xs_feature_gate"
    modes = {
        "ema": ("fear_xs", dict(update_mode="ema", update_threshold=0.0)),
        "gated": ("fear_xs_gate", dict(update_mode="gated", update_threshold=0.0)),
        "feature": ("fear_xs", dict(update_mode="feature", gate_params=feature_gate,
                                    recover_context=3.0, recover_threshold=0.7, update_interval=2)),
    }
    f0, chunk, boxes = synthetic_streams(4, 8, seed=2, device="cpu")
    for mode, (weights, kw) in modes.items():
        res = {}
        for device in ("cuda", "cpu"):
            tracker, _ = build_scan_tracker(weights, torch.float32, device, dynamic_template=True, **kw)
            state, out = tracker.track(tracker.init(f0, boxes), chunk)
            res[device] = dict(out, dyn_feats=state.dyn_feats)
        errs = {k: _max_err(res["cuda"], res["cpu"], k) for k in ("bbox", "confidence", "gate_obs", "dyn_feats")}
        if not (errs["bbox"] <= 1.0 and errs["confidence"] <= 1e-3 and errs["gate_obs"] <= 1e-3):
            raise AssertionError(f"dual {mode} f32 cuda vs cpu: {errs}")
        print(f"[7a] dual {mode:7s} ({weights}) f32 S=4 T=8 cuda vs cpu: bbox {errs['bbox']} px (<= 1), "
              f"confidence {errs['confidence']:.2e} (<= 1e-3), gate_obs {errs['gate_obs']:.2e} (<= 1e-3), "
              f"dyn_feats {errs['dyn_feats']:.2e}", flush=True)

    S, T, K = 128, 16, 4
    tracker, _ = build_scan_tracker("fear_xs", torch.bfloat16, "cuda", dynamic_template=True,
                                    update_mode="feature", gate_params=feature_gate,
                                    update_interval=K, recover_context=3.0)
    f0, chunk, boxes = synthetic_streams(S, T, seed=1, device="cuda")
    torch.cuda.synchronize()
    _zero(counters)
    state = tracker.init(f0, boxes)
    state, out = tracker.track(state, chunk)
    torch.cuda.synchronize()
    launches = _read(counters)
    refreshes = len(range(0, T, K))
    want = {"K1": T, "K2": n_fused * (1 + T + refreshes), "K3": 1 + T + refreshes}
    if launches != want:
        raise AssertionError(f"dual launch counts {launches}, expected {want}")
    for k, v in out.items():
        if v.shape[:2] != (T, S) or (v.is_floating_point() and not torch.isfinite(v).all()):
            raise AssertionError(f"dual output {k}: shape {tuple(v.shape)} or non-finite values")
    if not torch.isfinite(state.dyn_feats.float()).all():
        raise AssertionError("dual dyn_feats has non-finite values")
    for _ in range(2):
        state, out = tracker.track(state, chunk, start_step=T)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for r in range(reps):
        state, out = tracker.track(state, chunk, start_step=T * (r + 3))
    torch.cuda.synchronize()
    track_ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"[7b] dual bf16 S={S} T={T} feature, update_interval={K}, recover_context=3: launches "
          f"{launches} over init + 1 track (K2 {n_fused} + {n_fused}*{T} + {n_fused}*{refreshes}, "
          f"{(launches['K2'] - n_fused) / T} per frame); "
          f"finite outputs; {track_ms:.2f} ms/track, {S * T / track_ms * 1e3:.1f} frames/s [{card}]",
          flush=True)
    br = _trace_breakdown(lambda: tracker.track(state, chunk, start_step=T * 8), "chiprun_out/trace_dual_track")
    if br:
        print(f"[7c] one traced dual track call: device busy {br['busy_ms']:.2f} of {br['span_ms']:.2f} ms (idle "
              f"{100 * br['idle']:.1f}% under the profiler), {br['kernels']} kernels/copies; K2 {br['K2']:.2f} ms "
              f"({100 * br['K2'] / br['busy_ms']:.1f}%), K1 {br['K1']:.3f}, K3 {br['K3']:.3f}, GEMMs {br['gemm']:.2f}, "
              f"convolutions "
              f"{br['conv']:.2f}, other {br['other']:.2f} ms [{card}]", flush=True)
    else:
        print("[7c] the trace holds no device rows: breakdown not measured", flush=True)
    return launches, tracker


def _phase_pool(card, n_fused, counters, tracker):
    """Phase 8: the StreamPool slot server at capacity 128 on host frames.
    Returns the launch counts of its 128 ``add``s and of three serial steps,
    each read over that run alone."""
    import numpy as np
    import torch

    from feartracker_tpu_torch.evaluate.fps import fps_benchmark, pipelined_online_benchmark
    from feartracker_tpu_torch.evaluate.harness import DEMO_BBOX
    from feartracker_tpu_torch.evaluate.profiling import spin_cycles_per_ms
    from feartracker_tpu_torch.tracker.serving import StreamPool

    cap, hw = 128, (256, 480)
    rng = np.random.RandomState(3)
    video = rng.randint(0, 255, (12, *hw, 3), dtype=np.uint8)
    frames = [np.broadcast_to(v, (cap, *hw, 3)) for v in video]  # host numpy, one view per frame

    def fill(pool):
        for i in range(cap):
            pool.add(video[0], (DEMO_BBOX[0] + i % 8, DEMO_BBOX[1], DEMO_BBOX[2], DEMO_BBOX[3]))

    _zero(counters)
    pool = StreamPool(tracker, cap, hw)
    t0 = time.perf_counter()
    fill(pool)
    torch.cuda.synchronize()
    add_ms = (time.perf_counter() - t0) * 1e3 / cap
    launches = {"pool_add": _read(counters)}
    if pool.num_active != cap or launches["pool_add"] != {"K1": 0, "K2": n_fused * cap, "K3": cap}:
        raise AssertionError(f"pool: {pool.num_active} active, launches {launches['pool_add']} after {cap} adds")

    # warm the pinned host blocks, then three serial steps: their own launches
    for t in range(4):
        pool.step_async(frames[t]).result()
    torch.cuda.synchronize()
    start, count = pool.state, pool._step_count
    _zero(counters)
    serial = [pool.step(frames[4 + t]) for t in range(3)]
    torch.cuda.synchronize()
    launches["pool_step"] = _read(counters)
    refreshes = sum((count + t) % tracker.update_interval == 0 for t in range(3))
    want = {"K1": 3, "K2": n_fused * (3 + refreshes), "K3": 3 + refreshes}
    if launches["pool_step"] != want:
        raise AssertionError(f"pool: launches {launches['pool_step']} over 3 steps, expected {want}")

    # three dispatches back to back: the host's cost of each, then the check
    # with a device-side delay queued first, so that it does not hang on
    # host speed; a sync anywhere in step_async would wait through the delay
    # and through step 1. margin: from the third return to step 1's end
    def three_async(delay_cycles=0):
        pool.state, pool._step_count = start, count
        torch.cuda.synchronize()
        if delay_cycles:
            torch.cuda._sleep(delay_cycles)
        pending, ms = [], []
        for t in range(3):
            t0 = time.perf_counter()
            pending.append(pool.step_async(frames[4 + t]))
            ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        first_done = pending[0].done.query()
        pending[0].done.synchronize()
        margin_ms = (time.perf_counter() - t0) * 1e3
        results = [p.result() for p in pending]
        for a, b in zip(serial, results):
            if not (np.abs(a["bbox"] - b["bbox"]).max() <= 1e-3 and (a["failure"] == b["failure"]).all()):
                raise AssertionError("pool: pipelined results differ from serial ones")
        return ms, first_done, margin_ms

    dispatch_ms, _, _ = three_async()
    # the delay outlasts three times the host's dispatches, so a slower host
    # in the checked run still returns inside it
    delay_ms = 3 * sum(dispatch_ms) + 50.0
    # three steps held behind a delay need a pinned staging block each, where
    # the undelayed run reuses the first step's; the first time, the caching
    # host allocator pins a new 47 MB block (cudaHostAlloc, 15-110 ms, no
    # device sync) inside the third dispatch. A pool in service holds its
    # blocks, so one run behind the delay makes them before the check
    three_async(int(delay_ms * spin_cycles_per_ms()))
    checked_ms, first_done, margin_ms = three_async(int(delay_ms * spin_cycles_per_ms()))
    # with the blocks held no dispatch waits for the card (a full launch
    # queue, ≈1000 launches, would hold back only the third); a sync would
    # hold every dispatch to the delay's end and step 1's
    if first_done or not sum(checked_ms[:2]) < delay_ms:
        raise AssertionError(f"pool: a hidden sync: dispatches {checked_ms} ms behind a {delay_ms:.0f} ms delay, "
                             f"step 1 done when the third returned: {first_done}")
    print(f"[8] pool cap {cap}: {cap} adds ({add_ms:.2f} ms each); launches {launches}; step_async x3 back "
          f"to back: host ms per dispatch {[round(m, 2) for m in dispatch_ms]}; behind a {delay_ms:.0f} ms "
          f"device delay {[round(m, 2) for m in checked_ms]}, and step 1 ended {margin_ms:.2f} ms after the "
          f"third returned: no hidden sync; pipelined == serial", flush=True)
    pool.state, pool._step_count = start, count
    lat = fps_benchmark(lambda: pool.step(frames[7]), sync=lambda out: None, warmup=2, timed=20,
                        device="cuda")
    print(f"[8] serial pool.step cap {cap}: p50 {lat['p50_ms']:.2f} ms, p99 {lat['p99_ms']:.2f} ms "
          f"[{card}]", flush=True)

    # step_chunk against ScanTracker.track from the same state
    pool.state, pool._step_count = start, count
    chunk = np.broadcast_to(video[4:8, None], (4, cap, *hw, 3))
    got = pool.step_chunk(chunk)
    on_card = torch.from_numpy(video[4:8]).cuda()[:, None].expand(4, cap, *hw, 3)
    _, want = tracker.track(start, on_card, start_step=count)
    box_err = np.abs(got["bbox"] - want["bbox"].cpu().numpy()).max()
    if not (box_err <= 1e-3 and (got["failure"] == want["failure"].cpu().numpy()).all()):
        raise AssertionError(f"pool: step_chunk differs from ScanTracker.track (bbox {box_err})")
    # the same chunk as a tensor already on the card is used where it lies
    pool.state, pool._step_count = start, count
    got_card = pool.step_chunk(on_card)
    card_err = np.abs(got_card["bbox"] - got["bbox"]).max()
    if not card_err <= 1e-3:
        raise AssertionError(f"pool: step_chunk on card frames differs from host frames (bbox {card_err})")
    print(f"[8] step_chunk T=4 == ScanTracker.track: bbox max|err| {box_err}; frames on the card == host "
          f"frames: {card_err}", flush=True)

    # blank frames under "reinit": every failed slot gets a new template
    reinit = StreamPool(tracker, cap, hw, failure_policy="reinit")
    fill(reinit)
    before = reinit.state.template_feats.float().cpu()
    out = reinit.step(np.zeros((cap, *hw, 3), np.uint8))
    after = reinit.state.template_feats.float().cpu()
    changed = (after - before).flatten(1).abs().amax(1) > 0
    failed = torch.from_numpy(out["failure"])
    if not failed.any() or not torch.equal(changed, failed):
        raise AssertionError(f"reinit: {int(failed.sum())} failed, {int(changed.sum())} re-templated")
    print(f"[8] reinit: blank frames failed {int(failed.sum())}/{cap} slots, all re-templated", flush=True)
    del reinit

    stats = pipelined_online_benchmark(
        dispatch=lambda: pool.step_async(frames[int(time.time() * 30) % len(frames)]),
        fetch=lambda h: h.result(), duration_s=3.0, input_fps=30.0, depth=2, device="cuda")
    print(f"[8] pipelined online cap {cap}, 30 fps, depth 2, 3 s: completed {stats['completed']:.0f}, "
          f"dropped {stats['dropped']:.0f}, latency p50 {stats['latency_p50_ms']:.2f} ms, "
          f"p99 {stats['latency_p99_ms']:.2f} ms, device peak {stats['hbm_high_watermark_mb']:.0f} MiB "
          f"[{card}]", flush=True)
    return launches


def _render_clip(seed: int, n_frames: int, hw=(256, 480)):
    """(frames, boxes): a textured object moving on an ellipse and changing
    scale over a noise background, rendered with numpy from ``seed``;
    ``boxes`` (n, 4) xywh float64 is its true box
    (``tools/make_npy_dataset.py:render_clip``)."""
    from feartracker_tpu_torch.tools.make_npy_dataset import render_clip

    return render_clip(seed, n_frames, hw)


# phase 9d's configurations: static, dual EMA every 4th update, and zoom-out
# recovery with a threshold the clip's confidences (0.989-1.0 on the CPU)
# cross, so that the wider window is really taken
SEQUENTIAL_CONFIGS = {
    "static": {},
    "dual_ema": dict(dynamic_template=True, update_interval=4),
    "recover": dict(recover_context=3.0, recover_threshold=0.995),
}


SEQ_CLIP_FRAMES = 30  # phase 9's clip (and 11b-c's): init + 29 updates
PROTOCOL_CLIPS = 2  # 9g-9h's in-memory suite: clips of 24 frames


def _fear_tracker(device, dtype, **kw):
    from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net, variables_from_npz
    from feartracker_tpu_torch.models.fear_net import build_family_model
    from feartracker_tpu_torch.tracker.tracker import FEARTracker

    model = load_fear_net(build_family_model("fear_xs"), variables_from_npz(PACKAGED_FEAR_XS))
    return FEARTracker(model, dtype=dtype, device=device, **kw)


def _track_clip(tracker, frames, box):
    """initialize + one update per frame → (boxes (n-1, 4), confidences,
    number of dual refreshes, number of recovery crops)."""
    import numpy as np

    tracker.initialize(frames[0], box)
    out, refreshes, recoveries = [], 0, 0
    for f in frames[1:]:
        dyn = tracker._dyn_features
        recoveries += bool(tracker.recover_context and tracker.last_confidence < tracker.recover_threshold)
        out.append(tracker.update(f))
        refreshes += tracker._dyn_features is not dyn
    return (np.array([o["bbox"] for o in out], np.float64), np.array([o["confidence"] for o in out]),
            refreshes, recoveries)


def _protocol_suite(seqs, name: str = "synthetic"):
    """An in-memory GOT-10k-like dataset of decoded frames (``read_img``
    passes arrays through)."""
    from feartracker_tpu_torch.data.sequence import SequenceDataset

    class InMemory(SequenceDataset):
        def __init__(self):
            super().__init__()
            self.name = name
            self._sequences = [(f"clip{i}", frames, boxes) for i, (frames, boxes) in enumerate(seqs)]

    return InMemory()


def _protocols(device, seqs, dtype):
    """The three protocols on ``seqs`` in ``dtype`` on ``device``: OPE and
    VOT with ``FEARTracker``, letterboxed ``batched_evaluate`` with
    ``ScanTracker``."""
    from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
    from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker
    from feartracker_tpu_torch.evaluate.vot_eval import evaluate_vot

    ds = _protocol_suite(seqs)
    tracker = _fear_tracker(device, dtype)
    scan, _ = build_scan_tracker(dtype=dtype, device=device)
    h, w = seqs[0][0][0].shape[:2]
    return {
        "ope": evaluate_tracker(tracker, ds),
        "vot": evaluate_vot(tracker, ds),
        "batched": batched_evaluate(scan, ds, streams=len(seqs), frame_hw=(h, w)),
    }


def _kernel_trace_ms(fn, n: int, out_dir: str):
    """Device busy ms per call of ``fn`` over ``n`` calls, from the kernel,
    copy and memset rows of a ``torch.profiler`` trace (op rows repeat their
    kernels' time); None when the trace holds no device rows."""
    import torch

    from feartracker_tpu_torch.evaluate.profiling import trace

    with trace(out_dir):
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with open(f"{out_dir}/trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    busy = sum(e.get("dur", 0) for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return busy / 1e3 / n if busy else None


def _protocol_clips():
    """9g-9h's in-memory suite: ``PROTOCOL_CLIPS`` rendered clips of 24
    frames."""
    return [_render_clip(seed=20 + i, n_frames=24) for i in range(PROTOCOL_CLIPS)]


def _seq_witness(device: str, work: str = "", counters=None) -> dict:
    """Phase 9's side of its card-vs-CPU checks on ``device`` (``work``
    unused): 9d's three configurations over the clip in float32, each with
    its launches where ``counters`` are given; 9g's protocols in float32;
    9h's ``track`` and protocols in bfloat16."""
    import torch

    frames, boxes = _render_clip(seed=9, n_frames=SEQ_CLIP_FRAMES)
    sequential = {}
    for name, kw in SEQUENTIAL_CONFIGS.items():
        tracker = _fear_tracker(device, torch.float32, **kw)
        if counters:
            torch.cuda.synchronize()
            _zero(counters)
        got = _track_clip(tracker, frames, boxes[0])
        if counters:
            torch.cuda.synchronize()
        sequential[name] = (got, _read(counters) if counters else None)
    seqs = _protocol_clips()
    return {"sequential": sequential, "protocols": _protocols(device, seqs, torch.float32),
            "bf16_track": _bf16_track(device, torch.bfloat16, seqs),
            "bf16_protocols": _protocols(device, seqs, torch.bfloat16)}


def _phase_sequential(card, n_fused, counters, gen):
    """Phase 9: the sequential tracker and the evaluation protocols at S=1.
    Returns (launch counts by path, kernel times at S=1, update p50 ms by
    dtype)."""
    import numpy as np
    import torch

    from feartracker_tpu_torch.core import postprocess as pp
    from feartracker_tpu_torch.data.crops import get_extended_crop
    from feartracker_tpu_torch.evaluate.profiling import ir_block_bound, time_ms
    from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK
    from feartracker_tpu_torch.ops.cuda.build import load_library
    from feartracker_tpu_torch.ops.cuda.decode import postprocess_cuda
    from feartracker_tpu_torch.ops.cuda.ir_block import _fused_ir_block, fused_ir_block, plan_split
    from feartracker_tpu_torch.ops.fused_trunk import plain_ir_block

    dev = torch.device("cuda")
    # -- 9a: frames
    frames, boxes = _render_clip(seed=9, n_frames=SEQ_CLIP_FRAMES)
    H, W = frames[0].shape[:2]
    print(f"[9a] clip: {len(frames)} frames {W}x{H}, object {boxes[:, 2].min():.0f}-{boxes[:, 2].max():.0f} px "
          f"wide", flush=True)

    # -- 9b: the crop, card against CPU, byte for byte
    edge_boxes = [boxes[0], boxes[SEQ_CLIP_FRAMES // 2], (2, 100, 40, 30), (W - 42, 100, 40, 30), (200, 1, 40, 30),
                  (200, H - 31, 40, 30), (0, 0, 60, 50), (W - 61, H - 51, 60, 50), (10, 10, W - 20, H - 20)]
    n_crops = 0
    for img in (frames[0], frames[3 * SEQ_CLIP_FRAMES // 4]):
        on_card = torch.from_numpy(img).to(dev)
        for box in edge_boxes:
            box = np.asarray(box, np.float64)
            for size, offset, pad in ((128, 0.2, None), (256, 2.0, img.mean(axis=(0, 1))), (256, 3.0, None)):
                got = get_extended_crop(on_card, box, size, offset, pad)
                want = get_extended_crop(img, box, size, offset, pad)
                if not (torch.equal(got[0].cpu(), want[0]) and np.array_equal(got[1], want[1])
                        and np.array_equal(got[2], want[2])):
                    raise AssertionError(f"crop {box} size {size} offset {offset}: card differs from CPU")
                n_crops += 1
    print(f"[9b] get_extended_crop card == CPU byte for byte: {n_crops} crops (template 128², search "
          f"256² at context 2 and 3; windows past every side of the frame)", flush=True)

    # -- 9c: K2 at every FEAR-XS block shape and K1, at S=1. float32 also at
    # G=1 and at one chunk a group; a line per float32 block: kernel and
    # plain ms, the bound and its term, the kernel's share of it, G, blocks
    # per SM
    lib = load_library()
    tol = {torch.float32: 1e-4, torch.bfloat16: 0.15}
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    k2_times = {}
    for crop in (256, 128):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt)[6:]
            per_block, terms = [], {}
            for i, spec, cin, h in _block_shapes(FEAR_XS_TRUNK, crop):
                if spec.expansion == 1:
                    continue
                blk = _random_block(gen, cin, spec, dt, dev)
                x = torch.randn(1, h, h, cin, generator=gen, device=dev).to(dt)
                ref = plain_ir_block(x, blk, spec).float()
                ce, ho = cin * spec.expansion, h // spec.stride
                for groups in ((None, 1, -(-ce // 32)) if dt == torch.float32 else (None,)):
                    got = _fused_ir_block(x, blk, spec, True, False, None, groups).float()
                    e = (got - ref).abs().max().item()
                    if not e <= tol[dt]:
                        raise AssertionError(f"K2 S=1 block{i} crop {crop} {dt} groups {groups}: max|err| {e} "
                                             f"> {tol[dt]}")
                    err[dt] = max(err[dt], e)
                km = time_ms(lambda: fused_ir_block(x, blk, spec), iters=50)
                pm = time_ms(lambda: plain_ir_block(x, blk, spec), iters=50)
                bound, by, bterms = ir_block_bound(1, h, cin, spec, name)
                for key, v in bterms.items():
                    terms[key] = terms.get(key, 0.0) + v
                per_block.append((i, km, pm))
                if dt == torch.float32:
                    G = plan_split(1, ho, ho, ce)
                    occ = lib.fear_ir_block_occupancy(spec.kernel, spec.stride, cin, spec.out_channels, 0, 8, 8)
                    print(f"[9c] K2 block{i:2d} S=1 x (1,{h},{h},{cin}) f32 {spec}: kernel {km:.4f} ms, plain "
                          f"{pm:.4f} ms; bound {bound:.5f} ms by {by} ({', '.join(f'{t} {v:.5f}' for t, v in bterms.items())}), "
                          f"kernel at {100 * bound / km:.1f}% of it; G {G}, {(-(-ho // 8)) ** 2 * G} blocks, {occ} per "
                          f"SM [{card}]", flush=True)
            ms, plain = sum(b[1] for b in per_block), sum(b[2] for b in per_block)
            by = max(terms, key=terms.get)
            k2_times[f"{crop}_{name}"] = {"ms": ms, "plain_ms": plain, "bound_ms": terms[by],
                                          "bound_by": "bytes" if by == "bytes" else "operations"}
            print(f"[9c] K2 S=1 {crop}² {name}: {n_fused} blocks within atol {tol[dt]}; sum kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms ({ms / plain:.3f}x); bound {terms[by]:.5f} ms by {by} "
                  f"({', '.join(f'{t} {v:.5f}' for t, v in terms.items())}), kernel at {100 * terms[by] / ms:.1f}%; "
                  f"per block (kernel/plain ms) {' '.join(f'{i}:{k:.3f}/{p:.3f}' for i, k, p in per_block)} "
                  f"[{card}]", flush=True)
    reg = torch.rand(1, 16, 16, 4, generator=gen, device=dev) * 40 + 4
    logits = torch.randn(1, 16, 16, 1, generator=gen, device=dev)
    prev = torch.rand(1, 2, generator=gen, device=dev) * 60 + 20
    k1_err = 0.0
    for smooth in (False, True):
        cfg = pp.PostprocessConfig(smooth=smooth)
        ref = pp.postprocess(logits, reg, cfg, prev_size=prev)
        got = postprocess_cuda(logits, reg, cfg, prev_size=prev)
        torch.testing.assert_close(got.bbox, ref.bbox, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(got.confidence, ref.confidence, rtol=1e-5, atol=1e-6)
        if not torch.equal(got.pred_coords, ref.pred_coords):
            raise AssertionError(f"K1 S=1 smooth={smooth}: coords differ from the plain twin")
        k1_err = max(k1_err, (got.bbox - ref.bbox).abs().max().item())
    k1_times = {dt: _k1_times(pp.PostprocessConfig(), 1, dt, dev) for dt in (torch.float32, torch.bfloat16)}
    # a launch costs about one small kernel's time whatever it computes: K1's
    # S=1 time stands for it, so 13 K2 launches take at least 13 of them
    k1_s1 = k1_times[torch.float32]["postprocess_ms"]
    for t in k2_times.values():
        t["launch_floor_ms"] = n_fused * k1_s1
    print(f"[9c] K1 S=1 decode alone, both smooth modes: bbox max|err| {k1_err:.3e}, coords exact; K2 S=1 max|err| "
          f"f32 {err[torch.float32]:.3e} (planner's G, 1 and one chunk a group), bf16 {err[torch.bfloat16]:.3e}; "
          f"K2's practical floor at S=1: {n_fused} launches x K1's {k1_s1:.4f} ms = {n_fused * k1_s1:.4f} ms "
          f"[{card}]", flush=True)
    for t in k1_times.values():
        print(f"[9c] K1 S=1: " + _k1_line(t) + f" [{card}]", flush=True)

    # -- 9f: timing on the card, after warmup
    seq_ms = {}
    for dt in (torch.float32, torch.bfloat16):
        tracker = _fear_tracker("cuda", dt)
        init_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracker.initialize(frames[0], boxes[0])
            torch.cuda.synchronize()
            init_ms.append((time.perf_counter() - t0) * 1e3)
        for f in frames[1:11]:
            tracker.update(f)
        wall = []
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        tracker.initialize(frames[0], boxes[0])
        e0.record()
        for rep in range(2):
            for f in frames[1:]:
                t0 = time.perf_counter()
                tracker.update(f)  # ends with the read of box and confidence
                wall.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        torch.cuda.synchronize()
        span = e0.elapsed_time(e1) / len(wall)
        it = iter(frames[1:21])
        busy = _kernel_trace_ms(lambda: tracker.update(next(it)), 20, f"chiprun_out/trace_sequential_{str(dt)[6:]}")
        p50, p99 = np.percentile(wall, 50), np.percentile(wall, 99)
        seq_ms[str(dt)[6:]] = p50
        share = "not measured" if busy is None else f"{busy:.3f} ms ({100 * busy / np.mean(wall):.1f}% of the wall)"
        print(f"[9f] FEARTracker {str(dt)[6:]:8s} update over {len(wall)}: wall p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
              f"mean {np.mean(wall):.3f} ms ({1e3 / np.mean(wall):.1f} frames/s); CUDA-event span "
              f"{span:.3f} ms per update; device busy {share}; initialize p50 {np.median(init_ms):.3f} ms "
              f"[{card}]", flush=True)

    # -- 9d, 9e, 9g, 9h: the card's side of each card-vs-CPU check, the
    # host's in its own process meanwhile (started after 9f's timing)
    host = _host_refs("9")
    mine = _seq_witness("cuda", counters=counters)
    # the static configuration again under torch's defaults, as a user's
    # process runs it: cuDNN convolutions (the stem, the head) may take TF32
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        dflt_boxes, dflt_conf, _, _ = _track_clip(_fear_tracker("cuda", torch.float32), frames, boxes[0])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    refs = host()

    # -- 9d, 9e: boxes card vs CPU in float32; launch counts over init + N updates
    N = len(frames) - 1
    launches = {}
    for name in SEQUENTIAL_CONFIGS:
        (cpu_boxes, cpu_conf, cpu_ref, _), _ = refs["sequential"][name]
        (got_boxes, got_conf, refreshes, recoveries), counts = mine["sequential"][name]
        box_err = np.abs(got_boxes - cpu_boxes).max()
        conf_err = np.abs(got_conf - cpu_conf).max()
        if not (box_err <= 1.0 and conf_err <= 1e-3 and refreshes == cpu_ref):
            raise AssertionError(f"sequential {name} f32 card vs cpu: bbox {box_err} px, confidence {conf_err}, "
                                 f"refreshes {refreshes} vs {cpu_ref}")
        want = {"K1": N, "K2": n_fused * (1 + N + refreshes)}
        if counts != want:
            raise AssertionError(f"sequential {name}: launches {counts}, expected {want}")
        if name == "dual_ema" and not refreshes:
            raise AssertionError("sequential dual_ema: no refresh ran")
        if name == "recover" and not recoveries:
            raise AssertionError("sequential recover: the wider window was never taken")
        launches["sequential" if name == "static" else f"sequential_{name}"] = counts
        print(f"[9d] FEARTracker {name:8s} f32, init + {N} updates, card vs cpu: bbox max|err| {box_err} px "
              f"(<= 1), confidence {conf_err:.2e} (<= 1e-3); {refreshes} refreshes, {recoveries} recovery "
              f"crops; [9e] launches {counts} = K1 {N}, K2 {n_fused}*(1 + {N} + {refreshes})", flush=True)
        if name == "static":
            dflt_err = np.abs(dflt_boxes - cpu_boxes).max()
            if not dflt_err <= 1.0:
                raise AssertionError(f"sequential static f32 under torch's TF32 defaults: bbox {dflt_err} px > 1")
            print(f"[9d] FEARTracker static   f32 under torch's defaults (cudnn.allow_tf32=True), card vs cpu: "
                  f"bbox max|err| {dflt_err} px (<= 1), confidence {np.abs(dflt_conf - cpu_conf).max():.2e}",
                  flush=True)

    # -- 9g: the three protocols on an in-memory suite, card vs CPU
    card_r, cpu_r, n_clips = mine["protocols"], refs["protocols"], PROTOCOL_CLIPS
    ao = {k: (card_r[k]["ao"], cpu_r[k]["ao"]) for k in ("ope", "batched")}
    vot = (card_r["vot"]["robustness_failures"], cpu_r["vot"]["robustness_failures"])
    if not (all(abs(a - b) <= 0.01 for a, b in ao.values()) and vot[0] == vot[1]
            and abs(card_r["vot"]["accuracy"] - cpu_r["vot"]["accuracy"]) <= 0.01):
        raise AssertionError(f"protocols card vs cpu: AO {ao}, VOT failures {vot}")
    if not (card_r["ope"]["num_sequences"] == card_r["batched"]["num_sequences"] == n_clips
            and min(a for a, _ in ao.values()) > 0.5):
        raise AssertionError(f"protocols on the card: {card_r['ope']['num_sequences']} sequences, AO {ao}")
    print(f"[9g] protocols, {n_clips} x 24 frames, f32, card vs cpu: OPE AO {ao['ope'][0]:.4f} vs "
          f"{ao['ope'][1]:.4f}; batched (ScanTracker, S={n_clips}) AO {ao['batched'][0]:.4f} vs "
          f"{ao['batched'][1]:.4f}; VOT accuracy {card_r['vot']['accuracy']:.4f} vs "
          f"{cpu_r['vot']['accuracy']:.4f}, failures {vot[0]:.0f} vs {vot[1]:.0f}, EAO "
          f"{card_r['vot']['eao']:.4f}", flush=True)
    return launches, {"K1": k1_times[torch.float32], "K2": k2_times}, seq_ms, mine, refs


# phase 9h's tolerances for bfloat16 on the card: boxes at S=4, T=8 against
# the same port in bfloat16 on the CPU (the kernels' bf16 rounding against
# the twins' and the CPU convolutions'; measured 3.0 px on the H100) and
# against the card's own float32 boxes (bf16 against f32; measured 2.0 px),
# each with 2-3x headroom; protocol AO and VOT failures against the CPU in
# bfloat16 (measured AO within 0.004, failures equal)
BF16_BOX_PX = {"cpu_bf16": 6.0, "card_f32": 6.0}
BF16_AO, BF16_VOT_FAILURES = 0.02, 1


BF16_TRACK_T = 8  # 9h's track: T frames after the template's


def _bf16_track(device, dtype, seqs, T: int = BF16_TRACK_T) -> dict:
    """9h's ``track`` at S=len(seqs), T on the first T+1 frames of ``seqs``
    on ``device`` in ``dtype`` → its outputs as float32 on the CPU."""
    import numpy as np
    import torch

    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker

    f0 = np.stack([frames[0] for frames, _ in seqs])
    chunk = np.stack([np.stack([frames[t] for frames, _ in seqs]) for t in range(1, T + 1)])
    boxes = np.stack([b[0] for _, b in seqs]).astype(np.float32)
    tracker, _ = build_scan_tracker(dtype=dtype, device=device)
    _, out = tracker.track(tracker.init(f0, boxes), chunk)
    got = {k: v.float().cpu() for k, v in out.items()}
    if not all(torch.isfinite(v).all() for v in got.values()):
        raise AssertionError(f"bf16 phase: non-finite {dtype} outputs on {device}")
    return got


def _phase_bf16(card, card9, host9):
    """Phase 9h: the bfloat16 path end to end on the card. ``track`` at
    S=2, T=8 on the first 9 frames of 9g's two clips (an object to track:
    on random frames, as in 5a, bf16 and f32 boxes wander apart by 100 px
    and more) against the port in bfloat16 on the CPU and against the
    card's own float32 boxes; then 9g's protocols in bfloat16, card against
    CPU (each side's bfloat16 runs from its ``_seq_witness``: ``card9`` and
    ``host9``, phase 9's host process)."""
    import torch

    S, T = PROTOCOL_CLIPS, BF16_TRACK_T
    mine, cpu, f32 = card9["bf16_track"], host9["bf16_track"], _bf16_track("cuda", torch.float32, _protocol_clips())
    errs = {"cpu_bf16": (mine["bbox"] - cpu["bbox"]).abs().max().item(),
            "card_f32": (mine["bbox"] - f32["bbox"]).abs().max().item()}
    conf = (mine["confidence"] - cpu["confidence"]).abs().max().item()
    if not all(errs[k] <= BF16_BOX_PX[k] for k in errs):
        raise AssertionError(f"bf16 track S={S} T={T}: bbox max|err| {errs} px, limits {BF16_BOX_PX}")
    print(f"[9h] slice bf16 S={S} T={T} (9g's clips) on the card: bbox max|err| {errs['cpu_bf16']:.4f} px vs the port in bf16 on the "
          f"cpu (<= {BF16_BOX_PX['cpu_bf16']}), {errs['card_f32']:.4f} px vs the card's f32 boxes (<= "
          f"{BF16_BOX_PX['card_f32']}); confidence vs cpu bf16 {conf:.2e}", flush=True)

    card_r, cpu_r = card9["bf16_protocols"], host9["bf16_protocols"]
    ao = {k: (card_r[k]["ao"], cpu_r[k]["ao"]) for k in ("ope", "batched")}
    vot = (card_r["vot"]["robustness_failures"], cpu_r["vot"]["robustness_failures"])
    if not (all(abs(a - b) <= BF16_AO for a, b in ao.values()) and abs(vot[0] - vot[1]) <= BF16_VOT_FAILURES
            and min(a for a, _ in ao.values()) > 0.5):
        raise AssertionError(f"protocols bf16 card vs cpu: AO {ao}, VOT failures {vot}")
    print(f"[9h] protocols, {S} x 24 frames, bf16, card vs cpu: OPE AO {ao['ope'][0]:.4f} vs "
          f"{ao['ope'][1]:.4f}; batched AO {ao['batched'][0]:.4f} vs {ao['batched'][1]:.4f} (each within "
          f"{BF16_AO}); VOT accuracy {card_r['vot']['accuracy']:.4f} vs {cpu_r['vot']['accuracy']:.4f}, "
          f"failures {vot[0]:.0f} vs {vot[1]:.0f} (within {BF16_VOT_FAILURES}) [{card}]", flush=True)


# phase 10's tolerances, graphed against eager on the card: the same kernels
# on the same inputs, so equal bits are expected
GRAPH_BOX_PX, GRAPH_CONF = 1e-3, 1e-5


def _diff(a: dict, b: dict) -> float:
    """Largest |a - b| over the float tensors both dicts hold; inf where an
    integer or boolean tensor differs."""
    import torch

    err = 0.0
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if x.is_floating_point():
            err = max(err, (x.float() - y.float()).abs().max().item())
        elif not torch.equal(x, y):
            return float("inf")
    return err


def _two_chunks(tracker, f0, boxes, chunk, start: int):
    """``init`` and two ``track`` calls, the second from the first's state;
    call 1's outputs must not change under call 2 (no graph memory leaks
    out). → (final state as a dict, call 1's outputs, call 2's outputs)."""
    import torch

    T = chunk.shape[0]
    state, out1 = tracker.track(tracker.init(f0, boxes), chunk, start_step=start)
    kept = {k: v.clone() for k, v in out1.items()}
    state, out2 = tracker.track(state, chunk, start_step=start + T)
    torch.cuda.synchronize()
    if _diff(kept, out1) != 0.0:
        raise AssertionError("a graphed track call changed the outputs of the call before it")
    return state._asdict(), out1, out2


def _graph_vs_eager(ref, got, what: str) -> dict:
    """Boxes, confidence, every other output and the state, graphed against
    eager; raises past ``GRAPH_BOX_PX`` / ``GRAPH_CONF``."""
    errs = {"bbox": max(_diff({"b": r["bbox"]}, {"b": g["bbox"]}) for r, g in zip(ref[1:], got[1:])),
            "confidence": max(_diff({"c": r["confidence"]}, {"c": g["confidence"]}) for r, g in zip(ref[1:], got[1:])),
            "outputs": max(_diff(r, g) for r, g in zip(ref[1:], got[1:])),
            "state": _diff(ref[0], got[0])}
    if not (errs["bbox"] <= GRAPH_BOX_PX and errs["confidence"] <= GRAPH_CONF and errs["outputs"] <= GRAPH_BOX_PX
            and errs["state"] <= GRAPH_BOX_PX):
        raise AssertionError(f"{what}: graphed vs eager {errs}")
    return errs


def _phase_graphs(card, n_fused, counters, eager_static, eager_dual, lap):
    """Phase 10: ``scan_unroll`` (CUDA graphs of K steps), the bench and
    ``native_preprocess``. ``eager_static`` and ``eager_dual`` are phases
    5b's and 7b's trackers, the eager twins of 10a and 10b. Returns the
    launches of one ``track`` call of the K=16 tracker whose graph was
    captured before it: the kernels its replay ran (the wrappers' counters
    go up at capture, where a kernel is recorded and nothing runs, and stay
    at 0 through a replay)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, synthetic_streams
    from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK
    from feartracker_tpu_torch.ops.cuda.ir_block import plan_split, stream_tickets

    bf16, f32 = torch.bfloat16, torch.float32
    # -- 10a: the static path, bf16 S=128 T=16, graphed against eager
    S, T = 128, 16
    f0, chunk, boxes = synthetic_streams(S, T, seed=1, device="cuda")
    trackers = {1: eager_static}
    ref = _two_chunks(trackers[1], f0, boxes, chunk, 0)
    graph_launches = {}
    for K in (4, 16):
        trackers[K] = build_scan_tracker(dtype=bf16, device="cuda", scan_unroll=K)[0]
        t0 = time.perf_counter()
        got = _two_chunks(trackers[K], f0, boxes, chunk, 0)
        first_s = time.perf_counter() - t0
        errs = _graph_vs_eager(ref, got, f"static bf16 K={K}")
        # one call of the captured graphs, counted from 0: replays only
        state = trackers[K].init(f0, boxes)
        torch.cuda.synchronize()
        _zero(counters)
        replayed = trackers[K].replayed_launches
        replayed.update({k: 0 for k in replayed})
        trackers[K].track(state, chunk)
        torch.cuda.synchronize()
        eager_launches, graph_launches[K] = _read(counters), dict(replayed)
        want = {"K1": T, "K2": n_fused * T, "K3": T}
        if eager_launches != {"K1": 0, "K2": 0} or graph_launches[K] != want:
            raise AssertionError(f"static K={K}, one track call: replayed launches {graph_launches[K]}, expected "
                                 f"{want}; eager launches {eager_launches}, expected none")
        units = trackers[K]._unrolled
        print(f"[10a] static bf16 S={S} T={T} scan_unroll={K}: {len(units)} graph(s) of {K} steps ("
              f"{next(iter(units.values())).kernels} kernel nodes each, recorded at capture), two chunks graphed vs "
              f"eager: bbox max|err| {errs['bbox']} px (<= {GRAPH_BOX_PX}), confidence {errs['confidence']:.2e} "
              f"(<= {GRAPH_CONF}), other outputs {errs['outputs']:.2e}, state {errs['state']:.2e}; call 1's outputs "
              f"unchanged after call 2; one more call, counted from 0: replayed launches {graph_launches[K]}, eager "
              f"{eager_launches}; first two calls incl. warm-up and capture {first_s:.2f} s", flush=True)
    lap("10a")

    # -- 10b: the dual path of 7b at K=4, cadence phases 0 and 1
    dual = dict(dynamic_template=True, update_mode="feature", gate_params="fear_xs_feature_gate",
                update_interval=4, recover_context=3.0)
    eager = eager_dual
    graphed = build_scan_tracker(dtype=bf16, device="cuda", scan_unroll=4, **dual)[0]
    for start in (0, 1):
        errs = _graph_vs_eager(_two_chunks(eager, f0, boxes, chunk, start),
                               _two_chunks(graphed, f0, boxes, chunk, start), f"dual K=4 start {start}")
        print(f"[10b] dual bf16 S={S} T={T} feature, update_interval=4, recover_context=3, scan_unroll=4, "
              f"start_step={start}: graphed vs eager bbox {errs['bbox']} px, confidence {errs['confidence']:.2e}, "
              f"gate_obs and other outputs {errs['outputs']:.2e}, state (dyn_feats incl.) {errs['state']:.2e}",
              flush=True)
    print(f"[10b] dual graphs by cadence phase: {sorted(k[-1] for k in graphed._unrolled)}, "
          f"K2 per graph {[u.kernels['K2'] for u in graphed._unrolled.values()]}", flush=True)
    del eager, graphed
    lap("10b")

    # -- 10c: float32 S=4 T=8 at K=4, K2's tickets used inside the graph
    splits = [plan_split(4, h // s.stride, h // s.stride, cin * s.expansion)
              for _, s, cin, h in _block_shapes(FEAR_XS_TRUNK, 256) if s.expansion > 1]
    if max(splits) < 2:
        raise AssertionError(f"10c: no f32 block splits its chunks at S=4 ({splits}): the tickets go unused")
    sf0, schunk, sboxes = synthetic_streams(4, 8, seed=0, device="cpu")
    runs = {}
    for name, device, K in (("eager", "cuda", 1), ("graph", "cuda", 4), ("cpu", "cpu", 1)):
        tracker = build_scan_tracker(dtype=f32, device=device, scan_unroll=K)[0]
        runs[name] = _two_chunks(tracker, sf0, sboxes, schunk, 0)
        if name == "graph":
            # each unit holds the very buffer its captured launches use
            tickets = stream_tickets(torch.device("cuda", torch.cuda.current_device()),
                                     tracker._graph_stream().cuda_stream)
            if not all(u.tickets is not None and u.tickets is tickets for u in tracker._unrolled.values()):
                raise AssertionError("10c: a float32 graph does not hold its stream's ticket buffer")
    errs = _graph_vs_eager(runs["eager"], runs["graph"], "f32 S=4 K=4")
    cpu_box = max((g["bbox"].cpu() - c["bbox"]).abs().max().item() for g, c in zip(runs["graph"][1:], runs["cpu"][1:]))
    cpu_conf = max((g["confidence"].cpu() - c["confidence"]).abs().max().item()
                   for g, c in zip(runs["graph"][1:], runs["cpu"][1:]))
    if not (cpu_box <= 1.0 and cpu_conf <= 1e-3):
        raise AssertionError(f"10c: f32 graphed vs cpu: bbox {cpu_box} px, confidence {cpu_conf}")
    print(f"[10c] f32 S=4 T=8 scan_unroll=4 (K2 chunk groups per block {splits}: the tickets in the graph): "
          f"graphed vs eager card bbox {errs['bbox']} px, confidence {errs['confidence']:.2e}, state "
          f"{errs['state']:.2e}; vs the cpu bbox {cpu_box} px (<= 1), confidence {cpu_conf:.2e} (<= 1e-3)",
          flush=True)
    lap("10c")

    # -- 10d: ms per track, eager against graphed, in turns
    order = [1, 4, 16, 16, 4, 1]
    ms = {K: [] for K in trackers}
    state = {K: trackers[K].init(f0, boxes) for K in trackers}
    for K in trackers:
        state[K], _ = trackers[K].track(state[K], chunk)
    reps = 3
    for K in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state[K], _ = trackers[K].track(state[K], chunk)
        torch.cuda.synchronize()
        ms[K].append((time.perf_counter() - t0) * 1e3 / reps)
    print(f"[10d] ms per track bf16 S={S} T={T}, {reps} calls a turn, turns eager, 4, 16, 16, 4, eager: eager "
          f"{ms[1][0]:.2f} / {ms[1][1]:.2f}, scan_unroll=4 {ms[4][0]:.2f} / {ms[4][1]:.2f}, scan_unroll=16 "
          f"{ms[16][0]:.2f} / {ms[16][1]:.2f} ms ({S * T / min(ms[16]) * 1e3:.1f} frames/s at K=16, "
          f"{S * T / min(ms[1]) * 1e3:.1f} eager) [{card}]", flush=True)
    del trackers, state
    lap("10d")

    # -- 10e: the port's bench, short, in its own process
    env = {**os.environ, "BENCH_WARMUP": "2", "BENCH_TIMED": "3", "BENCH_REPEATS": "1"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "feartracker_tpu_torch.bench"], capture_output=True, text=True,
                          env=env, timeout=300)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench: rc {proc.returncode}, stdout {proc.stdout[-1000:]!r}, stderr "
                             f"{proc.stderr[-2000:]!r}")
    rec = json.loads(lines[0])
    if rec["weights"] != "fear_xs" or not rec["value"] > 0:
        raise AssertionError(f"bench: {rec}")
    print(f"[10e] python -m feartracker_tpu_torch.bench (BENCH_WARMUP=2 BENCH_TIMED=3 BENCH_REPEATS=1, "
          f"{time.perf_counter() - t0:.1f} s): {proc.stdout.splitlines()[0]} | {lines[0]}", flush=True)
    lap("10e")

    # -- 10f: native_preprocess on phase 9's clip, card against CPU
    frames, true_boxes = _render_clip(seed=9, n_frames=21)  # phase 9's clip, its first 21 frames
    native = {device: _fear_tracker(device, f32, native_preprocess=True) for device in ("cuda", "cpu")}
    got = {device: _track_clip(tracker, frames, true_boxes[0]) for device, tracker in native.items()}
    box_err = np.abs(got["cuda"][0] - got["cpu"][0]).max()
    conf_err = np.abs(got["cuda"][1] - got["cpu"][1]).max()
    if not (box_err <= 1.0 and conf_err <= 1e-3):
        raise AssertionError(f"native_preprocess card vs cpu: bbox {box_err} px, confidence {conf_err}")
    print(f"[10f] FEARTracker native_preprocess f32, init + {len(frames) - 1} updates, card vs cpu: bbox max|err| "
          f"{box_err} px (<= 1), confidence {conf_err:.2e} (<= 1e-3)", flush=True)
    # the two crop paths side by side: update wall p50 over the clip after a
    # warm-up, and the device rows of one traced update
    cost = {}
    for name, tracker in (("cv2", _fear_tracker("cuda", f32)), ("native", native["cuda"])):
        tracker.initialize(frames[0], true_boxes[0])
        for f in frames[1:6]:
            tracker.update(f)
        wall = []
        for f in frames[1:]:
            t0 = time.perf_counter()
            tracker.update(f)
            wall.append((time.perf_counter() - t0) * 1e3)
        with tempfile.TemporaryDirectory() as tmp:
            br = _trace_breakdown(lambda: tracker.update(frames[1]), tmp)
        cost[name] = (np.percentile(wall, 50), br.get("kernels"), br.get("busy_ms"))
    print(f"[10f] f32 update, cv2-exact crop against native_preprocess: wall p50 {cost['cv2'][0]:.3f} / "
          f"{cost['native'][0]:.3f} ms; one traced update {cost['cv2'][1]} / {cost['native'][1]} kernels and "
          f"copies, device busy {cost['cv2'][2]} / {cost['native'][2]} ms [{card}]", flush=True)
    lap("10f")
    return graph_launches[16]


def _reference_state_dict(seed: int):
    """FEAR-XS as a reference Lightning checkpoint holds it: the packaged
    ``fear_xs.npz`` weights under the reference's module names and order
    (``model.`` prefixed; the layout of ``tests/test_lightning_import.py``),
    each conv weight scaled elementwise by (1 + 0.02·N(0, 1)) drawn from
    ``seed``. The cls head's pointwise conv is scaled by 10: the reference's
    head multiplies by a literal 0.1, which the CoreML-recovered weights have
    folded in."""
    import numpy as np
    import torch

    from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net, variables_from_npz
    from feartracker_tpu_torch.models.fear_net import build_family_model

    model = load_fear_net(build_family_model("fear_xs"), variables_from_npz(PACKAGED_FEAR_XS))
    src = {k: v.numpy() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(ref, port, bias=False, scale=1.0):
        w = src[f"{port}.weight"]
        sd[f"{ref}.weight"] = w * (1 + 0.02 * rng.randn(*w.shape)) * scale
        if bias:
            sd[f"{ref}.bias"] = src[f"{port}.bias"] * scale

    def bn(ref, port):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{ref}.{leaf}"] = src[f"{port}.{leaf}"]
        sd[f"{ref}.num_batches_tracked"] = np.asarray(100)

    conv("encoder.model.backbone.stages.0.conv", "encoder.stem.conv")
    bn("encoder.model.backbone.stages.0.bn", "encoder.stem.bn")
    for i, spec in enumerate(model.trunk_blocks):
        ref, port = f"encoder.model.backbone.stages.{i + 1}", f"encoder.block{i}"
        for ref_part, port_part in (("pw", "expand"), ("dw", "dw"), ("pwl", "project")):
            if port_part == "expand" and spec.expansion == 1:
                continue
            conv(f"{ref}.{ref_part}.conv", f"{port}.{port_part}.conv")
            bn(f"{ref}.{ref_part}.bn", f"{port}.{port_part}.bn")
    conv("neck.downsample.0", "neck.downsample.conv")
    bn("neck.downsample.1", "neck.downsample.bn")
    head = "connect_model"
    for name in ("cls_encode", "reg_encode"):
        conv(f"{head}.{name}.matrix11_s.0.depthwise", f"{head}.{name}.sep.dw")
        conv(f"{head}.{name}.matrix11_s.0.pointwise", f"{head}.{name}.sep.pw")
        bn(f"{head}.{name}.matrix11_s.1", f"{head}.{name}.bn")
    for name in ("cls_dw", "reg_dw"):
        conv(f"{head}.{name}.enc.0.depthwise", f"{head}.{name}.enc.sep.dw", bias=True)
        conv(f"{head}.{name}.enc.0.pointwise", f"{head}.{name}.enc.sep.pw", bias=True)
        bn(f"{head}.{name}.enc.1", f"{head}.{name}.enc.bn")
    for tower in ("bbox_tower", "cls_tower"):
        for i in range(model.connect_model.towernum):
            conv(f"{head}.{tower}.{3 * i}.depthwise", f"{head}.{tower}{i}.sep.dw", bias=True)
            conv(f"{head}.{tower}.{3 * i}.pointwise", f"{head}.{tower}{i}.sep.pw", bias=True)
            bn(f"{head}.{tower}.{3 * i + 1}", f"{head}.{tower}{i}.bn")
    for pred, scale in (("bbox_pred", 1.0), ("cls_pred", 10.0)):
        conv(f"{head}.{pred}.depthwise", f"{head}.{pred}.dw", bias=True)
        conv(f"{head}.{pred}.pointwise", f"{head}.{pred}.pw", bias=True, scale=scale)
    sd[f"{head}.adjust"] = src[f"{head}.adjust"]
    sd[f"{head}.bias"] = src[f"{head}.bias"].reshape(1, 4, 1, 1)
    return {f"model.{k}": torch.from_numpy(np.asarray(v, np.int64 if k.endswith("tracked") else np.float32))
            for k, v in sd.items()}


def _wall_ms(fn, n: int) -> float:
    """Host wall ms per call over ``n`` calls ended by one synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _phase_deployment(card, n_fused, counters, lap):
    """Phase 11: the deployment surfaces on the card. 11a the exported pairs
    against the eager folded path and K2's operator against its wrapper;
    11b ``ExportedTracker`` against ``FEARTracker``; 11c the demo in its own
    process and in-process; 11d a reference ``.ckpt`` through
    ``load_variables``. Returns the launch counts by path."""
    import os
    import tempfile

    import numpy as np
    import torch

    from feartracker_tpu_torch import demo
    from feartracker_tpu_torch.convert.export import ExportedTracker, export_tracker, load_exported
    from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net, load_variables
    from feartracker_tpu_torch.evaluate.harness import synthetic_streams
    from feartracker_tpu_torch.models.fear_net import build_family_model
    from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK
    from feartracker_tpu_torch.ops.crop import normalize_imagenet
    from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block, fused_ir_block_op, ir_block_op_cuda
    from feartracker_tpu_torch.tracker.runtime import ScanTracker

    launches = {}
    model = load_fear_net(build_family_model("fear_xs"), load_variables(PACKAGED_FEAR_XS))
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    paths = export_tracker(model, tmp.name, device="cuda")
    export_s = time.perf_counter() - t0
    sizes = {k: os.path.getsize(v) for k, v in paths.items()}

    # -- 11a: each exported pair against the eager folded path on seeded crops
    gen = torch.Generator(device="cuda").manual_seed(11)
    template = torch.randint(0, 256, (1, 128, 128, 3), generator=gen, device="cuda").float()
    search = torch.randint(0, 256, (1, 256, 256, 3), generator=gen, device="cuda").float()
    for suffix, dtype in (("", torch.float32), ("_quantized", torch.bfloat16)):
        init_g, track_g = load_exported(paths[f"tracker_init{suffix}"]), load_exported(paths[f"tracker{suffix}"])
        eager = ScanTracker(model, dtype=dtype, device="cuda")

        def eager_track():
            feats = eager._features(normalize_imagenet(search))
            out = eager.model.connector(want_feats.to(dtype), feats)
            return out["TARGET_REGRESSION_LABEL_KEY"].float(), out["TARGET_CLASSIFICATION_KEY"].float()

        with torch.inference_mode():
            want_feats = eager._features(normalize_imagenet(template)).float()
            torch.cuda.synchronize()
            _zero(counters)
            ir_block_op_cuda.calls = 0
            feats = init_g(template)
            torch.cuda.synchronize()
            init_counts = {**_read(counters), "op": ir_block_op_cuda.calls}
            _zero(counters)
            ir_block_op_cuda.calls = 0
            reg, cls = track_g(search, want_feats)
            torch.cuda.synchronize()
            track_counts = {**_read(counters), "op": ir_block_op_cuda.calls}
            want_reg, want_cls = eager_track()
            errs = {"feats": (feats - want_feats).abs().max().item(), "reg": (reg - want_reg).abs().max().item(),
                    "cls": (cls - want_cls).abs().max().item()}
            want_counts = {"K1": 0, "K2": n_fused, "op": n_fused}
            if init_counts != want_counts or track_counts != want_counts:
                raise AssertionError(f"11a {dtype}: an exported call launched {init_counts} / {track_counts}, "
                                     f"expected {want_counts}")
            # the same kernels on the same folded weights, in the same dtype:
            # any difference is a cast or a weight the export got wrong
            if max(errs.values()) != 0 or not all(torch.isfinite(t).all() for t in (feats, reg, cls)):
                raise AssertionError(f"11a {dtype}: exported vs eager max|err| {errs}, expected equality")
            launches[f"export_tracker{suffix}"] = {k: track_counts[k] for k in ("K1", "K2")}
            track_call = lambda: track_g(search, want_feats)  # noqa: E731
            turns = [_wall_ms(f, 50) for f in (eager_track, track_call, track_call, eager_track)]
        print(f"[11a] exported pair {str(dtype)[6:]} (tracker_init{suffix}.pt2 {sizes[f'tracker_init{suffix}']} B, "
              f"tracker{suffix}.pt2 {sizes[f'tracker{suffix}']} B) vs the eager folded path, S=1: max|err| feats "
              f"{errs['feats']:.2e}, reg {errs['reg']:.2e}, cls {errs['cls']:.2e} (== 0); each exported "
              f"call K2 {track_counts['K2']} launches through the operator, K1 0; wall ms per tracker call over 50, "
              f"turns eager / exported / exported / eager: {' / '.join(f'{t:.3f}' for t in turns)} [{card}]",
              flush=True)
    # K2's operator against its wrapper: the same launches, and the
    # dispatcher's host cost per call (13 bf16 blocks at S=1, 256², queued
    # 20 times over without a wait, turns wrapper / op / op / wrapper), on
    # the bf16 tracker's folded blocks
    items = []
    h, cin = 128, 16
    for spec, blk in zip(FEAR_XS_TRUNK, eager.folded["blocks"]):
        if spec.expansion > 1:
            x = torch.randn(1, h, h, cin, generator=gen, device="cuda").to(torch.bfloat16)
            if not torch.equal(fused_ir_block_op(x, blk, spec), fused_ir_block(x, blk, spec)):
                raise AssertionError(f"11a: K2's operator and its wrapper differ at {spec} x {tuple(x.shape)}")
            items.append((x, blk, spec))
        h //= spec.stride
        cin = spec.out_channels

    def enqueue_us(fn, reps=20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            for x, blk, spec in items:
                fn(x, blk, spec)
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt * 1e6 / (reps * len(items))

    with torch.inference_mode():
        enqueue_us(fused_ir_block_op)
        host = [enqueue_us(f) for f in (fused_ir_block, fused_ir_block_op, fused_ir_block_op, fused_ir_block)]
    dispatch_us = (host[1] + host[2] - host[0] - host[3]) / 2
    print(f"[11a] K2 host cost per call, {len(items)} bf16 blocks at S=1 256² queued 20x without a wait, turns "
          f"wrapper / operator / operator / wrapper: {' / '.join(f'{t:.2f}' for t in host)} us; the operator's "
          f"dispatcher adds {dispatch_us:.2f} us a call, {dispatch_us * n_fused / 1e3:.4f} ms a frame's {n_fused} "
          f"launches (outputs equal bit for bit); export of both pairs {export_s:.1f} s [{card}]", flush=True)
    lap("11a")
    host12a = _host_refs("12a")  # 12a's host side, beside 11b-11d; phase 12 reads it

    # -- 11b: ExportedTracker on phase 9's clip (the launch counts) and four
    # more seeds against FEARTracker on the card: each pair against the
    # tracker in its own dtype, and the quantized pair against float32
    exported = {suffix: ExportedTracker(paths[f"tracker_init{suffix}"], paths[f"tracker{suffix}"], device="cuda")
                for suffix in ("", "_quantized")}
    trackers = {"": _fear_tracker("cuda", torch.float32), "_quantized": _fear_tracker("cuda", torch.bfloat16)}
    err = {}  # seed -> {"": f32 pair vs f32, "_quantized": vs bf16, "vs_f32": quantized pair vs f32}
    for seed in (9, 10, 11):
        frames, true_boxes = _render_clip(seed=seed, n_frames=SEQ_CLIP_FRAMES)
        N = len(frames) - 1
        want = {k: _track_clip(t, frames, true_boxes[0])[0] for k, t in trackers.items()}
        got = {}
        for suffix, tracker in exported.items():
            torch.cuda.synchronize()
            _zero(counters)
            ir_block_op_cuda.calls = 0
            got[suffix] = _track_clip(tracker, frames, true_boxes[0])[0]
            torch.cuda.synchronize()
            counts = _read(counters)
            want_counts = {"K1": N, "K2": n_fused * (1 + N)}
            if counts != want_counts or ir_block_op_cuda.calls != want_counts["K2"]:
                raise AssertionError(f"11b ExportedTracker{suffix} seed {seed}: launches {counts}, operator calls "
                                     f"{ir_block_op_cuda.calls}, expected {want_counts}")
            if seed == 9:
                launches[f"exported_tracker{suffix}"] = counts
        err[seed] = {k: float(np.abs(got[k] - want[k]).max()) for k in got}
        err[seed]["vs_f32"] = float(np.abs(got["_quantized"] - want[""]).max())
        if seed == 9:
            seq = want[""]
    vs_f32 = [e["vs_f32"] for e in err.values()]
    print(f"[11b] ExportedTracker, init + {N} updates a clip, seeds {list(err)} (9 is phase 9's clip) vs "
          f"FEARTracker on the card: bbox max|err| f32 pair vs f32 {[e[''] for e in err.values()]} px (<= 1), "
          f"quantized pair vs bf16 {[e['_quantized'] for e in err.values()]} px (<= 1), quantized pair vs f32 "
          f"{vs_f32} px (<= {BF16_BOX_PX['card_f32']}; min {min(vs_f32)}, median {float(np.median(vs_f32))}, max "
          f"{max(vs_f32)}); launches a clip {launches['exported_tracker']} = K1 {N}, K2 {n_fused}*(1 + {N}), "
          f"every K2 through the operator", flush=True)
    if not all(e[""] <= 1.0 and e["_quantized"] <= 1.0 and e["vs_f32"] <= BF16_BOX_PX["card_f32"]
               for e in err.values()):
        raise AssertionError(f"11b ExportedTracker vs FEARTracker on the card: bbox max|err| by seed {err}")
    frames, true_boxes = _render_clip(seed=9, n_frames=SEQ_CLIP_FRAMES)
    N = len(frames) - 1
    lap("11b")

    # -- 11c: the demo, in its own process and in-process, on that clip as .npy
    clip = os.path.join(tmp.name, "clip.npy")
    np.save(clip, np.stack(frames))
    box = [str(int(v)) for v in true_boxes[0]]
    other = ["40", "40", "60", "50"]
    want_final = list(map(int, seq[-1]))
    runs, argvs, procs = {}, {}, {}
    t0 = time.perf_counter()
    for name, extra in (("demo", ["--initial_bbox", *box]),
                        ("demo_scan", ["--runtime", "scan", "--initial_bbox", *box, *other])):
        argvs[name] = ["--device", "cuda", "--weights_path", PACKAGED_FEAR_XS, "--video_path", clip,
                       "--output_path", os.path.join(tmp.name, f"{name}.npz"), *extra]
        # both processes at once: neither is timed
        procs[name] = subprocess.Popen([sys.executable, "-m", "feartracker_tpu_torch.demo", *argvs[name]],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for name, argv in argvs.items():
            out, err = procs[name].communicate(timeout=300)
            finals = [line for line in out.splitlines() if line.startswith("final bbox")]
            if procs[name].returncode != 0 or not finals:
                raise AssertionError(f"{name}: rc {procs[name].returncode}, stdout {out[-1000:]!r}, stderr "
                                     f"{err[-2000:]!r}")
            boxes = [[int(v) for v in line.split("[")[-1].rstrip("]").split(",")] for line in finals]
            # the same entry point in this process, counted from 0
            torch.cuda.synchronize()
            _zero(counters)
            demo.main(argv)
            torch.cuda.synchronize()
            counts = _read(counters)
            want = {"K1": N, "K2": n_fused * (1 + N)}
            if counts != want:
                raise AssertionError(f"{name} in-process: launches {counts}, expected {want}")
            launches[name] = counts
            runs[name] = (boxes, time.perf_counter() - t0)
    finally:
        for p in procs.values():  # stop what still runs after a failure
            _stop(p)
    if runs["demo"][0] != [want_final]:
        raise AssertionError(f"11c demo final bbox {runs['demo'][0]} != FEARTracker's {want_final} on the card")
    scan = runs["demo_scan"][0]
    if len(scan) != 2 or np.abs(np.asarray(scan[0]) - want_final).max() > 1:
        raise AssertionError(f"11c demo --runtime scan finals {scan}, object 0 vs FEARTracker's {want_final}")
    print(f"[11c] python -m feartracker_tpu_torch.demo --device cuda, {len(frames)} frames .npy -> .npz: exit 0, final "
          f"bbox {runs['demo'][0][0]} == FEARTracker's on the card; --runtime scan with 2 objects: finals {scan} "
          f"(object 0 within 1 px); launches in-process {launches['demo']} host, {launches['demo_scan']} scan "
          f"(K1 one a frame for both objects); {runs['demo'][1]:.1f} / {runs['demo_scan'][1]:.1f} s from the start "
          f"of both processes, run at once, to the end of each one's in-process run", flush=True)
    lap("11c")

    # -- 11d: a reference Lightning .ckpt through load_variables, card vs CPU
    ckpt = os.path.join(tmp.name, "fear.ckpt")
    torch.save({"state_dict": _reference_state_dict(seed=5), "epoch": 0}, ckpt)
    ref_model = load_fear_net(build_family_model("fear_xs"), load_variables(ckpt))
    f0, chunk, sboxes = synthetic_streams(4, 8, seed=0, device="cpu")
    outs = {}
    for device in ("cuda", "cpu"):
        tracker = ScanTracker(ref_model, dtype=torch.float32, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
            _zero(counters)
        _, out = tracker.track(tracker.init(f0, sboxes), chunk)
        outs[device] = {k: v.cpu() for k, v in out.items()}
        if device == "cuda":
            torch.cuda.synchronize()
            launches["ckpt_scan"] = _read(counters)
    box_err = (outs["cuda"]["bbox"] - outs["cpu"]["bbox"]).abs().max().item()
    conf_err = (outs["cuda"]["confidence"] - outs["cpu"]["confidence"]).abs().max().item()
    if not (box_err <= 1.0 and conf_err <= 1e-3 and torch.isfinite(outs["cuda"]["bbox"]).all()):
        raise AssertionError(f"11d .ckpt track f32 S=4 T=8 card vs cpu: bbox {box_err} px, confidence {conf_err}")
    if launches["ckpt_scan"] != {"K1": 8, "K2": n_fused * 9}:
        raise AssertionError(f"11d launches {launches['ckpt_scan']}")
    spread = outs["cuda"]["bbox"][..., 2:].std().item()
    print(f"[11d] seeded reference state dict -> torch.save .ckpt -> load_variables -> ScanTracker f32 S=4 T=8: card "
          f"vs cpu bbox max|err| {box_err} px (<= 1), confidence {conf_err:.2e} (<= 1e-3); box size spread "
          f"{spread:.1f} px; launches {launches['ckpt_scan']}", flush=True)
    tmp.cleanup()
    lap("11d")
    return launches, dispatch_us, host12a


# phase 12's tolerances: float32 card (cuDNN, TF32 off) against the CPU
TRAIN_LOSS_RTOL = 1e-4
TRAIN_STATS_RTOL = 1e-4
# the card's float32 gradient against the same step in float64 on the CPU:
# within 1e-3 of the gradient's max |value| over all tensors, and within
# 5e-2 of each tensor's own max (float32 reads 7.8e-4 / 3.2e-2 on the H100
# and 2.0e-3 / 1.2e-2 on the CPU: the worst tensors are the smallest, bias
# and BatchNorm gradients near 2e-4 of the max, sums over B·H·W that cancel)
TRAIN_GRAD_F64_ATOL = 1e-3
TRAIN_GRAD_F64_OWN = 5e-2
TRAIN_AUG_RTOL = 1e-4  # augmented pixels, card against CPU
# the training configuration's dataset sizes (conf/dataset/got10k_train.yaml,
# conf/tracker/siam_tracker.yaml)
TRAIN_SIZES = {"search_image_size": 256, "template_image_size": 128, "search_context": 2,
               "template_bbox_offset": 0.2, "search_image_shift": 48, "search_image_scale": 0.35,
               "context_range": 3}


def _grad_errors(got: dict, ref: dict):
    """(max |got − ref| over the gradient's max |ref|, max |got − ref| over
    each tensor's own max |ref| where that is above a millionth of the
    gradient's max, the number of tensors below it: analytically zero
    gradients, such as a conv bias before a BatchNorm in train mode, of
    which both sides compute only rounding noise)."""
    gmax = max(float(r.abs().max()) for r in ref.values())
    err_all, err_own, zero = 0.0, 0.0, 0
    for k, r in ref.items():
        d = float((got[k] - r).abs().max())
        err_all = max(err_all, d / gmax)
        own = float(r.abs().max())
        if own < 1e-6 * gmax:
            zero += 1
        else:
            err_own = max(err_own, d / own)
    return err_all, err_own, zero


def _stat_error(got: dict, ref: dict) -> float:
    """Max over the BatchNorm statistics of |got − ref| / (|ref| + the
    tensor's max |ref|·1e-0): an rtol with a floor at the tensor's scale
    (a channel's mean may cancel to near zero)."""
    err = 0.0
    for k, r in ref.items():
        err = max(err, float(((got[k] - r).abs() / (r.abs() + r.abs().max())).max()))
    return err


def _opt_to(opt, device, dtype):
    """An optimizer state's tensors on ``device``, floating ones in ``dtype``."""
    if isinstance(opt, dict):
        return {k: _opt_to(v, device, dtype) for k, v in opt.items()}
    return opt.to(device, dtype) if opt.is_floating_point() else opt.to(device)


def _f32_start(restored: bool):
    """12a's starting point: FEAR-XS from ``fear_xs.npz`` and a fresh Adam
    state, or (18c, ``restored``) the state the JAX trainer's Orbax
    checkpoint restores → (model, opt_state or None)."""
    import os

    from feartracker_tpu_torch.models.fear_net import FEARNet
    from feartracker_tpu_torch.tools.train_profile import build_model
    from feartracker_tpu_torch.train.checkpoint import CheckpointManager
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state

    if not restored:
        return build_model("fear_xs")[0], None
    tx = build_optimizer({"name": "adam", "lr": 1e-4})
    here = os.path.dirname(os.path.abspath(__file__))
    state = CheckpointManager(os.path.join(here, *ORBAX_FIXTURE, "checkpoints"), optimizer=tx).restore_last(
        create_train_state(FEARNet(), tx, device="cpu"))
    return state.model, state.opt_state


def _f32_step(model, opt_state, d, dt):
    """One Adam step (lr 1e-4) of a copy of ``model`` on 12a's seeded batch
    (B=8, 256²/128²) on ``d`` in ``dt`` → (loss, gradients, BatchNorm
    statistics, seconds), on the CPU in float64."""
    import copy

    import torch

    from feartracker_tpu_torch.core.box_coder import BoxCoderSpec
    from feartracker_tpu_torch.tools.train_profile import synthetic_train_batch
    from feartracker_tpu_torch.train.optim import apply_updates, build_optimizer
    from feartracker_tpu_torch.train.step import make_loss_and_grads, params_of

    batch = synthetic_train_batch(8, 128, 256, BoxCoderSpec(), "cpu", seed=12)
    t0 = time.perf_counter()
    net = copy.deepcopy(model).to(d, dt)
    tx = build_optimizer({"name": "adam", "lr": 1e-4})
    params = params_of(net)
    opt = tx.init(params) if opt_state is None else _opt_to(opt_state, d, dt)
    total, _, _, grads = make_loss_and_grads()(net, {k: v.to(d, dt) for k, v in batch.items()})
    with torch.no_grad():
        updates, opt = tx.update(grads, opt, {k: p.detach() for k, p in params.items()})
        apply_updates(params, updates)
    stats = {k: v.cpu().double() for k, v in net.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    return float(total), {k: g.cpu().double() for k, g in grads.items()}, stats, time.perf_counter() - t0


def _phase_train_f32(card, dev, host, tag="12a"):
    """12a: one float32 Adam step of FEAR-XS at B=8, card against CPU, and
    both against the same gradient in float64 on the CPU, from
    ``fear_xs.npz`` and a fresh state, or (18c) from the state the JAX
    trainer's Orbax checkpoint restores; the CPU's two steps from ``host``,
    a host process (``_host_refs``) started earlier."""
    import torch

    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    model, opt_state = _f32_start(tag == "18c")
    res = {"card": _f32_step(model, opt_state, dev, torch.float32), **host()}
    (lc, gc, sc, tc), (lg, gg, sg, tg), g64 = res["cpu"], res["card"], res["f64"][1]
    loss_err = abs(lg - lc) / abs(lc)
    err_all, err_own, zero = _grad_errors(gg, gc)
    card_all, card_own, _ = _grad_errors(gg, g64)
    cpu_all, cpu_own, _ = _grad_errors(gc, g64)
    stat_err = _stat_error(sg, sc)
    print(f"[{tag}] FEAR-XS f32 Adam step B=8 256²/128², card vs CPU: loss {lg:.6f} vs {lc:.6f} (rel {loss_err:.2e}, "
          f"rtol {TRAIN_LOSS_RTOL}); BatchNorm statistics rel {stat_err:.2e} (rtol {TRAIN_STATS_RTOL}); "
          f"gradients ({len(gc)} tensors, {zero} analytically zero) card vs CPU {err_all:.2e} of the gradient's "
          f"max, {err_own:.2e} of each tensor's own; against float64 on the CPU: card {card_all:.2e} / "
          f"{card_own:.2e} (limits {TRAIN_GRAD_F64_ATOL} / {TRAIN_GRAD_F64_OWN}), CPU f32 {cpu_all:.2e} / "
          f"{cpu_own:.2e}; "
          f"wall {tg:.2f} s card with cuDNN's first calls, {tc:.2f} s CPU (4 threads, in a process of its own "
          f"beside the card's side) [{card}]", flush=True)
    assert loss_err <= TRAIN_LOSS_RTOL, loss_err
    assert stat_err <= TRAIN_STATS_RTOL, stat_err
    assert card_all <= TRAIN_GRAD_F64_ATOL and card_own <= TRAIN_GRAD_F64_OWN, (card_all, card_own)


TRAIN_PROFILE_BATCHES, TRAIN_PROFILE_STEPS = (32, 64, 128), 4  # 12b: 2 warm-up + 2 timed steps a batch size


def _phase_train_profile(card):
    """12b: the training sweep at the configuration's width in its own
    process."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "feartracker_tpu_torch.tools.train_profile",
                           "--batches", ",".join(map(str, TRAIN_PROFILE_BATCHES)), "--warmup", "2",
                           "--timed", str(TRAIN_PROFILE_STEPS - 2)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == card, lines[0]
    records = [json.loads(line) for line in lines if line.startswith("{")]
    assert [r["batch"] for r in records] == list(TRAIN_PROFILE_BATCHES), lines
    for line in lines[1:]:
        print(f"[12b] {line}", flush=True)
    for r in records:
        assert r["steps"] == TRAIN_PROFILE_STEPS and r["loss_first"] == r["loss_first"] and r["loss_last"] < r["loss_first"], r
    print(f"[12b] train_profile bf16 B={'/'.join(map(str, TRAIN_PROFILE_BATCHES))}: step {', '.join(f'{r['step_ms']:.2f}' for r in records)} ms, "
          f"{', '.join(f'{r['samples_per_s']:.1f}' for r in records)} samples/s, peak "
          f"{', '.join(f'{r['peak_mem_bytes'] / 2**30:.2f}' for r in records)} GiB, "
          f"{', '.join(f'{r['mfu_pct']:.2f}' for r in records)}% of 989 TFLOP/s; loss "
          f"{', '.join(f'{r['loss_first']:.4f}→{r['loss_last']:.4f}' for r in records)} over {TRAIN_PROFILE_STEPS} steps; first "
          f"steps {', '.join(f'{r['first_step_ms'] / 1e3:.1f}' for r in records)} s (each shape's first calls); "
          f"{time.perf_counter() - t0:.1f} s in its own process [{card}]", flush=True)
    return records


def _phase_train_data(card, dev, counters, root):
    """12c: the card's data path into the step with device augmentations;
    → (state, step, one staged batch on the card, launches of the step)."""
    import itertools
    import os

    import torch

    from feartracker_tpu_torch.data import device_augs as augs
    from feartracker_tpu_torch.data.dataset import SiameseTrackingDataset
    from feartracker_tpu_torch.data.loader import BatchLoader, prefetch_to_device
    from feartracker_tpu_torch.tools.make_npy_dataset import write_npy_dataset
    from feartracker_tpu_torch.tools.train_profile import build_model
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state, make_train_step

    B, n_steps = 32, 4
    csv_path = write_npy_dataset(root)
    cfg = {"root": root, "name": "rendered", "sizes": dict(TRAIN_SIZES), "regression_weight_label_size": 16,
           "device_augs": True,
           "sampling": {"type": "track", "data_path": csv_path, "negative_ratio": 0.0, "frame_offset": 70,
                        "num_samples": B * n_steps, "clip_range": True}}
    dataset = SiameseTrackingDataset(cfg, {"score_size": 16, "total_stride": 16}, seed=0)
    workers = len(os.sched_getaffinity(0))
    loader = BatchLoader(dataset, B, num_workers=workers, seed=0)
    # the loader alone: host ms per batch over the epoch's first half
    assert len(dataset) == B * n_steps and len(loader) == n_steps, (len(dataset), len(loader))
    t0 = time.perf_counter()
    host_batches = list(itertools.islice(loader, n_steps // 2))
    host_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)

    aug_cfg = augs.DeviceAugConfig(search_size=256, scale=0.35, shift=48.0, grid_size=16, total_stride=16)
    tx = build_optimizer({"name": "adam", "lr": 1e-4})
    state = create_train_state(build_model("fear_xs")[0], tx, device=dev)
    step = make_train_step(tx, device_augs=aug_cfg, aug_seed=0, dtype=torch.bfloat16)
    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, staged = [], None
    for batch in prefetch_to_device(iter(loader), dev):
        staged = staged or dict(batch)
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    launches = _read(counters)
    losses = [float(v) for v in losses]
    assert len(losses) == n_steps and all(v == v and abs(v) < 1e6 for v in losses), losses
    assert launches == {"K1": 0, "K2": 0}, launches

    # the step alone on a batch already on the card
    def one():
        step(state, dict(staged))

    step_ms = _wall_ms(one, 5)

    # augment_batch on the card against the CPU with the same drawn parameters
    params = augs.draw_params(staged, aug_cfg, augs.aug_generator(0, 0, dev))

    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_cpu(v) for v in x]
        return x.cpu() if isinstance(x, torch.Tensor) else x

    got = augs.apply_params(staged, params, aug_cfg)
    ref = augs.apply_params(to_cpu(staged), to_cpu(params), aug_cfg)
    from feartracker_tpu_torch.utils import constants as C

    mean = torch.tensor(C.IMAGENET_MEAN) * 255.0
    std = torch.tensor(C.IMAGENET_STD) * 255.0
    pix_err = 0.0
    for k in (C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY, C.TRACKER_TARGET_SEARCH_IMAGE_KEY):
        a, b = got[k].cpu() * std + mean, ref[k] * std + mean
        pix_err = max(pix_err, float(((a - b).abs() / (b.abs() + 255.0)).max()))
    box_diff = (got[C.TRACKER_TARGET_BBOX_KEY].cpu() - ref[C.TRACKER_TARGET_BBOX_KEY]).abs()
    same = box_diff.amax(dim=1) == 0
    label_ok = all(torch.equal(got[k].cpu()[same], ref[k][same]) for k in (
        C.TARGET_REGRESSION_LABEL_KEY, C.TARGET_CLASSIFICATION_KEY, C.TARGET_REGRESSION_WEIGHT_KEY))
    print(f"[12c] data path B={B}, {n_steps} steps bf16 with device augmentations from {len(dataset)} staged items "
          f"of .npy frames: loss {losses[0]:.4f} → {losses[-1]:.4f}; loader alone {host_ms:.1f} ms a batch on "
          f"{workers} threads, loader + step {e2e_ms:.1f} ms a step, step alone {step_ms:.1f} ms "
          f"({'the loader' if host_ms > step_ms else 'the step'} paces training on this host); launches in the "
          f"{n_steps} steps {launches}; augment_batch card vs CPU, same draws: pixels rel {pix_err:.2e} (rtol "
          f"{TRAIN_AUG_RTOL}), {int((~same).sum())} of {B} boxes differ (max {float(box_diff.max()):.0f} px), "
          f"labels of the equal boxes equal: {label_ok} [{card}]", flush=True)
    assert pix_err <= TRAIN_AUG_RTOL, pix_err
    assert float(box_diff.max()) <= 1.0 and label_ok
    return state, step, staged, launches, {"host_ms": host_ms, "step_ms": step_ms, "e2e_ms": e2e_ms}


def _phase_train_checkpoint(card, dev, state, step, staged, root):
    """12d: save, restore into a fresh state, one more step from each."""
    import os

    import torch

    from feartracker_tpu_torch.models.fear_net import FEARNet
    from feartracker_tpu_torch.train.checkpoint import CheckpointManager
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state

    mgr = CheckpointManager(os.path.join(root, "checkpoints"), max_to_keep=2)
    mgr.save(state.step, state, monitor=0.5, extra={"epoch": 1})
    fresh = create_train_state(FEARNet(), build_optimizer({"name": "adam", "lr": 1e-4}), device=dev)
    restored = mgr.restore_last(fresh)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        a, ma = step(state, dict(staged))
        b, mb = step(restored, dict(staged))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    differ = [k for (k, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values())
              if not torch.equal(p, q)]
    differ += [f"mu/{k}" for k, v in a.opt_state["mu"].items() if not torch.equal(v, b.opt_state["mu"][k])]
    print(f"[12d] checkpoint at step {state.step - 1} ({os.path.getsize(os.path.join(root, 'checkpoints', 'last', 'state.pt')) / 2**20:.1f} MiB) restored "
          f"into a fresh state: the next step's loss {float(ma['loss']):.6f} / {float(mb['loss']):.6f}, "
          f"{len(differ)} tensors differ, meta {mgr.load_meta()} [{card}]", flush=True)
    assert float(ma["loss"]) == float(mb["loss"]) and not differ and a.step == b.step, differ[:5]
    return b


def _phase_train_handover(card, dev, counters, state):
    """12e: the trained module in ``FEARTracker``, card against CPU."""
    import numpy as np
    import torch

    from feartracker_tpu_torch.tracker.tracker import FEARTracker

    frames, true_boxes = _render_clip(seed=9, n_frames=21)
    boxes, launches = {}, None
    for d in ("cpu", dev):
        tracker = FEARTracker(state.model, dtype=torch.float32, device=d)
        tracker.initialize(frames[0], true_boxes[0])
        _zero(counters)
        out = [tracker.update(f)["bbox"] for f in frames[1:]]
        if d != "cpu":
            launches = _read(counters)
        boxes[str(d)] = np.asarray(out, np.float64)
    n = len(frames) - 1
    px = float(np.abs(boxes[str(dev)] - boxes["cpu"]).max())
    print(f"[12e] trained module in FEARTracker f32: launches over {n} updates {launches} (K1 1, K2 13 an "
          f"update), boxes card vs CPU max {px:.0f} px (tol 1) [{card}]", flush=True)
    assert launches == {"K1": n, "K2": 13 * n}, launches
    assert px <= 1.0, px
    return launches


def _phase_train(card, counters, lap, root: str, host12a):
    """Phase 12: training on the card (12a-12e), 12c's clips and 12d's
    checkpoints written under ``root`` (phase 15 reads them), 12a's CPU
    side from ``host12a`` (``_host_refs``, started in phase 11); → (each
    path's launches, 12b's records)."""
    import torch

    dev = torch.device("cuda")
    _phase_train_f32(card, dev, host12a)
    lap("12a")
    profile = _phase_train_profile(card)
    lap("12b")
    state, step, staged, step_launches, _ = _phase_train_data(card, dev, counters, root)
    lap("12c")
    state = _phase_train_checkpoint(card, dev, state, step, staged, root)
    lap("12d")
    handover = _phase_train_handover(card, dev, counters, state)
    lap("12e")
    return {"train_step": step_launches, "train_handover_sequential": handover}, profile, staged


def _counted(fn, counters, into: dict, times: list):
    """``fn`` with the kernels it launches added into ``into`` and its wall
    seconds appended to ``times``."""

    def wrapped(*args, **kwargs):
        before, t0 = _read(counters), time.perf_counter()
        out = fn(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        for k, v in _read(counters).items():
            into[k] += v - before[k]
        return out

    return wrapped


# phase 13's validation: three 20-frame clips, each its own val dataset so
# that the per-dataset metrics are per-sequence ones; card against CPU
LOOP_VAL_CLIPS = 3
LOOP_VAL_FRAMES = 20
LOOP_SEQ_IOU_TOL = 0.02  # per-sequence mean IoU (phase 9's boxes: within 1 px)
LOOP_BATCHED_TOL = 0.1  # batched against sequential mean IoU (JAX's own test's bound)


def _phase_loop(card, counters, lap, step_alone_ms: float):
    """Phase 13: the training loop (``Trainer.fit``) on the card; → each
    of its paths' launches."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch

    from feartracker_tpu_torch.config import yaml_lite
    from feartracker_tpu_torch.config.compose import load_config, save_config
    from feartracker_tpu_torch.convert.load import load_fear_net, variables_from_npz
    from feartracker_tpu_torch.evaluate.harness import synthetic_streams
    from feartracker_tpu_torch.models.fear_net import FEARNet
    from feartracker_tpu_torch.tools.make_npy_dataset import render_clip, write_npy_dataset
    from feartracker_tpu_torch.tracker.runtime import ScanTracker
    from feartracker_tpu_torch.train.loop import Trainer
    from feartracker_tpu_torch.train.summary import read_events, scalars

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        write_npy_dataset(os.path.join(data, "got10k"))  # phase 12c's clips, where got10k_train looks
        exp = os.path.join(root, "exp")
        # -- 13a: the composed config, with no PyYAML
        overrides = [f"visual_object_tracking_datasets={data}", f"experiment.folder={exp}", "experiment.name=LOOP",
                     "model.pretrained_weights=fear_xs", "device_augs=true", "num_workers=8",
                     "batch_size.train=32", "train_percent=3", "max_epochs=2", "sanity_steps=1",
                     "log_every_n_steps=1", "save_top_k=2", "dynamic_frame_offset.start_epoch=1",
                     "dynamic_frame_offset.freq=1", "val.datasets=[]"]
        cfg = load_config("fear_tracker", overrides)
        path = os.path.join(root, "experiment_config.yaml")
        save_config(cfg, path)
        with open(path) as fh:
            back = yaml_lite.load(fh.read())
        assert back == cfg, "save_config did not read back equal"
        assert "yaml" not in sys.modules, "PyYAML was imported"
        assert (cfg["platform"], cfg["precision"], cfg["device_augs"], cfg["batch_size"]["train"]) == (
            "gpu", "bfloat16", True, 32), cfg
        print(f"[13a] load_config + {len(overrides)} overrides without PyYAML: backend gpu, bf16, device_augs, "
              f"B=32, {cfg['train_percent']} steps an epoch, {cfg['max_epochs']} epochs; save_config reads back "
              f"equal [{card}]", flush=True)
        lap("13a")

        # -- 13b: fit
        clips = [render_clip(seed=40 + i, n_frames=LOOP_VAL_FRAMES) for i in range(LOOP_VAL_CLIPS)]
        per_seq = [_protocol_suite([c], f"clip{i}") for i, c in enumerate(clips)]
        trainer = Trainer(cfg)
        trainer.setup_data()
        trainer.val_datasets = per_seq
        validate = trainer.validate
        step_k, val_k = {"K1": 0, "K2": 0}, {"K1": 0, "K2": 0}
        step_s, val_s, save_s, epochs = [], [], [], []
        trainer.train_step = _counted(trainer.train_step, counters, step_k, step_s)
        trainer.validate = _counted(validate, counters, val_k, val_s)
        trainer.ckpt.save = _counted(trainer.ckpt.save, counters, {"K1": 0, "K2": 0}, save_s)
        train_epoch = trainer.train_epoch

        def epoch_fn(epoch):
            out = train_epoch(epoch)
            epochs.append(dict(trainer.epoch_timing))
            return out

        trainer.train_epoch = epoch_fn
        _zero(counters)
        t0 = time.perf_counter()
        trainer.fit()
        fit_s = time.perf_counter() - t0
        total = _read(counters)
        report = {k: len(v) for k, v in trainer.transfer_report.items()}
        assert report == {"transferred": 307, "skipped_shape": 0, "missing": 0, "unused": 0}, report
        steps = sum(e["steps"] for e in epochs)
        assert trainer.state.step == steps == 2 * 3, (trainer.state.step, epochs)
        log = read_events(os.path.join(trainer.exp_dir, "logs"))
        events = scalars(log)
        losses = events["train/loss"]
        # step to step inside an epoch, from the event log's wall times
        walls = {e["step"]: e["wall_time"] for e in log for v in e.get("summary", ()) if v["tag"] == "train/loss"}
        periods = [walls[s] - walls[s - 1] for s in walls if s - 1 in walls and (s - 1) % cfg["train_percent"]]
        assert [s for s, _ in losses] == list(range(1, 7)) and all(np.isfinite(v) for _, v in losses), losses
        assert [s for s, _ in events["valid/metrics/box_iou"]] == [-1, 0, 1], events["valid/metrics/box_iou"]
        # sanity (val_percent 1 a dataset: every clip) and 2 epochs, each
        # clip initialized once and updated 39 times
        seqs = 3 * LOOP_VAL_CLIPS
        updates, inits = seqs * (LOOP_VAL_FRAMES - 1), seqs
        assert step_k == {"K1": 0, "K2": 0}, step_k
        assert val_k == {"K1": updates, "K2": 13 * (updates + inits)} == total, (val_k, total)
        offset = trainer.train_dataset.datasets[0].item_sampler.frame_offset
        assert offset == 70 + 2 * cfg["dynamic_frame_offset"]["step"], offset
        kept = sorted(int(d) for d in os.listdir(trainer.ckpt.directory) if d.isdigit())
        assert kept == [3, 6] and trainer.ckpt.has_last(), kept
        val_metrics = validate(9)
        val_ms = sum(val_s) * 1e3 / updates
        print(f"[13b] fit FEAR-XS bf16 B=32, {steps} steps in 2 epochs, warm start {report['transferred']} "
              f"leaves (full), losses {losses[0][1]:.4f} → {losses[-1][1]:.4f}; launches in the steps {step_k}, in "
              f"validation {val_k} over {updates} updates + {inits} initializes (K1 1, K2 13 each); frame_offset "
              f"70 → {offset}; checkpoints {kept} + last; events: train/loss at steps 1-{steps}, "
              f"valid/metrics/box_iou at epochs -1, 0, 1 [{card}]", flush=True)
        print(f"[13b] loop a step, epoch by epoch: "
              f"{', '.join(f'{e['wall_s'] * 1e3 / e['steps']:.1f}' for e in epochs)} ms (12b's step alone at B=32: "
              f"{step_alone_ms:.2f} ms), of it waiting for the loader and its copy "
              f"{', '.join(f'{e['wait_s'] * 1e3 / e['steps']:.1f}' for e in epochs)} ms (the first batches of an "
              f"epoch fill the prefetch); step to step inside an epoch (event wall times) "
              f"{', '.join(f'{p * 1e3:.1f}' for p in periods)} ms; step calls on the host "
              f"{', '.join(f'{t * 1e3:.1f}' for t in step_s)} ms; validation {val_ms:.2f} ms an update "
              f"({len(val_s)} calls, {sum(val_s):.2f} s, initializes included); checkpoint save "
              f"{', '.join(f'{t * 1e3:.1f}' for t in save_s)} ms; fit {fit_s:.1f} s [{card}]", flush=True)
        lap("13b")

        # 13g's command line starts here, in its own process, beside 13c-13f
        # (none of them timed), and is read after 13f
        t_cli = time.perf_counter()
        cli_log = tempfile.TemporaryFile("w+")
        cli = subprocess.Popen(
            [sys.executable, "-m", "feartracker_tpu_torch.train", f"visual_object_tracking_datasets={data}",
             f"experiment.folder={exp}", "experiment.name=CLI", "model.pretrained_weights=fear_xs",
             "device_augs=true", "batch_size.train=8", "train_percent=2", "max_epochs=1", "sanity_steps=0",
             "log_every_n_steps=1", "val.datasets=[]"],
            stdout=cli_log, stderr=subprocess.STDOUT, text=True)
        atexit.register(_stop, cli)  # should a check below raise

        # -- 13c: the card's validate() against a CPU Trainer's on the same
        # weights, the warm start (where the tracker follows the clips: a few
        # steps move the BatchNorm statistics of the packaged weights, whose
        # BatchNorms are identities, far enough to lose them)
        def start(platform, name):
            t = Trainer(dict(copy.deepcopy(cfg), platform=platform, experiment={"folder": exp, "name": name}))
            t.val_datasets = per_seq
            t.setup_state(0)
            return t

        card_start = start("gpu", "LOOP_START")
        card_metrics = card_start.validate(0)
        t0 = time.perf_counter()
        cpu_metrics = start("cpu", "LOOP_CPU").validate(0)
        cpu_s = time.perf_counter() - t0
        names = [f"clip{i}_box_iou" for i in range(LOOP_VAL_CLIPS)]
        diffs = [abs(card_metrics[k] - cpu_metrics[k]) for k in names]
        print(f"[13c] validate() card vs CPU on the warm start, per-sequence mean IoU "
              f"{', '.join(f'{card_metrics[k]:.4f}/{cpu_metrics[k]:.4f}' for k in names)}, max diff "
              f"{max(diffs):.2e} (tol {LOOP_SEQ_IOU_TOL}); CPU {cpu_s:.1f} s beside 13g's process; after the 6 steps (card) "
              f"{', '.join(f'{val_metrics[k]:.4f}' for k in names)} [{card}]", flush=True)
        assert sorted(card_metrics) == sorted(cpu_metrics) and max(diffs) <= LOOP_SEQ_IOU_TOL, (card_metrics,
                                                                                                cpu_metrics)
        lap("13c")

        # -- 13d: set_variables on the card, eager and under captured graphs
        start = load_fear_net(FEARNet(), variables_from_npz("fear_xs"))
        f0, chunk, boxes = synthetic_streams(4, 8, seed=3, device="cuda")
        kw = dict(dtype=torch.bfloat16, device="cuda", dynamic_template=True, update_mode="gated",
                  update_threshold=0.0)
        swaps = []
        for k in (1, 4):
            tracker = ScanTracker(start, scan_unroll=k, **kw)
            _, before = tracker.track(tracker.init(f0, boxes), chunk)
            units, replayed = len(tracker._unrolled), dict(tracker.replayed_launches)
            tracker.set_variables(trainer.state.model)
            _, got = tracker.track(tracker.init(f0, boxes), chunk)
            fresh = ScanTracker(trainer.state.model, scan_unroll=k, **kw)
            _, want = fresh.track(fresh.init(f0, boxes), chunk)
            differ = sum(int((got[n] != want[n]).sum()) for n in want)
            moved = float((before["bbox"] - want["bbox"]).abs().max())
            assert differ == 0 and moved > 0, (k, differ, moved)
            assert len(tracker._unrolled) == units, "set_variables recaptured"
            if k > 1:
                assert units and tracker.replayed_launches["K1"] > replayed["K1"], tracker.replayed_launches
            swaps.append(f"K={k}: {differ} elements differ from a fresh tracker, boxes moved {moved:.0f} px from "
                         f"the old weights' ({units} graph units kept)")
        print(f"[13d] set_variables bf16 S=4 T=8 gated dual template: {'; '.join(swaps)} [{card}]", flush=True)
        lap("13d")

        # -- 13e: resume from last for exactly one more epoch
        resumed = Trainer(dict(copy.deepcopy(cfg), resume=True, max_epochs=3))
        resumed.setup_data()
        resumed.val_datasets = per_seq
        resumed.fit()
        assert resumed.resumed_epoch == 2 and resumed.state.step == 9, (resumed.resumed_epoch, resumed.state.step)
        print(f"[13e] resume=True max_epochs=3: epoch 2 from the checkpoint's metadata, step 6 → "
              f"{resumed.state.step} [{card}]", flush=True)
        lap("13e")

        # -- 13f: batched validation at val_streams=2, the clips as one
        # dataset, on 13c's warm start
        card_start.val_datasets = [_protocol_suite(clips, "clips")]
        card_start.config.update(val_batched=True, val_streams=2, val_frame_hw=[256, 480])
        _zero(counters)
        t0 = time.perf_counter()
        batched_metrics = card_start.validate(1)
        batched_s = time.perf_counter() - t0
        batched = _read(counters)
        frames = 2 * (LOOP_VAL_FRAMES - 1)  # a group of 2 streams, then 1
        assert batched == {"K1": frames, "K2": 13 * (frames + 2)}, batched
        seq_mean = float(np.mean([card_metrics[k] for k in names]))
        assert {"box_iou", "clips_box_iou"} <= set(batched_metrics), batched_metrics
        assert abs(batched_metrics["box_iou"] - seq_mean) <= LOOP_BATCHED_TOL, (batched_metrics, seq_mean)
        print(f"[13f] _validate_batched val_streams=2: box_iou {batched_metrics['box_iou']:.4f} against the "
              f"sequential {seq_mean:.4f} (tol {LOOP_BATCHED_TOL}); launches {batched} ({frames} frames + 2 "
              f"inits); {batched_s:.2f} s beside 13g's process [{card}]", flush=True)
        lap("13f")

        # -- 13g: the command line in its own process, started after 13b
        try:
            rc = cli.wait(timeout=300)
        finally:
            _stop(cli)
        cli_log.seek(0)
        assert rc == 0, cli_log.read()[-4000:]
        cli_log.close()
        cli_losses = scalars(read_events(os.path.join(exp, "CLI", "logs")))["train/loss"]
        assert [s for s, _ in cli_losses] == [1, 2], cli_losses
        print(f"[13g] python -m feartracker_tpu_torch.train backend gpu, 1 epoch of 2 steps at B=8: exit 0, "
              f"losses {', '.join(f'{v:.4f}' for _, v in cli_losses)}, {time.perf_counter() - t_cli:.1f} s in its "
              f"own process, beside 13c-13f [{card}]", flush=True)
        lap("13g")
    print(f"[13] phase 13 {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return ({"train_loop_step": step_k, "train_loop_val_sequential": val_k, "train_loop_val_batched": batched},
            {k: card_metrics[k] for k in names})


# phase 14's tolerances: the data-parallel step on identical shards against
# one process's step on one shard, float32 with TF32 off, as the CPU test
# holds it (tests/test_torch_dp_step.py: JAX's own invariant), with each
# rank's BatchNorm statistics its own (averaged after the step). With
# cross-process statistics the step computes Flax's E[x²] − E[x]², which
# cancels in float32 where the single step's two-pass variance does not
# (tests/test_torch_warm_start.py: 3.5e-4 against 3.0e-5 of a statistic's
# scale from float64 after one step), and FEAR-XS's warm-start gradients
# carry that far: that run is printed, and held only to equal ranks. The
# sharded
# tracker at N=2 against ScanTracker, float32 S=4 T=8 (TF32 off), and in
# bfloat16 at S=128 within phase 9h's bound (other batch sizes of the
# head's library convolutions round other ways)
DP_PARAM_ATOL, DP_STAT_ATOL = 1e-6, 2e-5
DP_SGD = {"name": "sgd", "lr": 0.05}
SHARD_F32_PX = 1e-3
DP_F32_B = 8  # 14b's float32 shard
DP_VAL_ROW_ATOL = 1e-6  # 14c's gathered rows against phase 13's one-process rows


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dp_aug_cfg():
    from feartracker_tpu_torch.data.device_augs import DeviceAugConfig

    return DeviceAugConfig(search_size=256, scale=0.35, shift=48.0, grid_size=16, total_stride=16)


def _state_cpu(state) -> dict:
    return {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}


def _loop_config(data: str, exp: str, name: str, overrides=()):
    """Phase 13b's loop configuration (``load_config``) with ``overrides``."""
    from feartracker_tpu_torch.config.compose import load_config

    return load_config("fear_tracker", [
        f"visual_object_tracking_datasets={data}", f"experiment.folder={exp}", f"experiment.name={name}",
        "model.pretrained_weights=fear_xs", "device_augs=true", "batch_size.train=32", "train_percent=3",
        "max_epochs=2", "log_every_n_steps=1", "save_top_k=2", "dynamic_frame_offset.start_epoch=1",
        "dynamic_frame_offset.freq=1", "val.datasets=[]", *overrides])


def _dp_worker(rank: int, world: int, port: int, root: str) -> int:
    """One of phase 14's two processes on ``cuda:0`` over Gloo: 14b's steps,
    then 14c's ``Trainer.fit``; writes ``<root>/out<rank>.pt``."""
    import os

    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from feartracker_tpu_torch.models.blocks import set_sync_bn
    from feartracker_tpu_torch.ops.cuda import build as kbuild
    from feartracker_tpu_torch.ops.cuda.decode import postprocess_cuda
    from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block
    from feartracker_tpu_torch.parallel import multihost
    from feartracker_tpu_torch.parallel.mesh import shard_batch
    from feartracker_tpu_torch.tools.make_npy_dataset import render_clip
    from feartracker_tpu_torch.tools.train_profile import build_model
    from feartracker_tpu_torch.train import loop as L
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state, make_train_step

    kbuild.load_library()
    addr = f"127.0.0.1:{port}"
    multihost.initialize({"coordinator_address": addr, "num_processes": world, "process_id": rank,
                          "backend": "gloo"})
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=True)
    out = {}
    # -- 14b: float32 SGD, the same shard on both ranks, local and
    # cross-process BatchNorm statistics
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    for name, sync in (("f32", False), ("f32_sync", True)):
        tx = build_optimizer(DP_SGD)
        state = create_train_state(set_sync_bn(build_model("fear_xs")[0], sync), tx, device=dev)
        step = make_train_step(tx, mesh=multihost.process_group())
        state, m = step(state, {k: v.to(dev) for k, v in inputs["f32"].items()})
        out[name], out[f"{name}_loss"] = _state_cpu(state), float(m["loss"])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    # -- 14b: bfloat16 Adam, each rank its half of the staged batch, 3 steps
    tx = build_optimizer({"name": "adam", "lr": 1e-4})
    state = create_train_state(set_sync_bn(build_model("fear_xs")[0]), tx, device=dev)
    step = make_train_step(tx, device_augs=_dp_aug_cfg(), aug_seed=0, dtype=torch.bfloat16,
                           mesh=multihost.process_group())
    share = {k: v.to(dev) for k, v in shard_batch(inputs["staged"], rank, world).items()}
    losses = []
    for _ in range(3):
        state, m = step(state, dict(share))
        losses.append(float(m["loss"]))
    out["bf16"], out["bf16_losses"] = _state_cpu(state), losses
    del state, step

    # -- 14c: Trainer.fit, backend gpu_dp with num_devices 2, over Gloo
    cfg = _loop_config(os.path.join(root, "data"), os.path.join(root, "exp"), "DP", [
        "backend=gpu_dp", "num_devices=2", "distributed.backend=gloo", "num_workers=4", "sanity_steps=3",
        "max_epochs=1"])
    cfg["distributed"].update(coordinator_address=addr, num_processes=world, process_id=rank)
    counters = {"K1": postprocess_cuda, "K2": fused_ir_block}
    trainer = L.Trainer(cfg)
    trainer.setup_data()
    clips = [render_clip(seed=40 + i, n_frames=LOOP_VAL_FRAMES) for i in range(LOOP_VAL_CLIPS)]
    trainer.val_datasets = [_protocol_suite(clips, "clips")]
    step_k, val_k, step_s, val_s = {"K1": 0, "K2": 0}, {"K1": 0, "K2": 0}, [], []
    trainer.train_step = _counted(trainer.train_step, counters, step_k, step_s)
    trainer.validate = _counted(trainer.validate, counters, val_k, val_s)
    rows, allgather = [], multihost.allgather_rows

    def recording(r):
        got = allgather(r)
        rows.append(got)
        return got

    multihost.allgather_rows = recording
    _zero(counters)
    t0 = time.perf_counter()
    trainer.fit()
    out["fit"] = {"s": time.perf_counter() - t0, "step_k": step_k, "val_k": val_k, "step_s": step_s,
                  "val_s": val_s, "rows": [np.asarray(r).tolist() for r in rows], "step": trainer.state.step,
                  "batch_size": trainer.batch_size, "is_master": trainer.is_master,
                  "model": _state_cpu(trainer.state), "device": str(trainer.device)}
    torch.save(out, os.path.join(root, f"out{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def _phase_dp_world1(card, counters, staged, step_alone_ms: float):
    """14a: the data-parallel step over a group of one process on NCCL
    against the no-group step, bf16, B=32, 3 steps on 12c's staged batch."""
    import torch
    import torch.distributed as dist

    from feartracker_tpu_torch.parallel import multihost
    from feartracker_tpu_torch.tools.train_profile import build_model
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state, make_train_step

    multihost.initialize({"coordinator_address": f"127.0.0.1:{_free_port()}", "num_processes": 1,
                          "process_id": 0, "backend": "nccl"})
    try:
        assert dist.get_backend() == "nccl" and multihost.process_count() == 1
        runs, steps = {}, {}
        flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            for name, mesh in (("group", multihost.process_group()), ("alone", None)):
                tx = build_optimizer({"name": "adam", "lr": 1e-4})
                state = create_train_state(build_model("fear_xs")[0], tx, device="cuda")
                steps[name] = step = make_train_step(tx, device_augs=_dp_aug_cfg(), aug_seed=0,
                                                     dtype=torch.bfloat16, mesh=mesh)
                _zero(counters)
                losses = []
                for _ in range(3):
                    state, m = step(state, dict(staged))
                    losses.append(float(m["loss"]))
                runs[name] = (_state_cpu(state), losses, _read(counters), state)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        (g_sd, g_loss, g_k, g_state), (a_sd, a_loss, _, _) = runs["group"], runs["alone"]
        differ = [k for k in g_sd if not torch.equal(g_sd[k], a_sd[k])]
        assert not differ and g_loss == a_loss, (differ[:5], g_loss, a_loss)
        assert g_k == {"K1": 0, "K2": 0}, g_k
        # the step's time, the group's against the no-group step's, in turns
        # after a call of each under the default cuDNN flags
        for name in ("group", "alone"):
            steps[name](g_state, dict(staged))
        times = {name: [] for name in ("group", "alone")}
        for name in ("group", "alone", "alone", "group"):
            times[name].append(_wall_ms(lambda: steps[name](g_state, dict(staged)), 10))
        print(f"[14a] data-parallel step over a group of 1 on NCCL, bf16 B=32, 3 Adam steps: parameters and "
              f"BatchNorm statistics equal the no-group step's bit for bit ({len(g_sd)} tensors), losses "
              f"{', '.join(f'{v:.6f}' for v in g_loss)} equal; launches {g_k}; step ms group "
              f"{', '.join(f'{t:.2f}' for t in times['group'])}, no group "
              f"{', '.join(f'{t:.2f}' for t in times['alone'])} (12b's step alone {step_alone_ms:.2f}) [{card}]",
              flush=True)
        return g_k
    finally:
        dist.destroy_process_group()


def _phase_dp_processes(card, counters, staged, loop_val: dict):
    """14b, 14c: two processes on cuda:0 over Gloo (``_dp_worker``)."""
    import os
    import tempfile

    import torch

    from feartracker_tpu_torch.data import device_augs as augs
    from feartracker_tpu_torch.tools.make_npy_dataset import write_npy_dataset
    from feartracker_tpu_torch.tools.train_profile import build_model
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state, make_train_step

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        write_npy_dataset(os.path.join(root, "data", "got10k"))
        # 14b's float32 shard: the first 8 staged items augmented once
        f32 = augs.augment_batch({k: v[:DP_F32_B] for k, v in staged.items()}, augs.aug_generator(0, 0, dev),
                                 _dp_aug_cfg())
        torch.save({"f32": {k: v.cpu() for k, v in f32.items()}, "staged": {k: v.cpu() for k, v in staged.items()}},
                   os.path.join(root, "inputs.pt"))
        port = _free_port()
        t0 = time.perf_counter()
        logs = [open(os.path.join(root, f"rank{r}.log"), "w+") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, __file__, "--dp-worker", str(r), "2", str(port), root],
                                  stdout=log, stderr=subprocess.STDOUT, text=True) for r, log in enumerate(logs)]
        try:
            deadline = time.monotonic() + 420
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                _stop(p)
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            assert p.returncode == 0, f"phase 14 rank {r} exited {p.returncode}:\n{log.read()[-4000:]}"
            log.close()
        procs_s = time.perf_counter() - t0
        outs = [torch.load(os.path.join(root, f"out{r}.pt"), weights_only=True) for r in range(2)]

        # -- 14b: against one process's step on one shard
        flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            tx = build_optimizer(DP_SGD)
            one = create_train_state(build_model("fear_xs")[0], tx, device=dev)
            init = _state_cpu(one)
            one, m = make_train_step(tx)(one, dict(f32))
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        ref = _state_cpu(one)
        stat = lambda k: k.endswith(("running_mean", "running_var"))  # noqa: E731
        params = [k for k in ref if not stat(k) and not k.endswith("num_batches_tracked")]
        err = {}
        for name in ("f32", "f32_sync"):
            err[name] = (max(float((o[name][k] - ref[k]).abs().max()) for o in outs for k in params),
                         max(float((o[name][k] - ref[k]).abs().max()) for o in outs for k in ref if stat(k)),
                         max(abs(o[f"{name}_loss"] - float(m["loss"])) / abs(float(m["loss"])) for o in outs))
        upd = max(float((ref[k] - init[k]).abs().max()) for k in params)
        differ = {name: [k for k in outs[0][name] if not torch.equal(outs[0][name][k], outs[1][name][k])]
                  for name in ("f32", "f32_sync", "bf16")}
        print(f"[14b] two processes on cuda:0 over Gloo, FEAR-XS: float32 SGD (lr 0.05) step on the same "
              f"{DP_F32_B}-item shard each against one process's step on it, local BatchNorm statistics: "
              f"parameters max|err| {err['f32'][0]:.2e} (atol {DP_PARAM_ATOL}), statistics {err['f32'][1]:.2e} "
              f"(atol {DP_STAT_ATOL}), loss rel {err['f32'][2]:.2e}; cross-process statistics (Flax's E[x²] − "
              f"E[x]²): parameters {err['f32_sync'][0]:.2e}, statistics {err['f32_sync'][1]:.2e}, loss rel "
              f"{err['f32_sync'][2]:.2e}, the step's largest update {upd:.2e}; bf16 Adam on different halves "
              f"of 12c's batch (sync BN), 3 steps: losses {', '.join(f'{v:.4f}' for v in outs[0]['bf16_losses'])}; "
              f"tensors that differ across the ranks {({k: len(v) for k, v in differ.items()})} of "
              f"{len(outs[0]['bf16'])} [{card}]", flush=True)
        assert err["f32"][0] <= DP_PARAM_ATOL and err["f32"][1] <= DP_STAT_ATOL, err
        assert not any(differ.values()), {k: v[:5] for k, v in differ.items()}

        # -- 14c: the loop in the two processes
        fit = [o["fit"] for o in outs]
        names = [f"clip{i}_box_iou" for i in range(LOOP_VAL_CLIPS)]
        val = {k: fit[0]["val_k"][k] + fit[1]["val_k"][k] for k in ("K1", "K2")}
        seqs = 2 * LOOP_VAL_CLIPS  # the sanity check and 1 epoch, every clip each
        updates, inits = seqs * (LOOP_VAL_FRAMES - 1), seqs
        sanity = fit[0]["rows"][0]
        # rank 0 tracked clips 0 and 2, rank 1 clip 1: gathered in rank order
        want = [loop_val[names[i]] for i in (0, 2, 1)]
        row_err = max(abs(r[1] - w) for r, w in zip(sanity, want))
        exp = os.path.join(root, "exp", "DP")
        events = [f for f in os.listdir(os.path.join(exp, "logs")) if f.startswith("events.out.tfevents")]
        kept = sorted(int(d) for d in os.listdir(os.path.join(exp, "checkpoints")) if d.isdigit())
        fit_differ = [k for k in fit[0]["model"] if not torch.equal(fit[0]["model"][k], fit[1]["model"][k])]
        print(f"[14c] Trainer.fit in two processes on cuda:0 (backend gpu_dp, num_devices 2, Gloo), bf16 "
              f"{fit[0]['batch_size']} a process, {fit[0]['step']} steps in 1 epoch on each: launches in the steps "
              f"{[f['step_k'] for f in fit]}, in validation {[f['val_k'] for f in fit]} (summed {val}, one "
              f"process {updates} K1 / {13 * (updates + inits)} K2); sanity rows gathered "
              f"{[round(r[1], 6) for r in sanity]} against phase 13c's one-process "
              f"{[round(w, 6) for w in want]} (max diff {row_err:.2e}); {len(events)} event file, checkpoints "
              f"{kept} + last; {len(fit_differ)} tensors differ across the ranks after fit; fit "
              f"{', '.join(f'{f['s']:.1f}' for f in fit)} s, step calls "
              f"{', '.join(f'{t * 1e3:.0f}' for t in fit[0]['step_s'])} ms (rank 0); both processes "
              f"{procs_s:.1f} s [{card}]", flush=True)
        assert [f["is_master"] for f in fit] == [True, False] and all(f["step"] == 3 for f in fit), fit
        assert all(f["step_k"] == {"K1": 0, "K2": 0} for f in fit), fit
        assert val == {"K1": updates, "K2": 13 * (updates + inits)}, val
        assert len(sanity) == LOOP_VAL_CLIPS and row_err <= DP_VAL_ROW_ATOL, (sanity, want)
        assert fit[0]["rows"] == fit[1]["rows"]
        assert len(events) == 1 and kept == [3] and os.path.isdir(os.path.join(exp, "checkpoints", "last"))
        assert not fit_differ, fit_differ[:5]
    return {"dp_fit_2proc_step": {k: fit[0]["step_k"][k] + fit[1]["step_k"][k] for k in ("K1", "K2")},
            "dp_fit_2proc_val": val}


def _phase_sharded(card, counters, track_ms: float):
    """14d: ShardedScanTracker over [cuda:0] and [cuda:0, cuda:0]."""
    import numpy as np
    import torch

    from feartracker_tpu_torch.convert.load import load_fear_net, variables_from_npz
    from feartracker_tpu_torch.evaluate.harness import synthetic_streams
    from feartracker_tpu_torch.models.fear_net import FEARNet
    from feartracker_tpu_torch.parallel.inference import ShardedScanTracker
    from feartracker_tpu_torch.tracker.runtime import ScanTracker
    from feartracker_tpu_torch.tracker.serving import StreamPool

    model = load_fear_net(FEARNet(), variables_from_npz("fear_xs"))
    launches = {}
    # float32 S=4 T=8 (TF32 off inside the tracker), N=2 against ScanTracker
    f0, chunk, boxes = synthetic_streams(4, 8, seed=2, device="cuda")
    ref = ScanTracker(model, dtype=torch.float32)
    _, want = ref.track(ref.init(f0, boxes), chunk)
    two = ShardedScanTracker(model, dtype=torch.float32, devices=["cuda:0"] * 2)
    _, got = two.track(two.init(f0, boxes), chunk)
    f32_px = float((got["bbox"] - want["bbox"]).abs().max())
    assert f32_px <= SHARD_F32_PX, f32_px

    S, T = 128, 16
    f0, chunk, boxes = synthetic_streams(S, T, seed=1, device="cuda")
    ref = ScanTracker(model, dtype=torch.bfloat16)
    _, want = ref.track(ref.init(f0, boxes), chunk)
    lines = []
    for n in (1, 2):
        for k in (1, 4):
            tr = ShardedScanTracker(model, dtype=torch.bfloat16, devices=["cuda:0"] * n, scan_unroll=k)
            torch.cuda.synchronize()
            _zero(counters)
            state = tr.init(f0, boxes)
            state, got = tr.track(state, chunk)
            torch.cuda.synchronize()
            counted = _read(counters)
            if k == 1:
                assert counted == {"K1": n * T, "K2": 13 * n * (T + 1)}, (n, counted)
            else:
                # a second call from 0: the captured graphs' replays launch them
                before = dict(tr.replayed_launches)
                _zero(counters)
                state, again = tr.track(state, chunk)
                torch.cuda.synchronize()
                counted = {key: tr.replayed_launches[key] - before[key] for key in before}
                assert _read(counters) == {"K1": 0, "K2": 0} and counted == {"K1": n * T, "K2": 13 * n * T,
                                                                              "K3": n * T}, (
                    n, counted, _read(counters))
            launches[f"sharded_n{n}" + ("" if k == 1 else f"_scan_unroll_{k}")] = counted
            px = float((got["bbox"] - want["bbox"]).abs().max())
            if n == 1:
                assert all(torch.equal(got[key], want[key]) for key in want), (n, k)
            else:
                assert px <= BF16_BOX_PX["cpu_bf16"], (n, k, px)
            assert got["bbox"].shape == (T, S, 4) and torch.isfinite(got["bbox"]).all()
            ms = _wall_ms(lambda: tr.track(state, chunk), 5)
            lines.append(f"N={n} K={k}: launches {counted}, boxes vs ScanTracker {px:.2f} px, {ms:.2f} ms a "
                         f"call ({S * T / ms * 1e3:.1f} frames/s)")
    print(f"[14d] ShardedScanTracker bf16 S={S} T={T} on [cuda:0]*N, eager (K=1: init + one call) and "
          f"scan_unroll K=4 (a replayed call): {'; '.join(lines)}; 5b's ScanTracker {track_ms:.2f} ms a call; "
          f"f32 S=4 T=8 N=2 vs ScanTracker {f32_px:.2e} px (tol {SHARD_F32_PX}) [{card}]", flush=True)

    # StreamPool over it at capacity 128 against the pool over ScanTracker
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 255, (256, 480, 3), np.uint8) for _ in range(4)]
    boxes_np = [[180 + (i % 16) * 4, 100 + (i // 16) * 4, 40, 48] for i in range(S)]
    results = {}
    for name, tr in (("single", ScanTracker(model, dtype=torch.bfloat16)),
                     ("sharded", ShardedScanTracker(model, dtype=torch.bfloat16, devices=["cuda:0"] * 2))):
        pool = StreamPool(tr, capacity=S, frame_hw=(256, 480))
        for b in boxes_np:
            pool.add(frames[0], b)
        batch = np.broadcast_to(frames[1], (S, 256, 480, 3))
        t0 = time.perf_counter()
        outs = [pool.step(frames[1 + t % 3] if t % 2 else batch) for t in range(20)]
        results[name] = (np.stack([o["bbox"] for o in outs]), (time.perf_counter() - t0) * 1e3 / 20)
    pool_px = float(np.abs(results["sharded"][0] - results["single"][0]).max())
    print(f"[14d] StreamPool capacity {S} over ShardedScanTracker N=2 against the pool over ScanTracker, 20 steps "
          f"of host frames: boxes max diff {pool_px:.2f} px (tol {BF16_BOX_PX['cpu_bf16']}), "
          f"{results['sharded'][1]:.1f} / {results['single'][1]:.1f} ms a step [{card}]", flush=True)
    assert pool_px <= BF16_BOX_PX["cpu_bf16"], pool_px
    return launches


def _phase_parallel(card, counters, lap, staged, step_alone_ms: float, loop_val: dict, track_ms: float):
    """Phase 14: data parallelism and stream sharding on the one card."""
    import torch

    t_phase = time.perf_counter()
    staged = {k: v for k, v in staged.items() if isinstance(v, torch.Tensor)}

    # 14a and 14d time the card: they run before 14b-c's two processes start
    launches = {"dp_step_world1": _phase_dp_world1(card, counters, staged, step_alone_ms)}
    lap("14a")
    launches.update(_phase_sharded(card, counters, track_ms))
    lap("14d")
    launches.update(_phase_dp_processes(card, counters, staged, loop_val))
    lap("14b-c")
    print(f"[14] phase 14 {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches


# 15d: K2 against its twin on ir_block_micro's draws (the JAX tool's
# randn·0.2, not fan-in scaled: outputs up to ≈26, where one bf16 ulp is
# 0.125): phase 4's atol 0.15, or 2^-5 of the block's max|out| if larger
MICRO_BF16_RTOL = 2.0 ** -5


def _run_tool(module, argv, counters, tag: str):
    """A tool's ``main`` in-process on the card, its lines echoed under
    ``tag`` → (its JSON records, the kernels' launches over the run)."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    _zero(counters)
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    torch.cuda.synchronize()
    launches = _read(counters)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[{tag}] {line}", flush=True)
    return [json.loads(line) for line in lines if line.startswith("{")], launches


def _trunk_drift(S: int, T: int, check: dict) -> str:
    """15c's bfloat16 boxes at S, T on the tool's rendered clips, each trunk
    on the card, on the CPU (the fused trunk through K2's plain twin) and
    against the card's float32 boxes. Held: each trunk on the card within
    phase 9h's CPU limit of itself on the CPU (K2 against its twin); the
    fused trunk within 9h's float32 limit of the f32 boxes, and the trunks
    (``check``, the tool's reading) within it of each other, unless the
    same comparison among the CPU's bf16 paths, which run no kernel of the
    port, is past that limit too: then the drift is bf16's, common to both
    trunks, and is printed. → one line of readings."""
    import torch

    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker
    from feartracker_tpu_torch.tools.fused_trunk_bench import rendered_streams

    f0, chunk, boxes = rendered_streams(S, T, "cpu")
    got = {}
    for impl, device, dtype in [(i, d, torch.bfloat16) for i in ("xla", "fused") for d in ("cuda", "cpu")] + [
            ("fused", "cuda", torch.float32)]:
        tracker, _ = build_scan_tracker(dtype=dtype, device=device, trunk_impl=impl)
        out = tracker.track(tracker.init(f0.to(device), boxes.to(device)), chunk.to(device))[1]["bbox"].cpu()
        if not torch.isfinite(out).all():
            raise AssertionError(f"15c: non-finite {impl} {dtype} boxes on {device}")
        got[impl, device, dtype] = out
    bf16, f32 = torch.bfloat16, got["fused", "cuda", torch.float32]

    def px(a, b):
        return (a - b).abs().max().item()

    twin = {impl: px(got[impl, "cuda", bf16], got[impl, "cpu", bf16]) for impl in ("xla", "fused")}
    vs_f32 = {f"{impl}_{dev}": px(got[impl, dev, bf16], f32) for impl in ("xla", "fused") for dev in ("cuda", "cpu")}
    cpu_gap = px(got["xla", "cpu", bf16], got["fused", "cpu", bf16])
    line = (f"at S={S} T={T} bf16: each trunk card vs CPU {twin} px (<= {BF16_BOX_PX['cpu_bf16']}); vs the card's "
            f"f32 {vs_f32} px; xla vs fused trunk card {check['max_abs_px']} px, CPU {cpu_gap} px")
    limit = BF16_BOX_PX["card_f32"]
    if max(twin.values()) > BF16_BOX_PX["cpu_bf16"]:
        raise AssertionError(f"15c: a trunk on the card is off its CPU run: {line}")
    if vs_f32["fused_cuda"] > limit and max(vs_f32["xla_cpu"], vs_f32["fused_cpu"]) <= limit:
        raise AssertionError(f"15c: the fused (K2) trunk is past {limit} px from f32 where the CPU's are not: {line}")
    if check["max_abs_px"] > limit and cpu_gap <= limit:
        raise AssertionError(f"15c: the trunks are past {limit} px apart on the card, not on the CPU: {line}")
    return line


def _phase_tools(card, counters, lap, work: str, k2_phase6: dict):
    """Phase 15: the six measuring tools through their ``main`` on the card,
    FEAR-XS bf16 from ``fear_xs.npz`` at S=128; ``work`` holds phase 12c's
    ``.npy`` clips and 12d's checkpoints. → each tool's launches."""
    import os

    import torch

    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, synthetic_streams
    from feartracker_tpu_torch.evaluate.profiling import BF16_FLOPS, F32_FLOPS
    from feartracker_tpu_torch.models.fear_net import FEARNet
    from feartracker_tpu_torch.tools import (export_weights, fused_trunk_bench, ir_block_micro, loader_throughput,
                                             recovery_throughput, roofline)
    from feartracker_tpu_torch.tracker.runtime import ScanTracker

    S, T, n_fused, launches = 128, 16, 13, {}

    def used(name, got, k1=True, k2=True):
        launches[name] = got
        if (got["K1"] > 0) != k1 or (got["K2"] > 0) != k2:
            raise AssertionError(f"{name}: launches {got}; expected K1 {'> 0' if k1 else '0'}, "
                                 f"K2 {'> 0' if k2 else '0'}")

    # 15a: the whole step against the card's peaks, eager and graphed
    for K in (1, 4):
        (count, row), got = _run_tool(roofline, ["--streams", str(S), "--chunk", str(T), "--warmup", "2", "--timed",
                                                 "5", "--scan_unroll", str(K)], counters, "15a")
        used("roofline" if K == 1 else f"roofline_scan_unroll_{K}", got)
        for key in ("mfu_pct", "hbm_util_pct", "bound_share_pct"):
            if not 0.0 < row[key] <= 100.0:
                raise AssertionError(f"15a K={K}: {key} {row[key]} is no share")
        print(f"[15a] scan_unroll {K}: {row['ms_per_call']:.2f} ms a T={T} call at S={S} bf16 against a bound of "
              f"{row['bound_ms']:.3f} ms set by {row['binding_roofline']} (CUDA cores "
              f"{row['cuda_core_flops_per_call'] / F32_FLOPS * 1e3:.3f} ms, tensor cores "
              f"{row['tensor_core_flops_per_call'] / BF16_FLOPS * 1e3:.3f} ms, HBM {row['hbm_floor_ms']:.3f} ms): "
              f"{row['bound_share_pct']:.2f}% of the bound, MFU {row['mfu_pct']:.3f}%, HBM {row['hbm_util_pct']:.3f}% "
              f"[{card}]", flush=True)
    # the card's own count of one step (the xla trunk: K2 runs outside torch's
    # dispatcher, so a fused step would hide its products) against the CPU's
    xla, _ = build_scan_tracker(dtype=torch.bfloat16, device="cuda", trunk_impl="xla")
    f0, ch, bb = synthetic_streams(S, 1, device="cuda")
    counted = roofline.count_step(xla, xla.init(f0, bb), ch[0])
    # the unfolded trunk's 1×1s are convolutions where the folded trunk's are
    # matrix products: the same products, on the same unit
    parts, keys = count["flops_by_part_per_frame"], ("depthwise", "bmm")
    want = {"cuda_core": count["cuda_core_flops_per_frame"] * S, "tensor_core": count["tensor_core_flops_per_frame"] * S,
            "executed_crop": count["executed_crop_flops_per_frame"] * S, **{k: parts[k] * S for k in keys}}
    got = {**{k: counted[k] for k in ("cuda_core", "tensor_core", "executed_crop")},
           **{k: counted["by_part"][k] for k in keys}}
    if got != want:
        raise AssertionError(f"15a: the card counts {got} a step at S={S}, the CPU {want}")
    print(f"[15a] one step at S={S} counted on the card (xla trunk) = the CPU's per-frame count × S: {got}",
          flush=True)
    del xla, f0, ch, bb
    lap("15a")

    # 15b: zoom-out recovery's throughput cost
    env = {"BENCH_STREAMS": str(S), "BENCH_CHUNK": str(T), "BENCH_WARMUP": "2", "BENCH_TIMED": "5",
           "BENCH_REPEATS": "2"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        recs, got = _run_tool(recovery_throughput, [], counters, "15b")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    used("recovery_throughput", got)
    summary = recs[-1]
    print(f"[15b] recover_context 3 against 0 at S={S} T={T} bf16: {summary['baseline_fps']:.1f} / "
          f"{summary['recovery_fps']:.1f} frames/s, overhead {summary['overhead_pct']:.2f}% [{card}]", flush=True)
    lap("15b")

    # 15c: K2's trunk against the model's own trunk on cuDNN, same tracker:
    # the boxes at S=8 T=16 (the JAX tool's check), the f32 check at S=4 T=8,
    # both trunks timed on the synthetic streams
    recs, got = _run_tool(fused_trunk_bench, ["--streams", str(S), "--chunk", str(T), "--check_streams", "8",
                                              "--warmup", "2", "--timed", "5", "--repeats", "2"], counters, "15c")
    used("fused_trunk_bench", got)
    check16, xla_row, fused_row = recs
    per_call = {"xla": xla_row["k2_launches_per_call"], "fused": fused_row["k2_launches_per_call"]}
    if per_call != {"xla": 0, "fused": n_fused * T}:
        raise AssertionError(f"15c: K2 launches a call {per_call}; expected xla 0, fused {n_fused * T}")
    (check_f32,), got = _run_tool(fused_trunk_bench, ["--dtype", "float32", "--chunk", "8", "--check_streams", "4",
                                                       "--timed", "0"], counters, "15c")
    used("fused_trunk_bench_check_float32", got)
    if not check_f32["max_abs_px"] <= 1.0:
        raise AssertionError(f"15c: float32 xla vs fused trunk {check_f32['max_abs_px']} px > 1")
    drift = _trunk_drift(8, T, check16)
    print(f"[15c] xla trunk {xla_row['ms_per_call']:.2f} ms / fused {fused_row['ms_per_call']:.2f} ms a T={T} call "
          f"at S={S} bf16 = {xla_row['ms_per_call'] / fused_row['ms_per_call']:.3f}x; boxes apart at S=8 T=16 bf16 "
          f"{check16['max_abs_px']:.3f} max, {check16['mean_abs_px']:.4f} mean; {drift}; at S=4 T=8 f32 "
          f"{check_f32['max_abs_px']:.4f} (tol 1); K2 a call {per_call} [{card}]", flush=True)
    lap("15c")

    # 15d: each FEAR-XS block alone
    recs, got = _run_tool(ir_block_micro, ["--streams", str(S), "--inner", "20", "--timed", "1", "--repeats", "2"],
                          counters, "15d")
    used("ir_block_micro", got, k1=False)
    fused_rows = [r for r in recs if r["eligible"]]
    for r in fused_rows:
        tol = max(0.15, MICRO_BF16_RTOL * r["max_abs_out"])
        if not r["max_abs_err"] <= tol:
            raise AssertionError(f"15d block {r['block']}: max|err| {r['max_abs_err']} > {tol}")
    if len(recs) != 16 or len(fused_rows) != n_fused:
        raise AssertionError(f"15d: {len(recs)} blocks, {len(fused_rows)} through K2")
    print(f"[15d] {len(fused_rows)} K2 blocks at S={S} bf16: kernel {sum(r['fused_ms'] for r in fused_rows):.3f} ms, "
          f"plain {sum(r['plain_ms'] for r in fused_rows):.3f} ms (phase 6 on the packaged weights: "
          f"{k2_phase6['ms']:.3f} / {k2_phase6['plain_ms']:.3f}); max|err| "
          f"{max(r['max_abs_err'] for r in fused_rows):.3e} [{card}]", flush=True)
    lap("15d")

    # 15e: the loader on 12c's clips against the step's demand
    recs, got = _run_tool(loader_throughput, ["--root", work, "--batch", "32", "--steps", "2", "--num_workers", "8",
                                              "--modes", "device_augs,device_augs+cache", "--step"], counters, "15e")
    used("loader_throughput", got, k1=False, k2=False)
    for r in recs:
        if not (r["loader_samples_s"] > 0 and r["device_step_samples_s"] > 0):
            raise AssertionError(f"15e: {r}")
    print(f"[15e] B=32 on 8 threads: " + ", ".join(f"{r['mode']} {r['loader_samples_s']:.1f} samples/s (feed ratio "
                                                   f"{r['feed_ratio']:.4f})" for r in recs)
          + f" against the step's {recs[0]['device_step_samples_s']:.1f} [{card}]", flush=True)
    lap("15e")

    # 15f: 12d's checkpoint → .npz → build_scan_tracker, against the
    # tracker built from the checkpoint's model
    npz = os.path.join(work, "exported.npz")
    _, got = _run_tool(export_weights, ["--weights_path", os.path.join(work, "checkpoints", "last"), "--out", npz],
                       counters, "15f")
    used("export_weights", got, k1=False, k2=False)
    model = FEARNet()
    model.load_state_dict(torch.load(os.path.join(work, "checkpoints", "last", "state.pt"), map_location="cpu",
                                     weights_only=True)["model"])
    f0, ch, bb = synthetic_streams(S, 8, seed=2, device="cuda")
    boxes = {}
    for name, tracker in (("npz", build_scan_tracker(npz, dtype=torch.bfloat16, device="cuda")[0]),
                          ("model", ScanTracker(model, dtype=torch.bfloat16, device="cuda"))):
        _zero(counters)
        boxes[name] = tracker.track(tracker.init(f0, bb), ch)[1]["bbox"]
        torch.cuda.synchronize()
        if name == "npz":
            used("export_weights_tracker", _read(counters))
    px = (boxes["npz"] - boxes["model"]).abs().max().item()
    if px != 0.0:
        raise AssertionError(f"15f: the exported weights' boxes {px} px from the checkpoint's model's")
    # the xla trunk under K=4 graphs captured on fear_xs.npz, then swapped
    # to the checkpoint's model, against a fresh xla tracker on it
    swapped = build_scan_tracker(dtype=torch.bfloat16, device="cuda", trunk_impl="xla", scan_unroll=4)[0]
    swapped.track(swapped.init(f0, bb), ch)
    swapped.set_variables(model)
    fresh = ScanTracker(model, dtype=torch.bfloat16, device="cuda", trunk_impl="xla", scan_unroll=4)
    got, want = (t.track(t.init(f0, bb), ch)[1] for t in (swapped, fresh))
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if differ:
        raise AssertionError(f"15f: xla trunk after set_variables under graphs: {differ} differ from a fresh tracker")
    print(f"[15f] checkpoint → {os.path.getsize(npz) / 2**20:.1f} MiB .npz → ScanTracker bf16 S={S} T=8: boxes "
          f"{px} px from the tracker on the checkpoint's model; the xla trunk's K=4 graphs after set_variables "
          f"equal a fresh tracker's [{card}]", flush=True)
    lap("15f")
    return launches


# phase 16: the scenario suites at reduced counts (16a-b), and the CPU
# witness (16c) at one scenario, one seed, two 12-frame sequences a family
SCENARIO_SEEDS, SCENARIO_SEQUENCES, SCENARIO_FRAMES = (7,), 1, 24
WITNESS_SEQUENCES, WITNESS_FRAMES = 2, 12
# 16c, card against the port on the CPU: 9g's limits in float32 (AO and VOT
# accuracy 0.01, failures equal), 9h's in bfloat16 (AO 0.02, failures within
# one; VOT accuracy printed, held to no limit, as in 9h)
SCENARIO_LIMITS = {"float32": {"ao": 0.01, "accuracy": 0.01, "eao": 0.01, "robustness_failures": 0},
                   "bfloat16": {"ao": BF16_AO, "robustness_failures": BF16_VOT_FAILURES}}


def _tool_rows(fn, counters, tag: str):
    """A tool's ``run`` (``fn``) with its JSON lines echoed under ``tag`` →
    (its records, the kernels' launches over the run, seconds)."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    _zero(counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        recs = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read(counters)
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"[{tag}] {line}", flush=True)
    return recs, launches, seconds


def _quiet(fn):
    """``fn()`` with its printed lines dropped (16c's witnesses)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _witness(rows_card, rows_cpu, keys, what: str, limits: dict) -> str:
    """16c: the card's rows against the CPU's, matched by ``keys``, each
    field of ``limits`` within its limit (AO, VOT accuracy, EAO and
    failures are compared). → one line of the largest gaps."""
    cpu = {tuple(r[k] for k in keys): r for r in rows_cpu if "summary" not in r}
    card = [r for r in rows_card if "summary" not in r]
    if sorted(cpu) != sorted(tuple(r[k] for k in keys) for r in card):
        raise AssertionError(f"16c {what}: the card's rows {card} are not the CPU's {list(cpu.values())}")
    gaps = {}
    for r in card:
        w = cpu[tuple(r[k] for k in keys)]
        for k in ("ao", "accuracy", "eao", "robustness_failures"):
            if k in r:
                gaps[k] = max(gaps.get(k, 0.0), abs(r[k] - w[k]))
    if any(gaps[k] > limits[k] for k in gaps if k in limits):
        raise AssertionError(f"16c {what}: card vs CPU gaps {gaps}, limits {limits}: card {card}, "
                             f"CPU {list(cpu.values())}")
    return f"{what} " + ", ".join(f"{k} {v:.4f}" + (f" (<= {limits[k]})" if k in limits else "")
                                  for k, v in gaps.items())


def _scenario_witness(device: str, work: str) -> dict:
    """16c's side on ``device``: ``recovery_ablation`` (batched) on swap and
    ``vot_recovery`` on occlusion in each of ``SCENARIO_LIMITS``' dtypes,
    and ``quantized_quality``'s exported pairs on swap, at one seed over
    ``WITNESS_SEQUENCES`` × ``WITNESS_FRAMES``; each device writes its own
    scenario roots and export under ``work`` (the card's pair is 16b's
    export: graphs run where they were exported)."""
    import os

    import torch

    from feartracker_tpu_torch.tools import quantized_quality, recovery_ablation, vot_recovery

    on_card = device == "cuda"
    root = os.path.join(work, "witness" if on_card else "witness_host")
    kw = dict(seeds=[SCENARIO_SEEDS[0]], sequences=WITNESS_SEQUENCES, root=root, device=device)
    rows = {}
    for dtype_name in SCENARIO_LIMITS:
        dtype = getattr(torch, dtype_name)
        rows[dtype_name] = (
            _quiet(lambda: recovery_ablation.run(scenarios=["swap"], contexts=[3.0], dtype=dtype,
                                                 frames=WITNESS_FRAMES, **kw)),
            _quiet(lambda: vot_recovery.run(scenarios=["occlusion"], contexts=[3.0], skip=2, burnin=3, dtype=dtype,
                                            frames=WITNESS_FRAMES, **kw)))
    rows["quantized"] = _quiet(lambda: quantized_quality.run(
        export_dir=os.path.join(work, "export16" if on_card else "export16_cpu"), scenarios=["swap"],
        seq_frames=WITNESS_FRAMES, **kw))
    return rows


def _phase_scenarios(card, counters, lap, work: str):
    """Phase 16: the numpy scenario generator on the card host (16a), the
    ten ablation and probe tools' ``run`` on the card, bf16, each launching
    K1 and K2 (16b), and the card against the port on the CPU on the same
    generated roots, float32 and bfloat16 (16c). → each tool's launches."""
    import os

    from feartracker_tpu_torch.ops.cuda.ir_block import ir_block_op_cuda
    from feartracker_tpu_torch.tools import (dual_template_ablation, family_pareto, gate_v2_ablation,
                                             letterbox_penalty, occlusion_signal_probe, quantized_quality,
                                             recovery_ablation, tune_tracker, vot_recovery, vot_unified)
    from feartracker_tpu_torch.tools.make_synthetic_dataset import SCENARIOS, generate

    host = _host_refs("16", work)  # 16c's host side, in its own process from here on

    # 16a: every scenario at each seed, and drift again at 2× (letterbox_penalty's)
    root = os.path.join(work, "scenarios")
    n, frames, seeds = SCENARIO_SEQUENCES, SCENARIO_FRAMES, SCENARIO_SEEDS
    t0 = time.perf_counter()
    for scenario in SCENARIOS:
        for seed in seeds:
            generate(os.path.join(root, f"{scenario}_s{seed}"), tracks=1, frames=frames, val_sequences=n, seed=seed,
                     appearance_drift=1.0 if scenario == "drift" else 0.0, scenario=scenario)
    gen_1x = time.perf_counter() - t0
    for seed in seeds:
        generate(os.path.join(root, f"drift_s{seed}_x2"), tracks=1, frames=frames, val_sequences=n, seed=seed,
                 size=(320, 448), obj_scale=2.0, appearance_drift=1.0, scenario="drift")
    gen_all = time.perf_counter() - t0
    if {"cv2", "pandas"} & set(sys.modules):
        raise AssertionError(f"16a: the generator imported {sorted({'cv2', 'pandas'} & set(sys.modules))}")
    frames_written = (len(SCENARIOS) + 1) * len(seeds) * (n + 1) * frames
    print(f"[16a] numpy generator, no cv2 or pandas: {len(SCENARIOS)} scenarios x seeds {list(seeds)}, 1 track + "
          f"{n} val sequences of {frames} frames each, 160x224, in {gen_1x:.1f} s; drift at obj_scale 2 "
          f"(320x448) too: {frames_written} .npy frames in {gen_all:.1f} s", flush=True)
    lap("16a")

    # 16b: each tool's run on the card, bf16 (tune_tracker: JAX's float32
    # sequential, bfloat16 batched), at reduced counts
    kw = dict(seeds=seeds, sequences=n, frames=frames, root=root)
    tune_root = os.path.join(root, f"pose_s{seeds[0]}", "got10k")
    runs = {
        "dual_template_ablation": lambda: dual_template_ablation.run(scenarios=("swap", "occlusion"), **kw),
        "recovery_ablation": lambda: recovery_ablation.run(scenarios=("occlusion", "swap"), contexts=[3.0],
                                                           with_dual=True, **kw),
        "gate_v2_ablation": lambda: gate_v2_ablation.run(scenarios=SCENARIOS, **kw),
        "occlusion_signal_probe": lambda: occlusion_signal_probe.run(scenarios=("occlusion", "pose", "swap"), **kw),
        "letterbox_penalty": lambda: letterbox_penalty.run(scenarios=["drift"], scale=2.0, canvas_h=160,
                                                           canvas_w=224, **kw),
        # burn-in 5 of the tools' 10: the 24-frame sequences keep scored frames
        "vot_recovery": lambda: vot_recovery.run(scenarios=["occlusion"], contexts=[3.0], burnin=5, **kw),
        "vot_unified": lambda: vot_unified.run(scenarios=["occlusion"], burnin=5, **kw),
        "tune_tracker": lambda: tune_tracker.run(tune_root, penalty_k=[0.062, 0.15], window=[0.38]),
        "tune_tracker_batched": lambda: tune_tracker.run(tune_root, penalty_k=[0.062, 0.15], window=[0.38],
                                                         batched=True, streams=n),
        "family_pareto": lambda: family_pareto.run(scenarios=("swap", "pose"), **kw),
        "quantized_quality": lambda: quantized_quality.run(export_dir=os.path.join(work, "export16"),
                                                           scenarios=["drift"], seeds=seeds, seq_frames=frames,
                                                           sequences=n, root=root),
    }
    launches = {}
    for name, fn in runs.items():
        ir_block_op_cuda.calls = 0
        recs, got, seconds = _tool_rows(fn, counters, "16b")
        launches[name] = got
        if not (got["K1"] > 0 and got["K2"] > 0):
            raise AssertionError(f"16b {name}: launches {got}; expected K1 and K2 each > 0")
        if name == "quantized_quality" and not ir_block_op_cuda.calls > 0:
            raise AssertionError(f"16b {name}: K2 never ran through the operator fear_port::ir_block")
        if name == "occlusion_signal_probe":  # counts of update-eligible frames, and APCE
            per = [r for r in recs if "eligible" in r]
            aos = [q for r in per for c in ("apce_good", "apce_bad") if r[c] for q in r[c].values()]
            if not (per and sum(r["eligible"] for r in per) > 0 and all(r["good"] + r["bad"] == r["eligible"]
                                                                        for r in per)):
                raise AssertionError(f"16b {name}: {per}")
        else:
            aos = [r[k] for r in recs for k in ("ao", "mixed_ao", "accuracy") if k in r]
            if not aos or not all(0.0 <= a <= 1.0 for a in aos):
                raise AssertionError(f"16b {name}: AO/accuracy {aos}")
        line = (f"{name} {len(recs)} lines, K1 {got['K1']} / K2 {got['K2']}"
                + (f" (operator {ir_block_op_cuda.calls})" if name == "quantized_quality" else "") + f", {seconds:.1f} s")
        what = "APCE quantiles" if name == "occlusion_signal_probe" else "AO/accuracy"
        print(f"[16b] {line}; {what} {min(aos):.4f}-{max(aos):.4f} [{card}]", flush=True)
    lap("16b")

    # 16c: card against the port on the CPU (the host's side from its process), one family of tools at a time
    card_rows = _scenario_witness("cuda", work)
    host_rows = host()
    lines = []
    for dtype_name, limits in SCENARIO_LIMITS.items():
        rows = {"cuda": card_rows[dtype_name], "cpu": host_rows[dtype_name]}
        lines.append(_witness(rows["cuda"][0], rows["cpu"][0], ("mode", "scenario", "seed"),
                              f"{dtype_name} batched (recovery_ablation)", limits))
        lines.append(_witness(rows["cuda"][1], rows["cpu"][1], ("mode", "scenario", "seed"),
                              f"{dtype_name} VOT (vot_recovery)", limits))
        if not any(r.get("robustness_failures", 0) > 0 for r in rows["cuda"][1]):
            raise AssertionError(f"16c: no VOT failure on the occlusion witness to compare: {rows['cuda'][1]}")
    qrows = {"cuda": card_rows["quantized"], "cpu": host_rows["quantized"]}
    for path, dtype_name in (("fp32_export", "float32"), ("quantized_export", "bfloat16")):
        lines.append(_witness([r for r in qrows["cuda"] if r.get("path") == path],
                              [r for r in qrows["cpu"] if r.get("path") == path], ("scenario", "seed", "path"),
                              f"{dtype_name} exported pair ({path})", SCENARIO_LIMITS[dtype_name]))
    print(f"[16c] card vs CPU on one seed, {WITNESS_SEQUENCES} x {WITNESS_FRAMES} frames: " + "; ".join(lines)
          + f" [{card}]", flush=True)
    lap("16c")
    return launches


# -- 17: the dataset makers and the training drivers ---------------------------

DRIVER_BATCH = 8  # the drivers' train batch where cut: the loader, not the step, sets a step's time here
GATE_LOGIT_ATOL = 1e-3  # 17d: the template gate's logit after 4 Adam steps, card against CPU, float32
PRETRAIN_LOSS_RTOL = 1e-3  # 17d: pretrain_trunk's per-epoch loss, card against CPU
# 17d's pretraining runs at lr 1e-5: at the tool's 1e-3, Adam turns each
# gradient that is rounding noise into a full ±lr step, and FEAR-XS's
# classifier parts from itself on the CPU alone (8 against 1 thread: 1.2%
# after 6 steps, 10% after 12), so no two devices can be held to it there
PRETRAIN_WITNESS_LR = 1e-5
MLP_AUC_ATOL = 0.005  # 17d: train_mlp's AUC on the same observations, card against CPU
MLP_PARAM_ATOL = 1e-4  # 17d: train_mlp's parameters at MLP_WITNESS_EPOCHS
# the MLP fits separable data: past a few hundred epochs its weights grow and
# a 1e-7 change of the inputs moves them by 0.9 (of 33.6) on the CPU, so the
# parameters are held at 100 epochs and the tool's 3000 are printed
MLP_WITNESS_EPOCHS = 100
ROLLOUT_BOX_PX = 1.0  # 17d: the float32 rollout's boxes, card against CPU (phase 9g's limit)


def _annotation_layouts(root: str):
    """17a's hand-written COCO-2017 instances JSON and ImageNet-VID XML
    layouts. → (COCO root, VID root)."""
    import os

    coco = os.path.join(root, "coco")
    os.makedirs(os.path.join(coco, "annotations"), exist_ok=True)
    with open(os.path.join(coco, "annotations", "instances_train2017.json"), "w") as fh:
        json.dump({"images": [{"id": 7, "file_name": "000007.jpg", "width": 100, "height": 80},
                              {"id": 9, "file_name": "000009.jpg", "width": 64, "height": 64}],
                   "annotations": [{"id": 1, "image_id": 7, "bbox": [10, 12, 30, 25], "iscrowd": 0},
                                   {"id": 2, "image_id": 7, "bbox": [50, 5, 20, 20], "iscrowd": 0},
                                   {"id": 3, "image_id": 9, "bbox": [0, 0, 10, 10], "iscrowd": 1},
                                   {"id": 4, "image_id": 9, "bbox": [5, 5, 0, 7], "iscrowd": 0}]}, fh)
    vid = os.path.join(root, "vid")
    seq_dir = os.path.join(vid, "Annotations", "VID", "train", "a", "ILSVRC2015_train_00001000")
    os.makedirs(seq_dir, exist_ok=True)
    frames = {0: [(0, 0, 10, 10, 30, 20), (1, 0, 50, 40, 20, 20)], 1: [(0, 1, 12, 11, 30, 20)],
              2: [(0, 0, 14, 12, 30, 20), (1, 0, 55, 42, 20, 20)]}
    for f, objs in frames.items():
        body = "".join(f"<object><trackid>{t}</trackid><occluded>{o}</occluded><bndbox><xmin>{x}</xmin>"
                       f"<ymin>{y}</ymin><xmax>{x + w}</xmax><ymax>{y + h}</ymax></bndbox></object>"
                       for t, o, x, y, w, h in objs)
        with open(os.path.join(seq_dir, f"{f:06d}.xml"), "w") as fh:
            fh.write(f"<annotation><size><width>120</width><height>90</height></size>{body}</annotation>")
    return coco, vid


def _val_lengths(got10k_root: str, cap: int = 10**9, subset: str = "val") -> list:
    """The frames a validation or evaluation tracks in each sequence."""
    from feartracker_tpu_torch.data.sequence import GOT10kDataset

    ds = GOT10kDataset(got10k_root, subset)
    return [min(len(ds[i][0]), len(ds[i][1]), cap) for i in range(len(ds))]


def _n_fused(model_name: str) -> int:
    from feartracker_tpu_torch.models.fbnet import TRUNKS

    return sum(s.expansion > 1 for s in TRUNKS[model_name])


def _sequential_launches(lengths, n_fused: int) -> dict:
    """``FEARTracker`` over sequences of n frames: an ``initialize`` (K2 once
    a fused block) and n - 1 updates (K1 once, K2 once a fused block)."""
    return {"K1": sum(n - 1 for n in lengths), "K2": n_fused * sum(lengths)}


def _batched_launches(lengths, streams: int, n_fused: int, refresh: bool = False) -> dict:
    """``ScanTracker`` over groups of ``streams`` sequences: an ``init`` and a
    step a frame up to the group's longest (K1 once, K2 once a fused block,
    and once more on a dual-template refresh, every step at interval 1)."""
    k1 = k2 = 0
    for g in range(0, len(lengths), streams):
        steps = max(lengths[g:g + streams]) - 1
        k1 += steps
        k2 += n_fused * (1 + steps * (2 if refresh else 1))
    return {"K1": k1, "K2": k2}


def _sum_launches(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in ("K1", "K2")}


def _driver_witness(device: str, work: str) -> dict:
    """17d's side on ``device``: ``pretrain_trunk``'s history over 17a's
    classes under ``work`` (one epoch at ``PRETRAIN_WITNESS_LR``) and the
    feature-gate rollouts in float32 (seed 51, two 12-frame sequences a
    scenario), each device writing its own files under ``work``."""
    import os

    import torch

    from feartracker_tpu_torch.tools import pretrain_trunk, train_feature_gate
    from feartracker_tpu_torch.tools.make_synthetic_dataset import SCENARIOS

    suffix = "" if device == "cuda" else "_host"
    hist = _quiet(lambda: pretrain_trunk.run(os.path.join(work, "classes"), "fear_xs",
                                             os.path.join(work, f"trunk_{device}.npz"), epochs=1, batch_size=16,
                                             image_size=128, lr=PRETRAIN_WITNESS_LR, seed=0, device=device))
    roll = train_feature_gate.collect_rollouts(SCENARIOS, (51,), 12, 2, 1.0,
                                               os.path.join(work, "feature_gate_witness" + suffix),
                                               dtype=torch.float32, device=device)
    return {"pretrain": hist["history"], "obs": roll[0], "vis": roll[1], "iou": roll[2], "boxes": roll[5]}


def _phase_drivers(card, counters, lap, work: str):
    """Phase 17: the dataset makers (17a) and classification pretraining
    (17b) on the card host with no cv2 or pandas, the eight training
    drivers' ``run`` on the card at full width with cut depth (17c, each
    one's K1/K2 launches equal to its validation and rollout schedule), and
    the card against the port on the CPU in float32 (17d). → each step's
    launches."""
    import itertools
    import math
    import os

    import numpy as np

    from feartracker_tpu_torch.convert.load import transfer_variables, variables_from_npz, variables_of
    from feartracker_tpu_torch.data.loader import BatchLoader
    from feartracker_tpu_torch.models.fear_net import build_family_model
    from feartracker_tpu_torch.tools import (family_train, make_annotations, make_class_dataset, pretrain_chain,
                                             pretrain_trunk, synthetic_e2e, train_feature_gate, train_flagship,
                                             train_run, train_template_gate, warm_start_comparison)
    from feartracker_tpu_torch.tools.make_synthetic_dataset import SCENARIOS, generate

    t17 = time.perf_counter()
    launches = {}

    # 17a: the dataset makers, numpy and the standard library only
    cls_root = os.path.join(work, "classes")
    recs, launches["make_class_dataset"], seconds = _tool_rows(
        lambda: make_class_dataset.run(cls_root, per_class=8, size=128, seed=0), counters, "17a")
    if recs[0]["images"] != 96:
        raise AssertionError(f"17a make_class_dataset: {recs}")
    ann = os.path.join(work, "annotations")
    generate(os.path.join(ann, "got10k_npy"), tracks=1, frames=12, val_sequences=3, seed=5)
    coco, vid = _annotation_layouts(ann)
    made = {}
    for dataset, root, subset in (("got10k", os.path.join(ann, "got10k_npy", "got10k"), "val"),
                                  ("coco", coco, "train"), ("ilsvrc", vid, "train")):
        out = os.path.join(ann, f"{dataset}.csv")
        recs, got, _ = _tool_rows(lambda: make_annotations.run(dataset, root, out, subset=subset), counters, "17a")
        made[dataset] = (recs[0]["rows"], recs[0]["frame_shapes"])
        launches[f"make_annotations_{dataset}"] = got
    want = {"got10k": (36, ["[224, 160]"]), "coco": (2, ["[100, 80]"]), "ilsvrc": (5, ["[120, 90]"])}
    if made != want:
        raise AssertionError(f"17a make_annotations: rows and frame shapes {made}, expected {want}")
    if {"cv2", "pandas"} & set(sys.modules):
        raise AssertionError(f"17a: the dataset makers imported {sorted({'cv2', 'pandas'} & set(sys.modules))}")
    print(f"[17a] make_class_dataset 12 classes x 8 images, 128x128 .npy, in {seconds:.1f} s; make_annotations "
          f"rows and frame shapes {made}; no cv2 or pandas imported", flush=True)
    lap("17a")
    host = _host_refs("17", work)  # 17d's host side, in its own process from here on (17a made its classes)

    # 17b: classification pretraining of the FEAR-XS trunk, float32
    npz = os.path.join(work, "fear_xs_trunk.npz")
    rec, got, seconds = _tool_rows(lambda: pretrain_trunk.run(cls_root, "fear_xs", npz, epochs=1, batch_size=32,
                                                              image_size=128, seed=0, device="cuda"),
                                   counters, "17b")
    launches["pretrain_trunk"] = got
    loaded = variables_from_npz(npz)
    _, report = transfer_variables(loaded, variables_of(build_family_model("fear_xs")))
    loss = rec["history"][-1]["loss"]
    if not (math.isfinite(loss) and got == {"K1": 0, "K2": 0} and sorted(report["transferred"]) == sorted(loaded)
            and not report["skipped_shape"] and not report["unused"]):
        raise AssertionError(f"17b pretrain_trunk: loss {loss}, launches {got}, transfer "
                             f"{ {k: len(v) for k, v in report.items()} } of {len(loaded)} arrays")
    print(f"[17b] pretrain_trunk FEAR-XS 128x128 B=32, {rec['steps']} steps: loss {loss:.4f}, {len(loaded)} encoder "
          f"arrays, every one transferred into FEAR-XS ({len(report['missing'])} leaves kept at init); launches "
          f"{got}; {seconds:.1f} s [{card}]", flush=True)
    lap("17b")

    # 17c: the drivers on the card, FEAR-XS bf16 unless named, cut depth
    cut = {"batch_size": {"train": DRIVER_BATCH, "val": 1}, "train_percent": 2, "num_workers": 8}
    nf_xs = _n_fused("fear_xs")
    paths = {name: os.path.join(work, name) for name in (
        "train_run", "pretrain_chain", "family_train", "warm_start_comparison", "synthetic_e2e",
        "train_template_gate", "train_feature_gate", "train_flagship")}
    generate(os.path.join(paths["train_run"], "data"), tracks=4, frames=16, val_sequences=2, seed=11,
             size=(288, 384))
    generate(os.path.join(paths["synthetic_e2e"], "data"), tracks=4, frames=16, val_sequences=2, seed=0)

    def train_run_schedule():
        lengths = _val_lengths(os.path.join(paths["train_run"], "data", "got10k"), 12)
        first = [_sequential_launches(lengths[:1], nf_xs), _sequential_launches(lengths, nf_xs)]
        resumed = [_sequential_launches(lengths[:1], nf_xs), _sequential_launches(lengths, nf_xs)]
        return _sum_launches(*first, *resumed)

    def family_schedule():
        lengths = _val_lengths(os.path.join(paths["family_train"], "track", "got10k"), 8)
        return _sum_launches(*(_sequential_launches(lengths, _n_fused(m)) for m in ("fear_xs", "fear_m", "fear_l")))

    def e2e_schedule():
        root = os.path.join(paths["synthetic_e2e"], "data", "got10k")
        lengths, nf = _val_lengths(root, 24), _n_fused("fear_tiny")  # the AO runs' and validation's cap
        return _sum_launches(*[_sequential_launches(lengths, nf)] * 3, _sequential_launches(lengths[:1], nf))

    def feature_gate_schedule():
        return _sum_launches(*(_batched_launches(_val_lengths(os.path.join(paths["train_feature_gate"], f"{s}_s51",
                                                                           "got10k")), 2, nf_xs, refresh=True)
                               for s in SCENARIOS))

    def flagship_schedule():
        val = _val_lengths(os.path.join(paths["train_flagship"], "corpus", "val_all"), 24)
        gate = _val_lengths(os.path.join(paths["train_flagship"], "quality_gate", "got10k"))
        one_gate = _sum_launches(_sequential_launches(gate, nf_xs), _batched_launches(gate, 3, nf_xs))
        return _sum_launches(_batched_launches(val[:1], 16, nf_xs), _batched_launches(val, 16, nf_xs),
                             one_gate, one_gate)

    drivers = {
        "train_run": (lambda: train_run.run(os.path.join(paths["train_run"], "data"), epochs=1, resume_epochs=1,
                                            device_augs=True, device="cuda", overrides=cut),
                      train_run_schedule),
        "pretrain_chain": (lambda: pretrain_chain.run(epochs=1, batch=DRIVER_BATCH, num_samples=16, tracks=4,
                                                      track_frames=6, per_class=8, pretrain_epochs=1,
                                                      work=paths["pretrain_chain"], device="cuda", device_augs=True),
                           lambda: _sum_launches(*[_sequential_launches(_val_lengths(os.path.join(
                               paths["pretrain_chain"], "track", "got10k"), 8), nf_xs)] * 3)),
        "family_train": (lambda: family_train.run(epochs=1, batch=DRIVER_BATCH, num_samples=16, tracks=4,
                                                  track_frames=6, arms=("xs_scratch", "m_warmstart", "l_scratch"),
                                                  work=paths["family_train"], device="cuda", device_augs=True),
                         family_schedule),
        "warm_start_comparison": (lambda: warm_start_comparison.run(epochs=1, tracks=4, frames=12, val_sequences=2,
                                                                    work=paths["warm_start_comparison"],
                                                                    device="cuda", device_augs=True),
                                  lambda: _sum_launches(*[_sequential_launches(_val_lengths(os.path.join(
                                      paths["warm_start_comparison"], "data", "got10k"), 16),
                                      _n_fused("fear_tiny"))] * 2)),
        "synthetic_e2e": (lambda: synthetic_e2e.run(os.path.join(paths["synthetic_e2e"], "data"), epochs=2,
                                                    device="cuda", device_augs=True),
                          e2e_schedule),
        "train_template_gate": (lambda: train_template_gate.run(tracks=2, frames=16, epochs=1, samples_per_scenario=8,
                                                                batch=DRIVER_BATCH, work=paths["train_template_gate"],
                                                                device="cuda", device_augs=True, num_workers=8),
                                lambda: {"K1": 0, "K2": 0}),
        "train_feature_gate": (lambda: train_feature_gate.run(scenarios=SCENARIOS, train_seeds=(51,), frames=12,
                                                              sequences=2, work=paths["train_feature_gate"],
                                                              device="cuda"),
                               feature_gate_schedule),
        "train_flagship": (lambda: train_flagship.run(work=paths["train_flagship"], epochs=1, num_samples=16,
                                                      tracks=3, frames=8, per_class=8, pretrain_epochs=1,
                                                      device="cuda", device_augs=True,
                                                      overrides={"num_workers": 8}),
                           flagship_schedule),
    }
    records = {}
    for name, (fn, schedule) in drivers.items():
        recs, got, seconds = _tool_rows(fn, counters, "17c")
        want = schedule()
        if got != want:
            raise AssertionError(f"17c {name}: launches {got}, the validation and rollout schedule gives {want}")
        launches[name], records[name] = got, recs
        print(f"[17c] {name}: {len(recs)} records, K1 {got['K1']} / K2 {got['K2']} as scheduled, {seconds:.1f} s "
              f"[{card}]", flush=True)
    checks = {
        "train_run": records["train_run"][-1].get("resume_continuity") is True,
        "pretrain_chain": sorted(records["pretrain_chain"][-1]["summary"]) == ["cls_pretrain", "recovered", "scratch"],
        "family_train": sorted(records["family_train"][-1]["summary"]) == ["l_scratch", "m_warmstart", "xs_scratch"],
        "warm_start_comparison": len(records["warm_start_comparison"]) == 3,
        "synthetic_e2e": records["synthetic_e2e"][-1]["steps"] > 0,
        "train_template_gate": math.isfinite(records["train_template_gate"][-1]["gate_logit"]),
        "train_feature_gate": records["train_feature_gate"][0]["collected"] == len(SCENARIOS) * 2 * 11,
        "train_flagship": "summary" in records["train_flagship"][-1],
    }
    losses = [r["loss"] for rs in records.values() for r in rs if "loss" in r]
    if not all(checks.values()) or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"17c: checks {checks}, losses {losses}")
    flag = records["train_flagship"][-1]["summary"]
    print(f"[17c] resume continuity {records['train_run'][-1]}; every loss finite ({len(losses)}); flagship smoke "
          f"AO sequential {flag['repo_sequential_ao']} / {flag['ref_sequential_ao']} (trained / fear_xs), batched "
          f"{flag['repo_batched_ao']} / {flag['ref_batched_ao']}", flush=True)
    lap("17c")

    # 17d: card against the port on the CPU, float32 (TF32 off), each side
    # from the same initial values
    gate_root = os.path.join(paths["train_template_gate"], "swap")
    dataset = train_template_gate.build_dataset([gate_root], 4 * DRIVER_BATCH, 0, device_augs=True)
    loader = BatchLoader(dataset, DRIVER_BATCH, shuffle=True, num_workers=8, seed=0)
    batches = list(itertools.islice(train_template_gate.device_batches(loader, "cpu", True, 0), 4))
    logit = {}
    for device in ("cuda", "cpu"):
        model = train_template_gate.frozen_model("fear_xs", device)
        step = train_template_gate.make_gate_step(model, 0.05, mixed=False)
        for b in batches:
            step({k: v.to(device) for k, v in b.items()})
        logit[device] = float(model.template_gate.detach()[0])
    gate_gap = abs(logit["cuda"] - logit["cpu"])
    mine, refs = _driver_witness("cuda", work), host()
    hist = {"cuda": mine["pretrain"], "cpu": refs["pretrain"]}
    loss_gap = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(hist["cuda"], hist["cpu"]))
    box_px = float(np.abs(mine["boxes"] - refs["boxes"]).max())
    obs_err = float(np.abs(mine["obs"] - refs["obs"]).max())
    obs, vis, iou = mine["obs"], mine["vis"], mine["iou"]
    labels = ((vis >= 0.7) & (iou >= 0.5)).astype(np.float32)
    mlp = {(device, epochs): train_feature_gate.train_mlp(obs, labels, 8, epochs, 3e-2, 0, device=device)
           for epochs in (MLP_WITNESS_EPOCHS, 3000) for device in ("cuda", "cpu")}

    def mlp_gaps(epochs):
        card_mlp, cpu_mlp = mlp[("cuda", epochs)], mlp[("cpu", epochs)]
        return (max(abs(card_mlp[1][s]["auc"] - cpu_mlp[1][s]["auc"]) for s in ("train", "holdout")),
                max(float(np.abs(card_mlp[0][k] - cpu_mlp[0][k]).max()) for k in cpu_mlp[0]),
                " / ".join(f"{m[1]['train']['auc']}, {m[1]['holdout']['auc']}" for m in (card_mlp, cpu_mlp)))

    auc_gap, param_gap, aucs = mlp_gaps(MLP_WITNESS_EPOCHS)
    full_auc_gap, full_param_gap, full_aucs = mlp_gaps(3000)
    if not (gate_gap <= GATE_LOGIT_ATOL and loss_gap <= PRETRAIN_LOSS_RTOL and box_px <= ROLLOUT_BOX_PX
            and auc_gap <= MLP_AUC_ATOL and param_gap <= MLP_PARAM_ATOL):
        raise AssertionError(f"17d: gate logit {logit}, pretrain losses {hist}, rollout boxes {box_px} px, "
                             f"MLP at {MLP_WITNESS_EPOCHS} epochs: AUC (train, holdout) card / CPU {aucs}, "
                             f"params {param_gap}")
    print(f"[17d] card vs CPU, float32: template gate logit after 4 Adam steps {logit['cuda']:+.6f} / "
          f"{logit['cpu']:+.6f}, |gap| {gate_gap:.2e} (<= {GATE_LOGIT_ATOL}); pretrain_trunk at lr "
          f"{PRETRAIN_WITNESS_LR}, per-epoch loss rtol {loss_gap:.2e} (<= {PRETRAIN_LOSS_RTOL}; "
          f"{[round(h['loss'], 5) for h in hist['cuda']]}); feature-gate rollout of {len(obs)} frames: boxes "
          f"{box_px:.4f} px (<= {ROLLOUT_BOX_PX}), observations max|err| {obs_err:.2e}; the MLP on the card's "
          f"observations at {MLP_WITNESS_EPOCHS} epochs: AUC (train, holdout) card / CPU {aucs}, |gap| "
          f"{auc_gap:.4f} (<= {MLP_AUC_ATOL}), params max|err| {param_gap:.2e} (<= {MLP_PARAM_ATOL}); at the "
          f"tool's 3000: AUC {full_aucs}, |gap| {full_auc_gap:.4f}, params max|err| {full_param_gap:.2e} [{card}]",
          flush=True)
    lap("17d")
    print(f"[17] phase 17 in {time.perf_counter() - t17:.1f} s", flush=True)
    return launches


ORBAX_FIXTURE = ("tests", "fixtures", "orbax_fear_xs")  # a JAX trainer's checkpoint of fear_xs.npz, step 1234
ORBAX_DECODE_S = 30.0  # 18a: the most one read of the fixture may take on the card host's CPU
ORBAX_CROPS = 32  # 18d: seeded boxes through the warp and the subwindow crop


def _phase_orbax(card, counters, lap, work: str):
    """Phase 18: the JAX trainer's Orbax checkpoint read on the card host,
    which has no orbax, tensorstore or zstandard (18a), tracked from (18b)
    and resumed by the port's ``Trainer`` (18c); the host crops on the card
    (18d). → the Orbax-built tracker's launches."""
    import importlib.util
    import os
    import shutil

    import numpy as np
    import torch

    from feartracker_tpu_torch.convert.load import flatten_variables, load_variables, variables_from_npz
    from feartracker_tpu_torch.convert.orbax import find_orbax_state, read_checkpoint
    from feartracker_tpu_torch.data.crops import get_subwindow_tracking, rescale_crop
    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, synthetic_streams
    from feartracker_tpu_torch.ops.resize import warp_affine_linear_u8
    from feartracker_tpu_torch.tools.make_npy_dataset import write_npy_dataset
    from feartracker_tpu_torch.train.loop import Trainer
    from feartracker_tpu_torch.train.summary import read_events, scalars

    t18 = time.perf_counter()
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), *ORBAX_FIXTURE)
    host = _host_refs("18c")  # 18c's host side, in its own process beside 18a-18c
    want = variables_from_npz("fear_xs")

    def same(got):
        return sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes() for k in want)

    # 18a: the experiment dir, the checkpoints root and last/state, in Python and numpy
    reads = {}
    for form, path in (("experiment", fixture), ("checkpoints", os.path.join(fixture, "checkpoints")),
                       ("last/state", os.path.join(fixture, "checkpoints", "last", "state"))):
        t0 = time.perf_counter()
        tree, nbytes = read_checkpoint(find_orbax_state(path))
        seconds = time.perf_counter() - t0
        got = flatten_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]})
        if not (same(got) and int(tree["step"]) == 1234):
            raise AssertionError(f"18a {form}: the variables differ from fear_xs.npz or step {tree['step']} != 1234")
        reads[form] = (seconds, nbytes)
    if not same(load_variables(fixture)):
        raise AssertionError("18a: load_variables(<experiment dir>) differs from fear_xs.npz")
    slowest = max(s for s, _ in reads.values())
    if slowest > ORBAX_DECODE_S:
        raise AssertionError(f"18a: a read took {slowest:.1f} s > {ORBAX_DECODE_S} s")
    print(f"[18a] the JAX trainer's Orbax checkpoint of FEAR-XS read in Python and numpy through "
          f"{', '.join(f'{k} ({s:.2f} s)' for k, (s, _) in reads.items())}: {len(want)} arrays bit-equal to "
          f"fear_xs.npz, step 1234; {reads['experiment'][1] / 1e6:.2f} MB read a time; zstandard importable "
          f"{importlib.util.find_spec('zstandard') is not None} (not used); read times beside 18c's host "
          f"process [{card}]", flush=True)
    lap("18a")

    # 18b: the bench's shape from the Orbax dir and from the archive
    S, T = 128, 16
    f0, chunk, boxes = synthetic_streams(S, T, seed=1, device="cuda")
    outs, counts = {}, {}
    for name, weights in (("orbax", fixture), ("npz", "fear_xs")):
        tracker, _ = build_scan_tracker(weights, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        _zero(counters)
        state = tracker.init(f0, boxes)
        k2_init = counters["K2"].launches
        state, outs[name] = tracker.track(state, chunk)
        torch.cuda.synchronize()
        counts[name] = (_read(counters), k2_init)
        del tracker, state
    n_fused = counts["npz"][1]
    if counts["orbax"] != counts["npz"] or counts["orbax"] != ({"K1": T, "K2": n_fused * (T + 1)}, n_fused):
        raise AssertionError(f"18b launch counts {counts}; expected K1 {T}, K2 {n_fused} at init + {n_fused}*{T}")
    differ = [k for k in outs["npz"] if not torch.equal(outs["orbax"][k], outs["npz"][k])]
    if differ:
        raise AssertionError(f"18b: outputs {differ} differ between the Orbax-built and the archive-built tracker")
    print(f"[18b] build_scan_tracker(<Orbax dir>) bf16 S={S} T={T}: init + one track bit-equal to fear_xs.npz's "
          f"({len(outs['npz'])} outputs); launches {counts['orbax'][0]} (K2 {counts['orbax'][1]} at init) [{card}]",
          flush=True)
    lap("18b")

    # 18c: the port's Trainer resumes the JAX experiment, on a copy
    exp = os.path.join(work, "orbax_exp")
    shutil.copytree(fixture, os.path.join(exp, "JAX_RUN"))
    data = os.path.join(work, "orbax_data")
    write_npy_dataset(os.path.join(data, "got10k"))
    cfg = _loop_config(data, exp, "JAX_RUN", ["resume=true", "batch_size.train=8", "train_percent=2",
                                              "max_epochs=4", "scheduler.warmup_steps=0", "sanity_steps=0"])
    trainer = Trainer(cfg)
    seen = {}
    restore_last = trainer.ckpt.restore_last

    def spy(state):
        state = restore_last(state)
        seen.update(step=state.step, lr=float(state.opt_state["lr"]), count=int(state.opt_state["count"]))
        return state

    trainer.ckpt.restore_last = spy
    _zero(counters)
    t0 = time.perf_counter()
    trainer.fit()
    fit_s = time.perf_counter() - t0
    losses = scalars(read_events(os.path.join(trainer.exp_dir, "logs")))["train/loss"]
    if not (seen == {"step": 1234, "lr": float(np.float32(1e-4)), "count": 0} and trainer.resumed_epoch == 3
            and trainer.state.step == 1236 and [s for s, _ in losses] == [1235, 1236]
            and all(np.isfinite(v) for _, v in losses)):
        raise AssertionError(f"18c: restored {seen}, epoch {trainer.resumed_epoch}, step {trainer.state.step}, "
                             f"losses {losses}")
    print(f"[18c] Trainer resume=true on the JAX experiment: step {seen['step']}, epoch {trainer.resumed_epoch} "
          f"(meta.json), lr {seen['lr']:.1e} (the injected hyperparameter), Adam count {seen['count']}; bf16 B=8, "
          f"steps 1235-1236 losses {', '.join(f'{v:.4f}' for _, v in losses)}; launches {_read(counters)}; fit "
          f"{fit_s:.1f} s beside 18c's host process [{card}]", flush=True)
    _phase_train_f32(card, torch.device("cuda"), host, tag="18c")
    lap("18c")

    # 18d: the host crops on the card, against the CPU
    rng = np.random.RandomState(18)
    yy, xx = np.mgrid[0:256, 0:480]
    frame = np.clip(np.sin(xx / 9.0)[..., None] * 90 + np.cos(yy / 7.0)[..., None] * 60 + 128
                    + rng.randn(256, 480, 3) * 20, 0, 255).astype(np.uint8)
    card_frame = torch.from_numpy(frame).cuda()
    avg = np.mean(frame, axis=(0, 1))
    warp_equal = sub_equal = 0
    for _ in range(ORBAX_CROPS):
        box = np.array([rng.uniform(-60, 480), rng.uniform(-60, 256), rng.uniform(4, 200), rng.uniform(4, 200)])
        pad = tuple(rng.uniform(0, 255, 3))
        a, b = 126 / box[2], 126 / box[3]
        m = np.array([[a, 0, -a * box[0]], [0, b, -b * box[1]]])
        got = warp_affine_linear_u8(card_frame, m, (127, 127), pad).cpu().numpy()
        warp_equal += np.array_equal(got, warp_affine_linear_u8(torch.from_numpy(frame), m, (127, 127), pad).numpy())
        warp_equal += np.array_equal(rescale_crop(card_frame, box, 127, pad)[0].cpu().numpy(),
                                     rescale_crop(frame, box, 127, pad)[0])
        side = int(rng.randint(20, 400))
        got, info = get_subwindow_tracking(card_frame, box, 127, side, avg)
        ref, ref_info = get_subwindow_tracking(frame, box, 127, side, avg)
        sub_equal += np.array_equal(got.cpu().numpy(), ref) and info == ref_info
    if warp_equal != 2 * ORBAX_CROPS or sub_equal != ORBAX_CROPS:
        raise AssertionError(f"18d: bytes equal to the CPU's for {warp_equal} of {2 * ORBAX_CROPS} warps and "
                             f"{sub_equal} of {ORBAX_CROPS} subwindows")
    print(f"[18d] warp_affine_linear_u8 and rescale_crop ({2 * ORBAX_CROPS}) and get_subwindow_tracking "
          f"({ORBAX_CROPS}) on a 480x256 frame on the card: bytes equal to the CPU's for every seeded box [{card}]",
          flush=True)
    lap("18d")
    print(f"[18] phase 18 in {time.perf_counter() - t18:.1f} s", flush=True)
    return {"orbax": counts["orbax"][0]}


TRACE_5C = "chiprun_out/trace_static_track"  # phase 5c's trace, read by op in 20e

# phase 19: the card host's image input and output, with cv2 blocked
JPEG_FIXTURES = ("tests", "fixtures", "jpeg")  # cv2-made JPEGs and the sha256s of cv2's bytes
HOST_ITEMS = ("tests", "fixtures", "host_items.json")  # 19d's item digests, made on the CPU with cv2
# the transforms of both host pipelines, each forced on in turn for 19d
PHOTOMETRIC = ("Blur", "MotionBlur", "MedianBlur", "GaussianBlur", "GlassBlur", "GaussNoise", "ImageCompression",
               "ISONoise", "MultiplicativeNoise", "RandomRain", "RandomShadow", "Downscale")
TRACKING = ("ToGray", "ToSepia", "CLAHE", "RandomBrightnessContrast", "Emboss", "RandomGamma",
            "HueSaturationValue", "RGBShift", "Equalize", "ColorJitter", "RandomToneCurve")
HOST_ITEM_COUNT = 64
# ISONoise draws its noise from the float32 std of the image's lightness,
# a numpy reduction whose last bits may differ between numpy builds: its
# items are held to the mean of each image within this much of the CPU's
# (normalised units; one grey level is 0.017) where their bytes differ
ISO_MEAN_ATOL = 1e-3
HOSTAUG_STEPS, HOSTAUG_EPOCHS, HOSTAUG_WORKERS = 3, 1, 8
HOSTAUG_FRAME_HW = (720, 1280)  # a GOT-10k frame's size
HOST_OPE_SEED = 19  # phase 19b's generator seed
HOST_CODEC_REPS = 5


def fixture_frame(seed: int, h: int, w: int, gray: bool = False):
    """A seeded frame from integer draws alone, so the same bytes on every
    host: 16-pixel colour cells plus noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3))
    img = np.repeat(np.repeat(cells, 16, 0), 16, 1)[:h, :w]
    img = np.clip(img + rng.randint(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img[..., 0]) if gray else img


# (seed, h, w, quality, gray) of 19a's encoder checks
ENCODE_CASES = [(0, 720, 1280, 95, False), (1, 33, 17, 50, False), (2, 128, 128, 75, False), (3, 256, 256, 100, False),
                (4, 1, 1, 95, False), (5, 99, 101, 90, False), (6, 41, 29, 90, True), (7, 256, 256, 95, True)]


def host_item_tree(root: str) -> str:
    """19d's JPEG tree: 4 tracks of 6 seeded 240x320 frames (``fixture_frame``),
    encoded by the port at quality 95, and ``train.csv`` naming them; → the
    CSV's path."""
    import csv
    import os

    from feartracker_tpu_torch.data.jpeg import encode_jpeg

    os.makedirs(root, exist_ok=True)
    rows = []
    for t in range(4):
        for f in range(6):
            img = fixture_frame(1000 + 10 * t + f, 240, 320)
            x, y, w, h = 40 + 9 * f + 20 * t, 50 + 5 * f, 60 + 4 * t, 70
            img[y:y + h, x:x + w] = (200, 60 + 40 * t, 90)
            name = f"t{t}_f{f}.jpg"
            with open(os.path.join(root, name), "wb") as fh:
                fh.write(encode_jpeg(img, 95))
            rows.append({"sequence_id": f"s{t}", "track_id": f"t{t}", "frame_index": f, "img_path": name,
                         "bbox": str([x, y, w, h]), "frame_shape": "[320, 240]", "dataset": "host",
                         "presence": 1, "near_corner": 0})
    path = os.path.join(root, "train.csv")
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return path


def forced_item_digests(dataset_cls, aug, root: str) -> list:
    """19d's items: ``HOST_ITEM_COUNT`` normal-mode items of ``dataset_cls``
    over ``host_item_tree(root)``, item i with transform i of the 23 (mod
    23) forced on and the rest off, ``aug`` the augmentations module of the
    dataset's own package; → per item (transform, sha256 of every field,
    mean of each image array)."""
    import hashlib

    import numpy as np

    csv_path = host_item_tree(root)
    cfg = {"root": root, "name": "host", "sizes": dict(TRAIN_SIZES), "regression_weight_label_size": 16,
           "sampling": {"type": "track", "data_path": csv_path, "negative_ratio": 0.0, "frame_offset": 3,
                        "num_samples": 16, "clip_range": True}}
    ds = dataset_cls(cfg, {"score_size": 16, "total_stride": 16}, seed=19)
    names = PHOTOMETRIC + TRACKING
    out = []
    for i in range(HOST_ITEM_COUNT):
        name = names[i % len(names)]
        forced = aug.OneOf([getattr(aug, name)()], p=1.0)
        photometric = name in PHOTOMETRIC
        ds.photometric = aug.Compose([forced] if photometric else [])
        ds.paired_color = aug.PairedCompose([] if photometric else [forced])
        item = ds[i % len(ds)]
        h = hashlib.sha256()
        means = {}
        for k in sorted(item):
            v = item[k]
            h.update(k.encode())
            if isinstance(v, np.ndarray):
                h.update(f"{v.dtype}{v.shape}".encode())
                h.update(np.ascontiguousarray(v).tobytes())
                if v.ndim == 3:
                    means[k] = float(v.astype(np.float64).mean())
            else:
                h.update(repr(v).encode())
        out.append({"transform": name, "index": i % len(ds), "sha256": h.hexdigest(), "means": means})
    return out


def _sha(data) -> str:
    import hashlib

    return hashlib.sha256(bytes(data)).hexdigest()


def _phase_host_io(card, counters, lap, work: str, trace_dir: str):
    """Phases 19 and 20, the card host's image input and output with cv2
    blocked in the process wherever they read images. 19: JPEG and the host
    augmentations: the codec against cv2's bytes (19a), the default training
    configuration over a JPEG tree (19b), the GOT-10k protocol over JPEG
    against ``.npy`` frames of the same pixels (19c) and the forced-transform
    items against the CPU's (19d). 20: the other frame formats (20a-c), the
    demo over mp4 through the host's cv2 (20d) and phase 5c's trace by op
    (20e). → each path's launches."""
    import importlib.util
    import os

    t19 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    cv2_present = importlib.util.find_spec("cv2") is not None
    earlier = sys.modules.pop("cv2", None)
    sys.modules["cv2"] = None  # an import of cv2 raises for the rest of the phase
    try:
        launches, ope = _phase_host_io_body(card, counters, lap, work, here, cv2_present, t19)
        t20 = time.perf_counter()
        launches.update(_phase_formats(card, counters, lap, work, here, ope))
        t21 = time.perf_counter()
        launches.update(_phase_tiff_webp_gif(card, counters, lap, work, here, ope))
        print(f"[21] phase 21 in {time.perf_counter() - t21:.1f} s", flush=True)
        t22 = time.perf_counter()
        launches.update(_phase_jp2_hdr_pam(card, counters, lap, work, here))
        print(f"[22] phase 22 in {time.perf_counter() - t22:.1f} s", flush=True)
        t23 = time.perf_counter()
        launches.update(_phase_tiff_fax_cmyk(card, counters, lap, work, here, ope))
        print(f"[23] phase 23 in {time.perf_counter() - t23:.1f} s", flush=True)
        t24 = time.perf_counter()
        launches.update(_phase_webp_parts_jp2_modes(card, counters, lap, work, here))
        print(f"[24] phase 24 in {time.perf_counter() - t24:.1f} s", flush=True)
    finally:
        del sys.modules["cv2"]
        if earlier is not None:
            sys.modules["cv2"] = earlier
    launches.update(_phase_video(card, counters, lap, work))
    _phase_trace_ops(card, lap, trace_dir)
    print(f"[20] phase 20 in {time.perf_counter() - t20:.1f} s", flush=True)
    return launches


def host_ope_tree(data_root: str) -> str:
    """Phase 19b's GOT-10k tree under ``data_root``: ``make_synthetic_dataset``
    seed 19, 8 tracks (96 rows: 3 batches of 32 an epoch) and 2 val sequences
    of 12 JPEG frames of a GOT-10k frame's size, the val split moved to
    ``got10k/val``. → the tree's root (phase 19c's and 23b's OPE tree)."""
    import os

    from feartracker_tpu_torch.tools.make_synthetic_dataset import generate

    generate(os.path.join(data_root, "got10k"), tracks=8, frames=12, val_sequences=2, seed=HOST_OPE_SEED,
             size=HOSTAUG_FRAME_HW, fmt="jpg")
    os.rename(os.path.join(data_root, "got10k", "got10k", "val"), os.path.join(data_root, "got10k", "val"))
    return os.path.join(data_root, "got10k")


def _phase_host_io_body(card, counters, lap, work, here, cv2_present, t19):
    import os
    import statistics

    import numpy as np
    import torch

    from feartracker_tpu_torch.data import augmentations as aug
    from feartracker_tpu_torch.data.dataset import SiameseTrackingDataset
    from feartracker_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from feartracker_tpu_torch.data.loader import BatchLoader
    from feartracker_tpu_torch.data.sequence import GOT10kDataset
    from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
    from feartracker_tpu_torch.train import loop as L
    from feartracker_tpu_torch.train.loop import Trainer
    from feartracker_tpu_torch.train.summary import read_events, scalars

    # 19a: the codec against cv2's bytes, made on the CPU with cv2
    with open(os.path.join(here, *JPEG_FIXTURES, "manifest.json")) as fh:
        manifest = json.load(fh)
    enc_bad = [c for c in manifest["encode"] if _sha(encode_jpeg(fixture_frame(c["seed"], c["h"], c["w"], c["gray"]),
                                                                  c["quality"])) != c["sha256"]]
    dec_bad = []
    for c in manifest["decode"]:
        img = decode_jpeg(os.path.join(here, *JPEG_FIXTURES, c["file"]))
        if list(img.shape) != c["shape"] or _sha(img.tobytes()) != c["sha256"]:
            dec_bad.append(c["file"])
    if enc_bad or dec_bad:
        raise AssertionError(f"19a: encodes differ from cv2's for {enc_bad}; decodes for {dec_bad}")
    frame = fixture_frame(0, 720, 1280)
    data = encode_jpeg(frame, 95)
    for _ in range(3):
        decode_jpeg(data)
    enc_ms, dec_ms = [], []
    for _ in range(HOST_CODEC_REPS):
        t0 = time.perf_counter()
        encode_jpeg(frame, 95)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        decode_jpeg(data)
        dec_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[19a] JPEG codec (csrc/jpeg.cpp, g++) on the card host, cv2 installed {cv2_present}, blocked in the "
          f"process for the phase: "
          f"{len(manifest['encode'])} seeded encodes and {len(manifest['decode'])} cv2-made files ("
          f"{', '.join(c['kind'] for c in manifest['decode'])}) byte-equal to cv2's; 1280x720 4:2:0 q95 "
          f"({len(data) / 1e3:.0f} kB) decode p50 {statistics.median(dec_ms):.2f} ms, encode p50 "
          f"{statistics.median(enc_ms):.2f} ms on one core [{card}]", flush=True)
    lap("19a")

    # 19b: the default training configuration (host augmentations) over a
    # JPEG tree that the port's generator writes here
    data_root = os.path.join(work, "hostaug_data")
    t0 = time.perf_counter()
    host_ope_tree(data_root)
    gen_s = time.perf_counter() - t0
    exp = os.path.join(work, "hostaug_exp")
    cfg = _loop_config(data_root, exp, "HOSTAUG", [
        "device_augs=false", f"num_workers={HOSTAUG_WORKERS}", f"train_percent={HOSTAUG_STEPS}",
        f"max_epochs={HOSTAUG_EPOCHS}", "sanity_steps=0", "max_val_samples=12"])
    if cfg["device_augs"] or cfg["batch_size"]["train"] != 32:
        raise AssertionError(f"19b: device_augs {cfg['device_augs']}, B {cfg['batch_size']['train']}")
    trainer = Trainer(cfg)
    trainer.setup_data()
    trainer.val_datasets = [GOT10kDataset(os.path.join(data_root, "got10k"), "val")]
    # the loader alone, as 12c times it: host ms a batch over an epoch's batches
    alone = BatchLoader(trainer.train_dataset, 32, num_workers=HOSTAUG_WORKERS, seed=0)
    t0 = time.perf_counter()
    n_alone = sum(1 for _ in alone)
    host_ms = (time.perf_counter() - t0) * 1e3 / n_alone
    loader_ms = []
    plain_iter = L.BatchLoader.__iter__

    def timed_iter(self):  # the time to make each batch, as the step waits for it
        it = plain_iter(self)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            loader_ms.append((time.perf_counter() - t0) * 1e3)
            yield b

    mined = []
    miner_update = trainer.miner.update

    def spy(score, batch, outputs):
        before = (trainer.miner.best_mosaic, trainer.miner.worst_mosaic)
        miner_update(score, batch, outputs)
        after = (trainer.miner.best_mosaic, trainer.miner.worst_mosaic)
        mined.extend(m for m, b in zip(after, before) if m is not None and m is not b)

    trainer.miner.update = spy
    lengths = _val_lengths(os.path.join(data_root, "got10k"), 12)
    nf = _n_fused("fear_xs")
    schedule = _sum_launches(*[_sequential_launches(lengths, nf)] * HOSTAUG_EPOCHS)
    L.BatchLoader.__iter__ = timed_iter
    try:
        _zero(counters)
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        L.BatchLoader.__iter__ = plain_iter
    got = _read(counters)
    losses = scalars(read_events(os.path.join(trainer.exp_dir, "logs")))["train/loss"]
    events = read_events(os.path.join(trainer.exp_dir, "logs"))
    images = sorted({v["tag"] for e in events for v in e.get("summary", ()) if "image" in v})
    if got != schedule or len(losses) != HOSTAUG_STEPS * HOSTAUG_EPOCHS or not all(np.isfinite(v) for _, v in losses):
        raise AssertionError(f"19b: launches {got} against the validation schedule {schedule}; losses {losses}")
    if not mined or any(m.dtype != np.uint8 or m.ndim != 3 for m in mined):
        raise AssertionError(f"19b: {len(mined)} mosaics mined")
    print(f"[19b] Trainer.fit at the default device_augs=false: host augmentations on {HOSTAUG_WORKERS} loader "
          f"threads, B=32 bf16, {HOSTAUG_EPOCHS} epochs x {HOSTAUG_STEPS} steps over a JPEG GOT-10k tree written "
          f"here by make_synthetic_dataset --format jpg ({HOSTAUG_FRAME_HW[1]}x{HOSTAUG_FRAME_HW[0]}, 8 tracks + 2 "
          f"val sequences of 12 frames, {gen_s:.1f} s): losses {', '.join(f'{v:.4f}' for _, v in losses)}; "
          f"launches {got} = the validation schedule (FEARTracker over the JPEG frames, {lengths} frames a "
          f"sequence); loader alone {host_ms:.0f} ms a batch over {n_alone} batches (12c's staged .npy path: "
          f"679-721 ms); in the fit, each batch's wait {', '.join(f'{v:.0f}' for v in loader_ms)} ms; {len(mined)} mosaics "
          f"mined ({mined[0].shape[1]}x{mined[0].shape[0]}), logged as {images}; fit {fit_s:.1f} s [{card}]",
          flush=True)
    lap("19b")

    # 19c: the GOT-10k protocol over the JPEG frames and over .npy frames
    # of the same decoded pixels
    npy_root = os.path.join(work, "hostaug_npy")
    val_dir = os.path.join(data_root, "got10k", "val")
    for seq in sorted(os.listdir(val_dir)):
        src = os.path.join(val_dir, seq)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(npy_root, "val", seq)
        os.makedirs(dst, exist_ok=True)
        for f in os.listdir(src):
            if f.endswith(".jpg"):
                np.save(os.path.join(dst, f[:-4] + ".npy"), decode_jpeg(os.path.join(src, f)))
            else:
                with open(os.path.join(src, f), "rb") as a, open(os.path.join(dst, f), "wb") as b:
                    b.write(a.read())
    with open(os.path.join(val_dir, "list.txt"), "rb") as a, open(os.path.join(npy_root, "val", "list.txt"), "wb") as b:
        b.write(a.read())
    ao, counts = {}, {}
    for name, root in (("jpg", os.path.join(data_root, "got10k")), ("npy", npy_root)):
        ds = GOT10kDataset(root, "val")
        if not all(f.endswith("." + name) for i in range(len(ds)) for f in ds[i][0]):
            raise AssertionError(f"19c: the {name} dataset lists other frames")
        tracker = _fear_tracker("cuda", torch.float32)
        _zero(counters)
        ao[name] = evaluate_tracker(tracker, ds)
        torch.cuda.synchronize()
        counts[name] = _read(counters)
    full = _val_lengths(os.path.join(data_root, "got10k"))
    want = _sequential_launches(full, nf)
    if ao["jpg"] != ao["npy"] or counts["jpg"] != want or counts["npy"] != want:
        raise AssertionError(f"19c: JPEG {ao['jpg']} {counts['jpg']} against .npy {ao['npy']} {counts['npy']}; "
                             f"schedule {want}")
    print(f"[19c] GOT-10k OPE (FEARTracker FEAR-XS f32) over the {len(full)} JPEG val sequences and over .npy "
          f"frames of the same decoded pixels: every result equal (AO {ao['jpg']['ao']:.6f}, SR50 "
          f"{ao['jpg']['sr50']:.4f}, per sequence {ao['jpg']['per_sequence']}); launches {counts['jpg']} each, = the "
          f"schedule [{card}]", flush=True)
    lap("19c")

    # 19d: forced-transform items against the CPU's digests
    with open(os.path.join(here, *HOST_ITEMS)) as fh:
        want_items = json.load(fh)["items"]
    t0 = time.perf_counter()
    got_items = forced_item_digests(SiameseTrackingDataset, aug, os.path.join(work, "host_items"))
    items_s = time.perf_counter() - t0
    equal, near, bad = 0, [], []
    for g, w in zip(got_items, want_items):
        if g["transform"] != w["transform"] or g["index"] != w["index"]:
            raise AssertionError(f"19d: item order {g['transform']} {g['index']} against {w['transform']}")
        if g["sha256"] == w["sha256"]:
            equal += 1
        elif g["transform"] == "ISONoise" and g["means"].keys() == w["means"].keys() and all(
                abs(g["means"][k] - w["means"][k]) <= ISO_MEAN_ATOL for k in w["means"]):
            near.append(max(abs(g["means"][k] - w["means"][k]) for k in w["means"]))
        else:
            bad.append(g["transform"])
    if bad or len(got_items) != len(want_items):
        raise AssertionError(f"19d: items of {bad} differ from the CPU's")
    print(f"[19d] {len(got_items)} normal-mode items (256/128 crops of the 240x320 JPEG tree), each with one of the "
          f"{len(PHOTOMETRIC) + len(TRACKING)} host transforms forced on: {equal} byte-equal to the CPU's (cv2 and "
          f"JAX's items there); ISONoise items off by numpy's float std: {len(near)}"
          f"{f' (image means within {max(near):.1e} <= {ISO_MEAN_ATOL})' if near else ''}; {items_s:.1f} s on "
          f"one thread [{card}]", flush=True)
    lap("19d")
    print(f"[19] phase 19 in {time.perf_counter() - t19:.1f} s", flush=True)
    return ({"host_train": got, "host_ope": _sum_launches(counts["jpg"], counts["npy"])},
            {"ao": ao["npy"], "launches": want, "jpeg_root": os.path.join(data_root, "got10k"), "lengths": full})


# phase 20: the other frame formats of cv2.imread, the demo's video and traces by op
IMAGE_FIXTURES = ("tests", "fixtures", "images")  # seeded PNG/BMP/PNM/JPEG files and the sha256s of cv2's pixels
CMYK_TIMING_FILE = "cmyk_1280x720.jpg"
FORMAT_MANIFEST = "manifest_tiff_webp_gif.json"  # phase 21a's files and cv2's pixels of each
# leading bytes of formats cv2 reads and the port does not: each must raise naming it
UNREAD_SIGNATURES = (("AVIF", b"\x00\x00\x00\x20ftypavif"),)
JP2_MANIFEST = "manifest_jp2_hdr_pam.json"  # phase 22a's files and cv2's pixels of each
JP2_TREE = ("tests", "fixtures", "jp2_got10k")  # phase 22b's GOT-10k val tree of JPEG 2000 frames
JP2_TREE_RECORD = "record.json"  # its files' sha256s, how it was written and the CPU's OPE result over it
FAX_CMYK_MANIFEST = "manifest_tiff_fax_cmyk.json"  # phase 23a's files and cv2's pixels of each
# phase 23b(ii): the sha256 of each frame of 19c's val tree rewritten by tiff_ycbcr22, and the CPU's OPE over it
TIFF_OPE_RECORD = ("tests", "fixtures", "tiff_ope_record.json")
YCBCR_OPE_PX, YCBCR_OPE_AO = 1.0, 0.01  # 23b(ii)'s gate against that record: PERF.md section 2's f32 gate
WEBP_PARTS_JP2_MANIFEST = "manifest_webp_parts_jp2_modes.json"  # phase 24a's files and cv2's pixels of each
# phase 24b: 19c's val sequences written as 4-partition lossy WebP, each file's sha256 and the CPU's OPE over them
WEBP_TREE = ("tests", "fixtures", "webp_parts_got10k")
WEBP_TREE_RECORD = "record.json"
WEBP_OPE_PX, WEBP_OPE_AO = 1.0, 0.01  # 24b's gate against that record: PERF.md section 2's f32 gate
PRETRAIN_MIX = ("cmyk.jpg", "cmyk_progressive.jpg", "ycck.jpg", "s411.jpg", "png_named.JPEG")
VIDEO_FRAMES = 30


def bmp24(img) -> bytes:
    """(H, W, 3) RGB uint8 → a bottom-up 24-bit BMP (BITMAPINFOHEADER)."""
    import struct

    import numpy as np

    h, w = img.shape[:2]
    pitch = (3 * w + 3) & -4
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, :3 * w] = img[::-1, :, ::-1].reshape(h, 3 * w)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + info + rows.tobytes()


def _pack_codes(codes, widths, lsb_first: bool) -> bytes:
    """Variable-width codes packed most significant bit first (TIFF) or
    least significant bit first (GIF), numpy only."""
    import numpy as np

    codes, widths = np.asarray(codes, np.int64), np.asarray(widths, np.int64)
    ends = np.cumsum(widths)
    starts = ends - widths
    # a code (at most 16 bits) lies in the 3 bytes from its first bit's byte on; the codes' bits do not
    # overlap, so summing each byte's parts ORs them
    v = codes << (starts % 8) if lsb_first else codes << (24 - starts % 8 - widths)
    parts = [(v >> (8 * k if lsb_first else 16 - 8 * k)) & 255 for k in range(3)]
    at = np.concatenate([starts // 8 + k for k in range(3)])
    out = np.bincount(at, np.concatenate(parts), minlength=-(-int(ends[-1]) // 8) + 2)
    return out[:-(-int(ends[-1]) // 8)].astype(np.uint8).tobytes()


def _literal_lzw(data: bytes, tiff: bool):
    """LZW codes and widths that hold ``data`` as literal codes only: a Clear,
    at most 3,800 literals, a Clear, ..., an EOI; each code as wide as the
    decoder's growing table makes it (TIFF's decoder widens one code earlier
    than GIF's). Valid LZW, without compression: the writer needs no table."""
    import numpy as np

    per, g = 3800, 0 if tiff else 1

    def width(j):
        return 9 + (j >= 254 + g) + (j >= 766 + g) + (j >= 1790 + g)

    lit = np.frombuffer(data, np.uint8).astype(np.int64)
    chunks = [lit[i:i + per] for i in range(0, len(lit), per)] or [lit]
    codes, widths = [], []
    clear_width = 9
    for chunk in chunks:
        codes += [np.array([256]), chunk]
        widths += [np.array([clear_width]), width(np.arange(len(chunk)))]
        clear_width = int(width(len(chunk)))
    codes.append(np.array([257]))
    widths.append(np.array([clear_width]))
    return np.concatenate(codes), np.concatenate(widths)


def _ifd(entries, at: int) -> bytes:
    """A little-endian classic TIFF IFD at file offset ``at``: (tag, SHORT
    or LONG type, values) entries, longer values after it."""
    import struct

    entries = sorted(entries)
    after = at + 2 + 12 * len(entries) + 4
    out, extra = struct.pack("<H", len(entries)), b""
    for tag, typ, vals in entries:
        payload = b"".join(struct.pack("<H" if typ == 3 else "<I", v) for v in vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack("<I", after + len(extra))
            extra += payload
        out += struct.pack("<HHI", tag, typ, len(vals)) + field
    return out + b"\0\0\0\0" + extra


def tiff_lzw(img, rows: int = 16) -> bytes:
    """(H, W, 3) RGB uint8 → a TIFF of strips of ``rows`` rows, LZW
    compression (literal codes: ``_literal_lzw``) after predictor 2."""
    return _tiff_strips(img, rows, 5, [(262, 3, [2])])


def _tiff_file(strips, w: int, h: int, rows: int, bits, entries) -> bytes:
    """A little-endian TIFF: the 8-byte header, ``strips`` (``rows`` image
    rows each), then the IFD: the size, ``bits`` (one a sample), the strips'
    offsets and counts, contiguous samples, and ``entries`` ((tag, type,
    values): compression, photometric, ...)."""
    import struct

    offsets, pos = [], 8
    for st in strips:
        offsets.append(pos)
        pos += len(st)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, list(bits)), (273, 4, offsets), (277, 3, [len(bits)]),
               (278, 4, [rows]), (279, 4, [len(st) for st in strips]), (284, 3, [1])] + list(entries)
    return b"II" + struct.pack("<HI", 42, pos) + b"".join(strips) + _ifd(entries, pos)


def _tiff_strips(samples, rows: int, compression: int, entries) -> bytes:
    """A TIFF of (H, W, C) uint8 ``samples`` (contiguous) in strips of
    ``rows`` rows: compression 1 (none) or 5 (LZW of literal codes, after
    predictor 2); ``entries`` adds the photometric tag and any other."""
    import numpy as np

    h, w, c = samples.shape
    v = samples.reshape(h, c * w)
    if compression == 5:
        d = v.astype(np.int16)
        d[:, c:] = d[:, c:] - d[:, :-c]
        v = (d & 255).astype(np.uint8)
        strips = [_pack_codes(*_literal_lzw(v[y:y + rows].tobytes(), True), lsb_first=False)
                  for y in range(0, h, rows)]
        entries = list(entries) + [(317, 3, [2])]
    else:
        strips = [v[y:y + rows].tobytes() for y in range(0, h, rows)]
    return _tiff_file(strips, w, h, rows, [8] * c, [(259, 3, [compression])] + list(entries))


def tiff_cmyk(img, rows: int = 16) -> bytes:
    """(H, W, 3) RGB uint8 → an 8-bit CMYK TIFF (photometric 5), LZW after
    predictor 2: C, M, Y = 255 - R, G, B and K = 0, which libtiff's
    ``k * (255 - C) / 255`` takes back to R, G, B exactly."""
    import numpy as np

    cmyk = np.concatenate([255 - img, np.zeros(img.shape[:2] + (1,), np.uint8)], axis=2)
    return _tiff_strips(cmyk, rows, 5, [(262, 3, [5])])


def tiff_ycbcr22(img, rows: int = 16) -> bytes:
    """(H, W, 3) RGB uint8 → an uncompressed YCbCr TIFF (photometric 6),
    YCbCrSubsampling 2x2: JPEG's full-range BT.601 conversion, each 2x2
    block's Cb and Cr its four pixels' mean (lossy: the chroma is shared)."""
    import numpy as np

    h, w = img.shape[:2]
    ph, pw = -(-h // 2) * 2, -(-w // 2) * 2
    rgb = np.pad(img.astype(np.float64), ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = np.clip(np.rint(0.299 * r + 0.587 * g + 0.114 * b), 0, 255).astype(np.uint8)
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    mean = [np.clip(np.rint(c.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))), 0, 255).astype(np.uint8)
            for c in (cb, cr)]
    yb = y.reshape(ph // 2, 2, pw // 2, 2).transpose(0, 2, 1, 3).reshape(ph // 2, pw // 2, 4)
    blocks = np.concatenate([yb, mean[0][..., None], mean[1][..., None]], axis=2)  # a block row = 2 pixel rows
    per = max(1, rows // 2)  # block rows a strip
    strips = [blocks[y:y + per].tobytes() for y in range(0, blocks.shape[0], per)]
    return _tiff_file(strips, w, h, 2 * per, [8, 8, 8], [(259, 3, [1]), (262, 3, [6]), (530, 3, [2, 2])])


def tiff_lab(img, rows: int = 16) -> bytes:
    """(H, W, 3) RGB uint8 → an uncompressed 8-bit CIELab TIFF (photometric
    8): sRGB (D65) to XYZ to L*a*b* against D50, L scaled to 0-255, a and b
    as signed bytes."""
    import numpy as np

    c = img.astype(np.float64) / 255
    c = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    xyz = c @ np.array([[0.4124, 0.2126, 0.0193], [0.3576, 0.7152, 0.1192], [0.1805, 0.0722, 0.9505]])
    t = xyz / np.array([0.9642, 1.0, 0.8249])
    f = np.where(t > 216 / 24389, np.cbrt(t), (24389 / 27 * t + 16) / 116)
    lab = np.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]), 200 * (f[..., 1] - f[..., 2])], axis=2)
    out = np.empty(img.shape, np.uint8)
    out[..., 0] = np.clip(np.rint(lab[..., 0] * 255 / 100), 0, 255)
    out[..., 1:] = np.clip(np.rint(lab[..., 1:]), -128, 127).astype(np.int8).view(np.uint8)
    return _tiff_strips(out, rows, 1, [(262, 3, [8])])


# T.4's run-length codes, first bit first: white and black terminating codes
# (runs 0-63), their make-up codes (64-1728), the shared make-up codes (1792-2560)
T4_WHITE = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 101010 "
            "101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 00000010 "
            "00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 00101001 "
            "00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 "
            "01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 00110011 "
            "00110100").split()
T4_WHITE_MAKEUP = ("11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 "
                   "011001101 011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 "
                   "011011010 011011011 010011000 010011001 010011010 011000 010011011").split()
T4_BLACK = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
            "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 "
            "00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
            "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 "
            "000011010111 000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
            "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
            "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 000000101011 "
            "000000101100 000001011010 000001100110 000001100111").split()
T4_BLACK_MAKEUP = ("0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
                   "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
                   "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
                   "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
                   "0000001100100 0000001100101").split()
T4_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 000000010110 "
             "000000010111 000000011100 000000011101 000000011110 000000011111").split()


def _mh_run(n: int, black: bool) -> str:
    """One run's Modified Huffman codes: 2560 make-ups, a make-up, a terminating code."""
    out = []
    while n > 2623:
        out.append(T4_MAKEUP[-1])
        n -= 2560
    if n >= 64:
        m = n // 64
        out.append((T4_BLACK_MAKEUP if black else T4_WHITE_MAKEUP)[m - 1] if m <= 27 else T4_MAKEUP[m - 28])
        n -= 64 * m
    out.append((T4_BLACK if black else T4_WHITE)[n])
    return "".join(out)


def tiff_fax_mh(img) -> bytes:
    """(H, W, 3) RGB uint8 → a bilevel TIFF, CCITT Modified Huffman
    (compression 2: each row's runs, white first, byte-aligned), MinIsWhite:
    black where the pixel's channel mean is below 128."""
    import numpy as np

    h, w = img.shape[:2]
    black = img.astype(np.int32).sum(axis=2) < 3 * 128
    data = bytearray()
    for row in black:
        runs = np.diff([0] + (np.flatnonzero(row[1:] != row[:-1]) + 1).tolist() + [w]).tolist()
        bits = "".join(_mh_run(n, k % 2 == 1) for k, n in enumerate([0] * bool(row[0]) + runs))
        bits += "0" * (-len(bits) % 8)
        data += int(bits, 2).to_bytes(len(bits) // 8, "big")
    return _tiff_file([bytes(data)], w, h, h, [1], [(259, 3, [2]), (262, 3, [0])])


def webp_lossless(img) -> bytes:
    """(H, W, 3) RGB uint8 → a lossless WebP (VP8L) without transforms or
    colour cache: every green, red and blue value an 8-bit prefix code,
    alpha and distance one-symbol codes."""
    import struct

    import numpy as np

    h, w = img.shape[:2]
    bits = []

    def put(v, n):  # LSB first, as VP8L reads its header fields
        bits.extend((v >> i) & 1 for i in range(n))

    put(0, 3)  # no transform, no colour cache, no meta prefix codes
    for alphabet in (280, 256, 256):  # green (+ 24 length codes), red, blue
        put(0, 1)  # a normal code: its lengths through a code-length code
        put(12 - 4, 4)  # 12 code-length code lengths, in kCodeLengthCodeOrder
        for length in (0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1):  # symbols 0 and 8 at 1 bit
            put(length, 3)
        put(0, 1)  # every symbol's length follows
        bits.extend([1] * 256 + [0] * (alphabet - 256))  # length 8 (code 1), then 0 (code 0)
    put(1, 1), put(0, 1), put(1, 1), put(255, 8)  # alpha: one symbol, 255
    put(1, 1), put(0, 1), put(0, 1), put(0, 1)  # distance: one symbol, 0
    head = np.array(bits, np.uint8)
    gbr = img[..., [1, 0, 2]].reshape(-1)
    px = np.unpackbits(gbr, bitorder="big")  # an 8-bit canonical code is the value, first bit first
    payload = np.packbits(np.concatenate([head, px]), bitorder="little").tobytes()
    vp8l = b"\x2f" + struct.pack("<I", (w - 1) | (h - 1) << 14) + payload
    chunk = b"VP8L" + struct.pack("<I", len(vp8l)) + vp8l + b"\0" * (len(vp8l) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def gif_332(img) -> bytes:
    """(H, W, 3) RGB uint8 → a GIF89a of the colours cut to 3-3-2 bits (a
    256-entry global table), LZW of literal codes (``_literal_lzw``)."""
    import struct

    import numpy as np

    h, w = img.shape[:2]
    idx = (img[..., 0] & 0xE0) | ((img[..., 1] >> 3) & 0x1C) | (img[..., 2] >> 6)
    i = np.arange(256)
    table = np.stack([(i & 0xE0) * 255 // 0xE0, ((i & 0x1C) << 3) * 255 // 0xE0, (i & 3) * 85], 1).astype(np.uint8)
    data = _pack_codes(*_literal_lzw(idx.astype(np.uint8).tobytes(), False), lsb_first=True)
    blocks = b"".join(bytes([len(data[k:k + 255])]) + data[k:k + 255] for k in range(0, len(data), 255))
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + table.tobytes()
            + b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08" + blocks + b"\x00\x3b")


def pam_rgb(img) -> bytes:
    """(H, W, 3) RGB uint8 → a PAM (P7, TUPLTYPE RGB, maxval 255) whose
    samples are stored blue first: OpenCV's reader puts depth-3 samples into
    its BGR array as they are stored, and so does its writer."""
    h, w = img.shape[:2]
    return (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n".encode()
            + img[..., ::-1].tobytes())


def pfm_rgb(img) -> bytes:
    """(H, W, 3) RGB uint8 → a little-endian PFM (scale -1) holding the
    same values as floats, rows bottom-up."""
    h, w = img.shape[:2]
    return f"PF\n{w} {h}\n-1.0\n".encode() + img[::-1].astype("<f4").tobytes()


def sun_raster(img) -> bytes:
    """(H, W, 3) RGB uint8 → a standard 24-bit Sun raster: rows of blue,
    green, red padded to 16 bits, no colour map."""
    import struct

    import numpy as np

    h, w = img.shape[:2]
    pitch = (3 * w + 1) & ~1
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, :3 * w] = img[..., ::-1].reshape(h, 3 * w)
    return struct.pack(">8I", 0x59A66A95, w, h, 24, h * pitch, 1, 0, 0) + rows.tobytes()


def hdr_flat(img) -> bytes:
    """(H, W, 3) RGB uint8 → a Radiance file of flat RGBE pixels, each
    channel's mantissa the value and the exponent 128 (v / 256), which
    cv2 reads back as rint(v * 255 / 256)."""
    import numpy as np

    h, w = img.shape[:2]
    rgbe = np.concatenate([img, np.full((h, w, 1), 128, np.uint8)], axis=2)
    return f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode() + rgbe.tobytes()


def _decode_p50_ms(data: bytes, decode) -> float:
    import statistics

    for _ in range(3):
        decode(data)
    times = []
    for _ in range(HOST_CODEC_REPS):
        t0 = time.perf_counter()
        decode(data)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _rewrite_tree(src_root: str, dst_root: str, encode) -> int:
    """``src_root``'s val sequences with every ``.jpg`` frame decoded and
    written back by ``encode`` under the same name (cv2 and the port pick
    the decoder from the bytes); → frames written."""
    import os
    import shutil

    from feartracker_tpu_torch.data.imread import imread

    n = 0
    for d, _, files in os.walk(os.path.join(src_root, "val")):
        out = os.path.join(dst_root, os.path.relpath(d, src_root))
        os.makedirs(out, exist_ok=True)
        for f in files:
            if f.endswith(".jpg"):
                with open(os.path.join(out, f), "wb") as fh:
                    fh.write(encode(imread(os.path.join(d, f))))
                n += 1
            else:
                shutil.copyfile(os.path.join(d, f), os.path.join(out, f))
    return n


def _phase_formats(card, counters, lap, work: str, here: str, ope: dict) -> dict:
    """Phase 20a-c, cv2 blocked: every image fixture against cv2's pixels
    and 1280x720 decode ms (20a); phase 19c's OPE over its val frames
    rewritten as PNG and as BMP (20b); ``pretrain_trunk`` over an ImageFolder
    of mixed formats (20c). → each path's launches."""
    import math
    import os
    import shutil

    import numpy as np
    import torch

    from feartracker_tpu_torch.data.dataset import read_img
    from feartracker_tpu_torch.data.imread import imread
    from feartracker_tpu_torch.data.jpeg import encode_jpeg
    from feartracker_tpu_torch.data.sequence import GOT10kDataset
    from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
    from feartracker_tpu_torch.tools import pretrain_trunk
    from feartracker_tpu_torch.train.summary import encode_png

    launches = {}
    # 20a: the fixtures against cv2's pixels, made on the CPU with cv2
    images = os.path.join(here, *IMAGE_FIXTURES)
    with open(os.path.join(images, "manifest.json")) as fh:
        manifest = json.load(fh)["decode"]
    bad = []
    for c in manifest:
        img = read_img(os.path.join(images, c["file"]))
        if list(img.shape) != c["shape"] or _sha(img.tobytes()) != c["sha256"]:
            bad.append(c["file"])
    refused = {}
    for name, data in UNREAD_SIGNATURES:
        try:
            imread(data)
        except IOError as e:
            refused[name] = name in str(e)
    if bad or not all(refused.values()) or len(refused) != len(UNREAD_SIGNATURES):
        raise AssertionError(f"20a: {bad} differ from cv2's pixels; refusals named {refused}")
    frame = fixture_frame(0, 720, 1280)
    with open(os.path.join(images, CMYK_TIMING_FILE), "rb") as fh:
        cmyk = fh.read()
    timing = {"PNG (zlib level 6, filter 0)": encode_png(frame), "BMP 24-bit": bmp24(frame),
              "CMYK JPEG q75": cmyk}
    ms = {k: _decode_p50_ms(v, imread) for k, v in timing.items()}
    print(f"[20a] data/imread.py (PNG and BMP in numpy + csrc/imgcodecs.cpp, JPEG in csrc/jpeg.cpp), cv2 blocked: "
          f"{len(manifest)} fixtures ({', '.join(c['kind'] for c in manifest)}) equal to cv2's pixels; "
          f"{', '.join(refused)} raise IOError naming the format; 1280x720 decode p50 on one core "
          f"{', '.join(f'{k} ({len(timing[k]) / 1e3:.0f} kB) {v:.2f} ms' for k, v in ms.items())} [{card}]",
          flush=True)
    lap("20a")

    # 20b: phase 19c's OPE over its val frames rewritten as PNG and as BMP
    nf = _n_fused("fear_xs")
    results = {}
    for fmt, encode in (("png", encode_png), ("bmp", bmp24)):
        root = os.path.join(work, f"formats_{fmt}")
        n = _rewrite_tree(ope["jpeg_root"], root, encode)
        ds = GOT10kDataset(root, "val")
        with open(ds[0][0][0], "rb") as fh:
            head = fh.read(8)
        if not head.startswith(b"\x89PNG" if fmt == "png" else b"BM"):
            raise AssertionError(f"20b: the {fmt} tree holds {head!r}")
        tracker = _fear_tracker("cuda", torch.float32)
        _zero(counters)
        ao = evaluate_tracker(tracker, ds)
        torch.cuda.synchronize()
        results[fmt] = (ao, _read(counters), n)
        launches[f"formats_ope_{fmt}"] = results[fmt][1]
        shutil.rmtree(root)
    for fmt, (ao, got, n) in results.items():
        if ao != ope["ao"] or got != ope["launches"]:
            raise AssertionError(f"20b: {fmt} AO {ao} launches {got} against .npy {ope['ao']} {ope['launches']}")
    print(f"[20b] GOT-10k OPE (FEARTracker FEAR-XS f32) over phase 19c's {len(ope['lengths'])} val sequences "
          f"({results['png'][2]} frames) rewritten as PNG (train/summary.py:encode_png) and as 24-bit BMP under their "
          f".jpg names: every result equal to the run over .npy (AO {ope['ao']['ao']:.6f}); launches "
          f"{results['png'][1]} and {results['bmp'][1]}, = the schedule [{card}]", flush=True)
    lap("20b")

    # 20c: pretrain_trunk over an ImageFolder of mixed formats, the JAX tool's suffixes
    folder = os.path.join(work, "mixed_formats")
    for k in range(2):
        cls = os.path.join(folder, f"class{k}")
        os.makedirs(cls)
        img = fixture_frame(200 + k, 96, 128)
        files = {"baseline.jpg": encode_jpeg(img, 90), "plain.png": encode_png(img),
                 "bmp_named.jpg": bmp24(img[::-1])}
        for name in PRETRAIN_MIX:
            with open(os.path.join(images, name), "rb") as fh:
                files[name] = fh.read()
        for name, data in files.items():
            with open(os.path.join(cls, f"{k}_{name}"), "wb") as fh:
                fh.write(data)
    n_images = len(pretrain_trunk.list_image_folder(folder)[0])
    rec, got, seconds = _tool_rows(lambda: pretrain_trunk.run(folder, "fear_xs", os.path.join(work, "mixed.npz"),
                                                              epochs=1, batch_size=4, image_size=64, seed=0,
                                                              device="cuda"), counters, "20c")
    launches["pretrain_mixed_formats"] = got
    loss = rec["history"][-1]["loss"]
    if n_images != 16 or not math.isfinite(loss) or got != {"K1": 0, "K2": 0}:
        raise AssertionError(f"20c pretrain_trunk: {n_images} images, loss {loss}, launches {got}")
    print(f"[20c] pretrain_trunk FEAR-XS 64x64 B=4 over {n_images} images of 2 classes (baseline JPEG, CMYK and "
          f"progressive CMYK JPEG, YCCK, 4:1:1, PNG, a PNG named .JPEG, a BMP named .jpg): {rec['steps']} steps, "
          f"loss {loss:.4f}; launches {got}; {seconds:.1f} s [{card}]", flush=True)
    lap("20c")
    if "cv2" in {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}:
        raise AssertionError("20a-c imported cv2")
    return launches


def _phase_tiff_webp_gif(card, counters, lap, work: str, here: str, ope: dict) -> dict:
    """Phase 21, cv2 blocked: the TIFF, WebP, GIF and JPEG-mode fixtures
    against cv2's pixels and 1280x720 decode ms (21a); phase 19c's OPE over
    its val frames rewritten as TIFF (LZW, predictor 2) and as lossless WebP
    (21b); ``make_annotations`` over GOT-10k and YouTube-BB trees of TIFF,
    WebP and GIF frames against the same trees in JPEG (21c). → each path's
    launches."""
    import os
    import shutil

    import torch

    from feartracker_tpu_torch.data.dataset import read_img
    from feartracker_tpu_torch.data.imread import imread
    from feartracker_tpu_torch.data.jpeg import encode_jpeg
    from feartracker_tpu_torch.data.sequence import GOT10kDataset
    from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker

    launches = {}
    # 21a: the fixtures against cv2's pixels, made on the CPU with cv2 and PIL
    images = os.path.join(here, *IMAGE_FIXTURES)
    with open(os.path.join(images, FORMAT_MANIFEST)) as fh:
        manifest = json.load(fh)["decode"]
    bad, timing = [], {}
    for c in manifest:
        path = os.path.join(images, c["file"])
        img = read_img(path)
        if list(img.shape) != c["shape"] or _sha(img.tobytes()) != c["sha256"]:
            bad.append(c["file"])
        if c["file"].startswith("timing_"):
            with open(path, "rb") as fh:
                timing[c["kind"]] = fh.read()
    if bad or len(timing) != 5:
        raise AssertionError(f"21a: {bad} differ from cv2's pixels ({len(timing)} timing files)")
    ms = {k: _decode_p50_ms(v, imread) for k, v in timing.items()}
    print(f"[21a] data/tiff.py, data/webp.py, data/gif.py (+ csrc/imgcodecs.cpp, csrc/webp.cpp, csrc/jpeg.cpp), "
          f"cv2 blocked: {len(manifest)} fixtures equal to cv2's pixels; 1280x720 decode p50 on one core "
          f"{', '.join(f'{k} ({len(timing[k]) / 1e3:.0f} kB) {v:.2f} ms' for k, v in ms.items())} [{card}]",
          flush=True)
    lap("21a")

    # 21b: phase 19c's OPE over its val frames rewritten as TIFF and as lossless WebP
    results = {}
    for fmt, encode, magic in (("tiff", tiff_lzw, b"II*\x00"), ("webp", webp_lossless, b"RIFF")):
        root = os.path.join(work, f"formats_{fmt}")
        n = _rewrite_tree(ope["jpeg_root"], root, encode)
        ds = GOT10kDataset(root, "val")
        with open(ds[0][0][0], "rb") as fh:
            head = fh.read(4)
        if head != magic:
            raise AssertionError(f"21b: the {fmt} tree holds {head!r}")
        tracker = _fear_tracker("cuda", torch.float32)
        _zero(counters)
        ao = evaluate_tracker(tracker, ds)
        torch.cuda.synchronize()
        results[fmt] = (ao, _read(counters), n)
        launches[f"formats_ope_{fmt}"] = results[fmt][1]
        shutil.rmtree(root)
    for fmt, (ao, got, n) in results.items():
        if ao != ope["ao"] or got != ope["launches"]:
            raise AssertionError(f"21b: {fmt} AO {ao} launches {got} against .npy {ope['ao']} {ope['launches']}")
    print(f"[21b] GOT-10k OPE (FEARTracker FEAR-XS f32) over phase 19c's {len(ope['lengths'])} val sequences "
          f"({results['tiff'][2]} frames) rewritten as TIFF (LZW, predictor 2) and as lossless WebP under their .jpg "
          f"names: every result equal to the run over .npy (AO {ope['ao']['ao']:.6f}); launches "
          f"{results['tiff'][1]} and {results['webp'][1]}, = the schedule [{card}]", flush=True)
    lap("21b")

    # 21c: make_annotations over trees of each format against the same trees in JPEG
    ann = os.path.join(work, "annotations21")
    writers = {"jpg": lambda img: encode_jpeg(img, 90), "tiff": tiff_lzw, "webp": webp_lossless, "gif": gif_332}
    rows = _annotation_rows(ann, writers, 21)
    n_rows = [len(t.splitlines()) - 1 for t in rows["jpg"]]
    print(f"[21c] make_annotations over GOT-10k ({n_rows[0]} rows) and YouTube-BB ({n_rows[1]} rows, boxes scaled "
          f"by the frame size) trees of TIFF, WebP and GIF frames: rows equal to the JPEG trees', no zero frame "
          f"size [{card}]", flush=True)
    shutil.rmtree(ann)
    lap("21c")
    if "cv2" in {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}:
        raise AssertionError("phase 21 imported cv2")
    return launches


def _ytbb_tree(yt: str, frames: dict, write) -> None:
    """A YouTube-BB tree: each video's frames ({video: [frame]}) written by
    ``write`` under ``<video>_<ms>.jpg``, and its detection CSV."""
    import csv
    import os

    os.makedirs(yt, exist_ok=True)
    with open(os.path.join(yt, "yt_bb_detection_train.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        for k, (vid, imgs) in enumerate(frames.items()):
            os.makedirs(os.path.join(yt, vid), exist_ok=True)
            for t, img in enumerate(imgs):
                with open(os.path.join(yt, vid, f"{vid}_{t * 1000}.jpg"), "wb") as img_fh:
                    img_fh.write(write(img))
                w.writerow([vid, t * 1000, 7, "cat", k, "present", 0.1 + 0.05 * t, 0.6, 0.2, 0.7 + 0.05 * t])


def _annotations(ann: str, fmt: str, got_root: str, yt: str) -> list:
    """make_annotations' CSV text of a GOT-10k val tree and a YouTube-BB tree."""
    import os

    from feartracker_tpu_torch.tools import make_annotations

    made = []
    for dataset, root, subset in (("got10k", got_root, "val"), ("youtube_bb", yt, "train")):
        out = os.path.join(ann, f"{fmt}_{dataset}.csv")
        make_annotations.run(dataset, root, out, subset=subset)
        with open(out) as fh:
            made.append(fh.read())
    return made


def _check_rows(tag: str, rows: dict, base: str) -> None:
    """Raise unless every format's CSV texts equal ``base``'s and hold rows
    and no zero frame size."""
    zero = [fmt for fmt, made in rows.items() for text in made if "[0, 0]" in text]
    differ = [fmt for fmt in rows if rows[fmt] != rows[base]]
    if zero or differ or not all(len(t.splitlines()) > 1 for t in rows[base]):
        raise AssertionError(f"{tag} make_annotations: formats with a zero frame size {zero}, rows differing from "
                             f"{base}'s {differ}")


def _annotation_rows(ann: str, writers: dict, seed: int) -> dict:
    """21c and 22c: make_annotations over a generated GOT-10k val tree
    (2 x 6 frames of 128x96) and a YouTube-BB tree (two videos of 3 seeded
    frames, 160x90 and 96x120) in each of ``writers``' formats, each frame
    under its ``.jpg`` name; raises unless every format's rows equal the
    "jpg" writer's and no frame size is zero. → {format: [GOT-10k CSV text,
    YouTube-BB CSV text]}."""
    import os
    import shutil

    import numpy as np

    from feartracker_tpu_torch.tools.make_synthetic_dataset import generate

    generate(os.path.join(ann, "src"), tracks=1, frames=6, val_sequences=2, seed=seed, size=(96, 128))
    src_val = os.path.join(ann, "src", "got10k", "val")
    yt_frames = {vid: [fixture_frame(10 * seed + 3 * k + t, *size) for t in range(3)]
                 for k, (vid, size) in enumerate((("vidA", (90, 160)), ("vidB", (120, 96))))}
    rows = {}
    for fmt, write in writers.items():
        got_root = os.path.join(ann, fmt, "got10k")
        for d, _, files in os.walk(src_val):
            out = os.path.join(got_root, "val", os.path.relpath(d, src_val))
            os.makedirs(out, exist_ok=True)
            for f in files:
                if f.endswith(".npy"):
                    with open(os.path.join(out, f[:-4] + ".jpg"), "wb") as fh:
                        fh.write(write(np.load(os.path.join(d, f))))
                else:
                    shutil.copyfile(os.path.join(d, f), os.path.join(out, f))
        yt = os.path.join(ann, fmt, "ytbb")
        _ytbb_tree(yt, yt_frames, write)
        rows[fmt] = _annotations(ann, fmt, got_root, yt)
    _check_rows(f"{seed}c", rows, "jpg")
    return rows


def _phase_jp2_hdr_pam(card, counters, lap, work: str, here: str) -> dict:
    """Phase 22, cv2 blocked: the JPEG 2000, PAM, PFM, Sun raster and HDR
    fixtures against cv2's pixels and 1280x720 decode ms (22a); the GOT-10k
    OPE over the committed JPEG 2000 val tree against the CPU's recorded
    result (22b); ``make_annotations`` over trees of each format against
    the same trees in JPEG (22c). → each path's launches."""
    import os
    import shutil

    import torch

    from feartracker_tpu_torch.data.dataset import read_img
    from feartracker_tpu_torch.data.imread import imread
    from feartracker_tpu_torch.data.jpeg import encode_jpeg
    from feartracker_tpu_torch.data.sequence import GOT10kDataset
    from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker

    launches = {}
    # 22a: the fixtures against cv2's pixels, made on the CPU with cv2 and PIL
    images = os.path.join(here, *IMAGE_FIXTURES)
    with open(os.path.join(images, JP2_MANIFEST)) as fh:
        manifest = json.load(fh)["decode"]
    bad, timing = [], {}
    for c in manifest:
        path = os.path.join(images, c["file"])
        img = read_img(path)
        if list(img.shape) != c["shape"] or _sha(img.tobytes()) != c["sha256"]:
            bad.append(c["file"])
        if c["file"].startswith("timing_"):
            with open(path, "rb") as fh:
                timing[c["kind"]] = fh.read()
    frame = fixture_frame(0, 720, 1280)
    for kind, write in (("Sun raster 24-bit", sun_raster), ("PFM", pfm_rgb)):
        timing[kind] = write(frame)
        if not (imread(timing[kind]) == frame).all():
            bad.append(kind)
    if bad or len(timing) != 5:
        raise AssertionError(f"22a: {bad} differ from cv2's pixels or the frame written ({len(timing)} timing files)")
    ms = {k: _decode_p50_ms(v, imread) for k, v in timing.items()}
    print(f"[22a] data/jp2.py (+ csrc/jp2.cpp), data/hdr.py, data/imread.py's PAM, PFM and Sun raster, cv2 blocked: "
          f"{len(manifest)} fixtures equal to cv2's pixels; 1280x720 decode p50 on one core "
          f"{', '.join(f'{k} ({len(timing[k]) / 1e3:.0f} kB) {v:.2f} ms' for k, v in ms.items())} [{card}]",
          flush=True)
    lap("22a")

    # 22b: the GOT-10k protocol over the committed JPEG 2000 tree
    root = os.path.join(here, *JP2_TREE)
    with open(os.path.join(root, JP2_TREE_RECORD)) as fh:
        record = json.load(fh)
    differ = []
    for rel, digest in record["files"].items():
        with open(os.path.join(root, rel), "rb") as fh:
            data = fh.read()
        if _sha(data) != digest or (rel.endswith(".jpg") and not data.startswith(b"\x00\x00\x00\x0cjP  \r\n\x87\n")):
            differ.append(rel)
    ds = GOT10kDataset(root, "val")
    lengths = [len(ds[i][0]) for i in range(len(ds))]
    if differ or lengths != record["lengths"]:
        raise AssertionError(f"22b: the JPEG 2000 tree's files {differ} differ from its record; lengths {lengths}")
    tracker = _fear_tracker("cuda", torch.float32)
    _zero(counters)
    ao = evaluate_tracker(tracker, ds)
    torch.cuda.synchronize()
    got = _read(counters)
    want = _sequential_launches(lengths, _n_fused("fear_xs"))
    if got != want or want != {"K1": 22, "K2": 312}:
        raise AssertionError(f"22b: launches {got}, schedule {want}")
    if json.loads(json.dumps(ao)) != record["ope_cpu"]:
        raise AssertionError(f"22b: OPE over JPEG 2000 on the card AO {ao['ao']!r} against the CPU's recorded "
                             f"{record['ope_cpu']['ao']!r}")
    launches["jp2_ope"] = got
    print(f"[22b] GOT-10k OPE (FEARTracker FEAR-XS f32) over the committed JPEG 2000 val tree ({len(lengths)} x "
          f"{lengths[0]} frames of {record['frame_hw'][1]}x{record['frame_hw'][0]}, 9/7 rate {record['rate']}, "
          f"{record['bytes']} bytes, every file at its sha256): AO {ao['ao']:.6f}, SR50 {ao['sr50']:.4f}, every "
          f"result equal to the port's on the CPU; launches {got} = the schedule [{card}]", flush=True)
    lap("22b")

    # 22c: make_annotations over trees of each format against the same trees in JPEG
    _zero(counters)
    ann = os.path.join(work, "annotations22")
    writers = {"jpg": lambda img: encode_jpeg(img, 90), "pam": pam_rgb, "pfm": pfm_rgb, "hdr": hdr_flat,
               "sun": sun_raster}
    rows = _annotation_rows(ann, writers, 22)
    # JPEG 2000 (no writer here): 22b's tree and frames as they are, against JPEG encodes of their pixels
    jp2_rows = _as_is_and_as_jpeg(ann, "jp2", root, {
        vid: [os.path.join(root, "val", seq, f"{t:08d}.jpg") for t in range(3)]
        for vid, seq in (("vidA", "GOT-10k_Val_000000"), ("vidB", "GOT-10k_Val_000001"))})
    got = _read(counters)
    if got != {"K1": 0, "K2": 0}:
        raise AssertionError(f"22c: make_annotations launched {got}")
    launches["jp2_hdr_pam_annotations"] = got
    n_rows = [len(t.splitlines()) - 1 for t in rows["jpg"]]
    print(f"[22c] make_annotations over GOT-10k ({n_rows[0]} rows) and YouTube-BB ({n_rows[1]} rows) trees of PAM, "
          f"PFM, HDR and Sun raster frames, and over trees of 22b's JPEG 2000 frames "
          f"({len(jp2_rows['jp2'][0].splitlines()) - 1} and {len(jp2_rows['jp2'][1].splitlines()) - 1} rows): rows "
          f"equal to the same trees in JPEG, no zero frame size, no launch [{card}]", flush=True)
    shutil.rmtree(ann)
    lap("22c")
    if "cv2" in {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}:
        raise AssertionError("phase 22 imported cv2")
    return launches


def _phase_tiff_fax_cmyk(card, counters, lap, work: str, here: str, ope: dict) -> dict:
    """Phase 23, cv2 blocked: the CCITT, FillOrder 2, CMYK, CIELab, YCbCr and
    signed-sample TIFF fixtures against cv2's pixels and 1280x720 decode ms
    (23a); phase 19c's OPE over its val frames rewritten as CMYK TIFF (exact)
    and as YCbCr 2x2 TIFF against the CPU's recorded result (23b);
    ``make_annotations`` over trees of fax, CMYK, CIELab and YCbCr frames
    against the same trees in JPEG, the fax frames read back (23c). → each path's launches."""
    import os
    import shutil

    import numpy as np
    import torch

    from feartracker_tpu_torch.data.dataset import read_img
    from feartracker_tpu_torch.data.imread import imread
    from feartracker_tpu_torch.data.jpeg import encode_jpeg
    from feartracker_tpu_torch.data.sequence import GOT10kDataset
    from feartracker_tpu_torch.data.tiff import tiff_header
    from feartracker_tpu_torch.evaluate import got10k_eval as ge

    launches = {}
    # 23a: the fixtures against cv2's pixels, made on the CPU with cv2 and PIL
    images = os.path.join(here, *IMAGE_FIXTURES)
    with open(os.path.join(images, FAX_CMYK_MANIFEST)) as fh:
        manifest = json.load(fh)["decode"]
    bad, timing = [], {}
    for c in manifest:
        path = os.path.join(images, c["file"])
        img = read_img(path)
        if list(img.shape) != c["shape"] or _sha(img.tobytes()) != c["sha256"]:
            bad.append(c["file"])
        if c["file"].startswith("timing_"):
            with open(path, "rb") as fh:
                timing[c["kind"]] = fh.read()
    if bad or len(timing) != 5:
        raise AssertionError(f"23a: {bad} differ from cv2's pixels ({len(timing)} timing files)")
    ms = {k: _decode_p50_ms(v, imread) for k, v in timing.items()}
    print(f"[23a] data/tiff.py (+ csrc/imgcodecs.cpp tiff_fax, tiff_cielab), cv2 blocked: {len(manifest)} fixtures "
          f"equal to cv2's pixels; 1280x720 decode p50 on one core "
          f"{', '.join(f'{k} ({len(timing[k]) / 1e3:.0f} kB) {v:.2f} ms' for k, v in ms.items())} [{card}]",
          flush=True)
    lap("23a")

    # 23b: phase 19c's OPE over its val frames rewritten as CMYK TIFF and as YCbCr 2x2 TIFF
    with open(os.path.join(here, *TIFF_OPE_RECORD)) as fh:
        record = json.load(fh)
    want = _sequential_launches(ope["lengths"], _n_fused("fear_xs"))
    results = {}
    for fmt, encode in (("cmyk", tiff_cmyk), ("ycbcr", tiff_ycbcr22)):
        root = os.path.join(work, f"tiff_{fmt}")
        n = _rewrite_tree(ope["jpeg_root"], root, encode)
        ds = GOT10kDataset(root, "val")
        with open(ds[0][0][0], "rb") as fh:
            first = fh.read()
        if first[:4] != b"II*\x00" or tiff_header(first)["photometric"] != {"cmyk": 5, "ycbcr": 6}[fmt]:
            raise AssertionError(f"23b: the {fmt} tree holds {first[:4]!r}")
        differ = []
        if fmt == "ycbcr":
            for rel, digest in record["files"].items():
                with open(os.path.join(root, rel), "rb") as fh:
                    if _sha(fh.read()) != digest:
                        differ.append(rel)
        if differ:
            raise AssertionError(f"23b: the YCbCr tree's files {differ} differ from the CPU's record")
        tracker = _fear_tracker("cuda", torch.float32)
        _zero(counters)
        overlaps, names, precision, boxes = [], [], [], []
        for i in range(len(ds)):  # evaluate_tracker's loop, the boxes kept
            files, anno, _ = ds[i]
            m = min(len(files), len(anno))
            preds, _ = ge.run_sequence(tracker, files, anno[0], m)
            gt = np.asarray(anno[1:m], np.float64)
            overlaps.append(ge._overlap(preds[1:], gt))
            precision.append(ge.precision_stats(preds[1:], gt))
            names.append(ds.sequence_name(i))
            boxes.append(np.asarray(preds, np.float64))
        torch.cuda.synchronize()
        got = _read(counters)
        results[fmt] = (ge.summarize(overlaps, names, precision), boxes, got, n)
        launches[f"tiff_{fmt}_ope"] = got
        shutil.rmtree(root)
    ao, _, got, n = results["cmyk"]
    if ao != ope["ao"] or got != ope["launches"] or got != want or want != {"K1": 22, "K2": 312}:
        raise AssertionError(f"23b(i): CMYK AO {ao['ao']!r} launches {got} against .npy {ope['ao']['ao']!r} "
                             f"{ope['launches']}, schedule {want}")
    ao_y, boxes_y, got_y, _ = results["ycbcr"]
    px = max(float(np.abs(b - np.asarray(r)).max()) for b, r in zip(boxes_y, record["boxes_cpu"]))
    d_ao = abs(ao_y["ao"] - record["ope_cpu"]["ao"])
    if got_y != want or px > YCBCR_OPE_PX or d_ao > YCBCR_OPE_AO or len(boxes_y) != len(record["boxes_cpu"]):
        raise AssertionError(f"23b(ii): YCbCr boxes {px} px, AO {ao_y['ao']!r} against the CPU's "
                             f"{record['ope_cpu']['ao']!r}; launches {got_y}, schedule {want}")
    print(f"[23b] GOT-10k OPE (FEARTracker FEAR-XS f32) over phase 19c's {len(ope['lengths'])} val sequences ({n} "
          f"frames) rewritten under their .jpg names (i) as 8-bit CMYK TIFF (K = 0, LZW): every result equal to the "
          f"run over .npy (AO {ao['ao']:.6f}), launches {got}; (ii) as uncompressed YCbCr 2x2 TIFF (lossy, every "
          f"file at the CPU record's sha256): AO {ao_y['ao']:.6f} against the CPU's {record['ope_cpu']['ao']:.6f} "
          f"(|d| {d_ao:.2e} <= {YCBCR_OPE_AO}), boxes within {px:.2e} px (<= {YCBCR_OPE_PX}) of the CPU's, launches "
          f"{got_y}; each = the schedule [{card}]", flush=True)
    lap("23b")

    # 23c: make_annotations over trees of each layout against the same trees in JPEG
    _zero(counters)
    ann = os.path.join(work, "annotations23")
    writers = {"jpg": lambda img: encode_jpeg(img, 90), "fax": tiff_fax_mh, "cmyk": tiff_cmyk, "lab": tiff_lab,
               "ycbcr": tiff_ycbcr22}
    rows = _annotation_rows(ann, writers, 23)
    got = _read(counters)
    if got != {"K1": 0, "K2": 0}:
        raise AssertionError(f"23c: make_annotations launched {got}")
    # the fax tree's GOT-10k frames read back: each the threshold of its source frame
    src_val, n_fax = os.path.join(ann, "src", "got10k", "val"), 0
    for d, _, files in os.walk(src_val):
        for f in files:
            if f.endswith(".npy"):
                black = np.load(os.path.join(d, f)).astype(np.int32).sum(axis=2) < 3 * 128
                path = os.path.join(ann, "fax", "got10k", "val", os.path.relpath(d, src_val), f[:-4] + ".jpg")
                if not np.array_equal(read_img(path), np.repeat(np.where(black, 0, 255)[..., None], 3, 2)):
                    raise AssertionError(f"23c: {path} is not its frame's threshold")
                n_fax += 1
    if not n_fax:
        raise AssertionError("23c: the fax tree holds no frame")
    launches["tiff_fax_cmyk_annotations"] = got
    n_rows = [len(t.splitlines()) - 1 for t in rows["jpg"]]
    print(f"[23c] make_annotations over GOT-10k ({n_rows[0]} rows) and YouTube-BB ({n_rows[1]} rows) trees of CCITT "
          f"Modified Huffman, CMYK, CIELab and YCbCr 2x2 TIFF frames: rows equal to the JPEG trees', no zero frame "
          f"size, no launch; the {n_fax} Modified Huffman GOT-10k frames read back equal to their thresholds "
          f"[{card}]", flush=True)
    shutil.rmtree(ann)
    lap("23c")
    if "cv2" in {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}:
        raise AssertionError("phase 23 imported cv2")
    return launches


def _as_is_and_as_jpeg(ann: str, tag: str, got_root: str, yt_frames: dict) -> dict:
    """make_annotations over a GOT-10k val tree and a YouTube-BB tree whose
    frames are files as they are (``yt_frames``: {video: [path]}), and over
    the same trees with each frame written as JPEG of its pixels; raises
    unless the rows are equal and no frame size is zero. → {format: [GOT-10k
    CSV text, YouTube-BB CSV text]}."""
    import os

    from feartracker_tpu_torch.data.imread import imread
    from feartracker_tpu_torch.data.jpeg import encode_jpeg

    jpg = f"{tag}_as_jpg"
    jpg_root = os.path.join(ann, jpg, "got10k")
    _rewrite_tree(got_root, jpg_root, lambda img: encode_jpeg(img, 90))
    for fmt, write in ((tag, lambda path: open(path, "rb").read()), (jpg, lambda path: encode_jpeg(imread(path), 90))):
        _ytbb_tree(os.path.join(ann, fmt, "ytbb"), yt_frames, write)
    rows = {tag: _annotations(ann, tag, got_root, os.path.join(ann, tag, "ytbb")),
            jpg: _annotations(ann, jpg, jpg_root, os.path.join(ann, jpg, "ytbb"))}
    _check_rows(f"{tag}", rows, jpg)
    return rows


def _phase_webp_parts_jp2_modes(card, counters, lap, work: str, here: str) -> dict:
    """Phase 24, cv2 blocked: the multi-partition VP8 WebP and JPEG 2000
    coding-mode fixtures against cv2's pixels and 1280x720 decode ms (24a);
    the GOT-10k OPE over the committed tree of phase 19c's val sequences as
    4-partition lossy WebP against the CPU's recorded result (24b);
    ``make_annotations`` over trees of those WebP frames and of the JPEG 2000
    mode fixtures against the same trees in JPEG (24c). → each path's
    launches."""
    import os
    import shutil

    import numpy as np
    import torch

    from feartracker_tpu_torch.data.dataset import read_img
    from feartracker_tpu_torch.data.imread import imread
    from feartracker_tpu_torch.data.sequence import GOT10kDataset
    from feartracker_tpu_torch.evaluate import got10k_eval as ge

    launches = {}
    # 24a: the fixtures against cv2's pixels, made on the CPU with cv2 and pillow.libs' libwebp and OpenJPEG
    images = os.path.join(here, *IMAGE_FIXTURES)
    with open(os.path.join(images, WEBP_PARTS_JP2_MANIFEST)) as fh:
        manifest = json.load(fh)["decode"]
    bad, timing = [], {}
    for c in manifest:
        path = os.path.join(images, c["file"])
        img = read_img(path)
        if list(img.shape) != c["shape"] or _sha(img.tobytes()) != c["sha256"]:
            bad.append(c["file"])
        if c["file"].startswith("timing_"):
            with open(path, "rb") as fh:
                timing[c["kind"]] = fh.read()
    if bad or len(timing) != 2:
        raise AssertionError(f"24a: {bad} differ from cv2's pixels ({len(timing)} timing files)")
    ms = {k: _decode_p50_ms(v, imread) for k, v in timing.items()}
    print(f"[24a] data/webp.py + csrc/webp.cpp (2, 4 and 8 token partitions) and data/jp2.py + csrc/jp2.cpp (the six "
          f"code-block styles, ROI, POC, SOP/EPH, tile-parts in every progression), cv2 blocked: {len(manifest)} "
          f"fixtures equal to cv2's pixels; 1280x720 decode p50 of {HOST_CODEC_REPS} on one core "
          f"{', '.join(f'{k} ({len(timing[k]) / 1e3:.0f} kB) {v:.2f} ms' for k, v in ms.items())} [{card}]",
          flush=True)
    lap("24a")

    # 24b: the GOT-10k protocol over the committed 4-partition WebP tree
    root = os.path.join(here, *WEBP_TREE)
    with open(os.path.join(root, WEBP_TREE_RECORD)) as fh:
        record = json.load(fh)
    differ = []
    for rel, digest in record["files"].items():
        with open(os.path.join(root, rel), "rb") as fh:
            data = fh.read()
        if _sha(data) != digest or (rel.endswith(".jpg") and data[8:16] != b"WEBPVP8 "):
            differ.append(rel)
    ds = GOT10kDataset(root, "val")
    lengths = [len(ds[i][0]) for i in range(len(ds))]
    if differ or lengths != record["lengths"]:
        raise AssertionError(f"24b: the WebP tree's files {differ} differ from its record; lengths {lengths}")
    tracker = _fear_tracker("cuda", torch.float32)
    _zero(counters)
    overlaps, names, precision, boxes = [], [], [], []
    for i in range(len(ds)):  # evaluate_tracker's loop, the boxes kept
        files, anno, _ = ds[i]
        m = min(len(files), len(anno))
        preds, _ = ge.run_sequence(tracker, files, anno[0], m)
        gt = np.asarray(anno[1:m], np.float64)
        overlaps.append(ge._overlap(preds[1:], gt))
        precision.append(ge.precision_stats(preds[1:], gt))
        names.append(ds.sequence_name(i))
        boxes.append(np.asarray(preds, np.float64))
    torch.cuda.synchronize()
    got = _read(counters)
    ao = ge.summarize(overlaps, names, precision)
    want = _sequential_launches(lengths, _n_fused("fear_xs"))
    px = max(float(np.abs(b - np.asarray(r)).max()) for b, r in zip(boxes, record["boxes_cpu"]))
    d_ao = abs(ao["ao"] - record["ope_cpu"]["ao"])
    if got != want or want != {"K1": 22, "K2": 312} or len(boxes) != len(record["boxes_cpu"]):
        raise AssertionError(f"24b: launches {got}, schedule {want}")
    if px > WEBP_OPE_PX or d_ao > WEBP_OPE_AO:
        raise AssertionError(f"24b: WebP boxes {px} px, AO {ao['ao']!r} against the CPU's {record['ope_cpu']['ao']!r}")
    launches["webp_parts_ope"] = got
    print(f"[24b] GOT-10k OPE (FEARTracker FEAR-XS f32) over the committed tree of phase 19c's {len(lengths)} val "
          f"sequences ({sum(lengths)} frames of {record['frame_hw'][1]}x{record['frame_hw'][0]}) as lossy WebP with "
          f"{record['partitions']} token partitions (libwebp q{record['quality']:g}, {record['bytes']} bytes, every file "
          f"at its sha256): AO {ao['ao']:.6f} against the CPU's {record['ope_cpu']['ao']:.6f} (|d| {d_ao:.2e} <= "
          f"{WEBP_OPE_AO}), boxes within {px:.2e} px (<= {WEBP_OPE_PX}) of the CPU's; launches {got} = the schedule "
          f"[{card}]", flush=True)
    lap("24b")

    # 24c: make_annotations over trees of the WebP frames and of the JPEG 2000
    # mode fixtures (no writer of either here: the files as they are), against
    # the same trees in JPEG
    _zero(counters)
    ann = os.path.join(work, "annotations24")
    seqs = sorted(d for d in os.listdir(os.path.join(root, "val")) if os.path.isdir(os.path.join(root, "val", d)))
    webp_rows = _as_is_and_as_jpeg(ann, "webp", root, {
        vid: [os.path.join(root, "val", seq, f"{t:08d}.jpg") for t in range(3)] for vid, seq in zip(("vidA", "vidB"), seqs)})
    modes = [os.path.join(images, c["file"]) for c in manifest if c["file"].startswith("jp2_")]
    jp2_root = os.path.join(ann, "jp2_modes_src", "got10k")
    k = 0
    for d, _, files in os.walk(os.path.join(root, "val")):
        out = os.path.join(jp2_root, os.path.relpath(d, root))
        os.makedirs(out, exist_ok=True)
        for f in sorted(files):
            if f.endswith(".jpg"):  # each frame one of the mode fixtures, in turn
                shutil.copyfile(modes[k % len(modes)], os.path.join(out, f))
                k += 1
            else:
                shutil.copyfile(os.path.join(d, f), os.path.join(out, f))
    jp2_rows = _as_is_and_as_jpeg(ann, "jp2_modes", jp2_root, {"vidA": modes[:4], "vidB": modes[4:9]})
    got = _read(counters)
    if got != {"K1": 0, "K2": 0}:
        raise AssertionError(f"24c: make_annotations launched {got}")
    launches["webp_parts_jp2_modes_annotations"] = got
    n_rows = {t: [len(x.splitlines()) - 1 for x in r[t]] for t, r in (("webp", webp_rows), ("jp2_modes", jp2_rows))}
    print(f"[24c] make_annotations over GOT-10k and YouTube-BB trees of 24b's 4-partition WebP frames ({n_rows['webp']} "
          f"rows) and of the JPEG 2000 mode fixtures ({n_rows['jp2_modes']} rows): rows equal to the same trees in "
          f"JPEG, no zero frame size, no launch [{card}]", flush=True)
    shutil.rmtree(ann)
    lap("24c")
    if "cv2" in {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}:
        raise AssertionError("phase 24 imported cv2")
    return launches


def _phase_video(card, counters, lap, work: str) -> dict:
    """Phase 20d: the demo over an mp4 that the host's cv2 writes (mp4v),
    with an mp4 out, against ``FEARTracker`` over the frames cv2 decodes from
    it. → its launches."""
    import contextlib
    import io
    import os

    import cv2
    import numpy as np
    import torch

    from feartracker_tpu_torch import demo
    from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS
    from feartracker_tpu_torch.utils.video import read_video, video_fps, write_video

    frames, boxes = _render_clip(20, VIDEO_FRAMES)
    clip, out = os.path.join(work, "clip.mp4"), os.path.join(work, "tracked.mp4")
    write_video(clip, list(frames), fps=30.0)
    decoded = read_video(clip)
    if decoded.shape != np.asarray(frames).shape or video_fps(clip) != 30.0:
        raise AssertionError(f"20d: wrote {np.asarray(frames).shape}, read back {decoded.shape} at "
                             f"{video_fps(clip)} fps")
    drift = np.abs(decoded.astype(int) - np.asarray(frames, int)).mean()
    box = [int(v) for v in boxes[0]]
    want = _track_clip(_fear_tracker("cuda", torch.float32), list(decoded), np.array(box))[0][-1]
    argv = ["--device", "cuda", "--weights_path", PACKAGED_FEAR_XS, "--video_path", clip, "--output_path", out,
            "--initial_bbox", *map(str, box)]
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        demo.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = _read(counters)
    final = [line for line in printed.getvalue().splitlines() if line.startswith("final bbox")]
    tracked = read_video(out)
    n = VIDEO_FRAMES
    nf = _n_fused("fear_xs")
    want_final = list(map(int, want))
    if (got != {"K1": n - 1, "K2": nf * n} or final != [f"final bbox: {want_final}"]
            or tracked.shape != decoded.shape):
        raise AssertionError(f"20d: launches {got}, printed {final} against {want_final}, out {tracked.shape}")
    print(f"[20d] demo --device cuda over a {n}-frame {decoded.shape[2]}x{decoded.shape[1]} mp4 written by the "
          f"host's cv2 {cv2.__version__} (mp4v, FFMPEG; mean |decoded - rendered| {drift:.2f} grey levels), mp4 out "
          f"({tracked.shape[0]} frames read back): final bbox {final[0].split(': ')[1]} == FEARTracker's over the "
          f"decoded frames; launches {got}; {seconds:.1f} s [{card}]", flush=True)
    lap("20d")
    return {"demo_mp4": got}


def _phase_trace_ops(card, lap, trace_dir: str) -> None:
    """Phase 20e: phase 5c's trace through ``tools/parse_trace.py``: the top
    ten aten ops by device ms, with their input shapes and merged by name
    (the rows of no aten op named by kernel); both whole tables go to
    ``<trace_dir>/parse_trace.txt``."""
    import collections
    import os

    from feartracker_tpu_torch.tools.parse_trace import format_tables, load_trace, summarize

    sm = summarize(load_trace(os.path.join(trace_dir, "trace.json")))
    mapped = sum(ms for label, ms in sm["by_op"] if not label.startswith("(no aten op)"))
    if not sm["rows"] or not mapped:
        raise AssertionError(f"20e: {sm['rows']} device rows, {mapped} ms of them linked to an aten op")
    with open(os.path.join(trace_dir, "parse_trace.txt"), "w") as fh:
        fh.write(format_tables(sm, top=10**6) + "\n")
    by_name = collections.Counter()
    for label, ms in sm["by_op"]:
        by_name[label if label.startswith("(no aten op)") else label.split(" ")[0]] += ms
    total = sm["total_ms"]

    def row(label, ms):
        return f"{label} {ms:.2f} ms ({100 * ms / total:.1f}%)"

    print(f"[20e] phase 5c's trace by aten op (tools/parse_trace.py; whole tables in {trace_dir}/parse_trace.txt): "
          f"{total:.2f} ms device time in {sm['rows']} rows, {mapped:.2f} ms ({100 * mapped / total:.1f}%) launched "
          f"inside an aten op; top 10 by op and input shapes: " + "; ".join(row(*r) for r in sm["by_op"][:10])
          + "; top 10 by op: " + "; ".join(row(*r) for r in by_name.most_common(10))
          + "; top 5 by kernel: " + "; ".join(row(*r) for r in sm["by_kernel"][:5]) + f" [{card}]", flush=True)
    lap("20e")


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False  # cuDNN convs run TF32 by default
    torch.backends.cuda.matmul.allow_tf32 = False
    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, device_line, synthetic_streams
    from feartracker_tpu_torch.evaluate.profiling import ir_block_bound, time_ms
    from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK, TRUNKS, IRBlockSpec
    from feartracker_tpu_torch.ops.cuda import build as kbuild
    from feartracker_tpu_torch.ops.cuda.crop import crop_cuda
    from feartracker_tpu_torch.ops.cuda.decode import postprocess_cuda
    from feartracker_tpu_torch.ops.cuda.ir_block import (_fused_ir_block, bf16_smem_bytes, f32_smem_bytes,
                                                     fused_ir_block, ir_block_op_cuda, kernel_smem_bytes,
                                                     plan_tile, tiles_that_fit)
    from feartracker_tpu_torch.ops.fused_trunk import plain_ir_block

    def k2_smem(spec, cin, tile):
        return bf16_smem_bytes(spec.kernel, spec.stride, cin, spec.out_channels, tile)

    # wall seconds per phase, printed before the kernels line
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - last[0], 1)
        last[0] = now

    dev = torch.device("cuda")
    card = device_line(dev)
    print(f"[1] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # -- 2: build: nvcc of the CUDA kernels beside g++ of the host codecs ------
    from concurrent.futures import ThreadPoolExecutor

    from feartracker_tpu_torch.data import jpeg as host_codecs

    t0 = time.perf_counter()
    host_sources = sorted((host_codecs.PACKAGE_DIR / "csrc").glob("*.cpp"))
    with ThreadPoolExecutor(len(host_sources)) as pool:
        host_builds = [pool.submit(host_codecs.build, src) for src in host_sources]
        kbuild.load_library()
        cuda_s = time.perf_counter() - t0
        for b in host_builds:
            b.result()
    print(f"[2] built {[p.name for p in kbuild.sources()]} in {cuda_s:.1f} s and, at the same time, "
          f"{[p.name for p in host_sources]} with g++: {time.perf_counter() - t0:.1f} s in all", flush=True)
    for line in (kbuild.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[2]   " + line.strip())
    lap("1-2")

    # -- 3: K1 against its plain twins ----------------------------------------
    k1_err = _phase_k1(card, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    lap("3")
    k3_times = _phase_k3(card, dev)
    lap("3b")

    # -- 4: K2 against plain_ir_block -------------------------------------------
    tol = {torch.float32: 1e-4, torch.bfloat16: 0.15}
    k2_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checked = 0
    # FEAR-XS at S=8; the family trunks at S=2 add ragged chunks (Ce=108),
    # padded widths (Cin=36) and Cout up to 224. bfloat16 at every tile that
    # takes the shape, its shared memory as the wrapper's planner counts it;
    # float32 also at S=1, each at the planner's chunk groups, at 1 and at
    # one chunk a group, its shared memory as the Python count has it
    lib = kbuild.load_library()
    for name, streams in (("fear_xs", 8), ("fear_m", 2), ("fear_l", 2)):
        for crop in (256, 128):
            for i, spec, cin, h in _block_shapes(TRUNKS[name], crop):
                if spec.expansion == 1:
                    continue
                k, s, cout = spec.kernel, spec.stride, spec.out_channels
                chunks = -(-cin * spec.expansion // 32)
                bf16_tiles = tiles_that_fit(k, s, cin, cout)
                if not bf16_tiles:
                    raise AssertionError(f"K2 {name} block{i}: no bfloat16 tile takes Cin={cin} {spec}")
                if lib.fear_ir_block_smem_bytes(k, s, cin, cout, 0, 8, 8) != f32_smem_bytes(k, s, cin, cout):
                    raise AssertionError(f"K2 {name} block{i} f32: kernel and Python count different shared memory")
                runs = [(torch.bfloat16, streams, tile, None) for tile in bf16_tiles]
                runs += [(torch.float32, n, None, g) for n in (streams, 1) for g in (None, 1, chunks)]
                blks = {dt: _random_block(gen, cin, spec, dt, dev) for dt in tol}
                for dt, n, tile, groups in runs:
                    blk = blks[dt]
                    x = torch.randn(n, h, h, cin, generator=gen, device=dev).to(dt)
                    ref = plain_ir_block(x, blk, spec).float()
                    if tile and lib.fear_ir_block_smem_bytes(k, s, cin, cout, 1, *tile) != k2_smem(spec, cin, tile):
                        raise AssertionError(f"K2 {name} block{i} tile {tile}: kernel and planner count "
                                             f"different shared memory")
                    got = _fused_ir_block(x, blk, spec, True, False, tile, groups).float()
                    torch.cuda.synchronize()
                    err = (got - ref).abs().max().item()
                    if not err <= tol[dt]:
                        raise AssertionError(f"K2 {name} block{i} crop {crop} {dt} S={n} tile {tile} groups "
                                             f"{groups}: max|err| {err} > {tol[dt]}")
                    k2_err[dt] = max(k2_err[dt], err)
                    n_checked += 1
            print(f"[4] K2 {name} crop {crop}: every block with expansion > 1 ok (bf16 S={streams} at every "
                  f"tile that fits; f32 S={streams} and S=1 at the planner's chunk groups, 1 and one chunk a "
                  f"group)", flush=True)
    # widths that are not whole 16-byte rows (every family width is a
    # multiple of 4): both kernels' element-by-element staging
    for cin, spec in ((18, IRBlockSpec(3, 3, 1, 18)), (22, IRBlockSpec(2, 5, 2, 30))):
        runs = [(torch.bfloat16, None, t) for t in tiles_that_fit(spec.kernel, spec.stride, cin, spec.out_channels)]
        runs += [(torch.float32, g, None) for g in (None, 1, -(-cin * spec.expansion // 32))]
        for dt, groups, tile in runs:
            blk = _random_block(gen, cin, spec, dt, dev)
            x = torch.randn(2, 16, 16, cin, generator=gen, device=dev).to(dt)
            err = (_fused_ir_block(x, blk, spec, True, False, tile, groups).float()
                   - plain_ir_block(x, blk, spec).float()).abs().max().item()
            if not err <= tol[dt]:
                raise AssertionError(f"K2 ragged Cin={cin} {spec} {dt} tile {tile} groups {groups}: max|err| {err}")
            k2_err[dt] = max(k2_err[dt], err)
            n_checked += 1
    print("[4] K2 ragged widths (Cin 18 and 22, Ce 54 and 44, Cout 18 and 30) ok in both dtypes", flush=True)
    print(f"[4] K2 {n_checked} checks: max|err| f32 {k2_err[torch.float32]:.3e} (atol 1e-4), "
          f"bf16 {k2_err[torch.bfloat16]:.3e} (atol 0.15)", flush=True)
    lap("4")

    # -- 5a: the slice, f32 on the card against the port on the CPU ------------
    n_fused = sum(s.expansion > 1 for s in FEAR_XS_TRUNK)
    f0, chunk, boxes = synthetic_streams(4, 8, seed=0, device="cpu")
    results = {}
    for device in ("cuda", "cpu"):
        tracker, prov = build_scan_tracker(dtype=torch.float32, device=device)
        if prov != "fear_xs":
            raise AssertionError(f"weights provenance {prov!r}, expected fear_xs")
        state = tracker.init(f0, boxes)
        _, out = tracker.track(state, chunk)
        results[device] = {k: v.cpu() for k, v in out.items()}
    box_err = (results["cuda"]["bbox"] - results["cpu"]["bbox"]).abs().max().item()
    conf_err = (results["cuda"]["confidence"] - results["cpu"]["confidence"]).abs().max().item()
    if not (box_err <= 1.0 and conf_err <= 1e-3):
        raise AssertionError(f"slice f32 cuda vs cpu: bbox {box_err} px, confidence {conf_err}")
    print(f"[5] slice f32 S=4 T=8 cuda vs cpu: bbox max|err| {box_err} px (<= 1), "
          f"confidence {conf_err:.2e} (<= 1e-3)", flush=True)

    # -- 5b: the main path, bf16, S=128, T=16 ----------------------------------
    S, T = 128, 16
    tracker, _ = build_scan_tracker(dtype=torch.bfloat16, device="cuda")
    f0, chunk, boxes = synthetic_streams(S, T, seed=1, device="cuda")
    torch.cuda.synchronize()
    postprocess_cuda.launches = 0
    fused_ir_block.launches = 0
    crop_cuda.launches = 0
    ir_block_op_cuda.calls = 0
    state = tracker.init(f0, boxes)
    k2_init = fused_ir_block.launches
    state, out = tracker.track(state, chunk)
    torch.cuda.synchronize()
    launches = {"K1": postprocess_cuda.launches, "K2": fused_ir_block.launches, "K3": crop_cuda.launches}
    if k2_init != n_fused or launches != {"K1": T, "K2": n_fused * (T + 1), "K3": T + 1}:
        raise AssertionError(f"launch counts {launches} (init K2 {k2_init}); expected K1 {T}, "
                             f"K2 {n_fused} at init + {n_fused}*{T}, K3 1 at init + {T}")
    if ir_block_op_cuda.calls:
        raise AssertionError(f"the main path called K2's operator {ir_block_op_cuda.calls} times; it calls the wrapper")
    for k, v in out.items():
        if v.shape[:2] != (T, S):
            raise AssertionError(f"output {k}: shape {tuple(v.shape)}")
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"output {k} has non-finite values")
    for _ in range(2):
        state, out = tracker.track(state, chunk)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        state, out = tracker.track(state, chunk)
    torch.cuda.synchronize()
    track_ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"[5] slice bf16 S={S} T={T}: launches {launches} over init + 1 track; finite outputs; "
          f"{track_ms:.2f} ms/track, {S * T / track_ms * 1e3:.1f} frames/s [{card}]", flush=True)
    br = _trace_breakdown(lambda: tracker.track(state, chunk), TRACE_5C)
    if br:
        print(f"[5c] one traced track call, S={S} T={T} bf16: device busy {br['busy_ms']:.2f} of {br['span_ms']:.2f} "
              f"ms (idle {100 * br['idle']:.1f}% under the profiler), {br['kernels']} kernels/copies, "
              f"{br['kernels'] / T:.1f} kernels per frame; K2 {br['K2']:.2f} ms ({100 * br['K2'] / br['busy_ms']:.1f}%), K1 {br['K1']:.3f}, "
              f"K3 {br['K3']:.3f}, GEMMs "
              f"{br['gemm']:.2f}, convolutions {br['conv']:.2f}, other {br['other']:.2f} ms [{card}]", flush=True)
    else:
        print("[5c] the trace holds no device rows: breakdown not measured", flush=True)
    lap("5")

    # -- 6: kernels beside their plain twins at the main path's shapes ---------
    k1 = _k1_times(tracker.config.postprocess, 128, torch.bfloat16, dev)
    launch_floor_ms = k1["floor_ms"]
    print(f"[6] K1 S=128: " + _k1_line(k1) + f" [{card}]", flush=True)
    # K2 at S=128 bf16 at the search (256²) and template (128²) shapes: held
    # against its plain twin with fan-in-scaled weights (phase 4's bf16
    # tolerance), then timed with the packaged weights beside its bound
    k2_ms, k2_plain, k2_terms, k2_bound, k2_s128_err, k2_tiles = {}, {}, {}, {}, 0.0, {}
    for crop, what in ((256, "search"), (128, "template")):
        k2_ms[crop] = k2_plain[crop] = 0.0
        k2_terms[crop] = {"bytes": 0.0, "products": 0.0, "depthwise": 0.0}
        for i, spec, cin, h in _block_shapes(FEAR_XS_TRUNK, crop):
            if spec.expansion == 1:
                continue
            x = torch.randn(128, h, h, cin, generator=gen, device=dev).to(torch.bfloat16)
            rnd = _random_block(gen, cin, spec, torch.bfloat16, dev)
            err = (fused_ir_block(x, rnd, spec).float() - plain_ir_block(x, rnd, spec).float()).abs().max().item()
            if not err <= tol[torch.bfloat16]:
                raise AssertionError(f"K2 block{i} crop {crop} S=128 bf16: max|err| {err} > {tol[torch.bfloat16]}")
            k2_s128_err = max(k2_s128_err, err)
            blk = tracker.folded["blocks"][i]
            real = fused_ir_block(x, blk, spec).float()
            real_ref = plain_ir_block(x, blk, spec).float()
            real_err, real_mag = (real - real_ref).abs().max().item(), real_ref.abs().max().item()
            km = time_ms(lambda: fused_ir_block(x, blk, spec))
            pm = time_ms(lambda: plain_ir_block(x, blk, spec))
            bound, by, terms = ir_block_bound(128, h, cin, spec)
            ho = h // spec.stride
            tile = plan_tile(128, ho, ho, cin, spec.out_channels, spec, kernel_smem_bytes)
            occ = lib.fear_ir_block_occupancy(spec.kernel, spec.stride, cin, spec.out_channels, 1, *tile)
            # the planner's choice against every tile that fits
            sweep = {f"{t[0]}x{t[1]}": time_ms(lambda: _fused_ir_block(x, blk, spec, True, False, t))
                     for t in tiles_that_fit(spec.kernel, spec.stride, cin, spec.out_channels)}
            k2_tiles[f"{crop}_block{i}"] = f"{tile[0]}x{tile[1]}"
            k2_ms[crop] += km
            k2_plain[crop] += pm
            for key in terms:
                k2_terms[crop][key] += terms[key]
            print(f"[6] K2 block{i:2d} x (128,{h},{h},{cin}) bf16 {spec}: max|err| {err:.3e} (atol 0.15); "
                  f"packaged weights max|err| {real_err:.3e} of max|out| {real_mag:.3e}; "
                  f"kernel {km:.3f} ms, plain {pm:.3f} ms; bound {bound:.4f} ms by {by} (bytes "
                  f"{terms['bytes']:.4f}, products {terms['products']:.4f}, depthwise {terms['depthwise']:.4f}), "
                  f"kernel at {100 * bound / km:.1f}% of it; tile {tile[0]}x{tile[1]}, "
                  f"{128 * -(-ho // tile[0]) * -(-ho // tile[1])} blocks, {occ} per SM; every tile (ms) "
                  f"{', '.join(f'{t} {v:.4f}' for t, v in sweep.items())}", flush=True)
        by = max(k2_terms[crop], key=k2_terms[crop].get)
        k2_bound[crop] = k2_terms[crop][by]
        print(f"[6] K2 sum over {n_fused} blocks, {what} crop, S=128 bf16: kernel {k2_ms[crop]:.3f} ms, "
              f"plain {k2_plain[crop]:.3f} ms ({k2_ms[crop] / k2_plain[crop]:.3f}x), bound {k2_bound[crop]:.4f} ms "
              f"by {by} (the larger of the summed terms "
              f"{', '.join(f'{k} {v:.4f}' for k, v in k2_terms[crop].items())}) "
              f"(kernel at {100 * k2_bound[crop] / k2_ms[crop]:.1f}%) [{card}]", flush=True)
    print(f"[6] K2 S=128 bf16, {2 * n_fused} block shapes: max|err| {k2_s128_err:.3e} (atol 0.15)", flush=True)
    lap("6")

    # -- 7, 8: the dual-template path and the slot server -----------------
    counters = {"K1": postprocess_cuda, "K2": fused_ir_block}
    # the benchmark's paths also count K3, the crop
    dual_launches, dual_tracker = _phase_dual(card, n_fused, {**counters, "K3": crop_cuda})
    lap("7")
    pool_launches = _phase_pool(card, n_fused, {**counters, "K3": crop_cuda}, dual_tracker)
    lap("8")
    seq_launches, s1_times, seq_ms, card9, host9 = _phase_sequential(card, n_fused, counters, gen)
    _phase_bf16(card, card9, host9)
    print(f"[9] sequential vs batched: FEARTracker update p50 {seq_ms['float32']:.3f} ms f32, "
          f"{seq_ms['bfloat16']:.3f} ms bf16 = {1e3 / seq_ms['bfloat16']:.1f} frames/s; ScanTracker S={S} "
          f"T={T} bf16 {S * T / track_ms * 1e3:.1f} frames/s [{card}]", flush=True)
    lap("9")
    graph_launches = _phase_graphs(card, n_fused, counters, tracker, dual_tracker, lap)
    deploy_launches, dispatch_us, host12a = _phase_deployment(card, n_fused, counters, lap)
    with tempfile.TemporaryDirectory() as work:
        train_launches, profile, staged = _phase_train(card, counters, lap, work, host12a)
        step_alone_ms = next(r["step_ms"] for r in profile if r["batch"] == 32)
        loop_launches, loop_val = _phase_loop(card, counters, lap, step_alone_ms)
        parallel_launches = _phase_parallel(card, counters, lap, staged, step_alone_ms, loop_val, track_ms)
        tool_launches = _phase_tools(card, counters, lap, work, {"ms": k2_ms[256], "plain_ms": k2_plain[256]})
        scenario_launches = _phase_scenarios(card, counters, lap, work)
        driver_launches = _phase_drivers(card, counters, lap, work)
        orbax_launches = _phase_orbax(card, counters, lap, work)
        host_launches = _phase_host_io(card, counters, lap, work, TRACE_5C)
    print(f"[time] wall seconds per phase {laps}, {sum(laps.values()):.1f} s in all; the whole script "
          f"{time.perf_counter() - t_script:.1f} s", flush=True)
    # the graphed static path: one track call of the K=16 graphs (10a)
    by_path = {"static": launches, "dual": dual_launches, **pool_launches, **seq_launches,
               "static_scan_unroll_16": graph_launches, **deploy_launches, **train_launches, **loop_launches,
               **parallel_launches, **tool_launches, **scenario_launches, **driver_launches, **orbax_launches,
               **host_launches}

    def count(k):
        # launches: the static main path's; each other path's own count beside it
        return {"launches": launches[k], "launches_by_path": {name: p[k] for name, p in by_path.items() if k in p}}

    kernels = [
        {"name": "K1 fused decode region", "route": "cuda", "source": "feartracker_tpu_torch/csrc/decode.cu",
         "replaces": "feartracker_tpu/ops/pallas/decode.py:27", **count("K1"),
         "max_abs_err": k1_err, "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "floor_ms": launch_floor_ms,
         "postprocess_ms": k1["postprocess_ms"], "postprocess_plain_ms": k1["postprocess_plain_ms"],
         "postprocess_bound_ms": k1["postprocess_bound_ms"], "s1": s1_times["K1"]},
        {"name": "K2 fused inverted-residual block", "route": "cuda",
         "source": "feartracker_tpu_torch/csrc/ir_block.cu",
         "replaces": "feartracker_tpu/ops/pallas/ir_block.py:131", **count("K2"),
         "max_abs_err": k2_err[torch.bfloat16], "max_abs_err_f32": k2_err[torch.float32],
         "ms": k2_ms[256], "plain_ms": k2_plain[256],
         "bound_ms": k2_bound[256], "library_ms": None, "tile": k2_tiles,
         "bound_by": "bytes" if k2_terms[256]["bytes"] == k2_bound[256] else "operations",
         "s1": s1_times["K2"], "op_dispatch_us": dispatch_us},
        {"name": "K3 crop, pad, normalize and cast", "route": "cuda", "source": "feartracker_tpu_torch/csrc/crop.cu",
         "replaces": None, "counterpart": "feartracker_tpu.native.crop_resize_normalize (the JAX package's host crop)",
         **count("K3"), "max_abs_err": 0.0, "ms": k3_times[256]["ms"], "plain_ms": k3_times[256]["plain_ms"],
         "bound_ms": k3_times[256]["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "mm_ms": k3_times[256]["mm_ms"], "gather_ms": k3_times[256]["gather_ms"], "template": k3_times[128]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(_dp_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if sys.argv[1:2] == ["--host-refs"]:
        sys.exit(_host_refs_main(*sys.argv[2:5]))
    sys.exit(main())

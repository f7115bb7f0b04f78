#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``q3d_tpu_torch``) end to end on one card.

    python3 chip_smoke.py

Phases, one JSON line each (plus the card line from nvidia-smi):
  1. card     — name/power limit (nvidia-smi) and the torch / CUDA versions;
  2. build    — nvcc builds the kernels from ``q3d_tpu_torch/csrc`` (one
                process per source, started together);
  3. kernels  — each CUDA kernel held against its plain PyTorch version at
                the main path's real shapes: the sparse gather-conv on the
                rulebooks of all 21 backbone convs of the first
                centerpoint_ref batch-2 request (f32 and bf16 within stated
                tolerances, s8 with out_scale/out_valid bit-exact), per
                conv and summed per (Cin, Cout, K) group; greedy NMS in
                both forms: the IoU form's keep masks exactly equal on that
                request's 6 IoU matrices and on random K = 128 / 1024 /
                2048 ones; the boxes form's keep masks exactly equal on
                that request's 6 candidate sets and on random crowded boxes
                (K = 128 / 1024, thresh 0.2 / 0.5 / 0.9), its IoU bit-equal
                to boxes_iou_bev at every pair it evaluated and the plain
                IoU exactly 0 at every needed pair it skipped.  Median
                CUDA-event times of each kernel, its plain version and the
                nearest library call; for NMS also candidate_iou (the old
                path's IoU matrix) and each bound's bytes, operations and
                latency terms;
  4. serving  — CenterPoint at centerpoint_ref (full width, seeded random
                weights, BN statistics calibrated on the first request),
                batch 2, bf16 inputs, 4 requests covering the dataset's 8
                frames; per request the host time (scene + voxelize) and
                the device forward, and the valid detections.  Kernel
                launch counts are zeroed just before and read just after;
  5. stages   — CUDA-event time of each stage of one bf16 forward (VFE,
                sparse backbone, BEV map, 2D backbone, head convs, decode +
                NMS, and the head's decode and NMS apart), median of 5;
  6. model    — one request in f32 with TF32 off and cuDNN deterministic
                (as in phase 3 and the BN calibration; the timed bf16
                phases 4-5 run with PyTorch's own settings), through the
                kernels and through the plain versions: BEV maps, every
                head map and the final detections compared; NMS keep masks
                (both forms) and the head's final detections on identical
                candidates must be equal;
  7. int8    — the int8 deploy path under the JAX package's bench recipe
                (every sparse and BEV conv int8 with residency, the head
                bf16), calibrated (method "max") on the first request:
                ``kernel_conv_s8_requant``: each of the 21 residency convs'
                fused s8 entry on its real int8 input and book, bit-equal
                to its plain version, timed beside the unfused s8 entry +
                torch epilogue, the plain version, gather + ``_int_mm``
                and its bound; ``int8_conv2d``: each of the 12 BEV convs'
                ``_int_mm`` s32 equal to the exact product, timed beside
                cuDNN's bf16 conv; ``serving_int8``: 4 requests (launch
                counts zeroed before, read after: 84 fused, 48 ``_int_mm``)
                and bf16 / int8 forwards in turns; ``stages_int8``: the
                stage split of both; ``forward_trace``: device operations
                per forward and the card's busy and idle share, bf16 and
                int8 (torch.profiler); ``model_int8``: bench and entry recipes,
                one request through the kernels and the plain versions:
                every int8 map, spatial_features and detections equal;
  8. eval_gates / eval_plain — the four gates of
                tests/test_accuracy_regression.py on the card: the trained
                centerpoint_tiny fixture (read without JAX), 16 test frames
                at batch 2, f32 with TF32 off; fp32, int8 deploy (full and
                head float), dynamic SmoothQuant and static entropy,
                calibrated as the test does, each through ``eval_one_epoch``
                on the kernels (launch counts zeroed before, read after;
                both kernels must have launched) and on the plain versions
                (no launch): NDS, mAP, relative drop, infer_time_ms; fp32
                NDS > 0.4 and mAP > 0.3, drops <= 1% / 1% / 2% / 3%; the
                per-frame detections of the two runs compared (int8: equal;
                fp32 and fake-quant: as sets, see FQ_*);
  9. fakequant_ref — centerpoint_ref under dynamic SmoothQuant and static
                entropy (calibrated on the first request), f32, one forward
                through the kernels and the plain versions: every map and
                the detections compared; forward and stage times; the 12
                BEV SmoothQuant convs (im2col + fake-quant + matmul) beside
                cuDNN's bf16 conv;
 10. deploy_int8 / kernel_conv_s8 — centerpoint_ref under the int8 deploy
                recipes without residency: ``int8_deploy_recipe()``
                (dynamic), ``(sq=True)`` and ``(static=True)`` (calibrated
                on the first request given twice, entropy amax): launches of
                one forward per entry, held to the recipe's layer counts;
                kernels vs plain on the f32 request (every int8 map,
                spatial_features and the detections equal); int8 and bf16
                forwards in turns; device operations (``forward_trace``).
                Then kernel 1's unfused s8 entry on the dynamic recipe's
                real inputs, bit-equal to plain, beside its plain version,
                gather + ``_int_mm`` and its bound;
 11. driver_tiny — the port's PTQ driver on the trained tiny fixture with
                ``--deploy_int8`` and ``--deploy_int8 --no_sq``: fp32 NDS
                equal to eval_gates', the quantized scores within the JAX
                package's bound (mean |fp - q| < 0.05), NDS / mAP / drop;
                eval_plain also names the first layer where a float run
                differs between kernels and plain versions;
 12. SECOND and PointPillars at KITTI width — each KITTI config's MODEL
                as written (tools/cfgs/kitti_models/), on SyntheticDataset
                scenes at the config's own geometry (range, voxel size,
                points per voxel, the 40,000-voxel test cap; ~120,000
                points a sweep, cropped to the front camera's FOV as the
                dataset yaml's FOV_POINTS_ONLY asks): ``data_<model>``
                (points, voxels and labelled objects per frame; the cap
                must not bind), ``serving_<model>`` (4 bf16 requests of batch 2,
                seeded weights, conv_cls's prior bias 0, BN calibrated on
                the first request; launches: SECOND 48 kernel-1 and 4
                boxes-form NMS launches at K = 4096, PointPillars 0 and 4),
                ``stages_<model>``, ``model_<model>`` (the f32 request
                through the kernels and the plain versions: maps, keep
                masks on identical candidates, detections); then
                ``kernel_conv`` on SECOND's 12 convs, ``kernel_nms`` at K =
                2049 / 4096 (random IoU matrices and crowded boxes at
                thresh 0.01 / 0.5, both models' real candidate sets, times
                and bounds at K = 4096 with every candidate valid, with the
                validity conv_cls's prior bias gives and with the first 512
                valid) and ``recipes_kitti`` (SECOND under
                ``second_recipe()``, PointPillars under
                ``pointpillar_recipe()``, SECOND under
                ``int8_deploy_recipe()``: kernels vs plain);
 13. training (``q3d_tpu_torch.train_utils``), f32:
                ``train_grad`` (centerpoint_ref, batch 2, seeded weights,
                TF32 off: one training forward and backward through the
                kernels and through the plain versions on the first
                request: loss within 1e-5 relative, every gradient within
                1e-4 of its tensor's largest |g|, BN statistics within
                1e-5; kernel 1 launched 21 times forward and 20 times as
                the input gradient; peak memory), ``kernel_dx`` (each of
                those 20 input gradients: kernel 1 over the inverse book
                against its plain version, within 1e-5 of the largest |dX|,
                timed beside it, gather + ``torch.matmul``, the bound, the
                weight gradient's torch time and the inverse book's
                build), ``qat_tiny`` (the trained tiny fixture under
                ``centerpoint_recipe()``, 4 QAT steps; the first through
                the kernels and the plain versions, held as the CPU test
                holds QAT), ``train_tiny`` (8 Adam steps from the seeded
                init on one batch: the loss falls by at least 10%) and
                ``train_ref`` (``train_model`` at ref width, 2 epochs of
                the 8 frames, centerpoint_tiny's OPTIMIZATION; per step
                host ms, forward / backward / optimizer device ms, dX
                kernel and dW ms, peak memory; launches counted over the
                run; resumed from its checkpoint into a fresh model, whose
                model and optimizer state must equal the trained ones);
 14. SECOND and PointPillars training at the KITTI configs' width
                (``kitti_synthetic.kitti_config``: training frames at each
                yaml's geometry, FOV-cropped, the 16,000-voxel train cap,
                batch 4 as BATCH_SIZE_PER_GPU): ``train_kitti_grad`` (one
                batch without augmentation, f32, TF32 off: one step through
                the kernels and through the plain versions at
                ``TRAIN_TOL``; SECOND 12 kernel-1 launches forward and 11 as
                dX, PointPillars none), ``train_overfit`` (8 Adam steps of
                each seeded model on that batch: the last loss below 0.9 x
                the first), ``kernel_fwd_second`` / ``kernel_dx_second``
                (SECOND's 12 conv forwards and 11 input gradients of that
                step, each held against its plain version and timed beside
                it, gather + ``torch.matmul`` and its bound),
                ``qat_kitti`` (one step under ``second_recipe()`` /
                ``pointpillar_recipe()``, each launch held on its own
                operands and the whole step at ``QAT_TOL``) and
                ``train_kitti`` (``train_model``, 8 frames, 2 epochs, each
                yaml's OPTIMIZATION and its whole
                DATA_AUGMENTOR, gt_sampling reading a database written to a
                temporary directory from frames of another seed: per step
                host / forward / backward / optimizer ms and peak memory,
                objects placed per frame, positive anchors per class per
                frame; launches: SECOND 23 a step, PointPillars none, no
                NMS);
 15. VoxelNeXt inference (the nuScenes config's MODEL and CLASS_NAMES
                as written, on centerpoint_ref's scenes, batch 2, seeded
                weights, BN statistics from the first request):
                ``kernel_conv_voxelnext`` (kernel 1 on the 32 convs of one
                forward, 30 3D books and 2 2D ones over 3 x 2 x 160,000
                rows, against the plain versions in f32 / bf16 / s8, timed
                beside gather + ``torch.matmul`` and the bound; the 3D
                stages, conv5/conv6 and the 2D convs summed apart),
                ``serving_voxelnext`` (4 bf16 requests: 32 kernel-1
                launches, one kernel-2 launch of 12 candidate sets and 72
                pointwise 1x1 products each), ``stages_voxelnext``,
                ``model_voxelnext`` (f32, TF32 off, kernels vs plain: the
                encoded rows, every branch map, kernel 2 on identical
                candidates, the detections), ``kernel_nms_voxelnext``
                (kernel 2's boxes form on that forward's 12 candidate sets
                against its plain version, timed, its bound),
                ``recipes_voxelnext``
                (``voxelnext_recipe()``, ``int8_deploy_recipe()`` and int8
                residency calibrated on the first request: launches per
                recipe, each launch held against its plain version on its
                own operands, kernels vs plain end to end) and
                ``tta_voxelnext`` (double flip at tiny width, kernels vs
                plain);
 16. TransFusion-LiDAR inference (the nuScenes config's MODEL and
                CLASS_NAMES as written, on centerpoint_ref's scenes, batch 2,
                seeded weights, BN statistics from the first request):
                ``kernel_conv_transfusion`` (kernel 1 on the 21 convs of one
                forward, over 2 x 160,000 rows: no stage sets an output
                capacity, against the plain versions in f32 / bf16 / s8,
                timed beside gather + ``torch.matmul`` and the bound),
                ``serving_transfusion`` (4 bf16 requests: 21 kernel-1
                launches each and none of kernel 2, the head has no NMS;
                device forward and host time apart),
                ``stages_transfusion`` (vfe, backbone_3d, map_to_bev,
                backbone_2d, then the head: shared conv + heatmap, peak
                pool + top-K, the queries, the position embeddings,
                self-attention, cross-attention over the 180 x 180 cells,
                FFN, prediction head + decode), ``model_transfusion`` (f32,
                TF32 off, kernels vs plain: every map within 1e-4 of its
                scale, the top-K equal, the 200 queries' labels and valid
                flags equal) and ``recipes_transfusion``
                (``transfusion_recipe()`` and its static form calibrated on
                the first two requests: each launch held against its plain
                version on its own operands);
 17. TransFusion-LiDAR and VoxelNeXt training (``nuscenes_training``; each
                nuScenes config's MODEL on training frames of
                centerpoint_ref's scenes, f32; TransFusion at batch 2 over
                8 frames, VoxelNeXt at batch 1 over 4, since its batch-2
                step does not fit in 80 GB): ``train_grad_<model>`` (one
                step through the kernels and through the plain versions at
                ``TRAIN_TOL``; kernel-1 launches forward and dX, VoxelNeXt's
                2 dX over 2D inverse books apart; TransFusion's Hungarian
                assignment equal in both runs; peak memory),
                ``kernel_fwd_<model>`` / ``kernel_dx_<model>`` (each launch
                of that step against its plain version, timed beside it,
                gather + ``torch.matmul``, the bound and dW in torch;
                VoxelNeXt's 3D and 2D books apart), ``qat_<model>`` (one
                QAT step under ``transfusion_recipe()`` /
                ``voxelnext_recipe()`` at ``QAT_TOL``, each launch held on
                its operands), ``train_tiny_<model>`` (8 Adam steps of the
                tiny config: the loss falls by at least 10%) and
                ``train_<model>`` (``train_model``, 8 steps, the yaml's
                OPTIMIZATION, timed as ``train_ref``);
 18. SECOND-MultiHead at the Lyft config's width (``lyft_phases``;
                ``lyft_models/cbgs_second_multihead.yaml``'s MODEL as
                written: VoxelResBackBone8x, BaseBEVBackbone [5, 5],
                AnchorHeadMulti's five towers over 9 classes, the
                multi-class NMS; on SyntheticDataset scenes at the Lyft
                dataset yaml's geometry, ``datasets/lyft_synthetic.py``:
                +-80 m at 0.1 x 0.1 x 0.2 m, five point features with a
                zero timestamp, 52.9-54k voxels of the 60,000 cap, 720,000
                anchors a frame; seeded weights, every tower's conv_cls bias
                0): ``data_lyft`` (voxels against the cap and the 40,000
                floor, objects present), ``kernel_conv`` for its 21 convs,
                ``serving_lyft`` (4 bf16 requests: 21 kernel-1 launches and
                one boxes-form launch of 18 candidate sets at K = 1024 each;
                host ms apart from device ms), ``stages_lyft``,
                ``model_lyft`` (f32, TF32 off, kernels vs plain: maps, kernel
                2 on identical candidates in both forms, post_processing on
                identical inputs, detections end to end within the maps'
                tolerance carried through the decode), ``kernel_nms_lyft``
                (the boxes form on those 18 sets, and the IoU form on the
                same sets' axis-aligned IoU as ``nms_normal_bev`` runs it,
                against plain, timed, bounds), ``recipes_lyft``
                (``second_recipe()``, ``int8_deploy_recipe()``, the
                residency deploy: each launch held on its own operands, the
                int8 forms equal end to end), ``train_grad_lyft``,
                ``kernel_fwd_lyft`` / ``kernel_dx_lyft``, ``qat_lyft``,
                ``train_tiny_lyft`` (``lyft_synthetic.small_config``: the
                loss falls by at least 10% in 8 steps) and ``train_lyft``
                (``train_model`` at the yaml's batch 4, 16 frames, 2 epochs,
                its OPTIMIZATION and DATA_AUGMENTOR);
 19. PillarNet at the nuScenes width (``pillarnet_phases``;
                ``q3d_tpu_torch/cfgs/nuscenes_models/
                cbgs_pillar0075_res2d_centerpoint.yaml``: DynamicPillarVFE,
                PillarRes18BackBone8x's 19 sparse 2D convs, four of them 256
                x 256 and the strided 128 -> 256 on kernel 1's 256-channel
                instances, the dense conv5, BaseBEVBackboneV1 [5, 5],
                CenterHead's six heads; on centerpoint_ref's scenes with the
                raw points collated, 1440 x 1440 pillars of 0.075 m, seeded
                weights): ``data_pillarnet`` (points and pillars a frame,
                none dropped by MAX_RAW_POINTS or MAX_PILLARS),
                ``kernel_conv`` for the 19 convs and
                ``kernel_conv_pillarnet_256``, ``serving_pillarnet`` (4 bf16
                requests: 19 kernel-1 launches and one boxes-form NMS launch
                each; the raw points stay f32, the VFE's output is bf16),
                ``stages_pillarnet`` (vfe, the sparse 2D backbone, conv5,
                backbone_2d, head convs, decode + NMS), ``model_pillarnet``
                (f32, kernels vs plain), ``kernel_nms_pillarnet``,
                ``recipes_pillarnet`` (``int8_deploy_recipe()``: 19 s8
                sparse launches, the dense convs through ``_int_mm``, each
                launch on its operands, maps and detections equal),
                ``train_grad_pillarnet`` (19 forward and 19 dX launches: the
                first conv's input carries the VFE's gradient),
                ``kernel_fwd_pillarnet`` / ``kernel_dx_pillarnet`` and
                ``train_pillarnet`` (``train_model``, 8 steps at batch 2);
 20. ``dynvoxel_ref`` — centerpoint_ref's MODEL with DynamicVoxelVFE
                (NUM_FILTERS [16, 16], MAX_VOXELS 160,000), then with
                DynamicMeanVFE, one f32 request each, kernels vs plain;
 21. PV-RCNN, Voxel R-CNN, PartA2 and SECOND-IoU at the KITTI width
                (``two_stage_phases``; the port's
                ``q3d_tpu_torch/cfgs/kitti_models/pv_rcnn.yaml``,
                ``voxel_rcnn_car.yaml``, ``PartA2.yaml`` and
                ``second_iou.yaml`` on the FOV-cropped KITTI scenes of
                phase 12, batch 2, seeded weights, conv_cls's bias 0,
                the anchor head's conv_box and the ROI head's reg_out
                scaled by 1e-2 (``seed_like_trained``: rois and boxes at
                their anchors' size), BN statistics from the first
                request): ``data_pvrcnn`` (raw
                points a frame against MAX_RAW_POINTS, voxels against the
                40,000 cap: none dropped), ``kernel_conv`` for each model's
                12 convs (PartA2: UNetV2's 19, and
                ``kernel_conv_parta2_inverse``: its 3 inverse convs apart,
                each book equal to the transpose of its strided conv's and
                to the rule), ``serving_<model>`` (4 bf16 requests: 12 (19)
                kernel-1 launches and one kernel-2 launch of 2 candidate
                sets of K = 1024 a forward, the proposal layer's; the
                launches inside PartA2's inverse convs read around them;
                host ms apart from device ms), ``stages_<model>``
                (``two_stage_stage_times``: VFE, sparse backbone (UNetV2's
                decoder apart), BEV map, 2D backbone, RPN head, the
                proposal layer, FPS apart, each source's regrouping, ball
                query, MLP + pool and grouping, the fusion, the point head,
                the ROI pooling (``roiaware_pool3d``, the BEV sample), FCs
                and decode; the forward's peak memory), ``model_<model>``
                (f32, TF32 off, kernels vs plain: spatial features equal,
                the rois the same keep set, detections matched at 1e-3 /
                1e-4), ``kernel_nms_<model>`` (kernel 2 on the proposal
                sets against plain, timed, its bound) and
                ``recipes_<model>`` for PV-RCNN, PartA2 and SECOND-IoU
                (``int8_deploy_recipe()``: every launch held on its own
                operands, maps and rois equal, detections equal, or matched
                after PartA2's float inverse convs); then their training
                (``two_stage_training``: kernel 2 on the training proposal
                layer, one step kernels vs plain, kernel 1's forward and dX
                launches on its operands, ``train_model`` for 8 steps at
                the yaml's batch with its DATA_AUGMENTOR, the forward and
                dX launches inside PartA2's inverse convs read around
                them);
 22. the real-dataset entry points (``dataset_phases``, in a temporary
                directory; no dataset is in the repository, so each tree is
                written in its dataset's on-disk format from seeded synthetic
                scenes, then read back only through the port's entry
                points, on the configs as written with DATA_PATH set):
                ``data_kitti_tree`` (``kitti_synthetic.write_kitti_tree``:
                8 val frames, SECOND's phases' scenes, and 8 train frames of
                another seed; ``create_infos kitti --with_gt_database``;
                each val frame's FOV crop in ``KittiDataset`` equal to
                ``kitti_scene``'s but for points within 1e-3 px of the image
                edge, counted), ``eval_kitti_second`` (``tools/test.py`` on
                ``kitti_models/second.yaml`` with a seeded checkpoint, f32
                on the kernels with ``--save_to_file``, f32 on the plain
                versions, bf16: launches 12 + 1 a forward, kernels vs plain
                slot for slot and the same AP dict, one result file a frame
                equal to its annos to 4 decimals; the gt boxes as
                detections, through their result files, at the AP_R40
                ceiling of every class and difficulty),
                ``eval_kitti_parta2`` (``tools/test.py`` on the port's
                ``kitti_models/PartA2.yaml``, f32, kernels and plain: 19 +
                1 launches a forward, slot for slot, the same AP dict),
                ``train_kitti_tree``
                (``tools/train.py``, 2 epochs at batch 4: 4 steps, gt
                sampling from the written database; host and CUDA-event ms,
                peak memory), ``data_nuscenes_tree``
                (``nuscenes_synthetic.write_nuscenes_tree``: 8 val and 8
                train frames of 10 sweeps, 5 point features; points and
                voxels a frame under the 160,000 cap, the loader's host ms;
                the train gt database), ``eval_nuscenes_centerpoint``
                (``tools/test.py`` on ``cbgs_voxel0075_res3d_centerpoint.
                yaml``, batch 2, ``--bf16`` and ``--quant int8``: 21 + 1
                launches a forward; the first batch through the kernels and
                the plain versions slot for slot; gt as detections mAP 1;
                the stages at 10 sweeps) and ``train_nuscenes_tree``
                (``tools/train.py`` at batch 4 with CBGS and gt sampling,
                stopped after 2 steps);
 23. the ``kernels`` line, then ``{"ok": true, "device": ...}`` last.

Any failed check raises and exits nonzero without the last line.  Without
CUDA, or outside a checkout of the repo, it exits 1 and prints no result.
``USE_APPROX_TOPK`` in the config is ignored: the port's top-K is exact.
"""

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CFG = ROOT / "tools" / "cfgs" / "synthetic_models" / "centerpoint_ref.yaml"
BATCH = 2
REQUESTS = 4
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "s8": 1979e12}
# f32 operations of one rotated BEV IoU and of one circle test, counted from
# the formula in q3d_tpu_torch/csrc/greedy_nms.cu
IOU_OPS, IOU_CIRCLE_OPS = 821, 8
# the int8 recipe the JAX package's bench times (bench.py:281)
BENCH_RECIPE = dict(quantize_first_conv=True, extra_no_list=("dense_head.*",))
# the accuracy gates: tests/test_accuracy_regression.py's trained fixture
TINY_CFG = ROOT / "tools" / "cfgs" / "synthetic_models" / "centerpoint_tiny.yaml"
CKPT = ROOT / "tests" / "fixtures" / "centerpoint_tiny_trained.pkl"
# recipe -> the largest relative NDS drop against fp32 it may show
GATES = {"fp32": None, "int8_full": 0.01, "int8_head_bf16": 0.01,
         "sq_dynamic": 0.02, "static_entropy": 0.03}
# float fake-quant: kernel and plain versions sum in another order, which
# moves the odd value across a rounding boundary of the next fake-quant (one
# step of 1/127 of its amax), and a flipped rounding can move a detection
# near a decision (the score threshold, an NMS overlap) in or out; the
# detections are held as sets: at least FQ_MATCH_SHARE of those scoring at
# least FQ_MIN_SCORE have a partner of the same frame and label within
# FQ_BOX_TOL (m) and FQ_SCORE_TOL, the valid counts differ by at most
# FQ_COUNT_SHARE of the larger, and the NDS by at most FQ_NDS_TOL
FQ_MIN_SCORE, FQ_BOX_TOL, FQ_SCORE_TOL = 0.15, 0.1, 0.02
FQ_MATCH_SHARE, FQ_COUNT_SHARE, FQ_NDS_TOL = 0.99, 0.05, 1e-3
# fake-quant at centerpoint_ref: each map, kernels vs plain, within this
# share of max(1, its largest magnitude) (flipped roundings, one step each)
FQ_MAP_RTOL = 5e-2
CONV_DESIGN = ("128-row x all-Cout tiles; book loaded once, ballot tap masks; "
               "16-byte cp.async gathers into a 2-3 stage ring; mma.sync "
               "m16n8k16 bf16 / m16n8k32 s8 (f32 on CUDA cores)")

# per forward: kernel 1's launches (SECOND's 12 sparse convs; PointPillars
# has none) and the sparse convs under int8_deploy_recipe() (conv_input
# stays float)
KITTI_CONVS = {"second": 12, "pointpillar": 0}
# the least voxels (pillars) a frame keeps, by model
KITTI_MIN_VOXELS = {"second": 16000, "pointpillar": 9000}
# the KITTI phases' maps, kernels vs plain, in f32 (TF32 off): kernel 1's
# f32 entry sums in the plain order at these widths, so the maps agree to
# rounding, under the fake-quant recipes too (a flipped fake-quant rounding
# would be 1/127 of the scale)
KITTI_MAP_RTOL = 1e-4
# kernel 2 past 32 mask words a row: the first such K, and the largest
WIDE_K = (2049, 4096)


def emit(tag, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps=10, flush=None):
    """Median CUDA-event time of ``fn`` in ms; ``flush`` (run outside the
    timed region before each rep) evicts the 50 MB L2.  A ~100 us spin
    kernel ahead of the first event keeps the card busy while the host
    enqueues ``fn``, so that a short launch is timed on the device and not
    by the host's Python around it."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_device_us(fn, names, flush, reps=10):
    """Mean device time in us of each CUDA kernel whose name contains one of
    ``names``, per call of ``fn`` (torch.profiler; L2 flushed before each
    call) -> {name: us}, or "not measured" if the trace has no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        for n in names:
            if n in ev.key and us > 0:
                out[n] = out.get(n, 0.0) + us / reps
    return out or "not measured"


def forward_trace(model, batch, reps=3):
    """Device operations (kernels, copies, fills) per forward of ``model``
    on ``batch``, the card's busy time per forward (their summed device
    time; one stream, so they do not overlap) against the host clock around
    the forwards, the idle share, and the ten operations with the most
    device time -> dict, or "not measured" if the trace has no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model(dict(batch))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(dict(batch))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0.0) > 0]
    if not evs:
        return "not measured"
    busy_ms = sum(e.device_time_total for e in evs) / 1e3 / reps
    top = sorted(evs, key=lambda e: -e.device_time_total)[:10]
    return {"device_ops": sum(e.count for e in evs) / reps,
            "device_busy_ms": busy_ms, "traced_forward_ms": wall_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "top_ops": [{"op": e.key[:120], "per_forward": e.count / reps,
                         "ms": e.device_time_total / 1e3 / reps}
                        for e in top]}


def stage_times(model, batch, reps=5, extra=None):
    """CUDA-event time of each stage of one forward of ``model`` on
    ``batch``, median of ``reps`` -> {stage: ms}; ``extra`` adds stages by
    name -> module (PillarNet's conv5, inside its backbone_3d).  Decode and
    NMS are methods, not modules (CenterHead's ``_decode`` / ``_nms``; an
    anchor head's ``generate_predicted_boxes`` and the detector's
    ``post_processing``), so they are timed through instance attributes
    that shadow them for the run.  AnchorHeadMulti's head convs are its
    shared conv and towers; putting the towers' maps into the anchor
    order counts in ``dense_head`` only."""
    import torch
    head = model.dense_head
    stages = {"vfe": model.vfe}
    if hasattr(model, "backbone_3d"):
        stages["backbone_3d"] = model.backbone_3d
    if hasattr(model, "map_to_bev_module"):
        stages["map_to_bev"] = model.map_to_bev_module
    stages["backbone_2d"] = model.backbone_2d
    stages.update(extra or {})
    if hasattr(head, "heads_list"):                 # CenterHead
        stages["head_convs"] = [head.shared_conv, head.shared_requant,
                                *head.heads_list]
        methods = ((head, "_decode", "decode"), (head, "_nms", "nms"))
    else:                           # AnchorHeadSingle, AnchorHeadMulti
        stages["head_convs"] = [head.shared_conv, *head.heads] \
            if hasattr(head, "heads") else [
                c for c in (head.conv_cls, head.conv_box, head.conv_dir_cls)
                if c is not None]
        methods = ((head, "generate_predicted_boxes", "decode"),
                   (model, "post_processing", "nms"))
    stages["dense_head"] = head
    events = {name: [] for name in (*stages, "decode", "nms")}

    def mark(name, at):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append((at, ev))
        return hook
    hooks = []
    for name, mods in stages.items():
        for mod in (mods if isinstance(mods, list) else [mods]):
            hooks += [mod.register_forward_pre_hook(mark(name, 0)),
                      mod.register_forward_hook(mark(name, 1))]

    def timed(name, fn):
        def run(*args):
            mark(name, 0)()
            out = fn(*args)
            mark(name, 1)()
            return out
        return run
    for owner, attr, name in methods:
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    stage_ms = {name: [] for name in events}
    try:
        with torch.no_grad():
            for _ in range(reps):
                for evs in events.values():
                    evs.clear()
                model(dict(batch))
                torch.cuda.synchronize()
                for name, evs in events.items():
                    starts = [e for at, e in evs if at == 0]
                    ends = [e for at, e in evs if at == 1]
                    stage_ms[name].append(sum(a.elapsed_time(b)
                                              for a, b in zip(starts, ends)))
    finally:
        for h in hooks:
            h.remove()
        for owner, attr, _ in methods:
            delattr(owner, attr)
    stage_ms = {k: statistics.median(v) for k, v in stage_ms.items()}
    # CenterHead decodes and runs NMS inside the head; an anchor detector
    # decodes in the head and runs NMS after it
    stage_ms["decode_nms"] = stage_ms["dense_head"] - stage_ms["head_convs"] \
        if hasattr(head, "heads_list") else stage_ms["decode"] + stage_ms["nms"]
    return stage_ms


def plain_scene(ds, j):
    """Frame ``j`` of the synthetic dataset ``ds`` as its ``__getitem__``
    makes it -> (points, gt_boxes, gt_names)."""
    import numpy as np
    from q3d_tpu_torch.datasets.synthetic_dataset import make_scene
    return make_scene(np.random.RandomState(ds.base_seed + j),
                      ds.point_cloud_range, **ds.scene_kwargs)


def make_request(ds, r, scene=plain_scene):
    """Frames BATCH*r ... BATCH*r + BATCH-1 of the synthetic dataset ``ds``,
    each from ``scene(ds, j)`` -> (numpy batch, scene ms, voxelize ms):
    host time, scene synthesis and the data pipeline apart."""
    frames, scene_ms, vox_ms = [], 0.0, 0.0
    for j in range(r * BATCH, (r + 1) * BATCH):
        t0 = time.perf_counter()
        points, boxes, names = scene(ds, j)[:3]
        t1 = time.perf_counter()
        frames.append(ds.prepare_data({"points": points, "gt_boxes": boxes,
                                       "gt_names": names, "frame_id": j}))
        t2 = time.perf_counter()
        scene_ms += (t1 - t0) * 1e3
        vox_ms += (t2 - t1) * 1e3
    return ds.collate_batch(frames), scene_ms, vox_ms


def check_boxes_form(boxes, valid, th, what):
    """The boxes form against its plain version (the IoU of the needed
    pairs as boxes_iou_bev computes it, ``greedy_nms.needed_pair_iou``,
    then the plain sweep): keep masks equal; the kernel's IoU bit-equal at
    every pair it evaluated; every needed pair (j < i, both valid) it
    skipped has a plain IoU of exactly 0.  -> (pairs evaluated, pairs
    needed, the most pairs evaluated in one 64 x 64 tile)."""
    import torch
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    dev = boxes.device
    s_, k_ = valid.shape
    corners, areas = nms_mod.bev_corners_areas(boxes)
    iou_k = torch.full((s_, k_, k_), float("nan"), device=dev)
    keep_k = nms_mod.greedy_suppress_boxes_cuda(corners, areas, valid, th,
                                                iou_out=iou_k)
    iou_p = nms_mod.needed_pair_iou(boxes, valid)
    keep_p = nms_mod.greedy_suppress_plain(iou_p, valid, th)
    diff = (keep_k != keep_p).nonzero()
    check(len(diff) == 0, f"greedy_nms_boxes {what} thresh={th}: "
                          f"{len(diff)} keep flags differ, first (set, "
                          f"row) {diff[:1].tolist()}")
    need = valid[:, :, None] & valid[:, None, :] & torch.ones(
        (k_, k_), dtype=torch.bool, device=dev).triu(1)
    done = ~torch.isnan(iou_k)
    stray = (done & ~need).nonzero()
    check(len(stray) == 0, f"greedy_nms_boxes {what}: evaluated pairs "
                           f"outside j < i, both valid: {stray[:3].tolist()}")
    for bad, why in (
            (done & (iou_k.view(torch.int32) != iou_p.view(torch.int32)),
             "kernel IoU != plain IoU"),
            (need & ~done & (iou_p != 0), "skipped pair has plain IoU != 0")):
        at = bad.nonzero()
        if len(at):
            s0, j0, i0 = at[0].tolist()
            check(False, f"greedy_nms_boxes {what} thresh={th}: {len(at)} "
                         f"pairs: {why}; first set {s0} (j={j0}, i={i0}): "
                         f"kernel {float(iou_k[s0, j0, i0])!r}, plain "
                         f"{float(iou_p[s0, j0, i0])!r}")
    kt = -(-k_ // 64)
    tiles = torch.nn.functional.pad(
        done, (0, 64 * kt - k_, 0, 64 * kt - k_)).reshape(
        s_, kt, 64, kt, 64).sum((2, 4))
    return int(done.sum()), int(need.sum()), int(tiles.max())



def record_sparse_convs(model, batch):
    """One forward of ``model`` on ``batch`` with every call of kernel 1 (a
    sparse conv with a book; a 1x1 SubM conv has none) recorded in order ->
    ([(name, features, book, weight, row mask)], the forward's outputs)."""
    import torch
    from q3d_tpu_torch.ops.spconv.modules import (SparseInverseConv3d,
                                                  _SparseConv,
                                                  _SparseConvBase,
                                                  inverse_cache_key,
                                                  subm_cache_key,
                                                  down_cache_key)
    convs = []
    names = {m: n for n, m in model.named_modules()}

    def record(mod, args, out):
        st, cache = args[0], args[1]
        if mod.pointwise:
            return
        if isinstance(mod, SparseInverseConv3d):
            target, cache = args[1], args[2]
            idx = cache[inverse_cache_key(target.spatial_shape,
                                          mod.kernel_size, mod.stride,
                                          mod.padding)][0]
            valid = target.valid
        elif isinstance(mod, _SparseConv):
            key = down_cache_key(st.spatial_shape, mod.kernel_size, mod.stride,
                                 mod.padding, args[2] if len(args) > 2 else None)
            out_indices, idx, _ = cache[key]
            valid = out_indices[:, 0] >= 0
        else:
            key = subm_cache_key(mod.indice_key or "", st.spatial_shape,
                                 mod.kernel_size, mod.dilation)
            idx, valid = cache[key], st.valid
        convs.append((names[mod], st.features, idx, mod.weight.detach(), valid))
    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, _SparseConvBase)]
    try:
        with torch.no_grad():
            out = model(dict(batch))
    finally:
        for h in hooks:
            h.remove()
    return convs, out


def quant_sym(x, axis=None):
    """Symmetric int8 with per-tensor (axis None) or per-last-axis scale."""
    import torch
    amax = x.abs().amax() if axis is None else x.abs().amax(
        dim=tuple(range(x.dim() - 1)))
    s = (amax / 127.0).clamp(min=1e-8)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def kernel_conv(convs, flush, mode, label):
    """Phase ``kernel_conv`` for the recorded convs of one forward of model
    ``label``: kernel 1 against its plain version in f32, bf16 and s8 on
    each conv's real features, book and weights (f32 and bf16 within the
    stated tolerances, s8 bit-exact), timed beside its plain version,
    gather + ``torch.matmul`` / ``torch._int_mm`` and its bound; per conv,
    per (Cin, Cout, K) group and in total -> (bf16 totals, worst errors,
    the per-conv rows)."""
    import torch
    from q3d_tpu_torch.ops.spconv import gather_conv
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bytes_ms", "ops_ms")}
    worst = {"f32": 0.0, "bf16": 0.0, "s8": 0.0}
    by_width = {}                    # (Cin, Cout, K) -> summed times
    under_library = {"bf16": 0, "s8": 0}   # convs at or under the library
    rows = []
    with torch.no_grad():
        for name, feats, idx, w32, valid in convs:
            n, cin = feats.shape
            m, k = idx.shape
            cout = w32.shape[2]
            present = (idx >= 0) & (idx < n)
            n_present = int(present.sum())
            rows_read = int(torch.unique(idx[present]).numel())
            row = {"model": label, "conv": name, "N": n, "M": m, "K": k,
                   "Cin": cin, "Cout": cout, "present_taps": n_present}
            for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                f, w = feats.to(dt).contiguous(), w32.to(dt).contiguous()
                vk = gather_conv.sparse_gather_conv(f, idx, w, out_valid=valid,
                                                    impl="cuda")
                vp = gather_conv.sparse_gather_conv(f, idx, w, out_valid=valid,
                                                    impl="plain")
                torch.cuda.synchronize()
                err = (vk.float() - vp.float()).abs()
                mag = vp.float().abs()
                if tag == "f32":
                    # summation order only: relative to the output's scale
                    ok = float(err.max()) <= 1e-4 * max(1.0, float(mag.max()))
                else:
                    # one bf16 rounding of sums that differ in order: at most
                    # one ulp (2^-7 relative) per element
                    ok = bool((err <= 2.0 ** -7 * mag
                               + 1e-5 * max(1.0, float(mag.max()))).all())
                worst[tag] = max(worst[tag], float(err.max()))
                if not ok:
                    # the worst element's sum of |terms|: large against the
                    # element itself means heavy cancellation
                    at = int(err.argmax())
                    terms = gather_conv.gather_conv_plain(
                        f.float().abs(), idx, w.float().abs()).reshape(-1)[at]
                    check(False, f"{name} {tag}: kernel vs plain max err "
                                 f"{float(err.max())} (scale {float(mag.max())}"
                                 f"; worst element {at}: plain "
                                 f"{float(vp.reshape(-1)[at])}, sum|terms| "
                                 f"{float(terms)})")
                row[f"err_{tag}"] = float(err.max())
                row[f"ms_{tag}"] = time_ms(lambda: gather_conv.gather_conv_cuda(
                    f, idx, w, out_valid=valid), flush=flush)
                row[f"plain_ms_{tag}"] = time_ms(lambda: gather_conv.gather_conv_plain(
                    f, idx, w, out_valid=valid), reps=5, flush=flush)
                flat = torch.cat([f, f.new_zeros((1, cin))])
                safe = torch.where(present, idx.long(), n).reshape(-1)
                w2 = w.reshape(k * cin, cout)
                row[f"library_ms_{tag}"] = time_ms(
                    lambda: torch.matmul(flat[safe].reshape(m, k * cin), w2),
                    flush=flush)
                # each input read once (the rows the rulebook uses, the
                # table, the weights), the output written once; the
                # operations of the present taps only
                nbytes = (rows_read * cin + k * cin * cout + m * cout) \
                    * f.element_size() + m * k * 4
                row[f"bytes_ms_{tag}"] = 1e3 * nbytes / HBM_BYTES_PER_S
                row[f"ops_ms_{tag}"] = 1e3 * 2.0 * n_present * cin * cout \
                    / PEAK_OPS_PER_S[tag]
                row[f"bound_ms_{tag}"] = max(row[f"bytes_ms_{tag}"],
                                             row[f"ops_ms_{tag}"])
            # s8: exact s32 sums, and the scaled/masked epilogue bit-exact
            fq, s_f = quant_sym(feats.float())
            wq, s_w = quant_sym(w32.float(), axis=-1)
            scale = (s_f * s_w).float().contiguous()
            for kw in ({}, {"out_scale": scale, "out_valid": valid}):
                vk = gather_conv.sparse_gather_conv(fq, idx, wq, impl="cuda", **kw)
                vp = gather_conv.sparse_gather_conv(fq, idx, wq, impl="plain", **kw)
                check(torch.equal(vk, vp), f"{name} s8 {sorted(kw)}: kernel != plain")
            row["ms_s8"] = time_ms(lambda: gather_conv.gather_conv_cuda(
                fq, idx, wq, out_scale=scale, out_valid=valid), flush=flush)
            row["plain_ms_s8"] = time_ms(lambda: gather_conv.gather_conv_plain(
                fq, idx, wq, out_scale=scale, out_valid=valid), reps=5, flush=flush)
            flatq = torch.cat([fq, fq.new_zeros((1, cin))])
            safe = torch.where(present, idx.long(), n).reshape(-1)
            wq2 = wq.reshape(k * cin, cout)
            row["library_ms_s8"] = time_ms(
                lambda: torch._int_mm(flatq[safe].reshape(m, k * cin), wq2),
                flush=flush) if m > 16 else None
            nbytes = rows_read * cin + k * cin * cout + m * cout * 4 + m * k * 4
            row["bound_ms_s8"] = 1e3 * max(
                nbytes / HBM_BYTES_PER_S,
                2.0 * n_present * cin * cout / PEAK_OPS_PER_S["s8"])
            emit("kernel_conv", **row)
            rows.append(row)
            for key in totals:
                totals[key] += row[f"{key}_bf16"]
            group = by_width.setdefault((cin, cout, k), {"convs": 0})
            group["convs"] += 1
            for tag in ("bf16", "s8"):
                for key in ("ms", "library_ms", "bound_ms"):
                    v, acc = row[f"{key}_{tag}"], group.get(f"{key}_{tag}", 0.0)
                    group[f"{key}_{tag}"] = None if v is None or acc is None \
                        else acc + v
                lib_ms = row[f"library_ms_{tag}"]
                under_library[tag] += lib_ms is not None \
                    and row[f"ms_{tag}"] <= lib_ms
    groups = []
    for (cin, cout, k), g in by_width.items():
        for tag in ("bf16", "s8"):
            lib_ms = g[f"library_ms_{tag}"]
            g[f"kernel_over_library_{tag}"] = None if lib_ms is None \
                else g[f"ms_{tag}"] / lib_ms
        groups.append({"Cin": cin, "Cout": cout, "K": k, **g})
    emit("kernel_conv_by_width", model=label, groups=groups,
         times="sums over the convs of each (Cin, Cout, K) group")
    emit("kernel_conv_total", model=label, dtype="bf16", convs=len(convs),
         **totals,
         convs_at_or_under_library=under_library,
         mode=mode(), max_abs_err=worst, tolerance={
             "f32": "max|k-p| <= 1e-4 * max(1, max|p|)",
             "bf16": "|k-p| <= 2^-7 |p| + 1e-5 * max(1, max|p|) per element",
             "s8": "bit-exact (s32 sums and scaled/masked output)"})
    return totals, worst, rows


def kernel_launches(conv_k, nms_k):
    """Launch counts of both kernels, by entry (and the int8 convs'
    ``_int_mm`` calls, a library GEMM)."""
    from q3d_tpu_torch.models import layers as dense_layers
    from q3d_tpu_torch.ops.spconv import gather_conv
    entries = {"sparse_gather_conv_f32": "q3d_sparse_gather_conv_f32",
               "sparse_gather_conv_bf16": "q3d_sparse_gather_conv_bf16",
               "sparse_gather_conv_s8": "q3d_sparse_gather_conv_s8",
               "sparse_gather_conv_s8_requant": gather_conv.REQUANT_ENTRY}
    out = {k: conv_k.launches[e] for k, e in entries.items()}
    out["sparse_gather_conv_other"] = sum(conv_k.launches.values()) \
        - sum(out.values())
    return {**out, "greedy_nms_boxes": nms_k.launches["q3d_greedy_nms_boxes"],
            "greedy_nms_iou": nms_k.launches["q3d_greedy_nms"],
            "int_mm_conv2d": dense_layers.INT_MM_CALLS["int8_conv2d"],
            "int_mm_conv2d_sq": dense_layers.INT_MM_CALLS["int8_conv2d_sq"]}


def clear_launches(conv_k, nms_k):
    from q3d_tpu_torch.models import layers as dense_layers
    conv_k.launches.clear()
    nms_k.launches.clear()
    dense_layers.INT_MM_CALLS.clear()


def detections_near(a, b, min_score, box_tol, score_tol):
    """Per-frame detections (lists of host dicts) -> (detections of either
    run scoring >= min_score, those with a partner of the same frame and
    label in the other run within box_tol and score_tol, worst box and
    score differences over the partnered ones)."""
    import numpy as np
    n = matched = 0
    worst = [0.0, 0.0]
    for x, y in ((a, b), (b, a)):
        for fx, fy in zip(x, y):
            for i in range(fx["final_valid"].shape[0]):
                vx, vy = fx["final_valid"][i], fy["final_valid"][i]
                for box, label, score in zip(fx["final_boxes"][i][vx],
                                             fx["final_labels"][i][vx],
                                             fx["final_scores"][i][vx]):
                    if score < min_score:
                        continue
                    n += 1
                    same = fy["final_labels"][i][vy] == label
                    if not same.any():
                        continue
                    db = np.abs(fy["final_boxes"][i][vy][same] - box).max(-1)
                    ds = np.abs(fy["final_scores"][i][vy][same] - score)
                    k = int(np.argmin(db))
                    if db[k] <= box_tol and ds[k] <= score_tol:
                        matched += 1
                        worst = [max(worst[0], float(db[k])),
                                 max(worst[1], float(ds[k]))]
    return n, matched, worst


def matched_detections(a, b, frames, box_tol=1e-3, score_tol=1e-4,
                       box_floor=None):
    """Valid detections of either run with a partner in the other (same
    frame and label, each box element within ``box_tol``, or with
    ``box_floor`` within ``box_tol`` x max(box_floor, |element|), the
    score within ``score_tol``) -> (matched, total)."""
    matched = total = 0
    for x, y in ((a, b), (b, a)):
        for i in range(frames):
            vx, vy = x["final_valid"][i], y["final_valid"][i]
            bx, by = x["final_boxes"][i][vx], y["final_boxes"][i][vy]
            total += len(bx)
            if len(bx) == 0 or len(by) == 0:
                continue
            tol = box_tol if box_floor is None \
                else box_tol * by.abs().clamp_min(box_floor)[None]
            ok = ((bx[:, None, :] - by[None, :, :]).abs() <= tol).all(-1) \
                & (x["final_labels"][i][vx][:, None]
                   == y["final_labels"][i][vy][None, :]) \
                & ((x["final_scores"][i][vx][:, None]
                    - y["final_scores"][i][vy][None, :]).abs() <= score_tol)
            matched += int(ok.any(1).sum())
    return matched, total


def first_difference(model, batch):
    """One forward of ``model`` on ``batch`` through the kernels and through
    the plain versions, every conv, BN and quantizer output recorded in
    order -> the first one that differs (None if none does): its name,
    whether its inputs were equal, the share of elements that differ, the
    largest absolute difference, and that difference over the output's
    largest magnitude, also in units in the last place of that magnitude
    (an f32 sum taken in another order differs by a few of those; an
    element's own ulps mean nothing where its sum cancels to near 0)."""
    import torch
    from q3d_tpu_torch.models.layers import BatchNorm, Conv2d
    from q3d_tpu_torch.ops.spconv.modules import (SparseBatchNorm,
                                                  _SparseConvBase)
    from q3d_tpu_torch.quant.tensor_quant import TensorQuantizer

    def tensor(x):
        x = x[0] if isinstance(x, tuple) else x
        return (x.features if hasattr(x, "features") else x).detach().clone()
    names = {m: n for n, m in model.named_modules()}
    runs = {}
    for impl in ("cuda", "plain"):
        rec = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out: rec.append(
                (names[mod], tensor(args[0]), tensor(out))))
            for m in model.modules()
            if isinstance(m, (_SparseConvBase, SparseBatchNorm,
                              Conv2d, BatchNorm, TensorQuantizer))]
        model.set_kernel_impl(impl)
        try:
            with torch.no_grad():
                model(dict(batch))
            torch.cuda.synchronize()
        finally:
            model.set_kernel_impl(None)
            for h in hooks:
                h.remove()
        runs[impl] = rec
    for (name, xk, yk), (_, xp, yp) in zip(runs["cuda"], runs["plain"]):
        if torch.equal(yk, yp):
            continue
        a, b = yk.double(), yp.double()
        diff = (a - b).abs()
        row = {"layer": name, "inputs_equal": torch.equal(xk, xp),
               "share_differing": float((diff > 0).double().mean()),
               "max_abs": float(diff.max()),
               "max_rel_to_scale": float(diff.max() / b.abs().max().clamp_min(
                   1e-30))}
        if yp.dtype == torch.float32:
            top = yp.abs().max()
            ulp = torch.nextafter(top, top.new_tensor(float("inf"))) - top
            row["ulps_of_scale"] = float(diff.max() / ulp.double())
        return row
    return None


def eval_gates(dev, conv_k, nms_k, mode):
    """Phases ``eval_gates`` and ``eval_plain``: the four gates of
    tests/test_accuracy_regression.py on the card.  The trained
    centerpoint_tiny fixture (read without JAX), its 16 test frames at
    batch 2 in f32, each recipe calibrated as the test calibrates it, then
    ``eval_one_epoch`` through the kernels (launch counts zeroed before and
    read after: kernel 1 and kernel 2 must have launched) and, on the same
    calibrated model, through the plain versions; the per-frame detections
    of the two are compared.  -> {recipe: summary}; raises if a gate or a
    comparison fails."""
    import numpy as np
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.eval_utils import eval_one_epoch
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.utils.checkpoint import load_flax_checkpoint
    from q3d_tpu_torch.utils.weights import state_dict_from_jax

    cfg = cfg_from_yaml_file(str(TINY_CFG), EDict())
    cfg.MODEL.POST_PROCESSING.EVAL_METRIC = "nuscenes"
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=BATCH, training=False)
    names = list(cfg.CLASS_NAMES)
    state = state_dict_from_jax(load_flax_checkpoint(str(CKPT))[0])
    batch = load_data_to_device(next(iter(loader)), device=dev)

    def int8(extra):
        return lambda m: quant_api.prepare_int8_deploy(
            m, [batch, batch], recipe_kwargs=dict(quantize_first_conv=True,
                                                  extra_no_list=extra))

    def static_entropy(m):
        quant_api.quantize_model(m, quant_api.centerpoint_recipe(
            sq=False, static=True), batch)
        quant_api.collect_stats(m, [batch] * 3, num_batches=3)
        quant_api.compute_amax(m, method="entropy")
    recipes = {
        "fp32": lambda m: None,
        "int8_full": int8(()),
        "int8_head_bf16": int8(("dense_head.*",)),
        "sq_dynamic": lambda m: quant_api.quantize_model(
            m, quant_api.centerpoint_recipe(sq=True, alpha=0.5, static=False),
            batch),
        "static_entropy": static_entropy}
    n_batches = len(loader)
    results = {}
    for tag, prepare in recipes.items():
        m = build_network(cfg.MODEL, len(names), ds, device=dev)
        m.load_state_dict(state, strict=True)
        t0 = time.perf_counter()
        prepare(m)
        calib_s = time.perf_counter() - t0
        # where the float runs first part, kernels against plain versions
        runs = {} if tag.startswith("int8") \
            else {"first_difference": first_difference(m, batch)}
        for impl in ("cuda", "plain"):
            m.set_kernel_impl(impl)
            clear_launches(conv_k, nms_k)
            frames = []
            t0 = time.perf_counter()
            res = eval_one_epoch(m, loader, ds, names, cfg, device=dev,
                                 per_frame=frames)
            runs[impl] = {"res": res, "frames": frames,
                          "launches": kernel_launches(conv_k, nms_k),
                          "eval_s": time.perf_counter() - t0}
        m.set_kernel_impl(None)
        results[tag] = {"calibration_s": calib_s, **runs}

    fp = {impl: results["fp32"][impl]["res"] for impl in ("cuda", "plain")}
    summary, failed = {}, []
    for tag, r in results.items():
        row = {"calibration_s": r["calibration_s"]}
        if "first_difference" in r:
            row["first_difference"] = r["first_difference"]
        for impl in ("cuda", "plain"):
            res = r[impl]["res"]
            drop = (fp[impl]["NDS"] - res["NDS"]) / max(fp[impl]["NDS"], 1e-9)
            row[impl] = {"NDS": res["NDS"], "mAP": res["mAP"],
                         "rel_nds_drop": drop,
                         "infer_time_ms": res["infer_time_ms"],
                         "eval_s": r[impl]["eval_s"],
                         "launches": r[impl]["launches"]}
            limit = GATES[tag]
            if tag == "fp32" and not (res["NDS"] > 0.4 and res["mAP"] > 0.3):
                failed.append(f"{tag} {impl}: NDS {res['NDS']} mAP {res['mAP']}")
            if limit is not None and drop > limit:
                failed.append(f"{tag} {impl}: NDS drop {drop} > {limit}")
        lk, lp = r["cuda"]["launches"], r["plain"]["launches"]
        conv_entry = "sparse_gather_conv_s8_requant" if tag.startswith("int8") \
            else "sparse_gather_conv_f32"
        if lk[conv_entry] != 21 * n_batches \
                or lk["greedy_nms_boxes"] != n_batches:
            failed.append(f"{tag}: kernel launches {lk}")
        if any(lp.values()):
            failed.append(f"{tag}: the plain run launched {lp}")
        fk, fpl = r["cuda"]["frames"], r["plain"]["frames"]
        if tag.startswith("int8"):
            # the s8 kernels are bit-exact, the float layers identical
            same = all(np.array_equal(a[k], b[k]) for a, b in zip(fk, fpl)
                       for k in a)
            row["plain_vs_kernels"] = {"tolerance": "every final array equal",
                                       "equal": same}
            if not same:
                failed.append(f"{tag}: detections differ, kernels vs plain")
        else:
            fq = tag != "fp32"
            tol = (FQ_MIN_SCORE, FQ_BOX_TOL, FQ_SCORE_TOL) if fq \
                else (0.0, 1e-3, 1e-4)
            n, matched, worst = detections_near(fk, fpl, *tol)
            counts = [sum(int(f["final_valid"].sum()) for f in x)
                      for x in (fk, fpl)]
            row["plain_vs_kernels"] = {
                "min_score": tol[0], "box_tol": tol[1], "score_tol": tol[2],
                "detections": n, "matched": matched, "worst": worst,
                "valid_counts": counts,
                "nds_diff": r["cuda"]["res"]["NDS"] - r["plain"]["res"]["NDS"]}
            if fq:
                ok = matched >= FQ_MATCH_SHARE * n \
                    and abs(counts[0] - counts[1]) <= FQ_COUNT_SHARE * max(counts) \
                    and abs(row["plain_vs_kernels"]["nds_diff"]) <= FQ_NDS_TOL
            else:
                ok = matched >= 0.99 * n
            if not ok:
                failed.append(f"{tag}: kernels vs plain {row['plain_vs_kernels']}")
        summary[tag] = row
        common = dict(recipe=tag, gate=GATES[tag], mode=mode(),
                      config=TINY_CFG.name, frames=len(ds), batch=BATCH,
                      calibration_s=row["calibration_s"])
        emit("eval_gates", **common, **row["cuda"])
        emit("eval_plain", **common, **row["plain"],
             plain_vs_kernels=row["plain_vs_kernels"],
             **{k: row[k] for k in ("first_difference",) if k in row})
    check(not failed, "eval gates: " + "; ".join(failed))
    return summary


def fakequant_ref(model, batch, conv_k, nms_k, mode, flush):
    """Phase ``fakequant_ref``: centerpoint_ref (seeded weights, BN
    calibrated) under dynamic SmoothQuant and under static entropy
    (calibrated on ``batch``), one forward each through the kernels and
    through the plain versions: spatial_features, every head map and the
    detections compared; CUDA-event times of each forward and each stage;
    the 12 BEV SmoothQuant convs timed beside cuDNN's bf16 conv."""
    import torch
    from q3d_tpu_torch.eval_utils import to_host
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.quant import api as quant_api

    models = {}
    m = copy.deepcopy(model)
    quant_api.quantize_model(m, quant_api.centerpoint_recipe(
        sq=True, alpha=0.5, static=False), batch)
    models["sq_dynamic"] = (m, 0.0)
    m = copy.deepcopy(model)
    quant_api.quantize_model(m, quant_api.centerpoint_recipe(
        sq=False, static=True), batch)
    quant_api.collect_stats(m, [batch], num_batches=1)
    t0 = time.perf_counter()
    quant_api.compute_amax(m, method="entropy")
    models["static_entropy"] = (m, time.perf_counter() - t0)
    out = {}
    for tag, (m, amax_s) in models.items():
        outs, launches, fwd_ms = {}, {}, {}
        with torch.no_grad():
            for impl in ("cuda", "plain"):
                m.set_kernel_impl(impl)
                clear_launches(conv_k, nms_k)
                outs[impl] = m(dict(batch))
                torch.cuda.synchronize()
                launches[impl] = kernel_launches(conv_k, nms_k)
                fwd_ms[impl] = time_ms(lambda: m(dict(batch)), reps=5)
        check(launches["cuda"]["sparse_gather_conv_f32"] == 21
              and launches["cuda"]["greedy_nms_boxes"] == 1
              and launches["cuda"]["sparse_gather_conv_s8_requant"] == 0,
              f"fakequant_ref {tag}: kernel launches {launches['cuda']}")
        check(not any(launches["plain"].values()),
              f"fakequant_ref {tag}: the plain run launched {launches['plain']}")
        ok_, op = outs["cuda"], outs["plain"]
        maps = {"spatial_features": (ok_["spatial_features"],
                                     op["spatial_features"]),
                "spatial_features_2d": (ok_["spatial_features_2d"],
                                        op["spatial_features_2d"])}
        for h, (pk, pp) in enumerate(zip(ok_["pred_dicts"], op["pred_dicts"])):
            for key in pk:
                maps[f"head{h}.{key}"] = (pk[key], pp[key])
        map_err = {}
        for key, (a, b) in maps.items():
            check(bool(torch.isfinite(a).all()), f"fakequant_ref {tag}: {key} "
                                                  f"not finite")
            err = (a - b).abs()
            mag = float(b.abs().max())
            map_err[key] = {"max_abs": float(err.max()), "scale": mag,
                            "share_over_1e-3": float(
                                (err > 1e-3 * max(mag, 1e-30)).float().mean())}
            check(float(err.max()) <= FQ_MAP_RTOL * max(mag, 1.0),
                  f"fakequant_ref {tag}: {key} kernels vs plain {map_err[key]}")
        hk, hp = to_host(ok_), to_host(op)
        n, matched, worst = detections_near([hk], [hp], FQ_MIN_SCORE,
                                            FQ_BOX_TOL, FQ_SCORE_TOL)
        counts = [int(hk["final_valid"].sum()), int(hp["final_valid"].sum())]
        check(matched >= FQ_MATCH_SHARE * n and abs(counts[0] - counts[1])
              <= FQ_COUNT_SHARE * max(counts),
              f"fakequant_ref {tag}: detections kernels vs plain: {matched}/"
              f"{n} matched, counts {counts}")
        m.set_kernel_impl(None)
        stages = stage_times(m, batch)
        # cuDNN's deterministic f32 algorithms (this phase's mode) against
        # its own choice, TF32 still off: the float convs of static PTQ
        # are cuDNN's
        torch.backends.cudnn.deterministic = False
        with torch.no_grad():
            fwd_ms["cuda_cudnn_any_algorithm"] = time_ms(
                lambda: m(dict(batch)), reps=5)
        torch.backends.cudnn.deterministic = True
        out[tag] = {"forward_ms": fwd_ms, "stages_ms": stages,
                    "launches": launches["cuda"], "map_err": map_err,
                    "map_tolerance": f"max|k-p| <= {FQ_MAP_RTOL} * max(1, "
                                     f"max|p|)",
                    "detections": n, "matched": matched, "worst": worst,
                    "valid_counts": counts, "entropy_amax_s": amax_s}
        emit("fakequant_ref", recipe=tag, config=CFG.name, batch=BATCH,
             dtype="f32", mode=mode(), **out[tag])

    # the 12 BEV SmoothQuant convs: im2col + fake-quant + torch.matmul (f32),
    # beside cuDNN's bf16 conv at the same shapes
    m = models["sq_dynamic"][0]
    seen = []
    hooks = [c.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for c in m.backbone_2d.modules() if isinstance(c, Conv2d)]
    with torch.no_grad():
        m(dict(batch))
    for h in hooks:
        h.remove()
    n_bev = sum(isinstance(c, Conv2d) for c in m.backbone_2d.modules())
    check(len(seen) == n_bev > 0, f"fakequant_ref: {len(seen)} of {n_bev} BEV "
                                  f"SQ convs ran")
    rows = []
    with torch.no_grad():
        for conv, x in seen:
            xb = x.to(torch.bfloat16).contiguous()
            wb = conv.weight.to(torch.bfloat16)
            o, c_in, kh, kw = conv.weight.shape
            b_, _, h_, w_ = x.shape
            ho = (h_ + 2 * conv.padding[0] - kh) // conv.stride[0] + 1
            wo = (w_ + 2 * conv.padding[1] - kw) // conv.stride[1] + 1
            mm, kk = b_ * ho * wo, c_in * kh * kw
            row = {"x": list(x.shape), "w": list(conv.weight.shape),
                   "stride": list(conv.stride), "gemm_mkn": [mm, kk, o],
                   "sq_f32_ms": time_ms(lambda: conv._smoothquant_conv(x),
                                        reps=5, flush=flush),
                   "cudnn_bf16_ms": time_ms(lambda: torch.nn.functional.conv2d(
                       xb, wb, None, conv.stride, conv.padding), flush=flush)}
            # the f32 im2col GEMM's bound: the map read once, the patches
            # written and read, the output written; its f32 operations
            nbytes = 4 * (x.numel() + 2 * mm * kk + kk * o + mm * o)
            row["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, 2.0 * mm * kk
                                        * o / PEAK_OPS_PER_S["f32"])
            rows.append(row)
            emit("sq_conv2d", **row)
    emit("sq_conv2d_total", convs=len(rows), mode=mode(),
         **{k: sum(r[k] for r in rows)
            for k in ("sq_f32_ms", "cudnn_bf16_ms", "bound_ms")})
    return out


def sq_int8_conv2d(m, req, flush, mode):
    """The BEV backbone's SmoothQuant int8 convs of ``m`` on their real
    inputs of ``req``: each conv (f32 im2col, column scales, quantize,
    ``_int_mm``, rescale) timed beside its ``_int_mm`` alone and beside
    cuDNN's bf16 conv at its shapes, with the bound of its s8 GEMM ->
    totals."""
    import torch
    from q3d_tpu_torch.models.layers import Conv2d
    seen = []
    convs = [c for c in m.backbone_2d.modules() if isinstance(c, Conv2d)]
    hooks = [c.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0]))) for c in convs]
    with torch.no_grad():
        m(dict(req))
    for h in hooks:
        h.remove()
    check(len(seen) == len(convs) > 0, f"sq_int8_conv2d: {len(seen)} of "
                                       f"{len(convs)} BEV convs ran")
    rows = []
    with torch.no_grad():
        for conv, x in seen:
            o, c_in, kh, kw = conv.weight.shape
            patches, (b_, ho, wo) = conv._unfold(x)
            mm, kk = b_ * ho * wo, c_in * kh * kw
            a8 = torch.randint(-127, 128, (mm, kk), dtype=torch.int8,
                               device=x.device)
            w8 = torch.randint(-127, 128, (o, kk), dtype=torch.int8,
                               device=x.device)
            xb = x.to(torch.bfloat16).contiguous()
            wb = conv.weight.to(torch.bfloat16)
            row = {"x": list(x.shape), "x_dtype": str(x.dtype),
                   "w": list(conv.weight.shape), "stride": list(conv.stride),
                   "gemm_mkn": [mm, kk, o],
                   "ms": time_ms(lambda: conv._smoothquant_int8_conv(x),
                                 reps=5, flush=flush),
                   "int_mm_ms": time_ms(lambda: torch._int_mm(a8, w8.t()),
                                        flush=flush),
                   "cudnn_bf16_ms": time_ms(lambda: torch.nn.functional.conv2d(
                       xb, wb, None, conv.stride, conv.padding), flush=flush)}
            # the s8 GEMM's bound: its operands read once, the s32 written
            nbytes = mm * kk + kk * o + 4 * mm * o
            row["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, 2.0 * mm * kk
                                        * o / PEAK_OPS_PER_S["s8"])
            rows.append(row)
            emit("sq_int8_conv2d", **row)
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "int_mm_ms", "cudnn_bf16_ms", "bound_ms")}
    emit("sq_int8_conv2d_total", convs=len(rows), mode=mode(), **total)
    return total


def deploy_int8(model, req16, req32, conv_k, nms_k, mode, strict_f32, flush):
    """Phase ``deploy_int8``: centerpoint_ref (``model``: seeded weights, BN
    calibrated) under the three int8 deploy recipes without residency:
    ``int8_deploy_recipe()`` (dynamic, what tools/test.py --quant int8
    runs), ``(sq=True)`` (the PTQ driver's --deploy_int8) and
    ``(static=True)`` (calibrated on ``req16`` given twice, entropy amax).
    Per recipe: one forward of the bf16 request with the launch counts zeroed
    before and read after, held to the count of each entry the recipe's
    layers give; the f32 request (TF32 off) through the kernels and through
    the plain versions, every int8 map a quantizer emits, spatial_features
    and the detections equal; forwards of the int8 and the bf16 model in
    turns (CUDA events, the first round dropped); the device operations of
    a forward (``forward_trace``).  -> (per-recipe summary, the unfused s8
    entry's calls of one dynamic forward: (conv name, args))."""
    import torch
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.ops.spconv import modules as sp_modules
    from q3d_tpu_torch.ops.spconv.modules import SparseConv3d, SubMConv3d
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.quant.tensor_quant import TensorQuantizer

    recipes = {"dynamic": {}, "sq": {"sq": True}, "static": {"static": True}}
    summary, s8_calls = {}, []
    for tag, kw in recipes.items():
        m = copy.deepcopy(model)
        t0 = time.perf_counter()
        quant_api.quantize_model(m, quant_api.int8_deploy_recipe(**kw), req16)
        if kw.get("static"):
            quant_api.collect_stats(m, [req16, req16], num_batches=2)
            quant_api.compute_amax(m, method="entropy")
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        sparse = [c for c in m.modules()
                  if isinstance(c, (SubMConv3d, SparseConv3d))]
        dense8 = [c for c in m.modules() if isinstance(c, Conv2d)
                  and c.rule is not None]
        n_s8 = sum(c.rule is not None for c in sparse)
        expected = {"sparse_gather_conv_s8": n_s8,
                    "sparse_gather_conv_bf16": len(sparse) - n_s8,
                    "greedy_nms_boxes": 1,
                    "int_mm_conv2d_sq" if kw.get("sq") else "int_mm_conv2d":
                        len(dense8)}
        clear_launches(conv_k, nms_k)
        with torch.no_grad():
            out = m(dict(req16))
        torch.cuda.synchronize()
        launches = kernel_launches(conv_k, nms_k)
        check({k: v for k, v in launches.items() if v}
              == {k: v for k, v in expected.items() if v},
              f"deploy_int8 {tag}: launches {launches}, expected {expected}")
        check(all(torch.isfinite(out[k].float()).all() for k in
                  ("spatial_features_2d", "final_boxes", "final_scores")),
              f"deploy_int8 {tag}: non-finite outputs")
        valid = out["final_valid"].sum(1).tolist()
        if tag == "dynamic":
            # the unfused s8 entry's calls, by conv, for kernel_conv_s8
            names = {c: n for n, c in m.named_modules()}
            current = [None]
            real = sp_modules.sparse_gather_conv

            def rec(*args, **kwargs):
                if args[0].dtype == torch.int8:
                    s8_calls.append((current[0], args))
                return real(*args, **kwargs)
            hooks = [c.register_forward_pre_hook(
                lambda mod, a: current.__setitem__(0, names[mod]))
                for c in sparse]
            sp_modules.sparse_gather_conv = rec
            try:
                with torch.no_grad():
                    m(dict(req16))
            finally:
                sp_modules.sparse_gather_conv = real
                for h in hooks:
                    h.remove()
            check(len(s8_calls) == n_s8, f"deploy_int8: {len(s8_calls)} s8 "
                                         f"calls recorded, expected {n_s8}")

        # kernels vs plain on the f32 request: exact
        strict_f32(True)
        grabbed = {"cuda": [], "plain": []}
        impl_now = [None]
        qnames = {q: n for n, q in m.named_modules()
                  if isinstance(q, TensorQuantizer)}
        hooks = [q.register_forward_hook(
            lambda mod, a, o: grabbed[impl_now[0]].append((qnames[mod], o)))
            for q, n in qnames.items() if not n.endswith("weight_quant")]
        outs, plain_launches = {}, None
        try:
            with torch.no_grad():
                for impl in ("cuda", "plain"):
                    impl_now[0] = impl
                    m.set_kernel_impl(impl)
                    clear_launches(conv_k, nms_k)
                    outs[impl] = m(dict(req32))
                    torch.cuda.synchronize()
                    plain_launches = kernel_launches(conv_k, nms_k)
        finally:
            m.set_kernel_impl(None)
            for h in hooks:
                h.remove()
        strict_f32(False)
        check(not any(plain_launches.values()),
              f"deploy_int8 {tag}: the plain run launched {plain_launches}")
        gk, gp = grabbed["cuda"], grabbed["plain"]
        check(len(gk) == len(gp) > 0 and [n for n, _ in gk] == [n for n, _ in gp]
              and all(o[0].dtype == torch.int8 for _, o in gk),
              f"deploy_int8 {tag}: int8 maps {len(gk)} vs {len(gp)}")
        bad = [n for (n, a), (_, b) in zip(gk, gp)
               if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
        check(not bad, f"deploy_int8 {tag}: int8 maps differ at {bad[:5]}")
        for key in ("spatial_features", "final_boxes", "final_scores",
                    "final_labels", "final_valid"):
            check(torch.equal(outs["cuda"][key], outs["plain"][key]),
                  f"deploy_int8 {tag}: {key} differs, kernels vs plain")

        sq_total = sq_int8_conv2d(m, req16, flush, mode) if kw.get("sq") \
            else None

        # the int8 and the bf16 model in turns, CUDA events
        fwd = {"int8": [], "bf16": []}
        with torch.no_grad():
            for _ in range(6):
                for t_, mdl in (("int8", m), ("bf16", model)):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    a.record()
                    mdl(dict(req16))
                    b.record()
                    torch.cuda.synchronize()
                    fwd[t_].append(a.elapsed_time(b))
        med = {k: statistics.median(v[1:]) for k, v in fwd.items()}
        args = ", ".join(f"{k}={v}" for k, v in kw.items())
        summary[tag] = {"recipe": f"int8_deploy_recipe({args})",
                        "prepare_s": prep_s, "launches": launches,
                        "expected_launches": expected,
                        "int8_maps_equal": len(gk), "forward_ms": med["int8"],
                        "bf16_forward_ms": med["bf16"],
                        "int8_vs_bf16": med["bf16"] / med["int8"],
                        "valid_detections": valid,
                        "trace": forward_trace(m, req16),
                        **({} if sq_total is None
                           else {"bev_sq_int8_conv2d": sq_total})}
        emit("deploy_int8", config=CFG.name, batch=BATCH, mode=mode(),
             equal="every int8 map a quantizer emits, spatial_features and "
                   "final boxes/scores/labels/valid, kernels vs plain (f32 "
                   "request, exact)", timed="bf16 request, in turns",
             **summary[tag])
        del m
    return summary, s8_calls


def kernel_conv_s8(s8_calls, flush, mode):
    """Phase ``kernel_conv_s8``: kernel 1's unfused s8 entry on the real
    int8 features, books, weights, rescales and row masks of one forward
    under ``int8_deploy_recipe()``: bit-equal to its plain version, and
    timed beside it, beside the library form (gather + ``torch._int_mm``,
    the s32 sums without the rescale) and beside its bound.  -> totals."""
    import torch
    from q3d_tpu_torch.ops.spconv import gather_conv
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bytes_ms", "ops_ms")}
    with torch.no_grad():
        for name, (f, idx, wq, osc, valid) in s8_calls:
            n, cin = f.shape
            m, k = idx.shape
            cout = wq.shape[2]
            y_k = gather_conv.gather_conv_cuda(f, idx, wq, osc, valid)
            y_p = gather_conv.gather_conv_plain(f, idx, wq, osc, valid)
            torch.cuda.synchronize()
            check(torch.equal(y_k, y_p), f"{name} s8: kernel != plain")
            present = (idx >= 0) & (idx < n)
            n_present = int(present.sum())
            rows_read = int(torch.unique(idx[present]).numel())
            flatq = torch.cat([f, f.new_zeros((1, cin))])
            safe = torch.where(present, idx.long(), n).reshape(-1)
            wq2 = wq.reshape(k * cin, cout)
            row = {"conv": name, "N": n, "M": m, "K": k, "Cin": cin,
                   "Cout": cout, "present_taps": n_present,
                   "ms": time_ms(lambda: gather_conv.gather_conv_cuda(
                       f, idx, wq, osc, valid), flush=flush),
                   "plain_ms": time_ms(lambda: gather_conv.gather_conv_plain(
                       f, idx, wq, osc, valid), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch._int_mm(
                       flatq[safe].reshape(m, k * cin), wq2), flush=flush)}
            # inputs read once (the rows the book uses, the book, the
            # weights, the rescale, the row mask), the f32 output written
            # once; the present taps' operations
            nbytes = rows_read * cin + m * k * 4 + k * cin * cout \
                + 4 * cout + m + 4 * m * cout
            row["bytes_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
            row["ops_ms"] = 1e3 * 2.0 * n_present * cin * cout \
                / PEAK_OPS_PER_S["s8"]
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            emit("kernel_conv_s8", **row)
            for key in totals:
                totals[key] += row[key]
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] \
        else "operations"
    emit("kernel_conv_s8_total", convs=len(s8_calls), **totals,
         recipe="int8_deploy_recipe()", mode=mode(), max_abs_err=0,
         tolerance="bit-exact (f32 outputs of exact s32 sums, equal)",
         library="gather + torch._int_mm (the s32 sums without the rescale)")
    return totals


def driver_tiny(conv_k, nms_k, mode, fp32_nds):
    """Phase ``driver_tiny``: the port's PTQ driver
    (``q3d_tpu_torch.tools.quant_driver``) on the trained centerpoint_tiny
    fixture on the card, nuScenes metric, with ``--deploy_int8`` and with
    ``--deploy_int8 --no_sq``: fp32 and quantized NDS / mAP and the relative
    drop; fp32 NDS equal to this run's ``eval_gates`` fp32 NDS within 1e-6;
    the quantized final scores within the JAX package's bound for the
    recipe (``tests/test_quant_model_e2e.py:72``: mean |fp - q| < 0.05);
    launches counted over the run (fp32 eval, the seed pass, the quantized
    eval)."""
    import numpy as np
    from q3d_tpu_torch.tools import quant_driver
    out = {}
    for tag, extra in (("deploy_int8", []), ("deploy_int8_no_sq", ["--no_sq"])):
        frames = {}
        clear_launches(conv_k, nms_k)
        t0 = time.perf_counter()
        fp, q = quant_driver.run(argv=[
            "--cfg_file", str(TINY_CFG), "--ckpt", str(CKPT), "--deploy_int8",
            *extra, "--device", "cuda",
            "--set", "MODEL.POST_PROCESSING.EVAL_METRIC", "nuscenes"],
            frames=frames)
        run_s = time.perf_counter() - t0
        launches = kernel_launches(conv_k, nms_k)
        n = len(frames["fp"])
        score_diff = float(np.mean([
            np.abs(a["final_scores"] - b["final_scores"]).mean()
            for a, b in zip(frames["fp"], frames["quant"])]))
        row = {"fp32": {"NDS": fp["NDS"], "mAP": fp["mAP"]},
               "quant": {"NDS": q["NDS"], "mAP": q["mAP"],
                         "infer_time_ms": q["infer_time_ms"]},
               "rel_nds_drop": (fp["NDS"] - q["NDS"]) / fp["NDS"],
               "mean_abs_score_diff": score_diff, "batches": n,
               "launches": launches, "run_s": run_s,
               "eval_gates_fp32_nds": fp32_nds}
        # fp32 eval: 21 f32 convs a batch; the seed pass and the quantized
        # eval: conv_input in f32, 20 s8 convs; one NMS a forward
        want = {"sparse_gather_conv_f32": 21 * n + 1 + n,
                "sparse_gather_conv_s8": 20 * (n + 1),
                "greedy_nms_boxes": 2 * n + 1}
        check({k: launches[k] for k in want} == want,
              f"driver_tiny {tag}: launches {launches}, expected {want}")
        check(abs(fp["NDS"] - fp32_nds) <= 1e-6,
              f"driver_tiny {tag}: fp32 NDS {fp['NDS']} != eval_gates "
              f"{fp32_nds}")
        check(score_diff < 0.05, f"driver_tiny {tag}: mean |fp - q| score "
                                 f"{score_diff} >= 0.05")
        out[tag] = row
        emit("driver_tiny", recipe=tag, config=TINY_CFG.name, mode=mode(),
             score_bound="mean |fp - q| final_scores < 0.05 "
                         "(tests/test_quant_model_e2e.py:72)", **row)
    return out


def kitti_model(name, dev, conv_k, nms_k, mode, strict_f32):
    """Phases ``serving_<name>``, ``stages_<name>`` and ``model_<name>``:
    the KITTI config's MODEL at full width on KITTI-geometry synthetic
    scenes, seeded random weights (conv_cls's prior bias set to 0, so that
    the score threshold passes candidates as a trained model's scores do),
    BN statistics calibrated on the first request (f32, TF32 off).

    serving: 4 requests of batch 2 in bf16, host time (scene + voxelize)
    and device forward each, launches zeroed before and read after (kernel
    1: KITTI_CONVS a forward; kernel 2's boxes form: one a forward, at K =
    NMS_PRE_MAXSIZE); stages: CUDA events per stage of one bf16 forward;
    model: one f32 request (TF32 off) through the kernels and through the
    plain versions: spatial_features, the cls / box / dir maps (within
    1e-4 of scale) and the detections (matched), the NMS keep masks of
    both forms on identical candidates and post_processing on identical
    inputs equal.  -> dict of what later phases need."""
    import torch
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.kitti_synthetic import (
        CAMERA, SCENE, kitti_config, kitti_scene, scene_counts)
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.ops.iou3d_nms import candidate_iou
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.tools.nms_ab import anchor_candidates
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns

    cfg = kitti_config(name, BATCH * REQUESTS, SEED)
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                batch_size=BATCH, training=False)
    counts = scene_counts(ds)
    cap = int(cfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS["test"])
    # the cap must not bind: a capped frame loses the objects, which
    # make_scene puts last
    check(all(KITTI_MIN_VOXELS[name] <= c["voxels_kept"]
              == c["voxels_occupied"] < cap for c in counts),
          f"{name}: voxels kept {[c['voxels_kept'] for c in counts]}, "
          f"occupied {[c['voxels_occupied'] for c in counts]}, cap {cap}")
    check(all(c["objects_present"] == c["objects_labelled"] > 0
              for c in counts), f"{name}: objects lost: {counts}")
    emit(f"data_{name}", config=f"kitti_models/{name}.yaml",
         dataset="SyntheticDataset at the config's geometry, FOV-cropped",
         scene=SCENE, camera=CAMERA,
         point_cloud_range=list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
         voxel_size=[float(v) for v in ds.voxel_size],
         grid_size=[int(g) for g in ds.grid_size], voxel_cap=cap,
         frames=counts)
    t0 = time.perf_counter()
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    head = model.dense_head
    with torch.no_grad():
        head.conv_cls.bias.zero_()
    build_s = time.perf_counter() - t0
    raw0, _, _ = make_request(ds, 0, kitti_scene)
    strict_f32(True)
    batch_f32 = load_data_to_device(raw0, device=dev)
    calibrate_bns(model, batch_f32)
    strict_f32(False)

    # ------------------------------------------------------------ serving
    nms_cfg = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    pre, post_max = int(nms_cfg.NMS_PRE_MAXSIZE), int(nms_cfg.NMS_POST_MAXSIZE)
    k_seen = []                       # K of each boxes-form launch
    real_boxes_cuda = nms_mod.greedy_suppress_boxes_cuda

    def seen(corners, *args, **kw):
        k_seen.append(int(corners.shape[1]))
        return real_boxes_cuda(corners, *args, **kw)
    nms_mod.greedy_suppress_boxes_cuda = seen
    clear_launches(conv_k, nms_k)
    per_request = []
    try:
        for r in range(REQUESTS):
            raw, scene_ms, vox_ms = make_request(ds, r, kitti_scene)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = load_data_to_device(raw, device=dev,
                                        compute_dtype=torch.bfloat16)
            with torch.no_grad():
                out = model(batch)
            n_valid = out["final_valid"].sum(dim=1).tolist()
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            check(all(torch.isfinite(out[k].float()).all() for k in
                      ("spatial_features_2d", "batch_box_preds",
                       "final_boxes", "final_scores")),
                  f"{name} request {r}: non-finite outputs")
            check(out["final_boxes"].shape == (BATCH, post_max, 7),
                  f"{name} request {r}: final_boxes shape "
                  f"{tuple(out['final_boxes'].shape)}")
            per_request.append({"request": r,
                                "frames": list(range(BATCH * r,
                                                     BATCH * (r + 1))),
                                "scene_ms": scene_ms, "voxelize_ms": vox_ms,
                                "device_forward_ms": fwd_ms,
                                "valid_detections": n_valid})
            emit(f"serving_{name}_request", **per_request[-1])
    finally:
        nms_mod.greedy_suppress_boxes_cuda = real_boxes_cuda
    launches = kernel_launches(conv_k, nms_k)
    want = {"conv": KITTI_CONVS[name] * REQUESTS, "nms_boxes": REQUESTS,
            "nms_iou": 0, "nms_k": [pre] * REQUESTS}
    got = {"conv": sum(conv_k.launches.values()),
           "nms_boxes": launches["greedy_nms_boxes"],
           "nms_iou": launches["greedy_nms_iou"], "nms_k": k_seen}
    check(got == want, f"{name} main path launches {got}, expected {want}")
    emit(f"serving_{name}", config=f"kitti_models/{name}.yaml", batch=BATCH,
         dtype="bf16", requests=REQUESTS, launches=launches, nms_k=k_seen,
         anchors=int(head.anchors.shape[0]), build_s=build_s, mode=mode(),
         steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]))
    stages = stage_times(model, batch)
    emit(f"stages_{name}", dtype="bf16", batch=BATCH, mode=mode(), ms=stages)

    # ------------------------------------- whole model, kernels vs plain
    strict_f32(True)
    convs = []
    with torch.no_grad():
        model.set_kernel_impl("cuda")
        clear_launches(conv_k, nms_k)
        if KITTI_CONVS[name]:
            convs, out_k = record_sparse_convs(model, batch_f32)
        else:
            out_k = model(dict(batch_f32))
        torch.cuda.synchronize()
        cuda_launches = kernel_launches(conv_k, nms_k)
        model.set_kernel_impl("plain")
        clear_launches(conv_k, nms_k)
        out_p = model(dict(batch_f32))
        torch.cuda.synchronize()
        plain_launches = kernel_launches(conv_k, nms_k)
        model.set_kernel_impl(None)
    check(sum(conv_k.launches.values()) == 0 and not any(
        plain_launches.values()), f"model_{name}: the plain run launched "
                                  f"{plain_launches}")
    check(len(convs) == KITTI_CONVS[name] and cuda_launches[
        "greedy_nms_boxes"] == 1, f"model_{name}: kernel run launched "
                                  f"{cuda_launches}, {len(convs)} convs")
    map_err = {}
    for key in ("spatial_features", "spatial_features_2d", "cls_preds",
                "box_preds", "dir_cls_preds"):
        a, b = out_k[key], out_p[key]
        err, mag = float((a - b).abs().max()), float(b.abs().max())
        map_err[key] = {"max_abs": err, "scale": mag}
        check(err <= KITTI_MAP_RTOL * max(1.0, mag),
              f"model_{name} f32 {key}: kernels vs plain max err {err} "
              f"(scale {mag})")
    cand, cand_valid, prior_valid = anchor_candidates(out_k, cfg)
    thresh = float(nms_cfg.NMS_THRESH)
    with torch.no_grad():
        check(torch.equal(
            nms_mod.greedy_nms_boxes(cand, cand_valid, thresh, impl="cuda"),
            nms_mod.greedy_nms_boxes(cand, cand_valid, thresh, impl="plain")),
            f"model_{name}: NMS keep masks (boxes form) differ on identical "
            f"candidates")
        iou, iou_valid = candidate_iou(cand, cand_valid)
        check(torch.equal(nms_mod.greedy_nms(iou, iou_valid, thresh,
                                             impl="cuda"),
                          nms_mod.greedy_nms(iou, iou_valid, thresh,
                                             impl="plain")),
              f"model_{name}: NMS keep masks (IoU form) differ on identical "
              f"candidates")
        del iou
        finals = []
        for impl in ("cuda", "plain"):
            model.kernel_impl = impl
            finals.append(model.post_processing(
                {k: out_k[k] for k in ("batch_cls_preds", "batch_box_preds",
                                       "cls_preds_normalized")}))
        model.kernel_impl = None
    for key in ("final_boxes", "final_scores", "final_labels", "final_valid"):
        check(torch.equal(finals[0][key], finals[1][key]),
              f"model_{name}: {key} differs between NMS kernel and plain on "
              f"identical inputs")
    # end to end: every valid detection of one run has a partner in the
    # other (same label, box within 1e-3, score within 1e-4)
    matched, total = matched_detections(out_k, out_p, BATCH)
    frac = matched / max(total, 1)
    check(total > 0 and frac >= 0.99,
          f"model_{name}: only {matched}/{total} detections matched")
    emit(f"model_{name}", dtype="f32", mode=mode(), map_max_abs_err=map_err,
         map_tolerance=f"max|k-p| <= {KITTI_MAP_RTOL} * max(1, max|p|)",
         launches=cuda_launches,
         nms_identical_inputs=f"keep masks (both forms, K={cand.shape[1]}) "
         "and post_processing's detections equal",
         candidates_valid=cand_valid.sum(1).tolist(),
         candidates_valid_under_prior_bias=prior_valid.sum(1).tolist(),
         detections_matched=matched, detections=total, matched_fraction=frac)
    strict_f32(False)
    return {"model": model, "cfg": cfg, "batch_f32": batch_f32,
            "convs": convs, "cand": (cand, cand_valid, prior_valid),
            "launches": launches}


def boxes_bound(s, k, cand_pairs, near_pairs, clock_mhz):
    """Kernel 2's boxes form, three terms in ms: corners, areas and valid
    read once and keep written once (bytes); the circle test of every
    needed pair and the IoU of each near pair (operations, f32, as
    csrc/greedy_nms.cu counts them); the sweep's chain of K steps at >= 4
    cycles each (latency)."""
    return {"bytes": 1e3 * s * k * (32 + 4 + 1 + 1) / HBM_BYTES_PER_S,
            "operations": 1e3 * (cand_pairs * IOU_CIRCLE_OPS
                                 + near_pairs * IOU_OPS)
            / PEAK_OPS_PER_S["f32"],
            "latency": 1e3 * k * 4 / (clock_mhz * 1e6)}


def kernel_nms_wide(kitti, flush, mode, clock_mhz):
    """Phase ``kernel_nms`` at the anchor heads' widths (K > 2048, two mask
    words a sweep lane): the IoU form on random IoU matrices and the boxes
    form on random crowded boxes, K = 2049 and 4096, thresh 0.01 (the
    KITTI configs') and 0.5, and on both models' real candidate sets (K =
    4096): keep masks equal to the plain versions', the boxes form's IoU
    bit-equal at every pair it evaluated and 0 at every needed pair it
    skipped.  Then the boxes form timed on each model's candidates beside
    its plain version and its three-term bound, under three validities:
    every candidate valid, as the seeded models' zero conv_cls bias gives them (the main
    path's input and kernel 2's worst case), valid as conv_cls's prior
    bias would leave them, and the first 512 valid (``nms_ab.validities``).
    -> {model: row of the main path's input}."""
    import numpy as np
    import torch
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.tools.nms_ab import _crowded, validities
    dev = next(iter(kitti.values()))["cand"][0].device
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    for kk in WIDE_K:
        r_iou = torch.rand((2, kk, kk), generator=g, device=dev)
        r_valid = torch.rand((2, kk), generator=g, device=dev) > 0.1
        for th in (0.01, 0.5):
            check(torch.equal(nms_mod.greedy_nms(r_iou, r_valid, th,
                                                 impl="cuda"),
                              nms_mod.greedy_nms(r_iou, r_valid, th,
                                                 impl="plain")),
                  f"greedy_nms: random K={kk} thresh={th} keep masks differ")
        del r_iou
        r_boxes, r_valid = _crowded(rng, 2, kk, dev)
        for th in (0.01, 0.5):
            check_boxes_form(r_boxes, r_valid, th, f"random K={kk}")
    rows = {}
    for name, k_ in kitti.items():
        cand, all_valid, prior_valid = k_["cand"]
        th = float(k_["cfg"].MODEL.POST_PROCESSING.NMS_CONFIG.NMS_THRESH)
        corners, areas = nms_mod.bev_corners_areas(cand)
        s, k = all_valid.shape
        for share, valid in validities(all_valid, prior_valid):
            near, needed, most = check_boxes_form(
                cand, valid, th, f"{name} candidates, {share}")
            terms = boxes_bound(s, k, needed, near, clock_mhz)
            row = {"model": name, "entry": "q3d_greedy_nms_boxes",
                   "sets": s, "K": k, "thresh": th, "validity": share,
                   "valid": valid.sum(1).tolist(), "candidate_pairs": needed,
                   "near_pairs": near, "near_pairs_most_in_a_tile": most,
                   "kept": int(nms_mod.greedy_nms_boxes(cand, valid,
                                                        th).sum()),
                   "ms": time_ms(
                       lambda: nms_mod.greedy_suppress_boxes_cuda(
                           corners, areas, valid, th), flush=flush),
                   "plain_ms": time_ms(
                       lambda: nms_mod.greedy_suppress_boxes_plain(
                           cand, valid, th), reps=3, flush=flush),
                   **{f"{t}_ms": v for t, v in terms.items()},
                   "kernel_us": kernel_device_us(
                       lambda: nms_mod.greedy_suppress_boxes_cuda(
                           corners, areas, valid, th),
                       ("nms_box_pairs_kernel", "nms_box_iou_kernel",
                        "nms_sweep_kernel"), flush)}
            row["bound_by"] = max(terms, key=terms.get)
            row["bound_ms"] = terms[row["bound_by"]]
            rows.setdefault(name, row)
            emit("kernel_nms", form="boxes", **row, max_abs_err=0,
                 mode=mode(), clock_max_sm_mhz=clock_mhz,
                 tolerance="keep masks exactly equal, IoU bit-equal at every "
                 "evaluated pair, plain IoU exactly 0 at every skipped "
                 "needed pair (real candidates under each validity + "
                 "random K=2049/4096 x thresh 0.01/0.5); IoU form keep "
                 "masks equal on random K=2049/4096")
    return rows


def recipes_kitti(kitti, conv_k, nms_k, mode, strict_f32):
    """Phase ``recipes_kitti``: one f32 request (TF32 off) through the
    kernels and through the plain versions for SECOND under
    ``second_recipe()`` and PointPillars under ``pointpillar_recipe()``
    (dynamic SmoothQuant fake-quant: every map within KITTI_MAP_RTOL of its
    scale, the detections as sets with the FQ_* tolerances) and SECOND
    under ``int8_deploy_recipe()`` (every int8 map a quantizer emits,
    spatial_features and the detections equal; launches held to the
    recipe's layers: 11 s8, 1 f32 conv_input, one ``_int_mm`` per BEV conv
    (12), 1 NMS).
    -> {recipe: summary}."""
    import torch
    from q3d_tpu_torch.eval_utils import to_host
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.quant.tensor_quant import TensorQuantizer
    cases = (("second", "second_recipe()", quant_api.second_recipe()),
             ("pointpillar", "pointpillar_recipe()",
              quant_api.pointpillar_recipe()),
             ("second", "int8_deploy_recipe()",
              quant_api.int8_deploy_recipe()))
    strict_f32(True)
    summary = {}
    for name, tag, rules in cases:
        batch = kitti[name]["batch_f32"]
        m = copy.deepcopy(kitti[name]["model"])
        quant_api.quantize_model(m, rules, batch)
        int8 = "int8" in tag
        grabbed = {"cuda": [], "plain": []}
        impl_now = [None]
        qnames = {q: n for n, q in m.named_modules()
                  if isinstance(q, TensorQuantizer)}
        hooks = [q.register_forward_hook(
            lambda mod, a, o: grabbed[impl_now[0]].append((qnames[mod], o)))
            for q, n in qnames.items() if int8
            and not n.endswith("weight_quant")]
        outs, launches = {}, {}
        try:
            with torch.no_grad():
                for impl in ("cuda", "plain"):
                    impl_now[0] = impl
                    m.set_kernel_impl(impl)
                    clear_launches(conv_k, nms_k)
                    outs[impl] = m(dict(batch))
                    torch.cuda.synchronize()
                    launches[impl] = kernel_launches(conv_k, nms_k)
        finally:
            m.set_kernel_impl(None)
            for h in hooks:
                h.remove()
        n_conv = KITTI_CONVS[name]
        want = {"greedy_nms_boxes": 1}
        if int8:
            # conv_input float; one _int_mm per quantized dense conv (the
            # BEV backbone's 12 at KITTI width)
            want.update(sparse_gather_conv_s8=n_conv - 1,
                        sparse_gather_conv_f32=1, int_mm_conv2d=sum(
                            isinstance(c, Conv2d) and c.rule is not None
                            for c in m.modules()))
        elif n_conv:
            want["sparse_gather_conv_f32"] = n_conv
        check({k: v for k, v in launches["cuda"].items() if v} == want,
              f"recipes_kitti {name} {tag}: launches {launches['cuda']}, "
              f"expected {want}")
        check(not any(launches["plain"].values()),
              f"recipes_kitti {name} {tag}: the plain run launched "
              f"{launches['plain']}")
        ok_, op = outs["cuda"], outs["plain"]
        row = {"model": name, "recipe": tag, "launches": launches["cuda"],
               "valid": [int(ok_["final_valid"].sum()),
                         int(op["final_valid"].sum())]}
        if int8:
            gk, gp = grabbed["cuda"], grabbed["plain"]
            check(len(gk) == len(gp) > 0
                  and [n for n, _ in gk] == [n for n, _ in gp],
                  f"recipes_kitti {tag}: int8 maps {len(gk)} vs {len(gp)}")
            bad = [n for (n, a), (_, b) in zip(gk, gp)
                   if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
            check(not bad, f"recipes_kitti {tag}: int8 maps differ at "
                           f"{bad[:5]}")
            for key in ("spatial_features", "final_boxes", "final_scores",
                        "final_labels", "final_valid"):
                check(torch.equal(ok_[key], op[key]),
                      f"recipes_kitti {tag}: {key} differs, kernels vs plain")
            row.update(int8_maps_equal=len(gk),
                       equal="every int8 map, spatial_features, detections")
        else:
            map_err = {}
            for key in ("spatial_features", "spatial_features_2d",
                        "cls_preds", "box_preds", "dir_cls_preds"):
                a, b = ok_[key], op[key]
                err, mag = float((a - b).abs().max()), float(b.abs().max())
                map_err[key] = {"max_abs": err, "scale": mag}
                check(bool(torch.isfinite(a).all())
                      and err <= KITTI_MAP_RTOL * max(mag, 1.0),
                      f"recipes_kitti {name} {tag}: {key} {map_err[key]}")
            hk, hp = to_host(ok_), to_host(op)
            n, matched, worst = detections_near([hk], [hp], FQ_MIN_SCORE,
                                                FQ_BOX_TOL, FQ_SCORE_TOL)
            counts = row["valid"]
            check(n > 0 and matched >= FQ_MATCH_SHARE * n
                  and abs(counts[0] - counts[1])
                  <= FQ_COUNT_SHARE * max(counts),
                  f"recipes_kitti {name} {tag}: {matched}/{n} detections "
                  f"matched, counts {counts}")
            row.update(map_err=map_err, detections=n, matched=matched,
                       worst=worst, map_tolerance=f"max|k-p| <= "
                       f"{KITTI_MAP_RTOL} * max(1, max|p|)")
        summary[f"{name} {tag}"] = row
        emit("recipes_kitti", dtype="f32", mode=mode(), batch=BATCH, **row)
        del m
    strict_f32(False)
    return summary



# ================================================================ training
# the gradient checks: loss within 1e-5 relative, every parameter's gradient
# within 1e-4 of its tensor's largest |g|, BN running statistics within 1e-5
# (of max(1, their scale)).  A whole QAT (8-bit fake-quant) step is
# ill-conditioned: a last-bit difference can move an activation across a
# rounding boundary, and the gradients with it (readings in PERF.md, from
# tests/test_torch_port_train_step.py): loss within 2e-2, the gradients'
# cosine >= 0.95 and relative L2 <= 0.35, above every reading; each conv's
# kernel launches in the QAT step are held at 1e-5 of their plain versions
# on their own operands (hold_conv_launches)
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "stats": 1e-5}
QAT_TOL = {"loss": 2e-2, "cos": 0.95, "rel_l2": 0.35, "stats": 1e-3}
TRAIN_EPOCHS = 2
TINY_STEPS = 8
QAT_STEPS = 4
# from the trained fixture: momentum SGD (Adam's first updates move every
# weight by about +-lr, which undoes a trained model)
QAT_OPTIM = {"OPTIMIZER": "sgd", "LR": 0.003, "MOMENTUM": 0.9,
             "WEIGHT_DECAY": 0.01, "GRAD_NORM_CLIP": 10}


@contextlib.contextmanager
def recording_backward(model):
    """While open, each sparse conv's backward under autograd (which runs
    on as it does) also appends (conv name, features, weight, book,
    out_valid, inverse book, grad_out) to the list it yields: the inputs
    of the model's kernel-1 launches for the forward and the input
    gradient."""
    from q3d_tpu_torch.ops.spconv import gather_conv
    names = {p.data_ptr(): n for n, p in model.named_parameters()}
    recorded = []
    real_bwd = gather_conv._GatherConvFn.backward

    def capture(ctx, grad_out):
        f, w, idx, _, ov = ctx.saved_tensors
        recorded.append((names.get(w.data_ptr(), "?"), f.detach(), w.detach(),
                         idx, ov, ctx.inverse(), grad_out.detach()))
        return real_bwd(ctx, grad_out)
    gather_conv._GatherConvFn.backward = staticmethod(capture)
    try:
        yield recorded
    finally:
        gather_conv._GatherConvFn.backward = staticmethod(real_bwd)


def compare_training(mk, mp, loss_k, loss_p, qat=False, zero_extra=()):
    """The kernels' training step (``mk``) against the plain versions'
    (``mp``), after the same step from the same state: loss, every
    parameter's gradient, every BN's running statistics -> summary dict;
    raises past the tolerances (``TRAIN_TOL``, or ``QAT_TOL``).  The
    biases before a train-mode BN and ``zero_extra`` have gradient 0 in
    exact arithmetic and are held below 1e-5 of the model's largest."""
    import torch
    from q3d_tpu_torch.train_utils import biases_before_bn
    zero = biases_before_bn(mk) | set(zero_extra)
    pk, pp = dict(mk.named_parameters()), dict(mp.named_parameters())
    top = max(float(p.grad.abs().max()) for p in pp.values())
    worst, num, den, dot, nk = (0.0, ""), 0.0, 0.0, 0.0, 0.0
    for name, p in pp.items():
        gk, gp = pk[name].grad, p.grad
        check(gk is not None and bool(torch.isfinite(gk).all()),
              f"{name}: kernels' gradient missing or not finite")
        err, scale = float((gk - gp).abs().max()), float(gp.abs().max())
        if name in zero:
            check(max(scale, float(gk.abs().max())) <= 1e-5 * top,
                  f"{name}: a bias before a train-mode BN has gradient "
                  f"{scale} (largest of the model {top})")
            continue
        num += float((gk - gp).double().pow(2).sum())
        den += float(gp.double().pow(2).sum())
        dot += float((gk.double() * gp.double()).sum())
        nk += float(gk.double().pow(2).sum())
        rel = err / max(scale, 1e-30)
        if not qat:
            check(err <= TRAIN_TOL["grad"] * scale,
                  f"{name}: gradient kernels vs plain {err} (scale {scale})")
        worst = max(worst, (rel, name))
    rel_l2, cos = (num / den) ** 0.5, dot / (den * nk) ** 0.5
    tol = QAT_TOL if qat else TRAIN_TOL
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_rel <= tol["loss"], f"loss kernels {loss_k} vs plain {loss_p}")
    if qat:
        check(cos >= QAT_TOL["cos"] and rel_l2 <= QAT_TOL["rel_l2"],
              f"QAT gradients: cosine {cos}, relative L2 {rel_l2}")
    bk, bp = dict(mk.named_buffers()), dict(mp.named_buffers())
    stats_err = 0.0
    for name, b in bp.items():
        if name.endswith(("running_mean", "running_var")):
            e = float((bk[name] - b).abs().max()) \
                / max(1.0, float(b.abs().max()))
            check(e <= tol["stats"], f"{name}: kernels vs plain {e}")
            stats_err = max(stats_err, e)
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_err": loss_rel, "grad_worst_rel": worst[0],
            "grad_worst_param": worst[1], "grad_rel_l2": rel_l2,
            "grad_cosine": cos, "bn_stats_worst": stats_err,
            "zero_grad_biases": len(zero), "params": len(pp)}


FIRST_CONV = "backbone_3d.conv_input.0.weight"     # its input takes no dX


def kernel1_convs(model, two_d=False):
    """Names of the model's sparse convs that run on kernel 1 (every
    SubMConv / SparseConv but the 1x1 SubM convs of the pointwise route);
    only the 2D ones with ``two_d``."""
    from q3d_tpu_torch.ops.spconv.modules import (SparseConv2d, SparseConv3d,
                                                  SparseInverseConv3d,
                                                  SubMConv2d, SubMConv3d)
    kinds = (SubMConv2d, SparseConv2d) if two_d else (
        SubMConv3d, SparseConv3d, SparseInverseConv3d, SubMConv2d,
        SparseConv2d)
    return [n for n, mod in model.named_modules()
            if isinstance(mod, kinds) and not mod.pointwise]


def train_grad(model, batch, conv_k, mode, tag="train_grad", config=CFG.name,
               convs=21, zero_extra=(), dx_convs=None):
    """Phase ``train_grad`` (and ``train_kitti_grad``, ``train_grad_*``):
    one training forward and backward of ``model`` (seeded weights, f32,
    TF32 off) through the kernels and through the plain versions on the
    same batch, held by ``compare_training``; kernel-1 launches of the
    step, forward and input gradient apart, the 2D books' dX launches
    counted apart too (``convs`` forward; every sparse conv on kernel 1
    but conv_input, whose input takes no gradient, launches a dX, or
    ``dx_convs`` of them: PillarNet's first conv takes its input's
    gradient, the VFE's); every
    such conv's weight gets a gradient; peak memory of each step.  -> (the
    kernels' backward calls: (conv name, features, weight, book, out_valid,
    inverse book, grad_out) each, the kernels' run).  ``zero_extra``: as
    in ``compare_training``."""
    import numpy as np
    import torch
    mk, mp = copy.deepcopy(model), copy.deepcopy(model)
    out = {}
    for impl, m in (("cuda", mk), ("plain", mp)):
        m.set_kernel_impl(impl)
        m.train()
        conv_k.launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = m(dict(batch))
        fwd = sum(conv_k.launches.values())
        if impl == "cuda":
            with recording_backward(mk) as recorded:
                res["loss"].backward()
        else:
            res["loss"].backward()
        torch.cuda.synchronize()
        out[impl] = {"loss": float(res["loss"].detach()),
                     "step_ms": (time.perf_counter() - t0) * 1e3,
                     "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                     "launches_forward": fwd,
                     "launches_dx": sum(conv_k.launches.values()) - fwd,
                     "launches_by_entry": dict(conv_k.launches),
                     "tb": {k: float(v.detach())
                            for k, v in res["tb_dict"].items()}}
        m.set_kernel_impl(None)
    sparse = kernel1_convs(mk)
    two_d = kernel1_convs(mk, two_d=True)
    out["cuda"]["launches_dx_2d"] = sum(r[0].rsplit(".", 1)[0] in two_d
                                        for r in recorded)
    dx_convs = max(convs - 1, 0) if dx_convs is None else dx_convs
    check(len(sparse) == convs and out["cuda"]["launches_forward"] == convs
          and out["cuda"]["launches_dx"] == dx_convs
          and set(out["cuda"]["launches_by_entry"])
          <= {"q3d_sparse_gather_conv_f32"},
          f"{tag} {config}: kernel-1 launches {out['cuda']}")
    check(out["plain"]["launches_forward"] == out["plain"]["launches_dx"] == 0,
          f"{tag} {config}: plain run launched {out['plain']}")
    check(all(np.isfinite(r["loss"]) for r in out.values()),
          f"{tag} {config}: losses {out}")
    pk = dict(mk.named_parameters())
    for n in sparse:
        g = pk[f"{n}.weight"].grad
        check(g is not None and bool(g.abs().max() > 0),
              f"{tag}: {n}.weight has no gradient")
    first = 0 if dx_convs == convs else min(convs, 1)    # conv_input's
    check(len(recorded) == convs
          and sum(r[0] == FIRST_CONV for r in recorded) == first,
          f"{tag}: {len(recorded)} sparse conv backward calls")
    summary = compare_training(mk, mp, out["cuda"]["loss"],
                               out["plain"]["loss"], zero_extra=zero_extra)
    emit(tag, config=config, batch=int(batch["gt_boxes"].shape[0]),
         dtype="f32", mode=mode(), kernels=out["cuda"], plain=out["plain"],
         sparse_convs=len(sparse), sparse_convs_2d=len(two_d),
         tolerance=TRAIN_TOL,
         peak_covers="three model copies on the card; the kernels' run also "
         "keeps every conv's backward inputs", **summary)
    return recorded, out["cuda"]


def summed_apart(rows, part):
    """The rows of ``kernel_dx`` / ``kernel_forward`` whose conv name holds
    ``part``, summed: times, bounds, launches, the worst error."""
    mine = [r for r in rows if part in r["conv"]]
    out = {k: sum(r[k] for r in mine) for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")}
    out.update(convs=len(mine), max_abs_err=max(r["max_abs_err"]
                                                for r in mine),
               bound_by="bytes" if out["bytes_ms"] >= out["ops_ms"]
               else "operations")
    return out


def kernel_dx(recorded, flush, mode, tag="kernel_dx", config=CFG.name,
              apart=None):
    """Phase ``kernel_dx`` (and ``kernel_dx_second``): kernel 1's f32 entry
    as the input gradient of each sparse conv of a training step (the
    inverse book, the
    weights transposed per tap, the step's real output gradient), against
    its plain version (within 1e-5 of the largest |dX|), timed beside it,
    beside gather + ``torch.matmul`` (the library call of the same
    product) and beside its bound; the weight gradient's torch time
    (``engine.weight_grad``) and the inverse book's build beside them;
    ``apart``: the convs whose name holds it summed apart too
    (``totals["apart"]``).  -> totals."""
    import torch
    from q3d_tpu_torch.ops.spconv import engine, gather_conv
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bytes_ms", "ops_ms", "dw_ms", "inverse_ms")}
    worst = 0.0
    rows = []
    with torch.no_grad():
        for name, f, w, idx, ov, inv, grad_out in recorded:
            if name == FIRST_CONV:
                continue                       # its input takes no gradient
            n, cin = f.shape
            m, k = idx.shape
            cout = w.shape[2]
            g = grad_out.float()
            if ov is not None:
                g = g * ov.reshape(-1, 1).float()
            g = g.contiguous()
            wt = w.transpose(1, 2).contiguous()
            dk = gather_conv.gather_conv_cuda(g, inv, wt)
            dp = gather_conv.gather_conv_plain(g, inv, wt)
            torch.cuda.synchronize()
            err, scale = float((dk - dp).abs().max()), float(dp.abs().max())
            check(err <= 1e-5 * scale, f"{name} dX: kernel vs plain {err} "
                                       f"(scale {scale})")
            worst = max(worst, err)
            present = inv >= 0
            n_present = int(present.sum())
            rows_read = int(torch.unique(inv[present]).numel())
            flat = torch.cat([g, g.new_zeros((1, cout))])
            safe = torch.where(present, inv.long(), m).reshape(-1)
            w2 = wt.reshape(k * cout, cin)
            row = {"conv": name, "N": n, "M": m, "K": k, "Cin": cin,
                   "Cout": cout, "present_taps": n_present,
                   "max_abs_err": err, "scale": scale,
                   "ms": time_ms(lambda: gather_conv.gather_conv_cuda(
                       g, inv, wt), flush=flush),
                   "plain_ms": time_ms(lambda: gather_conv.gather_conv_plain(
                       g, inv, wt), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch.matmul(
                       flat[safe].reshape(n, k * cout), w2), flush=flush),
                   "dw_ms": time_ms(lambda: engine.weight_grad(f, idx, g),
                                    reps=5, flush=flush),
                   "inverse_ms": time_ms(lambda: engine.inverse_book(idx, n),
                                         flush=flush)}
            # the rows of dOut' the inverse book uses, the book, the
            # transposed weights read once, dX written once; the present
            # taps' operations on the CUDA cores (f32)
            nbytes = (rows_read * cout + k * cout * cin + n * cin) * 4 \
                + n * k * 4
            row["bytes_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
            row["ops_ms"] = 1e3 * 2.0 * n_present * cin * cout \
                / PEAK_OPS_PER_S["f32"]
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            emit(tag, **row)
            rows.append(row)
            for key in totals:
                totals[key] += row[key]
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] \
        else "operations"
    if apart is not None:
        totals["apart"] = summed_apart(rows, apart)
        emit(f"{tag}_apart", convs_named=apart, config=config,
             **totals["apart"])
    emit(f"{tag}_total", config=config, convs=len(rows), dtype="f32",
         mode=mode(), max_abs_err=worst, **totals,
         tolerance="max|k-p| <= 1e-5 * max|p| per conv",
         library="gather of dOut' by the inverse book + torch.matmul",
         dw="engine.weight_grad: per tap, gather + f32 torch.matmul")
    totals["max_abs_err"] = worst
    return totals


def kernel_forward(recorded, flush, mode, tag, config, apart=None):
    """Phase ``kernel_fwd_second``: kernel 1's f32 entry as each sparse
    conv's forward in a training step, on the operands
    ``recording_backward`` kept (features, book, weights, row mask),
    against its plain version (within 1e-5 of the largest |out|), timed
    beside it, beside gather + ``torch.matmul`` and beside its bound (the
    rows the book uses, the book and the weights read once, the output
    written once; the present taps' f32 operations on the CUDA cores);
    ``apart`` as in ``kernel_dx`` -> totals."""
    import torch
    from q3d_tpu_torch.ops.spconv import gather_conv
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bytes_ms", "ops_ms")}
    worst = 0.0
    rows = []
    with torch.no_grad():
        for name, f, w, idx, ov, _, _ in recorded:
            n, cin = f.shape
            m, k = idx.shape
            cout = w.shape[2]
            yk = gather_conv.gather_conv_cuda(f, idx, w, None, ov)
            yp = gather_conv.gather_conv_plain(f, idx, w, None, ov)
            torch.cuda.synchronize()
            err, scale = float((yk - yp).abs().max()), float(yp.abs().max())
            check(err <= 1e-5 * scale, f"{name} forward: kernel vs plain "
                                       f"{err} (scale {scale})")
            worst = max(worst, err)
            present = (idx >= 0) & (idx < n)
            n_present = int(present.sum())
            rows_read = int(torch.unique(idx[present]).numel())
            flat = torch.cat([f, f.new_zeros((1, cin))])
            safe = torch.where(present, idx.long(), n).reshape(-1)
            w2 = w.reshape(k * cin, cout)
            row = {"conv": name, "N": n, "M": m, "K": k, "Cin": cin,
                   "Cout": cout, "present_taps": n_present,
                   "max_abs_err": err, "scale": scale,
                   "ms": time_ms(lambda: gather_conv.gather_conv_cuda(
                       f, idx, w, None, ov), flush=flush),
                   "plain_ms": time_ms(lambda: gather_conv.gather_conv_plain(
                       f, idx, w, None, ov), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch.matmul(
                       flat[safe].reshape(m, k * cin), w2), flush=flush)}
            nbytes = (rows_read * cin + k * cin * cout + m * cout) * 4 \
                + m * k * 4
            row["bytes_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
            row["ops_ms"] = 1e3 * 2.0 * n_present * cin * cout \
                / PEAK_OPS_PER_S["f32"]
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            emit(tag, **row)
            rows.append(row)
            for key in totals:
                totals[key] += row[key]
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] \
        else "operations"
    if apart is not None:
        totals["apart"] = summed_apart(rows, apart)
        emit(f"{tag}_apart", convs_named=apart, config=config,
             **totals["apart"])
    emit(f"{tag}_total", config=config, convs=len(recorded), dtype="f32",
         mode=mode(), max_abs_err=worst, **totals,
         tolerance="max|k-p| <= 1e-5 * max|p| per conv",
         library="gather of the rows by the book + torch.matmul")
    totals["max_abs_err"] = worst
    return totals


def timed_train_model(model, optim, ds, loader, ckpt_dir, conv_k, dev,
                      tag, epochs=TRAIN_EPOCHS, no_signal=(), any_step=False):
    """The port's ``train_model`` as a user calls it, with hooks outside it
    that take each step's numbers: host ms (the loader's time, from the
    run's history, with the scene synthesis and the data augmentor timed
    around ``ds.scene`` and ``ds.data_augmentor.forward`` apart), device ms
    between CUDA events that a forward pre-hook and a forward hook on the
    model, each parameter's post-accumulate-grad hook (the last marks the
    backward's end) and a step post-hook on the torch optimizer record:
    forward, backward, and optimizer (both clips and the update); the
    input-gradient kernels' ms and the weight gradients' ms summed (CUDA
    events around each call between the forward's end and the update),
    peak memory, and the memory already allocated when the step starts
    (the model, the optimizer's state, and whatever earlier phases keep on
    the card).  Kernel-1 launch counts are zeroed just before and read just
    after.  Losses finite, every parameter a nonzero gradient (but the
    biases before a train-mode BN, whose gradient is 0, and ``no_signal``:
    parameters whose gradient is 0 on these scenes) in the last step, or,
    with ``any_step``, in some step of the run (an L1 loss gives a bias
    gradient 0 on a step where its terms' signs balance; the flags are
    taken on the card after each step's timed region).  Emits
    ``<tag>_step`` per step -> (optimizer, steps, launches, run_s)."""
    import numpy as np
    import torch
    from q3d_tpu_torch import train_utils
    from q3d_tpu_torch.ops.spconv import gather_conv
    from torch.optim.optimizer import register_optimizer_step_post_hook

    host = {"scene_ms": 0.0, "augment_ms": 0.0}
    cur, steps = {}, []
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    nonzero = torch.zeros(len(named), dtype=torch.bool, device=dev)
    in_bwd, dx_events, dw_events = [False], [], []
    real_cuda, real_wg = gather_conv.gather_conv_cuda, gather_conv.weight_grad
    augmentor = getattr(ds, "data_augmentor", None)

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def host_timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[key] += (time.perf_counter() - t0) * 1e3
        return run

    def timed(fn, store, when=lambda: True):
        def run(*a, **kw):
            if not when():
                return fn(*a, **kw)
            start = event()
            out = fn(*a, **kw)
            store.append((start, event()))
            return out
        return run

    def forward_starts(module, args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dx_events.clear()
        dw_events.clear()
        cur.clear()
        cur.update(resident=torch.cuda.memory_allocated() / 2 ** 20,
                   launches=sum(conv_k.launches.values()), host=dict(host),
                   start=event())
        host.update(scene_ms=0.0, augment_ms=0.0)

    def forward_ends(module, args, out):
        cur["forward_end"] = event()
        cur["launches_forward"] = sum(conv_k.launches.values()) \
            - cur["launches"]
        in_bwd[0] = True

    def grad_accumulated(param):
        cur["backward_end"] = event()      # the last parameter's counts

    def optimizer_stepped(optimizer, args, kwargs):
        in_bwd[0] = False
        end = event()
        torch.cuda.synchronize()
        steps.append({
            "step": len(steps) + 1, **cur["host"],
            "forward_ms": cur["start"].elapsed_time(cur["forward_end"]),
            "backward_ms": cur["forward_end"].elapsed_time(
                cur["backward_end"]),
            "optimizer_ms": cur["backward_end"].elapsed_time(end),
            "dx_kernel_ms": sum(a.elapsed_time(b) for a, b in dx_events),
            "dw_ms": sum(a.elapsed_time(b) for a, b in dw_events),
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "resident_mib": cur["resident"],
            "launches_forward": cur["launches_forward"],
            "launches_dx": sum(conv_k.launches.values()) - cur["launches"]
            - cur["launches_forward"]})
        nonzero.logical_or_(torch.stack([
            p.grad.ne(0).any() if p.grad is not None
            else nonzero.new_zeros(()) for _, p in named]))

    hooks = [model.register_forward_pre_hook(forward_starts),
             model.register_forward_hook(forward_ends),
             register_optimizer_step_post_hook(optimizer_stepped)]
    hooks += [p.register_post_accumulate_grad_hook(grad_accumulated)
              for p in model.parameters() if p.requires_grad]
    ds.scene = host_timed(ds.scene, "scene_ms")
    if augmentor is not None:
        augmentor.forward = host_timed(augmentor.forward, "augment_ms")
    gather_conv.gather_conv_cuda = timed(real_cuda, dx_events,
                                         lambda: in_bwd[0])
    gather_conv.weight_grad = timed(real_wg, dw_events)
    conv_k.launches.clear()
    t0 = time.perf_counter()
    try:
        optimizer, history = train_utils.train_model(
            model, optim, loader, ckpt_dir, total_epochs=epochs, device=dev)
    finally:
        launches = dict(conv_k.launches)
        del ds.scene
        if augmentor is not None:
            del augmentor.forward
        gather_conv.gather_conv_cuda, gather_conv.weight_grad = real_cuda, \
            real_wg
        for h in hooks:
            h.remove()
    run_s = time.perf_counter() - t0
    n_steps = epochs * len(loader)
    check(len(steps) == len(history) == n_steps,
          f"{tag}: {len(steps)} steps, expected {n_steps}")
    for st, h in zip(steps, history):
        # the loader's time before the step (train_model's data meter): the
        # scene's synthesis, the augmentor, then the rest of the data
        # pipeline and the copy to the card
        parts = {k[:-3]: st.pop(k) for k in ("scene_ms", "augment_ms")}
        parts["pipeline"] = h["data_s"] * 1e3 - sum(parts.values())
        st["host_ms"] = parts
        st["loss"] = h["loss"]
        emit(f"{tag}_step", **st)
    check(all(np.isfinite(s["loss"]) for s in steps), f"{tag}: losses")
    zero = train_utils.biases_before_bn(model)
    seen = dict(zip((n for n, _ in named), nonzero.tolist()))
    nograd = [n for n, p in model.named_parameters()
              if n not in zero and n not in no_signal and not (
                  seen[n] if any_step else p.grad is not None
                  and bool(p.grad.abs().max() > 0))]
    check(not nograd, f"{tag}: parameters without a gradient {nograd}")
    return optimizer, steps, launches, run_s


def median_after_first(steps):
    """Each step number's median over steps 2.., host ms summed."""
    med = {k: statistics.median(s[k] for s in steps[1:])
           for k in ("forward_ms", "backward_ms", "optimizer_ms",
                     "dx_kernel_ms", "dw_ms", "peak_mib", "resident_mib")}
    med["host_ms"] = statistics.median(sum(s["host_ms"].values())
                                       for s in steps[1:])
    return med


def train_ref(dev, conv_k, mode):
    """Phase ``train_ref``: the port's ``train_model`` at centerpoint_ref's
    width, batch 2, over the config's 8 frames for 2 epochs (8 steps), with
    centerpoint_tiny's OPTIMIZATION block (adam_onecycle, LR 0.003, WD
    0.01, clip 10; the ref config has none), on the kernels, PyTorch's
    default TF32 settings, timed by ``timed_train_model``.  Then a fresh
    model resumes from the run's last checkpoint, and its model and
    optimizer state must equal the trained ones exactly."""
    import shutil
    import numpy as np
    import torch
    from q3d_tpu_torch import train_utils
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network
    cfg = cfg_from_yaml_file(str(CFG), EDict())
    optim = cfg_from_yaml_file(str(TINY_CFG), EDict()).OPTIMIZATION
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=BATCH, training=True,
                                     seed=SEED)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    ckpt_dir = ROOT / "output" / "chip_smoke_train_ref"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    optimizer, steps, launches, run_s = timed_train_model(
        model, optim, ds, loader, ckpt_dir, conv_k, dev, "train_ref")
    n_steps = len(steps)
    check(launches == {"q3d_sparse_gather_conv_f32": 41 * n_steps},
          f"train_ref: launches {launches}")

    # resume: a fresh model and optimizer from the newest checkpoint
    fresh = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    opt2, hist2 = train_utils.train_model(fresh, optim, loader, ckpt_dir,
                                          total_epochs=TRAIN_EPOCHS,
                                          device=dev)
    check(not hist2, f"train_ref: resumed run took {len(hist2)} steps")
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        check(torch.equal(a, b), f"train_ref resume: model state {k} differs")
    sa, sb = optimizer.state_dict(), opt2.state_dict()
    check(sa["count"] == sb["count"] == n_steps, "train_ref resume: count")
    for i, st in sa["optimizer"]["state"].items():
        for k, v in st.items():
            check(torch.equal(torch.as_tensor(v), torch.as_tensor(
                sb["optimizer"]["state"][i][k]).to(torch.as_tensor(v).device)),
                f"train_ref resume: optimizer state {i}.{k} differs")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    med = median_after_first(steps)
    emit("train_ref", config=CFG.name, batch=BATCH, epochs=TRAIN_EPOCHS,
         steps=n_steps, optimization=dict(optim), mode=mode(),
         losses=[s["loss"] for s in steps], launches=launches,
         launches_per_step={"forward": steps[0]["launches_forward"],
                            "dx": steps[0]["launches_dx"]},
         run_s=run_s, median_after_first=med,
         resume="model and optimizer state equal after resume")
    return {"launches_dx": sum(s["launches_dx"] for s in steps),
            "launches_forward": sum(s["launches_forward"] for s in steps),
            "median": med}


def train_tiny(dev, mode):
    """Phase ``train_tiny``: centerpoint_tiny from its seeded init, 8 steps
    of Adam 3e-3 on one batch on the card (the JAX package's
    ``tests/test_training.py`` recipe, on CenterPoint): the loss falls by
    at least 10%."""
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.train_utils import MODEL_KEYS, train_step
    cfg = cfg_from_yaml_file(str(TINY_CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=BATCH, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    raw = next(iter(loader))
    batch = load_data_to_device({k: v for k, v in raw.items()
                                 if k in MODEL_KEYS}, device=dev)
    opt = build_optimizer(model.parameters(), EDict(
        {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.0}), TINY_STEPS)
    losses = [float(train_step(model, batch, opt)[0])
              for _ in range(TINY_STEPS)]
    check(losses[-1] < 0.9 * losses[0], f"train_tiny: losses {losses}")
    emit("train_tiny", config=TINY_CFG.name, batch=BATCH, mode=mode(),
         optimizer="adam, lr 3e-3, no weight decay, clip 10", losses=losses,
         fall=1 - losses[-1] / losses[0])


def hold_conv_launches(recorded):
    """Kernel 1 against its plain version on the operands that a training
    step's kernel launches had (``recording_backward``): each sparse conv's
    forward, and its input gradient over the inverse book (not
    conv_input's, whose input takes no gradient), within 1e-5 of the
    largest |value| of each -> {"convs", "forward_worst_rel",
    "dx_worst_rel"}."""
    import torch
    from q3d_tpu_torch.ops.spconv import gather_conv
    worst = {"forward": 0.0, "dx": 0.0}
    with torch.no_grad():
        for name, f, w, idx, ov, inv, grad_out in recorded:
            pairs = {"forward": (f, idx, w, None, ov)}
            if name != FIRST_CONV:
                g = grad_out.float()
                if ov is not None:
                    g = g * ov.reshape(-1, 1).float()
                pairs["dx"] = (g.contiguous(), inv,
                               w.transpose(1, 2).contiguous())
            for what, args in pairs.items():
                k = gather_conv.gather_conv_cuda(*args)
                p = gather_conv.gather_conv_plain(*args)
                err, scale = float((k - p).abs().max()), float(p.abs().max())
                check(err <= 1e-5 * scale, f"{name} {what}: kernel vs plain "
                                           f"{err} (scale {scale})")
                worst[what] = max(worst[what], err / max(scale, 1e-30))
    return {"convs": len(recorded), "forward_worst_rel": worst["forward"],
            "dx_worst_rel": worst["dx"]}


def qat_tiny(dev, conv_k, mode):
    """Phase ``qat_tiny``: the trained centerpoint_tiny fixture (read without
    JAX) under ``centerpoint_recipe()`` (dynamic SmoothQuant fake-quant),
    then QAT steps on the card (f32, TF32 off, ``QAT_OPTIM``): the first
    step through the kernels and through the plain versions held by
    ``compare_training`` at ``QAT_TOL``, and each of the kernels' launches
    in it (forward and input gradient, on the fake-quantized operands it
    had) at 1e-5 of its plain version; every quantized conv's weight
    (the 20 sparse ones and the dense ones the recipe quantizes) gets a
    finite, nonzero gradient; then 3 more steps through the kernels (4 in
    all), losses finite."""
    import numpy as np
    import torch
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.train_utils import MODEL_KEYS, train_step
    from q3d_tpu_torch.utils.checkpoint import load_params_from_file
    cfg = cfg_from_yaml_file(str(TINY_CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=BATCH, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    load_params_from_file(model, CKPT)
    raw = next(iter(loader))
    batch = load_data_to_device({k: v for k, v in raw.items()
                                 if k in MODEL_KEYS}, device=dev)
    quant_api.quantize_model(model, quant_api.centerpoint_recipe(), batch)
    check(not [n for n, _ in model.named_parameters()
               if "quant" in n or "amax" in n],
          "qat_tiny: a quantizer's state is a parameter")
    quantized = [n for n, m in model.named_modules()
                 if getattr(m, "rule", None) is not None
                 and getattr(m, "weight", None) is not None]
    n_sparse = sum(n.startswith("backbone_3d") for n in quantized)
    check(n_sparse == 20 and len(quantized) > n_sparse,
          f"qat_tiny: quantized convs {quantized}")
    runs = {}
    for tag in ("cuda", "plain"):
        m = copy.deepcopy(model)
        m.set_kernel_impl(tag)
        opt = build_optimizer(m.parameters(), EDict(QAT_OPTIM), QAT_STEPS)
        conv_k.launches.clear()
        with recording_backward(m) as recorded:
            loss = float(train_step(m, batch, opt)[0])
        runs[tag] = (m, opt, loss, sum(conv_k.launches.values()), recorded)
    mk, opt, loss_k, launches, recorded = runs["cuda"]
    check(launches == 41 and runs["plain"][3] == 0,
          f"qat_tiny: kernel-1 launches {launches} / {runs['plain'][3]}")
    layers = hold_conv_launches(recorded)
    grads = dict(mk.named_parameters())
    for n in quantized:
        g = grads[f"{n}.weight"].grad
        check(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0),
              f"qat_tiny: {n}.weight gradient")
    summary = compare_training(mk, runs["plain"][0], loss_k, runs["plain"][2],
                               qat=True)
    losses = [loss_k] + [float(train_step(mk, batch, opt)[0])
                         for _ in range(QAT_STEPS - 1)]
    check(all(np.isfinite(losses)), f"qat_tiny: losses {losses}")
    emit("qat_tiny", config=TINY_CFG.name, recipe="centerpoint_recipe()",
         batch=BATCH, mode=mode(), quantized_convs={
             "sparse": n_sparse, "dense": len(quantized) - n_sparse},
         launches_first_step=launches, losses=losses, tolerance=QAT_TOL,
         layers=layers, **summary)


# SECOND and PointPillars training at the KITTI configs' width: frames of
# each yaml's BATCH_SIZE_PER_GPU (4), kernel-1 launches a step forward
# (KITTI_CONVS), dX one fewer
KITTI_TRAIN_FRAMES = 8
OVERFIT_STEPS = 8
OVERFIT_OPTIM = {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.0}


def kitti_train_data(name, dev, frames, seed, augment=False, root=None):
    """The KITTI config ``name`` on a training SyntheticDataset of
    ``frames`` frames at its geometry (FOV-cropped, the 16,000-voxel train
    cap, points shuffled; the yaml's DATA_AUGMENTOR when ``augment``, its
    gt database under ``root``) and the model, seeded -> (cfg, ds, loader,
    model)."""
    import numpy as np
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.kitti_synthetic import kitti_config
    from q3d_tpu_torch.models import build_network
    cfg = kitti_config(name, frames, seed)
    if not augment:
        del cfg.DATA_CONFIG["DATA_AUGMENTOR"]
    np.random.seed(seed)
    ds, loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES,
        batch_size=int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), root_path=root,
        training=True, seed=seed)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    return cfg, ds, loader, model


def train_kitti_grad(dev, conv_k, mode):
    """Phase ``train_kitti_grad``: for SECOND and PointPillars at the KITTI
    configs' width, one batch of 4 training frames without augmentation
    (f32, TF32 off): one training forward and backward through the
    kernels and through the plain versions, held by ``train_grad`` (SECOND:
    12 kernel-1 launches forward and 11 as dX; PointPillars launches no
    kernel, and its loss must be finite); then ``train_overfit``: 8 Adam
    steps (LR 3e-3) of each seeded model on that batch, as the JAX
    package's ``tests/test_training.py`` takes them: the last loss below
    0.9 x the first.  -> {name: batch, seeded model, recorded backward
    calls, the kernels' run, losses}."""
    from q3d_tpu_torch.config import EDict
    from q3d_tpu_torch.models import load_data_to_device
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.train_utils import MODEL_KEYS, train_step
    out = {}
    for name, convs in KITTI_CONVS.items():
        cfg, ds, loader, model = kitti_train_data(name, dev, 4, SEED)
        raw = next(iter(loader))
        batch = load_data_to_device({k: v for k, v in raw.items()
                                     if k in MODEL_KEYS}, device=dev)
        recorded, run = train_grad(model, batch, conv_k, mode,
                                   "train_kitti_grad",
                                   f"kitti_models/{name}.yaml", convs)
        m = copy.deepcopy(model)
        opt = build_optimizer(m.parameters(), EDict(OVERFIT_OPTIM),
                              OVERFIT_STEPS)
        losses = [float(train_step(m, batch, opt)[0])
                  for _ in range(OVERFIT_STEPS)]
        check(losses[-1] < 0.9 * losses[0],
              f"train_overfit {name}: losses {losses}")
        emit("train_overfit", config=f"kitti_models/{name}.yaml",
             batch=len(raw["gt_boxes"]), mode=mode(),
             voxels=(raw["voxel_num_points"] > 0).sum(1).tolist(),
             voxel_cap=int(raw["voxel_num_points"].shape[1]),
             objects=(raw["gt_boxes"][..., 7] > 0).sum(1).tolist(),
             optimizer="adam, lr 3e-3, no weight decay, clip 10",
             losses=losses, fall=1 - losses[-1] / losses[0])
        del m, opt
        out[name] = {"batch": batch, "model": model, "recorded": recorded,
                     "run": run, "losses": losses}
    return out


def qat_kitti(kitti, conv_k, mode):
    """Phase ``qat_kitti``: each seeded KITTI model under its recipe
    (``second_recipe()``, ``pointpillar_recipe()``: dynamic SmoothQuant
    fake-quant), quantized on its ``train_kitti_grad`` batch, one QAT step
    (``QAT_OPTIM``, f32, TF32 off) through the kernels and through the
    plain versions: the whole step held by ``compare_training`` at
    ``QAT_TOL``, each kernel-1 launch of it (forward and dX, on the
    fake-quantized operands it had) at 1e-5 of its plain version
    (``hold_conv_launches``); every quantized conv's weight and the PFN's
    linear layers get finite, nonzero gradients."""
    import torch
    from q3d_tpu_torch.config import EDict
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.train_utils import train_step
    recipes = {"second": quant_api.second_recipe,
               "pointpillar": quant_api.pointpillar_recipe}
    for name, d in kitti.items():
        convs = KITTI_CONVS[name]
        model = copy.deepcopy(d["model"])
        quant_api.quantize_model(model, recipes[name](), d["batch"])
        check(not [n for n, _ in model.named_parameters()
                   if "quant" in n or "amax" in n],
              f"qat_kitti {name}: a quantizer's state is a parameter")
        quantized = [n for n, m in model.named_modules()
                     if getattr(m, "rule", None) is not None
                     and getattr(m, "weight", None) is not None]
        runs = {}
        for impl in ("cuda", "plain"):
            m = copy.deepcopy(model)
            m.set_kernel_impl(impl)
            opt = build_optimizer(m.parameters(), EDict(QAT_OPTIM), QAT_STEPS)
            conv_k.launches.clear()
            with recording_backward(m) as recorded:
                loss = float(train_step(m, d["batch"], opt)[0])
            runs[impl] = (m, loss, sum(conv_k.launches.values()), recorded)
        mk, loss_k, launches, recorded = runs["cuda"]
        check(launches == max(2 * convs - 1, 0) and runs["plain"][2] == 0,
              f"qat_kitti {name}: kernel-1 launches {launches} / "
              f"{runs['plain'][2]}")
        layers = hold_conv_launches(recorded)
        params = dict(mk.named_parameters())
        watched = [f"{n}.weight" for n in quantized] + [
            n for n in params if n.startswith("vfe.") and n.endswith(
                "linear.weight")]
        for n in watched:
            g = params[n].grad
            check(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0),
                  f"qat_kitti {name}: {n} gradient")
        summary = compare_training(mk, runs["plain"][0], loss_k,
                                   runs["plain"][1], qat=True)
        emit("qat_kitti", config=f"kitti_models/{name}.yaml",
             recipe=f"{recipes[name].__name__}()",
             batch=int(d["batch"]["voxels"].shape[0]), mode=mode(),
             quantized_convs=len(quantized), launches_step=launches,
             tolerance=QAT_TOL, layers=layers, **summary)


def train_kitti(dev, conv_k, nms_k, mode):
    """Phase ``train_kitti``: ``train_model`` for SECOND and PointPillars
    at the KITTI configs' width on 8 synthetic KITTI frames at batch 4, 2
    epochs (4 steps), with each yaml's OPTIMIZATION (adam_onecycle, LR
    0.003, clip 10) and its whole DATA_AUGMENTOR: ``gt_sampling`` reads a
    database that ``write_gt_database`` writes to a temporary directory
    from 8 frames of another seed, then the x flip, the rotation and the
    scaling run as configured.  Timed by ``timed_train_model`` (host,
    forward, backward and optimizer ms a step, peak memory, losses);
    objects placed by gt_sampling per frame and positive anchors per class
    per frame are recorded, and the sampler must place objects in every
    frame, and every class present in a frame must have positives.  Kernel
    launches: SECOND 12 forward and 11 dX a step, PointPillars none, no
    NMS.  -> {name: launches forward / dx, medians}."""
    import tempfile
    import torch
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.augmentor.database_sampler import \
        DataBaseSampler
    from q3d_tpu_torch.datasets.kitti_synthetic import (kitti_config,
                                                        write_gt_database)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, convs in KITTI_CONVS.items():
            root = Path(tmp) / name
            written = write_gt_database(build_dataloader(
                kitti_config(name, KITTI_TRAIN_FRAMES, SEED + 1).DATA_CONFIG,
                kitti_config(name, 1, SEED).CLASS_NAMES, 1,
                training=False)[0], root)
            cfg, ds, loader, model = kitti_train_data(
                name, dev, KITTI_TRAIN_FRAMES, SEED, augment=True, root=root)
            queue = ds.data_augmentor.data_augmentor_queue
            check([type(q).__name__ if isinstance(q, DataBaseSampler)
                   else q.func.__name__ for q in queue]
                  == ["DataBaseSampler", "random_world_flip",
                      "random_world_rotation", "random_world_scaling"],
                  f"train_kitti {name}: augmentor queue {queue}")
            placed, assigned = [], []
            sampler = queue[0]

            def counting(data_dict=None, sampler=sampler):
                n0 = len(data_dict["gt_boxes"])
                data_dict = sampler(data_dict=data_dict)
                placed.append(len(data_dict["gt_boxes"]) - n0)
                return data_dict
            queue[0] = counting
            head = model.dense_head
            real_assign = head.assign_targets

            def assign(gt_boxes, real_assign=real_assign):
                t = real_assign(gt_boxes)
                classes = torch.arange(1, len(cfg.CLASS_NAMES) + 1,
                                       device=gt_boxes.device)
                assigned.append((
                    (t["box_cls_labels"][:, :, None] == classes).sum(1),
                    (gt_boxes[:, :, 7:8] == classes).sum(1)))
                return t
            head.assign_targets = assign
            nms_k.launches.clear()
            try:
                _, steps, launches, run_s = timed_train_model(
                    model, cfg.OPTIMIZATION, ds, loader,
                    Path(tmp) / f"ckpt_{name}", conv_k, dev, "train_kitti")
            finally:
                del head.assign_targets
            n_steps = len(steps)
            want = {"q3d_sparse_gather_conv_f32": (2 * convs - 1) * n_steps} \
                if convs else {}
            check(launches == want and not any(nms_k.launches.values()),
                  f"train_kitti {name}: launches {launches}, NMS "
                  f"{dict(nms_k.launches)}")
            positives = torch.cat([a for a, _ in assigned]).tolist()
            present = torch.cat([b for _, b in assigned]).tolist()
            check(len(placed) == KITTI_TRAIN_FRAMES * 2 and min(placed) > 0,
                  f"train_kitti {name}: gt_sampling placed {placed}")
            check(all(p > 0 for pos, pres in zip(positives, present)
                      for p, n in zip(pos, pres) if n),
                  f"train_kitti {name}: a class present without positives: "
                  f"{list(zip(present, positives))}")
            med = median_after_first(steps)
            emit("train_kitti", config=f"kitti_models/{name}.yaml",
                 batch=int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU),
                 frames=KITTI_TRAIN_FRAMES, epochs=TRAIN_EPOCHS,
                 steps=n_steps, mode=mode(),
                 optimization={k: cfg.OPTIMIZATION[k] for k in (
                     "OPTIMIZER", "LR", "WEIGHT_DECAY", "GRAD_NORM_CLIP")},
                 augmentor=[c.NAME for c in
                            cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST],
                 gt_database=written, placed_per_frame=placed,
                 classes=list(cfg.CLASS_NAMES),
                 gt_per_class_per_frame=present,
                 positives_per_class_per_frame=positives,
                 losses=[s["loss"] for s in steps], launches=launches,
                 run_s=run_s, median_after_first=med)
            out[name] = {
                "launches_forward": sum(s["launches_forward"] for s in steps),
                "launches_dx": sum(s["launches_dx"] for s in steps),
                "median": med}
            del model
    return out


# =============================================================== VoxelNeXt
# the nuScenes VoxelNeXt config (MODEL and CLASS_NAMES as written) on
# centerpoint_ref's scenes (the same nuScenes geometry); its tiny config
# for the double-flip phase
VN_CFG = ROOT / "tools" / "cfgs" / "nuscenes_models" / \
    "cbgs_voxel0075_voxelnext.yaml"
VN_TINY_CFG = ROOT / "tools" / "cfgs" / "synthetic_models" / \
    "voxelnext_tiny.yaml"
# per forward at full width: kernel 1 (30 3D convs, conv_out, shared_conv),
# the 1x1 head convs on the pointwise route (6 heads x 6 branches x 2),
# kernel 2's candidate sets (6 heads x BATCH) in one launch
VN_CONVS, VN_POINTWISE, VN_HEADS, VN_BRANCHES = 32, 72, 6, 6
# the 3D convs of conv5 and conv6 (listed apart in kernel_conv_voxelnext)
VN_DEEP = ("backbone_3d.conv5.", "backbone_3d.conv6.")
VN_2D = ("backbone_3d.conv_out.", "backbone_3d.shared_conv.")


def nuscenes_model(dev, cfg_path, scenes=CFG, **head_cfg):
    """A model with ``cfg_path``'s MODEL and CLASS_NAMES (``head_cfg`` set
    on its DENSE_HEAD) on the synthetic scenes of ``scenes`` (seeded
    weights) -> (config, dataset, model)."""
    import dataclasses
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network
    from q3d_tpu_torch.models.builder import dataset_info
    vcfg = cfg_from_yaml_file(str(cfg_path), EDict())
    scfg = cfg_from_yaml_file(str(scenes), EDict())
    vcfg.MODEL.DENSE_HEAD.update(head_cfg)
    ds, _, _ = build_dataloader(scfg.DATA_CONFIG, scfg.CLASS_NAMES,
                                batch_size=BATCH, training=False)
    info = dataclasses.replace(dataset_info(ds),
                               class_names=tuple(vcfg.CLASS_NAMES))
    model = build_network(vcfg.MODEL, len(vcfg.CLASS_NAMES), info, device=dev)
    return vcfg, ds, model


def voxelnext_model(dev, cfg_path=VN_CFG, scenes=CFG, double_flip=False):
    """VoxelNeXt with ``cfg_path``'s MODEL and CLASS_NAMES on the synthetic
    scenes of ``scenes`` (seeded weights) -> (config, dataset, model)."""
    return nuscenes_model(dev, cfg_path, scenes, DOUBLE_FLIP=double_flip)


def voxelnext_stage_times(model, batch, reps=5):
    """CUDA-event time of each stage of one VoxelNeXt forward, median of
    ``reps`` -> {stage: ms}: vfe; backbone_3d (conv_input to conv6);
    merge_pool (dequantize, upscale, concatenate and ``bev_sum_pool``; the
    pool alone as bev_sum_pool); conv_out + shared_conv; head_convs; decode
    (top-K); nms; forward (all of it)."""
    import torch
    from q3d_tpu_torch.models.backbones_3d import spconv_backbone_voxelnext as vn
    bb, head = model.backbone_3d, model.dense_head
    events = {}

    def mark(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name] = ev
        return hook
    hooks = []
    for mod, pre, post in ((model.vfe, "vfe0", "vfe1"),
                           (bb.conv_input, "bb0", None),
                           (bb.conv6[-1], None, "bb1"),
                           (bb.conv_out, "bev0", None),
                           (bb.shared_conv, None, "bev1"),
                           (head.heads_list[0], "head0", None),
                           (head.heads_list[-1], None, "head1")):
        if pre:
            hooks.append(mod.register_forward_pre_hook(mark(pre)))
        if post:
            hooks.append(mod.register_forward_hook(mark(post)))

    def timed(fn, a, b):
        def run(*args, **kw):
            mark(a)()
            out = fn(*args, **kw)
            mark(b)()
            return out
        return run
    real_pool = vn.bev_sum_pool
    vn.bev_sum_pool = timed(real_pool, "pool0", "pool1")
    head._decode = timed(head._decode, "dec0", "dec1")
    head._nms = timed(head._nms, "nms0", "nms1")
    spans = {"vfe": ("vfe0", "vfe1"), "backbone_3d": ("bb0", "bb1"),
             "merge_pool": ("bb1", "bev0"), "bev_sum_pool": ("pool0", "pool1"),
             "conv_out_shared_conv": ("bev0", "bev1"),
             "head_convs": ("head0", "head1"), "decode": ("dec0", "dec1"),
             "nms": ("nms0", "nms1"), "forward": ("vfe0", "nms1")}
    ms = {k: [] for k in spans}
    try:
        with torch.no_grad():
            for _ in range(reps):
                events.clear()
                model(dict(batch))
                torch.cuda.synchronize()
                for k, (a, b) in spans.items():
                    ms[k].append(events[a].elapsed_time(events[b]))
    finally:
        vn.bev_sum_pool = real_pool
        del head._decode, head._nms
        for h in hooks:
            h.remove()
    return {k: statistics.median(v) for k, v in ms.items()}


def voxelnext_launches(conv_k, nms_k, sets):
    """kernel_launches plus the pointwise route and kernel 2's sets."""
    from q3d_tpu_torch.models import layers as dense_layers
    from q3d_tpu_torch.ops.spconv.modules import POINTWISE_CALLS
    out = kernel_launches(conv_k, nms_k)
    out.update(sparse_gather_conv=sum(conv_k.launches.values()),
               pointwise_float=POINTWISE_CALLS["float"],
               pointwise_int8=POINTWISE_CALLS["int8"],
               int_mm_pointwise=dense_layers.INT_MM_CALLS["sparse_pointwise"],
               nms_sets=list(sets))
    return out


@contextlib.contextmanager
def counting_nms_sets(sets):
    """Record the number of candidate sets of every boxes-form launch."""
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    real = nms_mod.greedy_suppress_boxes_cuda

    def seen(corners, *args, **kw):
        sets.append(int(corners.shape[0]))
        return real(corners, *args, **kw)
    nms_mod.greedy_suppress_boxes_cuda = seen
    try:
        yield
    finally:
        nms_mod.greedy_suppress_boxes_cuda = real


def clear_voxelnext_launches(conv_k, nms_k):
    from q3d_tpu_torch.ops.spconv.modules import POINTWISE_CALLS
    clear_launches(conv_k, nms_k)
    POINTWISE_CALLS.clear()


def voxelnext_kernels_vs_plain(model, batch, conv_k, nms_k, tag, frames,
                               strict=True):
    """One request through the kernels and through the plain versions ->
    (summary, kernel run's launches, kernel run's outputs).  Kernel 2 on
    identical candidates must give equal keep masks and ``_nms`` outputs.
    Always: the detections near at the FQ_* tolerances (a quantized
    model, where a last-bit difference flips a rounding and the flips grow
    through the layers, is held only to that, every launch of its kernels
    being held on its own operands).  ``strict`` (a float model): also the
    encoded rows and every branch map within 1e-4 of max(1, scale) (f32
    sums in another order) and 99% of the detections matched (box 1e-3,
    score 1e-4).  Whether the detections are equal is reported."""
    import torch
    from q3d_tpu_torch.eval_utils import to_host
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    head = model.dense_head
    outs, launches, sets = {}, {}, []
    with torch.no_grad(), counting_nms_sets(sets):
        for impl in ("cuda", "plain"):
            model.set_kernel_impl(impl)
            clear_voxelnext_launches(conv_k, nms_k)
            sets.clear()
            outs[impl] = model(dict(batch))
            torch.cuda.synchronize()
            launches[impl] = voxelnext_launches(conv_k, nms_k, sets)
        model.set_kernel_impl(None)
    check(not any(v for k, v in launches["plain"].items()
                  if not k.startswith("pointwise")),
          f"{tag}: the plain run launched {launches['plain']}")
    ok_, op = outs["cuda"], outs["plain"]
    maps = {"encoded": (ok_["encoded_spconv_tensor"].features,
                        op["encoded_spconv_tensor"].features)}
    for h, (pk, pp) in enumerate(zip(ok_["pred_dicts"], op["pred_dicts"])):
        for key in pk:
            maps[f"head{h}.{key}"] = (pk[key], pp[key])
    map_err = {}
    for key, (a, b) in maps.items():
        err, mag = float((a.float() - b.float()).abs().max()), \
            float(b.float().abs().max())
        map_err[key] = {"max_abs": err, "scale": mag}
        check(bool(torch.isfinite(a).all())
              and (not strict or err <= 1e-4 * max(1.0, mag)),
              f"{tag} {key}: kernels vs plain max err {err} (scale {mag})")
    nms_cfg = head.model_cfg.POST_PROCESSING.NMS_CONFIG
    thresh = float(nms_cfg.NMS_THRESH)
    with torch.no_grad():
        cand = head._candidates(ok_["encoded_spconv_tensor"], ok_["pred_dicts"])
        kc = min(int(nms_cfg.NMS_PRE_MAXSIZE), cand[0].shape[1])
        bx, bv = cand[0][:, :kc, :7].contiguous(), cand[3][:, :kc].contiguous()
        check(torch.equal(nms_mod.greedy_nms_boxes(bx, bv, thresh, impl="cuda"),
                          nms_mod.greedy_nms_boxes(bx, bv, thresh,
                                                   impl="plain")),
              f"{tag}: NMS keep masks differ on identical candidates")
        finals = []
        for impl in ("cuda", "plain"):
            head.kernel_impl = impl
            bd = {}
            head._nms(bd, *cand)
            finals.append(bd)
        head.kernel_impl = None
    for key in ("final_boxes", "final_scores", "final_labels", "final_valid"):
        check(torch.equal(finals[0][key], finals[1][key]),
              f"{tag}: {key} differs between NMS kernel and plain on "
              f"identical candidates")
    matched, total = matched_detections(ok_, op, frames)
    frac = matched / max(total, 1)
    check(total > 0 and (not strict or frac >= 0.99),
          f"{tag}: only {matched}/{total} detections matched")
    near = detections_near([to_host(ok_)], [to_host(op)], FQ_MIN_SCORE,
                           FQ_BOX_TOL, FQ_SCORE_TOL)
    counts = [int(ok_["final_valid"].sum()), int(op["final_valid"].sum())]
    check(near[0] > 0 and near[1] >= FQ_MATCH_SHARE * near[0]
          and abs(counts[0] - counts[1]) <= FQ_COUNT_SHARE * max(counts),
          f"{tag}: {near[1]}/{near[0]} detections near, counts {counts}")
    equal = all(torch.equal(ok_[k], op[k]) for k in (
        "final_boxes", "final_scores", "final_labels", "final_valid"))
    return ({"map_max_abs_err": map_err, "detections": total,
             "detections_matched": matched, "matched_fraction": frac,
             "detections_near_fq": {"scoring": near[0], "partnered": near[1],
                                    "worst_box_score": near[2]},
             "detections_equal": equal,
             "candidates_valid": cand[3].sum(1).tolist(),
             "candidate_sets": list(cand[3].shape)},
            launches["cuda"], ok_)


@contextlib.contextmanager
def recording_launches(calls):
    """Every launch of kernel 1's entries (with its operands) and of the
    pointwise ``_int_mm`` during the block -> ``calls`` [(entry, args,
    kwargs)]."""
    from q3d_tpu_torch.models import layers as dense_layers
    from q3d_tpu_torch.ops.spconv import gather_conv
    real = {"conv": gather_conv.gather_conv_cuda,
            "requant": gather_conv.gather_conv_requant_cuda,
            "int_mm": dense_layers.int8_matmul}

    def wrap(name):
        def run(*args, **kw):
            if name != "int_mm":
                calls.append((name, args, kw))
            elif kw.get("tag") == "sparse_pointwise":
                impl = args[2] if len(args) > 2 else kw.get("impl")
                if impl == "cuda" or impl is None and args[0].is_cuda:
                    calls.append((name, args[:2], {}))
            return real[name](*args, **kw)
        return run
    gather_conv.gather_conv_cuda = wrap("conv")
    gather_conv.gather_conv_requant_cuda = wrap("requant")
    dense_layers.int8_matmul = wrap("int_mm")
    try:
        yield
    finally:
        gather_conv.gather_conv_cuda = real["conv"]
        gather_conv.gather_conv_requant_cuda = real["requant"]
        dense_layers.int8_matmul = real["int_mm"]


def hold_launches_on_operands(calls, tag):
    """Each recorded launch against its plain version on its own operands:
    float entries within 1e-4 of max(1, scale) (summation order), s8, the
    fused requant entry and ``_int_mm`` exact -> {entry: launches, worst
    relative error}."""
    import torch
    from q3d_tpu_torch.models import layers as dense_layers
    from q3d_tpu_torch.ops.spconv import gather_conv
    counts, worst = {}, 0.0
    with torch.no_grad():
        for name, args, kw in calls:
            if name == "conv":
                k = gather_conv.gather_conv_cuda(*args, **kw)
                p = gather_conv.gather_conv_plain(*args, **kw)
                entry = f"conv_{str(args[0].dtype).split('.')[-1]}"
            elif name == "requant":
                k = gather_conv.gather_conv_requant_cuda(*args, **kw)
                p = gather_conv.gather_conv_requant_plain(*args, **kw)
                entry = "conv_s8_requant"
            else:
                a, b = args
                k = dense_layers.int8_matmul(a, b, "cuda", tag="held")
                p = dense_layers.int8_matmul(a, b, "plain")
                entry = "int_mm_pointwise"
            torch.cuda.synchronize()
            counts[entry] = counts.get(entry, 0) + 1
            if entry in ("conv_float32", "conv_bfloat16"):
                err = float((k.float() - p.float()).abs().max())
                scale = max(1.0, float(p.float().abs().max()))
                check(err <= 1e-4 * scale, f"{tag} {entry}: kernel vs plain "
                                           f"{err} (scale {scale})")
                worst = max(worst, err / scale)
            else:
                check(torch.equal(k, p), f"{tag} {entry}: kernel != plain")
    return {"launches_held": counts, "worst_float_rel": worst}


def voxelnext_phases(dev, conv_k, nms_k, mode, strict_f32, flush):
    """The VoxelNeXt phases (full width: the nuScenes config's MODEL on
    centerpoint_ref's scenes, batch 2, seeded weights, BN statistics from
    the first request): ``kernel_conv_voxelnext`` (kernel 1 on the 32 convs
    of one forward against the plain versions, timed; 3D, conv5/conv6 and
    2D apart), ``serving_voxelnext`` (4 bf16 requests: 32 kernel-1
    launches, one kernel-2 launch of 12 sets and 72 pointwise products
    each), ``stages_voxelnext``, ``model_voxelnext`` (f32, TF32 off,
    kernels vs plain), ``recipes_voxelnext`` (``voxelnext_recipe()``,
    ``int8_deploy_recipe()`` and residency: launches per recipe, each launch
    on its own operands, kernels vs plain) and ``tta_voxelnext`` (double
    flip at tiny width, kernels vs plain) -> summary for the kernels line."""
    import numpy as np
    import torch
    from q3d_tpu_torch.eval_utils import to_host
    from q3d_tpu_torch.models import load_data_to_device
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns

    t0 = time.perf_counter()
    vcfg, ds, model = voxelnext_model(dev)
    build_s = time.perf_counter() - t0
    raw0, _, _ = make_request(ds, 0)
    strict_f32(True)
    batch_f32 = load_data_to_device(raw0, device=dev)
    calibrate_bns(model, batch_f32)

    # ------------------------------------------------ kernels: conv
    convs, out_ref = record_sparse_convs(model, batch_f32)
    check(len(convs) == VN_CONVS,
          f"voxelnext: {len(convs)} kernel-1 convs, expected {VN_CONVS}")
    enc = out_ref["encoded_spconv_tensor"]
    rows_valid = int(enc.valid.sum())
    totals, worst, rows = kernel_conv(convs, flush, mode, "voxelnext")
    groups = {"3d_conv_input_to_conv4": [], "3d_conv5_conv6": [],
              "2d_conv_out_shared_conv": []}
    for row in rows:
        key = "2d_conv_out_shared_conv" if row["conv"].startswith(VN_2D) \
            else "3d_conv5_conv6" if row["conv"].startswith(VN_DEEP) \
            else "3d_conv_input_to_conv4"
        groups[key].append(row)
    group_sums = {
        g: {"convs": len(rs), "M": sorted({r["M"] for r in rs}),
            "K": sorted({r["K"] for r in rs}),
            **{k: sum(r[f"{k}_bf16"] for r in rs)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bytes_ms", "ops_ms")},
            **{f"{k}_s8": sum(r[f"{k}_s8"] for r in rs)
               for k in ("ms", "bound_ms")}}
        for g, rs in groups.items()}
    emit("kernel_conv_voxelnext", config=VN_CFG.name, scenes=CFG.name,
         batch=BATCH, convs=len(convs), totals_bf16=totals,
         max_abs_err=worst, groups=group_sums,
         encoded_rows=enc.capacity, encoded_rows_valid=rows_valid,
         mode=mode(), times="bf16 sums over one forward's convs, L2 flushed")
    strict_f32(False)

    # ------------------------------------------------ serving
    nms_cfg = vcfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG
    post_max = int(nms_cfg.NMS_POST_MAXSIZE)
    box_dim = 9 if "vel" in vcfg.MODEL.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT \
        else 7
    sets, per_request = [], []
    clear_voxelnext_launches(conv_k, nms_k)
    with counting_nms_sets(sets):
        for r in range(REQUESTS):
            raw, scene_ms, vox_ms = make_request(ds, r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = load_data_to_device(raw, device=dev,
                                        compute_dtype=torch.bfloat16)
            with torch.no_grad():
                out = model(batch)
            n_valid = out["final_valid"].sum(dim=1).tolist()
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            check(all(torch.isfinite(out[k].float()).all() for k in
                      ("final_boxes", "final_scores")),
                  f"voxelnext request {r}: non-finite outputs")
            check(out["final_boxes"].shape
                  == (BATCH, VN_HEADS * post_max, box_dim),
                  f"voxelnext request {r}: final_boxes shape "
                  f"{tuple(out['final_boxes'].shape)}")
            per_request.append({"request": r, "frames": list(range(
                BATCH * r, BATCH * (r + 1))), "scene_ms": scene_ms,
                "voxelize_ms": vox_ms, "device_forward_ms": fwd_ms,
                "valid_detections": n_valid})
            emit("serving_voxelnext_request", **per_request[-1])
    launches = voxelnext_launches(conv_k, nms_k, sets)
    want = {"sparse_gather_conv": VN_CONVS * REQUESTS,
            "sparse_gather_conv_bf16": VN_CONVS * REQUESTS,
            "greedy_nms_boxes": REQUESTS, "greedy_nms_iou": 0,
            "pointwise_float": VN_POINTWISE * REQUESTS, "pointwise_int8": 0,
            "nms_sets": [VN_HEADS * BATCH] * REQUESTS}
    got = {k: launches[k] for k in want}
    check(got == want, f"voxelnext main path launches {got}, expected {want}")
    emit("serving_voxelnext", config=VN_CFG.name, scenes=CFG.name,
         batch=BATCH, dtype="bf16", requests=REQUESTS, launches=launches,
         build_s=build_s, mode=mode(), steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]))
    stages = voxelnext_stage_times(model, batch)
    emit("stages_voxelnext", dtype="bf16", batch=BATCH, mode=mode(), ms=stages,
         sparse_conv_kernels_ms=totals["ms"],
         conv_kernels_ms_by_group={g: v["ms"] for g, v in group_sums.items()},
         trace=forward_trace(model, batch))

    # ------------------------------------------------ whole model, f32
    strict_f32(True)
    summary, launches_f32, _ = voxelnext_kernels_vs_plain(
        model, batch_f32, conv_k, nms_k, "model_voxelnext", BATCH)
    check(launches_f32["sparse_gather_conv_f32"] == VN_CONVS
          and launches_f32["greedy_nms_boxes"] == 1
          and launches_f32["pointwise_float"] == VN_POINTWISE,
          f"model_voxelnext: launches {launches_f32}")
    emit("model_voxelnext", dtype="f32", mode=mode(), launches=launches_f32,
         map_tolerance="max|k-p| <= 1e-4 * max(1, max|p|)", **summary)

    # ------------------------------------------------ kernels: NMS
    # kernel 2 on this forward's 12 candidate sets (6 heads x 2 frames,
    # K = 500): the boxes form against its plain version, timed, bound
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    head = model.dense_head
    with torch.no_grad():
        out_f = model(dict(batch_f32))
        cand = head._candidates(out_f["encoded_spconv_tensor"],
                                out_f["pred_dicts"])
    bx, bv = cand[0][..., :7].contiguous(), cand[3].contiguous()
    s_, k_ = bv.shape
    thresh = float(nms_cfg.NMS_THRESH)
    near_pairs, cand_pairs, near_max_tile = check_boxes_form(
        bx, bv, thresh, "voxelnext")
    corners, areas = nms_mod.bev_corners_areas(bx)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    terms = boxes_bound(s_, k_, cand_pairs, near_pairs, clock_mhz)
    nms_row = {"entry": "q3d_greedy_nms_boxes", "sets": s_, "K": k_,
               "valid": int(bv.sum()), "candidate_pairs": cand_pairs,
               "near_pairs": near_pairs,
               "near_pairs_most_in_a_tile": near_max_tile,
               "kept": int(nms_mod.greedy_nms_boxes(bx, bv, thresh).sum()),
               "ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_cuda(
                   corners, areas, bv, thresh), flush=flush),
               "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_plain(
                   bx, bv, thresh), reps=5, flush=flush),
               **{f"{k}_ms": v for k, v in terms.items()}}
    nms_row["bound_by"] = max(terms, key=terms.get)
    nms_row["bound_ms"] = terms[nms_row["bound_by"]]
    emit("kernel_nms_voxelnext", **nms_row, max_abs_err=0, mode=mode(),
         tolerance="keep masks exactly equal, IoU bit-equal at every "
         "evaluated pair, plain IoU exactly 0 at every skipped needed pair")

    # ------------------------------------------------ recipes
    recipes = {}
    cases = (("voxelnext_recipe()", lambda m: quant_api.quantize_model(
                 m, quant_api.voxelnext_recipe(), batch_f32)),
             ("int8_deploy_recipe()", lambda m: quant_api.quantize_model(
                 m, quant_api.int8_deploy_recipe(), batch_f32)),
             ("int8 residency", lambda m: quant_api.prepare_int8_deploy(
                 m, [batch_f32])))
    # the head's 1x1 convs: 6 x 5 hidden ones quantized (hm excluded), the
    # hm hidden ones and the 36 output convs float; conv_input float, the
    # other 29 3D convs quantized; conv_out and shared_conv on the
    # gather-view SmoothQuant or kernel 1's s8 entry (no residency)
    n_hidden_q = VN_HEADS * (VN_BRANCHES - 1)
    n_pw_float, n_3d = VN_POINTWISE - n_hidden_q, VN_CONVS - 2
    want_by = {
        "voxelnext_recipe()": {"sparse_gather_conv_f32": n_3d,
                               "greedy_nms_boxes": 1,
                               "pointwise_float": n_pw_float},
        "int8_deploy_recipe()": {"sparse_gather_conv_f32": 1,
                                 "sparse_gather_conv_s8": n_3d + 1,
                                 "greedy_nms_boxes": 1,
                                 "pointwise_float": n_pw_float,
                                 "pointwise_int8": n_hidden_q,
                                 "int_mm_pointwise": n_hidden_q},
        "int8 residency": {"sparse_gather_conv_f32": 1,
                           "sparse_gather_conv_s8": 2,
                           "sparse_gather_conv_s8_requant": n_3d - 1,
                           "greedy_nms_boxes": 1,
                           "pointwise_float": n_pw_float,
                           "pointwise_int8": n_hidden_q,
                           "int_mm_pointwise": n_hidden_q}}
    float_host = None
    for tag, prepare in cases:
        m = copy.deepcopy(model)
        t0 = time.perf_counter()
        prepare(m)
        prep_s = time.perf_counter() - t0
        calls = []
        with recording_launches(calls):
            row, launches_q, out_q = voxelnext_kernels_vs_plain(
                m, batch_f32, conv_k, nms_k, f"recipes_voxelnext {tag}",
                BATCH, strict=False)
        got = {k: v for k, v in launches_q.items()
               if v and k not in ("sparse_gather_conv", "nms_sets")}
        check(got == want_by[tag], f"recipes_voxelnext {tag}: launches "
                                   f"{got}, expected {want_by[tag]}")
        n_rec = sum(v for k, v in got.items()
                    if k.startswith("sparse_gather") or k == "int_mm_pointwise")
        check(len(calls) == n_rec, f"recipes_voxelnext {tag}: {len(calls)} "
                                   f"launches recorded, {n_rec} counted")
        held = hold_launches_on_operands(calls, f"recipes_voxelnext {tag}")
        del calls
        if float_host is None:
            with torch.no_grad():
                float_host = to_host(model(dict(batch_f32)))
        diff = float(np.abs(to_host(out_q)["final_scores"]
                            - float_host["final_scores"]).mean())
        recipes[tag] = {"launches": got, "prepare_s": prep_s,
                        "mean_abs_score_vs_float": diff, **held, **row}
        emit("recipes_voxelnext", recipe=tag, dtype="f32", batch=BATCH,
             mode=mode(), **recipes[tag])
        del m
    strict_f32(False)

    # ------------------------------------------------ double flip, tiny
    strict_f32(True)
    tcfg, tds, tmodel = voxelnext_model(dev, VN_TINY_CFG, VN_TINY_CFG,
                                        double_flip=True)
    traw = tds.collate_batch([tds[i] for i in range(BATCH)])
    tbatch = load_data_to_device(traw, device=dev)
    calibrate_bns(tmodel, tbatch)
    tsum, tl, _ = voxelnext_kernels_vs_plain(tmodel, tbatch, conv_k, nms_k,
                                             "tta_voxelnext", BATCH)
    n_heads = len(tcfg.MODEL.DENSE_HEAD.CLASS_NAMES_EACH_HEAD)
    check(tl["sparse_gather_conv_f32"] == 42 and tl["greedy_nms_boxes"] == 1
          and tl["nms_sets"] == [n_heads * BATCH],
          f"tta_voxelnext: launches {tl}")
    emit("tta_voxelnext", config=VN_TINY_CFG.name, frames=BATCH,
         expanded_batch=4 * BATCH, dtype="f32", mode=mode(), launches=tl,
         **tsum)
    strict_f32(False)
    del model, tmodel
    return {"launches": launches, "totals": totals, "worst": worst,
            "groups": group_sums, "stages": stages, "nms": nms_row}


TF_CFG = ROOT / "tools" / "cfgs" / "nuscenes_models" / "transfusion_lidar.yaml"
# per forward at full width: kernel 1 on VoxelResBackBone8x's 21 sparse
# convs; the head has no NMS, so kernel 2 never launches
TF_CONVS = 21
TF_OUT = ("final_boxes", "final_scores", "final_labels", "final_valid")


def transfusion_stage_times(model, batch, reps=5):
    """CUDA-event time of each stage of one TransFusion forward, median of
    ``reps`` -> {stage: ms}: vfe, backbone_3d, map_to_bev, backbone_2d,
    then the head: shared conv + heatmap (``dense_heatmap``), peak pool +
    top-K (``proposals``), the queries' gather and class encoding
    (``queries``), the two position embeddings, self-attention (with its
    LayerNorm), cross-attention (with its LayerNorm), FFN (with its
    LayerNorm), prediction head + decode; forward (all of it).  The head's
    methods are timed through instance attributes that shadow them."""
    import torch
    head, dec = model.dense_head, model.dense_head.decoder
    events = {}

    def mark(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name] = ev
        return hook
    hooks = []
    for mod, pre, post in (
            (model.vfe, "vfe0", "vfe1"), (model.backbone_3d, "bb0", "bb1"),
            (model.map_to_bev_module, "bev0", "bev1"),
            (model.backbone_2d, "b2d0", "b2d1"),
            (dec.self_posembed, "pos0", None),
            (dec.cross_posembed, None, "pos1"),
            (dec.self_attn, "sa0", None), (dec.norm1, None, "sa1"),
            (dec.multihead_attn, "ca0", None), (dec.norm2, None, "ca1"),
            (dec.linear1, "ffn0", None), (dec.norm3, None, "ffn1"),
            (head.prediction_head, "pred0", None)):
        if pre:
            hooks.append(mod.register_forward_pre_hook(mark(pre)))
        if post:
            hooks.append(mod.register_forward_hook(mark(post)))

    def timed(fn, a, b):
        def run(*args, **kw):
            if a:
                mark(a)()
            out = fn(*args, **kw)
            mark(b)()
            return out
        return run
    for attr, a, b in (("dense_heatmap", "hm0", "hm1"),
                       ("proposals", "topk0", "topk1"),
                       ("queries", "q0", "q1"),
                       ("final_predictions", None, "pred1")):
        setattr(head, attr, timed(getattr(head, attr), a, b))
    spans = {"vfe": ("vfe0", "vfe1"), "backbone_3d": ("bb0", "bb1"),
             "map_to_bev": ("bev0", "bev1"), "backbone_2d": ("b2d0", "b2d1"),
             "shared_conv_heatmap": ("hm0", "hm1"),
             "peak_pool_topk": ("topk0", "topk1"),
             "query_gather_class_encoding": ("q0", "q1"),
             "position_embeddings": ("pos0", "pos1"),
             "self_attention": ("sa0", "sa1"),
             "cross_attention": ("ca0", "ca1"), "ffn": ("ffn0", "ffn1"),
             "prediction_head_decode": ("pred0", "pred1"),
             "dense_head": ("hm0", "pred1"), "forward": ("vfe0", "pred1")}
    ms = {k: [] for k in spans}
    try:
        with torch.no_grad():
            for _ in range(reps):
                events.clear()
                model(dict(batch))
                torch.cuda.synchronize()
                for k, (a, b) in spans.items():
                    ms[k].append(events[a].elapsed_time(events[b]))
    finally:
        for attr in ("dense_heatmap", "proposals", "queries",
                     "final_predictions"):
            delattr(head, attr)
        for h in hooks:
            h.remove()
    return {k: statistics.median(v) for k, v in ms.items()}


@contextlib.contextmanager
def recording_proposals(head, store):
    """The head's top-K (classes, cells) of every forward -> ``store``."""
    real = head.proposals

    def run(*args):
        out = real(*args)
        store.append(out[1:])
        return out
    head.proposals = run
    try:
        yield
    finally:
        del head.proposals


def transfusion_kernels_vs_plain(model, batch, conv_k, nms_k, tag,
                                 strict=True):
    """One request through the kernels and through the plain versions ->
    (summary, kernel run's launches).  The plain run launches nothing.
    ``strict`` (a float model): spatial_features, spatial_features_2d and
    every head map (dense heatmap and the branches) within 1e-4 of max(1,
    scale); the top-K (classes and cells) equal; then the 200 queries'
    labels and valid flags equal and their boxes and scores within 1e-4 of
    max(1, scale).  Otherwise (a fake-quant model, where a last-bit
    difference flips a rounding that grows through the layers) only
    finite outputs, every launch being held on its own operands.  Whether
    the outputs are exactly equal is reported."""
    import torch
    head = model.dense_head
    outs, launches, res, tops = {}, {}, {}, {}
    real_predict = head.predict

    def keep_res(impl):
        def run(*args):
            res[impl] = real_predict(*args)
            return res[impl]
        return run
    with torch.no_grad():
        for impl in ("cuda", "plain"):
            model.set_kernel_impl(impl)
            clear_launches(conv_k, nms_k)
            tops[impl] = []
            head.predict = keep_res(impl)
            with recording_proposals(head, tops[impl]):
                outs[impl] = model(dict(batch))
            del head.predict
            torch.cuda.synchronize()
            launches[impl] = {**kernel_launches(conv_k, nms_k),
                              "sparse_gather_conv": sum(
                                  conv_k.launches.values())}
        model.set_kernel_impl(None)
    check(not any(launches["plain"].values()),
          f"{tag}: the plain run launched {launches['plain']}")
    ok_, op = outs["cuda"], outs["plain"]
    maps = {k: (ok_[k], op[k]) for k in ("spatial_features",
                                         "spatial_features_2d")}
    maps.update({f"head.{k}": (res["cuda"][k], res["plain"][k])
                 for k in res["cuda"] if k != "query_labels"})
    maps.update({k: (ok_[k], op[k]) for k in ("final_boxes", "final_scores")})
    map_err = {}
    for key, (a, b) in maps.items():
        err, mag = float((a.float() - b.float()).abs().max()), \
            float(b.float().abs().max())
        map_err[key] = {"max_abs": err, "scale": mag}
        check(bool(torch.isfinite(a.float()).all())
              and (not strict or err <= 1e-4 * max(1.0, mag)),
              f"{tag} {key}: kernels vs plain max err {err} (scale {mag})")
    same_topk = all(torch.equal(a, b) for a, b in zip(tops["cuda"][0],
                                                      tops["plain"][0]))
    if strict:
        check(same_topk, f"{tag}: the top-K differs between kernels and plain")
        for key in ("final_labels", "final_valid"):
            check(torch.equal(ok_[key], op[key]),
                  f"{tag}: {key} differ between kernels and plain")
    equal = all(torch.equal(ok_[k], op[k]) for k in TF_OUT)
    return ({"map_max_abs_err": map_err, "topk_equal": same_topk,
             "outputs_equal": equal,
             "valid_queries": ok_["final_valid"].sum(1).tolist()},
            launches["cuda"])


def transfusion_phases(dev, conv_k, nms_k, mode, strict_f32, flush):
    """The TransFusion phases (full width: the nuScenes config's MODEL and
    CLASS_NAMES on centerpoint_ref's scenes, batch 2, seeded weights, BN
    statistics from the first request): ``kernel_conv_transfusion``
    (kernel 1 on the 21 convs of one forward against the plain versions,
    timed), ``serving_transfusion`` (4 bf16 requests: 21 kernel-1 launches
    each, no kernel 2), ``stages_transfusion`` (the head split into its
    stages), ``model_transfusion`` (f32, TF32 off, kernels vs plain) and
    ``recipes_transfusion`` (``transfusion_recipe()`` and its static form,
    histograms calibrated on the first two requests, method "max": each
    launch held against its plain version on its own operands) -> summary
    for the kernels line."""
    import torch
    from q3d_tpu_torch.models import load_data_to_device
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns

    t0 = time.perf_counter()
    tcfg, ds, model = nuscenes_model(dev, TF_CFG)
    build_s = time.perf_counter() - t0
    raw0, _, _ = make_request(ds, 0)
    strict_f32(True)
    batch_f32 = load_data_to_device(raw0, device=dev)
    calibrate_bns(model, batch_f32)

    # ------------------------------------------------ kernels: conv
    convs, _ = record_sparse_convs(model, batch_f32)
    check(len(convs) == TF_CONVS,
          f"transfusion: {len(convs)} kernel-1 convs, expected {TF_CONVS}")
    totals, worst, rows = kernel_conv(convs, flush, mode, "transfusion")
    emit("kernel_conv_transfusion", config=TF_CFG.name, scenes=CFG.name,
         batch=BATCH, convs=len(convs), totals_bf16=totals,
         max_abs_err=worst, rows=sorted({r["M"] for r in rows}),
         mode=mode(), times="bf16 sums over one forward's convs, L2 flushed")
    del convs
    strict_f32(False)

    # ------------------------------------------------ serving
    head_cfg = tcfg.MODEL.DENSE_HEAD
    n_prop = int(head_cfg.NUM_PROPOSALS)
    box_dim = 9 if "vel" in head_cfg.SEPARATE_HEAD_CFG.HEAD_DICT else 7
    per_request = []
    clear_launches(conv_k, nms_k)
    for r in range(REQUESTS):
        raw, scene_ms, vox_ms = make_request(ds, r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = load_data_to_device(raw, device=dev,
                                    compute_dtype=torch.bfloat16)
        with torch.no_grad():
            out = model(batch)
        n_valid = out["final_valid"].sum(dim=1).tolist()
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.isfinite(out[k].float()).all() for k in
                  ("final_boxes", "final_scores")),
              f"transfusion request {r}: non-finite outputs")
        check(out["final_boxes"].shape == (BATCH, n_prop, box_dim),
              f"transfusion request {r}: final_boxes shape "
              f"{tuple(out['final_boxes'].shape)}")
        per_request.append({"request": r, "frames": list(range(
            BATCH * r, BATCH * (r + 1))), "scene_ms": scene_ms,
            "voxelize_ms": vox_ms, "device_forward_ms": fwd_ms,
            "valid_detections": n_valid})
        emit("serving_transfusion_request", **per_request[-1])
    launches = {**kernel_launches(conv_k, nms_k),
                "sparse_gather_conv": sum(conv_k.launches.values())}
    want = {"sparse_gather_conv": TF_CONVS * REQUESTS,
            "sparse_gather_conv_bf16": TF_CONVS * REQUESTS,
            "greedy_nms_boxes": 0, "greedy_nms_iou": 0}
    got = {k: launches[k] for k in want}
    check(got == want,
          f"transfusion main path launches {got}, expected {want}")
    emit("serving_transfusion", config=TF_CFG.name, scenes=CFG.name,
         batch=BATCH, dtype="bf16", requests=REQUESTS, launches=launches,
         build_s=build_s, mode=mode(), steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]),
         steady_host_ms=statistics.median(
             p["scene_ms"] + p["voxelize_ms"] for p in per_request[1:]))
    stages = transfusion_stage_times(model, batch)
    emit("stages_transfusion", dtype="bf16", batch=BATCH, mode=mode(),
         ms=stages, sparse_conv_kernels_ms=totals["ms"],
         trace=forward_trace(model, batch))

    # ------------------------------------------------ whole model, f32
    strict_f32(True)
    summary, launches_f32 = transfusion_kernels_vs_plain(
        model, batch_f32, conv_k, nms_k, "model_transfusion")
    check(launches_f32["sparse_gather_conv_f32"] == TF_CONVS
          and launches_f32["sparse_gather_conv"] == TF_CONVS
          and launches_f32["greedy_nms_boxes"] == 0,
          f"model_transfusion: launches {launches_f32}")
    emit("model_transfusion", dtype="f32", mode=mode(),
         launches=launches_f32,
         map_tolerance="max|k-p| <= 1e-4 * max(1, max|p|)", **summary)

    # ------------------------------------------------ recipes
    raw1, _, _ = make_request(ds, 1)
    batch1_f32 = load_data_to_device(raw1, device=dev)

    def static(m):
        quant_api.quantize_model(m, quant_api.transfusion_recipe(static=True),
                                 batch_f32)
        quant_api.collect_stats(m, [batch_f32, batch1_f32], 2)
        quant_api.compute_amax(m, method="max")
    recipes = {}
    for tag, prepare in (
            ("transfusion_recipe()", lambda m: quant_api.quantize_model(
                m, quant_api.transfusion_recipe(), batch_f32)),
            ("transfusion_recipe(static=True), max", static)):
        m = copy.deepcopy(model)
        t0 = time.perf_counter()
        prepare(m)
        prep_s = time.perf_counter() - t0
        calls = []
        with recording_launches(calls):
            row, launches_q = transfusion_kernels_vs_plain(
                m, batch_f32, conv_k, nms_k, f"recipes_transfusion {tag}",
                strict=False)
        got = {k: v for k, v in launches_q.items() if v}
        want = {"sparse_gather_conv": TF_CONVS,
                "sparse_gather_conv_f32": TF_CONVS}
        check(got == want, f"recipes_transfusion {tag}: launches {got}, "
                           f"expected {want}")
        check(len(calls) == TF_CONVS, f"recipes_transfusion {tag}: "
                                      f"{len(calls)} launches recorded")
        held = hold_launches_on_operands(calls, f"recipes_transfusion {tag}")
        del calls
        recipes[tag] = {"launches": got, "prepare_s": prep_s, **held, **row}
        emit("recipes_transfusion", recipe=tag, dtype="f32", batch=BATCH,
             mode=mode(), **recipes[tag])
        del m
    strict_f32(False)
    del model
    return {"launches": launches, "totals": totals, "worst": worst,
            "stages": stages}


# ============================================ TransFusion and VoxelNeXt training
# f32 training of the nuScenes configs' MODEL at full width on training
# frames of centerpoint_ref's scenes (the yamls' BATCH_SIZE_PER_GPU is 4):
# TransFusion at batch 2 over 8 frames; VoxelNeXt at batch 1 over 4 frames,
# since its batch-2 step runs out of the card's 80 GB (its head keeps f32
# activations of 3 x B x 160,000 rows, most of them padding).  The scenes'
# class ids 1-3 name each config's first three classes (car, truck,
# construction_vehicle).  Kernel 1 a step: TransFusion 21 forward and 20
# dX; VoxelNeXt 32 forward (30 3D, conv_out and shared_conv 2D) and 31 dX
# (2 over the 2D inverse books).
NU_TRAIN = {"transfusion": {"cfg": TF_CFG, "tiny": ROOT / "tools" / "cfgs"
                            / "synthetic_models" / "transfusion_tiny.yaml",
                            "batch": 2, "frames": 8,
                            "convs": TF_CONVS, "convs_2d": 0,
                            "recipe": "transfusion_recipe", "qat_convs": 21},
            "voxelnext": {"cfg": VN_CFG, "tiny": VN_TINY_CFG,
                          "batch": 1, "frames": 4,
                          "convs": VN_CONVS, "convs_2d": 2,
                          "recipe": "voxelnext_recipe", "qat_convs": 30}}
# TransFusion's gradients that are 0 in exact arithmetic besides the biases
# before a BN: the key projections' biases (the softmax cancels them) and
# the last LayerNorm's bias (the prediction branches' BNs cancel it)
TF_ZERO_GRAD = ("dense_head.decoder.self_attn.k_proj.bias",
                "dense_head.decoder.multihead_attn.k_proj.bias",
                "dense_head.decoder.norm3.bias")


def nuscenes_train_data(name, dev):
    """The nuScenes config ``name``'s MODEL and CLASS_NAMES (seeded weights)
    on a training loader of centerpoint_ref's scenes at the frames and
    batch ``NU_TRAIN`` gives (points shuffled, as training) -> (config,
    dataset, loader, model)."""
    import dataclasses
    import numpy as np
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network
    from q3d_tpu_torch.models.builder import dataset_info
    vcfg = cfg_from_yaml_file(str(NU_TRAIN[name]["cfg"]), EDict())
    scfg = cfg_from_yaml_file(str(CFG), EDict())
    scfg.DATA_CONFIG.NUM_FRAMES = NU_TRAIN[name]["frames"]
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(scfg.DATA_CONFIG, scfg.CLASS_NAMES,
                                     batch_size=NU_TRAIN[name]["batch"],
                                     training=True, seed=SEED)
    info = dataclasses.replace(dataset_info(ds),
                               class_names=tuple(vcfg.CLASS_NAMES))
    model = build_network(vcfg.MODEL, len(vcfg.CLASS_NAMES), info, device=dev)
    return vcfg, ds, loader, model


def zero_grads(model, name, gt_boxes):
    """The parameters whose gradient is 0 on a batch besides the biases
    before a BN: TransFusion's ``TF_ZERO_GRAD``; VoxelNeXt's regression
    branches of the heads none of whose classes the gt boxes hold (their
    L1 loss has no term) -> set of names."""
    if name == "transfusion":
        return set(TF_ZERO_GRAD)
    present = {int(c) - 1 for c in gt_boxes[..., -1].reshape(-1).tolist()
               if c > 0}
    head = model.dense_head
    return {n for n, _ in model.named_parameters()
            for i, ids in enumerate(head.class_id_mapping_each_head)
            if not present & set(ids.tolist())
            and n.startswith(f"dense_head.heads_list.{i}.")
            and not n.startswith(f"dense_head.heads_list.{i}.hm.")}


@contextlib.contextmanager
def recording_assignments(out):
    """While open, each ``hungarian_assignment`` result is appended to
    ``out``."""
    from q3d_tpu_torch.models.dense_heads import transfusion_head
    real = transfusion_head.hungarian_assignment

    def run(*args):
        assigned = real(*args)
        out.append(assigned)
        return assigned
    transfusion_head.hungarian_assignment = run
    try:
        yield
    finally:
        transfusion_head.hungarian_assignment = real


def qat_nuscenes(name, model, batch, conv_k, mode):
    """Phase ``qat_<name>``: the seeded model under its recipe
    (``transfusion_recipe()`` / ``voxelnext_recipe()``, dynamic SmoothQuant
    fake-quant), quantized on the batch, one QAT step (``QAT_OPTIM``, f32,
    TF32 off) through the kernels and through the plain versions: the whole
    step held by ``compare_training`` at ``QAT_TOL``, each kernel-1 launch
    (forward and dX, on the fake-quantized operands it had) at 1e-5 of its
    plain version (``hold_conv_launches``); every quantized layer's weight
    gets a finite gradient, nonzero but where the batch gives its loss no
    term.  VoxelNeXt's conv_out and shared_conv run the gather-view
    SmoothQuant in torch, so its 30 3D convs launch kernel 1."""
    import collections
    import torch
    from q3d_tpu_torch.config import EDict
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.train_utils import train_step
    spec = NU_TRAIN[name]
    recipe = getattr(quant_api, spec["recipe"])
    qmodel = copy.deepcopy(model)
    quant_api.quantize_model(qmodel, recipe(), batch)
    check(not [n for n, _ in qmodel.named_parameters()
               if "quant" in n or "amax" in n],
          f"qat_{name}: a quantizer's state is a parameter")
    quantized = {n: m.QUANT_KIND for n, m in qmodel.named_modules()
                 if getattr(m, "rule", None) is not None
                 and getattr(m, "weight", None) is not None}
    runs = {}
    for impl in ("cuda", "plain"):
        m = copy.deepcopy(qmodel)
        m.set_kernel_impl(impl)
        opt = build_optimizer(m.parameters(), EDict(QAT_OPTIM), QAT_STEPS)
        conv_k.launches.clear()
        with recording_backward(m) as recorded:
            loss = float(train_step(m, batch, opt)[0])
        runs[impl] = (m, loss, dict(conv_k.launches), recorded)
    del qmodel
    mk, loss_k, launches, recorded = runs["cuda"]
    n = spec["qat_convs"]
    check(launches == {"q3d_sparse_gather_conv_f32": 2 * n - 1}
          and not any(runs["plain"][2].values()) and len(recorded) == n,
          f"qat_{name}: kernel-1 launches {launches} / {runs['plain'][2]}")
    layers = hold_conv_launches(recorded)
    del recorded
    zero = zero_grads(mk, name, batch["gt_boxes"])
    params = dict(mk.named_parameters())
    for n_ in quantized:
        g = params[f"{n_}.weight"].grad
        check(bool(torch.isfinite(g).all()) and (
            f"{n_}.weight" in zero or bool(g.abs().max() > 0)),
            f"qat_{name}: {n_}.weight gradient")
    summary = compare_training(mk, runs["plain"][0], loss_k,
                               runs["plain"][1], qat=True, zero_extra=zero)
    emit(f"qat_{name}", config=spec["cfg"].name,
         recipe=f"{spec['recipe']}()", batch=spec["batch"], mode=mode(),
         quantized_by_kind=dict(collections.Counter(quantized.values())),
         launches_step=launches, tolerance=QAT_TOL, layers=layers,
         **summary)


def train_tiny_nuscenes(name, dev, mode):
    """Phase ``train_tiny_<name>``: the tiny config (``transfusion_tiny`` /
    ``voxelnext_tiny``) from its seeded init, 8 steps of Adam 3e-3 on one
    batch on the card, as ``train_tiny``: the loss falls by at least
    10%."""
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.train_utils import MODEL_KEYS, train_step
    path = NU_TRAIN[name]["tiny"]
    cfg = cfg_from_yaml_file(str(path), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=BATCH, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    raw = next(iter(loader))
    batch = load_data_to_device({k: v for k, v in raw.items()
                                 if k in MODEL_KEYS}, device=dev)
    opt = build_optimizer(model.parameters(), EDict(
        {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.0}), TINY_STEPS)
    losses = [float(train_step(model, batch, opt)[0])
              for _ in range(TINY_STEPS)]
    check(losses[-1] < 0.9 * losses[0], f"train_tiny_{name}: losses {losses}")
    emit(f"train_tiny_{name}", config=path.name, batch=BATCH, mode=mode(),
         optimizer="adam, lr 3e-3, no weight decay, clip 10", losses=losses,
         fall=1 - losses[-1] / losses[0])


def train_nuscenes(name, dev, conv_k, nms_k, mode):
    """Phase ``train_<name>``: ``train_model`` at the nuScenes config's
    width on ``NU_TRAIN``'s training frames and batch, 2 epochs (8 steps),
    with
    the yaml's OPTIMIZATION (adam_onecycle, LR 1e-3, WD 0.01, clip 10),
    PyTorch's TF32 defaults, timed by ``timed_train_model`` (host,
    forward, backward with dX and dW apart, optimizer ms a step, peak
    memory, losses); kernel-1 launches 2 x convs - 1 a step, no NMS ->
    {launches forward / dx, medians}."""
    import shutil
    cfg, ds, loader, model = nuscenes_train_data(name, dev)
    ckpt_dir = ROOT / "output" / f"chip_smoke_train_{name}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    quiet = zero_grads(model, name, next(iter(loader))["gt_boxes"])
    nms_k.launches.clear()
    try:
        _, steps, launches, run_s = timed_train_model(
            model, cfg.OPTIMIZATION, ds, loader, ckpt_dir, conv_k, dev,
            f"train_{name}", no_signal=quiet, any_step=True)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps, convs = len(steps), NU_TRAIN[name]["convs"]
    check(launches == {"q3d_sparse_gather_conv_f32": (2 * convs - 1) * n_steps}
          and not any(nms_k.launches.values()),
          f"train_{name}: launches {launches}, NMS {dict(nms_k.launches)}")
    med = median_after_first(steps)
    emit(f"train_{name}", config=NU_TRAIN[name]["cfg"].name, scenes=CFG.name,
         batch=NU_TRAIN[name]["batch"], epochs=TRAIN_EPOCHS, steps=n_steps,
         mode=mode(),
         optimization={k: cfg.OPTIMIZATION[k] for k in (
             "OPTIMIZER", "LR", "WEIGHT_DECAY", "GRAD_NORM_CLIP")},
         losses=[s["loss"] for s in steps], launches=launches, run_s=run_s,
         zero_gradient_allowed=sorted(quiet), median_after_first=med)
    return {"launches_forward": sum(s["launches_forward"] for s in steps),
            "launches_dx": sum(s["launches_dx"] for s in steps),
            "median": med}


def nuscenes_training(dev, conv_k, nms_k, mode, strict_f32, flush):
    """The TransFusion and VoxelNeXt training phases, each model in turn:
    ``train_grad_<name>`` (one training step of the seeded model on the
    first training batch, f32, TF32 off, through the kernels and through
    the plain versions at ``TRAIN_TOL``; TransFusion's Hungarian assignment
    equal in both runs; VoxelNeXt's 2 dX launches over the 2D inverse
    books counted apart), ``kernel_fwd_<name>`` and ``kernel_dx_<name>``
    (each recorded launch of that step against its plain version, timed
    beside it, gather + ``torch.matmul`` and the bound; VoxelNeXt's 3D and
    2D convs summed apart), ``qat_<name>``, ``train_tiny_<name>`` and
    ``train_<name>`` -> {name: summaries for the kernels line}."""
    import torch
    from q3d_tpu_torch.models import load_data_to_device
    from q3d_tpu_torch.train_utils import MODEL_KEYS
    out = {}
    for name, spec in NU_TRAIN.items():
        config = spec["cfg"].name
        _, _, loader, model = nuscenes_train_data(name, dev)
        raw = next(iter(loader))
        batch = load_data_to_device({k: v for k, v in raw.items()
                                     if k in MODEL_KEYS}, device=dev)
        strict_f32(True)
        assigned = []
        with recording_assignments(assigned):
            recorded, run = train_grad(
                model, batch, conv_k, mode, f"train_grad_{name}", config,
                spec["convs"], zero_grads(model, name, raw["gt_boxes"]))
        check(run["launches_dx_2d"] == spec["convs_2d"],
              f"train_grad_{name}: {run['launches_dx_2d']} dX launches over "
              f"2D books, expected {spec['convs_2d']}")
        if name == "transfusion":
            check(len(assigned) == 2 and torch.equal(assigned[0], assigned[1])
                  and bool((assigned[0] >= 0).any()),
                  f"train_grad_{name}: Hungarian assignments differ between "
                  f"kernels and plain versions")
            emit("train_grad_transfusion_assignment",
                 matched_per_frame=(assigned[0] >= 0).sum(1).tolist(),
                 objects_per_frame=(raw["gt_boxes"][..., -1] > 0).sum(1)
                 .tolist(), equal="kernels' and plain run's assignment")
        del assigned
        two_d = {f"{n}.weight" for n in kernel1_convs(model, two_d=True)}
        groups = {"3d": [r for r in recorded if r[0] not in two_d],
                  "2d": [r for r in recorded if r[0] in two_d]}
        fwd, dx = {}, {}
        for g, rec in groups.items():
            if not rec:
                continue
            suffix = f"{name}_{g}" if name == "voxelnext" else name
            fwd[g] = kernel_forward(rec, flush, mode, f"kernel_fwd_{suffix}",
                                    config)
            dx[g] = kernel_dx(rec, flush, mode, f"kernel_dx_{suffix}", config)
        del recorded, groups
        emit(f"kernel_dx_{name}", config=config, mode=mode(), forward=fwd,
             dx=dx, times="f32, one training step's launches, L2 flushed")
        qat_nuscenes(name, model, batch, conv_k, mode)
        strict_f32(False)
        del model, batch
        torch.cuda.empty_cache()
        train_tiny_nuscenes(name, dev, mode)
        trained = train_nuscenes(name, dev, conv_k, nms_k, mode)
        torch.cuda.empty_cache()
        out[name] = {"fwd": fwd, "dx": dx, "trained": trained,
                     "peak_mib": run["peak_mib"]}
    return out


def summed(groups):
    """Totals of ``kernel_forward`` / ``kernel_dx`` over groups of convs:
    times and bounds added, the worst error kept, ``bound_by`` of the
    sums."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms",
            "dw_ms", "inverse_ms")
    out = {k: sum(g[k] for g in groups.values()) for k in keys
           if all(k in g for g in groups.values())}
    out["max_abs_err"] = max(g["max_abs_err"] for g in groups.values())
    out["bound_by"] = "bytes" if out["bytes_ms"] >= out["ops_ms"] \
        else "operations"
    return out


def nuscenes_kernel_rows(nu):
    """The kernels line's entries of kernel 1 in the TransFusion and
    VoxelNeXt training steps: the f32 forward and the input gradient of
    each model, VoxelNeXt's 3D and 2D books apart as well."""
    rows = []
    for name, v in nu.items():
        spec = NU_TRAIN[name]
        config = spec["cfg"].name
        steps = TRAIN_EPOCHS * spec["frames"] // spec["batch"]
        for use, totals, launches in (
                ("forward", v["fwd"], v["trained"]["launches_forward"]),
                ("dx", v["dx"], v["trained"]["launches_dx"])):
            t = summed(totals)
            row = {"name": f"sparse_gather_conv_{use}_{name}_train",
                   "route": "cuda",
                   "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
                   "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
                   "entry": "q3d_sparse_gather_conv_f32",
                   "use": f"{name} training ({config}, batch "
                          f"{spec['batch']}): the "
                          + ("forward of its sparse convs" if use == "forward"
                             else "input gradient of every sparse conv but "
                                  "conv_input, over the inverse book"),
                   "launches": launches,
                   **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
                   "checks": "passed",
                   "times_cover": f"one f32 {name} training step's launches; "
                                  f"launches: train_{name}'s {steps} "
                                  f"steps",
                   "peak_mib_train_grad": v["peak_mib"]}
            if use == "dx":
                row.update(dw_torch_ms=t["dw_ms"],
                           inverse_book_ms=t["inverse_ms"])
            if len(totals) > 1:
                row["by_book"] = {g: {k: x[k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms",
                    "max_abs_err")} for g, x in totals.items()}
            rows.append(row)
    return rows


# ==================================================================== Lyft
# tools/cfgs/lyft_models/cbgs_second_multihead.yaml (MODEL as written):
# VoxelResBackBone8x's 21 sparse convs on kernel 1, AnchorHeadMulti's five
# towers, the multi-class NMS as one kernel-2 launch of BATCH x 9 candidate
# sets at K = NMS_PRE_MAXSIZE; on SyntheticDataset scenes at the Lyft
# dataset yaml's geometry (datasets/lyft_synthetic.py)
LYFT_CONVS, LYFT_SETS, LYFT_K = 21, 9, 1024
# a Lyft frame's voxels: the scenes fill at least this many of the cap
LYFT_MIN_VOXELS = 40000
LYFT_TRAIN_FRAMES = 16
# the largest anchor's BEV diagonal (bus: 12.70 x 2.92 m)
LYFT_DIAGONAL = 13.03


def lyft_model(dev, frames, training=False, augment=False):
    """The Lyft config on ``frames`` synthetic frames from SEED (a test
    loader of BATCH frames, or with ``training`` a training loader at the
    yaml's BATCH_SIZE_PER_GPU, points shuffled, the yaml's DATA_AUGMENTOR
    with ``augment``) and the seeded model, on the card -> (cfg, ds,
    loader, model)."""
    import dataclasses
    import numpy as np
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.lyft_synthetic import (SCENE_CLASSES,
                                                       lyft_config)
    from q3d_tpu_torch.models import build_network
    from q3d_tpu_torch.models.builder import dataset_info
    cfg = lyft_config(frames, SEED)
    if not augment:
        del cfg.DATA_CONFIG["DATA_AUGMENTOR"]
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(
        cfg.DATA_CONFIG, list(SCENE_CLASSES),
        batch_size=int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU) if training
        else BATCH, training=training, seed=SEED)
    info = dataclasses.replace(dataset_info(ds),
                               class_names=tuple(cfg.CLASS_NAMES))
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), info, device=dev)
    return cfg, ds, loader, model


def lyft_idle_box_convs(model, gt_boxes):
    """The towers' conv_box parameters none of whose classes the gt boxes
    hold (the scenes label classes 1-3: car, truck, bus): their regression
    loss has no term, so their gradient is exactly 0 -> set of names."""
    present = {int(c) - 1 for c in gt_boxes[..., -1].reshape(-1).tolist()
               if c > 0}
    return {f"dense_head.heads.{g}.conv_box.{p}"
            for g, (ids, _) in enumerate(model.dense_head.groups)
            if not present & set(ids) for p in ("weight", "bias")}


def lyft_candidates(out, nms_cfg, score_thresh):
    """The candidate sets that post_processing's multi-class NMS gives
    kernel 2 for a forward's outputs: per frame and class the top
    NMS_PRE_MAXSIZE rows by the class's score -> (boxes (B*C, K, 7), valid
    (B*C, K))."""
    import torch
    from q3d_tpu_torch.ops.iou3d_nms import top_candidates
    cls = torch.sigmoid(out["batch_cls_preds"].float())
    b, n, c = cls.shape
    scores = cls.permute(0, 2, 1).reshape(b * c, n)
    _, boxes, valid = top_candidates(
        out["batch_box_preds"][..., :7].float(), scores,
        scores >= score_thresh, int(nms_cfg.NMS_PRE_MAXSIZE))
    return boxes.contiguous(), valid.contiguous()


def lyft_phases(dev, conv_k, nms_k, mode, strict_f32, flush, clock_mhz):
    """SECOND-MultiHead at the Lyft config's width (MODEL as written; seeded
    weights, every tower's conv_cls bias 0 so that each class's scores sit
    near 0.5 and all NMS_PRE_MAXSIZE candidates of a set are valid, kernel
    2's worst case; BN statistics from the first request, f32, TF32 off):
    ``data_lyft`` (points, voxels kept against the 60,000 cap and the
    LYFT_MIN_VOXELS floor, objects present), ``kernel_conv`` for the 21
    convs (bf16 and s8 against plain, times, bound, library),
    ``serving_lyft`` (4 bf16 requests: 21 kernel-1 launches and one
    boxes-form launch of BATCH x 9 sets at K = 1024 each; host ms apart
    from device ms), ``stages_lyft``, ``model_lyft`` (f32 through the
    kernels and the plain versions: maps, kernel 2 on identical candidates
    in both forms, post_processing on identical inputs, detections),
    ``kernel_nms_lyft`` (the boxes form on those 18 sets against plain,
    timed, its bound; the IoU form under ``nms_normal_bev`` on the same
    sets), ``recipes_lyft`` (``second_recipe()``, ``int8_deploy_recipe()``
    and the residency deploy: launches per recipe, each launch held
    against its plain version on its own operands; the int8 forms' maps
    and detections equal end to end, the fake-quant form's end-to-end
    distance reported), then training at the yaml's batch (``train_grad_lyft``,
    ``kernel_fwd_lyft`` / ``kernel_dx_lyft``, ``qat_lyft``,
    ``train_tiny_lyft``, ``train_lyft``) -> summaries for the kernels
    line."""
    import numpy as np
    import torch
    from q3d_tpu_torch.datasets.lyft_synthetic import scene_counts
    from q3d_tpu_torch.eval_utils import to_host
    from q3d_tpu_torch.models import load_data_to_device
    from q3d_tpu_torch.models.dense_heads.anchor_head_multi import \
        ABSENT_LOGIT
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.models.model_utils import model_nms_utils
    from q3d_tpu_torch.ops.iou3d_nms import aligned_iou_bev
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
    config = "lyft_models/cbgs_second_multihead.yaml"

    # ---------------------------------------------------------------- data
    cfg, ds, _, model = lyft_model(dev, BATCH * REQUESTS)
    counts = scene_counts(ds)
    cap = int(cfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS["test"])
    check(all(LYFT_MIN_VOXELS <= c["voxels_kept"] == c["voxels_occupied"]
              < cap for c in counts),
          f"data_lyft: voxels kept {[c['voxels_kept'] for c in counts]}, "
          f"occupied {[c['voxels_occupied'] for c in counts]}, floor "
          f"{LYFT_MIN_VOXELS}, cap {cap}")
    check(all(c["objects_present"] == c["objects_labelled"] > 0
              for c in counts), f"data_lyft: objects lost: {counts}")
    emit("data_lyft", config=config,
         dataset="SyntheticDataset at the Lyft dataset yaml's geometry",
         point_cloud_range=list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
         point_features=list(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING
                             .used_feature_list),
         voxel_size=[float(v) for v in ds.voxel_size],
         grid_size=[int(g) for g in ds.grid_size], voxel_cap=cap,
         voxel_floor=LYFT_MIN_VOXELS,
         anchors_per_frame=int(model.dense_head.anchors.shape[0]),
         frames=counts,
         cuts="one sweep (timestamp 0); objects of class ids 1-3 only "
              "(car, truck, bus)")
    head = model.dense_head
    with torch.no_grad():
        for tower in head.heads:
            tower.conv_cls.bias.zero_()

    def request(r):
        return make_request(ds, r, lambda d, j: d.scene(j))
    raw0, _, _ = request(0)
    strict_f32(True)
    batch_f32 = load_data_to_device(raw0, device=dev)
    calibrate_bns(model, batch_f32)
    convs, _ = record_sparse_convs(model, batch_f32)
    check(len(convs) == LYFT_CONVS, f"lyft: {len(convs)} sparse convs")
    totals, worst, conv_rows = kernel_conv(convs, flush, mode, "lyft")
    s8_totals = {k: sum(r[f"{k}_s8"] or 0.0 for r in conv_rows)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    del convs
    strict_f32(False)

    # ------------------------------------------------------------- serving
    nms_cfg = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    post_max = int(nms_cfg.NMS_POST_MAXSIZE)
    sets_seen = []
    real_boxes_cuda = nms_mod.greedy_suppress_boxes_cuda

    def seen(corners, *args, **kw):
        sets_seen.append(list(corners.shape[:2]))
        return real_boxes_cuda(corners, *args, **kw)
    nms_mod.greedy_suppress_boxes_cuda = seen
    clear_launches(conv_k, nms_k)
    per_request = []
    try:
        for r in range(REQUESTS):
            raw, scene_ms, vox_ms = request(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = load_data_to_device(raw, device=dev,
                                        compute_dtype=torch.bfloat16)
            with torch.no_grad():
                out = model(batch)
            n_valid = out["final_valid"].sum(dim=1).tolist()
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            check(all(torch.isfinite(out[k].float()).all() for k in (
                "spatial_features_2d", "batch_box_preds", "final_boxes",
                "final_scores")), f"lyft request {r}: non-finite outputs")
            check(out["final_boxes"].shape == (BATCH, post_max, 7)
                  and out["batch_cls_preds"].dtype == torch.float32,
                  f"lyft request {r}: final_boxes "
                  f"{tuple(out['final_boxes'].shape)}, class map "
                  f"{out['batch_cls_preds'].dtype}")
            per_request.append({"request": r,
                                "frames": list(range(BATCH * r,
                                                     BATCH * (r + 1))),
                                "scene_ms": scene_ms, "voxelize_ms": vox_ms,
                                "host_ms": scene_ms + vox_ms,
                                "device_forward_ms": fwd_ms,
                                "valid_detections": n_valid})
            emit("serving_lyft_request", **per_request[-1])
    finally:
        nms_mod.greedy_suppress_boxes_cuda = real_boxes_cuda
    launches = kernel_launches(conv_k, nms_k)
    want = {"conv": LYFT_CONVS * REQUESTS, "nms_boxes": REQUESTS,
            "nms_iou": 0, "sets": [[BATCH * LYFT_SETS, LYFT_K]] * REQUESTS}
    got = {"conv": sum(conv_k.launches.values()),
           "nms_boxes": launches["greedy_nms_boxes"],
           "nms_iou": launches["greedy_nms_iou"], "sets": sets_seen}
    check(got == want, f"serving_lyft launches {got}, expected {want}")
    emit("serving_lyft", config=config, batch=BATCH, dtype="bf16",
         requests=REQUESTS, launches=launches, nms_sets_k=sets_seen,
         mode=mode(), steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]),
         steady_host_ms=statistics.median(
             p["host_ms"] for p in per_request[1:]))
    stages = stage_times(model, batch)
    emit("stages_lyft", dtype="bf16", batch=BATCH, mode=mode(), ms=stages,
         sparse_conv_kernels_ms=totals["ms"])
    del out, batch

    # ------------------------------------- whole model, kernels vs plain
    strict_f32(True)
    score_thresh = float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH)
    thresh = float(nms_cfg.NMS_THRESH)
    with torch.no_grad():
        model.set_kernel_impl("cuda")
        clear_launches(conv_k, nms_k)
        out_k = model(dict(batch_f32))
        torch.cuda.synchronize()
        cuda_launches = kernel_launches(conv_k, nms_k)
        model.set_kernel_impl("plain")
        clear_launches(conv_k, nms_k)
        out_p = model(dict(batch_f32))
        torch.cuda.synchronize()
        plain_launches = kernel_launches(conv_k, nms_k)
        model.set_kernel_impl(None)
    check(not any(plain_launches.values()),
          f"model_lyft: the plain run launched {plain_launches}")
    check(cuda_launches["greedy_nms_boxes"] == 1 and sum(
        conv_k.launches.values()) == 0, f"model_lyft: {cuda_launches}")
    map_err = {}
    for key in ("spatial_features", "spatial_features_2d", "cls_preds",
                "box_preds"):
        a, b = out_k[key], out_p[key]
        if key == "cls_preds":                # the absent channels: equal
            absent = b == ABSENT_LOGIT
            check(torch.equal(a[absent], b[absent]),
                  "model_lyft: absent class channels differ")
            a, b = a[~absent], b[~absent]
        err, mag = float((a - b).abs().max()), float(b.abs().max())
        map_err[key] = {"max_abs": err, "scale": mag}
        check(err <= KITTI_MAP_RTOL * max(1.0, mag),
              f"model_lyft f32 {key}: kernels vs plain max err {err} "
              f"(scale {mag})")
    cand, cand_valid = lyft_candidates(out_k, nms_cfg, score_thresh)
    check(tuple(cand_valid.shape) == (BATCH * LYFT_SETS, LYFT_K),
          f"model_lyft: candidate sets {tuple(cand_valid.shape)}")
    aabb_iou = aligned_iou_bev(cand)
    with torch.no_grad():
        check(torch.equal(
            nms_mod.greedy_nms_boxes(cand, cand_valid, thresh, impl="cuda"),
            nms_mod.greedy_nms_boxes(cand, cand_valid, thresh, impl="plain")),
            "model_lyft: boxes-form keep masks differ on identical "
            "candidates")
        check(torch.equal(
            nms_mod.greedy_nms(aabb_iou, cand_valid, thresh, impl="cuda"),
            nms_mod.greedy_nms(aabb_iou, cand_valid, thresh, impl="plain")),
            "model_lyft: IoU-form keep masks (nms_normal_bev's IoU) differ")
        finals = []
        for impl in ("cuda", "plain"):
            model.kernel_impl = impl
            finals.append(model.post_processing(
                {k: out_k[k] for k in ("batch_cls_preds", "batch_box_preds",
                                       "cls_preds_normalized")}))
        model.kernel_impl = None
        normal = []
        for impl in ("cuda", "plain"):
            normal.append(model_nms_utils.multi_classes_nms(
                torch.sigmoid(out_k["batch_cls_preds"]),
                out_k["batch_box_preds"],
                type(nms_cfg)({**nms_cfg, "NMS_TYPE": "nms_normal_gpu"}),
                score_thresh, impl=impl))
    for key in ("final_boxes", "final_scores", "final_labels", "final_valid"):
        check(torch.equal(finals[0][key], finals[1][key]),
              f"model_lyft: {key} differs between NMS kernel and plain on "
              f"identical inputs")
    check(all(torch.equal(a, b) for a, b in zip(*normal)),
          "model_lyft: multi_classes_nms under nms_normal_gpu differs")
    # end to end: every detection of one run has its partner in the other
    # within the tolerances the maps' (KITTI_MAP_RTOL of their scale)
    # carry through the decode and the sigmoid: x and y move by the
    # encoded error times the anchor's BEV diagonal (up to the bus's
    # LYFT_DIAGONAL), sizes by it times themselves, so boxes of 13 m
    # anchors move by more than the default 1 mm
    box_tol = KITTI_MAP_RTOL * max(1.0, map_err["box_preds"]["scale"])
    score_tol = 0.25 * KITTI_MAP_RTOL * max(1.0, map_err["cls_preds"]["scale"])
    matched, total = matched_detections(out_k, out_p, BATCH, box_tol,
                                        score_tol, LYFT_DIAGONAL)
    frac = matched / max(total, 1)
    labels = out_k["final_labels"][out_k["final_valid"]]
    first_diff = first_difference(model, batch_f32)
    emit("model_lyft", dtype="f32", mode=mode(), map_max_abs_err=map_err,
         map_tolerance=f"max|k-p| <= {KITTI_MAP_RTOL} * max(1, max|p|)",
         launches=cuda_launches,
         nms_identical_inputs=f"keep masks (boxes form, and the IoU form on "
         f"nms_normal_bev's IoU; {BATCH * LYFT_SETS} sets, K={LYFT_K}), "
         "post_processing's detections and multi_classes_nms under "
         "nms_normal_gpu equal",
         candidates_valid=int(cand_valid.sum()),
         labels=labels.unique().tolist(), first_difference=first_diff,
         detection_tolerance={"box": f"{box_tol} x max({LYFT_DIAGONAL}, "
                                     "|value|) per element",
                              "score": score_tol},
         detections_matched=matched, detections=total,
         matched_fraction=frac,
         matched_within_1mm=matched_detections(out_k, out_p, BATCH)[0])
    check(total > 0 and frac >= 0.99 and len(labels.unique()) > 1,
          f"model_lyft: {matched}/{total} detections matched, labels "
          f"{labels.unique().tolist()}")

    # ------------------------------------------- kernel 2 on the 18 sets
    near, needed, most = check_boxes_form(cand, cand_valid, thresh, "lyft")
    corners, areas = nms_mod.bev_corners_areas(cand)
    s_, k_ = cand_valid.shape
    terms = boxes_bound(s_, k_, needed, near, clock_mhz)
    nms_row = {"entry": "q3d_greedy_nms_boxes", "sets": s_, "K": k_,
               "valid": int(cand_valid.sum()), "candidate_pairs": needed,
               "near_pairs": near, "near_pairs_most_in_a_tile": most,
               "kept": int(nms_mod.greedy_nms_boxes(cand, cand_valid,
                                                    thresh).sum()),
               "ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_cuda(
                   corners, areas, cand_valid, thresh), flush=flush),
               "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_plain(
                   cand, cand_valid, thresh), reps=3, flush=flush),
               "multi_classes_nms_ms": time_ms(
                   lambda: model_nms_utils.multi_classes_nms(
                       torch.sigmoid(out_k["batch_cls_preds"]),
                       out_k["batch_box_preds"], nms_cfg, score_thresh),
                   flush=flush),
               **{f"{k}_ms": v for k, v in terms.items()},
               "kernel_us": kernel_device_us(
                   lambda: nms_mod.greedy_suppress_boxes_cuda(
                       corners, areas, cand_valid, thresh),
                   ("nms_box_pairs_kernel", "nms_box_iou_kernel",
                    "nms_sweep_kernel"), flush)}
    nms_row["bound_by"] = max(terms, key=terms.get)
    nms_row["bound_ms"] = terms[nms_row["bound_by"]]
    # the IoU form on the same sets, as nms_normal_bev runs it: the
    # entries the function needs (j < i, both valid) read once, one
    # compare each, valid read and keep written once; the sweep's chain
    n_c = cand_valid.sum(1).double()
    pairs = float((n_c * (n_c - 1) / 2).sum())
    iou_terms = {"bytes": 1e3 * (pairs * 4 + 2 * s_ * k_) / HBM_BYTES_PER_S,
                 "operations": 1e3 * pairs / PEAK_OPS_PER_S["f32"],
                 "latency": 1e3 * k_ * 4 / (clock_mhz * 1e6)}
    iou_row = {"entry": "q3d_greedy_nms", "sets": s_, "K": k_,
               "kept": int(nms_mod.greedy_nms(aabb_iou, cand_valid,
                                              thresh).sum()),
               "ms": time_ms(lambda: nms_mod.greedy_suppress_cuda(
                   aabb_iou, cand_valid, thresh), flush=flush),
               "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_plain(
                   aabb_iou, cand_valid, thresh), reps=3, flush=flush),
               "aabb_iou_ms": time_ms(lambda: aligned_iou_bev(cand),
                                      flush=flush),
               **{f"{k}_ms": v for k, v in iou_terms.items()}}
    iou_row["bound_by"] = max(iou_terms, key=iou_terms.get)
    iou_row["bound_ms"] = iou_terms[iou_row["bound_by"]]
    emit("kernel_nms_lyft", form="boxes", **nms_row, max_abs_err=0,
         mode=mode(), clock_max_sm_mhz=clock_mhz,
         tolerance="keep masks exactly equal, IoU bit-equal at every "
         "evaluated pair, plain IoU exactly 0 at every skipped needed pair")
    emit("kernel_nms_lyft", form="iou (nms_normal_bev)", **iou_row,
         max_abs_err=0, mode=mode(), clock_max_sm_mhz=clock_mhz,
         tolerance="keep masks exactly equal")
    del aabb_iou, corners, areas, out_k, out_p, finals, normal

    # ------------------------------------------------------------ recipes
    recipes = {}
    cases = (("second_recipe()", lambda m: quant_api.quantize_model(
                 m, quant_api.second_recipe(), batch_f32)),
             ("int8_deploy_recipe()", lambda m: quant_api.quantize_model(
                 m, quant_api.int8_deploy_recipe(), batch_f32)),
             ("int8 residency", lambda m: quant_api.prepare_int8_deploy(
                 m, [batch_f32, batch_f32])))
    for tag, prepare in cases:
        m = copy.deepcopy(model)
        t0 = time.perf_counter()
        prepare(m)
        prep_s = time.perf_counter() - t0
        k1 = set(kernel1_convs(m))
        q_sparse = sum(getattr(mod, "rule", None) is not None
                       for n, mod in m.named_modules() if n in k1)
        q_dense = sum(isinstance(mod, Conv2d) and mod.rule is not None
                      for mod in m.modules())
        calls, outs, runs = [], {}, {}
        with recording_launches(calls):
            with torch.no_grad():
                for impl in ("cuda", "plain"):
                    m.set_kernel_impl(impl)
                    clear_launches(conv_k, nms_k)
                    outs[impl] = m(dict(batch_f32))
                    torch.cuda.synchronize()
                    runs[impl] = {k: v for k, v in
                                  kernel_launches(conv_k, nms_k).items() if v}
                m.set_kernel_impl(None)
        got = runs["cuda"]
        int8 = tag != "second_recipe()"
        conv_sum = sum(v for k, v in got.items()
                       if k.startswith("sparse_gather_conv"))
        want_int8 = got.get("sparse_gather_conv_s8", 0) \
            + got.get("sparse_gather_conv_s8_requant", 0)
        check(conv_sum == LYFT_CONVS and got.get("greedy_nms_boxes") == 1
              and want_int8 == (q_sparse if int8 else 0)
              and got.get("int_mm_conv2d", 0) == (q_dense if int8 else 0)
              and ("residency" not in tag
                   or got.get("sparse_gather_conv_s8_requant", 0) > 0)
              and not runs["plain"],
              f"recipes_lyft {tag}: launches {runs}, {q_sparse} int8 sparse "
              f"convs, {q_dense} int8 dense convs")
        check(len(calls) == conv_sum, f"recipes_lyft {tag}: {len(calls)} "
                                      f"launches recorded, {conv_sum} counted")
        held = hold_launches_on_operands(calls, f"recipes_lyft {tag}")
        del calls
        ok_, op = outs["cuda"], outs["plain"]
        row = {"launches": got, "quantized_sparse": q_sparse,
               "quantized_dense": q_dense, "prepare_s": prep_s,
               "valid": [int(ok_["final_valid"].sum()),
                         int(op["final_valid"].sum())], **held}
        if int8:
            for key in ("spatial_features", "spatial_features_2d",
                        "batch_cls_preds", "final_boxes", "final_scores",
                        "final_labels", "final_valid"):
                check(torch.equal(ok_[key], op[key]),
                      f"recipes_lyft {tag}: {key} differs, kernels vs plain")
            row["equal"] = "maps, class scores and detections, kernels vs " \
                           "plain"
        else:
            # fake-quant: a summation-order difference flips a rounding of
            # 1/127 of a tensor's amax, and each flip spreads through the
            # [5, 5] BEV layers on these random weights, so the whole
            # forward is held launch by launch on its own operands (above)
            # and its end-to-end distance is reported
            for key in ("spatial_features", "spatial_features_2d",
                        "box_preds"):
                a, b = ok_[key], op[key]
                check(bool(torch.isfinite(a).all()),
                      f"recipes_lyft {tag}: {key} not finite")
                row[f"{key}_max_abs_err"] = {
                    "max_abs": float((a - b).abs().max()),
                    "scale": float(b.abs().max())}
            n, matched, worst_fq = detections_near(
                [to_host(ok_)], [to_host(op)], FQ_MIN_SCORE, FQ_BOX_TOL,
                FQ_SCORE_TOL)
            row.update(detections=n, matched_within_fq_tolerances=matched)
        recipes[tag] = row
        emit("recipes_lyft", recipe=tag, dtype="f32", batch=BATCH,
             mode=mode(), **row)
        del m, outs
    strict_f32(False)
    del model, batch_f32
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- training
    from q3d_tpu_torch.config import EDict
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.train_utils import MODEL_KEYS, train_step
    tcfg, _, loader, tmodel = lyft_model(dev, LYFT_TRAIN_FRAMES,
                                         training=True)
    raw = next(iter(loader))
    tbatch = load_data_to_device({k: v for k, v in raw.items()
                                  if k in MODEL_KEYS}, device=dev)
    idle = lyft_idle_box_convs(tmodel, raw["gt_boxes"])
    strict_f32(True)
    recorded, run = train_grad(tmodel, tbatch, conv_k, mode,
                               "train_grad_lyft", config, LYFT_CONVS, idle)
    fwd = kernel_forward(recorded, flush, mode, "kernel_fwd_lyft", config)
    dx = kernel_dx(recorded, flush, mode, "kernel_dx_lyft", config)
    del recorded

    # QAT under second_recipe() (no tower's output conv in its no_list)
    qmodel = copy.deepcopy(tmodel)
    quant_api.quantize_model(qmodel, quant_api.second_recipe(), tbatch)
    quantized = [n for n, mod in qmodel.named_modules()
                 if getattr(mod, "rule", None) is not None
                 and getattr(mod, "weight", None) is not None]
    qruns = {}
    for impl in ("cuda", "plain"):
        mq = copy.deepcopy(qmodel)
        mq.set_kernel_impl(impl)
        opt = build_optimizer(mq.parameters(), EDict(QAT_OPTIM), QAT_STEPS)
        conv_k.launches.clear()
        with recording_backward(mq) as rec_q:
            loss = float(train_step(mq, tbatch, opt)[0])
        qruns[impl] = (mq, loss, sum(conv_k.launches.values()), rec_q)
    del qmodel
    mk, loss_k, q_launches, rec_q = qruns["cuda"]
    check(q_launches == 2 * LYFT_CONVS - 1 and qruns["plain"][2] == 0,
          f"qat_lyft: kernel-1 launches {q_launches} / {qruns['plain'][2]}")
    layers = hold_conv_launches(rec_q)
    del rec_q
    params = dict(mk.named_parameters())
    for n in quantized:
        g = params[f"{n}.weight"].grad
        check(bool(torch.isfinite(g).all())
              and (f"{n}.weight" in idle or bool(g.abs().max() > 0)),
              f"qat_lyft: {n}.weight gradient")
    summary = compare_training(mk, qruns["plain"][0], loss_k,
                               qruns["plain"][1], qat=True, zero_extra=idle)
    emit("qat_lyft", config=config, recipe="second_recipe()",
         batch=int(tbatch["voxels"].shape[0]), mode=mode(),
         quantized_convs=len(quantized), launches_step=q_launches,
         tolerance=QAT_TOL, layers=layers, **summary)
    del qruns, mk, params, tmodel, tbatch
    strict_f32(False)
    torch.cuda.empty_cache()

    # the small Lyft model learning on one batch
    import dataclasses
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.lyft_synthetic import (SCENE_CLASSES,
                                                       lyft_config,
                                                       small_config)
    from q3d_tpu_torch.models import build_network
    from q3d_tpu_torch.models.builder import dataset_info
    scfg = small_config(lyft_config(BATCH, SEED), BATCH, SEED)
    sds, sloader, _ = build_dataloader(scfg.DATA_CONFIG, list(SCENE_CLASSES),
                                       batch_size=BATCH, training=False)
    smodel = build_network(scfg.MODEL, len(scfg.CLASS_NAMES),
                           dataclasses.replace(dataset_info(sds),
                                               class_names=tuple(
                                                   scfg.CLASS_NAMES)),
                           device=dev)
    sraw = next(iter(sloader))
    sbatch = load_data_to_device({k: v for k, v in sraw.items()
                                  if k in MODEL_KEYS}, device=dev)
    opt = build_optimizer(smodel.parameters(), EDict(
        {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.0}), TINY_STEPS)
    losses = [float(train_step(smodel, sbatch, opt)[0])
              for _ in range(TINY_STEPS)]
    check(losses[-1] < 0.9 * losses[0], f"train_tiny_lyft: losses {losses}")
    emit("train_tiny_lyft", config=f"{config}, lyft_synthetic.small_config",
         batch=BATCH, mode=mode(),
         optimizer="adam, lr 3e-3, no weight decay, clip 10", losses=losses,
         fall=1 - losses[-1] / losses[0])
    del smodel, sbatch

    # train_model at the yaml's batch, its OPTIMIZATION and DATA_AUGMENTOR
    import shutil
    tcfg, tds, tloader, tmodel = lyft_model(dev, LYFT_TRAIN_FRAMES,
                                            training=True, augment=True)
    queue = tds.data_augmentor.data_augmentor_queue
    check([q.func.__name__ for q in queue]
          == ["random_world_flip", "random_world_rotation",
              "random_world_scaling"], f"train_lyft: augmentor {queue}")
    ckpt_dir = ROOT / "output" / "chip_smoke_train_lyft"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    nms_k.launches.clear()
    try:
        _, steps, t_launches, run_s = timed_train_model(
            tmodel, tcfg.OPTIMIZATION, tds, tloader, ckpt_dir, conv_k, dev,
            "train_lyft", no_signal=idle, any_step=True)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps = len(steps)
    check(t_launches == {"q3d_sparse_gather_conv_f32":
                         (2 * LYFT_CONVS - 1) * n_steps}
          and not any(nms_k.launches.values()),
          f"train_lyft: launches {t_launches}, NMS {dict(nms_k.launches)}")
    med = median_after_first(steps)
    batch_size = int(tcfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    emit("train_lyft", config=config, batch=batch_size,
         frames=LYFT_TRAIN_FRAMES, epochs=TRAIN_EPOCHS, steps=n_steps,
         mode=mode(),
         optimization={k: tcfg.OPTIMIZATION[k] for k in (
             "OPTIMIZER", "LR", "WEIGHT_DECAY", "GRAD_NORM_CLIP")},
         augmentor=[c.NAME for c in
                    tcfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST],
         losses=[s["loss"] for s in steps], launches=t_launches,
         run_s=run_s, zero_gradient_allowed=sorted(idle),
         median_after_first=med)
    del tmodel
    torch.cuda.empty_cache()
    return {"launches": launches, "totals": totals, "worst": worst,
            "s8": s8_totals, "stages": stages, "nms": nms_row,
            "nms_iou": iou_row, "recipes": recipes, "fwd": fwd, "dx": dx,
            "peak_mib": run["peak_mib"], "batch": batch_size,
            "trained": {"launches_forward": sum(s["launches_forward"]
                                                for s in steps),
                        "launches_dx": sum(s["launches_dx"] for s in steps),
                        "median": med, "steps": n_steps}}


def lyft_kernel_rows(lyft):
    """The kernels line's Lyft entries: kernel 1 on the 21 convs of a bf16
    forward (its s8 times beside), as the f32 forward and the input
    gradient of a training step, and kernel 2 on the forward's BATCH x 9
    candidate sets (the IoU form under nms_normal_bev beside)."""
    config = "lyft_models/cbgs_second_multihead.yaml"
    common = {"route": "cuda",
              "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
              "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
              "library_ms": None, "checks": "passed"}
    t = lyft["totals"]
    rows = [{**common, "name": "sparse_gather_conv_lyft",
             "entry": "q3d_sparse_gather_conv_bf16",
             "use": f"{config}: VoxelResBackBone8x's 21 convs, bf16",
             "launches": lyft["launches"]["sparse_gather_conv_bf16"],
             "max_abs_err": lyft["worst"]["bf16"], "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
             else "operations", "library_ms": t["library_ms"],
             "s8": {**lyft["s8"], "max_abs_err": lyft["worst"]["s8"]},
             "times_cover": f"one bf16 forward at batch {BATCH} (21 convs); "
                            f"launches: serving_lyft's {REQUESTS} requests"}]
    steps = lyft["trained"]["steps"]
    for use, tot, launches in (
            ("forward", lyft["fwd"], lyft["trained"]["launches_forward"]),
            ("dx", lyft["dx"], lyft["trained"]["launches_dx"])):
        row = {**common, "name": f"sparse_gather_conv_{use}_lyft_train",
               "entry": "q3d_sparse_gather_conv_f32",
               "use": f"{config} training, batch {lyft['batch']}: the "
                      + ("forward of its 21 sparse convs" if use == "forward"
                         else "input gradient of every sparse conv but "
                              "conv_input, over the inverse book"),
               "launches": launches,
               **{k: tot[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")},
               "times_cover": f"one f32 training step's launches; launches: "
                              f"train_lyft's {steps} steps",
               "peak_mib_train_grad": lyft["peak_mib"]}
        if use == "dx":
            row.update(dw_torch_ms=tot["dw_ms"],
                       inverse_book_ms=tot["inverse_ms"])
        rows.append(row)
    n, i = lyft["nms"], lyft["nms_iou"]
    rows.append({"name": "greedy_nms_lyft", "route": "cuda",
                 "source": "q3d_tpu_torch/csrc/greedy_nms.cu",
                 "replaces": "q3d_tpu/ops/iou3d_nms/pallas_nms.py:45",
                 "entry": "q3d_greedy_nms_boxes",
                 "launches": lyft["launches"]["greedy_nms_boxes"],
                 "max_abs_err": 0.0, "ms": n["ms"], "plain_ms": n["plain_ms"],
                 "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
                 "library_ms": None, "checks": "passed",
                 "times_cover": f"one forward's multi-class NMS: {n['sets']} "
                                f"sets, K={n['K']}",
                 "iou_form_nms_normal_bev": {k: i[k] for k in (
                     "entry", "sets", "K", "ms", "plain_ms", "bound_ms",
                     "bound_by")}})
    return rows


PN_CFG = ROOT / "q3d_tpu_torch" / "cfgs" / "nuscenes_models" / \
    "cbgs_pillar0075_res2d_centerpoint.yaml"
PN_CONFIG = "q3d_tpu_torch/cfgs/nuscenes_models/" \
    "cbgs_pillar0075_res2d_centerpoint.yaml"
# PillarRes18BackBone8x's sparse convs: four SubM 32, a strided 32 -> 64,
# four SubM 64, a strided 64 -> 128, four SubM 128, a strided 128 -> 256,
# four SubM 256; all 19 take an input gradient in training
PN_CONVS = 19
PN_TRAIN_FRAMES = 8
# dynvoxel_ref: centerpoint_ref's voxel size and per-frame voxel cap
DV_VOXEL_SIZE, DV_MAX_VOXELS = [0.075, 0.075, 0.2], 160000


def pillar_data_config(cfg_path, frames):
    """``cfg_path``'s config, and centerpoint_ref's with ``cfg_path``'s
    DATA_PROCESSOR (only the grid's size; no voxelizer) and MAX_RAW_POINTS
    (the raw points collated) over ``frames`` frames -> (config, scene
    config)."""
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    vcfg = cfg_from_yaml_file(str(cfg_path), EDict())
    scfg = cfg_from_yaml_file(str(CFG), EDict())
    dc = scfg.DATA_CONFIG
    dc.DATA_PROCESSOR = vcfg.DATA_CONFIG.DATA_PROCESSOR
    dc.MAX_RAW_POINTS = vcfg.DATA_CONFIG.MAX_RAW_POINTS
    dc.NUM_FRAMES = frames
    return vcfg, scfg


def raw_points_model(dev, vcfg, scfg, batch, training=False):
    """A model of ``vcfg``'s MODEL and CLASS_NAMES (seeded weights) on the
    synthetic scenes of ``scfg`` (a test loader, or a training loader with
    the points shuffled) -> (dataset, loader, model)."""
    import dataclasses
    import numpy as np
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network
    from q3d_tpu_torch.models.builder import dataset_info
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(scfg.DATA_CONFIG, scfg.CLASS_NAMES,
                                     batch_size=batch, training=training,
                                     seed=SEED)
    info = dataclasses.replace(dataset_info(ds),
                               class_names=tuple(vcfg.CLASS_NAMES))
    return ds, loader, build_network(vcfg.MODEL, len(vcfg.CLASS_NAMES), info,
                                     device=dev)


def pillar_counts(ds, raw):
    """One numpy batch's frames: points collated against MAX_RAW_POINTS
    and the 2D cells they occupy on the grid -> [{points, occupied}]."""
    import numpy as np
    nx, ny = (int(g) for g in ds.grid_size[:2])
    vx, vy = (np.float32(v) for v in ds.voxel_size[:2])
    x0, y0 = (np.float32(v) for v in ds.point_cloud_range[:2])
    out = []
    for pts, mask in zip(raw["points"], raw["points_mask"]):
        p = pts[mask]
        cx = np.floor((p[:, 0] - x0) / vx).astype(np.int64)
        cy = np.floor((p[:, 1] - y0) / vy).astype(np.int64)
        ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
        out.append({"points": int(mask.sum()),
                    "occupied": int(np.unique(cy[ok] * nx + cx[ok]).size)})
    return out


def kernels_vs_plain_centerhead(model, batch, conv_k, nms_k, tag, convs):
    """A CenterHead model's request (f32, TF32 off) through the kernels and
    through the plain versions: the launches (``convs`` kernel-1 launches
    and one boxes-form NMS through the kernels, none through the plain
    versions), the BEV map and every head map within 1e-4 of max(1,
    scale) (f32 sums in another order), kernel 2's keep masks and the
    head's detections equal on identical candidates, 99% of the
    detections end to end matched (box 1e-3, score 1e-4), as
    ``model_check`` holds centerpoint_ref -> summary."""
    import torch
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    head = model.dense_head
    outs, launches = {}, {}
    with torch.no_grad():
        for impl in ("cuda", "plain"):
            model.set_kernel_impl(impl)
            clear_launches(conv_k, nms_k)
            outs[impl] = model(dict(batch))
            torch.cuda.synchronize()
            launches[impl] = {k: v for k, v in kernel_launches(
                conv_k, nms_k).items() if v}
        model.set_kernel_impl(None)
    got = launches["cuda"]
    check(not launches["plain"] and got.get("greedy_nms_boxes") == 1
          and sum(v for k, v in got.items()
                  if k.startswith("sparse_gather_conv")) == convs,
          f"{tag}: launches {launches}")
    ok_, op = outs["cuda"], outs["plain"]
    maps = {"spatial_features_2d": (ok_["spatial_features_2d"],
                                    op["spatial_features_2d"])}
    for h, (pk, pp) in enumerate(zip(ok_["pred_dicts"], op["pred_dicts"])):
        for key in pk:
            maps[f"head{h}.{key}"] = (pk[key], pp[key])
    map_err = {}
    for key, (a, b) in maps.items():
        err, mag = float((a - b).abs().max()), float(b.abs().max())
        map_err[key] = {"max_abs": err, "scale": mag}
        check(bool(torch.isfinite(a).all()) and err <= 1e-4 * max(1.0, mag),
              f"{tag} {key}: kernels vs plain max err {err} (scale {mag})")
    nms_cfg = head.model_cfg.POST_PROCESSING.NMS_CONFIG
    thresh = float(nms_cfg.NMS_THRESH)
    with torch.no_grad():
        cand = head._decode(ok_["pred_dicts"])
        kc = min(int(nms_cfg.NMS_PRE_MAXSIZE), cand[0].shape[1])
        bx, bv = cand[0][:, :kc, :7].contiguous(), cand[3][:, :kc].contiguous()
        check(torch.equal(
            nms_mod.greedy_nms_boxes(bx, bv, thresh, impl="cuda"),
            nms_mod.greedy_nms_boxes(bx, bv, thresh, impl="plain")),
            f"{tag}: NMS keep masks differ on identical candidates")
        finals = []
        for impl in ("cuda", "plain"):
            head.kernel_impl = impl
            bd = {}
            head._nms(bd, *cand)
            finals.append(bd)
        head.kernel_impl = None
    for key in ("final_boxes", "final_scores", "final_labels", "final_valid"):
        check(torch.equal(finals[0][key], finals[1][key]),
              f"{tag}: {key} differs between NMS kernel and plain on "
              f"identical candidates")
    matched, total = matched_detections(ok_, op, BATCH)
    frac = matched / max(total, 1)
    check(total > 0 and frac >= 0.99,
          f"{tag}: only {matched}/{total} detections matched")
    return {"launches": got, "map_max_abs_err": map_err,
            "map_tolerance": "max|k-p| <= 1e-4 * max(1, max|p|)",
            "nms_sets_k": list(bv.shape), "detections": total,
            "detections_matched": matched, "matched_fraction": frac,
            "nms_identical_inputs": "keep masks and the head's detections "
            "equal"}, ok_, (bx, bv, thresh)


def pillarnet_phases(dev, conv_k, nms_k, mode, strict_f32, flush, clock_mhz):
    """PillarNet at the nuScenes width (``PN_CONFIG``: DynamicPillarVFE,
    PillarRes18BackBone8x's 19 sparse 2D convs, the dense conv5,
    BaseBEVBackboneV1 [5, 5], CenterHead's six heads; seeded weights, BN
    statistics from the first request, f32 with TF32 off where held against
    plain) on centerpoint_ref's scenes: ``data_pillarnet`` (points and
    pillars a frame against MAX_RAW_POINTS and MAX_PILLARS: none dropped),
    ``kernel_conv`` for the 19 convs (f32, bf16, s8 against plain; the
    256-wide instances among them), ``serving_pillarnet`` (4 bf16 requests:
    19 kernel-1 launches and one boxes-form NMS launch each; host ms apart
    from device ms), ``stages_pillarnet``, ``model_pillarnet`` (f32,
    kernels vs plain), ``kernel_nms_pillarnet`` (that forward's candidate
    sets against plain, timed, its bound), ``recipes_pillarnet``
    (``int8_deploy_recipe()``: the 19 sparse convs on kernel 1's s8 entry,
    the dense convs through ``_int_mm``, each launch held against its plain
    version on its own operands, maps and detections equal end to end),
    ``train_grad_pillarnet`` (one training step at batch 2, kernels vs
    plain, 19 forward and 19 dX launches), ``kernel_fwd_pillarnet`` /
    ``kernel_dx_pillarnet`` and ``train_pillarnet`` (``train_model``, 8
    steps at batch 2) -> summaries for the kernels line."""
    import numpy as np
    import torch
    from q3d_tpu_torch.models import load_data_to_device
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns

    # ---------------------------------------------------------------- data
    cfg, scfg = pillar_data_config(PN_CFG, BATCH * REQUESTS)
    dc = scfg.DATA_CONFIG
    ds, _, model = raw_points_model(dev, cfg, scfg, BATCH)
    cap = int(cfg.MODEL.VFE.MAX_PILLARS)
    frames, kept = [], []
    strict_f32(True)
    with torch.no_grad():
        for r in range(REQUESTS):
            raw, _, _ = make_request(ds, r)
            counts = pillar_counts(ds, raw)
            sizes = [len(ds.prepare_data({"points": p, "gt_boxes": b,
                                          "gt_names": n, "frame_id": j})
                         ["points"])
                     for j, (p, b, n) in ((j, plain_scene(ds, j)[:3])
                                          for j in range(r * BATCH,
                                                         (r + 1) * BATCH))]
            for c, n in zip(counts, sizes):
                c["points_before_collate"] = n
            vfe_out = model.vfe(load_data_to_device(raw, device=dev))
            kept.append(int((vfe_out["pillar_coords"][:, 0] >= 0).sum()))
            frames += counts
    batch_occupied = [frames[2 * r]["occupied"] + frames[2 * r + 1]["occupied"]
                      for r in range(REQUESTS)]
    check(all(c["points"] == c["points_before_collate"]
              < int(dc.MAX_RAW_POINTS) for c in frames)
          and kept == batch_occupied and max(kept) < cap,
          f"data_pillarnet: frames {frames}, pillars kept {kept}, occupied "
          f"{batch_occupied}, cap {cap}")
    emit("data_pillarnet", config=PN_CONFIG, scenes=CFG.name,
         point_cloud_range=list(dc.POINT_CLOUD_RANGE),
         pillar_size=[float(v) for v in ds.voxel_size],
         grid_size=[int(g) for g in ds.grid_size],
         max_raw_points=int(dc.MAX_RAW_POINTS), max_pillars=cap,
         frames=frames, pillars_kept_per_batch=kept,
         points_dropped=sum(c["points_before_collate"] - c["points"]
                            for c in frames),
         pillars_dropped=sum(batch_occupied) - sum(kept),
         cuts="4 point features, one sweep (no timestamp column), "
              "synthetic scenes, seeded weights")

    def request(r):
        return make_request(ds, r)
    raw0, _, _ = request(0)
    batch_f32 = load_data_to_device(raw0, device=dev)
    calibrate_bns(model, batch_f32)
    convs, _ = record_sparse_convs(model, batch_f32)
    check(len(convs) == PN_CONVS and sum(c[3].shape[1:] == (256, 256)
                                         for c in convs) == 4,
          f"pillarnet: {len(convs)} sparse convs")
    totals, worst, conv_rows = kernel_conv(convs, flush, mode, "pillarnet")
    wide = [r for r in conv_rows if 256 in (r["Cin"], r["Cout"])]
    s8_totals = {k: sum(r[f"{k}_s8"] or 0.0 for r in conv_rows)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    wide_totals = {f"{k}_{t}": sum(r[f"{k}_{t}"] or 0.0 for r in wide)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")
                   for t in ("f32", "bf16", "s8")}
    emit("kernel_conv_pillarnet_256", convs=len(wide), **wide_totals,
         widths=sorted({(r["Cin"], r["Cout"]) for r in wide}),
         times="sums over the convs with a 256-wide side")
    del convs
    strict_f32(False)

    # ------------------------------------------------------------- serving
    sets_seen = []
    real_boxes_cuda = nms_mod.greedy_suppress_boxes_cuda

    def seen(corners, *args, **kw):
        sets_seen.append(list(corners.shape[:2]))
        return real_boxes_cuda(corners, *args, **kw)
    nms_mod.greedy_suppress_boxes_cuda = seen
    clear_launches(conv_k, nms_k)
    per_request = []
    try:
        for r in range(REQUESTS):
            raw, scene_ms, prep_ms = request(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = load_data_to_device(raw, device=dev,
                                        compute_dtype=torch.bfloat16)
            with torch.no_grad():
                out = model(batch)
            n_valid = out["final_valid"].sum(dim=1).tolist()
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            check(all(torch.isfinite(out[k].float()).all() for k in (
                "spatial_features_2d", "final_boxes", "final_scores"))
                and out["pillar_features"].dtype == torch.bfloat16,
                f"pillarnet request {r}: non-finite outputs or "
                f"{out['pillar_features'].dtype} pillars")
            per_request.append({"request": r,
                                "frames": list(range(BATCH * r,
                                                     BATCH * (r + 1))),
                                "scene_ms": scene_ms, "pipeline_ms": prep_ms,
                                "host_ms": scene_ms + prep_ms,
                                "device_forward_ms": fwd_ms,
                                "valid_detections": n_valid})
            emit("serving_pillarnet_request", **per_request[-1])
    finally:
        nms_mod.greedy_suppress_boxes_cuda = real_boxes_cuda
    launches = kernel_launches(conv_k, nms_k)
    got = {"conv_bf16": launches["sparse_gather_conv_bf16"],
           "conv_other": sum(conv_k.launches.values())
           - launches["sparse_gather_conv_bf16"],
           "nms_boxes": launches["greedy_nms_boxes"],
           "nms_iou": launches["greedy_nms_iou"]}
    check(got == {"conv_bf16": PN_CONVS * REQUESTS, "conv_other": 0,
                  "nms_boxes": REQUESTS, "nms_iou": 0}
          and len({tuple(s) for s in sets_seen}) == 1,
          f"serving_pillarnet launches {got}, NMS sets {sets_seen}")
    emit("serving_pillarnet", config=PN_CONFIG, batch=BATCH, dtype="bf16",
         requests=REQUESTS, launches=launches, nms_sets_k=sets_seen[0],
         mode=mode(), steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]),
         steady_host_ms=statistics.median(
             p["host_ms"] for p in per_request[1:]))
    stages = stage_times(model, batch, extra={
        "conv5": model.backbone_3d.conv5})
    stages["sparse_backbone_2d"] = stages["backbone_3d"] - stages["conv5"]
    emit("stages_pillarnet", dtype="bf16", batch=BATCH, mode=mode(),
         ms=stages, sparse_conv_kernels_ms=totals["ms"],
         note="sparse_backbone_2d = backbone_3d (to x_conv5) - conv5; "
              "decode and nms inside dense_head")
    del out, batch

    # ------------------------------------- whole model, kernels vs plain
    strict_f32(True)
    summary, out_k, (bx, bv, thresh) = kernels_vs_plain_centerhead(
        model, batch_f32, conv_k, nms_k, "model_pillarnet", PN_CONVS)
    emit("model_pillarnet", dtype="f32", mode=mode(), **summary,
         first_difference=first_difference(model, batch_f32))

    # ------------------------------------- kernel 2 on the forward's sets
    near, needed, most = check_boxes_form(bx, bv, thresh, "pillarnet")
    corners, areas = nms_mod.bev_corners_areas(bx)
    s_, k_ = bv.shape
    terms = boxes_bound(s_, k_, needed, near, clock_mhz)
    nms_row = {"entry": "q3d_greedy_nms_boxes", "sets": s_, "K": k_,
               "valid": int(bv.sum()), "candidate_pairs": needed,
               "near_pairs": near, "near_pairs_most_in_a_tile": most,
               "kept": int(nms_mod.greedy_nms_boxes(bx, bv, thresh).sum()),
               "ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_cuda(
                   corners, areas, bv, thresh), flush=flush),
               "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_plain(
                   bx, bv, thresh), reps=3, flush=flush),
               **{f"{k}_ms": v for k, v in terms.items()}}
    nms_row["bound_by"] = max(terms, key=terms.get)
    nms_row["bound_ms"] = terms[nms_row["bound_by"]]
    emit("kernel_nms_pillarnet", form="boxes", **nms_row, max_abs_err=0,
         mode=mode(), clock_max_sm_mhz=clock_mhz,
         tolerance="keep masks exactly equal, IoU bit-equal at every "
         "evaluated pair, plain IoU exactly 0 at every skipped needed pair")
    del out_k, corners, areas

    # ------------------------------------------- int8_deploy_recipe()
    m8 = copy.deepcopy(model)
    t0 = time.perf_counter()
    quant_api.quantize_model(m8, quant_api.int8_deploy_recipe(), batch_f32)
    prep_s = time.perf_counter() - t0
    k1 = set(kernel1_convs(m8))
    q_sparse = sum(getattr(mod, "rule", None) is not None
                   for n, mod in m8.named_modules() if n in k1)
    q_dense = sum(isinstance(mod, Conv2d) and mod.rule is not None
                  for mod in m8.modules())
    calls, outs, runs, fwd_ms = [], {}, {}, {}
    with recording_launches(calls):
        with torch.no_grad():
            for impl in ("cuda", "plain"):
                m8.set_kernel_impl(impl)
                clear_launches(conv_k, nms_k)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[impl] = m8(dict(batch_f32))
                torch.cuda.synchronize()
                fwd_ms[impl] = (time.perf_counter() - t0) * 1e3
                runs[impl] = {k: v for k, v in
                              kernel_launches(conv_k, nms_k).items() if v}
            m8.set_kernel_impl(None)
    got = runs["cuda"]
    check(q_sparse == PN_CONVS and got.get("sparse_gather_conv_s8") == PN_CONVS
          and sum(v for k, v in got.items()
                  if k.startswith("sparse_gather_conv")) == PN_CONVS
          and got.get("int_mm_conv2d") == q_dense > 0
          and got.get("greedy_nms_boxes") == 1 and not runs["plain"],
          f"recipes_pillarnet: launches {runs}, {q_sparse} int8 sparse "
          f"convs, {q_dense} int8 dense convs")
    check(len(calls) == PN_CONVS, f"recipes_pillarnet: {len(calls)} "
                                  f"launches recorded")
    held = hold_launches_on_operands(calls, "recipes_pillarnet")
    del calls
    for key in ("spatial_features_2d", "final_boxes", "final_scores",
                "final_labels", "final_valid"):
        check(torch.equal(outs["cuda"][key], outs["plain"][key]),
              f"recipes_pillarnet: {key} differs, kernels vs plain")
    recipes = {"launches": got, "quantized_sparse": q_sparse,
               "quantized_dense": q_dense, "prepare_s": prep_s,
               "forward_ms": fwd_ms, **held,
               "valid": int(outs["cuda"]["final_valid"].sum()),
               "first_conv_quantized": getattr(
                   m8.backbone_3d.conv1[0].conv1, "rule", None) is not None}
    emit("recipes_pillarnet", recipe="int8_deploy_recipe()", dtype="f32",
         batch=BATCH, mode=mode(), **recipes,
         equal="maps and detections, kernels vs plain")
    del m8, outs
    strict_f32(False)
    del model, batch_f32
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- training
    from q3d_tpu_torch.train_utils import MODEL_KEYS
    tcfg, tscfg = pillar_data_config(PN_CFG, PN_TRAIN_FRAMES)
    tds, tloader, tmodel = raw_points_model(dev, tcfg, tscfg, BATCH,
                                            training=True)
    raw = next(iter(tloader))
    tbatch = load_data_to_device({k: v for k, v in raw.items()
                                  if k in MODEL_KEYS}, device=dev)
    quiet = zero_grads(tmodel, "pillarnet", raw["gt_boxes"])
    strict_f32(True)
    recorded, run = train_grad(tmodel, tbatch, conv_k, mode,
                               "train_grad_pillarnet", PN_CONFIG, PN_CONVS,
                               quiet, dx_convs=PN_CONVS)
    fwd = kernel_forward(recorded, flush, mode, "kernel_fwd_pillarnet",
                         PN_CONFIG)
    dx = kernel_dx(recorded, flush, mode, "kernel_dx_pillarnet", PN_CONFIG)
    del recorded, tbatch
    strict_f32(False)
    torch.cuda.empty_cache()

    import shutil
    ckpt_dir = ROOT / "output" / "chip_smoke_train_pillarnet"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    nms_k.launches.clear()
    try:
        _, steps, t_launches, run_s = timed_train_model(
            tmodel, tcfg.OPTIMIZATION, tds, tloader, ckpt_dir, conv_k, dev,
            "train_pillarnet", no_signal=quiet, any_step=True)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps = len(steps)
    check(t_launches == {"q3d_sparse_gather_conv_f32": 2 * PN_CONVS * n_steps}
          and not any(nms_k.launches.values()),
          f"train_pillarnet: launches {t_launches}, NMS "
          f"{dict(nms_k.launches)}")
    med = median_after_first(steps)
    emit("train_pillarnet", config=PN_CONFIG, scenes=CFG.name, batch=BATCH,
         frames=PN_TRAIN_FRAMES, epochs=TRAIN_EPOCHS, steps=n_steps,
         mode=mode(),
         optimization={k: tcfg.OPTIMIZATION[k] for k in (
             "OPTIMIZER", "LR", "WEIGHT_DECAY", "GRAD_NORM_CLIP")},
         losses=[s["loss"] for s in steps], launches=t_launches, run_s=run_s,
         zero_gradient_allowed=sorted(quiet), median_after_first=med,
         cut="batch 2 (the yaml's BATCH_SIZE_PER_GPU is 4), 8 frames, no "
             "augmentor")
    del tmodel
    torch.cuda.empty_cache()
    return {"launches": launches, "totals": totals, "worst": worst,
            "s8": s8_totals, "wide": wide_totals, "stages": stages,
            "nms": nms_row, "recipes": recipes, "fwd": fwd, "dx": dx,
            "peak_mib": run["peak_mib"],
            "trained": {"launches_forward": sum(s["launches_forward"]
                                                for s in steps),
                        "launches_dx": sum(s["launches_dx"] for s in steps),
                        "median": med, "steps": n_steps}}


def dynvoxel_ref(dev, conv_k, nms_k, mode, strict_f32):
    """Phase ``dynvoxel_ref``: centerpoint_ref's MODEL with its MeanVFE
    replaced by ``DynamicVoxelVFE`` (NUM_FILTERS [16, 16], the tiny
    config's, MAX_VOXELS 160,000 a frame, the ref's cap) and then by
    ``DynamicMeanVFE`` (MAX_VOXELS 160,000), on centerpoint_ref's scenes
    with the grid's size only (0.075 x 0.075 x 0.2 m) and the raw points
    collated (MAX_RAW_POINTS 250,000): one f32 request each, voxels kept
    against the cap, kernels vs plain as ``model_check`` holds them."""
    import torch
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.models import load_data_to_device
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
    strict_f32(True)
    for vfe in ({"NAME": "DynamicVoxelVFE", "WITH_DISTANCE": False,
                 "USE_ABSLOTE_XYZ": True, "USE_NORM": True,
                 "NUM_FILTERS": [16, 16], "MAX_VOXELS": DV_MAX_VOXELS},
                {"NAME": "DynamicMeanVFE", "MAX_VOXELS": DV_MAX_VOXELS}):
        cfg = cfg_from_yaml_file(str(CFG), EDict())
        cfg.MODEL.VFE = EDict(vfe)
        dc = cfg.DATA_CONFIG
        dc.DATA_PROCESSOR = dc.DATA_PROCESSOR[:2] + [EDict({
            "NAME": "calculate_grid_size", "VOXEL_SIZE": DV_VOXEL_SIZE})]
        dc.MAX_RAW_POINTS = 250000
        ds, _, model = raw_points_model(dev, cfg, cfg, BATCH)
        raw, _, _ = make_request(ds, 0)
        batch = load_data_to_device(raw, device=dev)
        with torch.no_grad():
            vout = model.vfe(dict(batch))
        voxels = (vout["voxel_num_points"] > 0).sum(1).tolist()
        check(max(voxels) < vfe["MAX_VOXELS"],
              f"dynvoxel_ref {vfe['NAME']}: voxels {voxels}")
        calibrate_bns(model, batch)
        summary, _, _ = kernels_vs_plain_centerhead(
            model, batch, conv_k, nms_k, f"dynvoxel_ref {vfe['NAME']}", 21)
        emit("dynvoxel_ref", vfe=vfe, scenes=CFG.name, dtype="f32",
             mode=mode(), voxels_per_frame=voxels, **summary,
             cut="NUM_FILTERS [16, 16] (centerpoint_dynvoxel_tiny's); "
                 "centerpoint_ref's MODEL otherwise")
        del model, batch, vout
        torch.cuda.empty_cache()
    strict_f32(False)


def pillarnet_kernel_rows(pn):
    """The kernels line's PillarNet entries: kernel 1 on the 19 convs of a
    bf16 forward (its s8 times and the 256-wide convs beside), as the f32
    forward and the input gradient of a training step, and kernel 2 on the
    forward's candidate sets."""
    common = {"route": "cuda",
              "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
              "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
              "checks": "passed"}
    t = pn["totals"]
    rows = [{**common, "name": "sparse_gather_conv_pillarnet",
             "entry": "q3d_sparse_gather_conv_bf16",
             "use": f"{PN_CONFIG}: PillarRes18BackBone8x's 19 sparse 2D convs "
                    "(K = 9), bf16",
             "launches": pn["launches"]["sparse_gather_conv_bf16"],
             "max_abs_err": pn["worst"]["bf16"], "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
             else "operations", "library_ms": t["library_ms"],
             "s8": {**pn["s8"], "max_abs_err": pn["worst"]["s8"]},
             "wide_256": pn["wide"],
             "times_cover": f"one bf16 forward at batch {BATCH} (19 convs); "
                            f"launches: serving_pillarnet's {REQUESTS} "
                            "requests"}]
    steps = pn["trained"]["steps"]
    for use, tot, launches in (
            ("forward", pn["fwd"], pn["trained"]["launches_forward"]),
            ("dx", pn["dx"], pn["trained"]["launches_dx"])):
        row = {**common, "name": f"sparse_gather_conv_{use}_pillarnet_train",
               "entry": "q3d_sparse_gather_conv_f32",
               "use": f"{PN_CONFIG} training, batch {BATCH}: the "
                      + ("forward of its 19 sparse convs" if use == "forward"
                         else "input gradient of all 19 sparse convs, over "
                              "the inverse book"),
               "launches": launches,
               **{k: tot[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")},
               "times_cover": f"one f32 training step's launches; launches: "
                              f"train_pillarnet's {steps} steps",
               "peak_mib_train_grad": pn["peak_mib"]}
        if use == "dx":
            row.update(dw_torch_ms=tot["dw_ms"],
                       inverse_book_ms=tot["inverse_ms"])
        rows.append(row)
    n = pn["nms"]
    rows.append({"name": "greedy_nms_pillarnet", "route": "cuda",
                 "source": "q3d_tpu_torch/csrc/greedy_nms.cu",
                 "replaces": "q3d_tpu/ops/iou3d_nms/pallas_nms.py:45",
                 "entry": "q3d_greedy_nms_boxes",
                 "launches": pn["launches"]["greedy_nms_boxes"],
                 "max_abs_err": 0.0, "ms": n["ms"], "plain_ms": n["plain_ms"],
                 "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
                 "library_ms": None, "checks": "passed",
                 "times_cover": f"one forward's NMS: {n['sets']} sets, "
                                f"K={n['K']}"})
    return rows


# ======================================================= two-stage detectors
# the two-stage detectors at the KITTI width (the port's own configs):
# VoxelBackBone8x's 12 convs (PartA2: UNetV2's 19, 3 of them inverse) on
# kernel 1, the proposal layer's one launch of kernel 2 (B sets of
# NMS_PRE_MAXSIZE = 1024, all valid: no score threshold there)
TS_CFG = {"pvrcnn": "pv_rcnn", "voxelrcnn": "voxel_rcnn_car",
          "parta2": "PartA2", "second_iou": "second_iou"}
TS_CONVS = {"pvrcnn": 12, "voxelrcnn": 12, "parta2": 19, "second_iou": 12}
TS_INVERSE = {"parta2": 3}
TS_RECIPES = ("pvrcnn", "parta2", "second_iou")
TS_BACKBONE = {"parta2": "UNetV2's 19 convs (12 SubM, 4 strided, 3 inverse)"}
# a seeded anchor head's untrained box residuals, through the decode's
# exp, give rois of up to ~1e8 m a side (PartA2's), and the ROI head's
# decode multiplies those sizes again: the anchor head's conv_box and the
# ROI head's reg_out scaled by this keep the rois near their anchors' size
# and the boxes near their rois', as a trained model's residuals keep them,
# so that boxes are held at 1e-3 m
TS_BOX_SCALE = 1e-2


def seed_like_trained(model):
    """On a seeded two-stage model: conv_cls's prior bias 0, the anchor
    head's ``conv_box`` and the ROI head's ``reg_out`` (where there is one)
    scaled by ``TS_BOX_SCALE``."""
    import torch
    reg_out = getattr(model.roi_head, "reg_out", None)
    with torch.no_grad():
        model.dense_head.conv_cls.bias.zero_()
        for layer in (model.dense_head.conv_box, reg_out):
            for p in () if layer is None else layer.parameters():
                p.mul_(TS_BOX_SCALE)


def inverse_conv_launches(model, conv_k):
    """Kernel 1's launches inside the model's SparseInverseConv3d, read at
    each call: a forward pre-hook and a forward hook take the change of
    every entry's count over the conv's forward; where the output carries
    a gradient, hooks on the output's and the input's gradient take it over
    the conv's backward (its input gradient: the autograd engine runs the
    conv's nodes from the one behind its output to its input's ReLU in a
    row, as nothing else created between them is waiting) -> (counts
    {"forward", "dx"}, remove)."""
    from q3d_tpu_torch.ops.spconv import SparseInverseConv3d
    counts = {"forward": 0, "dx": 0}
    start = {}

    def total():
        return sum(conv_k.launches.values())

    def pre(module, args):
        start[module] = total()

    def post(module, args, out):
        counts["forward"] += total() - start[module]
        x = args[0].features
        if out.features.requires_grad and x.requires_grad:
            def out_grad(grad, module=module):
                start[module, "dx"] = total()

            def in_grad(grad, module=module):
                counts["dx"] += total() - start.pop((module, "dx"))
            out.features.register_hook(out_grad)
            x.register_hook(in_grad)

    hooks = []
    for m in model.modules():
        if isinstance(m, SparseInverseConv3d):
            hooks += [m.register_forward_pre_hook(pre),
                      m.register_forward_hook(post)]

    def remove():
        for h in hooks:
            h.remove()
    return counts, remove
TS_PROPOSAL_K = 1024
# the training proposal layer's candidates a frame (ROI_HEAD.NMS_CONFIG.
# TRAIN.NMS_PRE_MAXSIZE) and kernel 2's widths past 4096 held on crowded
# boxes
TS_TRAIN_K = 9000
TS_WIDE_K = (4097, 9000)


def ts_config_path(name):
    return f"q3d_tpu_torch/cfgs/kitti_models/{TS_CFG[name]}.yaml"


def two_stage_stage_times(model, batch, reps=5):
    """CUDA-event time of each stage of one forward of a two-stage model on
    ``batch``, median of ``reps`` -> {stage: ms}: the modules (vfe,
    backbone_3d, map_to_bev, pfe, backbone_2d, dense_head, point_head,
    roi_head), the proposal layer (sigmoid, best class, kernel 2), and
    inside the PFE and the ROI head: FPS (``pfe.fps``), the BEV sample,
    each source's regrouping, ball query, MLP + pool and its whole set
    abstraction (``<slot>.<source>.total``; the grouping is the total less
    the query and the MLP), the fusion, and the ROI head's FCs + decode;
    UNetV2's decoder (the up blocks and conv5), PartA2FCHead's
    ``roiaware_pool3d`` (cells and pools), SECONDHead's BEV sample and
    FCs.
    Functions are timed through module attributes that shadow them for
    the run; every stage's start and end events are recorded on the
    stream, so a stage's time is the device's time between them."""
    import collections
    import torch
    from q3d_tpu_torch.models.backbones_3d.pfe import (
        voxel_set_abstraction as vsa_mod)
    from q3d_tpu_torch.models.roi_heads import parta2_head as p2h
    from q3d_tpu_torch.models.roi_heads import pvrcnn_head as pvh
    from q3d_tpu_torch.models.roi_heads import second_head as s2h
    from q3d_tpu_torch.models.roi_heads import voxelrcnn_head as vrh
    names = {m: n for n, m in model.named_modules()}
    events = collections.defaultdict(list)
    current = []

    def mark(label, at):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[label].append((at, ev))

    def sa_label(blocks):
        return names[blocks[0]].rsplit("_r", 1)[0]

    def timed(fn, label):
        def run(*args, **kw):
            tag = label(args) if callable(label) else label
            current.append(tag)
            mark(tag, 0)
            try:
                out = fn(*args, **kw)
            finally:
                mark(tag, 1)
                current.pop()
            return out
        return run
    modules = {k: getattr(model, attr) for k, attr in (
        ("vfe", "vfe"), ("backbone_3d", "backbone_3d"),
        ("map_to_bev", "map_to_bev_module"), ("pfe", "pfe"),
        ("backbone_2d", "backbone_2d"), ("dense_head", "dense_head"),
        ("point_head", "point_head"), ("roi_head", "roi_head"))
        if getattr(model, attr, None) is not None}
    hooks = []
    for label, mod in modules.items():
        hooks += [mod.register_forward_pre_hook(
                      lambda *_, t=label: mark(t, 0)),
                  mod.register_forward_hook(lambda *_, t=label: mark(t, 1))]
    for mod, n in names.items():
        if isinstance(mod, vsa_mod.SAMLPBlock):
            t = n.rsplit("_r", 1)[0] + ".mlp"
        elif n in ("pfe.vsa_point_feature_fusion", "pfe.fusion_norm"):
            t = "pfe.fusion"
        elif n in ("backbone_3d.up4", "backbone_3d.up3", "backbone_3d.up2",
                   "backbone_3d.conv5", "backbone_3d.norm5"):
            t = "backbone_3d.decoder"
        else:
            continue
        hooks += [mod.register_forward_pre_hook(lambda *_, t=t: mark(t, 0)),
                  mod.register_forward_hook(lambda *_, t=t: mark(t, 1))]
    patches = [(model, "proposal_layer", "proposal_layer")]
    if "pfe" in modules:
        patches += [(model.pfe, "sample_keypoints", "pfe.fps"),
                    (vsa_mod, "bilinear", "pfe.bev_sample"),
                    (vsa_mod, "stage_points", "pfe.regroup")]
    patches += [(vrh, "stage_points", "roi_head.regroup"),
                (model.roi_head, "finish", "roi_head.fcs_decode"),
                (p2h, "roiaware_cells", "roi_head.roiaware_pool3d"),
                (p2h, "pool_cells", "roi_head.roiaware_pool3d"),
                (s2h, "bilinear", "roi_head.bev_sample")]
    if isinstance(model.roi_head, s2h.SECONDHead):
        patches.append((model.roi_head, "shared", "roi_head.fcs"))
    for mod in (vsa_mod, pvh, vrh):
        patches.append((mod, "set_abstraction",
                        lambda a: sa_label(a[0]) + ".total"))
    patches.append((vsa_mod, "ball_query",
                    lambda a: current[-1].rsplit(".", 1)[0] + ".ball_query"))
    saved = [(owner, attr, owner.__dict__.get(attr))
             for owner, attr, _ in patches]
    for owner, attr, label in patches:
        setattr(owner, attr, timed(getattr(owner, attr), label))
    out = collections.defaultdict(list)
    try:
        with torch.no_grad():
            for _ in range(reps):
                events.clear()
                model(dict(batch))
                torch.cuda.synchronize()
                for label, evs in events.items():
                    starts = [e for at, e in evs if at == 0]
                    ends = [e for at, e in evs if at == 1]
                    out[label].append(sum(a.elapsed_time(b)
                                          for a, b in zip(starts, ends)))
    finally:
        for h in hooks:
            h.remove()
        for owner, attr, orig in saved:
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
    ms = {k: statistics.median(v) for k, v in sorted(out.items())}
    for total in [k for k in ms if k.endswith(".total")]:
        base = total[:-len(".total")]
        ms[base + ".grouping"] = ms[total] - ms.get(base + ".ball_query", 0) \
            - ms.get(base + ".mlp", 0)
    return ms


def proposal_candidates(out, k):
    """The proposal layer's candidate sets for a forward's outputs: per
    frame the top ``k`` anchors by their best class's sigmoid -> (boxes
    (B, k, 7), valid (B, k)), kernel 2's input."""
    import torch
    from q3d_tpu_torch.ops.iou3d_nms import top_candidates
    scores = torch.sigmoid(out["batch_cls_preds"].float()).amax(dim=-1)
    _, boxes, valid = top_candidates(out["batch_box_preds"][..., :7].float(),
                                     scores, None, k)
    return boxes.contiguous(), valid.contiguous()


def inverse_conv_phase(model, batch, conv_rows, name, mode):
    """Phase ``kernel_conv_<name>_inverse``: UNetV2's inverse convs apart.
    One forward with each ``SparseInverseConv3d``'s book taken from the
    rulebook cache: equal to the transpose of its strided conv's book
    (``engine.transposed_book`` of that book's inverse) and to the rule
    (``engine.inverse_conv_indices``), integer for integer; then their rows
    of ``kernel_conv`` (kernel 1 against its plain version, f32 / bf16 /
    s8) summed -> bf16 totals."""
    import torch
    from q3d_tpu_torch.ops.spconv import engine
    from q3d_tpu_torch.ops.spconv.modules import (SparseInverseConv3d,
                                                  inverse_cache_key)
    books = []

    def grab(mod, args, out):
        st, target, cache = args
        key = inverse_cache_key(target.spatial_shape, mod.kernel_size,
                                mod.stride, mod.padding)
        book, back = cache[key]
        strided = cache[key[len("inverse|"):]][1]
        transposed = engine.transposed_book(
            engine.inverse_book(strided, target.capacity), st.capacity)
        rule = engine.inverse_conv_indices(st, target.indices,
                                           mod.kernel_size, mod.stride,
                                           mod.padding)
        books.append({"conv": names[mod], "M": book.shape[0],
                      "N": st.capacity, "present_taps": int(
                          (book < st.capacity).sum()),
                      "transposed_equal": torch.equal(book, transposed),
                      "rule_equal": torch.equal(book, rule),
                      "dx_over_strided_book": back is strided})
    names = {m: n for n, m in model.named_modules()}
    hooks = [m.register_forward_hook(grab) for m in model.modules()
             if isinstance(m, SparseInverseConv3d)]
    try:
        with torch.no_grad():
            model(dict(batch))
    finally:
        for h in hooks:
            h.remove()
    check(len(books) == TS_INVERSE[name] and all(
        b["transposed_equal"] and b["rule_equal"]
        and b["dx_over_strided_book"] for b in books),
          f"kernel_conv_{name}_inverse: books {books}")
    rows = [r for r in conv_rows if ".inv_conv" in r["conv"]]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")
    totals = {k: sum(r[f"{k}_bf16"] for r in rows) for k in keys}
    totals["max_abs_err"] = max(r["err_bf16"] for r in rows)
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] \
        else "operations"
    emit(f"kernel_conv_{name}_inverse", convs=len(rows), books=books,
         mode=mode(), dtype="bf16", **totals,
         f32={k: sum(r[f"{k}_f32"] for r in rows) for k in keys},
         s8={k: sum(r[f"{k}_s8"] for r in rows)
             for k in ("ms", "plain_ms", "bound_ms")},
         per_conv=[{k: r[k] for k in (
             "conv", "N", "M", "Cin", "Cout", "present_taps", "ms_bf16",
             "plain_ms_bf16", "library_ms_bf16", "bound_ms_bf16", "ms_f32",
             "ms_s8", "err_bf16", "err_f32")} for r in rows],
         note="the three inverse convs of one bf16 forward's kernel_conv "
              "rows; each book equal to the transpose of its strided "
              "conv's and to the rule")
    return totals


def two_stage_phases(name, dev, conv_k, nms_k, mode, strict_f32, flush,
                     clock_mhz):
    """One two-stage model at the KITTI width (``ts_config_path(name)``:
    PV-RCNN, Voxel R-CNN, PartA2 or SECOND-IoU, seeded weights, conv_cls's
    bias 0, BN statistics from the first request, f32 with TF32 off where
    held against plain) on the FOV-cropped KITTI scenes, batch 2:
    ``data_pvrcnn`` (points against MAX_RAW_POINTS and voxels against the
    40,000 cap a frame, none dropped), ``kernel_conv`` for its
    TS_CONVS[name] convs (PartA2: ``kernel_conv_parta2_inverse``, its
    three inverse convs apart and their books checked,
    ``inverse_conv_phase``), ``serving_<name>`` (4 bf16 requests:
    TS_CONVS[name] kernel-1 launches and one kernel-2 launch of 2 sets of
    K = 1024 a forward; host ms apart from device ms), ``stages_<name>``
    (``two_stage_stage_times``; the forward's peak memory),
    ``model_<name>`` (f32, kernels vs plain: the spatial features exactly
    equal, the rois the same keep set, the detections matched at 1e-3 /
    1e-4), ``kernel_nms_<name>`` (kernel 2 on the proposal sets against
    plain, timed, its bound) and, for TS_RECIPES, ``recipes_<name>``
    (``int8_deploy_recipe()``: every sparse conv s8 but the float
    conv_input and inverse convs, the quantized BEV convs through
    ``_int_mm``, each launch held against its plain version on its own
    operands, the maps and rois equal, the detections equal, or matched
    after PartA2's float decoder); then its training phases
    (``two_stage_training``) -> summary for the kernels line."""
    import torch
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.kitti_synthetic import (kitti_config,
                                                        kitti_scene,
                                                        scene_counts)
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
    config = ts_config_path(name)
    cfg = kitti_config(TS_CFG[name], BATCH * REQUESTS, SEED)
    dc = cfg.DATA_CONFIG
    ds, _, _ = build_dataloader(dc, cfg.CLASS_NAMES, batch_size=BATCH,
                                training=False)
    cap = int(dc.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS["test"])
    raw_cap = int(dc.get("MAX_RAW_POINTS", 0))

    def request(r):
        return make_request(ds, r, kitti_scene)

    # ---------------------------------------------------------------- data
    if raw_cap:
        counts = scene_counts(ds)
        for r in range(REQUESTS):
            raw, _, _ = request(r)
            for j, m in enumerate(raw["points_mask"]):
                counts[r * BATCH + j]["points_collated"] = int(m.sum())
        check(all(c["voxels_kept"] == c["voxels_occupied"] < cap
                  and c["points_collated"] == c["points_in_range"] < raw_cap
                  and c["objects_present"] == c["objects_labelled"] > 0
                  for c in counts),
              f"data_{name}: frames {counts}, caps {raw_cap} / {cap}")
        emit(f"data_{name}", config=config,
             dataset="SyntheticDataset at the config's geometry, FOV-cropped",
             max_raw_points=raw_cap, voxel_cap=cap, frames=counts,
             points_dropped=0, voxels_dropped=0,
             cuts="synthetic scenes, seeded weights")

    t0 = time.perf_counter()
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    seed_like_trained(model)
    build_s = time.perf_counter() - t0
    raw0, _, _ = request(0)
    strict_f32(True)
    batch_f32 = load_data_to_device(raw0, device=dev)
    calibrate_bns(model, batch_f32)
    convs, _ = record_sparse_convs(model, batch_f32)
    n_convs, n_inv = TS_CONVS[name], TS_INVERSE.get(name, 0)
    check(len(convs) == n_convs, f"{name}: {len(convs)} sparse convs")
    totals, worst, conv_rows = kernel_conv(convs, flush, mode, name)
    del convs
    inverse = None
    if n_inv:
        inverse = inverse_conv_phase(model, batch_f32, conv_rows, name, mode)
    strict_f32(False)

    # ------------------------------------------------------------- serving
    roi_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
    post = int(roi_cfg.NMS_POST_MAXSIZE)
    sets_seen = []
    real_boxes_cuda = nms_mod.greedy_suppress_boxes_cuda

    def seen(corners, *args, **kw):
        sets_seen.append(list(corners.shape[:2]))
        return real_boxes_cuda(corners, *args, **kw)
    nms_mod.greedy_suppress_boxes_cuda = seen
    # the inverse convs' share of kernel 1's launches, read around each
    # of their calls (the bf16 total is held below)
    inverse_k, remove_inverse = inverse_conv_launches(model, conv_k)
    clear_launches(conv_k, nms_k)
    per_request = []
    try:
        for r in range(REQUESTS):
            raw, scene_ms, prep_ms = request(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = load_data_to_device(raw, device=dev,
                                        compute_dtype=torch.bfloat16)
            with torch.no_grad():
                out = model(batch)
            n_valid = out["final_valid"].sum(dim=1).tolist()
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            check(all(torch.isfinite(out[k].float()).all() for k in (
                "spatial_features_2d", "rois", "final_boxes", "final_scores"))
                and out["final_boxes"].shape == (BATCH, post, 7)
                and out["spatial_features"].dtype == torch.bfloat16,
                f"{name} request {r}: non-finite outputs or final_boxes "
                f"{tuple(out['final_boxes'].shape)}")
            per_request.append({"request": r,
                                "frames": list(range(BATCH * r,
                                                     BATCH * (r + 1))),
                                "scene_ms": scene_ms, "pipeline_ms": prep_ms,
                                "host_ms": scene_ms + prep_ms,
                                "device_forward_ms": fwd_ms,
                                "valid_rois": out["roi_valid"].sum(1).tolist(),
                                "valid_detections": n_valid})
            emit(f"serving_{name}_request", **per_request[-1])
    finally:
        nms_mod.greedy_suppress_boxes_cuda = real_boxes_cuda
        remove_inverse()
    launches = kernel_launches(conv_k, nms_k)
    got = {"conv_bf16": launches["sparse_gather_conv_bf16"],
           "conv_other": sum(conv_k.launches.values())
           - launches["sparse_gather_conv_bf16"],
           "nms_boxes": launches["greedy_nms_boxes"],
           "nms_iou": launches["greedy_nms_iou"], "nms_sets": sets_seen}
    want = {"conv_bf16": n_convs * REQUESTS, "conv_other": 0,
            "nms_boxes": REQUESTS, "nms_iou": 0,
            "nms_sets": [[BATCH, TS_PROPOSAL_K]] * REQUESTS}
    check(got == want and inverse_k["forward"] == n_inv * REQUESTS,
          f"serving_{name}: launches {got}, expected {want}; inside the "
          f"inverse convs {inverse_k['forward']}")
    emit(f"serving_{name}", config=config, batch=BATCH, dtype="bf16",
         requests=REQUESTS, launches=launches, nms_sets_k=sets_seen[0],
         inverse_conv_launches=inverse_k["forward"],
         build_s=build_s, mode=mode(), steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]),
         steady_host_ms=statistics.median(
             p["host_ms"] for p in per_request[1:]),
         note="raw points f32, the VFE's voxels and everything to the "
              "proposals bf16; past each SA block's (and each point or ROI "
              "head MLP's) first BN f32, as the reference's flax BNs give "
              "it")
    stages = two_stage_stage_times(model, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2 ** 20
    with torch.no_grad():
        model(dict(batch))
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    emit(f"stages_{name}", dtype="bf16", batch=BATCH, mode=mode(), ms=stages,
         sparse_conv_kernels_ms=totals["ms"], peak_mib=peak_mib,
         peak_over_resident_mib=peak_mib - base_mib,
         note="<slot>.<source>.grouping = total - ball_query - mlp; the "
              "proposal layer holds kernel 2; roi_head.fcs_decode the "
              "shared / cls / reg FCs and the decode")
    del out, batch

    # ------------------------------------- whole model, kernels vs plain
    strict_f32(True)
    outs, runs = {}, {}
    with torch.no_grad():
        for impl in ("cuda", "plain"):
            model.set_kernel_impl(impl)
            clear_launches(conv_k, nms_k)
            outs[impl] = model(dict(batch_f32))
            torch.cuda.synchronize()
            runs[impl] = {k: v for k, v in kernel_launches(
                conv_k, nms_k).items() if v}
        model.set_kernel_impl(None)
    ok_, op = outs["cuda"], outs["plain"]
    check(runs["cuda"] == {"sparse_gather_conv_f32": n_convs,
                           "greedy_nms_boxes": 1} and not runs["plain"],
          f"model_{name}: launches {runs}")
    check(torch.equal(ok_["spatial_features"], op["spatial_features"]),
          f"model_{name}: spatial_features differ, kernels vs plain")
    roi_err = float((ok_["rois"] - op["rois"]).abs().max())
    check(torch.equal(ok_["roi_valid"], op["roi_valid"])
          and torch.equal(ok_["roi_labels"], op["roi_labels"])
          and roi_err <= 1e-4, f"model_{name}: rois differ ({roi_err})")
    matched, total = matched_detections(ok_, op, BATCH)
    frac = matched / max(total, 1)
    check(total > 0 and frac >= 0.99,
          f"model_{name}: only {matched}/{total} detections matched")
    emit(f"model_{name}", dtype="f32", mode=mode(), launches=runs["cuda"],
         spatial_features="equal", rois_max_abs=roi_err,
         rois_valid=ok_["roi_valid"].sum(1).tolist(), detections=total,
         detections_matched=matched, matched_fraction=frac,
         tolerance="spatial_features exactly equal; rois: valid flags and "
                   "labels equal, boxes within 1e-4; detections matched "
                   "(same label, box within 1e-3, score within 1e-4)")

    # -------------------------------- kernel 2 on the proposal sets
    bx, bv = proposal_candidates(ok_, int(roi_cfg.NMS_PRE_MAXSIZE))
    thresh = float(roi_cfg.NMS_THRESH)
    check(bv.shape == (BATCH, TS_PROPOSAL_K) and bool(bv.all()),
          f"kernel_nms_{name}: sets {tuple(bv.shape)}, valid "
          f"{bv.sum(1).tolist()}")
    near, needed, most = check_boxes_form(bx, bv, thresh, name)
    corners, areas = nms_mod.bev_corners_areas(bx)
    terms = boxes_bound(BATCH, TS_PROPOSAL_K, needed, near, clock_mhz)
    nms_row = {"entry": "q3d_greedy_nms_boxes", "sets": BATCH,
               "K": TS_PROPOSAL_K, "thresh": thresh,
               "valid": int(bv.sum()), "candidate_pairs": needed,
               "near_pairs": near, "near_pairs_most_in_a_tile": most,
               "kept": int(nms_mod.greedy_nms_boxes(bx, bv, thresh).sum()),
               "ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_cuda(
                   corners, areas, bv, thresh), flush=flush),
               "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_plain(
                   bx, bv, thresh), reps=3, flush=flush),
               **{f"{k}_ms": v for k, v in terms.items()}}
    nms_row["bound_by"] = max(terms, key=terms.get)
    nms_row["bound_ms"] = terms[nms_row["bound_by"]]
    emit(f"kernel_nms_{name}", form="boxes", **nms_row, max_abs_err=0,
         mode=mode(), clock_max_sm_mhz=clock_mhz,
         tolerance="keep masks exactly equal, IoU bit-equal at every "
         "evaluated pair, plain IoU exactly 0 at every skipped needed pair")
    del outs, ok_, op, corners, areas
    summary = {"launches": launches, "totals": totals, "worst": worst,
               "nms": nms_row, "inverse": inverse,
               "inverse_launches": inverse_k["forward"]}

    # ------------------------------------------- int8_deploy_recipe()
    if name in TS_RECIPES:
        m8 = copy.deepcopy(model)
        quant_api.quantize_model(m8, quant_api.int8_deploy_recipe(),
                                 batch_f32)
        q_dense = sum(isinstance(mod, Conv2d) and mod.rule is not None
                      for mod in m8.modules())
        calls, outs, runs = [], {}, {}
        with recording_launches(calls):
            with torch.no_grad():
                for impl in ("cuda", "plain"):
                    m8.set_kernel_impl(impl)
                    clear_launches(conv_k, nms_k)
                    outs[impl] = m8(dict(batch_f32))
                    torch.cuda.synchronize()
                    runs[impl] = {k: v for k, v in kernel_launches(
                        conv_k, nms_k).items() if v}
                m8.set_kernel_impl(None)
        # conv_input and the inverse convs (no recipe lists their kind)
        # stay float
        want = {"sparse_gather_conv_s8": n_convs - 1 - n_inv,
                "sparse_gather_conv_f32": 1 + n_inv,
                "int_mm_conv2d": q_dense, "greedy_nms_boxes": 1}
        check(runs["cuda"] == want and q_dense > 0 and not runs["plain"],
              f"recipes_{name}: launches {runs}, expected {want}")
        check(len(calls) == n_convs,
              f"recipes_{name}: {len(calls)} launches recorded")
        held = hold_launches_on_operands(calls, f"recipes_{name}")
        del calls
        # the decoder's float inverse convs sum in another order on the
        # kernel: from there on (the point features) PartA2's runs are held
        # as the f32 model is, the first stage exactly
        exact = ("spatial_features", "spatial_features_2d", "rois")
        if not n_inv:
            exact += ("final_boxes", "final_scores", "final_labels",
                      "final_valid")
        for key in exact:
            check(torch.equal(outs["cuda"][key], outs["plain"][key]),
                  f"recipes_{name}: {key} differs, kernels vs plain")
        matched, total = matched_detections(outs["cuda"], outs["plain"],
                                            BATCH)
        check(total > 0 and matched >= 0.99 * total,
              f"recipes_{name}: only {matched}/{total} detections matched")
        emit(f"recipes_{name}", recipe="int8_deploy_recipe()", dtype="f32",
             batch=BATCH, mode=mode(), launches=runs["cuda"],
             quantized_dense=q_dense, float_inverse_convs=n_inv, **held,
             valid=int(outs["cuda"]["final_valid"].sum()),
             detections=total, detections_matched=matched,
             equal=", ".join(exact) + " equal, kernels vs plain"
             + ("; detections matched (same label, box within 1e-3, score "
                "within 1e-4)" if n_inv else ""))
        del m8, outs
    strict_f32(False)
    del model, batch_f32
    torch.cuda.empty_cache()
    summary["train"] = two_stage_training(name, dev, conv_k, nms_k, mode,
                                          strict_f32, flush, clock_mhz)
    return summary


def roi_head_inputs(model, batch):
    """The batch dict a training forward of ``model`` (a copy: its BN
    statistics move) hands its ROI head: the proposal layer's inputs
    (``batch_cls_preds``, ``batch_box_preds``) and outputs (``rois``,
    ``roi_labels`` ...)."""
    import torch
    seen = {}

    def grab(module, args):
        seen.update(args[0])
        raise StopIteration
    m = copy.deepcopy(model).train()
    hook = m.roi_head.register_forward_pre_hook(grab)
    try:
        with torch.no_grad():
            m(dict(batch))
    except StopIteration:
        pass
    finally:
        hook.remove()
    return seen


def plant_on_proposals(model, batch, per_frame=4):
    """``batch`` with gt rows planted on the first proposals of a training
    forward of ``model`` (``roi_head_inputs``) 0.5-10 m a side inside
    the point cloud range: each shifted 0.1 m in x and y, with the
    proposal's class, after the frame's own objects.  Seeded weights leave
    every proposal far from the scene's objects, and then the ROI head's
    regression has no foreground roi and no gradient; planted rows give it
    both -> (batch, rows planted a frame)."""
    import torch
    seen = roi_head_inputs(model, batch)
    pcr = torch.tensor(model.dataset.point_cloud_range,
                       device=seen["rois"].device)
    gt = batch["gt_boxes"].clone()
    planted = []
    for b in range(gt.shape[0]):
        rois = seen["rois"][b]
        ok = ((rois[:, 3:6] >= 0.5) & (rois[:, 3:6] <= 10.0)).all(1) \
            & ((rois[:, 0:3] > pcr[0:3]) & (rois[:, 0:3] < pcr[3:6])).all(1)
        n = int((gt[b, :, 7] > 0).sum())
        pick = ok.nonzero()[:, 0][:min(per_frame, gt.shape[1] - n)]
        boxes = rois[pick].clone()
        boxes[:, 0:2] += 0.1
        gt[b, n:n + len(pick), :7] = boxes
        gt[b, n:n + len(pick), 7] = seen["roi_labels"][b, pick].to(gt.dtype)
        planted.append(len(pick))
    return dict(batch, gt_boxes=gt), planted


def two_stage_training(name, dev, conv_k, nms_k, mode, strict_f32, flush,
                       clock_mhz):
    """The training phases of a two-stage model at the KITTI width
    (``ts_config_path(name)``, seeded weights) on 4 batches of synthetic
    KITTI frames at the yaml's batch (2: PV-RCNN, Voxel R-CNN; 4: PartA2,
    SECOND-IoU) with its whole DATA_AUGMENTOR (gt_sampling from a database
    ``write_gt_database`` writes to a temporary directory from 8 frames of
    another seed, then the flip, rotation and scaling):

    * ``kernel_nms_<name>_train``: kernel 2's boxes form on the training
      proposal layer's input (ROI_HEAD.NMS_CONFIG.TRAIN: a set of
      TS_TRAIN_K candidates a frame, all valid, conv_cls's bias 0, of a
      training forward on the first batch) and on crowded boxes with
      duplicates and a degenerate quad at K in TS_WIDE_K (also through the
      IoU form), at the TRAIN thresh: keep masks equal to the plain
      versions', the IoU bit-equal at every evaluated pair and 0 at every
      skipped needed pair; timed beside the plain version (one call at K =
      9000) and the three-term bound;
    * ``train_grad_<name>``: one f32 step (TF32 off) through the kernels
      and through the plain versions on the first batch with gt rows
      planted on its proposals (``plant_on_proposals``: the ROI head's
      regression loss, SECONDHead's IoU loss, nonzero), held by
      ``train_grad`` (TS_CONVS[name] kernel-1 launches forward, one fewer
      as dX) and one kernel-2 launch of a set a frame of TS_TRAIN_K;
    * ``kernel_fwd_<name>`` / ``kernel_dx_<name>``: kernel 1's f32 entry on
      that step's forward and input-gradient operands, each launch against
      its plain version (PartA2's inverse convs also summed apart,
      ``*_apart``);
    * ``train_<name>``: ``train_model`` for 2 epochs of 4 steps (the
      yaml's OPTIMIZATION: adam_onecycle, clip 10), timed by
      ``timed_train_model`` (host, forward, backward with dX and dW, the
      optimizer, peak memory), each step TS_CONVS[name] + one fewer
      kernel-1 launches and one kernel-2 launch, every loss finite, every
      parameter a gradient in some step but the ROI head's reg branch when
      no sampled roi of the run reached REG_FG_THRESH (the foreground
      rois of each step are recorded).
    -> summary for the kernels line."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.augmentor.database_sampler import \
        DataBaseSampler
    from q3d_tpu_torch.datasets.kitti_synthetic import (kitti_config,
                                                        write_gt_database)
    from q3d_tpu_torch.models import load_data_to_device
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.tools.nms_ab import crowded_with_degenerate
    from q3d_tpu_torch.train_utils import MODEL_KEYS
    config = ts_config_path(name)
    cname = TS_CFG[name]
    n_convs = TS_CONVS[name]
    # the config's batch, 8 steps in the run's 2 epochs
    batch_size = int(kitti_config(cname, 1, SEED).OPTIMIZATION
                     .BATCH_SIZE_PER_GPU)
    train_frames = 4 * batch_size
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "db"
        written = write_gt_database(build_dataloader(
            kitti_config(cname, KITTI_TRAIN_FRAMES, SEED + 1).DATA_CONFIG,
            kitti_config(cname, 1, SEED).CLASS_NAMES, 1,
            training=False)[0], root)
        cfg, ds, loader, model = kitti_train_data(
            cname, dev, train_frames, SEED, augment=True, root=root)
        queue = ds.data_augmentor.data_augmentor_queue
        check([type(q).__name__ if isinstance(q, DataBaseSampler)
               else q.func.__name__ for q in queue]
              == ["DataBaseSampler", "random_world_flip",
                  "random_world_rotation", "random_world_scaling"],
              f"train_{name}: augmentor queue {queue}")
        train_nms = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN
        check(int(train_nms.NMS_PRE_MAXSIZE) == TS_TRAIN_K,
              f"train_{name}: NMS TRAIN {train_nms}")
        thresh = float(train_nms.NMS_THRESH)
        raw = next(iter(loader))
        batch = load_data_to_device({k: v for k, v in raw.items()
                                     if k in MODEL_KEYS}, device=dev)

        # ----------------------- kernel 2 on the training proposal layer
        strict_f32(True)
        m0 = copy.deepcopy(model)
        with torch.no_grad():
            m0.dense_head.conv_cls.bias.zero_()
        bx, bv = proposal_candidates(roi_head_inputs(m0, batch), TS_TRAIN_K)
        del m0
        check(bv.shape == (batch_size, TS_TRAIN_K) and bool(bv.all()),
              f"kernel_nms_{name}_train: sets {tuple(bv.shape)}, valid "
              f"{bv.sum(1).tolist()}")
        near, needed, most = check_boxes_form(bx, bv, thresh,
                                              f"{name} training proposals")
        corners, areas = nms_mod.bev_corners_areas(bx)
        terms = boxes_bound(batch_size, TS_TRAIN_K, needed, near, clock_mhz)
        nms_row = {
            "entry": "q3d_greedy_nms_boxes", "sets": batch_size,
            "K": TS_TRAIN_K,
            "thresh": thresh, "valid": int(bv.sum()),
            "candidate_pairs": needed, "near_pairs": near,
            "near_pairs_most_in_a_tile": most,
            "kept": int(nms_mod.greedy_nms_boxes(bx, bv, thresh).sum()),
            "ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_cuda(
                corners, areas, bv, thresh), flush=flush),
            "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_plain(
                bx, bv, thresh), reps=1, flush=flush),
            "kernel_us": kernel_device_us(
                lambda: nms_mod.greedy_suppress_boxes_cuda(
                    corners, areas, bv, thresh),
                ("nms_box_pairs_kernel", "nms_box_iou_kernel",
                 "nms_sweep_kernel"), flush),
            **{f"{k}_ms": v for k, v in terms.items()}}
        nms_row["bound_by"] = max(terms, key=terms.get)
        nms_row["bound_ms"] = terms[nms_row["bound_by"]]
        del bx, bv, corners, areas
        crowded = []
        rng = np.random.RandomState(SEED + TS_TRAIN_K)
        for kk in TS_WIDE_K:
            r_boxes, r_valid = crowded_with_degenerate(rng, 2, kk, dev)
            c_near, c_needed, _ = check_boxes_form(
                r_boxes, r_valid, thresh, f"crowded K={kk}")
            iou = nms_mod.needed_pair_iou(r_boxes, r_valid)
            check(torch.equal(nms_mod.greedy_nms(iou, r_valid, thresh,
                                                 impl="cuda"),
                              nms_mod.greedy_suppress_plain(iou, r_valid,
                                                            thresh)),
                  f"greedy_nms: crowded K={kk} IoU-form keep masks differ")
            crowded.append({"K": kk, "valid": r_valid.sum(1).tolist(),
                            "candidate_pairs": c_needed, "near_pairs": c_near})
            del r_boxes, r_valid, iou
        emit(f"kernel_nms_{name}_train", form="boxes", **nms_row,
             max_abs_err=0, crowded=crowded, mode=mode(),
             clock_max_sm_mhz=clock_mhz,
             tolerance="keep masks exactly equal, IoU bit-equal at every "
             "evaluated pair, plain IoU exactly 0 at every skipped needed "
             "pair (the training proposals; crowded boxes with duplicates "
             "and a degenerate quad at K = 4097 / 9000, whose IoU-form keep "
             "masks equal too)", plain_reps=1)
        torch.cuda.empty_cache()

        # ------------------------------- one step, kernels vs plain (f32)
        # on the first batch with gt rows planted on its proposals, so that
        # the ROI head's regression and its gradient are held too
        planted_batch, planted = plant_on_proposals(model, batch)
        nms_k.launches.clear()
        recorded, run = train_grad(model, planted_batch, conv_k, mode,
                                   f"train_grad_{name}", config, n_convs)
        grad_nms = {k: v for k, v in nms_k.launches.items() if v}
        # SECONDHead has no regression branch: its IoU loss instead
        rcnn = "rcnn_reg_loss" if "rcnn_reg_loss" in run["tb"] \
            else "rcnn_iou_loss"
        check(grad_nms == {"q3d_greedy_nms_boxes": 1}
              and run["tb"][rcnn] > 0,
              f"train_grad_{name}: kernel-2 launches {grad_nms}, planted "
              f"{planted}, {rcnn} {run['tb'][rcnn]}")
        emit(f"planted_{name}", gt_rows_planted_per_frame=planted,
             **{rcnn: run["tb"][rcnn]},
             note="train_grad's batch: gt rows on the first proposals of "
                  "0.5-10 m a side, shifted 0.1 m (plant_on_proposals)")
        del planted_batch
        apart = ".inv_conv" if name in TS_INVERSE else None
        fwd = kernel_forward(recorded, flush, mode, f"kernel_fwd_{name}",
                             config, apart)
        dx = kernel_dx(recorded, flush, mode, f"kernel_dx_{name}", config,
                       apart)
        del recorded
        strict_f32(False)
        torch.cuda.empty_cache()

        # ------------------------------------------------- train_model
        sets_seen = []
        real_boxes_cuda = nms_mod.greedy_suppress_boxes_cuda

        def seen(corners, *args, **kw):
            sets_seen.append(list(corners.shape[:2]))
            return real_boxes_cuda(corners, *args, **kw)
        nms_mod.greedy_suppress_boxes_cuda = seen
        # the sampled rois at or above REG_FG_THRESH a step; seeded weights
        # may leave every proposal far from the gt boxes, and then the reg
        # branch has no signal in the run
        head = model.roi_head
        real_assign = head.assign_targets
        foreground = []
        reg_branch = {n for n, _ in model.named_parameters()
                      if n.startswith(("roi_head.reg_fc_", "roi_head.reg_out"))}
        no_signal = set(reg_branch)

        def assign(*args, **kw):
            t = real_assign(*args, **kw)
            foreground.append(int(t["reg_valid"].sum()))
            if foreground[-1]:
                no_signal.difference_update(reg_branch)
            return t
        head.assign_targets = assign
        inverse_k, remove_inverse = inverse_conv_launches(model, conv_k)
        nms_k.launches.clear()
        try:
            _, steps, launches, run_s = timed_train_model(
                model, cfg.OPTIMIZATION, ds, loader,
                Path(tmp) / f"ckpt_{name}", conv_k, dev, f"train_{name}",
                no_signal=no_signal, any_step=True)
        finally:
            nms_mod.greedy_suppress_boxes_cuda = real_boxes_cuda
            del head.assign_targets
            remove_inverse()
        n_steps = len(steps)
        n_inv = TS_INVERSE.get(name, 0)
        t_nms = {k: v for k, v in nms_k.launches.items() if v}
        check(launches == {"q3d_sparse_gather_conv_f32":
                           (2 * n_convs - 1) * n_steps}
              and t_nms == {"q3d_greedy_nms_boxes": n_steps}
              and sets_seen == [[batch_size, TS_TRAIN_K]] * n_steps
              and inverse_k == {"forward": n_inv * n_steps,
                                "dx": n_inv * n_steps},
              f"train_{name}: launches {launches}, NMS {t_nms}, sets "
              f"{sets_seen}, inside the inverse convs {inverse_k}")
        med = median_after_first(steps)
        emit(f"train_{name}", config=config,
             batch=int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU),
             frames=train_frames, epochs=TRAIN_EPOCHS, steps=n_steps,
             mode=mode(),
             optimization={k: cfg.OPTIMIZATION[k] for k in (
                 "OPTIMIZER", "LR", "WEIGHT_DECAY", "GRAD_NORM_CLIP")},
             augmentor=[c.NAME for c in
                        cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST],
             gt_database=written, losses=[s["loss"] for s in steps],
             launches=launches, nms_launches=t_nms, nms_sets=sets_seen[0],
             inverse_conv_launches=inverse_k,
             foreground_rois_per_step=foreground,
             zero_gradient_allowed=sorted(no_signal),
             run_s=run_s, median_after_first=med)
        out = {"nms": nms_row, "fwd": fwd, "dx": dx, "batch": batch_size,
               "peak_mib": run["peak_mib"], "median": med, "steps": n_steps,
               "launches_forward": sum(s["launches_forward"] for s in steps),
               "launches_dx": sum(s["launches_dx"] for s in steps),
               "launches_inverse": inverse_k,
               "launches_nms": t_nms["q3d_greedy_nms_boxes"]}
        del model, batch
    torch.cuda.empty_cache()
    return out


def two_stage_kernel_rows(ts):
    """The kernels line's entries of the two-stage models: kernel 1 on the
    sparse convs of a bf16 forward (PartA2's inverse convs also apart) and
    of a training step, kernel 2 on the proposal sets."""
    rows = []
    kernel1 = {"route": "cuda",
               "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
               "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274"}
    kernel2 = {"route": "cuda", "source": "q3d_tpu_torch/csrc/greedy_nms.cu",
               "replaces": "q3d_tpu/ops/iou3d_nms/pallas_nms.py:45",
               "entry": "q3d_greedy_nms_boxes", "max_abs_err": 0.0,
               "library_ms": None, "checks": "passed"}
    for name, s in ts.items():
        t, n = s["totals"], s["nms"]
        convs = TS_CONVS[name]
        backbone = TS_BACKBONE.get(name, f"VoxelBackBone8x's {convs} convs")
        rows += [
            {"name": f"sparse_gather_conv_{name}", **kernel1,
             "entry": "q3d_sparse_gather_conv_bf16",
             "use": f"{ts_config_path(name)}: {backbone}, bf16",
             "launches": s["launches"]["sparse_gather_conv_bf16"],
             "max_abs_err": s["worst"]["bf16"], "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
             else "operations", "library_ms": t["library_ms"],
             "checks": "passed",
             "times_cover": f"one bf16 forward at batch {BATCH} ({convs} "
                            f"convs); launches: serving_{name}'s "
                            f"{REQUESTS} requests"},
            {"name": f"greedy_nms_{name}", **kernel2,
             "launches": s["launches"]["greedy_nms_boxes"],
             "ms": n["ms"], "plain_ms": n["plain_ms"],
             "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
             "times_cover": f"the proposal layer's NMS: {n['sets']} sets, "
                            f"K={n['K']}"}]
        inv = s.get("inverse")
        if inv is not None:
            rows.append(
                {"name": f"sparse_gather_conv_{name}_inverse", **kernel1,
                 "entry": "q3d_sparse_gather_conv_bf16",
                 "use": f"{ts_config_path(name)}: UNetV2's 3 "
                        "SparseInverseConv3d (64->64, 64->32, 32->16) over "
                        "the transposes of their strided convs' books, bf16",
                 "launches": s["inverse_launches"],
                 **{k: inv[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
                 "checks": "passed",
                 "times_cover": "the 3 inverse convs of one bf16 forward; "
                                "launches: read around the inverse convs "
                                f"in serving_{name}'s {REQUESTS} "
                                "requests"})
        tr = s["train"]
        n = tr["nms"]
        rows.append(
            {"name": f"greedy_nms_{name}_train", **kernel2,
             "launches": tr["launches_nms"],
             "ms": n["ms"], "plain_ms": n["plain_ms"],
             "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
             "times_cover": f"the training proposal layer's NMS: "
                            f"{n['sets']} sets, K={n['K']} (plain: one "
                            f"call); launches: train_{name}'s "
                            f"{tr['steps']} steps"})
        for use, tot, launches in (
                ("forward", tr["fwd"], tr["launches_forward"]),
                ("dx", tr["dx"], tr["launches_dx"])):
            row = {"name": f"sparse_gather_conv_{use}_{name}_train",
                   **kernel1, "entry": "q3d_sparse_gather_conv_f32",
                   "use": f"{ts_config_path(name)} training, batch "
                          f"{tr['batch']}: "
                          + (f"the forward of its {convs} sparse convs"
                             if use == "forward" else
                             "the input gradient of every sparse conv but "
                             "conv_input, over the inverse book"),
                   "launches": launches,
                   **{k: tot[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
                   "checks": "passed",
                   "times_cover": f"one f32 training step's launches; "
                                  f"launches: train_{name}'s {tr['steps']} "
                                  "steps",
                   "peak_mib_train_grad": tr["peak_mib"]}
            if use == "dx":
                row.update(dw_torch_ms=tot["dw_ms"],
                           inverse_book_ms=tot["inverse_ms"])
            rows.append(row)
            apart = tot.get("apart")
            if apart is not None:
                rows.append({
                    "name": f"sparse_gather_conv_{use}_{name}_inverse_train",
                    **kernel1, "entry": "q3d_sparse_gather_conv_f32",
                    "use": f"{ts_config_path(name)} training: the 3 inverse "
                           "convs' " + ("forward" if use == "forward" else
                                        "input gradient, over their strided "
                                        "convs' books"),
                    "launches": tr["launches_inverse"][use],
                    **{k: apart[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")},
                    "checks": "passed",
                    "times_cover": "one f32 training step's 3 inverse "
                                   "convs; launches: read around the "
                                   f"inverse convs in train_{name}'s "
                                   f"{tr['steps']} steps"})
    return rows


# ================================================== the real-dataset paths
# KITTI and nuScenes trees written in each dataset's on-disk format from
# the port's seeded synthetic scenes (no dataset is in the repository), then
# read back through the port's entry points: create_infos, the test CLI and
# the train CLI, on the configs as written with only DATA_PATH set
DS_KITTI_CFG = ROOT / "tools" / "cfgs" / "kitti_models" / "second.yaml"
DS_KITTI_DATA = ROOT / "tools" / "cfgs" / "dataset_configs" / \
    "kitti_dataset.yaml"
DS_NU_CFG = ROOT / "tools" / "cfgs" / "nuscenes_models" / \
    "cbgs_voxel0075_res3d_centerpoint.yaml"
DS_KITTI_FRAMES = 8            # val: SECOND's phases' frames; train: seed + 1
DS_NU_FRAMES = 8               # val and train each
DS_NU_TRAIN_STEPS = 2
DS_FOV_EDGE_PX = 1e-3          # a point may leave the crop only this near
DS_CONVS = {"second": 12, "centerpoint": 21, "parta2": 19}
DS_PARTA2_CFG = ROOT / "q3d_tpu_torch" / "cfgs" / "kitti_models" / \
    "PartA2.yaml"



@contextlib.contextmanager
def cli_models(impl=None, store=None):
    """While open, every model the port's CLIs build (through
    ``q3d_tpu_torch.models.build_network``) routes its kernels through
    ``impl`` ("plain": the plain versions on the card; None: by device)
    and is appended to ``store``."""
    from q3d_tpu_torch import models
    real = models.build_network

    def build(*args, **kw):
        model = real(*args, **kw)
        if impl is not None:
            model.set_kernel_impl(impl)
        if store is not None:
            store.append(model)
        return model
    models.build_network = build
    try:
        yield
    finally:
        models.build_network = real


def cli_output_dir(cfg_file, tag):
    """Where the port's CLIs put a run of ``cfg_file`` under ``tag``."""
    return ROOT / "output" / "/".join(Path(cfg_file).parts[-3:-1]) \
        / Path(cfg_file).stem / tag


def run_test_cli(cfg_file, tree, tag, dev, extra=(), impl=None):
    """``q3d_tpu_torch.tools.test`` on ``tree`` (only DATA_PATH set) ->
    (metrics, result.pkl's annos, {frame: result-file text} or None,
    seconds, launches).  Launch counts are zeroed just before and read just
    after; the run's output directory is removed."""
    import pickle
    import shutil
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.ops.spconv import gather_conv
    from q3d_tpu_torch.tools import test as test_cli
    out = cli_output_dir(cfg_file, tag)
    clear_launches(gather_conv.KERNEL, nms_mod.KERNEL)
    t0 = time.perf_counter()
    try:
        with cli_models(impl):
            ret = test_cli.main(["--cfg_file", str(cfg_file), "--extra_tag",
                                 tag, "--device", str(dev), *extra, "--set",
                                 "DATA_CONFIG.DATA_PATH", str(tree)])
        seconds = time.perf_counter() - t0
        launches = kernel_launches(gather_conv.KERNEL, nms_mod.KERNEL)
        result_dir = out / "eval" / "default"
        with open(result_dir / "result.pkl", "rb") as f:
            annos = pickle.load(f)
        files = result_dir / "final_result" / "data"
        texts = {p.stem: p.read_text() for p in sorted(files.iterdir())} \
            if files.is_dir() else None
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return ret, annos, texts, seconds, launches


class StepTimer:
    """Per training step of a model the train CLI builds: CUDA events from
    a forward pre-hook and a forward hook, each parameter's
    post-accumulate-grad hook (the last marks the backward's end) and the
    torch optimizer's step post-hook: forward, backward, optimizer ms,
    peak memory; kernel-1 launches forward and as dX."""

    def __init__(self, conv_k):
        self.conv_k, self.steps, self.cur, self.hooks = conv_k, [], {}, []

    def attach(self, model):
        import torch
        from torch.optim.optimizer import register_optimizer_step_post_hook

        def event():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def starts(module, args):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.cur = {"start": event(),
                        "launches": sum(self.conv_k.launches.values())}

        def forward_ends(module, args, out):
            self.cur["forward_end"] = event()
            self.cur["launches_forward"] = sum(
                self.conv_k.launches.values()) - self.cur["launches"]

        def grad_done(param):
            self.cur["backward_end"] = event()

        def stepped(optimizer, args, kwargs):
            end = event()
            torch.cuda.synchronize()
            c = self.cur
            self.steps.append({
                "forward_ms": c["start"].elapsed_time(c["forward_end"]),
                "backward_ms": c["forward_end"].elapsed_time(
                    c["backward_end"]),
                "optimizer_ms": c["backward_end"].elapsed_time(end),
                "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                "launches_forward": c["launches_forward"],
                "launches_dx": sum(self.conv_k.launches.values())
                - c["launches"] - c["launches_forward"]})
        self.hooks += [model.register_forward_pre_hook(starts),
                       model.register_forward_hook(forward_ends),
                       register_optimizer_step_post_hook(stepped)]
        self.hooks += [p.register_post_accumulate_grad_hook(grad_done)
                       for p in model.parameters() if p.requires_grad]

    def close(self):
        for h in self.hooks:
            h.remove()


def run_train_cli(cfg_file, tree, tag, dev, conv_k, extra=(), steps=None):
    """``q3d_tpu_torch.tools.train`` on ``tree`` (only DATA_PATH set),
    stopped after ``steps`` batches when given -> (history with each step's
    host ms and CUDA-event times, objects the gt sampler placed per frame,
    training frames, seconds).  Its checkpoints are removed."""
    import itertools
    import shutil
    from q3d_tpu_torch.datasets import SimpleLoader
    from q3d_tpu_torch.datasets.augmentor.database_sampler import \
        DataBaseSampler
    from q3d_tpu_torch.tools import train as train_cli
    models, placed, frames = [], [], []
    timer = StepTimer(conv_k)
    real_call, real_iter = DataBaseSampler.__call__, SimpleLoader.__iter__

    def sampling(self, data_dict=None, **kw):
        n0 = len(data_dict["gt_boxes"])
        data_dict = real_call(self, data_dict=data_dict, **kw)
        placed.append(len(data_dict["gt_boxes"]) - n0)
        return data_dict

    def batches(self):
        frames.append(len(self.dataset))
        return itertools.islice(real_iter(self), steps)

    class Attach(list):
        def append(self, model):
            timer.attach(model)
            super().append(model)
    models = Attach()
    DataBaseSampler.__call__, SimpleLoader.__iter__ = sampling, batches
    t0 = time.perf_counter()
    try:
        with cli_models(store=models):
            _, history = train_cli.main(
                ["--cfg_file", str(cfg_file), "--extra_tag", tag, "--device",
                 str(dev), "--fix_random_seed", *extra, "--set",
                 "DATA_CONFIG.DATA_PATH", str(tree)])
    finally:
        DataBaseSampler.__call__, SimpleLoader.__iter__ = real_call, real_iter
        timer.close()
        shutil.rmtree(cli_output_dir(cfg_file, tag), ignore_errors=True)
    seconds = time.perf_counter() - t0
    check(len(timer.steps) == len(history) > 0,
          f"train CLI {cfg_file.name}: {len(timer.steps)} timed steps, "
          f"history {len(history)}")
    for h, st in zip(history, timer.steps):
        h.update(st, host_ms=h["data_s"] * 1e3)
    return history, placed, frames, seconds


def held_launches(launches, run, convs, nms):
    """A CLI run's launches: none in a plain run ("..._plain"); else
    ``convs`` of kernel 1 (any entry) and ``nms`` of kernel 2's boxes form,
    none of its IoU form."""
    conv = sum(v for k, v in launches.items()
               if k.startswith("sparse_gather_conv"))
    if run.endswith("plain"):
        return conv == 0 and launches["greedy_nms_boxes"] == 0 \
            and launches["greedy_nms_iou"] == 0
    return (conv, launches["greedy_nms_boxes"],
            launches["greedy_nms_iou"]) == (convs, nms, 0)


def same_slots(a, b, box_tol=1e-3, score_tol=1e-4, worst=None):
    """Two runs' annos (lists of frames' dicts with boxes_lidar or boxes,
    score(s), name) slot for slot -> (slots matched, slots): the same
    count a frame, and at each slot the same name, the box within
    ``box_tol`` and the score within ``score_tol``.  ``worst``, a dict, takes the largest box element, box
    difference (absolute, and relative to max(1, |element|)) and score
    difference of the frames compared."""
    import numpy as np
    matched = total = 0
    for x, y in zip(a, b):
        bx = np.asarray(x.get("boxes_lidar", x.get("boxes")))
        by = np.asarray(y.get("boxes_lidar", y.get("boxes")))
        total += max(len(bx), len(by))
        if len(bx) != len(by):
            continue
        sx, sy = np.asarray(x["score"]), np.asarray(y["score"])
        if len(bx) == 0:
            continue
        diff = np.abs(bx - by)
        ok = (np.asarray(x["name"]) == np.asarray(y["name"])) \
            & (diff.max(-1) <= box_tol) & (np.abs(sx - sy) <= score_tol)
        matched += int(ok.sum())
        if worst is not None:
            for key, v in (("box_max_abs", np.abs(by).max()),
                           ("box_max_abs_diff", diff.max()),
                           ("box_max_rel_diff",
                            (diff / np.maximum(np.abs(by), 1.0)).max()),
                           ("score_max_abs_diff", np.abs(sx - sy).max())):
                worst[key] = max(worst.get(key, 0.0), float(v))
    return matched, total


def eval_kitti_parta2(root, dev, mode, strict_f32, tmp):
    """Phase ``eval_kitti_parta2``: ``tools/test.py`` on the port's
    ``kitti_models/PartA2.yaml`` with only DATA_PATH set to the written
    KITTI tree, f32 (TF32 off), batch 2, a seeded checkpoint
    (``seed_like_trained``, BN statistics from the first batch), through
    the kernels and through the plain versions: 19 kernel-1 and 1 kernel-2
    launches a forward, the same AP dict, and the runs slot for slot (each
    box element within 1e-3) -> launches."""
    import torch
    from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
    from q3d_tpu_torch.utils.checkpoint import save_checkpoint
    cfg = cfg_from_yaml_file(str(DS_PARTA2_CFG), EDict())
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, BATCH,
                                     training=False)
    check(type(ds).__name__ == "KittiDataset" and len(ds) == DS_KITTI_FRAMES,
          f"PartA2.yaml's dataset: {type(ds).__name__}, {len(ds)} frames")
    torch.manual_seed(SEED)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    seed_like_trained(model)
    strict_f32(True)
    calibrate_bns(model, load_data_to_device(next(iter(loader)), device=dev))
    ckpt = save_checkpoint(Path(tmp) / "parta2_seeded.pth", model)
    del model
    runs = {run: run_test_cli(DS_PARTA2_CFG, root, f"chip_parta2_{run}", dev,
                              ["--ckpt", str(ckpt)], impl)
            for run, impl in (("f32", None), ("f32_plain", "plain"))}
    run_mode = mode()
    strict_f32(False)
    forwards = -(-DS_KITTI_FRAMES // 2)       # the CLI's batch 2
    for run, r in runs.items():
        check(held_launches(r[4], run, DS_CONVS["parta2"] * forwards,
                            forwards),
              f"eval_kitti_parta2 {run}: launches {r[4]}")
    ret_k, annos_k = runs["f32"][:2]
    ret_p, annos_p = runs["f32_plain"][:2]
    ap_keys = [k for k in ret_k if "_R40" in k]
    ap_diff = max(abs(ret_k[k] - ret_p[k]) for k in ap_keys)
    check(ap_diff <= 1e-6, f"eval_kitti_parta2: AP dicts differ by {ap_diff}")
    worst = {}
    matched, slots = same_slots(annos_k, annos_p, worst=worst)
    check(slots > 0 and matched >= 0.99 * slots,
          f"eval_kitti_parta2: kernels vs plain {matched}/{slots} slots "
          f"({worst})")
    emit("eval_kitti_parta2", config="q3d_tpu_torch/cfgs/kitti_models/"
         "PartA2.yaml", entry="q3d_tpu_torch.tools.test", frames=len(ds),
         batch=2, weights="seeded (torch.manual_seed), conv_cls bias 0, "
         f"dense_head.conv_box and roi_head.reg_out x {TS_BOX_SCALE}, BN "
         "statistics from the first batch", mode=run_mode,
         runs={run: {"seconds": r[3], "launches": r[4],
                     "infer_time_ms": r[0]["infer_time_ms"],
                     "detections": int(sum(len(a["name"]) for a in r[1])),
                     "ap": {k: r[0][k] for k in ap_keys}}
               for run, r in runs.items()},
         kernels_vs_plain={"slots_matched": matched, "slots": slots,
                           "ap_max_abs_diff": ap_diff, **worst},
         tolerance="AP dicts within 1e-6; 99% of the slots with the same "
                   "name, each box element within 1e-3, the score within "
                   "1e-4")
    return runs["f32"][4]


def kitti_tree_phases(dev, conv_k, nms_k, mode, strict_f32, tmp):
    """Phases ``data_kitti_tree``, ``eval_kitti_second``,
    ``eval_kitti_parta2`` and ``train_kitti_tree`` (see the module
    docstring) -> launches."""
    import numpy as np
    import pickle
    import torch
    from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.kitti import kitti_eval
    from q3d_tpu_torch.datasets.kitti.kitti_dataset import get_fov_flag
    from q3d_tpu_torch.datasets.kitti_synthetic import (
        kitti_config, kitti_fov, kitti_scene, read_results, write_kitti_tree)
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.tools import create_infos
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
    from q3d_tpu_torch.utils.checkpoint import save_checkpoint

    root = Path(tmp) / "kitti"
    names = ["Car", "Pedestrian", "Cyclist"]

    def synthetic(seed):
        return build_dataloader(kitti_config("second", DS_KITTI_FRAMES,
                                             seed).DATA_CONFIG, names, 1,
                                training=False)[0]
    # ------------------------------------------------------ data_kitti_tree
    val_ids = [f"{j:06d}" for j in range(DS_KITTI_FRAMES)]
    train_ids = [f"{DS_KITTI_FRAMES + j:06d}" for j in range(DS_KITTI_FRAMES)]
    val_sds = synthetic(SEED)
    t0 = time.perf_counter()
    labelled = write_kitti_tree(val_sds, root, {"val": val_ids})
    labelled.update(write_kitti_tree(synthetic(SEED + 1), root,
                                     {"train": train_ids}))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    made = create_infos.main(["kitti", "--cfg_file", str(DS_KITTI_DATA),
                              "--data_path", str(root), "--with_gt_database"])
    infos_s = time.perf_counter() - t0
    in_gt = {}
    for split in ("train", "val"):
        with open(root / f"kitti_infos_{split}.pkl", "rb") as f:
            infos = pickle.load(f)
        in_gt[split] = {
            "frames": len(infos),
            "objects": int(sum(len(i["annos"]["name"]) for i in infos)),
            "points_in_gt": int(sum(i["annos"].get(
                "num_points_in_gt", np.zeros(0)).sum() for i in infos))}
    with open(made["gt_database"], "rb") as f:
        db = {k: len(v) for k, v in pickle.load(f).items()}
    check(made["infos"] == {"train": DS_KITTI_FRAMES,
                            "val": DS_KITTI_FRAMES} and sum(db.values()) > 0,
          f"create_infos kitti: {made}, database {db}")

    cfg = cfg_from_yaml_file(str(DS_KITTI_CFG), EDict())
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, BATCH,
                                     training=False)
    check(type(ds).__name__ == "KittiDataset" and len(ds) == DS_KITTI_FRAMES,
          f"second.yaml's dataset: {type(ds).__name__}, {len(ds)} frames")
    frames, edge_points = [], 0
    for j, info in enumerate(ds.kitti_infos):
        idx = info["point_cloud"]["lidar_idx"]
        points, calib = ds.get_lidar(idx), ds.get_calib(idx)
        shape = info["image"]["image_shape"]
        mine = get_fov_flag(calib.lidar_to_rect(points[:, :3]), shape, calib)
        theirs = kitti_fov(points[:, :3])
        check(np.array_equal(points[theirs], kitti_scene(val_sds, j)[0]),
              f"data_kitti_tree frame {idx}: the scan is not kitti_scene's")
        diff = mine != theirs
        uv, _ = calib.rect_to_img(calib.lidar_to_rect(points[diff, :3]))
        margin = np.minimum(np.minimum(np.abs(uv[:, 0]),
                                       np.abs(uv[:, 0] - shape[1])),
                            np.minimum(np.abs(uv[:, 1]),
                                       np.abs(uv[:, 1] - shape[0])))
        check(bool((margin <= DS_FOV_EDGE_PX).all()),
              f"data_kitti_tree frame {idx}: {int(diff.sum())} points differ "
              f"from kitti_scene's crop, up to {margin.max(initial=0)} px from an edge")
        edge_points += int(diff.sum())
        frame = ds[j]
        frames.append({"frame": idx, "points": len(points),
                       "points_in_fov": int(mine.sum()),
                       "edge_points": int(diff.sum()),
                       "voxels": int((frame["voxel_num_points"] > 0).sum()),
                       "objects": len(info["annos"]["name"])})
    emit("data_kitti_tree", config="kitti_models/second.yaml",
         dataset="KittiDataset", written_s=write_s, create_infos_s=infos_s,
         labelled=labelled, infos=in_gt, gt_database=db,
         fov_edge_points=edge_points, fov_edge_px=DS_FOV_EDGE_PX,
         frames=frames)

    # ---------------------------------------------------- eval_kitti_second
    torch.manual_seed(SEED)
    model = build_network(cfg.MODEL, len(names), ds, device=dev)
    with torch.no_grad():
        model.dense_head.conv_cls.bias.zero_()
    strict_f32(True)
    calibrate_bns(model, load_data_to_device(next(iter(loader)), device=dev))
    ckpt = save_checkpoint(Path(tmp) / "second_seeded.pth", model)
    del model
    runs = {}
    for run, extra, impl in (("f32", ["--save_to_file"], None),
                             ("f32_plain", [], "plain")):
        runs[run] = run_test_cli(DS_KITTI_CFG, root, f"chip_{run}", dev,
                                 ["--ckpt", str(ckpt), *extra], impl)
    strict_f32(False)
    runs["bf16"] = run_test_cli(DS_KITTI_CFG, root, "chip_bf16", dev,
                                ["--ckpt", str(ckpt), "--bf16"])
    forwards = -(-DS_KITTI_FRAMES // 2)       # the CLI's batch 2
    for run, r in runs.items():
        check(held_launches(r[4], run, DS_CONVS["second"] * forwards,
                            forwards), f"eval_kitti_second {run}: launches "
                                       f"{r[4]}")
    ret_k, annos_k, texts, _, _ = runs["f32"]
    ret_p, annos_p = runs["f32_plain"][:2]
    matched, slots = same_slots(annos_k, annos_p)
    check(slots > 0 and matched >= 0.99 * slots,
          f"eval_kitti_second: kernels vs plain {matched}/{slots} slots")
    ap_keys = [k for k in ret_k if "_R40" in k]
    ap_diff = max(abs(ret_k[k] - ret_p[k]) for k in ap_keys)
    check(ap_diff <= 1e-6, f"eval_kitti_second: AP dicts differ by {ap_diff}")
    # one result file a frame, each equal to its annos to 4 decimals
    check(sorted(texts) == val_ids, f"result files {sorted(texts)}")
    file_err = 0.0
    for anno in annos_k:
        rows = [line.split() for line in
                texts[anno["frame_id"]].splitlines()]
        check([r[0] for r in rows] == list(anno["name"]),
              f"result file {anno['frame_id']}: names differ")
        back = np.array([[float(v) for v in r[3:]] for r in rows],
                        np.float64).reshape(-1, 13)
        want = np.concatenate([anno["alpha"][:, None], anno["bbox"],
                               anno["dimensions"][:, [1, 2, 0]],
                               anno["location"], anno["rotation_y"][:, None],
                               anno["score"][:, None]], axis=1)
        file_err = max(file_err, float(np.abs(back - want).max(initial=0)))
    check(file_err <= 5e-5 + 1e-6, f"result files: {file_err} from annos")
    # the gt boxes as detections, through their result files
    gt_dir = Path(tmp) / "gt_as_detections"
    dets, direct = [], []
    for raw in loader:
        gt = raw["gt_boxes"]
        preds = {"final_boxes": gt[..., :7],
                 "final_scores": np.ones(gt.shape[:2], np.float32),
                 "final_labels": gt[..., 7], "final_valid": gt[..., 7] > 0}
        direct += ds.generate_prediction_dicts(raw, preds, names,
                                               output_path=gt_dir)
    dets = read_results(gt_dir / "final_result" / "data", val_ids)
    _, gt_res = ds.evaluation(dets, names, device=dev)
    _, gt_direct = ds.evaluation(direct, names, device=dev)
    gt_annos = [info["annos"] for info in ds.kitti_infos]
    ceilings, below = {}, []
    for cls in names:
        for d, diff_name in enumerate(("easy", "moderate", "hard")):
            n = sum(kitti_eval._clean_data(
                g, dt, kitti_eval.CLASS_NAMES.index(cls), d)[0]
                for g, dt in zip(gt_annos, dets))
            ceilings[f"{cls}/{diff_name}"] = {
                "valid_gt": n,
                "ap_r40_ceiling": 100.0 * (min(n, 41) - 1) / 40 if n else 0.0}
    for key, ap in gt_res.items():
        if "aos" in key:
            continue
        want = ceilings[f"{key.split('_')[0]}/{key.split('/')[1][:-4]}"]
        if abs(ap - want["ap_r40_ceiling"]) > 1e-9:
            below.append((key, ap, want))
    check(not below, f"eval_kitti_second: gt as detections below the "
                     f"AP_R40 ceiling: {below}")
    # the rotated IoU of each gt with its own unrounded round trip
    from q3d_tpu_torch.datasets.kitti.kitti_eval import frame_overlaps
    zero_iou = sum(int((np.diag(ov) == 0).sum()) for ov in frame_overlaps(
        gt_annos, [{k: d[k] for k in ("location", "dimensions", "rotation_y")}
                   for d in direct], 1, dev) if len(ov))
    emit("eval_kitti_second", config="kitti_models/second.yaml",
         entry="q3d_tpu_torch.tools.test --save_to_file", frames=len(ds),
         batch=2, weights="seeded (torch.manual_seed), conv_cls bias 0, BN "
         "statistics from the first batch", mode=mode(),
         runs={run: {"seconds": r[3], "launches": r[4],
                     "infer_time_ms": r[0]["infer_time_ms"],
                     "detections": int(sum(len(a["name"]) for a in r[1])),
                     "ap": {k: r[0][k] for k in ap_keys}}
               for run, r in runs.items()},
         kernels_vs_plain={"slots_matched": matched, "slots": slots,
                           "ap_max_abs_diff": ap_diff},
         result_files=len(texts), result_file_max_abs_err=file_err,
         gt_as_detections={"ap": gt_res, "ceilings": ceilings,
                           "unrounded_ap": gt_direct,
                           "unrounded_zero_bev_iou": zero_iou})

    parta2 = eval_kitti_parta2(root, dev, mode, strict_f32, tmp)

    # ----------------------------------------------------- train_kitti_tree
    history, placed, train_frames, run_s = run_train_cli(
        DS_KITTI_CFG, root, "chip_train", dev, conv_k, ["--epochs", "2"])
    bs = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    n_steps = 2 * (DS_KITTI_FRAMES // bs)
    check(len(history) == n_steps and all(np.isfinite(h["loss"])
                                          for h in history),
          f"train_kitti_tree: {[h['loss'] for h in history]}")
    check(len(placed) == n_steps * bs and sum(placed) > 0,
          f"train_kitti_tree: gt sampling placed {placed}")
    check(all(h["launches_forward"] == DS_CONVS["second"] and
              h["launches_dx"] == DS_CONVS["second"] - 1 for h in history),
          f"train_kitti_tree: launches "
          f"{[(h['launches_forward'], h['launches_dx']) for h in history]}")
    emit("train_kitti_tree", config="kitti_models/second.yaml",
         entry="q3d_tpu_torch.tools.train --epochs 2", batch=bs,
         frames=train_frames[0], steps=len(history), mode=mode(),
         placed_per_frame=placed, run_s=run_s,
         steps_detail=[{k: h[k] for k in (
             "loss", "host_ms", "forward_ms", "backward_ms", "optimizer_ms",
             "peak_mib", "launches_forward", "launches_dx")}
             for h in history])
    return {"conv": {**{f"eval_kitti_second_{run}": r[4][
                         "sparse_gather_conv_" + ("bf16" if run == "bf16"
                                                  else "f32")]
                         for run, r in runs.items() if run != "f32_plain"},
                     "eval_kitti_parta2_f32": parta2[
                         "sparse_gather_conv_f32"]},
            "nms": {**{f"eval_kitti_second_{run}": r[4]["greedy_nms_boxes"]
                       for run, r in runs.items() if run != "f32_plain"},
                    "eval_kitti_parta2_f32": parta2["greedy_nms_boxes"]},
            "train_conv": sum(h["launches_forward"] + h["launches_dx"]
                              for h in history)}


def nuscenes_tree_phases(dev, conv_k, nms_k, mode, strict_f32, flush,
                         clock_mhz, tmp):
    """Phases ``data_nuscenes_tree``, ``eval_nuscenes_centerpoint`` (with
    ``kernel_conv`` on the first batch's 21 convs and
    ``kernel_nms_flagship`` on its 12 candidate sets), and
    ``train_nuscenes_tree`` (see the module docstring) -> launches, and
    kernel 1's and kernel 2's rows for the kernels line."""
    import numpy as np
    import torch
    from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.nuscenes.nuscenes_dataset import \
        NuScenesDataset
    from q3d_tpu_torch.datasets.nuscenes.nuscenes_infos import \
        create_groundtruth_database
    from q3d_tpu_torch.datasets.nuscenes_synthetic import (
        SCENE, write_nuscenes_tree)
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
    from q3d_tpu_torch.utils.checkpoint import save_checkpoint

    root = Path(tmp) / "nuscenes"
    cfg = cfg_from_yaml_file(str(DS_NU_CFG), EDict())
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    names = list(cfg.CLASS_NAMES)
    sweeps = int(cfg.DATA_CONFIG.MAX_SWEEPS)
    cap = int(cfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS.test)
    # --------------------------------------------------- data_nuscenes_tree
    t0 = time.perf_counter()
    write_nuscenes_tree(root, DS_NU_FRAMES, SEED + 200, split="val",
                        sweeps=sweeps)
    write_nuscenes_tree(root, DS_NU_FRAMES, SEED + 300, split="train",
                        sweeps=sweeps)
    write_s = time.perf_counter() - t0
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, names, 2,
                                     training=False)
    check(type(ds).__name__ == "NuScenesDataset" and len(ds) == DS_NU_FRAMES,
          f"the flagship config's dataset: {type(ds).__name__}, {len(ds)}")
    frames = []
    lo = np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE[:3], np.float32)
    for j in range(len(ds)):
        t0 = time.perf_counter()
        frame = ds[j]
        load_ms = (time.perf_counter() - t0) * 1e3
        pts = frame["points"]
        cells = np.floor((pts[:, :3] - lo) / ds.voxel_size).astype(np.int64)
        inside = ((cells >= 0) & (cells < ds.grid_size)).all(1)
        frames.append({"frame": frame["frame_id"],
                       "points": int(len(ds.get_lidar_with_sweeps(
                           j, max_sweeps=sweeps))),
                       "points_in_range": int(inside.sum()),
                       "voxels_occupied": len(np.unique(cells[inside],
                                                        axis=0)),
                       "voxels_kept": int((frame["voxel_num_points"] > 0)
                                          .sum()),
                       "point_features": int(frame["voxels"].shape[-1]),
                       "time_lags": len(np.unique(frame["points"][:, 4])),
                       "gt": int((frame["gt_boxes"][:, -1] > 0).sum()),
                       "loader_host_ms": load_ms})
    check(all(f["voxels_kept"] == f["voxels_occupied"] < cap
              and f["point_features"] == 5 and f["time_lags"] == sweeps
              for f in frames), f"data_nuscenes_tree: {frames} (cap {cap})")
    train_ds = NuScenesDataset(cfg.DATA_CONFIG, names, training=True,
                               rng=np.random.RandomState(SEED))
    train_ds.include_nuscenes_data("train")          # without CBGS
    t0 = time.perf_counter()
    db_path = create_groundtruth_database(train_ds, max_sweeps=sweeps)
    db_s = time.perf_counter() - t0
    import pickle
    with open(db_path, "rb") as f:
        db = {k: len(v) for k, v in pickle.load(f).items()}
    check(sorted(db) == sorted(names), f"nuScenes gt database: {db}")
    emit("data_nuscenes_tree",
         config="nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml",
         dataset="NuScenesDataset", scene=SCENE, sweeps=sweeps,
         written_s=write_s, gt_database_s=db_s, gt_database=db,
         voxel_cap=cap, frames=frames,
         loader_host_ms_median=statistics.median(
             f["loader_host_ms"] for f in frames))

    # -------------------------------------------- eval_nuscenes_centerpoint
    torch.manual_seed(SEED)
    model = build_network(cfg.MODEL, len(names), ds, device=dev)
    strict_f32(True)
    first = next(iter(loader))
    batch = load_data_to_device(first, device=dev)
    calibrate_bns(model, batch)
    ckpt = save_checkpoint(Path(tmp) / "centerpoint_seeded.pth", model)
    outs = {}
    with torch.no_grad():
        for impl in ("cuda", "plain"):
            model.set_kernel_impl(impl)
            clear_launches(conv_k, nms_k)
            outs[impl] = {k: v.cpu() for k, v in model(dict(batch)).items()
                          if k.startswith("final_")}
            outs[impl + "_launches"] = kernel_launches(conv_k, nms_k)
        model.set_kernel_impl(None)
    check(held_launches(outs["cuda_launches"], "f32", DS_CONVS["centerpoint"],
                        1) and held_launches(outs["plain_launches"], "plain",
                                             0, 0),
          f"eval_nuscenes_centerpoint: first batch launches "
          f"{outs['cuda_launches']}, plain {outs['plain_launches']}")
    k_, p_ = outs["cuda"], outs["plain"]
    valid_equal = torch.equal(k_["final_valid"], p_["final_valid"])
    v = k_["final_valid"]
    slot_box = float((k_["final_boxes"][v] - p_["final_boxes"][v]).abs()
                     .max()) if v.any() else 0.0
    slot_score = float((k_["final_scores"][v] - p_["final_scores"][v]).abs()
                       .max()) if v.any() else 0.0
    check(valid_equal and bool(v.any()) and torch.equal(
        k_["final_labels"][v], p_["final_labels"][v]) and slot_box <= 1e-3
        and slot_score <= 1e-4,
        f"eval_nuscenes_centerpoint: kernels vs plain slots: valid equal "
        f"{valid_equal}, box {slot_box}, score {slot_score}")
    # kernel 1 on the first batch's 21 convs, kernel 2 on its 12 sets
    convs, out_ref = record_sparse_convs(model, batch)
    check(len(convs) == DS_CONVS["centerpoint"],
          f"flagship: {len(convs)} sparse convs recorded")
    totals, worst, _ = kernel_conv(convs, flush, mode,
                                   "cbgs_voxel0075_res3d_centerpoint")
    del convs
    head = model.dense_head
    nms_cfg = head.model_cfg.POST_PROCESSING.NMS_CONFIG
    with torch.no_grad():
        cand = head._decode(out_ref["pred_dicts"])
    kc = min(int(nms_cfg.NMS_PRE_MAXSIZE), cand[0].shape[1])
    bx, bv = cand[0][:, :kc, :7].contiguous(), cand[3][:, :kc].contiguous()
    thresh = float(nms_cfg.NMS_THRESH)
    near, needed, most = check_boxes_form(bx, bv, thresh, "flagship")
    corners, areas = nms_mod.bev_corners_areas(bx)
    terms = boxes_bound(*bv.shape, needed, near, clock_mhz)
    nms_row = {"entry": "q3d_greedy_nms_boxes", "sets": int(bv.shape[0]),
               "K": int(bv.shape[1]), "valid": int(bv.sum()),
               "candidate_pairs": needed, "near_pairs": near,
               "near_pairs_most_in_a_tile": most,
               "ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_cuda(
                   corners, areas, bv, thresh), flush=flush),
               "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_plain(
                   bx, bv, thresh), reps=3, flush=flush),
               **{f"{k}_ms": v for k, v in terms.items()}}
    nms_row["bound_by"] = max(terms, key=terms.get)
    nms_row["bound_ms"] = terms[nms_row["bound_by"]]
    emit("kernel_nms_flagship", form="boxes", **nms_row, max_abs_err=0,
         mode=mode(), clock_max_sm_mhz=clock_mhz,
         config="nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml",
         tolerance="keep masks exactly equal, IoU bit-equal at every "
         "evaluated pair, plain IoU exactly 0 at every skipped needed pair")
    del out_ref, cand, corners, areas
    strict_f32(False)
    bf16 = load_data_to_device(first, device=dev, compute_dtype=torch.bfloat16)
    stages = stage_times(model, bf16)
    del model, batch, bf16
    torch.cuda.empty_cache()
    runs = {}
    for run, extra in (("bf16", ["--bf16"]), ("int8", ["--quant", "int8"])):
        runs[run] = run_test_cli(DS_NU_CFG, root, f"chip_{run}", dev,
                                 ["--ckpt", str(ckpt), *extra])
    # the int8 run's quantize_model takes one calibration forward more
    forwards = -(-DS_NU_FRAMES // 2)
    for run, r in runs.items():
        n = forwards + (run == "int8")
        check(held_launches(r[4], run, DS_CONVS["centerpoint"] * n, n),
              f"eval_nuscenes_centerpoint {run}: launches {r[4]}")
    gts = []
    for info in ds.infos:
        gts.append({"frame_id": Path(info["lidar_path"]).stem,
                    "boxes": info["gt_boxes"], "names": info["gt_names"],
                    "scores": np.ones(len(info["gt_boxes"]))})
    _, gt_res = ds.evaluation(gts, names)
    check(abs(gt_res["mAP"] - 1.0) <= 1e-9,
          f"eval_nuscenes_centerpoint: gt as detections mAP {gt_res['mAP']}")
    emit("eval_nuscenes_centerpoint",
         config="nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml",
         entry="q3d_tpu_torch.tools.test", frames=len(ds), batch=2,
         sweeps=sweeps, weights="seeded (torch.manual_seed), BN statistics "
         "from the first batch", mode=mode(),
         kernels_vs_plain={"valid_equal": valid_equal,
                           "detections": int(v.sum()),
                           "box_max_abs_diff": slot_box,
                           "score_max_abs_diff": slot_score,
                           "launches": outs["cuda_launches"]},
         runs={run: {"seconds": r[3], "launches": r[4],
                     "forwards": forwards + (run == "int8"),
                     "launches_per_forward": {
                         "sparse_gather_conv": sum(
                             n for k, n in r[4].items()
                             if k.startswith("sparse_gather_conv"))
                         / (forwards + (run == "int8")),
                         "greedy_nms_boxes": r[4]["greedy_nms_boxes"]
                         / (forwards + (run == "int8"))},
                     "infer_time_ms": r[0]["infer_time_ms"],
                     "detections": int(sum(len(a["name"]) for a in r[1])),
                     "metrics": {k: r[0][k] for k in ("NDS", "mAP")}}
               for run, r in runs.items()},
         gt_as_detections={k: gt_res[k] for k in ("NDS", "mAP")},
         stages_bf16_ms=stages)

    # -------------------------------------------------- train_nuscenes_tree
    bs = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    history, placed, train_frames, run_s = run_train_cli(
        DS_NU_CFG, root, "chip_train", dev, conv_k, ["--epochs", "1"],
        steps=DS_NU_TRAIN_STEPS)
    check(len(history) == DS_NU_TRAIN_STEPS and all(
        np.isfinite(h["loss"]) for h in history),
        f"train_nuscenes_tree: {[h['loss'] for h in history]}")
    check(train_frames and train_frames[0] > DS_NU_FRAMES,
          f"train_nuscenes_tree: CBGS gave {train_frames} frames")
    check(len(placed) == DS_NU_TRAIN_STEPS * bs and sum(placed) > 0,
          f"train_nuscenes_tree: gt sampling placed {placed}")
    check(all(h["launches_forward"] == DS_CONVS["centerpoint"]
              and h["launches_dx"] == DS_CONVS["centerpoint"] - 1
              for h in history),
          f"train_nuscenes_tree: launches "
          f"{[(h['launches_forward'], h['launches_dx']) for h in history]}")
    emit("train_nuscenes_tree",
         config="nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml",
         entry="q3d_tpu_torch.tools.train, stopped after "
               f"{DS_NU_TRAIN_STEPS} steps", batch=bs,
         frames_after_cbgs=train_frames[0], steps=len(history), mode=mode(),
         placed_per_frame=placed, run_s=run_s,
         steps_detail=[{k: h[k] for k in (
             "loss", "host_ms", "forward_ms", "backward_ms", "optimizer_ms",
             "peak_mib", "launches_forward", "launches_dx")}
             for h in history])
    conv = {f"eval_nuscenes_centerpoint_{run}": sum(
        n for k, n in r[4].items() if k.startswith("sparse_gather_conv"))
        for run, r in runs.items()}
    bf16_launches = conv["eval_nuscenes_centerpoint_bf16"]
    conv_row = {
        "name": "sparse_gather_conv_flagship", "route": "cuda",
        "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
        "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
        "use": "nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml as "
               "written, 10 sweeps, 5 point features (tools/test.py --bf16)",
        "launches": bf16_launches, "max_abs_err": worst["bf16"],
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"]
        else "operations", "library_ms": totals["library_ms"],
        "checks": "passed",
        "times_cover": "the first batch's 21 convs (batch 2, f32 features "
                       "cast per dtype; the bf16 numbers)"}
    nms_kernel_row = {
        "name": "greedy_nms_flagship", "route": "cuda",
        "source": "q3d_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "q3d_tpu/ops/iou3d_nms/pallas_nms.py:45",
        "entry": "q3d_greedy_nms_boxes",
        "use": conv_row["use"],
        "launches": runs["bf16"][4]["greedy_nms_boxes"], "max_abs_err": 0.0,
        "ms": nms_row["ms"], "plain_ms": nms_row["plain_ms"],
        "bound_ms": nms_row["bound_ms"], "bound_by": nms_row["bound_by"],
        "library_ms": None, "checks": "passed",
        "times_cover": f"the first batch's {nms_row['sets']} candidate sets "
                       f"(K={nms_row['K']})"}
    return {"conv": conv,
            "nms": {f"eval_nuscenes_centerpoint_{run}":
                    r[4]["greedy_nms_boxes"] for run, r in runs.items()},
            "train_conv": sum(h["launches_forward"] + h["launches_dx"]
                              for h in history),
            "rows": [conv_row, nms_kernel_row]}


def dataset_phases(dev, conv_k, nms_k, mode, strict_f32, flush, clock_mhz):
    """The KITTI and nuScenes tree phases in a temporary directory ->
    their launches by path and the flagship's kernel rows, for the kernels
    line."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        kitti = kitti_tree_phases(dev, conv_k, nms_k, mode, strict_f32, tmp)
        nu = nuscenes_tree_phases(dev, conv_k, nms_k, mode, strict_f32,
                                  flush, clock_mhz, tmp)
    conv = {**kitti["conv"], **nu["conv"],
            "train_kitti_tree": kitti["train_conv"],
            "train_nuscenes_tree": nu["train_conv"]}
    return {"conv": conv, "nms": {**kitti["nms"], **nu["nms"]},
            "rows": nu["rows"]}


def ptxas_spills(libraries):
    """From each build's ``-Xptxas -v`` log: the kernels that spill ->
    [{library, kernel (mangled), registers, spill stores, spill loads}]."""
    import re
    out = []
    for lib in libraries:
        for so in lib.so_paths:
            kernel = None
            for line in so.with_suffix(".log").read_text().splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    kernel = m.group(1)
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m and (int(m.group(1)) or int(m.group(2))):
                    out.append({"library": so.name, "kernel": kernel,
                                "spill_stores": int(m.group(1)),
                                "spill_loads": int(m.group(2))})
    return out


def main():
    import numpy as np
    import torch
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "q3d_tpu_torch").is_dir() or not CFG.exists():
        print("chip_smoke: run from a checkout of the repo "
              "(q3d_tpu_torch/ or the configs are missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.ops import kernel_build
    from q3d_tpu_torch.ops.iou3d_nms import candidate_iou
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.ops.spconv import gather_conv
    from q3d_tpu_torch.ops.spconv.modules import SubMConv3d, SparseConv3d
    from q3d_tpu_torch.models import layers as dense_layers
    from q3d_tpu_torch.ops.spconv import modules as sp_modules
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.quant.tensor_quant import (TensorQuantizer,
                                                  quantize_with_scale)
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns

    conv_k, nms_k = gather_conv.KERNEL, nms_mod.KERNEL
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # --------------------------------------------------------------- build
    build_s = kernel_build.build_all([conv_k, nms_k])
    for lib in (conv_k, nms_k):
        lib.lib()
    emit("build", seconds=build_s, libraries=[str(so.relative_to(ROOT))
                                              for lib in (conv_k, nms_k)
                                              for so in lib.so_paths],
         spills=ptxas_spills([conv_k, nms_k]), nvidia_smi=smi)

    # ---------------------------------------------------------- data/model
    cfg = cfg_from_yaml_file(str(CFG), EDict())
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                batch_size=BATCH, training=False)

    def request(r):
        return make_request(ds, r)

    check(len(ds) == BATCH * REQUESTS, f"dataset has {len(ds)} frames")
    raw0, _, _ = request(0)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    defaults = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.deterministic)

    def strict_f32(on):
        """TF32 off and deterministic cuDNN in the f32 comparison phases;
        PyTorch's own settings back for the timed bf16 phases."""
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = (False, False, True) if on \
            else defaults

    def mode():
        return {"tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
                "tf32_cudnn": torch.backends.cudnn.allow_tf32,
                "cudnn_deterministic": torch.backends.cudnn.deterministic}

    strict_f32(True)
    batch_f32 = load_data_to_device(raw0, device=dev)

    # BN statistics from the first request (a trained model's BNs match
    # their inputs; random weights with identity BNs fade to constants)
    calibrate_bns(model, batch_f32)

    # ------------------------------------------------------ kernels: conv
    convs, out_ref = record_sparse_convs(model, batch_f32)
    check(len(convs) == 21, f"expected 21 sparse convs, recorded {len(convs)}")

    scratch = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    totals, worst, _ = kernel_conv(convs, flush, mode, CFG.stem)

    # ------------------------------------------------------- kernels: NMS
    head = model.dense_head
    with torch.no_grad():
        sb, ss, sl, sv = head._decode(out_ref["pred_dicts"])
    pre = int(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE)
    thresh = float(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_THRESH)
    kc = min(pre, sb.shape[1])
    cand, cand_valid = sb[:, :kc].contiguous(), sv[:, :kc].contiguous()
    # the IoU form (the TPU kernel's own function) on the shared sweep
    iou, iou_valid = candidate_iou(cand, cand_valid)
    keep_k = nms_mod.greedy_nms(iou, iou_valid, thresh, impl="cuda")
    keep_p = nms_mod.greedy_nms(iou, iou_valid, thresh, impl="plain")
    check(torch.equal(keep_k, keep_p), "greedy_nms: ref-decode keep masks differ")
    g = torch.Generator(device=dev).manual_seed(SEED)
    for s, kk in ((6, 128), (6, 1024), (6, 2048)):
        r_iou = torch.rand((s, kk, kk), generator=g, device=dev)
        r_valid = torch.rand((s, kk), generator=g, device=dev) > 0.1
        for th in (0.2, 0.5, 0.9):
            check(torch.equal(nms_mod.greedy_nms(r_iou, r_valid, th, impl="cuda"),
                              nms_mod.greedy_nms(r_iou, r_valid, th, impl="plain")),
                  f"greedy_nms: random K={kk} thresh={th} keep masks differ")

    near_pairs, cand_pairs, near_max_tile = check_boxes_form(
        cand, cand_valid, thresh, "ref decode")
    rng = np.random.RandomState(SEED)
    for kk in (128, 1024):
        rb_ = np.zeros((6, kk, 7), np.float32)      # crowded, with duplicates
        rb_[..., 0:2] = rng.uniform(-0.4, 0.4, (6, kk, 2)) * np.sqrt(kk)
        rb_[..., 3:6] = rng.uniform(0.5, 4.5, (6, kk, 3))
        rb_[..., 6] = rng.uniform(-np.pi, np.pi, (6, kk))
        rb_[:, 10:20] = rb_[:, 0:10]
        rb_[:, 20:30, :6] = rb_[:, 30:40, :6]
        r_boxes = torch.from_numpy(rb_).to(dev)
        r_valid = torch.from_numpy(rng.rand(6, kk) > 0.1).to(dev)
        for th in (0.2, 0.5, 0.9):
            check_boxes_form(r_boxes, r_valid, th, f"random K={kk}")

    # times of the old path's pieces (candidate_iou, then the IoU form) and
    # the new one's, all on the ref decode's candidates, L2 flushed
    corners, areas = nms_mod.bev_corners_areas(cand)
    s, kp, _ = iou.shape
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])

    def bound(terms):
        """The largest term in ms, and its name."""
        name = max(terms, key=terms.get)
        return terms[name], name
    # IoU form: the entries iou[j, i] the function needs (j < i, both valid)
    # read once, one compare each, valid read and keep written once; the
    # sweep's chain of K steps at >= 4 cycles each
    n_cand = iou_valid.sum(1).double()
    pairs = float((n_cand * (n_cand - 1) / 2).sum())
    iou_terms = {"bytes": 1e3 * (pairs * 4 + 2 * s * kp) / HBM_BYTES_PER_S,
                 "operations": 1e3 * pairs / PEAK_OPS_PER_S["f32"],
                 "latency": 1e3 * kp * 4 / (clock_mhz * 1e6)}
    box_terms = boxes_bound(s, kc, cand_pairs, near_pairs, clock_mhz)
    iou_form = {
        "entry": "q3d_greedy_nms", "sets": s, "K": kp,
        "candidate_pairs": pairs,
        "ms": time_ms(lambda: nms_mod.greedy_suppress_cuda(iou, iou_valid,
                                                           thresh), flush=flush),
        "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_plain(
            iou, iou_valid, thresh), reps=5, flush=flush),
        "candidate_iou_ms": time_ms(lambda: candidate_iou(cand, cand_valid),
                                    reps=5, flush=flush),
        **{f"{k}_ms": v for k, v in iou_terms.items()}}
    iou_form["bound_ms"], iou_form["bound_by"] = bound(iou_terms)
    boxes_form = {
        "entry": "q3d_greedy_nms_boxes", "sets": s, "K": kc,
        "candidate_pairs": cand_pairs, "near_pairs": near_pairs,
        "near_pairs_most_in_a_tile": near_max_tile,
        "kept": int(nms_mod.greedy_nms_boxes(cand, cand_valid, thresh).sum()),
        "ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_cuda(
            corners, areas, cand_valid, thresh), flush=flush),
        "with_corners_ms": time_ms(lambda: nms_mod.greedy_nms_boxes(
            cand, cand_valid, thresh, impl="cuda"), flush=flush),
        "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_plain(
            cand, cand_valid, thresh), reps=5, flush=flush),
        **{f"{k}_ms": v for k, v in box_terms.items()},
        "operations_all_pairs_ms": 1e3 * cand_pairs * IOU_OPS
        / PEAK_OPS_PER_S["f32"]}
    boxes_form["bound_ms"], boxes_form["bound_by"] = bound(box_terms)
    iou_form["kernel_us"] = kernel_device_us(
        lambda: nms_mod.greedy_suppress_cuda(iou, iou_valid, thresh),
        ("nms_iou_mask_kernel", "nms_sweep_kernel"), flush)
    boxes_form["kernel_us"] = kernel_device_us(
        lambda: nms_mod.greedy_suppress_boxes_cuda(corners, areas, cand_valid,
                                                   thresh),
        ("nms_box_pairs_kernel", "nms_box_iou_kernel", "nms_sweep_kernel"),
        flush)
    # the sweep's cost per row of the chain: its device time at three K on
    # random IoU matrices (its code does the same work whatever the data)
    sweep_us = {}
    for kk in (512, 1024, 2048):
        r_iou = torch.rand((s, kk, kk), generator=g, device=dev)
        r_valid = torch.ones((s, kk), dtype=torch.bool, device=dev)
        us = kernel_device_us(lambda: nms_mod.greedy_suppress_cuda(
            r_iou, r_valid, thresh), ("nms_sweep_kernel",), flush)
        sweep_us[kk] = us if isinstance(us, str) else us["nms_sweep_kernel"]
    if not any(isinstance(v, str) for v in sweep_us.values()):
        iou_form["sweep_us_by_K"] = sweep_us
        iou_form["sweep_cycles_per_row"] = (sweep_us[2048] - sweep_us[512]) \
            * clock_mhz / (2048 - 512)
    old_path_ms = iou_form["candidate_iou_ms"] + iou_form["ms"]
    emit("kernel_nms", form="iou", **iou_form, kept=int(keep_k.sum()),
         max_abs_err=0, tolerance="keep masks exactly equal (ref decode + "
         "random K=128/1024/2048)", clock_max_sm_mhz=clock_mhz)
    emit("kernel_nms", form="boxes", **boxes_form, max_abs_err=0,
         old_path_ms=old_path_ms, under_old_path=boxes_form["ms"] < old_path_ms,
         tolerance="keep masks exactly equal, IoU bit-equal at every "
         "evaluated pair, plain IoU exactly 0 at every skipped needed pair "
         "(ref decode + random K=128/1024 x thresh 0.2/0.5/0.9)",
         clock_max_sm_mhz=clock_mhz)
    check(boxes_form["ms"] < old_path_ms,
          f"boxes form {boxes_form['ms']} ms is not under candidate_iou + the "
          f"IoU form, {old_path_ms} ms")

    # -------------------------------------------------------------- serving
    strict_f32(False)
    conv_k.launches.clear()
    nms_k.launches.clear()
    per_request = []
    for r in range(REQUESTS):
        raw, scene_ms, vox_ms = request(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = load_data_to_device(raw, device=dev, compute_dtype=torch.bfloat16)
        with torch.no_grad():
            out = model(batch)
        n_valid = out["final_valid"].sum(dim=1).tolist()
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.isfinite(out[k].float()).all() for k in
                  ("spatial_features_2d", "final_boxes", "final_scores")),
              f"request {r}: non-finite outputs")
        check(out["final_boxes"].shape == (BATCH, 3 * 83, 9),
              f"request {r}: final_boxes shape {tuple(out['final_boxes'].shape)}")
        per_request.append({"request": r, "frames": [2 * r, 2 * r + 1],
                            "scene_ms": scene_ms, "voxelize_ms": vox_ms,
                            "device_forward_ms": fwd_ms,
                            "valid_detections": n_valid})
        emit("serving_request", **per_request[-1])
    launches = {"sparse_gather_conv": sum(conv_k.launches.values()),
                "greedy_nms_boxes": nms_k.launches["q3d_greedy_nms_boxes"],
                "greedy_nms_iou": nms_k.launches["q3d_greedy_nms"]}
    check(launches["sparse_gather_conv"] == 21 * REQUESTS
          and launches["greedy_nms_boxes"] == REQUESTS
          and launches["greedy_nms_iou"] == 0,
          f"main path launches {launches}")
    emit("serving", config=CFG.name, batch=BATCH, dtype="bf16",
         requests=REQUESTS, launches=launches, mode=mode(),
         steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]))

    # ------------------------------------------------------------- stages
    # where one bf16 forward's time goes: CUDA events around each stage of
    # the last request, median of 5 forwards
    emit("stages", dtype="bf16", batch=BATCH, mode=mode(),
         ms=stage_times(model, batch), sparse_conv_kernels_ms=totals["ms"])

    # --------------------------------------------------- whole-model check
    strict_f32(True)
    with torch.no_grad():
        model.set_kernel_impl("cuda")
        out_k = model(dict(batch_f32))
        model.set_kernel_impl("plain")
        out_p = model(dict(batch_f32))
        model.set_kernel_impl(None)
    maps = {"spatial_features": (out_k["spatial_features"],
                                 out_p["spatial_features"]),
            "spatial_features_2d": (out_k["spatial_features_2d"],
                                    out_p["spatial_features_2d"])}
    for h, (pk, pp) in enumerate(zip(out_k["pred_dicts"], out_p["pred_dicts"])):
        for key in pk:
            maps[f"head{h}.{key}"] = (pk[key], pp[key])
    map_err = {}
    for key, (a, b) in maps.items():
        err, mag = float((a - b).abs().max()), float(b.abs().max())
        map_err[key] = err
        check(err <= 1e-4 * max(1.0, mag),
              f"model f32 {key}: kernels vs plain max err {err} (scale {mag})")
    # identical candidates through both NMS paths: equal keep masks and
    # equal final detections
    with torch.no_grad():
        cand = head._decode(out_k["pred_dicts"])
        iou, iou_valid = candidate_iou(cand[0][:, :kc], cand[3][:, :kc])
        check(torch.equal(nms_mod.greedy_nms(iou, iou_valid, thresh, impl="cuda"),
                          nms_mod.greedy_nms(iou, iou_valid, thresh, impl="plain")),
              "model f32: NMS keep masks (IoU form) differ on identical "
              "candidates")
        bx, bv = cand[0][:, :kc].contiguous(), cand[3][:, :kc].contiguous()
        check(torch.equal(nms_mod.greedy_nms_boxes(bx, bv, thresh, impl="cuda"),
                          nms_mod.greedy_nms_boxes(bx, bv, thresh, impl="plain")),
              "model f32: NMS keep masks (boxes form) differ on identical "
              "candidates")
        finals = []
        for impl in ("cuda", "plain"):
            head.kernel_impl = impl
            bd = {}
            head._nms(bd, *cand)
            finals.append(bd)
        head.kernel_impl = None
    for key in ("final_boxes", "final_scores", "final_labels", "final_valid"):
        check(torch.equal(finals[0][key], finals[1][key]),
              f"model f32: {key} differs between NMS kernel and plain")
    # end to end: every valid detection of one run has a partner in the
    # other (same label, box within 1e-3, score within 1e-4); a partner can
    # be missing only where near-equal scores reorder the greedy sweep
    matched, total = matched_detections(out_k, out_p, BATCH)
    frac = matched / max(total, 1)
    check(frac >= 0.99, f"model f32: only {matched}/{total} detections matched")
    emit("model_check", dtype="f32", mode=mode(), map_max_abs_err=map_err,
         map_tolerance="max|k-p| <= 1e-4 * max(1, max|p|)",
         nms_identical_inputs="keep masks (both forms) and final detections "
         "(head._nms through the kernel and the plain version) equal",
         detections_matched=matched, detections=total, matched_fraction=frac)
    strict_f32(False)

    # ========================================================= int8 deploy
    # the bench recipe (every sparse conv and BEV conv int8 with residency,
    # the head bf16), calibrated with method "max" on the first request
    # given twice, as the JAX package's bench calibrates
    batch0 = load_data_to_device(raw0, device=dev, compute_dtype=torch.bfloat16)

    def int8_model(recipe):
        m8 = copy.deepcopy(model)
        quant_api.prepare_int8_deploy(m8, [batch0, batch0],
                                      recipe_kwargs=recipe)
        return m8
    t0 = time.perf_counter()
    bench8 = int8_model(BENCH_RECIPE)
    calib_s = time.perf_counter() - t0

    # one forward with the fused entry's and the dense int8 conv's
    # arguments recorded, call by call, under their module's name
    fused_calls, dense_calls, current = [], [], [None]
    names8 = {m: n for n, m in bench8.named_modules()}
    real_rq, real_i8 = sp_modules.sparse_gather_conv_requant, \
        dense_layers.int8_conv2d

    def note(mod, args):
        current[0] = names8[mod]

    def rec_rq(*args, **kw):
        fused_calls.append((current[0], args, kw))
        return real_rq(*args, **kw)

    def rec_i8(*args, **kw):
        dense_calls.append((current[0], args, kw))
        return real_i8(*args, **kw)
    hooks = [m.register_forward_pre_hook(note) for m in bench8.modules()
             if hasattr(m, "QUANT_KIND")]
    sp_modules.sparse_gather_conv_requant = rec_rq
    dense_layers.int8_conv2d = rec_i8
    try:
        with torch.no_grad():
            bench8(dict(batch0))
    finally:
        sp_modules.sparse_gather_conv_requant = real_rq
        dense_layers.int8_conv2d = real_i8
        for h in hooks:
            h.remove()
    check(len(fused_calls) == 21,
          f"bench int8: {len(fused_calls)} fused sparse convs, expected 21")
    check(len(dense_calls) == 12,
          f"bench int8: {len(dense_calls)} int8 BEV convs, expected 12")

    # ----------------------------------------- kernels: the fused s8 entry
    rq_totals = {k: 0.0 for k in ("ms", "unfused_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bytes_ms", "ops_ms")}
    with torch.no_grad():
        for name, args, kw in fused_calls:
            kw = {k: v for k, v in kw.items() if k != "impl"}
            f, idx, wq, osc, kf, bf, s_rq = args
            n, cin = f.shape
            m, k = idx.shape
            cout = wq.shape[2]
            ident = kw["identity"]
            q_k = gather_conv.gather_conv_requant_cuda(*args, **kw)
            q_p = gather_conv.gather_conv_requant_plain(*args, **kw)
            torch.cuda.synchronize()
            ndiff = int((q_k != q_p).sum())
            check(ndiff == 0, f"{name} fused s8 requant: {ndiff} of "
                              f"{q_k.numel()} int8 outputs differ from plain")
            present = (idx >= 0) & (idx < n)
            n_present = int(present.sum())
            rows_read = int(torch.unique(idx[present]).numel())

            def unfused():
                y = gather_conv.gather_conv_cuda(f, idx, wq, osc,
                                                 kw["out_valid"])
                return quantize_with_scale(gather_conv.epilogue_f32(
                    y, kf, bf, kw["row_valid"], ident, kw["identity_scale"]), s_rq)
            flatq = torch.cat([f, f.new_zeros((1, cin))])
            safe = torch.where(present, idx.long(), n).reshape(-1)
            wq2 = wq.reshape(k * cin, cout)
            row = {"conv": name, "N": n, "M": m, "K": k, "Cin": cin,
                   "Cout": cout, "present_taps": n_present,
                   "identity": None if ident is None else str(ident.dtype),
                   "ms": time_ms(lambda: gather_conv.gather_conv_requant_cuda(
                       *args, **kw), flush=flush),
                   "unfused_ms": time_ms(unfused, flush=flush),
                   "plain_ms": time_ms(lambda: gather_conv.gather_conv_requant_plain(
                       *args, **kw), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch._int_mm(
                       flatq[safe].reshape(m, k * cin), wq2), flush=flush)}
            # inputs read once (the rows the book uses, the book, the
            # weights, the identity, the scale/fold vectors, the masks), the
            # s8 output written once; the present taps' operations
            nbytes = rows_read * cin + m * k * 4 + k * cin * cout + m * cout \
                + (0 if ident is None else m * cout * ident.element_size()) \
                + 3 * 4 * cout + 2 * m
            row["bytes_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
            row["ops_ms"] = 1e3 * 2.0 * n_present * cin * cout \
                / PEAK_OPS_PER_S["s8"]
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            emit("kernel_conv_s8_requant", **row)
            for key in rq_totals:
                rq_totals[key] += row[key]
    rq_totals["bound_by"] = "bytes" if rq_totals["bytes_ms"] \
        >= rq_totals["ops_ms"] else "operations"
    emit("kernel_conv_s8_requant_total", convs=len(fused_calls), **rq_totals,
         calibration_s=calib_s, recipe="bench", mode=mode(),
         tolerance="bit-exact (int8 outputs equal)", max_abs_err=0,
         unfused="s8 entry (f32 rows) + the torch epilogue and requant",
         library="gather + torch._int_mm (the conv without its epilogue)")

    # --------------------------------------- the dense int8 conv (_int_mm)
    i8_rows = []
    with torch.no_grad():
        for name, args, kw in dense_calls:
            x, w8, stride, padding = args
            o_k = real_i8(x, w8, stride, padding, impl="cuda")
            o_p = real_i8(x, w8, stride, padding, impl="plain")
            torch.cuda.synchronize()
            check(torch.equal(o_k, o_p),
                  f"{name} int8_conv2d: _int_mm s32 != the exact product")
            a, _ = dense_layers._patches(x, w8.shape[2:], stride, padding)
            wm = w8.permute(0, 2, 3, 1).reshape(w8.shape[0], -1)
            xb = x.to(torch.bfloat16).contiguous()
            wb = w8.to(torch.bfloat16)
            mm, kk_, nn_ = a.shape[0], a.shape[1], wm.shape[0]
            row = {"conv": name, "x": list(x.shape), "w": list(w8.shape),
                   "stride": list(stride), "gemm_mkn": [mm, kk_, nn_],
                   "ms": time_ms(lambda: real_i8(x, w8, stride, padding,
                                                 impl="cuda"), flush=flush),
                   "int_mm_ms": time_ms(lambda: torch._int_mm(a, wm.t()),
                                        flush=flush),
                   "cudnn_bf16_ms": time_ms(lambda: torch.nn.functional.conv2d(
                       xb, wb, None, stride, padding), flush=flush)}
            nbytes = x.numel() + w8.numel() + 4 * mm * nn_
            row["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, 2.0 * mm
                                        * kk_ * nn_ / PEAK_OPS_PER_S["s8"])
            emit("int8_conv2d", **row)
            i8_rows.append(row)
    emit("int8_conv2d_total", convs=len(i8_rows), mode=mode(),
         tolerance="s32 exactly equal to the plain product",
         **{k: sum(r[k] for r in i8_rows)
            for k in ("ms", "int_mm_ms", "cudnn_bf16_ms", "bound_ms")})

    # ------------------------------------------------------ serving, int8
    clear_launches(conv_k, nms_k)
    per_request = []
    for r in range(REQUESTS):
        raw, scene_ms, vox_ms = request(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = load_data_to_device(raw, device=dev, compute_dtype=torch.bfloat16)
        with torch.no_grad():
            out = bench8(batch)
        n_valid = out["final_valid"].sum(dim=1).tolist()
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.isfinite(out[k].float()).all() for k in
                  ("spatial_features_2d", "final_boxes", "final_scores")),
              f"int8 request {r}: non-finite outputs")
        check(out["final_boxes"].shape == (BATCH, 3 * 83, 9),
              f"int8 request {r}: final_boxes shape "
              f"{tuple(out['final_boxes'].shape)}")
        per_request.append({"request": r, "frames": [2 * r, 2 * r + 1],
                            "scene_ms": scene_ms, "voxelize_ms": vox_ms,
                            "device_forward_ms": fwd_ms,
                            "valid_detections": n_valid})
        emit("serving_int8_request", **per_request[-1])
    launches8 = {
        "sparse_gather_conv_s8_requant": conv_k.launches[gather_conv.REQUANT_ENTRY],
        "sparse_gather_conv_other": sum(conv_k.launches.values())
        - conv_k.launches[gather_conv.REQUANT_ENTRY],
        "int_mm_conv2d": dense_layers.INT_MM_CALLS["int8_conv2d"],
        "greedy_nms_boxes": nms_k.launches["q3d_greedy_nms_boxes"],
        "greedy_nms_iou": nms_k.launches["q3d_greedy_nms"]}
    check(launches8 == {"sparse_gather_conv_s8_requant": 21 * REQUESTS,
                        "sparse_gather_conv_other": 0,
                        "int_mm_conv2d": 12 * REQUESTS,
                        "greedy_nms_boxes": REQUESTS, "greedy_nms_iou": 0},
          f"int8 main path launches {launches8}")
    # bf16 and int8 forwards of the same batch in turns, host clock around
    # a forward that ends in a synchronize
    fwd = {"bf16": [], "int8": []}
    with torch.no_grad():
        for _ in range(6):
            for tag, mdl in (("bf16", model), ("int8", bench8)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mdl(dict(batch))
                torch.cuda.synchronize()
                fwd[tag].append((time.perf_counter() - t0) * 1e3)
    fwd_med = {k: statistics.median(v[1:]) for k, v in fwd.items()}
    emit("serving_int8", config=CFG.name, batch=BATCH, recipe="bench",
         requests=REQUESTS, launches=launches8, mode=mode(),
         steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]),
         in_turns_forward_ms=fwd_med,
         int8_vs_bf16=fwd_med["bf16"] / fwd_med["int8"])
    st8 = stage_times(bench8, batch)
    st16 = stage_times(model, batch)
    emit("stages_int8", batch=BATCH, recipe="bench", mode=mode(),
         ms_int8=st8, ms_bf16=st16,
         bf16_over_int8={k: st16[k] / st8[k] for k in st8 if st8[k] > 0},
         fused_conv_kernels_ms=rq_totals["ms"])
    emit("forward_trace", batch=BATCH, recipe="bench", mode=mode(),
         bf16=forward_trace(model, batch), int8=forward_trace(bench8, batch))

    # --------------------------------------- whole-model check, int8 path
    # one request through the kernels and through the plain versions with
    # one set of calibrated scales, under both recipes: every int8 feature
    # map a residency layer emits, spatial_features and the detections
    # equal.  The entry recipe keeps conv_input float, and a float conv
    # equals its plain version exactly only in f32 (bf16: within one
    # rounding), so its request is the f32 one.
    strict_f32(True)
    recipes = {"bench": (bench8, batch0), "entry": (int8_model({}), batch_f32)}
    model_int8 = {}
    for tag, (m8, req) in recipes.items():
        grabbed = {"cuda": [], "plain": []}
        impl_now = [None]

        def grab(mod, args, out):
            t = out.features if hasattr(out, "features") else out[0]
            if t.dtype == torch.int8:
                grabbed[impl_now[0]].append((names_q[mod], t))
        names_q = {mm: n for n, mm in m8.named_modules()}
        sparse_names = {n for mm, n in names_q.items()
                        if isinstance(mm, (SubMConv3d, SparseConv3d))}
        watched = [mm for mm in m8.modules()
                   if isinstance(mm, (SubMConv3d, SparseConv3d))
                   or (isinstance(mm, TensorQuantizer)
                       and not names_q[mm].endswith("weight_quant"))]
        hooks = [mm.register_forward_hook(grab) for mm in watched]
        outs, ms, fused = {}, {}, {}
        try:
            with torch.no_grad():
                for impl in ("cuda", "plain"):
                    impl_now[0] = impl
                    m8.set_kernel_impl(impl)
                    fused0 = conv_k.launches[gather_conv.REQUANT_ENTRY]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs[impl] = m8(dict(req))
                    torch.cuda.synchronize()
                    ms[impl] = (time.perf_counter() - t0) * 1e3
                    fused[impl] = conv_k.launches[gather_conv.REQUANT_ENTRY] \
                        - fused0
        finally:
            m8.set_kernel_impl(None)
            for h in hooks:
                h.remove()
        n_sparse = 21 if tag == "bench" else 20      # entry: conv_input float
        check(fused == {"cuda": n_sparse, "plain": 0},
              f"model int8 {tag}: fused entry launches {fused}")
        gk, gp = grabbed["cuda"], grabbed["plain"]
        check(len(gk) == len(gp) > 0 and [n for n, _ in gk] == [n for n, _ in gp],
              f"model int8 {tag}: int8 maps {len(gk)} vs {len(gp)}")
        bad = [n for (n, a), (_, b) in zip(gk, gp) if not torch.equal(a, b)]
        check(not bad, f"model int8 {tag}: int8 features differ at {bad[:5]}")
        for key in ("spatial_features", "final_boxes", "final_scores",
                    "final_labels", "final_valid"):
            check(torch.equal(outs["cuda"][key], outs["plain"][key]),
                  f"model int8 {tag}: {key} differs between kernels and plain")
        model_int8[tag] = {
            "request_dtype": str(req["voxels"].dtype),
            "fused_launches": fused["cuda"],
            "int8_maps_equal": len(gk),
            "sparse_int8_maps": sum(n in sparse_names for n, _ in gk),
            "valid_detections": outs["cuda"]["final_valid"].sum(1).tolist(),
            "forward_ms": ms}
    emit("model_int8", recipes=model_int8, mode=mode(), batch=BATCH,
         equal="every int8 map a residency layer emits, spatial_features and "
               "final boxes/scores/labels/valid, kernels vs plain (exact)")
    strict_f32(False)

    # ============================== int8 deploy without residency
    # the PTQ driver's and tools/test.py's recipes: dynamic, SmoothQuant and
    # static, each sparse conv on kernel 1's unfused s8 entry
    deploy, s8_calls = deploy_int8(model, batch0, batch_f32, conv_k, nms_k,
                                   mode, strict_f32, flush)
    s8_totals = kernel_conv_s8(s8_calls, flush, mode)

    # ================================= the accuracy gates and fake-quant
    # both in f32 with TF32 off, as the reference's eval_one_epoch runs
    strict_f32(True)
    gates = eval_gates(dev, conv_k, nms_k, mode)
    fakequant_ref(model, batch_f32, conv_k, nms_k, mode, flush)
    driver = driver_tiny(conv_k, nms_k, mode, gates["fp32"]["cuda"]["NDS"])
    strict_f32(False)

    def per_recipe(key):
        return {tag: g["cuda"]["launches"][key] for tag, g in gates.items()}

    # ============================= SECOND and PointPillars at KITTI width
    kitti = {name: kitti_model(name, dev, conv_k, nms_k, mode, strict_f32)
             for name in KITTI_CONVS}
    strict_f32(True)
    second_totals, second_worst, _ = kernel_conv(kitti["second"]["convs"],
                                                 flush, mode, "second")
    strict_f32(False)
    nms_wide = kernel_nms_wide(kitti, flush, mode, clock_mhz)
    recipes_kitti(kitti, conv_k, nms_k, mode, strict_f32)
    kitti_launches = {name: {"sparse_gather_conv": sum(
        k_["launches"][e] for e in k_["launches"]
        if e.startswith("sparse_gather_conv")),
        "greedy_nms_boxes": k_["launches"]["greedy_nms_boxes"]}
        for name, k_ in kitti.items()}

    # ============================================================ training
    # the trainer: one step's gradients through the kernels against the
    # plain versions (f32, TF32 off), kernel 1 as the input gradient, QAT
    # on the trained tiny fixture; then the tiny model learning, and
    # train_model at ref width (the slice's main path; PyTorch's TF32
    # defaults)
    # a ref training step through both routes needs ~23 GB: let go of the
    # inference phases' models and recorded conv inputs first
    n_s8_convs = len(s8_calls)
    del bench8, recipes, m8, fused_calls, dense_calls, s8_calls, kitti
    strict_f32(True)
    recorded, _ = train_grad(model, batch_f32, conv_k, mode)
    dx_totals = kernel_dx(recorded, flush, mode)
    del recorded
    qat_tiny(dev, conv_k, mode)
    strict_f32(False)
    train_tiny(dev, mode)
    trained = train_ref(dev, conv_k, mode)

    # ============================= SECOND and PointPillars training
    # one step's gradients through the kernels against the plain versions
    # and SECOND's dX (f32, TF32 off), QAT; then train_model with the data
    # augmentor (the slice's main path; PyTorch's TF32 defaults)
    strict_f32(True)
    kitti_train = train_kitti_grad(dev, conv_k, mode)
    recorded = kitti_train["second"].pop("recorded")
    fwd_second = kernel_forward(recorded, flush, mode, "kernel_fwd_second",
                                "kitti_models/second.yaml")
    dx_second = kernel_dx(recorded, flush, mode, "kernel_dx_second",
                          "kitti_models/second.yaml")
    del recorded
    qat_kitti(kitti_train, conv_k, mode)
    strict_f32(False)
    del kitti_train
    kitti_trained = train_kitti(dev, conv_k, nms_k, mode)

    # ============================================================ VoxelNeXt
    # inference at the nuScenes config's width on centerpoint_ref's scenes:
    # kernel 1 on 3D and 2D books, the pointwise 1x1 head convs, kernel 2 on
    # 12 candidate sets; the PTQ recipes; double flip at tiny width
    torch.cuda.empty_cache()
    vn = voxelnext_phases(dev, conv_k, nms_k, mode, strict_f32, flush)

    # ========================================================== TransFusion
    # inference at the nuScenes config's width on centerpoint_ref's scenes:
    # kernel 1 on the 21 sparse convs, the cross-attention decoder in torch,
    # no NMS; its PTQ recipe, dynamic and static
    torch.cuda.empty_cache()
    tf = transfusion_phases(dev, conv_k, nms_k, mode, strict_f32, flush)

    # ============================== TransFusion and VoxelNeXt training
    # at the nuScenes configs' width: kernel 1 as every sparse conv's
    # forward and input gradient (VoxelNeXt's 2D books too), the set loss
    # and the sparse targets, QAT under each recipe, train_model
    torch.cuda.empty_cache()
    nu = nuscenes_training(dev, conv_k, nms_k, mode, strict_f32, flush)

    # ============================================== SECOND-MultiHead, Lyft
    # inference, the multi-class NMS (kernel 2 on BATCH x 9 sets), its
    # quant forms and training at the Lyft config's width
    torch.cuda.empty_cache()
    lyft = lyft_phases(dev, conv_k, nms_k, mode, strict_f32, flush, clock_mhz)

    # ================================================== PillarNet, nuScenes
    # the dynamic pillar VFE, the sparse 2D pillar backbone (kernel 1 at 256
    # channels), BaseBEVBackboneV1: inference, int8 and training; then the
    # dynamic 3D VFEs on centerpoint_ref's MODEL
    torch.cuda.empty_cache()
    pn = pillarnet_phases(dev, conv_k, nms_k, mode, strict_f32, flush,
                          clock_mhz)
    dynvoxel_ref(dev, conv_k, nms_k, mode, strict_f32)

    # ======== PV-RCNN, Voxel R-CNN, PartA2 and SECOND-IoU at KITTI width
    # the two-stage detectors' inference: the keypoint set abstraction,
    # PartA2's sparse UNet (inverse convs on kernel 1), the proposal layer
    # on kernel 2, the ROI grid, part-aware and BEV pooling; and their
    # training (proposal targets, point-head and ROI-head losses, kernel 2
    # on the training proposal layer's 9000 candidates a frame)
    torch.cuda.empty_cache()
    ts = {name: two_stage_phases(name, dev, conv_k, nms_k, mode, strict_f32,
                                 flush, clock_mhz)
          for name in ("pvrcnn", "voxelrcnn", "parta2", "second_iou")}

    # ======================================== KITTI and nuScenes on disk
    # trees in each dataset's format, read through the port's entry points:
    # create_infos, the test CLI (SECOND on KITTI with the official AP
    # evaluator; the flagship CenterPoint at 10 sweeps, bf16 and int8) and
    # the train CLI (gt sampling from the written databases, CBGS)
    torch.cuda.empty_cache()
    datasets = dataset_phases(dev, conv_k, nms_k, mode, strict_f32, flush,
                              clock_mhz)

    # ---------------------------------------------------------- kernels line
    kernels = [
        {"name": "sparse_gather_conv", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "launches": launches["sparse_gather_conv"],
         "max_abs_err": worst["bf16"], "ms": totals["ms"],
         "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
         "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"]
         else "operations", "library_ms": totals["library_ms"],
         "design": CONV_DESIGN,
         "eval_launches_f32_entry": per_recipe("sparse_gather_conv_f32"),
         "launches_second": kitti_launches["second"]["sparse_gather_conv"],
         "launches_train": {n: {k: v["trained"][k] for k in (
             "launches_forward", "launches_dx")} for n, v in nu.items()},
         "launches_voxelnext": vn["launches"]["sparse_gather_conv"],
         "launches_transfusion": tf["launches"]["sparse_gather_conv"],
         "launches_lyft": lyft["launches"]["sparse_gather_conv_bf16"],
         "launches_pillarnet": pn["launches"]["sparse_gather_conv_bf16"],
         "launches_two_stage": {n: v["launches"]["sparse_gather_conv_bf16"]
                                for n, v in ts.items()},
         "launches_datasets": datasets["conv"],
         "transfusion": {"ms": tf["totals"]["ms"],
                         "plain_ms": tf["totals"]["plain_ms"],
                         "bound_ms": tf["totals"]["bound_ms"],
                         "bound_by": "bytes" if tf["totals"]["bytes_ms"]
                         >= tf["totals"]["ops_ms"] else "operations",
                         "library_ms": tf["totals"]["library_ms"],
                         "max_abs_err": tf["worst"]["bf16"],
                         "times_cover": "one TransFusion bf16 forward "
                                        "(21 convs)"},
         "voxelnext": {"ms": vn["totals"]["ms"],
                       "plain_ms": vn["totals"]["plain_ms"],
                       "bound_ms": vn["totals"]["bound_ms"],
                       "library_ms": vn["totals"]["library_ms"],
                       "max_abs_err": vn["worst"]["bf16"],
                       "by_group": {g: {k: v[k] for k in (
                           "convs", "ms", "plain_ms", "bound_ms",
                           "library_ms")} for g, v in vn["groups"].items()},
                       "times_cover": "one VoxelNeXt bf16 forward (32 convs)"},
         "second": {"ms": second_totals["ms"],
                    "plain_ms": second_totals["plain_ms"],
                    "bound_ms": second_totals["bound_ms"],
                    "library_ms": second_totals["library_ms"],
                    "max_abs_err": second_worst["bf16"],
                    "times_cover": "one SECOND bf16 forward (12 convs)"},
         "checks": "passed", "times_cover": "one bf16 forward (21 convs)"},
        {"name": "sparse_gather_conv_dx", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": "q3d_sparse_gather_conv_f32",
         "use": "the input gradient of every sparse conv but conv_input, "
                "over the inverse book, weights transposed per tap",
         "launches": trained["launches_dx"],
         "forward_launches": trained["launches_forward"],
         "max_abs_err": dx_totals["max_abs_err"], "ms": dx_totals["ms"],
         "plain_ms": dx_totals["plain_ms"], "bound_ms": dx_totals["bound_ms"],
         "bound_by": dx_totals["bound_by"],
         "library_ms": dx_totals["library_ms"],
         "dw_torch_ms": dx_totals["dw_ms"],
         "inverse_book_ms": dx_totals["inverse_ms"], "checks": "passed",
         "times_cover": "one f32 ref training step's 20 input gradients; "
                        "launches: train_model's 8 steps"},
        {"name": "sparse_gather_conv_f32_second_train", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": "q3d_sparse_gather_conv_f32",
         "use": "SECOND training (kitti_models/second.yaml, batch 4): the "
                "forward of its 12 sparse convs",
         "launches": kitti_trained["second"]["launches_forward"],
         "max_abs_err": fwd_second["max_abs_err"], "ms": fwd_second["ms"],
         "plain_ms": fwd_second["plain_ms"],
         "bound_ms": fwd_second["bound_ms"],
         "bound_by": fwd_second["bound_by"],
         "library_ms": fwd_second["library_ms"], "checks": "passed",
         "times_cover": "one f32 SECOND training step's 12 conv forwards; "
                        "launches: train_kitti's 4 steps"},
        {"name": "sparse_gather_conv_dx_second", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": "q3d_sparse_gather_conv_f32",
         "use": "SECOND training (kitti_models/second.yaml, batch 4): the "
                "input gradient of every sparse conv but conv_input",
         "launches": kitti_trained["second"]["launches_dx"],
         "forward_launches": kitti_trained["second"]["launches_forward"],
         "max_abs_err": dx_second["max_abs_err"], "ms": dx_second["ms"],
         "plain_ms": dx_second["plain_ms"], "bound_ms": dx_second["bound_ms"],
         "bound_by": dx_second["bound_by"],
         "library_ms": dx_second["library_ms"],
         "dw_torch_ms": dx_second["dw_ms"],
         "inverse_book_ms": dx_second["inverse_ms"], "checks": "passed",
         "times_cover": "one f32 SECOND training step's 11 input gradients; "
                        "launches: train_kitti's 4 steps"},
        *nuscenes_kernel_rows(nu),
        *lyft_kernel_rows(lyft),
        *pillarnet_kernel_rows(pn),
        *two_stage_kernel_rows(ts),
        *datasets["rows"],
        {"name": "sparse_gather_conv_s8_requant", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": gather_conv.REQUANT_ENTRY,
         "launches": launches8["sparse_gather_conv_s8_requant"],
         "max_abs_err": 0.0, "ms": rq_totals["ms"],
         "plain_ms": rq_totals["plain_ms"], "bound_ms": rq_totals["bound_ms"],
         "bound_by": rq_totals["bound_by"],
         "library_ms": rq_totals["library_ms"],
         "unfused_ms": rq_totals["unfused_ms"],
         "eval_launches": per_recipe("sparse_gather_conv_s8_requant"),
         "checks": "passed",
         "times_cover": "one int8 forward, bench recipe (21 residency convs)"},
        {"name": "sparse_gather_conv_s8", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": "q3d_sparse_gather_conv_s8",
         "launches": deploy["dynamic"]["launches"]["sparse_gather_conv_s8"],
         "max_abs_err": 0.0, "ms": s8_totals["ms"],
         "plain_ms": s8_totals["plain_ms"], "bound_ms": s8_totals["bound_ms"],
         "bound_by": s8_totals["bound_by"],
         "library_ms": s8_totals["library_ms"],
         "launches_by_recipe": {tag: d["launches"]["sparse_gather_conv_s8"]
                                for tag, d in deploy.items()},
         "driver_launches": {tag: d["launches"]["sparse_gather_conv_s8"]
                             for tag, d in driver.items()},
         "checks": "passed",
         "times_cover": "one int8 forward, int8_deploy_recipe() "
                        f"({n_s8_convs} convs)"},
        {"name": "greedy_nms", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "q3d_tpu/ops/iou3d_nms/pallas_nms.py:45",
         "entry": "q3d_greedy_nms_boxes",
         "launches": launches["greedy_nms_boxes"], "max_abs_err": 0.0,
         "ms": boxes_form["ms"], "plain_ms": boxes_form["plain_ms"],
         "bound_ms": boxes_form["bound_ms"], "bound_by": boxes_form["bound_by"],
         "library_ms": None, "checks": "passed",
         "eval_launches": per_recipe("greedy_nms_boxes"),
         "times_cover": f"one forward's NMS from BEV corners ({s} sets, "
                        f"K={kc}); the IoU form from the padded IoU matrix "
                        f"(K={kp})",
         "launches_kitti": {n: v["greedy_nms_boxes"]
                            for n, v in kitti_launches.items()},
         "launches_voxelnext": vn["launches"]["greedy_nms_boxes"],
         "launches_transfusion": tf["launches"]["greedy_nms_boxes"],
         "launches_lyft": lyft["launches"]["greedy_nms_boxes"],
         "launches_pillarnet": pn["launches"]["greedy_nms_boxes"],
         "launches_two_stage": {n: v["launches"]["greedy_nms_boxes"]
                                for n, v in ts.items()},
         "launches_datasets": datasets["nms"],
         "voxelnext": {k: vn["nms"][k] for k in (
             "sets", "K", "ms", "plain_ms", "bound_ms", "bound_by")},
         "k4096": {n: {k: r[k] for k in ("sets", "K", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}
                   for n, r in nms_wide.items()},
         "entries": [
             {"entry": f["entry"], "launches": launches[key], "ms": f["ms"],
              "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
              "bound_by": f["bound_by"]}
             for f, key in ((boxes_form, "greedy_nms_boxes"),
                            (iou_form, "greedy_nms_iou"))]}]
    emit("script", seconds=time.perf_counter() - t_script, nvidia_smi=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

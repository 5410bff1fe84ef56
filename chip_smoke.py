#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: RepVGG-A0 chained int8,
FSPTQ reconstruction served through the conv kernel, chained int8
cifar_resnet18, BASELINE config #1's PTQ entry, chained int8 ResNet-50,
chained int8 MobileNetV2 and MobileOne-S1 (the depthwise kernel), W4
execution (MobileOne-S1 all-W4, a W4 stem, BASELINE config #4's entry),
the PTQ observers and BASELINE config #2's PTQ entry, the training path
(LSQ and RootQ QAT, fp32, QAT -> deploy at W4A4, ResNet-50 RootQ), the
accuracy protocol cut short (trained cifar_resnet20 and RepVGG-A0), the
serving engine (RepVGG-A0 and ResNet-50 through continuous batching, the
two-process lockstep), the model axis (RepVGG-A0 and ResNet-50 sharded
over two ranks of one card) and data-parallel training on NCCL, RootQ
served in int8 (BASELINE config #5's ResNet-50 through the engine,
cifar_resnet20; the window sums of a weight offset), the rest of the
RepVGG family (RepVGG-B2g4's grouped convs, RepVGG-D2se's SE blocks) and
merge_bn, GhostNet-1.0 and EfficientNet-B0 (the 5x5 depthwise window and
any channel count), the zoo's last integer routes (MobileOne-S1's train form through
the depthwise kernel's 1x1 window, RepVGG-B2g4 with RootQ's row term per
group), the data layer (CIFAR-10 pickles feeding the QAT entry, a JPEG
folder feeding RepVGG-A0), then the two int8 GEMM tools.

    python3 chip_smoke.py [--parent DIR [--turns gemm,window,stem,dw,conv]]

With --parent DIR the kernels of another tree (e.g. an archive of the
parent commit) are timed beside this tree's, those that --turns names (all
by default): gemm, window (the window sums in turns, the window-sum and
im2col kernels beside each launch), stem (the stem's part of a request in
turns), dw (the depthwise kernel in turns), conv (the 3x3 conv in turns).

Phases, each fatal on failure:
  1. build   the kernels from dlmc_quant_torch/ops/cuda/csrc (int8
             3x3 conv and its grouped build, int8 GEMM and its staged
             route's build, int8 im2col, int8
             stem conv + pool, int8 depthwise conv: the aligned 3x3 build
             and the build of the 5x5 window and the ragged path, int8
             window sum, int8 MMA probe), one nvcc
             each, all at once (prints the build
             seconds, ptxas' report of registers and spills, and the
             dynamic shared memory of every GEMM tile and of the probe's
             ring); then the card tests of the conv at ragged shapes, the
             SAME stride-2 geometry, the residual epilogue, the GEMM at the
             ResNet-18 shortcut shapes and the GEMM's epilogue modes and
             the im2col at ragged M, every epilogue tile and residual
             dtype, the stem conv + pool at ragged shapes, every band
             size, each mode (int32, codes, f32) and ResNet-50's stem at
             batch 8 and 256 (W8 and W4), the depthwise
             conv at MobileNetV2's and MobileOne-S1's shapes at batch 8 and
             256 and at ragged shapes, the 5x5 window and the ragged path
             (C % 8 != 0) at W8 and W4 with and without a weight offset's
             term and at GhostNet-1.0's and EfficientNet-B0's shapes, the
             two models' stems and the GEMM
             at 24 channels (tests/test_torch_int8_conv.py,
             tests/test_torch_resnet_conv.py,
             tests/test_torch_gemm_epilogue.py,
             tests/test_torch_gemm_staged.py,
             tests/test_torch_stem_pool.py, tests/test_torch_dwconv.py,
             tests/test_torch_mobile.py, the four weight-taking kernels at
             W4, tests/test_torch_int4_kernels.py, and the window sums and
             the weight offset's term in the conv's, GEMM's and depthwise
             conv's epilogues at W8 and W4, tests/test_torch_rootq_int.py;
             the depthwise kernel's 1x1 window on each path, its pads
             passed in, the window sums in 2 and 4 groups and the grouped
             conv's row term at RepVGG-B2g4's shapes,
             tests/test_torch_zoo_routes.py;
             the window-sum and im2col kernels at the tiles their CPU
             emulations run, tests/test_torch_{window_sum,im2col}_tiles.py;
             -m cuda), before any timing;
  2. kernel  RepVGG-A0 deploy form at 224x224, full width, seeded random
             weights, calibrated on one seeded batch (FSPTQ W8A8 with
             AdaRound decisions) and prepared for integer execution.  At
             batch 8 and at the serving batch, every one of the 22 convs
             runs through the kernel and through its plain PyTorch version
             on the same input codes; codes and f32 outputs must be equal
             (tolerance 0: both compute an exact int32 accumulator and the
             same two f32 ops).  Per conv: shape, tile plan, max |diff|,
             kernel ms (per launch of a CUDA graph of 16, median of 5
             replays: a conv takes about as long as its launch from Python),
             bound ms, kernel / bound, plain ms;
  3. serve   make_serving_fn(model, qmode="intc", graph=False) answers 6
             requests of 256 random images; the logits must be finite,
             (256, 1000), agree with the same model run on the CPU (plain
             path) on 8 images, and the kernel must have launched 22 times
             a request; then the graphed function, the card's default
             (graphed_requests, as every serving phase that goes through
             serve_requests: the request captured in a CUDA graph at its
             first call and replayed), on the same images: the launches
             recorded at the capture == one request's, the logits
             bit-equal to the eager request's, no host sync in a replay;
             the capture s and the graphed request's ms, host enqueue ms
             and images/s beside the eager ones; then the device time of
             the request's three parts (input quantize, the 22 convs, pool
             + head; CUDA graphs) and what is left of the eager request:
             host and gaps;
  recon    the flagship's main path: RepVGG-A0 in train form at full width
           (seeded weights, BN statistics from a train-mode forward of the
           first batch, then perturbed), repvgg_fuse, the
           FSPTQ W8A8 scheme attached to a copy, calibrate with one observe
           pass per batch over 256 images of the synthetic ImageNet
           fallback (seed 123, training, batch 64), FSPTQTrainer with its
           defaults but 40 iterations a block and the flagship's
           disable_first_act_quant (the stem weight-only; per target: capture and
           reconstruction ms, steps/s, held-out l2, kept or reverted; the
           teacher agreement before and after, which may not drop; the
           blocks kept with moved parameters); eval-mode logits on 8
           images within relative L2 2e-2 of the same model on the CPU;
           prepare_deploy (the stem's plan: int8 weights only), the 21
           reconstructed convs behind it kernel == plain (tolerance 0,
           batch 8), and one make_serving_fn(qmode="intc") request of 256
           images with 21 launches and one bf16 stem conv (f32 out);
  resnet   cifar_resnet18 at full width (stem 3->64, stages 64/128/256/512,
           10 classes), 32x32: train form with seeded weights and perturbed
           BN statistics -> resnet_deploy -> config #1's scheme
           (examples/configs/PTQ_resnet18_cifar10_w8a8.yaml) -> calibrate
           on one seeded batch -> prepare_deploy.  At batch 8 and 256 every
           conv and GEMM launch of one chained request (the stem in codes
           and in f32, the SAME stride-2 convs, the residual epilogues with
           int8, int32 and f32 shortcuts, the three 1x1 shortcut GEMMs) is
           recorded and held against its plain version on the same inputs
           (tolerance 0); per launch kernel us (CUDA graph of 16), bound us,
           kernel / bound.  Then make_serving_fn(qmode="intc") answers 6
           requests of 256 images: logits finite, (256, 10), within
           relative L2 2e-2 of the CPU plain path on 8 images, 18 conv and
           3 GEMM launches a request (the 512->10 head is torch._int_mm);
           median request ms, images/s, and the request's split into input
           quantize, the 21 kernels, pool + head (CUDA graphs) and the
           rest (host, gaps and the small per-request ops);
  resnet50 ResNet-50 at full width (7x7/s2 stem 3->64, max-pool,
           Bottleneck stages 64/128/256/512 x 4, 1000 classes), 224x224:
           train form with seeded weights and perturbed BN statistics ->
           resnet_deploy -> the bench's W8A8 scheme -> calibrate on one
           seeded batch of 32 -> prepare_deploy.  At batch 8 and 256 every
           launch of one chained request (the stem conv + pool with the
           first block's conv1 fold and with its downsample's, in codes
           mode, the 16 3x3 convs, the 36 1x1 GEMMs in codes, residual and
           int32 modes)
           against its plain version, tolerance 0; per launch kernel us
           (CUDA graph of 16), bound us, kernel / bound, and the sums by
           launch group; the stem's plain ms and, as context, a bf16
           F.conv2d 7x7/s2 + F.max_pool2d of the same shape; torch._int_mm
           beside every int32-mode GEMM (the four downsamples), equal and
           timed; at batch 256 each GEMM's route and tile in its label,
           its plain ms and torch._int_mm's product alone at its (M, K,
           N), and per GEMM group (16 residual, 16 codes, 4 int32) the
           kernel ms, bound, _int_mm's ms and the routes taken, with the
           phase's seconds; with --parent DIR then DIR's GEMM and this
           tree's in turns (tools/gemm_launches.py, parent, this, this,
           parent, each in a process of its own) at those 36 launches and
           at MobileNetV2's, MobileOne-S1's (W8A8, all-W4) and config
           #5's GEMM launches, sums by model and group.  Then the stem's
           other route at batch 256: its pending
           output materialized (int8_im2col rows into the GEMM), the
           im2col == plain and timed (with --parent DIR, DIR's im2col
           kernel beside it, as for the window sums in rootq_serve), the
           old stem GEMM (3211264,160) x
           (160,64) in int32 mode beside torch._int_mm.  Then the stem
           launch at batch 256 in each mode (codes with conv1's fold, f32
           with materialize's, int32), == plain, timed beside its bound and
           its plain version.  Then make_serving_fn(qmode="intc") answers
           6 requests of 256 images: logits finite, (256, 1000), within
           relative L2 2e-2 of the CPU plain path on 8 images, 16 conv +
           36 GEMM + 2 stem conv + pool launches a request and no im2col;
           median request ms, images/s and the request's split (input
           quantize, the stem's two launches, the 52 other kernels, pool +
           head; CUDA graphs) and the rest (host and gaps); with --parent
           DIR the stem's part of a request (conv + pool and the two
           consumers' codes) timed by tools/stem_bands.py --split on DIR
           and on this tree in turns: DIR's kernel and its two folds in
           torch ops against this tree's two codes launches;
  serving  the continuous-batching engine (parallel/serving.py) on
           serve_benchmark's path: RepVGG-A0 (deploy form) and ResNet-50
           (train form) under the FSPTQ W8A8 scheme of examples/
           serve_benchmark.py, calibrated on 8 seeded images, qmode 'int',
           batch 128 (A0 through the entry itself, its JSON line: images/s
           at 1 device), then
           the resnet50 phase's deploy-form ResNet-50 in 'intc' (the stem
           conv + pool kernel).  Each: the graphed engine (the card's
           default: its step captured in a CUDA graph at warmup) beside
           an eager one (graph=False): measure_throughput images/s and a
           step's forward ms of both, the graphed steps at a full and a
           padded batch bit-equal to the eager ones; on the eager engine a
           stream of 6 requests of 1..384 seeded images from a submitter
           thread under LaunchRecorder(check=True): the launches of the
           steps as expected (A0 22 convs, ResNet-50 16 convs + 37 GEMMs +
           1 im2col in 'int', 16 + 36 + 2 stem conv + pool in 'intc'),
           each == plain (tolerance 0); then on the graphed engine 32
           requests of 1..384 images submitted at once (the engine's
           images/s under a full queue), and a stream at Poisson
           arrivals at 0.6 of that rate (A0 300 requests: latency p50,
           p99 and max; ResNet-50 32: p50 and max), images/s, pad waste;
           every future's rows == the direct forward of its images
           (relative 1e-6); a graphed step's forward ms on
           device-resident images and the host-to-device copy ms of its
           128 float32 images (CUDA events);
  model_axis the model axis (parallel/sharding_rules.py) on two ranks of
           card 0 (two processes, a gloo group, the codes gathered through
           host memory): python -m dlmc_quant_torch.examples.serve_benchmark
           RepVGG_A0 64 at --num-hosts 2 (mesh (1, 2), the whole A0 W8A8 at
           224x224 in 'int', its JSON line with model_axis "2 (...)"), then
           python -m dlmc_quant_torch.tools.model_axis_2proc: each rank
           builds RepVGG-A0 (batch 64) and ResNet-50's deploy form (batch
           16) at full width from the same seeds and runs one batch
           replicated and sharded; rc 0 only where the logits and every
           layer boundary's codes are equal and every sharded conv, GEMM
           and stem + pool launch == plain (tolerance 0); printed per
           rank: request ms, the gathers' count, MB and ms, each kernel's
           sharded launches' ms beside the whole layers', with bounds;
  mobile   MobileNetV2 and MobileOne-S1 at full published width, and
           MobileNetV2 at width 0.75 (24-channel stem and first depthwise
           conv), 224x224, 1000 classes: train form with seeded weights and
           perturbed BN statistics -> its fuser (mobilenet_deploy,
           mobileone_fuse) -> the bench's W8A8 scheme -> calibrate on one
           seeded batch of 32 -> prepare_deploy.  At batch 8 and 256 every
           launch of one chained request (the 3x3 stem conv, the depthwise
           convs, the 1x1 GEMMs in codes, f32, int32 and residual modes)
           against its plain version, tolerance 0; per launch kernel us,
           bound us, kernel / bound, and for each depthwise launch its tile
           plan, its plain ms, as context a bf16 F.conv2d(groups=C) of the
           same shape, and with --parent DIR the us of DIR's depthwise
           kernel at that launch at batch 256 (tools/dw_launches.py on DIR,
           seeded operands of the same shape, in a process of its own;
           the tool on DIR, this tree, this tree and DIR in turns, every
           depthwise launch of the five models' requests, the sums by
           model and path printed with this tree's over DIR's).  Then
           make_serving_fn(qmode="intc") answers 6 requests of 256
           images: logits finite, (256, 1000), within relative L2 2e-2 of
           the CPU plain path on 8 images, MobileNetV2 1 conv + 39 GEMM +
           17 depthwise launches a request at either width (16 expand,
           17 project, the head and 5 int32 re-runs of a project GEMM that
           is also a residual block's shortcut), MobileOne-S1 1 + 21 + 21;
           median
           request ms, images/s, and the split: input quantize, the
           kernels by kind, the K-pad copies (MobileNetV2's 24-channel
           maps into the GEMM), pool + head, and the rest (host and gaps);
  w4       MobileOne-S1 at full width under bench's all-W4 scheme (every
           weight at 4 bits, the stem and head too; deployed as in the
           mobile phase): the weight bytes a served request reads, W4 at
           most 0.55 of W8's, and no int8 copy of a W4 weight; at batch 8
           and 256 every launch (1 conv, 21 GEMM, 21 depthwise) == plain,
           its us beside the same launch of the mobile phase's W8 model; 6
           served batch-256 requests (logits finite, within relative L2
           2e-2 of the CPU plain path, 1 + 21 + 21 launches each) and
           their split; W8 and W4 requests in turns, with the host's
           busiest ops; two W4 int8_stem_pool launches at ResNet-50's stem
           (batch 256), int32 and codes, == plain, beside the same weight
           at W8; then
           BASELINE config #4 through python -m
           dlmc_quant_torch.examples.FSPTQuant on a cut copy (256
           calibration images, 40 iterations a block, 64 eval images; the
           cuts printed): it must reach its chained int8 evaluation, whose
           21 GEMM + 21 depthwise launches each == plain;
  repvgg_zoo the rest of the RepVGG family at 224x224, 1000 classes,
           seeded weights, the bench's W8A8 scheme calibrated on 8
           images: RepVGG-B2g4 in train form (BN statistics from a
           train-mode forward, perturbed) -> repvgg_fuse -> prepare_deploy,
           13 of its 28 convs grouped (Cg = 40, 80, 160: the grouped
           layout of int8_conv3x3.cu), and RepVGG-D2se as bench.py's
           repvgg_d2se_int8 (deploy form, about 133 M weights, an SE block
           after each of its 48 convs, which therefore run in f32 mode; the
           SE blocks' dense layers are torch._int_mm, K = C/16 padded to a
           multiple of 8).  At batch 64 every launch of one chained request
           == plain (tolerance 0) and timed; each grouped launch beside its
           bound, its plain ms and a bf16 F.conv2d(groups=G) of the same
           shape.  Then 6 served batch-64 requests each (logits finite,
           within relative L2 2e-2 of the CPU plain path on 2 images, 28
           launches with 13 grouped, or 48, a request), images/s; then
           merge_bn on cifar_resnet20 (perturbed BN) on the card: 19 folds,
           the output within 1e-4 relative;
  ghost_effnet GhostNet-1.0 ('intc': its blocks chained, each residual sum
           closed on a float32 trunk, the ghost module's concat) and
           EfficientNet-B0 ('int': swish closes every chain) at full
           width, 224x224, 1000 classes: train form with seeded weights
           and BN statistics from a train-mode forward of the calibration
           batch, then perturbed -> ghostnet_deploy / efficientnet_deploy ->
           the bench's W8A8 scheme -> calibrate on one seeded batch of 32 ->
           prepare_deploy.  At batch 8 and 256 every launch of one request
           == plain (tolerance 0, codes and f32), each depthwise launch
           (GhostNet 41: 4 of them 5x5/s2 and 10 at C % 8 != 0 on the
           ragged path; EfficientNet 16: 9 of them 5x5) with its window, C,
           stride, plan, us, bound us (bytes), plain us and a bf16
           F.conv2d(groups=C) of the same shape as context, the sums by
           path (aligned 3x3, ragged, 5x5).  Then 6 served
           batch-256 requests each (logits finite, (256, 1000), within
           relative L2 2e-2 of the CPU plain path on 8 images, or, where a
           tie flips, every module of the 'int' forward fed the card's
           inputs within 1e-4 and the logits printed), the launches a
           request by kernel and the request's ms;
  zoo_routes the zoo's last integer routes: (a) MobileOne-S1's train form
           at full width, 224x224, batch 256 (seeded weights, BN statistics
           from a train-mode forward, then perturbed), config #4's W4A8
           FSPTQ scheme (stage0 and the head at W8), calibrated on 32
           images, in 'int': every branch apart, the depthwise blocks' 1x1
           scale branches on the depthwise kernel's 1x1 window; every
           launch of a request == plain (1 conv, 22 GEMMs, 42 depthwise:
           21 of them 1x1), each 1x1 launch timed beside its bound (bytes:
           the pixels it reads, f32 written), its plain us and a bf16
           F.conv2d(groups=C) 1x1 as context; 6 served requests (logits
           within 2e-2 of the CPU plain path on 8 images, or every module
           within 1e-4) and the request's ms beside the 21 launches' sum
           and bound; (b) RepVGG-B2g4 at batch 64 under config #5's RootQ
           W4A4 scheme with its bounds spread (spread_bounds: a row term
           on every layer), the train form in 'int' (13 grouped 3x3s, 13
           grouped 1x1s as a GEMM a group, grouped window sums) and the
           deploy form in 'intc' (13 grouped 3x3 convs with the row term
           read per group): every launch == plain, each grouped window sum
           and grouped row-term conv timed beside its bound, plain us and
           a context call (a torch.sum of each pixel's groups; a bf16
           grouped conv); every module of each form fed the card's inputs
           within 1e-4 of its CPU copy on 2 images, the logits printed; 6
           served deploy-form requests.  With --parent DIR the window-sum
           kernel at config #5's launches (groups = 1; --turns window) and
           the conv kernel at RepVGG-A0's, B2g4's, ResNet-50's,
           cifar_resnet18's and config #5's launches (--turns conv), of DIR
           and of this tree in turns (tools/window_launches.py,
           tools/conv_launches.py: DIR, this, this, DIR), the sums by model
           and group and this tree's over DIR's;
           (c) a 5x5 conv at C = 96 (2,400 bytes of K, past the im2col
           rows' 2,048) at batch 64, 28x28: two runs of 48 channels, an
           im2col and an int32 GEMM each, every launch == plain, timed;
  data     the data layer (dlmc_quant_torch/data) on the card's host: the
           probe (CPU count, g++, libjpeg's jpeglib.h, PIL), the native
           batch assembly built (data/native/augment.cpp, g++) and in use;
           full-size CIFAR-10 pickles written (50,000 + 10,000 seeded
           images), LSQ W4A4 cifar_resnet20 through the QAT entry's
           build_trainer reading them (its first batch bit for bit the
           CPU numpy path's), 4 steps on the card with finite losses; a
           JPEG tree (256 train, 768 val images, random RGB at 500x375,
           375x500, 256^2, 640x480), the loader's images/s (train and eval
           transforms, batch 256, os.cpu_count() decode threads, PIL and,
           where jpeglib.h is found and the decoder builds, libjpeg), then
           RepVGG-A0 at full width calibrated on a folder batch, prepared
           and served 'intc' at batch 256 from ImageNet(data_dir,
           training=False): logits finite, within relative L2 2e-2 of the
           CPU plain path on 8 images, 22 conv launches a request (counts
           zeroed before, read after), images/s alone (6 requests on one
           device batch, after 20 that lift the clocks) and fed by the
           loader (2 epochs of val);
  observers every observer of ops/observers.py (the 9 tensor observers,
           the 2 output observers, the percentile stream per tensor and
           per channel, the min/max stream per channel) on config #2's
           tensors: MobileNetV2 at full width (seeded, fp), the input of
           block1_0.depthwise (batch x 112 x 112 x 96, unsigned 8 bits;
           channels on the last axis), its 96x1x3x3 weight for the pixel
           observers, its own conv (forward_oi) for the output observers.
           At batch 8 the card against the same tensors on the CPU:
           minmax, percentile and the streams equal, l2loss and l2norm
           within rtol 1e-5 in the achieved SSE, the output observers'
           scales within rtol 1e-4; then each one's card ms at config #2's
           calibration batch of 64 (77.1 M values; CUDA events, one call
           after a warm-up call);
  config2  python -m dlmc_quant_torch.examples.post_training_quantization
           on config #2 (examples/configs/
           PTQ_mobilenetv2_imagenet_w8a8_percentile.yaml) with eval_int:
           true and int_qmode: intc, nothing cut (8 observe passes over
           calibration batches of 64 at 224x224, the BN refresh, 1024 eval
           images at batch 256; the train form runs intc as int): rc 0,
           finite fp32, fake-quant and integer losses, the integer loss
           within 5 % of the fake-quant one, conv, GEMM and depthwise
           launches, each held against its plain version as it runs
           (tolerance 0); wall time, the calibration's observe passes,
           calibrate passes and BN refresh apart, the metrics, the
           launches by kind;
  qat      the training path (examples/configs): (a) both QAT configs
           (LSQ and RootQ W4A4) at full width through the QAT entry's
           build_trainer (classification's build_common -> calibrate on the
           first batch -> QATTrainer), cut to one epoch over 2048 synthetic
           CIFAR-10 images at the config's batch 128 (14 steps after the
           10 % validation split), one run, nothing saved, under full_f32:
           every step's loss finite, the quantizer parameters (LSQ
           wt_scale; RootQ wt_upper, wt_alpha) moved, the first step's loss
           within 1e-2 relative of the same model and batch on the CPU, and
           after training, in eval mode on 64 validation images, every
           quantized layer fed the card's input to it within relative L2
           1e-4 of its CPU copy (the logits' relative L2 is printed: at 4
           bits a code that flips on a float difference moves every layer
           after it); then ms a step at the default precision (cuDNN TF32)
           split into device time (CUDA events over a CUDA graph of the
           step; the profiler's kernel sum beside it) and host and gaps,
           images/s, peak memory.  (b) the fp32 baseline
           config through the classification entry, the same way.  (c) the
           deploy leg: the LSQ config at its own W4A4, trained the same
           way, prepare_deploy (the weights nibble-packed), every
           one of the 18 conv launches of a request == plain at batch 8 and
           256, one make_serving_fn(qmode="intc") request of 256 training
           images under full_f32 (the float stem and head): finite
           (256, 10) logits, 18 launches, within relative L2 2e-2 of the
           same deployed model on the CPU plain path; top-1
           agreement with the fake-quant eval forward printed.  (d) BASELINE
           config #5's training leg (RootQ W4A4 ResNet-50 at full width on
           the synthetic ImageNet fallback, 224x224) at batch 64 (the
           config's 256: r50_training_leg(256), by hand): ms a step and
           peak memory;
  rootq_serve RootQ in int8 (a weight offset's row term, ROADMAP item 13):
           (a) config #5's ResNet-50 as the qat phase's (d) trains it,
           prepare_deploy (the C20 midpoint count printed); (b)
           'intc' (the train form runs it as 'int') through InferenceEngine
           at batch 128: measure_throughput images/s, a checked stream of
           6 requests of 1..384 images under LaunchRecorder(check=True),
           16 conv + 36 GEMM + 52 window-sum launches a step, each ==
           plain, every future == the direct forward, a step's forward ms;
           (c) on 4 images the card against the CPU plain path under
           full_f32: every module fed the card's inputs within relative L2
           1e-4, the logits' relative L2 printed (not gated: C14), top-1
           agreement with the card's fake-quant eval; every window-sum
           launch of a batch-128 step == plain, timed, its bound (bytes),
           its plain ms and torch.sum beside the 1x1 ones, their share of
           the forward, the sums by group (3x3 at stride 1, 1x1 at stride
           1, strided) and, with --parent DIR, DIR's window-sum kernel at
           each launch's shape (tools/window_launches.py on DIR, seeded
           codes, in a process of its own) and its group sums; each conv
           and GEMM launch timed with its term and
           without it; (d) the qat phase's RootQ W4A4 cifar_resnet20
           deployed: every launch of a request == plain at batch 8 and 256
           (18 convs, 18 window sums), one make_serving_fn request of 256
           under full_f32 and the card against the CPU at 64 images as in
           (c); (e) one RootQ depthwise launch with its offset term (W4,
           56x56x144) == plain, timed with and without the term;
  accuracy the port's accuracy protocol (python -m
           dlmc_quant_torch.tools.accuracy_protocol) cut to --epochs 2
           --qat-epochs 1 --recon-iters 40, both sections, on the hard
           synthetic CIFAR at batch 256: every table value finite (the
           cut top-1s printed), the teacher agreement not lower after
           reconstruction in any PTQ row, the card-against-CPU eval
           logits of the reconstructed A0 and the RootQ W4A4 model
           printed; every kernel launch of the protocol's run (A0's int
           and intc evaluations at batch 256 and the last batch of 208)
           against its plain version as it runs (tolerance 0); the
           trained, reconstructed A0 (32x32): its intc
           evaluation 21 conv launches a batch, its 21 convs on 8
           calibration images kernel == plain (tolerance 0), its served
           intc logits on them within relative L2 2e-2 of the CPU plain
           path;
  lockstep python -m dlmc_quant_torch.tools.lockstep_2proc: two
           processes, both engines on the card, votes over gloo; every
           future resolved, consensus exit, equal step counts;
  distributed python -m dlmc_quant_torch.examples.distributed_training at
           world size 1 on NCCL (localhost, a free port) on the LSQ W4A4
           config cut as the qat phase cuts it, under full_f32: rc 0, its
           first 3 losses within 1e-4 relative of the plain QATTrainer's
           (the QAT entry's build_trainer) on the same config;
  ptq      python -m dlmc_quant_torch.examples.post_training_quantization
           on config #1 with eval_int: true (nothing else changed): fp32,
           fake-quant and integer metrics, which must be finite, the
           integer loss within 5 % of the fake-quant one; both kernels
           must have launched; wall time;
  4. gemm    the GEMM-sweep tool's path (gemm_sweep.main: every shape at
             every compiled tile, the default tile marked *,
             each result equal to torch._int_mm's), which must launch the
             GEMM kernel; then at every sweep shape (default tile, printed
             per shape) the kernel against its plain version and
             torch._int_mm, tolerance 0 (integer results are exact).  Per
             shape: kernel ms and library ms (the tool's CUDA-graph
             medians), bound ms, plain ms (CUDA events, median of 3);
  5. probe   the same for the MMA-rate probe's path (mma_probe.main) and
             its shapes, the library call being torch._int_mm on the
             concatenated operands.
The last lines: one JSON line of kernel figures (the grouped launches,
int8_conv3x3.cu's grouped build int8_conv3x3_grouped.cu, under an entry of
their own: B2g4's 13 at batch 64, their served launches; the depthwise
launches of int8_dwconv5x5.cu under two entries, int8_dwconv5x5 for the
5x5 window and int8_dwconv_ragged for the 3x3 window's ragged path, apart
from int8_dwconv3x3's aligned ones; the zoo_routes phase's under three:
int8_dwconv1x1, the 1x1 window's launches of MobileOne-S1's train form,
int8_window_sum_grouped and int8_conv3x3_grouped_term, RepVGG-B2g4's
grouped window sums and grouped convs with the row term, each with its
served launches; int8_gemm over the sweep's shapes and ResNet-50's 36
launches at batch 256, on both builds of int8_gemm.cu, the register route
and int8_gemm_staged.cu's), the card's name and power limit,
and {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import os
import pathlib
import pickle
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from dlmc_quant_torch import (FSPTQTrainer, attach_scheme, calibrate,
                              get_dataloader, get_model, make_serving_fn,
                              prepare_deploy, scheme_from_dict)
from dlmc_quant_torch.data import native
from dlmc_quant_torch.data.loaders import (IMAGENET_MEAN, IMAGENET_STD,
                                           ImageFolderDataset,
                                           scan_image_folder)
from dlmc_quant_torch.examples import FSPTQuant as fsptq_entry
from dlmc_quant_torch.examples import classification as fp_entry
from dlmc_quant_torch.examples import distributed_training as dist_entry
from dlmc_quant_torch.examples import serve_benchmark as serve_bench
from dlmc_quant_torch.examples import post_training_quantization as ptq_entry
from dlmc_quant_torch.examples import quantization_aware_training as qat_entry
from dlmc_quant_torch.models.fuse import (efficientnet_deploy,
                                          ghostnet_deploy, merge_bn,
                                          mobilenet_deploy, repvgg_fuse,
                                          resnet_deploy)
from dlmc_quant_torch.models.mobileone import mobileone_fuse
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda import int8_conv as K
from dlmc_quant_torch.ops.cuda import int8_dwconv as DW
from dlmc_quant_torch.ops.cuda import int8_gemm as G
from dlmc_quant_torch.ops.cuda import int8_im2col as I
from dlmc_quant_torch.ops.cuda import int8_mma_probe as P
from dlmc_quant_torch.ops.cuda import int8_stem_pool as SP
from dlmc_quant_torch.ops.cuda import int8_window_sum as WS
from dlmc_quant_torch.ops import observers as OBS
from dlmc_quant_torch.ops.cuda.nibbles import W4
from dlmc_quant_torch.parallel.serving import (InferenceEngine,
                                               measure_throughput)
from dlmc_quant_torch.quant.chain import (fold_params, materialize, qmaxpool,
                                          qrelu, qrelu6)
from dlmc_quant_torch.quant.deploy import midpoint_count
from dlmc_quant_torch.quant.layers import QConv, QDense, full_f32
from dlmc_quant_torch.tools import accuracy_protocol as protocol
from dlmc_quant_torch.tools import (gemm_launches, gemm_sweep, loaderbench,
                                    mma_probe)
from dlmc_quant_torch.tools import window_launches as window_tool
from dlmc_quant_torch.training import ptq as ptq_lib
from dlmc_quant_torch.training.trainer import Trainer
from dlmc_quant_torch.utils.profiling import (PEAK_BYTES, PEAK_INT8_OPS,
                                              bound_by, card_line, event_ms,
                                              graph_ms, step_split)
from dlmc_quant_torch.utils.checkpoint import load_checkpoint
from dlmc_quant_torch.utils.launches import (KERNELS, LaunchRecorder,
                                             launch_bound, launch_route,
                                             max_diff_to_plain)
from dlmc_quant_torch.utils.config import ConfigParser, read_yaml, write_yaml
from dlmc_quant_torch.utils.logging import get_logger

SIZE, CLASSES, SEED = 224, 1000, 0
CAL_BATCH, SERVE_BATCH, REQUESTS, REPS = 32, 256, 6, 20
PLAIN_REPS = 3
RECON_SAMPLES, RECON_BATCH, RECON_SEED, RECON_ITERS = 256, 64, 123, 40
GRAPH_LAUNCHES = 16
REPO = pathlib.Path(__file__).resolve().parent
CONFIGS = REPO / "examples" / "configs"
CONFIG_1 = CONFIGS / "PTQ_resnet18_cifar10_w8a8.yaml"
CIFAR_SIZE, CIFAR_CLASSES = 32, 10
# launches of one chained request: 3x3 convs, GEMMs, im2cols, stem convs
# + pools, depthwise convs
RESNET18_LAUNCHES = {"conv": 18, "gemm": 3, "im2col": 0, "stem_pool": 0,
                     "dwconv": 0, "window_sum": 0}
# (ResNet-50: the stem and its pool stay pending on the chain; the first
# block's conv1 and downsample each run them with their own fold)
RESNET50_LAUNCHES = {"conv": 16, "gemm": 36, "im2col": 0, "stem_pool": 2,
                     "dwconv": 0, "window_sum": 0}
# the depthwise zoo: registry name and factory keywords of the train form,
# its fuser, the launches of a request, and the module whose (activated)
# output the pool reads
MOBILENET_V2_LAUNCHES = {"conv": 1, "gemm": 39, "im2col": 0, "stem_pool": 0,
                         "dwconv": 17, "window_sum": 0}
MOBILE = {
    "mobilenet_v2": ("mobilenet_v2", {}, mobilenet_deploy,
                     MOBILENET_V2_LAUNCHES, "conv_head"),
    "mobilenet_v2_w075": ("mobilenet_v2", {"width_mult": 0.75},
                          mobilenet_deploy, MOBILENET_V2_LAUNCHES,
                          "conv_head"),
    "MobileOne_S1": ("MobileOne_S1", {}, mobileone_fuse,
                     {"conv": 1, "gemm": 21, "im2col": 0, "stem_pool": 0,
                      "dwconv": 21, "window_sum": 0}, "stage4_0_pw")}
DW_TOOL = REPO / "dlmc_quant_torch" / "tools" / "dw_launches.py"
GEMM_TOOL = REPO / "dlmc_quant_torch" / "tools" / "gemm_launches.py"
WINDOW_TOOL = REPO / "dlmc_quant_torch" / "tools" / "window_launches.py"
STEM_TOOL = REPO / "dlmc_quant_torch" / "tools" / "stem_bands.py"
# the training path: configs, cuts and what must move
QAT_CONFIGS = {"lsq": "QAT_lsq_resnet20_cifar10_w4a4",
               "rootq": "RootQ_resnet20_cifar10_w4a4"}
QAT_MOVED = {"lsq": ("wt_scale",), "rootq": ("wt_upper", "wt_alpha")}
FP_CONFIG, R50_CONFIG = ("baseline_resnet20_cifar10",
                         "RootQ_resnet50_imagenet_w4a4")
QAT_IMAGES, TIMED_STEPS, EVAL_IMAGES = 2048, 20, 64
R50_BATCH, R50_STEPS = 64, 4
QAT_DEPLOY_LAUNCHES = {"conv": 18, "gemm": 0, "im2col": 0, "stem_pool": 0,
                       "dwconv": 0, "window_sum": 0}
# the rootq_serve phase: a step of config #5's ResNet-50 (train form,
# 'intc' runs as 'int'; conv1 and linear excluded: 16 3x3 convs, 36 1x1
# GEMMs, a window sum each) and a request of RootQ cifar_resnet20 (18 3x3
# convs, a window sum each); the images of the card-vs-CPU check
R50_ROOTQ_LAUNCHES = {"conv": 16, "gemm": 36, "im2col": 0, "stem_pool": 0,
                      "dwconv": 0, "window_sum": 52}
RESNET20_ROOTQ_LAUNCHES = {"conv": 18, "gemm": 0, "im2col": 0,
                           "stem_pool": 0, "dwconv": 0, "window_sum": 18}
ROOTQ_IMAGES = 4
SCHEME = {
    "quantization_type": "FSPTQ",
    "weight": {"enable": True, "type": "minmax_channel",
               "recon_type": "adaround",
               "args": {"n_bits": 8, "signed": True}},
    "input": {"enable": True, "type": "minmax_tensor",
              "args": {"n_bits": 8, "signed": False}},
}
# the bench's W8A8 scheme (bench.py:_scheme): no AdaRound
BENCH_SCHEME = {**SCHEME, "weight": {"enable": True, "type": "minmax_channel",
                                     "args": {"n_bits": 8, "signed": True}}}
# bench.py's mobileone_s1_w4a8 (_scheme(w_bits=4)): every weight at 4 bits,
# the stem and the head too
W4_SCHEME = {**SCHEME, "weight": {"enable": True, "type": "minmax_channel",
                                  "args": {"n_bits": 4, "signed": True}}}
W4_MODEL = "MobileOne_S1"
# BASELINE config #4 and its cut: calibration images and iterations a
# block as the recon phase cuts A0, 64 eval images
CONFIG_4 = CONFIGS / "FSPTQ_mobileone_s1_w4a8.yaml"
CONFIG_4_EVAL = 64
CONFIG_2 = CONFIGS / "PTQ_mobilenetv2_imagenet_w8a8_percentile.yaml"
# config #2's calibration batch, and the batch the observers are held
# against the CPU at
C2_BATCH, C2_COMPARE = 64, 8
# the accuracy protocol's cut, and A0's conv launches a batch of its
# intc evaluation (the stem weight-only)
ACCURACY_CUT = ["--epochs", "2", "--qat-epochs", "1", "--recon-iters", "40"]
ACCURACY_CONVS = 21
# the model axis: serve_benchmark's A0 batch on two ranks of one card
MODEL_AXIS_BATCH = 64
# zoo_routes' wide conv past the im2col rows' 2,048 bytes of K
CHUNKED = dict(c=96, o=96, size=28, batch=64)
# the serving engine: serve_benchmark's batch, the requests of the checked
# and the full-queue streams, the requests of A0's timed stream (enough
# for a p99) and of ResNet-50's (p50 and max only), the timed stream's
# load (a share of the images/s under a full queue); the launches of one
# 'int' step of serve_benchmark's models (A0 deploy form; ResNet-50 train
# form: its stem through im2col rows into the GEMM)
ENGINE_BATCH, ENGINE_CHECKED, ENGINE_FULL = 128, 6, 32
ENGINE_TAIL, ENGINE_SHORT = 300, 32
ENGINE_LOAD = 0.6
ENGINE_INT_LAUNCHES = {
    "RepVGG_A0": {"conv": 22, "gemm": 0, "im2col": 0, "stem_pool": 0,
                  "dwconv": 0, "window_sum": 0},
    "resnet50": {"conv": 16, "gemm": 37, "im2col": 1, "stem_pool": 0,
                 "dwconv": 0, "window_sum": 0}}
# distributed_training's losses held against the plain QATTrainer's
DIST_LOSSES = 3
# the repvgg_zoo phase: bench.py's D2se batch, the calibration images and
# the images of the CPU reference; RepVGG-B2g4's 28 convs (13 grouped) and
# RepVGG-D2se's 48 (f32 mode, an SE block after each: its two dense layers
# are torch._int_mm) a request; cifar_resnet20's images for merge_bn
ZOO_BATCH, ZOO_CAL, ZOO_REF = 64, 8, 2
B2G4_LAUNCHES = {"conv": 28, "gemm": 0, "im2col": 0, "stem_pool": 0,
                 "dwconv": 0, "window_sum": 0}
B2G4_GROUPED = 13
D2SE_LAUNCHES = dict(B2G4_LAUNCHES, conv=48)
MERGE_BN_IMAGES = 64
# the ghost_effnet phase: GhostNet-1.0 (its blocks chained, 'intc') and
# EfficientNet-B0 (swish: 'intc' runs as 'int'), 224x224, 1000 classes:
# registry name, fuser, the launches of a request and its depthwise ones
# at 5x5 and on the ragged path (C % 8 != 0)
GHOST_EFFNET = {
    "GhostNet_1.0": ("ghostnet", ghostnet_deploy,
                     {"conv": 2, "gemm": 70, "im2col": 0, "stem_pool": 0,
                      "dwconv": 41, "window_sum": 0}, 4, 10),
    "EfficientNet_B0": ("efficientnetb0", efficientnet_deploy,
                        {"conv": 1, "gemm": 32, "im2col": 0, "stem_pool": 0,
                         "dwconv": 16, "window_sum": 0}, 9, 0)}


# the zoo_routes phase: MobileOne-S1's train form in 'int' at SERVE_BATCH
# (config #4's scheme): the stem's 3x3 conv, 22 GEMMs (the stem's 1x1
# scale branch and 21 pointwise convs) and 42 depthwise launches, 21 of
# them the depthwise blocks' 1x1 scale branches; RepVGG-B2g4 under config
# #5's RootQ W4A4 at ZOO_BATCH, its launches counted from its layers
MOBILEONE_TRAIN_LAUNCHES = {"conv": 1, "gemm": 22, "im2col": 0,
                            "stem_pool": 0, "dwconv": 42, "window_sum": 0}
MOBILEONE_SCALE_BRANCHES = 21
CONV_TOOL = REPO / "dlmc_quant_torch" / "tools" / "conv_launches.py"
# --parent DIR: the kernels timed in turns with DIR's (--turns): the GEMM,
# the window sums (and the stem im2col beside), the stem + pool, the
# depthwise conv, the 3x3 conv
TURN_KINDS = ("gemm", "window", "stem", "dw", "conv")


# the data phase: QAT steps from the written CIFAR-10 pickles; the JPEG
# tree's train and val images; seconds a loader rate is measured over; the
# val epochs the loader feeds A0 for
DATA_STEPS, DATA_TRAIN_JPEGS, DATA_VAL_JPEGS = 4, 256, 768
DATA_SECONDS, DATA_FED_EPOCHS = 2.0, 2


def images(n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, SIZE, SIZE, 3), generator=g).to(device)


def card_tests():
    """The conv's, the ResNet path's and the depthwise zoo's card tests
    (ragged shapes, every compiled tile, both modes, SAME stride 2, the
    residual epilogue, the shortcut GEMMs, the GEMM's epilogue modes, the
    im2col, the stem conv + pool, the depthwise conv, the GEMM at 24
    channels, the four weight-taking kernels at W4, the window sums and a
    weight offset's term in the conv, GEMM and depthwise epilogues, the
    window-sum and im2col kernels at their emulated tiles, the grouped
    conv at every (Cg, Og) of RepVGG's g2/g4 variants and the SE blocks'
    int8 products, the depthwise kernel's 1x1 window and pads passed in,
    the grouped window sums and the grouped conv's row term, the conv, GEMM
    and stem + pool at the widths of two model-axis ranks, the GEMM's
    staged route in every mode at ResNet-50's residual and downsample
    shapes, at W4, with the row term and at every staged tile, and its
    register route at N = 24, the graphed serving function and engine
    against the eager ones), in a process of their own; fatal unless all
    pass."""
    tests = REPO / "tests"
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", str(tests / "test_torch_int8_conv.py"),
         str(tests / "test_torch_resnet_conv.py"),
         str(tests / "test_torch_gemm_epilogue.py"),
         str(tests / "test_torch_gemm_staged.py"),
         str(tests / "test_torch_stem_pool.py"),
         str(tests / "test_torch_dwconv.py"),
         str(tests / "test_torch_mobile.py"),
         str(tests / "test_torch_int4_kernels.py"),
         str(tests / "test_torch_rootq_int.py"),
         str(tests / "test_torch_window_sum_tiles.py"),
         str(tests / "test_torch_im2col_tiles.py"),
         str(tests / "test_torch_sharding.py"),
         str(tests / "test_torch_grouped_conv.py"),
         str(tests / "test_torch_zoo_routes.py"),
         str(tests / "test_torch_graphed_serving.py")],
        capture_output=True, text=True)
    tail = run.stdout.strip().splitlines()[-1:] or [run.stderr.strip()[-300:]]
    print(f"# card tests of int8_conv3x3 (grouped too), the ResNet path, "
          f"the depthwise zoo and the weight offset's term: {tail[0]}")
    if run.returncode != 0:
        print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
        raise RuntimeError("the ResNet path's card tests failed")


def conv_calls(model, x):
    """The conv launches of one chained forward of ``x`` (22, or 21 behind
    a weight-only stem, whose bf16 conv runs here), each as (name, args,
    kwargs), with the kernel's own output as the next input."""
    names = list(model.block_names)
    convs = [getattr(model, n).reparam for n in names]
    if convs[0].weight_only:
        x = qrelu(convs[0](x, qmode="intc"))
        names, convs = names[1:], convs[1:]
    codes = convs[0]._input_codes(x)
    calls = []
    for i, conv in enumerate(convs):
        de = qrelu(conv.deferred(codes))
        if i + 1 < len(convs):
            h = convs[i + 1].plan_scalars
            a, b, lo, hi = fold_params(de, h["in_inv_scale"], h["in_qbias"],
                                       -128, 127)
            kw = dict(lo=lo, hi=hi, mode="codes")
        else:
            a, b, kw = de.scale, de.bias, dict(mode="f32", relu=True)
        kw.update(stride=de.acc.stride, pad=de.acc.pad)
        args = (de.acc.x, de.acc.weight, a.contiguous(), b.contiguous())
        calls.append((names[i], args, kw))
        if i + 1 < len(convs):
            codes = K.int8_conv3x3(*args, **kw)
    return calls


def bound(args, kw):
    """(bound ms, ops ms, bytes ms) of one conv: int8 MACs over the peak
    int8 rate, bytes (inputs read once, output written once) over HBM."""
    x, w, a, _ = args
    n, h, wd, c = x.shape
    o = a.shape[0]
    ho, wo = K.out_hw(h, wd, kw["stride"])
    macs = n * ho * wo * o * 9 * c
    out_bytes = n * ho * wo * o * (1 if kw["mode"] == "codes" else 4)
    nbytes = x.numel() + 9 * c * o + 8 * o + out_bytes
    t_ops = 2 * macs / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def kernel_phase(model, batch: int, device, x=None):
    """Kernel vs plain on every conv of one forward (of ``x``, else of
    ``batch`` seeded images at 224x224); returns the totals."""
    print(f"# kernel vs plain, batch {batch}: name in-shape C->O s mode "
          "plan(BN x rows, stages, weight) | max|dcode| max|df32| | "
          "kernel_ms bound_ms(by) kernel/bound plain_ms "
          "bf16_conv_ms(context, not the same function)")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
               bytes_ms=0.0, err=0.0, context_ms=0.0)
    with torch.inference_mode():
        calls = conv_calls(model, images(batch, SEED + 1, device)
                           if x is None else x)
        for name, args, kw in calls:
            got = K.int8_conv3x3(*args, **kw)
            want = K.int8_conv3x3_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            # the f32 epilogue on the same accumulator
            x, w, _, _ = args
            conv = getattr(model, name).reparam
            f32 = dict(stride=kw["stride"], pad=kw["pad"], mode="f32",
                       relu=True)
            f32_args = (x, w, conv.epi_scale, conv.bias_eff)
            err_f = float((K.int8_conv3x3(*f32_args, **f32)
                           - K.int8_conv3x3_plain(*f32_args, **f32))
                          .abs().max())
            ms = graph_ms(lambda i: K.int8_conv3x3(*args, **kw),
                          GRAPH_LAUNCHES)
            plain_ms = event_ms(lambda: K.int8_conv3x3_plain(*args, **kw),
                                PLAIN_REPS)
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16) \
                .contiguous(memory_format=torch.channels_last)
            wb = conv.weight.to(torch.bfloat16) \
                .contiguous(memory_format=torch.channels_last)
            context_ms = event_ms(
                lambda: F.conv2d(xb, wb, stride=kw["stride"], padding=1),
                REPS)
            b_ms, t_ops, t_bytes = bound(args, kw)
            got_hw = got.shape[1] * got.shape[2]
            plan = K.tile_plan(x.shape[0] * got_hw, x.shape[-1],
                               args[2].shape[0], kw["mode"],
                               stride=kw["stride"], width=x.shape[2])
            print(f"{name:10s} {tuple(x.shape)} {x.shape[-1]}->"
                  f"{args[2].shape[0]} s{kw['stride']} {kw['mode']:5s} "
                  f"{plan.bn}x128,{plan.stages},"
                  f"{'resident' if plan.resident else 'streamed'},"
                  f"halo{plan.halo_bufs} | "
                  f"{err:g} {err_f:g} | {ms:.4f} {b_ms:.4f}"
                  f"({bound_by(t_ops, t_bytes)}) {ms / b_ms:.2f} "
                  f"{plain_ms:.4f} {context_ms:.4f}")
            if err != 0 or err_f != 0:
                raise RuntimeError(f"{name}: kernel and plain version differ "
                                   f"(codes {err}, f32 {err_f})")
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", b_ms), ("ops_ms", t_ops),
                             ("bytes_ms", t_bytes),
                             ("context_ms", context_ms)):
                tot[key] += val
            tot["err"] = max(tot["err"], err, err_f)
    print(f"# batch {batch} totals over {len(calls)} convs: kernel "
          f"{tot['ms']:.4f} ms, "
          f"bound {tot['bound_ms']:.4f} ms (ops {tot['ops_ms']:.4f}, bytes "
          f"{tot['bytes_ms']:.4f}), plain {tot['plain_ms']:.4f} ms, "
          f"bf16 conv context {tot['context_ms']:.4f} ms")
    print(f"# library_ms: none - no PyTorch call computes an int8 conv on "
          f"CUDA; a bf16 F.conv2d of the same shapes takes "
          f"{tot['context_ms']:.4f} ms (context only, not the same function)")
    return tot


def serve_phase(model, device, card: str):
    """The main path: chained int8 serving through make_serving_fn."""
    cpu_model = copy.deepcopy(model).cpu()
    serve = make_serving_fn(model, qmode="intc", device=device, graph=False)
    x = images(SERVE_BATCH, SEED + 2, device)
    K.int8_conv3x3.launches = 0
    times, enqueue, y = timed_requests(serve, x)
    launches = K.int8_conv3x3.launches
    if launches != 22 * REQUESTS:
        raise RuntimeError(f"{launches} kernel launches for {REQUESTS} "
                           f"requests, expected {22 * REQUESTS}")
    if y.shape != (SERVE_BATCH, CLASSES) or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"bad logits: {tuple(y.shape)}")
    with torch.inference_mode():
        ref = cpu_model(x[:8].cpu(), qmode="intc")
    rel = float((y[:8].cpu() - ref).norm() / (ref.norm() + 1e-9))
    print(f"# serve: logits {tuple(y.shape)} finite; vs CPU plain path on 8 "
          f"images: rel L2 {rel:.3e}; launches {launches} = 22 x {REQUESTS}")
    if rel >= 2e-2:
        raise RuntimeError(f"GPU and CPU logits differ: rel L2 {rel}")
    steady = statistics.median(times[1:])
    print(f"# serve: batch {SERVE_BATCH} request {steady * 1e3:.3f} ms "
          f"median (first {times[0] * 1e3:.1f} ms); "
          f"{SERVE_BATCH / steady:.1f} images/s on {card}; the host has "
          f"enqueued a request after {statistics.median(enqueue[1:]) * 1e3:.3f}"
          f" ms")
    graphed_requests("a0", model, x, y, dict(dict.fromkeys(KERNELS, 0),
                                             conv=22), (times, enqueue))
    split_phase(model, x, steady * 1e3)
    return launches


def split_phase(model, x, request_ms: float):
    """Device ms of the request's three parts, each as a CUDA graph (no
    host gaps inside), and what the request takes beyond their sum."""
    convs = [getattr(model, n).reparam for n in model.block_names]
    with torch.inference_mode():
        calls = conv_calls(model, x)

        def run_convs(_):
            for _, args, kw in calls:
                out = K.int8_conv3x3(*args, **kw)
            return out

        feat = run_convs(0)
        quant_ms = graph_ms(lambda i: convs[0]._input_codes(x), 4)
        convs_ms = graph_ms(run_convs, 4)
        head_ms = graph_ms(lambda i: materialize(model.linear(
            feat.mean(dim=(1, 2)), qmode="intc")), 4)
    rest = request_ms - quant_ms - convs_ms - head_ms
    print(f"# serve split (device ms, CUDA graphs): input quantize "
          f"{quant_ms:.4f}, 22 convs {convs_ms:.4f}, pool + head "
          f"{head_ms:.4f}; request {request_ms:.4f} - their sum = host and "
          f"gaps {rest:.4f} ({100 * rest / request_ms:.1f} % of the request)")


def perturbed_a0(device, x):
    """RepVGG-A0 in train form with seeded weights, BatchNorm statistics
    taken from one train-mode forward of ``x`` (so that every branch's
    output is normalized, as in a trained model) and then perturbed, and
    BN affine parameters moved off their initial values."""
    gen = torch.Generator().manual_seed(SEED)
    model = get_model("RepVGG_A0", device=device, num_classes=CLASSES,
                      generator=gen)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.momentum = 1.0
        model.train()(x, qmode="fp")
        model.eval()
        for bn in bns:
            bn.momentum = 0.1
            for t in (bn.running_mean, bn.running_var, bn.weight, bn.bias):
                t += 0.1 * torch.rand(t.shape, generator=gen).to(device)
    return model


def recon_phase(device, card: str):
    """Calibrate with observe passes → reconstruct → deploy → serve; returns
    the conv launches of the served request and the largest kernel-vs-plain
    difference."""
    t0 = time.perf_counter()
    loader = get_dataloader("ImageNet", data_dir="data/imagenet",
                            batch_size=RECON_BATCH, training=True,
                            n_samples=RECON_SAMPLES, seed=RECON_SEED)
    batches = [torch.from_numpy(x).to(device) for x, _ in loader]
    teacher = repvgg_fuse(perturbed_a0(device, batches[0]))
    student = attach_scheme(copy.deepcopy(teacher), scheme_from_dict(SCHEME))
    t1 = time.perf_counter()
    calibrate(student, batches, observe_passes=len(batches))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"# recon: A0 train form -> repvgg_fuse + {RECON_SAMPLES} synthetic "
          f"images in {t1 - t0:.2f} s; calibrate ({len(batches)} observe "
          f"passes + 1, batch {RECON_BATCH}) {1e3 * (t2 - t1):.1f} ms")
    before = {k: v.clone() for k, v in student.state_dict().items()}
    # the flagship's setting: the stem runs weight-only
    res = FSPTQTrainer(student, teacher, batches, iters=RECON_ITERS,
                       disable_first_act_quant=True).train()
    print(f"# recon: {len(res['blocks'])} targets, {RECON_ITERS} iterations "
          f"each: block capture_ms recon_ms steps/s held-out-l2 kept")
    for b in res["blocks"]:
        print(f"{b['block']:10s} {b['capture_ms']:9.2f} {b['recon_ms']:9.2f} "
              f"{RECON_ITERS / (b['recon_ms'] / 1e3):8.1f} {b['l2']:.6g} "
              f"{'kept' if b['kept'] else 'REVERTED'}")
    cap = sum(b["capture_ms"] for b in res["blocks"])
    rec = sum(b["recon_ms"] for b in res["blocks"])
    print(f"# recon: trainer {time.perf_counter() - t2:.2f} s (capture "
          f"{cap / 1e3:.2f} s, reconstruction {rec / 1e3:.2f} s, "
          f"{len(res['blocks']) * RECON_ITERS / (rec / 1e3):.1f} steps/s) on "
          f"{card}; teacher agreement {res['agreement'][0]:.4f} -> "
          f"{res['agreement'][1]:.4f}")
    state = student.state_dict()
    moved = [b["block"] for b in res["blocks"] if b["kept"] and any(
        not torch.equal(state[k], before[k]) for k in state
        if k.startswith(b["block"] + "."))]
    print(f"# recon: kept and moved: {moved}")
    agree0, agree1 = res["agreement"]
    losses = torch.tensor([b["l2"] for b in res["blocks"]])
    if not (any(b["kept"] for b in res["blocks"]) and agree1 >= agree0
            and bool(torch.isfinite(losses).all())):
        raise RuntimeError("reconstruction broke the gate's contract: "
                           f"agreement {agree0} -> {agree1}, l2 {losses}")

    x8 = batches[0][:8]
    with torch.no_grad(), full_f32():
        y = student(x8, qmode="eval")
        ref = copy.deepcopy(student).cpu()(x8.cpu(), qmode="eval")
    rel = float((y.cpu() - ref).norm() / (ref.norm() + 1e-9))
    print(f"# recon: eval-mode logits, card vs CPU on 8 images: rel L2 "
          f"{rel:.3e}")
    if not rel < 2e-2:
        raise RuntimeError(f"card and CPU eval logits differ: rel L2 {rel}")

    prepare_deploy(student)
    stem = getattr(student, student.block_names[0]).reparam
    if not stem.weight_only:
        raise RuntimeError("the stem is not weight-only after "
                           "disable_first_act_quant")
    err = kernel_phase(student, 8, device)["err"]
    serve = make_serving_fn(student, qmode="intc", device=device,
                            graph=False)
    x = images(SERVE_BATCH, SEED + 3, device)
    stem_calls = []
    hook = stem.register_forward_hook(
        lambda mod, args, out: stem_calls.append(out.dtype))
    K.int8_conv3x3.launches = 0
    y = serve(x)
    torch.cuda.synchronize()
    launches = K.int8_conv3x3.launches
    hook.remove()
    if launches != 21 or stem_calls != [torch.float32]:
        raise RuntimeError(f"{launches} conv launches and stem outputs "
                           f"{stem_calls} for one request of the "
                           "reconstructed model, expected 21 and one f32")
    if y.shape != (SERVE_BATCH, CLASSES) or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"bad logits: {tuple(y.shape)}")
    print(f"# recon: served the reconstructed model: logits "
          f"{tuple(y.shape)} finite, {launches} conv launches and one bf16 "
          "stem conv (weight-only, f32 out)")
    return launches, err


def cifar_images(n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, CIFAR_SIZE, CIFAR_SIZE, 3), generator=g).to(device)


def resnet18_deployed(device):
    """cifar_resnet18 train form (seeded weights, BN statistics and affine
    perturbed) -> resnet_deploy -> config #1's scheme -> calibrate on one
    seeded batch of 256 -> prepare_deploy."""
    gen = torch.Generator().manual_seed(SEED)
    model = get_model("cifar_resnet18", device=device,
                      num_classes=CIFAR_CLASSES, generator=gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, BatchNorm):
                for t, lo in ((bn.running_mean, -0.1), (bn.running_var, 0.7),
                              (bn.weight, 0.8), (bn.bias, -0.1)):
                    t.copy_(lo + 0.3 * torch.rand(t.shape, generator=gen))
    scheme = scheme_from_dict(read_yaml(CONFIG_1)["quantization"])
    deploy = attach_scheme(resnet_deploy(model), scheme)
    calibrate(deploy, [cifar_images(SERVE_BATCH, SEED, device)])
    return prepare_deploy(deploy)


def launch_label(kind, args, kw) -> str:
    x = args[0]
    r = kw.get("residual")
    extra = f" +r {str(r[0].dtype).split('.')[-1]}" if r is not None else ""
    if kw.get("row") is not None or kw.get("offset") is not None:
        extra += " +o_w"
    if kind == "window_sum":
        return (f"window_sum {tuple(x.shape)} {kw.get('kernel', 1)}x"
                f"{kw.get('kernel', 1)} s{kw.get('stride', 1)} pads "
                f"{kw.get('pads', ((0, 0), (0, 0)))[0]}")
    if kind == "im2col":
        return (f"im2col {tuple(x.shape)} {kw['kernel']}x{kw['kernel']} "
                f"s{kw['stride']} pads {kw['pads'][0]}")
    if kind == "dwconv":
        k, mode = DW.window(args[1]), kw.get("mode", "codes")
        p = DW.check_kernel(x, args[1], kw["stride"], mode=mode)
        ragged = f" ragged g{p.granule}" if DW.route(x, args[1], mode) \
            else ""
        return (f"dwconv {k}x{k} {tuple(x.shape)} s{kw['stride']} pad_lo "
                f"{kw.get('pad_lo', k // 2)} {kw['mode']}"
                f"{' relu' if kw.get('relu') else ''}{extra} [cb{p.cb} "
                f"{p.th}x{p.tw} {p.threads}t rpt{p.rpt} {p.tiles} tiles"
                f"{ragged}]")
    if kind == "stem_pool":
        out = (x.shape[0],) + SP.geometry(x.shape[1], x.shape[2],
                                          kw["pads"])[2:] + (args[1].shape[1],)
        return (f"stem_pool {tuple(x.shape)}->{out} pads {kw['pads'][0]} "
                f"{kw.get('mode', 'int32')}{' relu' if kw.get('relu') else ''}"
                f"{' w4' if args[1].dtype == W4 else ''}")
    if kind == "gemm":
        m, k = x.shape
        return (f"gemm ({m},{k})x({k},{args[1].shape[0]}) "
                f"{kw.get('mode', 'int32')}{extra} "
                f"[{launch_route(kind, args, kw)}]")
    groups = f" g{kw['groups']}" if kw.get("groups", 1) > 1 else ""
    return (f"conv {tuple(x.shape)}->{args[2].shape[0]}{groups} "
            f"s{kw['stride']} pad_lo {kw.get('pad_lo', 1)} {kw['mode']}"
            f"{' relu' if kw.get('relu') else ''}{extra}")


def launch_group(kind, args, kw) -> str:
    """The launch's group in the per-group sums."""
    if kind == "dwconv":
        k = DW.window(args[1])
        return f"depthwise {k}x{k} conv"
    if kind != "gemm":
        return {"conv": "3x3 conv", "im2col": "stem im2col",
                "stem_pool": "stem conv + pool",
                "window_sum": "window sums"}[kind]
    mode = kw.get("mode", "int32")
    return f"gemm {mode}" + (" + residual" if kw.get("residual") else "")


def stem_context_ms(args, kw) -> float:
    """A bf16 F.conv2d 7x7/s2 + F.max_pool2d 3x3/s2 at a stem launch's
    shape, channels last (context: not the same function, and no PyTorch
    call computes an int8 conv)."""
    x, wp = args[:2]
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    wb = SP.unpack_weight(wp, x.shape[-1]).permute(3, 2, 0, 1) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return event_ms(lambda: F.max_pool2d(
        F.conv2d(xb, wb, stride=SP.STRIDE, padding=SP.KERNEL // 2),
        **SP.POOL), REPS)


def dw_context_ms(args, kw) -> float:
    """A bf16 F.conv2d(groups=C) at a depthwise launch's window and shape,
    channels last (context: no PyTorch call computes an int8 conv)."""
    x, wp = args[:2]
    k, s = DW.window(wp), kw["stride"]
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    wb = DW.unpack_weight(wp, x.shape[-1]).permute(3, 2, 0, 1) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    pad = kw.get("pad_lo", k // 2)
    if pad != k // 2:                    # SAME at stride 2: pads (k//2 - 1,
        xb = F.pad(xb, (pad, pad + 1, pad, pad + 1))   # k//2), even maps
        pad = 0
    return event_ms(lambda: F.conv2d(xb, wb, stride=s, padding=pad,
                                     groups=x.shape[-1]), REPS)


# kinds whose launches get their plain ms and a bf16 context in the log and
# the kernels line (the other kinds have phases of their own for that)
CONTEXT = {"stem_pool": stem_context_ms, "dwconv": dw_context_ms}


def int_mm_beside(label, args, out):
    """torch._int_mm on an int32-mode GEMM launch's operands: equal to the
    kernel's output; returns its ms (CUDA graph of 16)."""
    x, wp = args[:2]
    wc = gemm_sweep.col_major(wp, x.shape[1])
    err = max_abs(torch._int_mm(x, wc), out)
    if err != 0:
        raise RuntimeError(f"{label}: torch._int_mm differs by {err}")
    return graph_ms(lambda _: torch._int_mm(x, wc), GRAPH_LAUNCHES)


def int_mm_product_ms(args):
    """torch._int_mm's product alone (int32 out) at a GEMM launch's (M, K,
    N), the yardstick of an epilogue-mode launch (tools/row_bounds.py's):
    its ms (CUDA graph of 16)."""
    x, wp = args[:2]
    wc = G.unpack_b(wp, x.shape[1]).t().contiguous().t()
    return graph_ms(lambda _: torch._int_mm(x, wc), GRAPH_LAUNCHES)


def resnet_kernel_phase(what, model, x, expect, parent=None, beside=None,
                        gemm_groups=False):
    """Every kernel launch of one chained request of ``x``, kernel vs plain
    (tolerance 0), timed per launch, torch._int_mm beside each int32-mode
    GEMM, a plain ms and a bf16 context beside each launch of a CONTEXT
    kind, the ms of another tree's depthwise kernel beside the i-th
    depthwise launch where ``parent`` ({i: ms}) has it, and ``beside``'s
    ms of launch i (the same launch of another model) <in angle
    brackets>; returns the totals, the launches' ms in order
    (``launch_ms``) and, under each CONTEXT kind, its launches' ms, plain
    ms, bound ms, ops and bytes ms (its entry in the kernels line).  With
    ``gemm_groups`` also every GEMM launch's plain ms and torch._int_mm's
    product alone at its (M, K, N) [in brackets], summed by GEMM group
    (printed with the routes taken) and over the GEMMs (``gemm``: the
    GEMMs' share of the kernels line; its library ms is _int_mm's at the
    int32 launches, whose function it computes)."""
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(x, qmode="intc")
        torch.cuda.synchronize()
        if rec.counts() != expect:
            raise RuntimeError(f"{what}: a request made {rec.counts()} "
                               f"launches, expected {expect}")
        print(f"# {what} kernel vs plain, batch {x.shape[0]}: launch "
              "[depthwise plan: slice, tile, threads, rows a thread, tiles] | "
              "max|diff| | kernel_us bound_us (by) kernel/bound "
              "[torch._int_mm_us] {plain_us bf16_context_us} "
              "(parent tree's depthwise us)"
              + (" <the same launch's us in the W8 model>" if beside
                 else ""))
        tot = dict(ms=0.0, bound_ms=0.0, err=0.0, launch_ms=[])
        groups = {}
        gemm = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                    bytes_ms=0.0, library_ms=0.0, err=0.0, launches=0)
        gemm_groups_ms = {}
        extra = {kind: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                            bytes_ms=0.0, context_ms=0.0, err=0.0)
                 for kind in CONTEXT}
        dw_index = 0
        for i, (kind, args, kw, out) in enumerate(rec.calls):
            run, plain_fn = KERNELS[kind]
            label = launch_label(kind, args, kw)
            err = max_diff_to_plain(kind, args, kw, out)
            ms = graph_ms(lambda _: run(*args, **kw), GRAPH_LAUNCHES)
            b_ms, t_ops, t_bytes = launch_bound(kind, args, kw, out)
            lib = ""
            if kind == "gemm" and kw.get("mode", "int32") == "int32":
                lib = f" [{int_mm_beside(label, args, out) * 1e3:8.2f}]"
            if kind == "gemm" and gemm_groups:
                int_mm = int_mm_product_ms(args)
                plain_ms = event_ms(lambda: plain_fn(*args, **kw),
                                    PLAIN_REPS)
                lib = f" [{int_mm * 1e3:8.2f}] {{{plain_ms * 1e3:.1f}}}"
                for key, val in (("ms", ms), ("bound_ms", b_ms),
                                 ("ops_ms", t_ops), ("bytes_ms", t_bytes),
                                 ("plain_ms", plain_ms)):
                    gemm[key] += val
                if kw.get("mode", "int32") == "int32":
                    gemm["library_ms"] += int_mm
                gemm["err"] = max(gemm["err"], err)
                gemm["launches"] += 1
                g = gemm_groups_ms.setdefault(
                    launch_group(kind, args, kw), dict(int_mm=0.0, routes={}))
                g["int_mm"] += int_mm
                way = launch_route(kind, args, kw).split()[0]
                g["routes"][way] = g["routes"].get(way, 0) + 1
            if kind in CONTEXT:
                e = extra[kind]
                plain_ms = event_ms(lambda: plain_fn(*args, **kw),
                                    PLAIN_REPS)
                context_ms = CONTEXT[kind](args, kw)
                for key, val in (("ms", ms), ("bound_ms", b_ms),
                                 ("ops_ms", t_ops), ("bytes_ms", t_bytes),
                                 ("plain_ms", plain_ms),
                                 ("context_ms", context_ms)):
                    e[key] += val
                e["err"] = max(e["err"], err)
                lib = f" {{{plain_ms * 1e3:.1f} {context_ms * 1e3:.2f}}}"
            if kind == "dwconv":
                if (parent or {}).get(dw_index) is not None:
                    lib += f" ({parent[dw_index] * 1e3:.2f})"
                dw_index += 1
            if beside:
                lib += f" <{beside[i] * 1e3:.2f}>"
            tot["launch_ms"].append(ms)
            print(f"{i:2d} {label:62s} | {err:g} | "
                  f"{ms * 1e3:8.2f} {b_ms * 1e3:8.2f} "
                  f"({bound_by(t_ops, t_bytes)}) {ms / b_ms:.2f}{lib}")
            if err != 0:
                raise RuntimeError(f"{what} launch {i} ({label}): "
                                   f"kernel and plain differ by {err}")
            tot["ms"] += ms
            tot["bound_ms"] += b_ms
            tot["err"] = max(tot["err"], err)
            g = groups.setdefault(launch_group(kind, args, kw),
                                  [0, 0.0, 0.0])
            g[0] += 1
            g[1] += ms
            g[2] += b_ms
    print(f"# {what} batch {x.shape[0]}: {len(rec.calls)} launches, kernels "
          f"{tot['ms']:.4f} ms against a bound of {tot['bound_ms']:.4f} ms; "
          "by group (launches, ms, bound ms): " + "; ".join(
              f"{name} {n}, {ms:.4f}, {b:.4f}"
              for name, (n, ms, b) in groups.items()))
    for name, g in gemm_groups_ms.items():
        n, ms, b = groups[name]
        print(f"# {what} batch {x.shape[0]} {name} ({n}): kernel {ms:.4f} "
              f"ms, bound {b:.4f} ms ({ms / b:.2f}x), torch._int_mm's "
              f"product alone at the same (M, K, N) {g['int_mm']:.4f} ms; "
              "routes " + ", ".join(f"{k} {v}" for k, v in
                                    sorted(g["routes"].items())))
    for kind, name in (("stem_pool", "stem conv + pool"),
                       ("dwconv", "depthwise 3x3 convs")):
        e = extra[kind]
        if expect.get(kind):
            print(f"# {what} batch {x.shape[0]} {name} ({expect[kind]}): "
                  f"kernel {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
                  f"({bound_by(e['ops_ms'], e['bytes_ms'])}; ops "
                  f"{e['ops_ms']:.4f}, bytes {e['bytes_ms']:.4f}), plain "
                  f"{e['plain_ms']:.4f} ms; library_ms: none - no PyTorch "
                  "call computes an int8 conv; bf16 convs of the same "
                  f"shapes take {e['context_ms']:.4f} ms (context only, not "
                  "the same function)")
    tot.update(extra)
    tot["gemm"] = gemm
    return tot


def stem_im2col_phase(model, x, parent=None):
    """The stem conv's route where no pool follows, at ResNet-50's stem
    shape: its pending output materialized in f32, which runs int8_im2col
    and int8_gemm, each against its plain version (tolerance 0); the
    im2col timed against its bound (and beside another tree's im2col at
    the same shape where ``parent``, {launch key: ms}, has it), and the
    old stem GEMM (the rows in int32 mode) beside torch._int_mm.  Returns
    the im2col launches of the route and its entry in the kernels line."""
    with torch.inference_mode():
        de = model.conv1.deferred(model.conv1._input_codes(x))
        I.int8_im2col.launches = 0
        with LaunchRecorder() as rec:
            materialize(de)
        torch.cuda.synchronize()
        launches = I.int8_im2col.launches
        want = {"conv": 0, "gemm": 1, "im2col": 1, "stem_pool": 0,
                "dwconv": 0, "window_sum": 0}
        if rec.counts() != want or launches != 1:
            raise RuntimeError(f"the stem's im2col route made "
                               f"{rec.counts()} calls, {launches} im2col "
                               f"launches, expected {want}")
        err = max(max_diff_to_plain(*call) for call in rec.calls)
        _, args, kw, rows = rec.calls[0]
        ms = graph_ms(lambda _: I.int8_im2col(*args, **kw), GRAPH_LAUNCHES)
        plain_ms = event_ms(lambda: I.int8_im2col_plain(*args, **kw),
                            PLAIN_REPS)
        b_ms, t_ops, t_bytes = launch_bound("im2col", args, kw, rows)
        wp = de.acc.weight
        acc = G.int8_gemm(rows, wp)
        label = (f"gemm ({rows.shape[0]},{rows.shape[1]})x"
                 f"({rows.shape[1]},{wp.shape[0]}) int32")
        lib_ms = int_mm_beside(label, (rows, wp), acc)
        gemm_ms = graph_ms(lambda _: G.int8_gemm(rows, wp), GRAPH_LAUNCHES)
        g_ms, g_ops, g_bytes = launch_bound("gemm", (rows, wp), {}, acc)
    theirs = parent_ms(parent, "im2col", args, kw)
    theirs = "" if theirs is None else f", parent tree {theirs:.4f} ms"
    print(f"# resnet50 stem without its pool (materialize), batch "
          f"{x.shape[0]}: im2col {tuple(args[0].shape)} -> "
          f"{tuple(rows.shape)} | {err:g} | kernel {ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({bound_by(t_ops, t_bytes)}), plain {plain_ms:.4f}"
          f" ms{theirs}; {label}: int8_gemm {gemm_ms:.4f} ms, "
          f"torch._int_mm "
          f"{lib_ms:.4f} ms, bound {g_ms:.4f} ms ({bound_by(g_ops, g_bytes)})")
    if err != 0:
        raise RuntimeError(f"the stem's im2col route differs from its plain "
                           f"version by {err}")
    return launches, dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          ops_ms=t_ops, bytes_ms=t_bytes, err=err)


def serve_requests(what, model, x, expect, classes, ref: int = 8,
                   on_flip=None):
    """make_serving_fn(qmode="intc", graph=False) on ``x``, REQUESTS times,
    then the graphed function on the same ``x`` (graphed_requests): checks
    the launches a request (``expect`` by kind; ``conv_grouped``,
    ``dwconv_5x5``, ``dwconv_ragged``, ``dwconv_1x1`` and
    ``window_sum_grouped``, where given, the grouped ones among the conv's,
    the 5x5, ragged and 1x1 ones among the depthwise conv's and the
    grouped window sums), the logits' shape and
    finiteness and the CPU plain path on ``ref`` images (relative L2 2e-2;
    past it ``on_flip(rel, images)``, where given, must hold the model
    module by module, C14, or raise); returns (median eager request ms,
    the eager requests' launches by kind)."""
    cpu_model = copy.deepcopy(model).cpu()
    serve = make_serving_fn(model, qmode="intc", device=x.device,
                            graph=False)
    counters = {kind: KERNELS[kind][0] for kind in expect if kind in KERNELS}
    for fn in counters.values():
        fn.launches = 0
    K.int8_conv3x3.grouped_launches = 0
    DW.int8_dwconv3x3.launches_5x5 = DW.int8_dwconv3x3.launches_ragged = 0
    DW.int8_dwconv3x3.launches_1x1 = WS.int8_window_sum.launches_grouped = 0
    times, enqueue, y = timed_requests(serve, x)
    launches = {kind: fn.launches for kind, fn in counters.items()}
    for key, n in (("conv_grouped", K.int8_conv3x3.grouped_launches),
                   ("dwconv_5x5", DW.int8_dwconv3x3.launches_5x5),
                   ("dwconv_ragged", DW.int8_dwconv3x3.launches_ragged),
                   ("dwconv_1x1", DW.int8_dwconv3x3.launches_1x1),
                   ("window_sum_grouped",
                    WS.int8_window_sum.launches_grouped)):
        if key in expect:
            launches[key] = n
    syncs = host_syncs(lambda: serve(x))
    if launches != {kind: n * REQUESTS for kind, n in expect.items()}:
        raise RuntimeError(f"{what}: {launches} launches for {REQUESTS} "
                           f"requests, expected {expect} a request")
    if y.shape != (x.shape[0], classes) \
            or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{what}: bad logits: {tuple(y.shape)}")
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu_model(x[:ref].cpu(), qmode="intc")
    rel = float((y[:ref].cpu() - want).norm() / (want.norm() + 1e-9))
    steady = statistics.median(times[1:])
    print(f"# {what} serve: logits {tuple(y.shape)} finite; vs CPU plain "
          f"path on {ref} images ({time.perf_counter() - t0:.1f} s): rel L2 "
          f"{rel:.3e}; launches {launches} = {expect} x {REQUESTS}")
    if not rel < 2e-2:
        if on_flip is None:
            raise RuntimeError(f"{what}: GPU and CPU logits differ: rel L2 "
                               f"{rel}")
        on_flip(rel, x[:ref])
    print(f"# {what} serve: batch {x.shape[0]} request {steady * 1e3:.3f} "
          f"ms median of {REQUESTS - 1} (first {times[0] * 1e3:.1f} ms); "
          f"{x.shape[0] / steady:.1f} images/s on {card_line()}; the host "
          f"has enqueued a request after "
          f"{statistics.median(enqueue[1:]) * 1e3:.3f} ms; host syncs in a "
          f"request: {len(syncs)}"
          + "".join(f"\n#   sync: {str(w.message)[:200]}"
                    for w in syncs[:3]))
    graphed_requests(what, model, x, y, expect, (times, enqueue))
    return steady * 1e3, launches


def timed_requests(serve, x):
    """REQUESTS calls of ``serve(x)``, each to the card's end: (request s,
    the host's enqueue s, the last logits)."""
    torch.cuda.synchronize()
    times, enqueue = [], []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        y = serve(x)
        enqueue.append(time.perf_counter() - t0)   # the host's part
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, enqueue, y


def host_syncs(run):
    """The calls in ``run()`` that make the host wait for the card, as
    PyTorch's sync debugging warns of them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # (the first use also warns that the mode is a prototype)
    return [w for w in caught if "called a synchronizing" in str(w.message)]


def graphed_requests(what, model, x, eager_y, expect, eager):
    """``x`` through make_serving_fn's graphed function (the card's
    default: a CUDA graph captured at the first call, replayed after):
    the launches recorded at the capture against ``expect`` (one request's,
    by kind), the first and the last logits bit-equal to the eager
    request's ``eager_y``, no host sync in a replay, one graph; then
    REQUESTS replays timed as the eager requests were (``eager``: their
    request and enqueue seconds).  Prints the capture's seconds and the
    graphed request's median ms, enqueue ms and images/s beside the eager
    ones; drops the graph (its memory pool freed); any mismatch raises.
    Returns the graphed median ms."""
    serve = make_serving_fn(model, qmode="intc", device=x.device)
    t0 = time.perf_counter()
    first = serve(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    key = (tuple(x.shape), x.dtype)
    recorded = dict(serve.launches[key])
    capture_s = serve.capture_s[key]
    times, enqueue, y = timed_requests(serve, x)
    syncs = host_syncs(lambda: serve(x))
    graphs = len(serve.launches)
    serve.reset()
    del serve
    got = {kind: recorded[kind] for kind in expect}
    if got != expect or graphs != 1:
        raise RuntimeError(f"{what} graphed: {graphs} graphs, the capture "
                           f"recorded {got}, expected {expect} a request")
    if not (torch.equal(first, eager_y) and torch.equal(y, eager_y)):
        diff = max(float((t.float() - eager_y.float()).abs().max())
                   for t in (first, y))
        raise RuntimeError(f"{what} graphed: logits differ from the eager "
                           f"request's by {diff}")
    if syncs:
        raise RuntimeError(f"{what} graphed: {len(syncs)} host syncs in a "
                           f"replay: {str(syncs[0].message)[:200]}")
    steady, enq = statistics.median(times), statistics.median(enqueue)
    e_steady = statistics.median(eager[0][1:])
    e_enq = statistics.median(eager[1][1:])
    n = x.shape[0]
    print(f"# {what} graphed: capture {capture_s:.3f} s (two forwards and "
          f"the capture; the first call {first_s:.3f} s); batch {n} request "
          f"{steady * 1e3:.3f} ms median of {REQUESTS} (eager "
          f"{e_steady * 1e3:.3f}), host enqueue {enq * 1e3:.3f} ms (eager "
          f"{e_enq * 1e3:.3f}), {n / steady:.1f} images/s (eager "
          f"{n / e_steady:.1f}); launches recorded at the capture "
          f"{ {k: v for k, v in recorded.items() if v} } == a request's; "
          f"logits bit-equal to the eager request's; host syncs in a "
          f"replay: 0; {card_line()}")
    return steady * 1e3


def recorded_calls(model, x, drop=()):
    """The kernel calls of one chained request of ``x``, as (kernel, args,
    keywords), without those of the kinds in ``drop``; and the last
    block's output."""
    last = {}
    hook = getattr(model, model.block_names[-1]).register_forward_hook(
        lambda mod, args, out: last.__setitem__("out", out))
    with LaunchRecorder() as rec:
        model(x, qmode="intc")
    hook.remove()
    return ([(KERNELS[kind][0], a, kw) for kind, a, kw, _ in rec.calls
             if kind not in drop], materialize(last["out"]))


def run_calls(calls):
    for run, a, kw in calls:
        run(*a, **kw)


def split_line(what, request_ms, parts):
    rest = request_ms - sum(parts.values())
    print(f"# {what} serve split (device ms, CUDA graphs): " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in parts.items())
        + f"; request {request_ms:.4f} - their sum = host, gaps and small "
        f"ops {rest:.4f} ({100 * rest / request_ms:.1f} % of the request)")


def resnet_serve_phase(model, device):
    """Chained int8 cifar_resnet18 through make_serving_fn; returns the
    launches by kind."""
    x = cifar_images(SERVE_BATCH, SEED + 2, device)
    request_ms, launches = serve_requests("resnet18", model, x,
                                          RESNET18_LAUNCHES, CIFAR_CLASSES)
    # the request's split: device parts as CUDA graphs, the rest is host,
    # gaps and the small per-request ops (grid-adapted epilogues)
    with torch.inference_mode():
        calls, feat = recorded_calls(model, x)
        quant_ms = graph_ms(lambda _: model.conv1._input_codes(x), 4)
        kernels_ms = graph_ms(lambda _: run_calls(calls), 4)
        head_ms = graph_ms(lambda _: materialize(model.linear(
            feat.mean(dim=(1, 2)), qmode="intc")), 4)
    split_line("resnet18", request_ms, {
        "input quantize": quant_ms, f"{len(calls)} kernels": kernels_ms,
        "pool + head": head_ms})
    return launches


def resnet50_deployed(device):
    """ResNet-50 train form at full width (seeded weights, BN statistics
    and affine perturbed) -> resnet_deploy -> the bench's W8A8 scheme ->
    calibrate on one seeded batch of CAL_BATCH -> prepare_deploy."""
    gen = torch.Generator().manual_seed(SEED)
    model = get_model("resnet50", device=device, num_classes=CLASSES,
                      generator=gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, BatchNorm):
                for t, lo in ((bn.running_mean, -0.1), (bn.running_var, 0.7),
                              (bn.weight, 0.8), (bn.bias, -0.1)):
                    t.copy_(lo + 0.3 * torch.rand(t.shape, generator=gen))
    deploy = attach_scheme(resnet_deploy(model),
                           scheme_from_dict(BENCH_SCHEME))
    calibrate(deploy, [images(CAL_BATCH, SEED, device)])
    return prepare_deploy(deploy)


def resnet50_serve_phase(model, device, parent=None):
    """Chained int8 ResNet-50 through make_serving_fn; returns the launches
    by kind.  ``parent``: the stem's part of a request timed on this tree
    and on another by tools/stem_bands.py --split (parent_stem_ms), put
    beside the split's stem part."""
    x = images(SERVE_BATCH, SEED + 2, device)
    request_ms, launches = serve_requests("resnet50", model, x,
                                          RESNET50_LAUNCHES, CLASSES)
    with torch.inference_mode():
        # the stem's two launches (one for each of the first block's
        # consumers) are timed as the stem's part
        calls, feat = recorded_calls(model, x, drop=("stem_pool",))
        codes = model.conv1._input_codes(x)
        first = getattr(model, model.block_names[0])

        def stem_pool(_):
            de = qmaxpool(qrelu(model.conv1.deferred(codes)), (3, 3),
                          (2, 2), ((1, 1), (1, 1)))
            return (first.conv1._input_codes(de),
                    first.downsample._input_codes(de))

        quant_ms = graph_ms(lambda _: model.conv1._input_codes(x), 4)
        stem_ms = graph_ms(stem_pool, 4)
        kernels_ms = graph_ms(lambda _: run_calls(calls), 4)
        head_ms = graph_ms(lambda _: materialize(model.linear(
            feat.mean(dim=(1, 2)), qmode="intc")), 4)
    split_line("resnet50", request_ms, {
        "input quantize": quant_ms,
        "stem + pool (2 int8_stem_pool launches in codes mode, the first "
        "block's conv1 and downsample folds in their epilogues)": stem_ms,
        f"{len(calls)} kernels": kernels_ms, "pool + head": head_ms})
    if parent:
        print("# resnet50 stem + pool + the first block's 2 codes at batch "
              f"{SERVE_BATCH}, tools/stem_bands.py --split in turns (parent "
              "tree: one int32 launch and 2 folded quantizes in torch ops; "
              "this tree: 2 codes launches): " + ", ".join(
                  f"{who} {ms:.4f} ms" for who, ms in parent)
              + f"; the split above: {stem_ms:.4f} ms; {card_line()}")
    return launches


def stem_modes_phase(model, x):
    """ResNet-50's stem launch in each mode on a request's codes (batch
    256): codes with the first block's conv1 fold (the request's launch),
    f32 with materialize's (the stem's scale and bias, ReLU), and the
    pooled int32 accumulator (a ReLU-free shortcut term's); each == plain,
    timed (CUDA graph of 16) beside its bound and its plain version.
    Returns the largest difference."""
    with torch.inference_mode():
        de = qmaxpool(qrelu(model.conv1.deferred(model.conv1._input_codes(
            x))), (3, 3), (2, 2), ((1, 1), (1, 1)))
        with LaunchRecorder() as rec:
            getattr(model, model.block_names[0]).conv1._input_codes(de)
        (_, codes_args, codes_kw, _), = rec.calls
        p = de.acc
        base = dict(pads=p.pads, pad=p.pad)
        launches = {
            "codes": (codes_args, codes_kw),
            "f32": ((p.x, p.weight, de.scale, de.bias),
                    dict(base, mode="f32", relu=True)),
            "int32": ((p.x, p.weight), dict(base, mode="int32"))}
        err = 0.0
        print(f"# resnet50 stem launch by mode, batch {x.shape[0]}: mode | "
              "max|diff| | kernel ms, bound ms (by), kernel/bound | plain "
              f"ms; {card_line()}")
        for mode, (args, kw) in launches.items():
            out = SP.int8_stem_pool(*args, **kw)
            e = max_diff_to_plain("stem_pool", args, kw, out)
            ms = graph_ms(lambda _: SP.int8_stem_pool(*args, **kw),
                          GRAPH_LAUNCHES)
            plain_ms = event_ms(lambda: SP.int8_stem_pool_plain(*args, **kw),
                                PLAIN_REPS)
            b_ms, t_ops, t_bytes = launch_bound("stem_pool", args, kw, out)
            print(f"#   {mode:5s} | {e:g} | {ms:.4f}, {b_ms:.4f} "
                  f"({bound_by(t_ops, t_bytes)}), {ms / b_ms:.2f} | "
                  f"{plain_ms:.4f}")
            if e != 0:
                raise RuntimeError(f"the stem's {mode} launch differs from "
                                   f"its plain version by {e}")
            err = max(err, e)
    return err


def mobile_deployed(name, kwargs, fuser, device, scheme=BENCH_SCHEME):
    """``name``'s train form (:func:`mobile_train_form`) -> ``fuser`` ->
    ``scheme`` (the bench's W8A8) -> calibrate on the calibration batch of
    CAL_BATCH -> prepare_deploy."""
    model, x = mobile_train_form(name, kwargs, device)
    deploy = attach_scheme(fuser(model), scheme_from_dict(scheme))
    calibrate(deploy, [x])
    return prepare_deploy(deploy)


def mobile_train_form(name, kwargs, device):
    """``name`` in train form with the factory's ``kwargs`` (seeded
    weights; BN statistics from one train-mode forward of the calibration
    batch, so that every branch's output is normalized as in a trained
    model, then perturbed with the BN affine), and that batch of
    CAL_BATCH."""
    gen = torch.Generator().manual_seed(SEED)
    model = get_model(name, device=device, num_classes=CLASSES,
                      generator=gen, **kwargs)
    x = images(CAL_BATCH, SEED, device)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def batch_stats(bn, args):
        # flax's statistics of this batch; the forward then keeps them
        t = args[0]
        mean = t.mean(dim=(0, 1, 2))
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(torch.clamp_min(
            (t * t).mean(dim=(0, 1, 2)) - mean * mean, 0.0))

    hooks = [bn.register_forward_pre_hook(batch_stats) for bn in bns]
    with torch.no_grad():
        model.train()(x, qmode="fp")
        model.eval()
        for h in hooks:
            h.remove()
        for bn in bns:
            for t in (bn.running_mean, bn.running_var, bn.weight, bn.bias):
                t += 0.1 * torch.rand(t.shape, generator=gen).to(device)
    return model, x


def served_weight_bytes(model) -> int:
    """Bytes of the weight buffers a served request reads: each conv's
    kernel layout (``w_packed``, ``w_gemm`` or ``w_dw``; ``w_stem`` where
    the stem kernel takes the conv) and each dense or weight-only layer's
    ``w_int4``, ``w_mm`` or ``w_int``."""
    total = 0
    for m in model.modules():
        if not isinstance(m, (QConv, QDense)) or m.plan_scalars is None:
            continue
        if isinstance(m, QDense) or m.weight_only:
            names = ("w_int4", "w_mm", "w_int")
        elif getattr(m, "w_stem", None) is not None:
            names = ("w_stem",)
        else:
            names = ("w_packed", "w_gemm", "w_dw")
        t = next(getattr(m, n) for n in names
                 if getattr(m, n, None) is not None)
        total += t.numel() * t.element_size()
    return total


def mobile_serve_phase(name, model, device, pooled, expect=None):
    """Chained int8 MobileNetV2 or MobileOne-S1 through make_serving_fn;
    returns the launches by kind (``expect``, by default ``MOBILE``'s).
    ``pooled`` names the module whose output, activated and materialized,
    the global pool reads."""
    expect = expect or MOBILE[name][3]
    x = images(SERVE_BATCH, SEED + 2, device)
    request_ms, launches = serve_requests(name, model, x, expect, CLASSES)
    # the 1x1 convs whose K the GEMM takes padded (pad_k copies their codes)
    narrow = {id(m.w_gemm): m.weight.shape[1] for m in model.modules()
              if isinstance(m, QConv) and m.kernel_size == 1
              and m.weight.shape[1] % 16}
    with torch.inference_mode():
        # one recorded request: the launches by kind, the pooled module's
        # output
        seen = {}
        hook = model.get_submodule(pooled).register_forward_hook(
            lambda mod, args, out: seen.__setitem__("out", out))
        with LaunchRecorder() as rec:
            model(x, qmode="intc")
        hook.remove()
        by_kind, copies = {}, []
        for kind, a, kw, _ in rec.calls:
            by_kind.setdefault(kind, []).append((KERNELS[kind][0], a, kw))
            if kind == "gemm" and id(a[1]) in narrow:
                copies.append(torch.zeros((a[0].shape[0], narrow[id(a[1])]),
                                          dtype=torch.int8, device=device))
        out = seen["out"]
        feat = materialize(qrelu6(out) if pooled == "conv_head" else out)
        stem = model.conv_stem if hasattr(model, "conv_stem") \
            else model.stage0.reparam
        parts = {"input quantize": graph_ms(
            lambda _: stem._input_codes(x), 4)}
        for kind, calls in by_kind.items():
            parts[f"{len(calls)} {kind}"] = graph_ms(
                lambda _, c=calls: run_calls(c), 4)
        if copies:
            parts[f"{len(copies)} K-pad copies"] = graph_ms(
                lambda _: [G.pad_k(c) for c in copies], 4)
        parts["pool + head"] = graph_ms(lambda _: materialize(model.linear(
            feat.mean(dim=(1, 2)), qmode="intc")), 4)
    split_line(name, request_ms, parts)
    # what the host enqueues: the kernels of one eager request by the
    # profiler
    serve = make_serving_fn(model, qmode="intc", device=device, graph=False)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        serve(x)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    ours = sum(n for k, n in kernels.items() if "int8_" in k)
    print(f"# {name} serve: one request runs {sum(kernels.values())} "
          f"kernels on the card, {ours} of them the port's "
          f"({sum(expect.values())} launches) and the rest torch's small "
          "ops (the folded boundaries' affines, the input quantize, the "
          "K-pad copies, the head)")
    return launches


def parent_dw_turns(root: str):
    """The depthwise kernel of the tree at ``root`` and of this one, in
    turns (parent, this, this, parent), each timed by tools/dw_launches.py
    in a process of its own at every depthwise launch of the five models'
    requests at batch SERVE_BATCH; prints the sums by model and path (the
    aligned 3x3 build, the ragged path, the 5x5 window) and this tree's
    over the parent's.  Returns the first parent run's ms by (model,
    batch, launch index)."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for who, tree in (("parent", root), ("this", str(REPO)),
                          ("this", str(REPO)), ("parent", root)):
            out = pathlib.Path(tmp) / "rows.json"
            run = subprocess.run(
                [sys.executable, str(DW_TOOL), "--root", tree, "--json",
                 str(out), str(SERVE_BATCH)], capture_output=True, text=True)
            if run.returncode != 0:
                print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
                raise RuntimeError(f"timing the depthwise kernel of {tree} "
                                   "failed")
            runs.append((who, json.loads(out.read_text())))
    sums = {}
    for turn, (who, rows) in enumerate(runs):
        for r in rows:
            if r["ms"] is None:         # a launch that tree refuses
                continue
            key = (r["model"], r["group"])
            sums.setdefault(key, [[0.0] * 4, 0.0, 0])
            sums[key][0][turn] += r["ms"]
            if turn == 1:
                sums[key][1] += r["bound_ms"]
                sums[key][2] += 1
    print(f"# depthwise kernel of the parent tree {root} and this one at "
          f"batch {SERVE_BATCH}, in turns (tools/dw_launches.py, seeded "
          "codes, each run a process of its own): model path launches | "
          "parent this this parent ms | bound ms | this / parent")
    for (model, grp), (ms, bound, n) in sorted(sums.items()):
        ratio = (ms[1] + ms[2]) / (ms[0] + ms[3]) if ms[0] else float("nan")
        print(f"  {model:18s} {grp:7s} {n:2d} | "
              + " ".join(f"{t:.4f}" for t in ms)
              + f" | {bound:.4f} | {ratio:.4f}")
    return {(r["model"], r["batch"], r["index"]): r["ms"]
            for r in runs[0][1]}


def parent_gemm_turns(root: str):
    """The int8 GEMM of the tree at ``root`` and of this one, in turns
    (parent, this, this, parent), each timed by tools/gemm_launches.py in
    a process of its own at ResNet-50's 36 GEMM launches at batch
    SERVE_BATCH and at the GEMM launches of MobileNetV2's, MobileOne-S1's
    (W8A8, all-W4) and config #5's requests (SERVE_BATCH, ENGINE_BATCH),
    on seeded operands, each launch checked against its plain version;
    prints the sums by model and group and this tree's over the
    parent's."""
    specs = (gemm_launches.resnet50_specs(SERVE_BATCH)
             + gemm_launches.model_specs(SERVE_BATCH, ENGINE_BATCH))
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = pathlib.Path(tmp) / "specs.json"
        spec_path.write_text(json.dumps(specs))
        for who, tree in (("parent", root), ("this", str(REPO)),
                          ("this", str(REPO)), ("parent", root)):
            out = pathlib.Path(tmp) / "rows.json"
            run = subprocess.run(
                [sys.executable, str(GEMM_TOOL), "--root", tree, "--specs",
                 str(spec_path), "--json", str(out)], capture_output=True,
                text=True)
            if run.returncode != 0:
                print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
                raise RuntimeError(f"timing the GEMM of {tree} failed")
            runs.append((who, json.loads(out.read_text())))
    sums = {}
    for turn, (who, rows) in enumerate(runs):
        for r in rows:
            key = (r["model"], r["group"])
            sums.setdefault(key, [[0.0] * 4, 0.0, 0])
            sums[key][0][turn] += r["ms"]
            if turn == 1:
                sums[key][1] += r["bound_ms"]
                sums[key][2] += 1
    print(f"# int8_gemm of the parent tree {root} and this one, in turns "
          "(tools/gemm_launches.py, seeded operands, each launch == plain, "
          "each run a process of its own): model group launches | parent "
          "this this parent ms | bound ms | this / parent")
    for (model, grp), (ms, bound, n) in sums.items():
        print(f"  {model:16s} {grp:8s} {n:2d} | "
              + " ".join(f"{t:.4f}" for t in ms)
              + f" | {bound:.4f} | {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}")


def parent_window_ms(root: str):
    """The window-sum and im2col kernels of the tree at ``root`` timed at
    config #5's window-sum launches and ResNet-50's stem im2col
    (tools/window_launches.py in a process of its own, on that tree's
    package): {launch key: ms}."""
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "rows.json"
        run = subprocess.run(
            [sys.executable, str(WINDOW_TOOL), "--root", root, "--json",
             str(out), "--batch", str(ENGINE_BATCH), "--stem-batch",
             str(SERVE_BATCH)], capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"timing the window-sum and im2col kernels of "
                               f"{root} failed")
        rows = json.loads(out.read_text())
    print(f"# parent tree {root}: its window-sum and im2col kernels timed at "
          f"{len(rows)} launches (tools/window_launches.py)")
    return {r["key"]: r["ms"] for r in rows}


def parent_stem_ms(root: str):
    """The stem's part of a ResNet-50 request at batch SERVE_BATCH (its
    conv + pool and the first block's two consumers' codes), timed by
    tools/stem_bands.py --split on the tree at ``root`` and on this one, in
    turns (parent, this, this, parent), each in a process of its own:
    [(tree, ms)]."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for who, tree in (("parent", root), ("this", str(REPO)),
                          ("this", str(REPO)), ("parent", root)):
            path = pathlib.Path(tmp) / "rows.json"
            run = subprocess.run(
                [sys.executable, str(STEM_TOOL), "--root", tree, "--split",
                 "--json", str(path), str(SERVE_BATCH)], capture_output=True,
                text=True)
            if run.returncode != 0:
                print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
                raise RuntimeError(f"timing the stem of {tree} failed")
            out.append((who, json.loads(path.read_text())[0]["ms"]))
    return out


def parent_ms(parent, kind, args, kw):
    """The ms that ``parent`` ({launch key: ms}) has for a window-sum or
    im2col launch, or None."""
    return (parent or {}).get(window_tool.key(
        kind, args[0].shape, kw.get("kernel", 1), kw.get("stride", 1),
        kw.get("pads", ((0, 0), (0, 0)))))


def mobile_phase(device, parent=None):
    """MobileNetV2 (widths 1.0 and 0.75) and MobileOne-S1: deploy, every
    launch == plain at batch 8 and 256, 6 served requests each.  Returns
    the largest difference, the depthwise launches' totals at batch 256
    over the three models (their entry in the kernels line), the served
    launches by kind and, for the W4 phase, MobileOne-S1's per-launch ms by
    batch and its served weight bytes.  ``parent``: another tree's
    depthwise ms by (model, batch, launch), printed beside each depthwise
    launch."""
    err, served, w8 = 0.0, {}, {}
    dw = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
              err=0.0)
    for label, (name, kwargs, fuser, expect, pooled) in MOBILE.items():
        t0 = time.perf_counter()
        model = mobile_deployed(name, kwargs, fuser, device)
        print(f"# {label}: train form -> {fuser.__name__} -> bench W8A8 "
              f"scheme -> calibrate (batch {CAL_BATCH}) + prepare_deploy in "
              f"{time.perf_counter() - t0:.2f} s")
        for batch in (8, SERVE_BATCH):
            theirs = {i: ms for (m, b, i), ms in (parent or {}).items()
                      if m == label and b == batch}
            got = resnet_kernel_phase(label, model,
                                      images(batch, SEED + 1, device), expect,
                                      theirs)
            err = max(err, got["err"])
            dw["err"] = max(dw["err"], got["dwconv"]["err"])
            if label == W4_MODEL:
                w8[batch] = got["launch_ms"]
            if batch == SERVE_BATCH:
                for key in ("ms", "plain_ms", "bound_ms", "ops_ms",
                            "bytes_ms"):
                    dw[key] += got["dwconv"][key]
        launches = mobile_serve_phase(label, model, device, pooled)
        for kind, n in launches.items():
            served[kind] = served.get(kind, 0) + n
        if label == W4_MODEL:
            w8["weight_bytes"] = served_weight_bytes(model)
            w8["model"] = model         # the W4 phase serves it in turns
        del model
    return err, dw, served, w8


def requests_in_turns(models, x, rounds: int = 4):
    """Requests of each model of ``models`` ({name: model}) in turns, in
    one process: the median request ms and host enqueue ms of each, and
    the host's busiest ops of one request by the profiler's self CPU
    time."""
    serves = {name: make_serving_fn(m, qmode="intc", device=x.device,
                                    graph=False)
              for name, m in models.items()}
    times = {name: ([], []) for name in serves}
    for fn in serves.values():
        fn(x)
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, fn in serves.items():
            t0 = time.perf_counter()
            fn(x)
            enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            times[name][0].append((time.perf_counter() - t0) * 1e3)
            times[name][1].append(enqueue * 1e3)
    for name, fn in serves.items():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn(x)
            torch.cuda.synchronize()
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        req, enq = (statistics.median(t) for t in times[name])
        print(f"# {name} in turns ({rounds} rounds): request {req:.3f} ms, "
              f"host enqueue {enq:.3f} ms; the host's busiest ops of a "
              "request (self CPU ms, calls): " + "; ".join(
                  f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} "
                  f"x{e.count}" for e in top[:6]))


def w4_stem_launch(device):
    """Two W4 int8_stem_pool launches at ResNet-50's stem (batch 256, 224²,
    3 -> 64, flax's SAME pads), int32 and codes (a seeded fold), each ==
    plain and timed beside the same weight at W8; returns (launches, the
    largest difference)."""
    g = torch.Generator().manual_seed(SEED + 5)
    x = torch.randint(-128, 128, (SERVE_BATCH, SIZE, SIZE, 3), generator=g,
                      dtype=torch.int8).to(device)
    wk = torch.randint(-8, 8, (7, 7, 3, 64), generator=g,
                       dtype=torch.int8).to(device)
    w4, w8 = SP.pack_weight_int4(wk), SP.pack_weight(wk)
    pads = QConv(3, 64, 7, 2, "SAME").spatial_pads(SIZE, SIZE)
    a = (2e-4 + 6e-4 * torch.rand(64, generator=g)).to(device)
    b = (20.0 * torch.randn(64, generator=g)).to(device)
    err = launches = 0
    for mode, ab, epi in (("int32", (), {}),
                          ("codes", (a, b), dict(lo=-128, hi=127))):
        kw = dict(pads=pads, pad=-17, mode=mode, **epi)
        before = SP.int8_stem_pool.launches
        out = SP.int8_stem_pool(x, w4, *ab, **kw)
        torch.cuda.synchronize()
        launches += SP.int8_stem_pool.launches - before
        e = max_abs(out, SP.int8_stem_pool_plain(x, w4, *ab, **kw))
        ms = graph_ms(lambda _: SP.int8_stem_pool(x, w4, *ab, **kw),
                      GRAPH_LAUNCHES)
        ms8 = graph_ms(lambda _: SP.int8_stem_pool(x, w8, *ab, **kw),
                       GRAPH_LAUNCHES)
        plain_ms = event_ms(lambda: SP.int8_stem_pool_plain(x, w4, *ab, **kw),
                            PLAIN_REPS)
        b_ms, t_ops, t_bytes = launch_bound("stem_pool", (x, w4) + ab, kw,
                                            out)
        print(f"# w4 stem: int8_stem_pool {tuple(x.shape)} -> "
              f"{tuple(out.shape)} {mode} with (16, 64, 8) nibble-packed "
              f"weights | {e} | {ms * 1e3:.2f} us ({ms8 * 1e3:.2f} us with "
              f"the int8 weights), bound {b_ms * 1e3:.2f} us "
              f"({bound_by(t_ops, t_bytes)}), plain {plain_ms:.4f} ms")
        err = max(err, e)
    if err != 0 or launches != 2:
        raise RuntimeError(f"the W4 stem launches differ from their plain "
                           f"versions by {err} ({launches} launches)")
    return launches, err


def w4_phase(device, w8):
    """MobileOne-S1 at full width under bench's all-W4 scheme: every launch
    == plain at batch 8 and 256, each beside the W8 model's same launch
    (``w8``: mobile_phase's per-launch ms, weight bytes and model); 6
    served requests and their split, then W8 and W4 requests in turns;
    the weight bytes a request reads, W4 against W8; then one W4 stem
    launch.  Returns the largest difference and the
    launches by kind of the served requests and the stem."""
    t0 = time.perf_counter()
    name, kwargs, fuser, expect, pooled = MOBILE[W4_MODEL]
    model = mobile_deployed(name, kwargs, fuser, device, W4_SCHEME)
    print(f"# {W4_MODEL} w4: train form -> {fuser.__name__} -> bench's "
          f"all-W4 scheme -> calibrate (batch {CAL_BATCH}) + prepare_deploy "
          f"in {time.perf_counter() - t0:.2f} s")
    nbytes = served_weight_bytes(model)
    ratio = nbytes / w8["weight_bytes"]
    print(f"# {W4_MODEL} weight bytes a served request reads: W4 {nbytes} "
          f"against W8 {w8['weight_bytes']} ({ratio:.4f})")
    if not ratio <= 0.55:
        raise RuntimeError(f"W4 weights take {ratio:.4f} of the W8 bytes")
    for m in model.modules():
        if isinstance(m, (QConv, QDense)) and hasattr(m, "w_int"):
            raise RuntimeError(f"{m.path}: a W4 layer keeps an int8 weight")
    err = 0.0
    for batch in (8, SERVE_BATCH):
        got = resnet_kernel_phase(f"{W4_MODEL} w4", model,
                                  images(batch, SEED + 1, device), expect,
                                  beside=w8[batch])
        err = max(err, got["err"])
        print(f"# {W4_MODEL} batch {batch}: the {len(got['launch_ms'])} "
              f"launches take {sum(got['launch_ms']):.4f} ms at W4 against "
              f"{sum(w8[batch]):.4f} ms at W8")
    served = mobile_serve_phase(f"{W4_MODEL} w4", model, device, pooled,
                                expect)
    requests_in_turns({f"{W4_MODEL} w8": w8.pop("model"),
                       f"{W4_MODEL} w4": model},
                      images(SERVE_BATCH, SEED + 2, device))
    del model
    stem_launches, stem_err = w4_stem_launch(device)
    served["stem_pool"] = served.get("stem_pool", 0) + stem_launches
    return max(err, stem_err), served


def config4_phase(device):
    """BASELINE config #4 through ``python -m
    dlmc_quant_torch.examples.FSPTQuant`` on a cut copy (calibration images
    and iterations a block as the recon phase cuts A0, CONFIG_4_EVAL eval
    images): it must reach the chained int8 evaluation, and each launch of
    that evaluation must equal its plain version.  Returns the launches by
    kind and the largest difference."""
    cfg = read_yaml(CONFIG_4)
    run_dir = REPO / "saved" / "chip_smoke_c4"
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg["save_dir"] = str(run_dir)
    cfg["dataloaders"]["calibration"]["args"].update(
        n_samples=RECON_SAMPLES, batch_size=RECON_BATCH)
    cfg["dataloaders"]["eval"]["args"].update(n_samples=CONFIG_4_EVAL,
                                              batch_size=CONFIG_4_EVAL)
    cfg["reconstruction"]["epochs"] = RECON_ITERS
    path = run_dir / "FSPTQ_mobileone_s1_w4a8_cut.yaml"
    write_yaml(cfg, path)
    print(f"# config #4 entry: FSPTQ_mobileone_s1_w4a8 cut: calibration "
          f"{RECON_SAMPLES} images (batch {RECON_BATCH}) instead of 1024, "
          f"{RECON_ITERS} iterations a block instead of 2000, eval "
          f"{CONFIG_4_EVAL} images instead of the synthetic fallback's 1024;"
          " nothing else changed (224x224, 1000 classes, stage0 and linear "
          "at 8 bits, the 42 other layers at 4)")
    t0 = time.perf_counter()
    with LaunchRecorder() as rec:
        rc = fsptq_entry.main(["-c", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = rec.counts()
    want = {"conv": 0, "gemm": 21, "im2col": 0, "stem_pool": 0, "dwconv": 21, "window_sum": 0}
    err = max((max_diff_to_plain(*call) for call in rec.calls), default=0.0)
    print(f"# config #4 entry: rc {rc}, {wall:.2f} s; its chained int8 "
          f"evaluation made {counts} launches (the stem weight-only: "
          f"disable_first_act_quant), each against its plain version: max "
          f"|diff| {err:g}")
    if rc != 0 or counts != want or err != 0:
        raise RuntimeError(f"config #4's entry did not reach a chained int8 "
                           f"evaluation equal to plain: rc {rc}, {counts}, "
                           f"{err}")
    return counts, err


def c2_activation(model, batch: int, device) -> torch.Tensor:
    """The input of config #2's largest observed layer, block1_0.depthwise
    (batch x 112 x 112 x 96 after ReLU6), from a seeded fp forward."""
    seen = []
    hook = model.block1_0.depthwise.register_forward_pre_hook(
        lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            model(images(batch, SEED + 5, device), qmode="fp")
    finally:
        hook.remove()
    return seen[0]


def observer_calls(model, x):
    """(name, call) of every observer on config #2's tensors: the tensor
    and channel observers (channels on the NHWC last axis) on the
    activation ``x`` with config #2's input grid (unsigned 8 bits), the
    pixel observers on the depthwise weight (signed 8 bits), the output
    observers driving the depthwise conv on ``x``, and the streams (x's
    two halves folded: the 99.99 percentile of |x| per tensor and per
    channel, min/max per channel)."""
    layer = model.block1_0.depthwise
    w = layer.weight.detach().to(x.device)
    act, wt = dict(n_bits=8, signed=False), dict(n_bits=8, signed=True)
    calls = []
    for name, fn in OBS.TENSOR_OBSERVERS.items():
        if "pixel" in name:
            calls.append((name, lambda fn=fn: fn(w, **wt)))
        else:
            kw = dict(act, ch_axis=3) if "channel" in name else act
            calls.append((name, lambda fn=fn, kw=kw: fn(x, **kw)))
    for name, fn in OBS.OUTPUT_OBSERVERS.items():
        calls.append((name, lambda fn=fn: fn(x, w, layer.forward_oi, **wt)))
    half = x.shape[0] // 2
    for name, ch_axis, pct in (("stream percentile", None, 99.99),
                               ("stream percentile channel", 3, 99.99),
                               ("stream minmax channel", 3, None)):
        def stream(ch_axis=ch_axis, pct=pct):
            st = OBS.streaming_init(() if ch_axis is None else (x.shape[3],),
                                    device=x.device)
            for part in (x[:half], x[half:]):
                st = OBS.streaming_update(st, part, ch_axis, pct)
            return OBS.streaming_finalize(
                st, "percentile" if pct else "minmax", **act)
        calls.append((name, stream))
    return calls


def observer_sse(name, x, w, scale, offset) -> float:
    """The reconstruction SSE of ``(scale, offset)`` in float64 on the
    CPU: on the activation (or, for a pixel observer, the weight)."""
    t = (w if "pixel" in name else x).double().cpu()
    s, o = scale.double().cpu(), offset.double().cpu()
    if "channel" in name:
        s, o = s.reshape(-1), o.reshape(-1)          # NHWC last axis
    lo, hi = (-127, 127) if "pixel" in name else (0, 255)
    q = torch.clamp(torch.round((t - o) / s), lo, hi)
    return float(((q * s + o - t) ** 2).sum())


def observers_phase(device):
    """Every observer of the port on config #2's tensors, on the card and on
    the same tensors on the CPU at batch C2_COMPARE: minmax, percentile and
    the streams equal; l2loss and l2norm within rtol 1e-5 in the achieved
    SSE; the output observers' scales within rtol 1e-4.  Then each one's
    card ms at config #2's calibration batch (C2_BATCH: the 77.1 M-value
    activation), CUDA events around one call after one warm-up call."""
    model = get_model("mobilenet_v2", device=device, num_classes=CLASSES,
                      generator=torch.Generator().manual_seed(SEED)).eval()
    x = c2_activation(model, C2_COMPARE, device)
    w = model.block1_0.depthwise.weight.detach()
    print(f"# observers: config #2's MobileNetV2 (seeded, fp), the input of "
          f"block1_0.depthwise {tuple(x.shape)} (unsigned 8 bits), its "
          f"weight {tuple(w.shape)} for the pixel observers (signed 8 bits)"
          "; name | card vs CPU | card ms at batch "
          f"{C2_BATCH}")
    card = dict(observer_calls(model, x))
    cpu_model = copy.deepcopy(model).cpu()
    host = dict(observer_calls(cpu_model, x.cpu()))
    worst = {}
    with full_f32():
        for name in card:
            got = [t.cpu() for t in card[name]()]
            want = host[name]()
            if name.startswith(("minmax", "percentile", "stream")):
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                ok = err == 0
                what = f"max |diff| {err:g}"
            elif "output" in name:
                err = float(((got[0] - want[0]).abs()
                             / want[0].abs()).max())
                ok = err <= 1e-4 and torch.equal(got[1], want[1])
                what = f"scale rel {err:.3g}"
            else:
                a = observer_sse(name, x, w, *got)
                b = observer_sse(name, x, w, *want)
                err = abs(a - b) / b
                ok = err <= 1e-5
                what = f"SSE {a:.6g} vs {b:.6g} (rel {err:.3g})"
            worst[name] = (what, ok)
        del card, host, cpu_model
        x = c2_activation(model, C2_BATCH, device)
        times = {name: event_ms(call, 1)
                 for name, call in observer_calls(model, x)}
    for name, (what, ok) in worst.items():
        print(f"{name} | {what}{'' if ok else ' FAILED'} | "
              f"{times[name]:.4f}")
    bad = [name for name, (_, ok) in worst.items() if not ok]
    if bad:
        raise RuntimeError(f"observers off the CPU's: {bad}")
    return times


@contextlib.contextmanager
def calibration_split(times: dict):
    """Time the PTQ entry's calibration on the card: its ``'observe'`` and
    ``'calibrate'`` forwards (hooks on the model inside ``ptq.calibrate``)
    and ``ptq.bn_recalibrate``, each bracketed by synchronizes."""
    saved = ptq_lib.calibrate, ptq_lib.bn_recalibrate

    def calibrate_timed(model, batches, observe_passes=0):
        start = []

        def pre(m, args, kw):
            torch.cuda.synchronize()
            start.append(time.perf_counter())

        def post(m, args, kw, out):
            torch.cuda.synchronize()
            times[kw["qmode"]] += time.perf_counter() - start.pop()

        hooks = (model.register_forward_pre_hook(pre, with_kwargs=True),
                 model.register_forward_hook(post, with_kwargs=True))
        try:
            return saved[0](model, batches, observe_passes=observe_passes)
        finally:
            for h in hooks:
                h.remove()

    def bn_timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved[1](*args, **kw)
        torch.cuda.synchronize()
        times["bn refresh"] += time.perf_counter() - t0
        return out

    ptq_lib.calibrate, ptq_lib.bn_recalibrate = calibrate_timed, bn_timed
    try:
        yield
    finally:
        ptq_lib.calibrate, ptq_lib.bn_recalibrate = saved


def config2_phase():
    """BASELINE config #2 through the PTQ entry, uncut, with eval_int: true
    and int_qmode: intc: rc 0, finite losses, the integer loss within 5 %
    of the fake-quant one, conv, GEMM and depthwise launches, each launch
    equal to its plain version (held as it runs).  Returns the launches by
    kind and the largest difference."""
    cfg = read_yaml(CONFIG_2)
    cfg.update(eval_int=True, int_qmode="intc")
    run_dir = REPO / "saved" / "chip_smoke_c2"
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg["save_dir"] = str(run_dir)
    path = run_dir / "PTQ_mobilenetv2_imagenet_w8a8_percentile_eval_int.yaml"
    write_yaml(cfg, path)
    cal = cfg["dataloaders"]["calibration"]["args"]
    print(f"# config #2: with eval_int: true, int_qmode: intc, nothing cut "
          f"(mobilenet_v2, 1000 classes, 224x224; {cfg['observe_passes']} "
          f"observe passes over calibration batches of {cal['batch_size']}; "
          f"eval the synthetic fallback's 1024 at batch "
          f"{cfg['dataloaders']['eval']['args']['batch_size']}; the train "
          "form runs intc as int)")
    wrappers = {"conv": K.int8_conv3x3, "gemm": G.int8_gemm,
                "dwconv": DW.int8_dwconv3x3}
    for fn in wrappers.values():
        fn.launches = 0
    times = dict.fromkeys(("observe", "calibrate", "bn refresh"), 0.0)
    t0 = time.perf_counter()
    with calibration_split(times), LaunchRecorder(check=True) as rec:
        rc = ptq_entry.main(["-c", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kind: fn.launches for kind, fn in wrappers.items()}
    counts = rec.counts()
    err = max((diff for _, diff in rec.calls), default=0.0)
    (ckpt,) = sorted((run_dir / "models").glob("*/*/quantized_model"))[-1:]
    _, meta = load_checkpoint(ckpt)
    fp, quant, real = meta["fp32"], meta["quant"], meta["int"]
    print(f"# config #2: rc {rc}, wall {wall:.2f} s; calibration "
          f"{sum(times.values()):.2f} s: observe passes "
          f"{times['observe']:.2f} s, calibrate passes "
          f"{times['calibrate']:.2f} s, BN refresh {times['bn refresh']:.2f}"
          f" s; fp32 {fp}; fake quant {quant}; int {real}; launches "
          f"{launches} (recorded {counts}), each against its plain version: "
          f"max |diff| {err:g}")
    losses = torch.tensor([fp["loss"], quant["loss"], real["loss"]])
    if not (rc == 0 and bool(torch.isfinite(losses).all())
            and all(launches.values()) and launches == {
                kind: counts[kind] for kind in launches} and err == 0
            and abs(real["loss"] - quant["loss"]) < 0.05 * quant["loss"]):
        raise RuntimeError("config #2's PTQ entry is off")
    return launches, err


def training_config(name: str, **loader_args) -> ConfigParser:
    """``examples/configs/<name>.yaml`` cut for the smoke run: one epoch,
    one run, the training loader's ``loader_args``, nothing saved."""
    cfg = read_yaml(CONFIGS / f"{name}.yaml")
    cfg["train_loader"]["args"].update(loader_args)
    cfg["n_runs"] = 1
    cfg["trainer"]["epochs"] = 1
    return ConfigParser(cfg, "cuda", save_to_disk=False)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).norm() / (want.norm() + 1e-12))


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def eval_modules(model, x, qmode: str):
    """Forward of ``x`` in ``qmode`` on the card and on a CPU copy: (logits
    relative L2, {module: the worst relative L2 of its CPU copy run on the
    card's inputs to it, with the outputs of its own submodules replaced by
    the card's}).  That holds every op once on its own, free of the codes
    that flip upstream: the layers and BatchNorms as wholes, and the code
    between submodules (ReLUs, option-A shortcuts, residual sums, pooling)
    on its output and on each submodule's input."""
    cpu = copy.deepcopy(model).cpu()      # before the hooks: not copied
    caps = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, kwargs, out, name=name: caps.__setitem__(
            name, (_to_cpu(args), _to_cpu(kwargs), _to_cpu(out))),
        with_kwargs=True) for name, m in model.named_modules()]
    with torch.no_grad():
        y = model(x, qmode=qmode)
        for h in hooks:
            h.remove()
        ref = cpu(x.cpu(), qmode=qmode)
        worst = {}
        for name, (args, kwargs, out) in caps.items():
            mod, fed = cpu.get_submodule(name), {}
            subs = [c.register_forward_hook(
                lambda c_, a, o, sub=sub: (fed.__setitem__(sub, a[0]),
                                           caps[sub][2])[1])
                for child, c in mod.named_children()
                for sub in [f"{name}.{child}" if name else child]
                if sub in caps]
            errs = [rel_l2(mod(*args, **kwargs), out)] + [
                rel_l2(inp, caps[sub][0][0]) for sub, inp in fed.items()]
            for h in subs:
                h.remove()
            worst[name or "(model)"] = max(errs)
    return rel_l2(y, ref), worst


def train_gated(what: str, trainer, moved=(), chain_gate: bool = True):
    """One epoch of ``trainer.train()`` under full_f32, then the gates:
    every step's loss finite, the parameters named ``moved`` changed, the
    first step's loss within 1e-2 of the same model and batch on the CPU,
    in eval mode every module and the code between them, fed the card's
    inputs, within relative L2 1e-4 of its CPU copy (``eval_modules``),
    and, with ``chain_gate``, the eval logits within relative L2 2e-2 of the
    CPU's.  Without it the logits' reading is printed only: RootQ at 4 bits
    read 4.97e-2 with every layer within 4.4e-6, a code that flips on a
    float difference moving the layers after it.  Returns the first batch
    (on the card)."""
    model = trainer.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.rpartition(".")[2] in moved}
    rec = {"losses": []}

    def recorded_step(x, y):
        if "x" not in rec:      # the model and batch of the first step
            rec.update(x=x, y=y, model=copy.deepcopy(model).cpu())
        loss, logits = type(trainer).train_step(trainer, x, y)
        rec["losses"].append(loss)
        return loss, logits

    trainer.train_step = recorded_step
    t0 = time.perf_counter()
    with full_f32():
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del trainer.train_step
        losses = torch.stack(rec["losses"]).cpu()
        twin = rec["model"].train()
        cpu_loss = float(trainer.loss_fn(
            twin(rec["x"].cpu(), qmode=trainer.train_qmode), rec["y"].cpu()))
        x_eval = torch.from_numpy(next(iter(trainer.valid_loader))[0][
            :EVAL_IMAGES]).to(rec["x"].device)
        rel_eval, layers = eval_modules(model.eval(), x_eval,
                                        trainer.eval_qmode)
    rel_loss = abs(float(losses[0]) - cpu_loss) / abs(cpu_loss)
    worst = max(layers.items(), key=lambda kv: kv[1], default=("-", 0.0))
    shifts = {n: float(((p.detach() - before[n]).abs().max()
                        / (before[n].abs().max() + 1e-12)))
              for n, p in model.named_parameters() if n in before}
    print(f"# {what}: {len(losses)} steps of batch {len(rec['y'])} in "
          f"{wall:.2f} s (full_f32; train loader, host batches); losses "
          f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}, epoch "
          f"{ {k: round(v, 4) for k, v in result.items()} }; first loss card "
          f"vs CPU rel {rel_loss:.2e}; eval on {len(x_eval)} images, card "
          f"vs CPU: logits rel L2 {rel_eval:.2e}"
          f"{' (gated at 2e-2)' if chain_gate else ' (printed only)'}, "
          f"{len(layers)} modules each fed the card's inputs: worst rel L2 "
          f"{worst[1]:.2e} ({worst[0]})"
          + (f"; {len(shifts)} quantizer parameters moved, relative shift "
             f"{min(shifts.values()):.2e}..{max(shifts.values()):.2e}"
             if moved else ""))
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"{what}: a loss is not finite: {losses}")
    if moved and not (len(shifts) and min(shifts.values()) > 0):
        raise RuntimeError(f"{what}: quantizer parameters did not move: "
                           f"{shifts}")
    if not rel_loss < 1e-2:
        raise RuntimeError(f"{what}: first loss card vs CPU rel {rel_loss}")
    if not worst[1] < 1e-4:
        raise RuntimeError(f"{what}: eval module {worst[0]} card vs CPU rel "
                           f"{worst[1]}")
    if chain_gate and not rel_eval < 2e-2:
        raise RuntimeError(f"{what}: eval logits card vs CPU rel {rel_eval}")
    return rec["x"], rec["y"]


def time_steps(what: str, trainer, x, y, steps: int = TIMED_STEPS,
               graph_steps: int = 4):
    """ms a step at the default precision (cuDNN TF32), split into device
    time and host and gaps; returns the split."""
    torch.cuda.reset_peak_memory_stats()
    split = step_split(lambda: trainer.train_step(x, y), steps, graph_steps)
    peak = torch.cuda.max_memory_allocated()
    n = x.shape[0]
    print(f"# {what} step, batch {n}, default precision: "
          f"{split['wall_ms']:.3f} ms ({n / split['wall_ms'] * 1e3:.1f} "
          f"images/s); device {split['device_ms']:.3f} ms (CUDA events over "
          f"a CUDA graph of {graph_steps} steps), {split['kernels']:.0f} "
          f"kernels a step taking {split['busy_ms']:.3f} ms (profiler); host "
          f"and gaps "
          f"{split['host_gap_ms']:.3f} ms "
          f"({100 * split['host_gap_ms'] / split['wall_ms']:.1f} % of the "
          f"step); peak memory {peak / 2 ** 30:.2f} GiB; {card_line()}")
    return split


def qat_deploy_leg(device):
    """LSQ QAT at the config's own W4A4 → prepare_deploy → chained int8
    through the conv kernel, W4 weights nibble-packed; returns the served
    request's conv launches and the largest kernel-vs-plain difference."""
    config = training_config(QAT_CONFIGS["lsq"], n_samples=QAT_IMAGES)
    trainer = qat_entry.build_trainer(config, device, get_logger("qat"))
    train_gated("qat lsq w4a4 (deploy leg)", trainer, QAT_MOVED["lsq"])
    model = prepare_deploy(trainer.model.eval())
    batches = [torch.from_numpy(b) for b, _ in trainer.train_loader]
    x256 = torch.cat(batches[:2]).to(device)
    err = max(resnet_kernel_phase("qat lsq w4a4", model, xb,
                                  QAT_DEPLOY_LAUNCHES)["err"]
              for xb in (x256[:8], x256))
    serve = make_serving_fn(model, qmode="intc", device=device, graph=False)
    # the float stem conv and head in strict f32, as on the CPU (cuDNN's
    # TF32 default moves them by ~1e-3, and the codes after them with it)
    K.int8_conv3x3.launches = 0
    with full_f32():
        y = serve(x256)
        torch.cuda.synchronize()
    launches = K.int8_conv3x3.launches
    y_tf32 = serve(x256)
    with torch.inference_mode():
        ref = copy.deepcopy(model).cpu()(x256.cpu(), qmode="intc")
        fake = model(x256, qmode="eval")
    rel = rel_l2(y, ref)
    agree = float((y.argmax(-1) == fake.argmax(-1)).float().mean())
    print(f"# qat lsq w4a4 serve: logits {tuple(y.shape)}, {launches} conv "
          f"launches; vs the CPU plain path on {len(ref)} images rel L2 "
          f"{rel:.3e} (full_f32; {rel_l2(y_tf32, ref):.3e} with the float "
          f"stem and head at the default TF32); top-1 agreement with the "
          f"fake-quant eval forward {agree:.4f}")
    if launches != QAT_DEPLOY_LAUNCHES["conv"] \
            or y.shape != (SERVE_BATCH, CIFAR_CLASSES) \
            or not bool(torch.isfinite(y).all()) or not rel < 2e-2:
        raise RuntimeError("the QAT model's int8 request is off")
    return launches, err


def r50_training_leg(batch: int = R50_BATCH, steps: int = R50_STEPS):
    """BASELINE config #5's training leg: RootQ W4A4 ResNet-50 through the
    QAT entry's build_trainer on the synthetic ImageNet fallback, one
    checked step and ``steps`` timed ones at ``batch``; returns the
    trainer (the rootq_serve phase serves its model).  By hand for the
    config's batch 256: ``python3 -c 'import chip_smoke as s;
    s.r50_training_leg(256, 2)'``."""
    device = torch.device("cuda")
    n = -(-(steps + 2) * batch * 100 // 96)     # after the 4 % split
    config = training_config(R50_CONFIG, batch_size=batch, n_samples=n)
    t0 = time.perf_counter()
    trainer = qat_entry.build_trainer(config, device, get_logger("qat"))
    x, y = (torch.from_numpy(a).to(device) for a in
            next(iter(trainer.train_loader)))
    print(f"# r50 rootq w4a4: build_trainer (synthetic ImageNet, {n} images "
          f"at 224x224) + calibrate in {time.perf_counter() - t0:.2f} s")
    loss, _ = trainer.train_step(x, y.long())
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"r50 rootq w4a4: loss {float(loss)}")
    time_steps("r50 rootq w4a4", trainer, x, y.long(), steps, graph_steps=1)
    return trainer


def qat_phase(device):
    """(a) both QAT configs, (b) the fp32 baseline, (c) the deploy leg, (d)
    ResNet-50 RootQ training; returns the deploy leg's (launches, err) and
    the two RootQ trainers, cifar_resnet20's and ResNet-50's (the
    rootq_serve phase deploys them)."""
    trained = {}
    for family, name in QAT_CONFIGS.items():
        trainer = qat_entry.build_trainer(
            training_config(name, n_samples=QAT_IMAGES), device,
            get_logger("qat"))
        # RootQ's chain is chaotic across devices (see train_gated)
        x, y = train_gated(f"qat {family} w4a4", trainer, QAT_MOVED[family],
                           chain_gate=family != "rootq")
        time_steps(f"qat {family} w4a4", trainer, x, y)
        trained[family] = trainer
    trainer = fp_entry.build_trainer(
        training_config(FP_CONFIG, n_samples=QAT_IMAGES), device,
        get_logger("fp"))
    x, y = train_gated("fp32 baseline", trainer)
    time_steps("fp32 baseline", trainer, x, y)
    launches, err = qat_deploy_leg(device)
    return launches, err, trained["rootq"], r50_training_leg()


def card_vs_cpu(what, model, x, qmode):
    """``model(x)`` in ``qmode`` on the card and on its CPU copy (the plain
    path) under full_f32: the logits' relative L2, printed and not gated
    (C14: at 4 bits a code that a float difference flips at a tie, in the
    float stem's conv or a BatchNorm's rsqrt, moves every layer after it),
    and, gated at 1e-4, every module fed the card's inputs to it
    (``eval_modules``); returns the card's logits."""
    with full_f32():
        rel, layers = eval_modules(model, x, qmode)
    worst = max(layers.items(), key=lambda kv: kv[1])
    with torch.inference_mode(), full_f32():
        y = model(x, qmode=qmode)
    print(f"# {what} {qmode} card vs CPU plain path on {len(x)} images "
          f"(full_f32): logits rel L2 {rel:.3e} (printed only: C14); "
          f"{len(layers)} modules each fed the card's inputs: worst rel L2 "
          f"{worst[1]:.2e} ({worst[0]})")
    if not worst[1] < 1e-4 or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{what}: module {worst[0]} card vs CPU rel "
                           f"{worst[1]}, or the logits are not finite")
    return y


def checked_engine(what, model, qmode, image, expect, device, card):
    """``model`` through InferenceEngine at ENGINE_BATCH: the graphed
    engine's (the card's default) measure_throughput images/s and a step's
    forward ms on device-resident images, its step bit-equal to the eager
    engine's (graphed_engine); then engine_leg's checked stream on the
    eager engine (ENGINE_CHECKED requests of 1..3 batches under
    LaunchRecorder(check=True): the launches a step as ``expect`` says,
    each == plain; every future's rows == the direct forward); returns
    (the stream's launches by kind, images/s, forward ms)."""
    eng = InferenceEngine(model, batch_size=ENGINE_BATCH, qmode=qmode,
                          device=device, graph=False)
    graphed, ips, fwd_ms = graphed_engine(what, model, qmode, image, eng,
                                          device)
    graphed.graphed.reset()
    b = ENGINE_BATCH
    pool = np.random.default_rng(SEED + 5).random(
        (3 * b + 64,) + tuple(image), np.float32)
    sizes = np.random.default_rng(SEED + 6).integers(
        1, 3 * b + 1, ENGINE_CHECKED).tolist()
    eng.start()
    try:
        reqs, steps, n_checked = checked_stream(what, eng, pool, sizes,
                                                expect)
    finally:
        eng.stop()
    torch.cuda.synchronize()
    launches = engine_counts()
    if launches != {kind: n * steps for kind, n in expect.items()}:
        raise RuntimeError(f"{what} engine: the wrappers counted {launches} "
                           f"launches in {steps} steps")
    worst = check_futures(what, eng, pool, reqs)
    print(f"# {what} engine (qmode {qmode!r}, batch {b}): graphed "
          f"measure_throughput {ips:.1f} images/s; eager checked stream of "
          f"{len(reqs)} requests ({sum(sizes)} images, {steps} steps, "
          f"{n_checked} launches == plain); every future == the direct "
          f"forward (worst relative {worst:.1e}); a graphed step's forward "
          f"{fwd_ms:.3f} ms on device-resident images; launches {launches};"
          f" {card}")
    return launches, ips, fwd_ms


def graphed_engine(what, model, qmode, image, eager, device):
    """The graphed InferenceEngine (the card's default) at ENGINE_BATCH:
    measure_throughput (its warmup captures the step's graph) and a step's
    forward ms (CUDA events, device-resident images copied into the
    graph's input); its steps at a full and a padded batch bit-equal to
    the ``eager`` engine's; one graph.  Prints the eager engine's
    measure_throughput and forward beside them.  Returns (the graphed
    engine, its images/s, its forward ms); the caller drops its graph
    (``engine.graphed.reset()``)."""
    eng = InferenceEngine(model, batch_size=ENGINE_BATCH, qmode=qmode,
                          device=device)
    ips = measure_throughput(eng, image, n_batches=20)
    e_ips = measure_throughput(eager, image, n_batches=20)
    xd = torch.from_numpy(np.random.default_rng(SEED + 9).random(
        (ENGINE_BATCH,) + tuple(image), np.float32)).to(device)
    fwd_ms = event_ms(lambda: eng.forward(xd), 5)
    e_fwd_ms = event_ms(lambda: eager.forward(xd), 5)
    for n in (ENGINE_BATCH, 5):
        if not torch.equal(eng.forward(xd[:n]), eager.forward(xd[:n])):
            raise RuntimeError(f"{what} engine: the graphed step of {n} "
                               "rows differs from the eager one")
    capture_s = eng.graphed.capture_s
    graphs = len(capture_s)
    capture_s = next(iter(capture_s.values()))
    if graphs != 1:
        raise RuntimeError(f"{what} engine: {graphs} graphs captured")
    print(f"# {what} engine (qmode {qmode!r}, batch {ENGINE_BATCH}): graphed"
          f" measure_throughput {ips:.1f} images/s (eager {e_ips:.1f}), a "
          f"step's forward {fwd_ms:.3f} ms (eager {e_fwd_ms:.3f}) on "
          f"device-resident images, capture {capture_s:.3f} s; graphed "
          f"steps bit-equal to the eager engine's; {card_line()}")
    return eng, ips, fwd_ms


def offset_beside(calls):
    """Each conv, GEMM and depthwise launch of ``calls`` that carries a
    weight offset's term, timed with it and again without it at the same
    shape (CUDA graphs of GRAPH_LAUNCHES); returns {kind: [launches, ms
    with, ms without]}."""
    out = {}
    for kind, args, kw, _ in calls:
        key = "row" if kind in ("conv", "gemm") else "offset"
        if kind not in ("conv", "gemm", "dwconv") or kw.get(key) is None:
            continue
        run = KERNELS[kind][0]
        bare = {k: v for k, v in kw.items() if k != key}
        e = out.setdefault(kind, [0, 0.0, 0.0])
        e[0] += 1
        e[1] += graph_ms(lambda _: run(*args, **kw), GRAPH_LAUNCHES)
        e[2] += graph_ms(lambda _: run(*args, **bare), GRAPH_LAUNCHES)
    return out


def window_sum_launches(calls, total_ms, parent=None):
    """Every window-sum launch of ``calls``: kernel == plain (tolerance 0),
    kernel ms (CUDA graph), bound ms (bytes: x read once, S written once,
    over HBM's rate), plain ms, and beside a 1x1 window the library call
    that computes it, torch.sum(x - zero, -1, dtype=int32), and another
    tree's kernel at the same shape where ``parent`` ({launch key: ms})
    has it; their sums, by group (3x3 at stride 1, 1x1 at stride 1,
    strided), and their share of ``total_ms``.  Returns the kernels-line
    entry."""
    e = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
             library_ms=0.0, err=0.0)
    shapes, groups = {}, {}
    for kind, args, kw, out in calls:
        if kind != "window_sum":
            continue
        err = max_diff_to_plain(kind, args, kw, out)
        ms = graph_ms(lambda _: WS.int8_window_sum(*args, **kw),
                      GRAPH_LAUNCHES)
        b_ms, t_ops, t_bytes = launch_bound(kind, args, kw, out)
        key = launch_label(kind, args, kw)
        if key not in shapes:
            plain_ms = event_ms(lambda: WS.int8_window_sum_plain(
                *args, **kw), PLAIN_REPS)
            lib = None
            if kw.get("kernel", 1) == 1 and kw.get("stride", 1) == 1:
                x, zero = args[0], kw["zero"]
                want = torch.sum(x, -1, dtype=torch.int32) \
                    - zero * x.shape[-1]
                if not torch.equal(want, out):
                    raise RuntimeError(f"{key}: torch.sum differs")
                lib = graph_ms(lambda _: torch.sum(x, -1, dtype=torch.int32),
                               GRAPH_LAUNCHES)
            shapes[key] = [0, plain_ms, lib]
        shapes[key][0] += 1
        for k, v in (("ms", ms), ("bound_ms", b_ms), ("ops_ms", t_ops),
                     ("bytes_ms", t_bytes), ("plain_ms", shapes[key][1]),
                     ("library_ms", shapes[key][2] or 0.0)):
            e[k] += v
        e["err"] = max(e["err"], err)
        theirs = parent_ms(parent, kind, args, kw)
        g = groups.setdefault(window_tool.group(kw.get("kernel", 1),
                                                kw.get("stride", 1)),
                              [0, 0.0, 0.0, 0.0])
        g[0] += 1
        g[1] += ms
        g[2] += b_ms
        g[3] += theirs or 0.0
        print(f"{key:52s} | {err:g} | {ms * 1e3:8.2f} {b_ms * 1e3:8.2f} "
              f"{ms / b_ms:.2f} {{plain {shapes[key][1] * 1e3:.1f}}}"
              + (f" [torch.sum {shapes[key][2] * 1e3:.2f}]"
                 if shapes[key][2] is not None else "")
              + (f" (parent tree {theirs * 1e3:.2f})" if theirs else ""))
        if err != 0:
            raise RuntimeError(f"{key}: kernel and plain differ by {err}")
    n = sum(v[0] for v in shapes.values())
    print(f"# window sums: {n} launches at {len(shapes)} shapes, kernel "
          f"{e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms (bytes), plain "
          f"{e['plain_ms']:.4f} ms, torch.sum beside the 1x1 ones "
          f"{e['library_ms']:.4f} ms (no library call sums a window); "
          f"{100 * e['ms'] / total_ms:.1f} % of the {total_ms:.3f} ms "
          f"forward; by group (launches, ms, bound ms"
          + (", parent tree ms" if parent else "") + "): " + "; ".join(
              f"{name} {c}, {ms:.4f}, {b:.4f}"
              + (f", {theirs:.4f}" if parent else "")
              for name, (c, ms, b, theirs) in groups.items()))
    return e


def rootq_dw_launch(device):
    """One RootQ depthwise launch with its offset term at MobileNetV2's
    56x56x144 stride-1 layer, batch 8, W4: kernel == plain, timed beside
    the same launch without the term; returns (max diff, ms with, ms
    without)."""
    g = torch.Generator().manual_seed(SEED + 11)
    x = torch.randint(-8, 8, (8, 56, 56, 144), generator=g,
                      dtype=torch.int8).to(device)
    wp = DW.pack_weight_int4(torch.randint(-7, 8, (3, 3, 1, 144),
                                           generator=g, dtype=torch.int8))
    a, b, oc = ((torch.rand(144, generator=g) * 1e-2).to(device),
                torch.randn(144, generator=g).to(device),
                (torch.randn(144, generator=g) * 1e-2).to(device))
    kw = dict(stride=1, pad=-8, lo=-8, hi=7, mode="codes")
    wp = wp.to(device)
    got = DW.int8_dwconv3x3(x, wp, a, b, offset=oc, **kw)
    err = max_abs(got, DW.int8_dwconv3x3_plain(x, wp, a, b, offset=oc, **kw))
    ms = graph_ms(lambda _: DW.int8_dwconv3x3(x, wp, a, b, offset=oc, **kw),
                  GRAPH_LAUNCHES)
    bare = graph_ms(lambda _: DW.int8_dwconv3x3(x, wp, a, b, **kw),
                    GRAPH_LAUNCHES)
    print(f"# rootq depthwise launch (8,56,56,144) s1 W4 codes +o_w: max "
          f"|diff| to plain {err}; {ms * 1e3:.2f} us with the offset term, "
          f"{bare * 1e3:.2f} us without")
    if err != 0:
        raise RuntimeError(f"the depthwise offset term differs from plain "
                           f"by {err}")
    return err, ms, bare


def spread_bounds(model, seed: int):
    """Move every RootQ weight's bounds apart, running and learned alike,
    from ``seed``: ``u`` up by 5-35 %, ``l`` toward 0 by 10-40 %.  A cut
    QAT run leaves ``u = −l`` (its few steps sit inside the configs'
    warmup of 400 and 2,500 steps, and the running bounds take 0.1 % of
    each step), so ``o_w = (u + l)/2`` is 0 on the symmetric grid; a
    trained checkpoint's is not, and the served path is the one with the
    row term."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "wt_run_upper"):
                up, down = (1.05 + 0.3 * torch.rand((2,), generator=g)
                            ).tolist()
                for t in (m.wt_run_upper, m.wt_upper):
                    t.mul_(up)
                for t in (m.wt_run_lower, m.wt_lower):
                    t.mul_(down - 0.45)


def rootq_serve_phase(device, card, r20_trainer, r50_trainer,
                      parent=None):
    """BASELINE config #5 served, and RootQ's integer routes: (a) the
    ResNet-50 RootQ W4A4 model of r50_training_leg, its bounds spread
    (spread_bounds) -> prepare_deploy; (b)
    intc through InferenceEngine at ENGINE_BATCH (checked_engine); (c) on
    ROOTQ_IMAGES images the card against the CPU plain path (card_vs_cpu),
    top-1 agreement with the card's fake-quant eval, the C20 count; (d)
    RootQ cifar_resnet20 (qat_phase's trainer) deployed: every launch ==
    plain at batch 8 and SERVE_BATCH, one served request; (e) one RootQ
    depthwise launch, every window-sum launch of a ResNet-50 step (==
    plain, timed, bound, torch.sum beside the 1x1 ones, ``parent``'s ms
    beside each: window_sum_launches) and each corrected conv / GEMM
    launch beside its uncorrected one.  Returns the launches by
    kind (b + d's request), the largest kernel-vs-plain difference, the
    window sums' kernels-line entry and the depthwise launch's
    (err, ms, bare ms)."""
    t0 = time.perf_counter()
    model = r50_trainer.model.eval()
    spread_bounds(model, SEED + 12)
    model = prepare_deploy(model)
    mids = midpoint_count(model)
    launches, ips, fwd_ms = checked_engine(
        "r50 rootq w4a4 (config #5)", model, "intc", (SIZE, SIZE, 3),
        R50_ROOTQ_LAUNCHES, device, card)
    x = images(ROOTQ_IMAGES, SEED + 9, device)
    y = card_vs_cpu("r50 rootq w4a4", model, x, "intc")
    with torch.inference_mode(), full_f32():
        fake = model(x, qmode="eval")
    agree = float((y.argmax(-1) == fake.argmax(-1)).float().mean())
    print(f"# r50 rootq w4a4: logits {tuple(y.shape)}; top-1 agreement with "
          f"the card's fake-quant eval {agree:.4f}; weights on a bin "
          f"midpoint (C20) {mids}")
    if y.shape != (ROOTQ_IMAGES, CLASSES):
        raise RuntimeError(f"r50 rootq w4a4: logits {tuple(y.shape)}")
    xb = torch.from_numpy(np.random.default_rng(SEED + 5).random(
        (ENGINE_BATCH, SIZE, SIZE, 3), np.float32)).to(device)
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(xb, qmode="intc")
        torch.cuda.synchronize()
        ws = window_sum_launches(rec.calls, fwd_ms, parent)
        beside = offset_beside(rec.calls)
    print("# r50 rootq w4a4 batch 128, each corrected launch beside the "
          "uncorrected one at its shape (launches, ms with the term, ms "
          "without): " + "; ".join(f"{kind} {n}, {a:.4f}, {b:.4f}"
                                   for kind, (n, a, b) in beside.items()))
    del model, rec
    r20 = r20_trainer.model.eval()
    spread_bounds(r20, SEED + 13)
    r20 = prepare_deploy(r20)
    xs = torch.cat([torch.from_numpy(b) for b, _ in
                    list(r20_trainer.train_loader)[:2]]).to(device)
    err = max(resnet_kernel_phase("qat rootq w4a4", r20, xb_,
                                  RESNET20_ROOTQ_LAUNCHES)["err"]
              for xb_ in (xs[:8], xs))
    zero_counts()
    serve = make_serving_fn(r20, qmode="intc", device=device, graph=False)
    with full_f32():
        served = serve(xs)
        torch.cuda.synchronize()
    request = engine_counts()
    card_vs_cpu("qat rootq w4a4 (cifar_resnet20)", r20, xs[:EVAL_IMAGES],
                "intc")
    if request != RESNET20_ROOTQ_LAUNCHES or not bool(
            torch.isfinite(served).all()):
        raise RuntimeError(f"the RootQ cifar_resnet20 request made "
                           f"{request}, expected {RESNET20_ROOTQ_LAUNCHES}")
    dw = rootq_dw_launch(device)
    print(f"# rootq_serve phase: {time.perf_counter() - t0:.1f} s")
    total = {k: launches[k] + request[k] for k in launches}
    return total, max(err, ws["err"]), ws, dw


def ptq_phase():
    """BASELINE config #1 through the PTQ entry, with eval_int: true;
    returns the conv and GEMM launches of the run."""
    cfg = read_yaml(CONFIG_1)
    cfg["eval_int"] = True
    run_dir = REPO / "saved" / "chip_smoke"
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg["save_dir"] = str(run_dir)
    path = run_dir / "PTQ_resnet18_cifar10_w8a8_eval_int.yaml"
    write_yaml(cfg, path)
    print(f"# ptq: config #1 with eval_int: true, nothing cut (calibration "
          f"{cfg['dataloaders']['calibration']['args']['n_samples']} images, "
          f"eval the synthetic fallback's 2000)")
    K.int8_conv3x3.launches = G.int8_gemm.launches = 0
    t0 = time.perf_counter()
    if ptq_entry.main(["-c", str(path)]) != 0:
        raise RuntimeError("the PTQ entry failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    convs, gemms = K.int8_conv3x3.launches, G.int8_gemm.launches
    (ckpt,) = sorted((run_dir / "models").glob("*/*/quantized_model"))[-1:]
    _, meta = load_checkpoint(ckpt)
    fp, quant, real = meta["fp32"], meta["quant"], meta["int"]
    print(f"# ptq: fp32 {fp}; fake quant {quant}; int {real}; "
          f"{convs} conv and {gemms} GEMM launches; wall {wall:.2f} s")
    losses = torch.tensor([fp["loss"], quant["loss"], real["loss"]])
    if not (bool(torch.isfinite(losses).all()) and convs and gemms
            and abs(real["loss"] - quant["loss"]) < 0.05 * quant["loss"]):
        raise RuntimeError("the PTQ entry's results are off")
    return convs, gemms


def accuracy_phase(device, card: str):
    """The port's accuracy protocol (tools/accuracy_protocol.py) cut to
    ACCURACY_CUT, both sections, as its main runs them; then the gates on
    its reconstructed RepVGG-A0.  Returns the conv launches of the
    protocol's run and the largest kernel-vs-plain difference."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        args = protocol.parse_args(ACCURACY_CUT
                                   + ["--out", f"{tmp}/RESULTS_torch.md"])
        K.int8_conv3x3.launches = 0
        # every launch of the run held against its plain version as it runs
        with LaunchRecorder(check=True) as rec:
            results = protocol.run(args, *protocol.loaders(args))
        torch.cuda.synchronize()
        launches = K.int8_conv3x3.launches
        protocol.write(results, args, card)
    t_run = time.perf_counter() - t0
    checked = rec.counts()
    worst = max((e for _, e in rec.calls), default=0.0)
    print(f"# accuracy: {checked} kernel calls of the protocol's run held "
          f"against their plain versions: max |diff| {worst}")
    if checked["conv"] != launches or worst != 0:
        raise RuntimeError(f"{checked['conv']} conv calls checked of "
                           f"{launches} launches, max |diff| {worst}")
    values = protocol.table_values(results)
    if not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"the protocol's tables hold {values}")
    res, qat, rep = results["resnet"], results["qat"], results["repvgg"]
    rows = ([("resnet20 fp32", res["fp32"], None)]
            + [(r["label"], r["top1"], r["agreement"]) for r in res["rows"]]
            + [(r["label"], r["top1"], None) for r in qat["rows"]]
            + [("A0 fp32", rep["fp32"], None)]
            + [(r["label"], r["top1"], rep["agreement"] if i == 0 else None)
               for i, r in enumerate(rep["rows"])])
    print(f"# accuracy: protocol {' '.join(ACCURACY_CUT)} in {t_run:.1f} s "
          f"(fp32 training {res['train_s']:.1f} + {rep['train_s']:.1f} s, "
          f"A0 reconstruction {rep['recon_s']:.1f} s); top-1 % and teacher "
          "agreement:")
    for label, top1, agree in rows:
        print(f"{label:45s} {top1:6.2f}" + (
            "" if agree is None else
            f"  agreement {agree[0]:.4f} -> {agree[1]:.4f}"))
    print("# accuracy: card vs CPU eval logits on 8 images (the worst "
          "quantized layer fed the card's input): reconstructed A0 rel L2 "
          "{:.3e} ({:.3e}), RootQ W4A4 {:.3e} ({:.3e}); gate kept ".format(
              *rep.get("card_vs_cpu", (math.nan,) * 2),
              *qat.get("rootq_card_vs_cpu", (math.nan,) * 2))
          + ", ".join(f"{r['kept']}/{r['blocks']}" for r in res["rows"])
          + f" (resnet20), {rep['kept']}/{rep['blocks']} (A0)")
    dropped = [a for a in [r["agreement"] for r in res["rows"]]
               + [rep["agreement"]] if a[1] < a[0]]
    if dropped:
        raise RuntimeError(f"teacher agreement dropped: {dropped}")
    intc = rep["rows"][2]
    per_batch = intc["launches"] / rep["batches"]
    print(f"# accuracy: A0 intc evaluation {intc['launches']} conv launches "
          f"over {rep['batches']} batches ({per_batch:g} a batch)")
    if intc["launches"] != ACCURACY_CONVS * rep["batches"]:
        raise RuntimeError(f"{per_batch} conv launches a batch in A0's "
                           f"intc evaluation, expected {ACCURACY_CONVS}")
    model, x8 = rep["qmodel"], rep["x8"]
    err = kernel_phase(model, 8, device, x=x8)["err"]
    y = make_serving_fn(model, qmode="intc", device=device)(x8)
    with torch.inference_mode():
        ref = copy.deepcopy(model).cpu()(x8.cpu(), qmode="intc")
    rel = rel_l2(y, ref)
    print(f"# accuracy: trained, reconstructed A0 served (intc, batch 8) vs "
          f"CPU plain path: rel L2 {rel:.3e}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    if y.shape != ref.shape or not bool(torch.isfinite(y).all()) \
            or not rel < 2e-2:
        raise RuntimeError(f"served A0 logits: rel L2 {rel} against the CPU")
    return launches, max(err, worst)


def tool_path(drive, wrapper, what: str):
    """Run a tool's main path with ``wrapper``'s launch count set to 0;
    returns the tool's rows and the launches of that run."""
    wrapper.launches = 0
    rows = drive()
    torch.cuda.synchronize()
    launches = wrapper.launches
    if launches == 0:
        raise RuntimeError(f"{what} never launched its kernel")
    return rows, launches


def max_abs(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def gemm_calls(row, gen):
    """(kernel, plain, library) calls on fresh operands of a sweep row."""
    m, k, n = row["m"], row["k"], row["n"]
    x, w = gemm_sweep.operands(m, k, n, gen)
    wp = G.pack_b(w)
    wc = gemm_sweep.col_major(wp, k)
    return (lambda: G.int8_gemm(x, wp), lambda: G.int8_gemm_plain(x, wp),
            lambda: torch._int_mm(x, wc))


def probe_calls(row, gen):
    """(kernel, plain, library) calls on fresh operands of a probe row."""
    x, wp = mma_probe.operands(row["m"], row["k"], row["n"], gen)
    rolls = row["rolls"]
    xc, wc = mma_probe.concat_operands(x, wp, rolls)
    return (lambda: P.int8_mma_probe(x, wp, rolls),
            lambda: P.int8_mma_probe_plain(x, wp, rolls),
            lambda: torch._int_mm(xc, wc))


def exact_phase(what: str, rows, calls):
    """Kernel vs plain vs torch._int_mm at each row's shape (tolerance 0);
    returns totals of the tool's times, the bounds and the plain times."""
    print(f"# {what} vs plain and torch._int_mm: (M,K,N) plan | max|d plain| "
          "max|d _int_mm| | kernel_ms bound_ms (by) plain_ms library_ms")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               library_ms=0.0, err=0)
    for row in rows:
        kernel, plain, library = calls(row)
        got = kernel()
        err_plain = max_abs(got, plain())
        err_lib = max_abs(got, library())
        plain_ms = event_ms(plain, PLAIN_REPS)
        b_ms = max(row["ops_ms"], row["bytes_ms"])
        plan = (f"tile {row['tile'][0]}x{row['tile'][1]}" if "tile" in row
                else f"split {row['split']}")
        print(f"({row['m']},{row['k']},{row['n']}) {plan} | {err_plain} "
              f"{err_lib} | "
              f"{row['ms']:.5f} {b_ms:.5f} "
              f"({bound_by(row['ops_ms'], row['bytes_ms'])}) {plain_ms:.4f} "
              f"{row['library_ms']:.5f}")
        if err_plain or err_lib:
            raise RuntimeError(f"{what} at ({row['m']},{row['k']},"
                               f"{row['n']}): differs from plain by "
                               f"{err_plain}, from torch._int_mm by {err_lib}")
        for key, val in (("ms", row["ms"]), ("plain_ms", plain_ms),
                         ("bound_ms", b_ms), ("ops_ms", row["ops_ms"]),
                         ("bytes_ms", row["bytes_ms"]),
                         ("library_ms", row["library_ms"])):
            tot[key] += val
    print(f"# {what} totals over {len(rows)} shapes: kernel {tot['ms']:.4f} "
          f"ms, bound {tot['bound_ms']:.4f} ms, plain {tot['plain_ms']:.4f} "
          f"ms, torch._int_mm {tot['library_ms']:.4f} ms")
    return tot


def engine_counts():
    """Every kernel wrapper's launch count, by kind."""
    return {kind: fn.launches for kind, (fn, _) in KERNELS.items()}


def zero_counts():
    for fn, _ in KERNELS.values():
        fn.launches = 0


def submit_stream(engine, pool, sizes, rate=None, seed=SEED):
    """Submit requests of ``sizes`` images (slices of ``pool`` at seeded
    offsets) from a submitter thread, at exponential gaps of mean
    ``1/rate`` s (all at once without a rate); returns [(offset, size,
    future, submit time, done times)] once every future is done."""
    rng = np.random.default_rng(seed)
    offsets = rng.integers(0, len(pool) - max(sizes) + 1, len(sizes))
    gaps = (rng.exponential(1.0 / rate, len(sizes)) if rate
            else np.zeros(len(sizes)))
    reqs = []

    def submitter():
        for off, k, gap in zip(offsets, sizes, gaps):
            time.sleep(gap)
            done = []
            t = time.perf_counter()
            fut = engine.submit(pool[off:off + k])
            fut.add_done_callback(
                lambda _, d=done: d.append(time.perf_counter()))
            reqs.append((off, k, fut, t, done))

    thread = threading.Thread(target=submitter)
    thread.start()
    thread.join()
    for *_, fut, _t, _d in reqs:
        fut.result(timeout=600)
    return reqs


def checked_stream(what, eng, pool, sizes, expect):
    """Requests of ``sizes`` images (slices of ``pool``) through the
    running engine under LaunchRecorder(check=True): the launches a step
    as ``expect`` says, each == plain.  Returns (the requests, the steps,
    the launches checked)."""
    zero_counts()
    steps0 = eng.stats["batches"]
    with LaunchRecorder(check=True) as rec:
        reqs = submit_stream(eng, pool, sizes)
    steps = eng.stats["batches"] - steps0
    bad = [(kind, err) for kind, err in rec.calls if err != 0]
    want = {kind: n * steps for kind, n in expect.items()}
    if rec.counts() != want or bad:
        raise RuntimeError(f"{what} engine: {rec.counts()} checked "
                           f"launches in {steps} steps (expected {want}); "
                           f"differing from plain: {bad[:3]}")
    return reqs, steps, len(rec.calls)


def check_futures(what, eng, pool, reqs):
    """Every request's rows == the direct forward of its images (relative
    1e-6); returns the worst relative difference."""
    b = eng.batch_size
    worst = 0.0
    for off, k, fut, *_ in reqs:
        got = fut.result()
        direct = np.concatenate([
            eng.forward(pool[off + i:off + min(i + b, k)]).cpu().numpy()
            for i in range(0, k, b)])
        if got.shape != direct.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{what} engine: bad rows {got.shape}")
        worst = max(worst, float(np.abs(got - direct).max()
                                 / (np.abs(direct).max() + 1e-12)))
    if not worst <= 1e-6:
        raise RuntimeError(f"{what} engine: a future differs from the "
                           f"direct forward by {worst} (relative)")
    return worst


def engine_leg(what, model, qmode, image, expect, device, card,
               ips_line=None, n_timed=ENGINE_SHORT):
    """One model through the continuous-batching engine at ENGINE_BATCH: a
    checked stream of mixed request sizes (1 to 3 batches) under
    LaunchRecorder(check=True), every launch == plain, every future's rows
    == the direct forward of its images; ENGINE_FULL requests submitted at
    once (the engine's images/s under a full queue); a timed stream of
    ``n_timed`` requests with Poisson arrivals at ENGINE_LOAD of that
    rate: request latency median (p50), max, and p99 where ``n_timed`` is
    ENGINE_TAIL; images/s, pad waste; the step's device parts.  The
    checked stream runs on an eager engine (the recorder sees the
    wrappers' calls, which a graph's replay does not make), the rest on
    the graphed engine, the card's default, whose steps are first held
    bit-equal to the eager engine's (graphed_engine).  Returns the
    launches by kind from the checked stream on (a graph's replay
    launches nothing on the host)."""
    eager = InferenceEngine(model, batch_size=ENGINE_BATCH, qmode=qmode,
                            device=device, graph=False)
    eng, ips, _ = graphed_engine(what, model, qmode, image, eager, device)
    if ips_line is not None:
        print(f"# {what} engine: serve_benchmark {json.dumps(ips_line)}")
    print(f"# {what} engine (qmode {qmode!r}, batch {ENGINE_BATCH}): graphed"
          f" measure_throughput {ips:.1f} images/s on {card}")
    b = ENGINE_BATCH
    pool = np.random.default_rng(SEED + 5).random(
        (3 * b + 64,) + tuple(image), np.float32)
    rng = np.random.default_rng(SEED + 6)
    eager.start()
    try:
        checked, checked_steps, n_checked = checked_stream(
            what, eager, pool, rng.integers(1, 3 * b + 1,
                                            ENGINE_CHECKED).tolist(), expect)
    finally:
        eager.stop()
    eng.start()
    try:
        sizes = rng.integers(1, 3 * b + 1, ENGINE_FULL).tolist()
        t0 = time.perf_counter()
        full = submit_stream(eng, pool, sizes, seed=SEED + 7)
        full_ips = sum(sizes) / (time.perf_counter() - t0)
        sizes = rng.integers(1, 3 * b + 1, n_timed).tolist()
        before = dict(eng.stats)
        t0 = time.perf_counter()
        timed = submit_stream(eng, pool, sizes, seed=SEED + 8,
                              rate=ENGINE_LOAD * full_ips / np.mean(sizes))
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    torch.cuda.synchronize()
    launches = engine_counts()
    steps = {k: eng.stats[k] - before[k] for k in eng.stats}
    worst = max(check_futures(what, eager, pool, checked),
                check_futures(what, eng, pool, full + timed))
    lat = np.array([(d[0] - t) * 1e3 for *_, t, d in timed])
    tail = (f"p99 {np.percentile(lat, 99):.2f} ms, "
            if n_timed >= ENGINE_TAIL else "")
    images = sum(k for _, k, *_ in timed)
    x = torch.from_numpy(pool[:b])
    xd = x.to(device)
    fwd_ms = event_ms(lambda: eng.forward(xd), 5)
    eng.graphed.reset()
    h2d_ms = event_ms(lambda: x.to(device), 5)
    print(f"# {what} engine: eager checked stream of {len(checked)} requests "
          f"({sum(k for _, k, *_ in checked)} images, {checked_steps} steps, "
          f"{n_checked} launches == plain); every future == the direct "
          f"forward (worst relative {worst:.1e}, "
          f"{len(checked + full + timed)} requests); {len(full)} requests of "
          f"1..{3 * b} images at once: {full_ips:.1f} images/s; "
          f"{len(timed)} requests at Poisson arrivals at {ENGINE_LOAD} of "
          f"that rate: request latency median (p50) "
          f"{np.percentile(lat, 50):.2f} ms, {tail}max of {len(timed)} "
          f"{lat.max():.2f} ms, mean {lat.mean():.2f} ms; "
          f"{images / wall:.1f} images/s over {wall:.2f} s; {steps['batches']}"
          f" steps, pad waste {steps['pad_waste'] / (steps['batches'] * b):.3f}"
          f" of the rows (graphed); a step's device parts: graphed forward "
          f"{fwd_ms:.3f} ms on device-resident images, host-to-device copy of "
          f"{b} float32 images {h2d_ms:.3f} ms; launches {launches}; {card}")
    return launches


def serving_phase(device, card, r50_deploy):
    """serve_benchmark's path on RepVGG-A0 (the entry itself, with its
    defaults) and ResNet-50 (W8A8, 224x224, qmode 'int'), then the
    deploy-form ResNet-50 in 'intc' (the stem conv + pool kernel), each
    through InferenceEngine; returns the launches by kind."""
    total = dict.fromkeys(KERNELS, 0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_bench.main([])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    for name in ("RepVGG_A0", "resnet50"):
        model = serve_bench.build(name, 8, 8, device)
        a0 = name == "RepVGG_A0"
        got = engine_leg(f"{name} W8A8", model, "int", (SIZE, SIZE, 3),
                         ENGINE_INT_LAUNCHES[name], device, card,
                         line if a0 else None,
                         ENGINE_TAIL if a0 else ENGINE_SHORT)
        total = {k: total[k] + got[k] for k in total}
        del model
    got = engine_leg("resnet50 deploy form", r50_deploy, "intc",
                     (SIZE, SIZE, 3), RESNET50_LAUNCHES, device, card)
    return {k: total[k] + got[k] for k in total}


def lockstep_leg():
    """tools/lockstep_2proc.py on the card: two processes, both engines on
    card 0, the votes over gloo."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "dlmc_quant_torch.tools.lockstep_2proc"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    lines = run.stdout.strip().splitlines()
    print("# lockstep 2-proc on the card: " + " | ".join(
        ln for ln in lines if ln.startswith(("proc ", "LOCKSTEP")))
        + f" ({time.perf_counter() - t0:.1f} s)")
    steps = [ln.split("steps=")[1].split(",")[0] for ln in lines
             if "steps=" in ln]
    if run.returncode != 0 or "LOCKSTEP 2-PROC: PASS" not in run.stdout \
            or len(steps) != 2 or steps[0] != steps[1]:
        print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
        raise RuntimeError("the two-process lockstep failed")


def two_ranks(argv, timeout: int):
    """``argv`` started as ranks 0 and 1 of a world of two on localhost
    (a free port), each with OMP_NUM_THREADS=1; their stdouts, or a
    RuntimeError with their tails where either fails."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [*argv, "--coordinator", f"localhost:{port}", "--num-hosts", "2",
         "--host-id", str(i)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        for i, out in enumerate(outs):
            print(f"--- rank {i}:\n{out[-3000:]}", file=sys.stderr)
        raise RuntimeError(f"{argv[2]} on two ranks failed")
    return outs


def model_axis_phase(card: str):
    """The model axis on two ranks of card 0 (docstring); returns the
    launches by kind of the tool's sharded batches, both ranks'."""
    t0 = time.perf_counter()
    outs = two_ranks([sys.executable, "-m",
                      "dlmc_quant_torch.examples.serve_benchmark",
                      "RepVGG_A0", str(MODEL_AXIS_BATCH)], 300)
    line = json.loads(outs[0].strip().splitlines()[-1])
    print(f"# model_axis: serve_benchmark RepVGG_A0 W8A8 batch "
          f"{MODEL_AXIS_BATCH} on two ranks of card 0 ({card}): "
          f"{json.dumps(line)} ({time.perf_counter() - t0:.1f} s)")
    if not line["model_axis"].startswith("2 (") \
            or not line["2_devices"] > 0:
        raise RuntimeError("serve_benchmark ran no model axis")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "dlmc_quant_torch.tools.model_axis_2proc"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    lines = run.stdout.strip().splitlines()
    for ln in lines:
        if ln.startswith(("# ", "---", "MODEL AXIS")):
            print(ln)
    results = [json.loads(ln.split(" ", 1)[1]) for ln in lines
               if ln.startswith("MODEL_AXIS ")]
    if run.returncode != 0 or "MODEL AXIS 2-PROC: PASS" not in run.stdout \
            or len(results) != 2:
        print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
        raise RuntimeError("the two-rank model axis failed")
    launches = dict.fromkeys(KERNELS, 0)
    for rank in results:
        for res in rank["models"]:
            for kind, n in res["launches"].items():
                launches[kind] += n
    if not all(launches[k] for k in ("conv", "gemm", "stem_pool")):
        raise RuntimeError(f"the sharded batches launched {launches}")
    print(f"# model_axis: the tool {time.perf_counter() - t0:.1f} s; "
          f"sharded launches of both ranks {launches}")
    return launches


@contextlib.contextmanager
def recorded_losses(losses):
    """Every trainer's step losses into ``losses``."""
    step = Trainer.train_step

    def recorded(self, x, y):
        loss, logits = step(self, x, y)
        losses.append(loss)
        return loss, logits

    Trainer.train_step = recorded
    try:
        yield
    finally:
        Trainer.train_step = step


def distributed_phase(device):
    """python -m dlmc_quant_torch.examples.distributed_training at world
    size 1 on NCCL (LSQ W4A4 cut as the qat phase cuts it), its first
    losses against the plain QATTrainer's, both under full_f32."""
    cfg = read_yaml(CONFIGS / f"{QAT_CONFIGS['lsq']}.yaml")
    cfg["train_loader"]["args"].update(n_samples=QAT_IMAGES)
    cfg["n_runs"] = 1
    cfg["trainer"]["epochs"] = 1
    with tempfile.TemporaryDirectory() as tmp:
        cfg["save_dir"] = tmp
        path = pathlib.Path(tmp) / "lsq_cut.yaml"
        write_yaml(cfg, path)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist_losses, plain_losses = [], []
        t0 = time.perf_counter()
        with full_f32(), recorded_losses(dist_losses):
            rc = dist_entry.main(["-c", str(path), "--coordinator",
                                  f"localhost:{port}", "--num-hosts", "1",
                                  "--host-id", "0"])
        wall = time.perf_counter() - t0
    trainer = qat_entry.build_trainer(
        training_config(QAT_CONFIGS["lsq"], n_samples=QAT_IMAGES), device,
        get_logger("qat"))
    with full_f32(), recorded_losses(plain_losses):
        trainer.train()
    a = torch.stack(dist_losses).cpu().double()
    b = torch.stack(plain_losses).cpu().double()
    n = DIST_LOSSES
    rel = float(((a[:n] - b[:n]).abs() / b[:n].abs()).max())
    print(f"# distributed_training (NCCL, world size 1, LSQ W4A4, "
          f"{len(a)} steps in {wall:.2f} s): rc {rc}; first {n} losses "
          f"{[round(float(v), 5) for v in a[:n]]} vs the plain "
          f"QATTrainer's {[round(float(v), 5) for v in b[:n]]}: worst "
          f"relative {rel:.2e}")
    if rc != 0 or len(a) != len(b) or not rel < 1e-4:
        raise RuntimeError("distributed_training departs from QATTrainer")


def grouped_context_ms(args, kw) -> float:
    """A bf16 F.conv2d(groups=G) 3x3 at a grouped launch's shape, channels
    last (context: no PyTorch call computes an int8 conv)."""
    x, wp, a = args[:3]
    g = kw["groups"]
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    wb = K.unpack_weight(wp, x.shape[-1], a.shape[0], g) \
        .permute(3, 2, 0, 1).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    pad = kw.get("pad_lo", 1)
    if pad == 0:                         # SAME at stride 2: pads (0, 1)
        xb = F.pad(xb, (0, 1, 0, 1))
    return event_ms(lambda: F.conv2d(xb, wb, stride=kw["stride"],
                                     padding=pad, groups=g), REPS)


def zoo_deployed(name, device, train_form: bool):
    """RepVGG ``name`` at full width, 224x224, seeded weights: the train
    form with BN statistics from a train-mode forward of the calibration
    images, then perturbed, through repvgg_fuse (``train_form``), or the
    deploy form built directly (bench.py's D2se); the bench's W8A8 scheme,
    calibrated on ZOO_CAL images, prepared.  Returns it and ZOO_BATCH
    seeded images."""
    if not train_form:
        model = get_model(name, device=device, num_classes=CLASSES,
                          deploy=True, scheme=scheme_from_dict(BENCH_SCHEME),
                          generator=torch.Generator().manual_seed(SEED))
        x = images(ZOO_BATCH, SEED + 4, device)
    else:
        model, x = zoo_train_form(name, device)
        model = attach_scheme(repvgg_fuse(model),
                              scheme_from_dict(BENCH_SCHEME))
    calibrate(model, [x[:ZOO_CAL]])
    return prepare_deploy(model), x


def zoo_train_form(name, device):
    """RepVGG ``name``'s train form at full width, seeded weights, BN
    statistics from a train-mode forward of ZOO_CAL images, then
    perturbed; and ZOO_BATCH seeded images."""
    gen = torch.Generator().manual_seed(SEED)
    x = images(ZOO_BATCH, SEED + 4, device)
    model = get_model(name, device=device, num_classes=CLASSES,
                      generator=gen)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.momentum = 1.0
        model.train()(x[:ZOO_CAL], qmode="fp")
        model.eval()
        for bn in bns:
            bn.momentum = 0.1
            for t in (bn.running_mean, bn.running_var, bn.weight, bn.bias):
                t += 0.1 * torch.rand(t.shape, generator=gen).to(device)
    return model, x


def zoo_launch_phase(what, model, x, expect):
    """Every launch of one chained request of ``x`` against its plain
    version (tolerance 0) and timed (CUDA graph of 16); each grouped
    launch beside its bound, its plain ms and a bf16 grouped conv of the
    same shape.  Returns the totals of the grouped and of the other
    launches."""
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(x, qmode="intc")
        torch.cuda.synchronize()
        if rec.counts() != expect:
            raise RuntimeError(f"{what}: a request made {rec.counts()} "
                               f"launches, expected {expect}")
        print(f"# {what} kernel vs plain, batch {x.shape[0]}: launch | "
              "max|diff| | kernel_us bound_us (by) kernel/bound "
              "{plain_us bf16_grouped_conv_us}")
        tots = {key: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                          bytes_ms=0.0, context_ms=0.0, err=0.0, n=0)
                for key in ("grouped", "conv")}
        for i, (kind, args, kw, out) in enumerate(rec.calls):
            label = launch_label(kind, args, kw)
            err = max_diff_to_plain(kind, args, kw, out)
            if err != 0:
                raise RuntimeError(f"{what} launch {i} ({label}): kernel "
                                   f"and plain differ by {err}")
            ms = graph_ms(lambda _: K.int8_conv3x3(*args, **kw),
                          GRAPH_LAUNCHES)
            b_ms, t_ops, t_bytes = launch_bound(kind, args, kw, out)
            grouped = kw.get("groups", 1) > 1
            t = tots["grouped" if grouped else "conv"]
            extra = ""
            if grouped:
                plain_ms = event_ms(lambda: KERNELS[kind][1](*args, **kw),
                                    PLAIN_REPS)
                context_ms = grouped_context_ms(args, kw)
                t["plain_ms"] += plain_ms
                t["context_ms"] += context_ms
                extra = f" {{{plain_ms * 1e3:.1f} {context_ms * 1e3:.2f}}}"
            for key, val in (("ms", ms), ("bound_ms", b_ms),
                             ("ops_ms", t_ops), ("bytes_ms", t_bytes)):
                t[key] += val
            t["n"] += 1
            print(f"{i:2d} {label:62s} | {err:g} | {ms * 1e3:8.2f} "
                  f"{b_ms * 1e3:8.2f} ({bound_by(t_ops, t_bytes)}) "
                  f"{ms / b_ms:.2f}{extra}")
    for key, t in tots.items():
        if t["n"]:
            print(f"# {what} batch {x.shape[0]} {key} launches ({t['n']}): "
                  f"kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({bound_by(t['ops_ms'], t['bytes_ms'])}; ops "
                  f"{t['ops_ms']:.4f}, bytes {t['bytes_ms']:.4f})"
                  + (f", plain {t['plain_ms']:.4f} ms; library_ms: none - "
                     "no PyTorch call computes an int8 conv; bf16 grouped "
                     f"convs of the same shapes take {t['context_ms']:.4f} "
                     "ms (context only)" if key == "grouped" else ""))
    return tots


def merge_bn_leg(device):
    """merge_bn on the card: cifar_resnet20 with seeded weights and
    perturbed BN statistics keeps its output (strict f32) within 1e-4
    relative."""
    gen = torch.Generator().manual_seed(SEED)
    model = get_model("cifar_resnet20", device=device,
                      num_classes=CIFAR_CLASSES, generator=gen)
    x = cifar_images(MERGE_BN_IMAGES, SEED, device)
    with torch.no_grad(), full_f32():
        for bn in model.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                for t, lo in ((bn.running_mean, -0.1), (bn.running_var, 0.7),
                              (bn.weight, 0.8), (bn.bias, -0.1)):
                    t.copy_(lo + 0.3 * torch.rand(t.shape, generator=gen))
        want = model(x)
        merged = merge_bn(model, x[:1])
        got = merged(x)
    folded = sum(bool((m.running_var == 1 - m.eps).all())
                 for m in merged.modules()
                 if isinstance(m, torch.nn.BatchNorm2d))
    rel = float((got - want).norm() / want.norm())
    print(f"# merge_bn: cifar_resnet20 on the card, {folded} BatchNorms "
          f"folded into their convs; output vs the unfolded model on "
          f"{MERGE_BN_IMAGES} images (full f32): rel L2 {rel:.3e}")
    if folded != 19 or not rel < 1e-4:
        raise RuntimeError(f"merge_bn on the card: {folded} folds, rel {rel}")


def zoo_phase(device):
    """RepVGG-B2g4 (train form -> repvgg_fuse -> calibrate -> deploy; 13
    grouped convs) and RepVGG-D2se (deploy form, SE blocks): every launch
    == plain, 6 served requests each (the CPU reference on ZOO_REF
    images), then merge_bn on the card.  Returns the grouped launches'
    totals (with the served grouped launches) and the served launches and
    largest difference of the other convs."""
    t0 = time.perf_counter()
    model, x = zoo_deployed("RepVGG_B2g4", device, train_form=True)
    grouped = sum(getattr(model, n).reparam.groups > 1
                  for n in model.block_names)
    print(f"# RepVGG-B2g4: train form -> repvgg_fuse -> bench W8A8 scheme "
          f"-> calibrate ({ZOO_CAL} images) + prepare_deploy in "
          f"{time.perf_counter() - t0:.2f} s; {grouped} of "
          f"{len(model.block_names)} convs grouped")
    if grouped != B2G4_GROUPED:
        raise RuntimeError(f"RepVGG-B2g4 has {grouped} grouped convs")
    b2 = zoo_launch_phase("RepVGG_B2g4", model, x, B2G4_LAUNCHES)
    _, b2_served = serve_requests(
        "RepVGG_B2g4", model, x,
        dict(B2G4_LAUNCHES, conv_grouped=B2G4_GROUPED), CLASSES, ZOO_REF)
    del model
    t0 = time.perf_counter()
    model, x = zoo_deployed("RepVGG_D2se", device, train_form=False)
    n_params = sum(p.numel() for n, p in model.named_parameters()
                   if n.endswith(("weight", "bias"))) / 1e6
    print(f"# RepVGG-D2se: deploy form ({n_params:.1f} M weights and "
          f"biases) -> bench W8A8 scheme -> calibrate ({ZOO_CAL} "
          f"images) + prepare_deploy in {time.perf_counter() - t0:.2f} s")
    d2 = zoo_launch_phase("RepVGG_D2se", model, x, D2SE_LAUNCHES)
    _, d2_served = serve_requests("RepVGG_D2se", model, x, D2SE_LAUNCHES,
                                  CLASSES, ZOO_REF)
    del model
    merge_bn_leg(device)
    grouped_tot = dict(b2["grouped"],
                       launches=b2_served["conv_grouped"])
    other = (b2_served["conv"] - b2_served["conv_grouped"]
             + d2_served["conv"])
    return grouped_tot, other, max(b2["conv"]["err"], d2["conv"]["err"])


# the depthwise launches' paths: the aligned 3x3 build (int8_dwconv3x3.cu),
# the 3x3 window's ragged path and the 5x5 window (both int8_dwconv5x5.cu),
# the 1x1 window (either build)
DW_PATHS = ("aligned", "ragged", "5x5", "1x1")


def dw_path(args) -> str:
    """A depthwise launch's path (DW_PATHS) from its codes and weight."""
    if DW.window(args[1]) in (1, 5):
        return f"{DW.window(args[1])}x{DW.window(args[1])}"
    return "ragged" if DW.route(args[0], args[1]) else "aligned"


def dw_launch_phase(what, model, x, expect):
    """Every launch of one request of ``x`` against its plain version
    (tolerance 0); each depthwise launch timed (CUDA graph of 16) beside
    its window, C, stride, plan, bound (bytes: x and the weight read once,
    the output written once), plain ms and a bf16 F.conv2d(groups=C) of the
    same shape.  Returns the depthwise totals by path (DW_PATHS)."""
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(x, qmode="intc")
        torch.cuda.synchronize()
        if rec.counts() != expect:
            raise RuntimeError(f"{what}: a request made {rec.counts()} "
                               f"launches, expected {expect}")
        tots = {g: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                        bytes_ms=0.0, context_ms=0.0, err=0.0, n=0, ragged=0)
                for g in DW_PATHS}
        print(f"# {what} kernel vs plain, batch {x.shape[0]}: every launch "
              "== plain; each depthwise launch: window, (N, H, W, C), "
              "stride, plan | kernel_us bound_us (by) kernel/bound "
              "{plain_us bf16_grouped_conv_us}")
        for i, (kind, args, kw, out) in enumerate(rec.calls):
            err = max_diff_to_plain(kind, args, kw, out)
            if err != 0:
                raise RuntimeError(f"{what} launch {i} ({kind}): kernel and "
                                   f"plain differ by {err}")
            if kind != "dwconv":
                continue
            t = tots[dw_path(args)]
            ms = graph_ms(lambda _: DW.int8_dwconv3x3(*args, **kw),
                          GRAPH_LAUNCHES)
            b_ms, t_ops, t_bytes = launch_bound(kind, args, kw, out)
            plain_ms = event_ms(lambda: DW.int8_dwconv3x3_plain(*args, **kw),
                                PLAIN_REPS)
            context_ms = dw_context_ms(args, kw)
            for key, val in (("ms", ms), ("bound_ms", b_ms),
                             ("ops_ms", t_ops), ("bytes_ms", t_bytes),
                             ("plain_ms", plain_ms),
                             ("context_ms", context_ms)):
                t[key] += val
            t["n"] += 1
            t["ragged"] += DW.route(args[0], args[1]) != 0
            print(f"{i:3d} {launch_label(kind, args, kw):78s} | "
                  f"{ms * 1e3:8.2f} {b_ms * 1e3:8.2f} "
                  f"({bound_by(t_ops, t_bytes)}) {ms / b_ms:.2f} "
                  f"{{{plain_ms * 1e3:.1f} {context_ms * 1e3:.2f}}}")
    for g, t in tots.items():
        if t["n"]:
            print(f"# {what} batch {x.shape[0]} depthwise {g} launches "
                  f"({t['n']}, {t['ragged']} on the ragged path): kernel "
                  f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({bound_by(t['ops_ms'], t['bytes_ms'])}), plain "
                  f"{t['plain_ms']:.4f} ms; bf16 grouped convs of the same "
                  f"shapes {t['context_ms']:.4f} ms (context only)")
    return tots


def held_by_modules(what, model):
    """``serve_requests``'s ``on_flip``: the logits of the card and the CPU
    plain path parted past 2e-2 on the reference images (C14: a code that
    a float difference flips at a tie moves every layer after it); each
    module of the plain 'int' forward fed the card's inputs must be within
    1e-4 of its CPU copy (``card_vs_cpu``: gated there), and the logits
    are printed."""
    def hold(rel, x):
        print(f"# {what}: intc logits card vs CPU rel L2 {rel:.3e} past "
              "2e-2 (C14, a tie flipped); the model held module by module "
              "in 'int':")
        y = card_vs_cpu(what, model, x, "int")
        print(f"# {what}: card logits {y[:2].cpu().numpy().round(3)}")
    return hold


def kernel_split(what, model, x, request_ms, expect):
    """One request's launches replayed by kind (CUDA graphs of each kind's
    launches in request order) against the request's ms: the rest is the
    host, gaps and torch's small ops, whose kernels the profiler counts."""
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(x, qmode="intc")
        by_kind = {}
        for kind, a, kw, _ in rec.calls:
            by_kind.setdefault(kind, []).append((KERNELS[kind][0], a, kw))
        parts = {f"{len(calls)} {kind}": graph_ms(
            lambda _, c=calls: run_calls(c), 4)
            for kind, calls in by_kind.items()}
    split_line(what, request_ms, parts)
    serve = make_serving_fn(model, qmode="intc", device=x.device,
                            graph=False)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        serve(x)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    print(f"# {what} serve: one request runs {sum(kernels.values())} "
          f"kernels on the card, {sum(expect.values())} of them the port's "
          "launches and the rest torch's ops (folded boundaries' affines, "
          "input quantizes, concats, float32 sums, SE blocks, swish, head)")


def ghost_effnet_phase(device):
    """GhostNet-1.0 ('intc') and EfficientNet-B0 ('int') at 224x224: train
    form with seeded weights and BN statistics -> ghostnet_deploy /
    efficientnet_deploy -> the bench's W8A8 scheme -> calibrate -> deploy;
    every launch of a request == plain at batch 8 and 256, each depthwise
    launch timed; 6 served batch-256 requests each.  Returns the depthwise
    totals by path (DW_PATHS) at batch 256 (both models) and the served
    launches by kind (``dwconv_5x5`` and ``dwconv_ragged`` among them: no
    5x5 launch is ragged, so these are the two entries of
    int8_dwconv5x5.cu)."""
    dw = {g: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                  bytes_ms=0.0, context_ms=0.0, err=0.0) for g in DW_PATHS}
    served = {}
    for label, (name, fuser, expect, wide, ragged) in GHOST_EFFNET.items():
        t0 = time.perf_counter()
        model = mobile_deployed(name, {}, fuser, device)
        print(f"# {label}: train form -> {fuser.__name__} -> bench W8A8 "
              f"scheme -> calibrate (batch {CAL_BATCH}) + prepare_deploy in "
              f"{time.perf_counter() - t0:.2f} s")
        for batch in (8, SERVE_BATCH):
            tots = dw_launch_phase(label, model,
                                   images(batch, SEED + 1, device), expect)
            if (tots["5x5"]["n"], tots["ragged"]["n"],
                    tots["5x5"]["ragged"]) != (wide, ragged, 0):
                raise RuntimeError(f"{label}: {tots['5x5']['n']} 5x5 and "
                                   f"{tots['ragged']['n']} ragged 3x3 "
                                   f"depthwise launches, "
                                   f"{tots['5x5']['ragged']} 5x5 ones on "
                                   f"the ragged path, expected {wide}, "
                                   f"{ragged}, 0")
            if batch == SERVE_BATCH:
                for k, t in tots.items():
                    for key in dw[k]:
                        dw[k][key] += t[key]
        request_ms, launches = serve_requests(
            label, model, images(SERVE_BATCH, SEED + 2, device),
            dict(expect, dwconv_5x5=wide, dwconv_ragged=ragged), CLASSES,
            on_flip=held_by_modules(label, model))
        kernel_split(label, model, images(SERVE_BATCH, SEED + 2, device),
                     request_ms, expect)
        print(f"# {label} serve: launches a request by kernel: "
              f"int8_conv3x3 {expect['conv']}, int8_gemm {expect['gemm']}, "
              f"int8_dwconv3x3 {expect['dwconv'] - wide - ragged}, "
              f"int8_dwconv_ragged {ragged} and int8_dwconv5x5 {wide} "
              f"(int8_dwconv5x5.cu); request {request_ms:.3f} ms at batch "
              f"{SERVE_BATCH}")
        for kind, n in launches.items():
            served[kind] = served.get(kind, 0) + n
        del model
    return dw, served


# the zoo_routes phase's routes: the depthwise kernel's 1x1 window, the
# grouped window sums and the grouped conv with a row term
ROUTE_KINDS = ("dwconv_1x1", "window_sum_grouped", "conv_grouped_term")


def route_kind(kind, args, kw):
    """A launch's route among ROUTE_KINDS, or None."""
    if kind == "dwconv" and DW.window(args[1]) == 1:
        return "dwconv_1x1"
    if kind == "window_sum" and kw.get("groups", 1) > 1:
        return "window_sum_grouped"
    if kind == "conv" and kw.get("groups", 1) > 1 \
            and kw.get("row") is not None:
        return "conv_grouped_term"
    return None


def route_context_ms(route, args, kw) -> float:
    """A PyTorch call beside a route's launch (context: none computes the
    same function): a bf16 F.conv2d(groups=C) 1x1, a torch.sum of each
    pixel's groups (the sums' reduction without the windows), a bf16
    grouped 3x3 conv."""
    if route == "dwconv_1x1":
        return dw_context_ms(args, kw)
    if route == "conv_grouped_term":
        return grouped_context_ms(args, kw)
    x, g = args[0], kw["groups"]
    xg = x.view(*x.shape[:3], g, x.shape[3] // g)
    return event_ms(lambda: torch.sum(xg, dim=-1, dtype=torch.int32), REPS)


def route_launch_phase(what, model, x, qmode, expect):
    """One request of ``x`` in ``qmode``: the launches by kind as
    ``expect``, each == plain (tolerance 0); each launch of this slice's
    routes (ROUTE_KINDS) timed (CUDA graph of 16) beside its bound, its
    plain ms and a context call.  Returns the totals by route."""
    tots = {r: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                    bytes_ms=0.0, context_ms=0.0, err=0.0, n=0)
            for r in ROUTE_KINDS}
    with torch.inference_mode():
        with LaunchRecorder() as rec:
            model(x, qmode=qmode)
        torch.cuda.synchronize()
        if rec.counts() != expect:
            raise RuntimeError(f"{what}: a request made {rec.counts()} "
                               f"launches, expected {expect}")
        print(f"# {what} {qmode} kernel vs plain, batch {x.shape[0]}: "
              f"every one of {len(rec.calls)} launches == plain; each launch "
              "of this slice's routes: launch | kernel_us bound_us (by) "
              "kernel/bound {plain_us context_us}")
        for i, (kind, args, kw, out) in enumerate(rec.calls):
            err = max_diff_to_plain(kind, args, kw, out)
            if err != 0:
                raise RuntimeError(f"{what} launch {i} ({kind}): kernel and "
                                   f"plain differ by {err}")
            route = route_kind(kind, args, kw)
            if route is None:
                continue
            run, plain = KERNELS[kind]
            ms = graph_ms(lambda _: run(*args, **kw), GRAPH_LAUNCHES)
            b_ms, t_ops, t_bytes = launch_bound(kind, args, kw, out)
            plain_ms = event_ms(lambda: plain(*args, **kw), PLAIN_REPS)
            context_ms = route_context_ms(route, args, kw)
            t = tots[route]
            for key, val in (("ms", ms), ("bound_ms", b_ms),
                             ("ops_ms", t_ops), ("bytes_ms", t_bytes),
                             ("plain_ms", plain_ms),
                             ("context_ms", context_ms)):
                t[key] += val
            t["n"] += 1
            print(f"{i:3d} {launch_label(kind, args, kw):78s} | "
                  f"{ms * 1e3:8.2f} {b_ms * 1e3:8.2f} "
                  f"({bound_by(t_ops, t_bytes)}) {ms / b_ms:.2f} "
                  f"{{{plain_ms * 1e3:.1f} {context_ms * 1e3:.2f}}}")
    for route, t in tots.items():
        if t["n"]:
            print(f"# {what} {qmode} batch {x.shape[0]} {route} launches "
                  f"({t['n']}): kernel {t['ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms "
                  f"({bound_by(t['ops_ms'], t['bytes_ms'])}), plain "
                  f"{t['plain_ms']:.4f} ms; context calls "
                  f"{t['context_ms']:.4f} ms")
    return tots


def expected_launches(model, qmode):
    """The launches by kind of one request of a RepVGG whose every layer
    has a weight offset (RootQ), counted from its layers: a 3x3 conv one
    conv launch, a 1x1 one GEMM launch a group, each offset layer one
    window sum (grouped ones apart), the dense head none where it is not
    quantized; 'intc' on the deploy form, 'int' on the train form."""
    out = dict.fromkeys(KERNELS, 0)
    out.update(conv_grouped=0, window_sum_grouped=0)
    for m in model.modules():
        if isinstance(m, QConv) and m.cfg is not None:
            if m.kernel_size == 3:
                out["conv"] += 1
                out["conv_grouped"] += m.groups > 1
            else:
                out["gemm"] += m.groups
            if hasattr(m, "w_offset"):
                out["window_sum"] += 1
                out["window_sum_grouped"] += m.groups > 1
        elif isinstance(m, QDense) and m.cfg is not None \
                and hasattr(m, "w_offset"):
            out["window_sum"] += 1
    return out


def mobileone_train_int(device):
    """MobileOne-S1's train form (:func:`mobile_train_form`) under config
    #4's W4A8 FSPTQ scheme, calibrated on CAL_BATCH images, prepared: its
    'int' path runs every branch apart."""
    model, x = mobile_train_form(W4_MODEL, {}, device)
    attach_scheme(model, scheme_from_dict(read_yaml(CONFIG_4)["quantization"]))
    calibrate(model, [x])
    return prepare_deploy(model)


def b2g4_rootq(device, train_form: bool):
    """RepVGG-B2g4's train form (:func:`zoo_train_form`), as it is or
    through repvgg_fuse; config #5's RootQ W4A4 scheme; calibrated on
    ZOO_CAL images; every weight's bounds spread apart (spread_bounds:
    o_w != 0, the row term on every layer); prepared.  Returns it and
    ZOO_BATCH images."""
    model, x = zoo_train_form("RepVGG_B2g4", device)
    if not train_form:
        model = repvgg_fuse(model)
    attach_scheme(model, scheme_from_dict(
        read_yaml(CONFIGS / f"{R50_CONFIG}.yaml")["quantization"]))
    calibrate(model, [x[:ZOO_CAL]])
    spread_bounds(model, SEED + 5)
    return prepare_deploy(model), x


def zoo_routes_phase(device, parent=None, turns=("window", "conv")):
    """MobileOne-S1's train form in 'int' and RepVGG-B2g4 under RootQ
    W4A4 (train form 'int', deploy form 'intc'): every launch == plain,
    the launches of this slice's routes timed, every module of B2g4's
    forms fed the card's inputs within 1e-4 of its CPU copy, served
    requests; with ``parent`` the window-sum and conv kernels of that tree
    and this one in turns (those of ``turns``).  Returns {route: totals
    with the served launches}."""
    start = t0 = time.perf_counter()
    model = mobileone_train_int(device)
    print(f"# {W4_MODEL} train form: config #4's W4A8 FSPTQ scheme "
          f"(stage0 and the head W8) -> calibrate (batch {CAL_BATCH}) + "
          f"prepare_deploy in {time.perf_counter() - t0:.2f} s; 'int' runs "
          f"every branch: {MOBILEONE_SCALE_BRANCHES} depthwise 1x1 scale "
          "branches")
    x = images(SERVE_BATCH, SEED + 1, device)
    mo = route_launch_phase(f"{W4_MODEL} train", model, x, "int",
                            MOBILEONE_TRAIN_LAUNCHES)
    if mo["dwconv_1x1"]["n"] != MOBILEONE_SCALE_BRANCHES:
        raise RuntimeError(f"{mo['dwconv_1x1']['n']} 1x1 launches, expected "
                           f"{MOBILEONE_SCALE_BRANCHES}")
    request_ms, served = serve_requests(
        f"{W4_MODEL} train", model, x,
        dict(MOBILEONE_TRAIN_LAUNCHES, dwconv_1x1=MOBILEONE_SCALE_BRANCHES),
        CLASSES, on_flip=held_by_modules(f"{W4_MODEL} train", model))
    t = mo["dwconv_1x1"]
    print(f"# {W4_MODEL} train form 'int' request at batch {SERVE_BATCH}: "
          f"{request_ms:.3f} ms; its {t['n']} scale-branch launches "
          f"{t['ms']:.4f} ms against a bound of {t['bound_ms']:.4f} ms "
          f"(bytes: {t['bytes_ms']:.4f}; x{t['ms'] / t['bound_ms']:.2f})")
    del model, x
    routes = {"dwconv_1x1": dict(mo["dwconv_1x1"],
                                 launches=served["dwconv_1x1"])}
    grouped = {}
    for train_form, qmode in ((True, "int"), (False, "intc")):
        t0 = time.perf_counter()
        model, x = b2g4_rootq(device, train_form)
        form = "train" if train_form else "deploy"
        expect = expected_launches(model, qmode)
        print(f"# RepVGG_B2g4 {form} form: config #5's RootQ W4A4 scheme "
              f"-> calibrate ({ZOO_CAL} images) -> spread_bounds -> "
              f"prepare_deploy in {time.perf_counter() - t0:.2f} s; "
              f"{qmode} launches a request {expect}")
        kinds = {k: n for k, n in expect.items() if k in KERNELS}
        tots = route_launch_phase(f"RepVGG_B2g4 {form}", model, x, qmode,
                                  kinds)
        for route in ("window_sum_grouped", "conv_grouped_term"):
            g = grouped.setdefault(route, dict.fromkeys(tots[route], 0.0))
            for key, val in tots[route].items():
                g[key] = max(g[key], val) if key == "err" else g[key] + val
        card_vs_cpu(f"RepVGG_B2g4 {form}", model, x[:ZOO_REF], "int")
        if not train_form:
            _, served = serve_requests(
                "RepVGG_B2g4 deploy RootQ", model, x,
                dict(kinds, conv_grouped=expect["conv_grouped"],
                     window_sum_grouped=expect["window_sum_grouped"]),
                CLASSES, ZOO_REF,
                on_flip=held_by_modules("RepVGG_B2g4 deploy RootQ", model))
            for route, key in (("window_sum_grouped", "window_sum_grouped"),
                               ("conv_grouped_term", "conv_grouped")):
                routes[route] = dict(grouped[route], launches=served[key])
        del model, x
    print(f"# zoo_routes: the two models' legs "
          f"{time.perf_counter() - start:.2f} s")
    routes["chunked"] = chunked_wide_leg(device)
    if parent and {"window", "conv"} & set(turns):
        parent_route_turns(parent, turns)
    return routes


def chunked_wide_leg(device):
    """The zoo_routes phase's (c): a 5x5 conv past the im2col
    rows' 2,048 bytes of K a group in runs of channels; every launch ==
    plain, the launch set timed as a CUDA graph beside its bound.  Returns
    its launches by kind (counts zeroed before, read after)."""
    c = CHUNKED
    gen = torch.Generator().manual_seed(SEED + 7)
    layer = attach_scheme(QConv(c["c"], c["o"], 5, 1, 2, generator=gen),
                          scheme_from_dict(BENCH_SCHEME)).to(device)
    x = torch.rand((c["batch"], c["size"], c["size"], c["c"]),
                   generator=gen).to(device)
    calibrate(layer, [x])
    layer.prepare_deploy()
    zero_counts()
    with torch.inference_mode(), LaunchRecorder() as rec:
        y = layer(x, qmode="int")
    counts = {kind: n for kind, n in engine_counts().items() if n}
    errs = [max_diff_to_plain(kind, a, kw, o) for kind, a, kw, o in rec.calls]
    bound = sum(launch_bound(kind, a, kw, o)[0] for kind, a, kw, o in rec.calls)
    ms = graph_ms(lambda _: run_calls([(KERNELS[kind][0], a, kw)
                                       for kind, a, kw, _ in rec.calls]), 4)
    print(f"# zoo_routes: a 5x5 conv at C = {c['c']} -> {c['o']} "
          f"({25 * c['c']} bytes of K) on ({c['batch']}, {c['size']}, "
          f"{c['size']}): launches {counts}, each == plain (worst "
          f"{max(errs)}); the launch set {ms:.4f} ms against a bound of "
          f"{bound:.4f} ms; output {tuple(y.shape)} finite "
          f"{bool(torch.isfinite(y).all())}")
    if counts != {"im2col": 2, "gemm": 2} or any(errs) \
            or not torch.isfinite(y).all():
        raise RuntimeError("the chunked wide conv failed")
    return counts


def parent_route_turns(root: str, kinds=("window", "conv")):
    """The window-sum kernel at config #5's launches (groups = 1) and the
    conv kernel at RepVGG-A0's (ungrouped), B2g4's, ResNet-50's,
    cifar_resnet18's and config #5's launches, of the tree at ``root`` and
    of this one, in turns (parent, this, this, parent), each run a process
    of its own (tools/window_launches.py, tools/conv_launches.py; ``kinds``
    says which of the two); prints the sums by model and group and this
    tree's over the parent's."""
    tools = {"window": (WINDOW_TOOL, ["--batch", str(ENGINE_BATCH),
                                      "--grouped-batch", "0"]),
             "conv": (CONV_TOOL, ["--batch", str(SERVE_BATCH),
                                  "--grouped-batch", str(ZOO_BATCH),
                                  "--resnet-batch", str(SERVE_BATCH),
                                  "--config5-batch", str(ENGINE_BATCH)])}
    for tool, extra in (tools[k] for k in ("window", "conv") if k in kinds):
        t0 = time.perf_counter()
        runs = []
        with tempfile.TemporaryDirectory() as tmp:
            for tree in (root, str(REPO), str(REPO), root):
                out = pathlib.Path(tmp) / "rows.json"
                run = subprocess.run(
                    [sys.executable, str(tool), "--root", tree, "--json",
                     str(out)] + extra, capture_output=True, text=True)
                if run.returncode != 0:
                    print(run.stdout[-3000:], run.stderr[-3000:],
                          file=sys.stderr)
                    raise RuntimeError(f"{tool.name} on {tree} failed")
                runs.append(json.loads(out.read_text()))
        sums = {}
        for turn, rows in enumerate(runs):
            for r in rows:
                if r.get("ms") is None:
                    continue
                for key in ((r.get("model", ""), r["group"]),
                            (r.get("model", ""), "all")):
                    s = sums.setdefault(key, [[0.0] * 4, [0] * 4, 0.0])
                    s[0][turn] += r["ms"]
                    s[1][turn] += 1
                    s[2] += r.get("bound_ms", 0.0) / 4
        print(f"# {tool.name} on the parent tree {root} and this one in "
              "turns: model group launches | parent this this parent ms | "
              "bound ms | this / parent (launches that a tree refuses are "
              f"left out of its sums); {time.perf_counter() - t0:.1f} s")
        for (model, grp), (ms, n, bound) in sorted(sums.items()):
            ratio = (ms[1] + ms[2]) / (ms[0] + ms[3]) if ms[0] else float(
                "nan")
            print(f"  {model:15s} {grp:18s} {n} | "
                  + " ".join(f"{t:.4f}" for t in ms)
                  + f" | {bound:.4f} | {ratio:.4f}")


def data_probe() -> dict:
    """What the host offers the data layer: CPU count, g++, libjpeg's
    header, PIL; printed."""
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
        header = subprocess.run(
            ["g++", "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
            capture_output=True, text=True).returncode == 0
    except (OSError, IndexError):
        gxx, header = None, False
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    print(f"# data probe: os.cpu_count() {os.cpu_count()}; g++ {gxx}; "
          f"jpeglib.h {'found' if header else 'missing'}; PIL {pil}")
    return {"gxx": gxx, "jpeglib": header, "pil": pil}


def write_cifar10(root: pathlib.Path, seed: int):
    """CIFAR-10's python pickles at full size, seeded random images:
    data_batch_1..5 (10,000 images each) and test_batch (10,000)."""
    rng = np.random.default_rng(seed)
    folder = root / "cifar-10-batches-py"
    folder.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"batch_label": name.encode(),
                 b"data": rng.integers(0, 256, (10000, 3072), np.uint8),
                 b"labels": rng.integers(0, 10, 10000).tolist(),
                 b"filenames": [b"%d.png" % i for i in range(10000)]}
        with open(folder / name, "wb") as f:
            pickle.dump(batch, f, protocol=2)


def data_cifar_leg(device, root: pathlib.Path, card: str):
    """LSQ W4A4 cifar_resnet20 through the QAT entry on written pickles."""
    t0 = time.perf_counter()
    write_cifar10(root, SEED)
    t1 = time.perf_counter()
    trainer = qat_entry.build_trainer(
        training_config(QAT_CONFIGS["lsq"], data_dir=str(root)), device,
        get_logger("qat"))
    loader = trainer.train_loader
    ds = loader.dataset
    print(f"# data: CIFAR-10 pickles (50,000 + 10,000 images) written in "
          f"{t1 - t0:.2f} s; the QAT entry's build_trainer read them and "
          f"calibrated in {time.perf_counter() - t1:.2f} s: {len(ds)} "
          f"images {ds.images.dtype}, {loader.n_samples} after the "
          f"validation split; batch assembly "
          f"{'native' if ds.use_native else 'numpy'}")
    if not (ds.use_native and ds.images.dtype == np.uint8
            and len(ds) == 50000):
        raise RuntimeError("the QAT entry's loader did not read the pickles "
                           "through the native batch assembly")
    # the first batch of the epoch the trainer starts with, against the
    # CPU numpy path on the same draws
    loader.set_epoch(int(trainer.epoch_seeds[0]))
    numpy_path = copy.copy(loader)
    numpy_path.dataset = copy.copy(ds)
    numpy_path.dataset.use_native = False
    (x, y), (xr, yr) = next(iter(loader)), next(iter(numpy_path))
    if not (np.array_equal(x.view(np.uint32), xr.view(np.uint32))
            and np.array_equal(y, yr)):
        raise RuntimeError("the native batch differs from the numpy path's")
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (x, y) in enumerate(loader):
        if i == DATA_STEPS:
            break
        loss, _ = trainer.train_step(*trainer._to_device(x, y))
        losses.append(float(loss))
    torch.cuda.synchronize()
    print(f"# data: {DATA_STEPS} QAT steps on the card from the pickles "
          f"(batch {loader.batch_size}, first batch == the numpy path's bit "
          f"for bit): losses {[round(v, 4) for v in losses]} in "
          f"{time.perf_counter() - t0:.3f} s (the first steps include "
          f"cuDNN's warm-up) on {card}")
    if len(losses) != DATA_STEPS or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"QAT from the pickles: losses {losses}")


def data_jpeg_leg(device, root: pathlib.Path, probe: dict, card: str):
    """The JPEG tree: loader images/s, then RepVGG-A0 calibrated on a
    folder batch and served from ImageNet(data_dir, training=False)."""
    if probe["jpeglib"] and not native.jpeg_available():
        raise RuntimeError("jpeglib.h is there but the native decoder does "
                           f"not build: {native.JPEG.error}")
    t0 = time.perf_counter()
    loaderbench.make_tree(root / "train", DATA_TRAIN_JPEGS, seed=SEED)
    loaderbench.make_tree(root / "val", DATA_VAL_JPEGS, seed=SEED + 1)
    size = sum(p.stat().st_size for p in root.rglob("*.jpg"))
    print(f"# data: JPEG tree of {DATA_TRAIN_JPEGS} + {DATA_VAL_JPEGS} "
          f"random RGB images (quality 85, {size / 2 ** 20:.1f} MiB) "
          f"written in {time.perf_counter() - t0:.2f} s")
    decoders = [False] + ([True] if native.jpeg_available() else [])
    if not native.jpeg_available():
        print("# data: native JPEG decode left out: jpeglib.h missing on "
              "this host; PIL decodes")
    workers = os.cpu_count() or 8
    rates = {}
    for split, train in (("train", True), ("val", False)):
        paths, labels, _ = scan_image_folder(root / split)
        for decode in decoders:
            ds = ImageFolderDataset(paths, labels, SIZE, IMAGENET_MEAN,
                                    IMAGENET_STD, train_augment=train,
                                    num_workers=workers,
                                    native_decode=decode)
            key = (f"{'train' if train else 'eval'} "
                   f"{'libjpeg' if decode else 'PIL'}")
            rates[key] = loaderbench.measure(ds, SERVE_BATCH, train,
                                             DATA_SECONDS)
    print(f"# data: loader images/s at batch {SERVE_BATCH}, {workers} "
          f"decode threads, prefetch 3 (the batch assembly native): "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))

    t0 = time.perf_counter()
    calib = get_dataloader("ImageNet", data_dir=str(root), training=True,
                           batch_size=CAL_BATCH, seed=SEED)
    xcal, _ = next(iter(calib))
    model = get_model("RepVGG_A0", device=device, num_classes=CLASSES,
                      deploy=True, scheme=scheme_from_dict(SCHEME),
                      generator=torch.Generator().manual_seed(SEED))
    calibrate(model, [torch.from_numpy(xcal).to(device)])
    prepare_deploy(model)
    serve = make_serving_fn(model, qmode="intc", device=device, graph=False)
    val = get_dataloader("ImageNet", data_dir=str(root), training=False,
                         batch_size=SERVE_BATCH)
    batches = iter(val)
    x, _ = next(batches)
    batches.close()     # its prefetch thread stops decoding: A0 alone
    print(f"# data: RepVGG-A0 calibrated on a folder batch of {CAL_BATCH} "
          f"(train transform) + prepare_deploy, first val batch in "
          f"{time.perf_counter() - t0:.2f} s")
    xd = torch.from_numpy(x).to(device)
    for _ in range(REPS):       # the card's clocks up after the host's work
        serve(xd)
    zero_counts()
    torch.cuda.synchronize()
    times = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        y = serve(xd)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    alone = K.int8_conv3x3.launches
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = copy.deepcopy(model).cpu()(torch.from_numpy(x[:8]),
                                         qmode="intc")
    rel = rel_l2(y[:8], ref)
    ref_s = time.perf_counter() - t0
    steady = statistics.median(times[1:])
    zero_counts()
    n, batches = 0, 0
    t0 = time.perf_counter()
    for epoch in range(DATA_FED_EPOCHS):
        val.set_epoch(epoch)
        for xb, _ in val:
            out = serve(torch.from_numpy(xb).to(device))
            n, batches = n + len(xb), batches + 1
    torch.cuda.synchronize()
    fed = n / (time.perf_counter() - t0)
    counts = engine_counts()
    print(f"# data: A0 'intc' from the folder: logits {tuple(y.shape)}, vs "
          f"the CPU plain path on 8 images ({ref_s:.2f} s) rel L2 "
          f"{rel:.3e}; conv launches "
          f"{alone} for {REQUESTS} requests, {counts['conv']} for "
          f"{batches} fed batches (other kernels "
          f"{sum(counts.values()) - counts['conv']})")
    print(f"# data: A0 'intc' at batch {SERVE_BATCH}: alone "
          f"{steady * 1e3:.3f} ms a request, {SERVE_BATCH / steady:.1f} "
          f"images/s ({REPS} requests before, to lift the clocks); fed "
          f"by the folder loader (PIL eval decode"
          f"{' or libjpeg' if len(decoders) > 1 else ''}, {DATA_FED_EPOCHS} "
          f"epochs of {len(val.dataset)} images) {fed:.1f} images/s; "
          f"the loader alone: " + ", ".join(
              f"{k} {v:.1f}" for k, v in rates.items()) + f"; {card}")
    if (alone != 22 * REQUESTS or counts["conv"] != 22 * batches
            or y.shape != (SERVE_BATCH, CLASSES)
            or not bool(torch.isfinite(y).all())
            or not bool(torch.isfinite(out).all()) or not rel < 2e-2):
        raise RuntimeError("A0 served from the folder is off")


def data_phase(device, card: str):
    """The data layer on the card's host; see the docstring's ``data``."""
    t0 = time.perf_counter()
    probe = data_probe()
    if not native.available():
        raise RuntimeError(f"the native batch assembly does not build: "
                           f"{native.AUGMENT.error}")
    decoder = (native.library_path("jpegdec.cpp", "-ljpeg")
               if native.jpeg_available()
               else f"not built ({native.JPEG.error.splitlines()[0]})")
    print(f"# data: batch assembly "
          f"{native.library_path('augment.cpp', '-lpthread')}; JPEG decoder "
          f"{decoder}")
    with tempfile.TemporaryDirectory() as tmp:
        data_cifar_leg(device, pathlib.Path(tmp) / "cifar", card)
        if probe["pil"] is None:
            print("# data: the JPEG leg is left out: PIL is missing (it "
                  "writes the tree)")
        else:
            data_jpeg_leg(device, pathlib.Path(tmp) / "imagenet", probe,
                          card)
    print(f"# data: phase {time.perf_counter() - t0:.2f} s")


def kernel_entry(name, replaces, launches, tot, library_ms,
                 source=None):
    return {"name": name, "route": "cuda",
            "source": source or f"dlmc_quant_torch/ops/cuda/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": bound_by(tot["ops_ms"], tot["bytes_ms"]),
            "library_ms": library_ms}


def main(argv=None) -> int:
    cli = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli.add_argument("--parent", default=None,
                     help="another tree (e.g. an archive of the parent "
                          "commit) whose depthwise, window-sum and im2col "
                          "kernels are timed beside this one's at every "
                          "launch of theirs, whose stem + pool with the "
                          "first block's two codes beside this one's, and "
                          "whose window-sum, conv and GEMM kernels in turns "
                          "with this one's")
    cli.add_argument("--turns", default=",".join(TURN_KINDS),
                     help="with --parent, the kernels timed beside the "
                          "parent's, comma-separated: "
                          + ", ".join(TURN_KINDS) + " (default: all)")
    args = cli.parse_args(argv)
    turns = set(args.turns.split(",")) if args.parent else set()
    if turns - set(TURN_KINDS):
        cli.error(f"--turns takes {', '.join(TURN_KINDS)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    build.build(*build.SOURCES, verbose=True)
    print(f"# build: {time.perf_counter() - t0:.2f} s")
    card_tests()
    print("# int8_gemm dynamic shared memory by tile (BM x BN: stages, "
          "bytes): " + ", ".join(
              f"{bm}x{bn}: {G.TILE_STAGES[bm, bn]}, "
              f"{G.tile_smem_bytes((bm, bn))}" for bm, bn in G.TILES))
    print(f"# int8_mma_probe dynamic shared memory: 3-4 stages of (rolls + "
          f"nbufs) tiles of 8192 bytes, at most {P.MAX_TILES} tiles a stage, "
          f"{G.MAX_SMEM} bytes a block")

    t0 = time.perf_counter()
    model = get_model("RepVGG_A0", device=device, num_classes=CLASSES,
                      deploy=True, scheme=scheme_from_dict(SCHEME),
                      generator=torch.Generator().manual_seed(SEED))
    calibrate(model, [images(CAL_BATCH, SEED, device)])
    prepare_deploy(model)
    print(f"# model: RepVGG-A0 deploy form, calibrate (batch {CAL_BATCH}) + "
          f"prepare_deploy in {time.perf_counter() - t0:.2f} s")

    err8 = kernel_phase(model, 8, device)["err"]
    tot = kernel_phase(model, SERVE_BATCH, device)
    launches = serve_phase(model, device, card)
    recon_launches, recon_err = recon_phase(device, card)
    launches += recon_launches

    t0 = time.perf_counter()
    resnet = resnet18_deployed(device)
    print(f"# resnet18: train form -> resnet_deploy -> config #1 scheme -> "
          f"calibrate (batch {SERVE_BATCH}) + prepare_deploy in "
          f"{time.perf_counter() - t0:.2f} s")
    res_err = max(resnet_kernel_phase(
        "resnet18", resnet, cifar_images(b, SEED + 1, device),
        RESNET18_LAUNCHES)["err"] for b in (8, SERVE_BATCH))
    served = resnet_serve_phase(resnet, device)
    del resnet
    ptq_convs, ptq_gemms = ptq_phase()

    t0 = time.perf_counter()
    r50 = resnet50_deployed(device)
    print(f"# resnet50: train form -> resnet_deploy -> bench W8A8 scheme -> "
          f"calibrate (batch {CAL_BATCH}) + prepare_deploy in "
          f"{time.perf_counter() - t0:.2f} s")
    r50_err = resnet_kernel_phase("resnet50", r50, images(8, SEED + 1, device),
                                  RESNET50_LAUNCHES)["err"]
    t0 = time.perf_counter()
    r50_tot = resnet_kernel_phase("resnet50", r50,
                                  images(SERVE_BATCH, SEED + 1, device),
                                  RESNET50_LAUNCHES, gemm_groups=True)
    print(f"# resnet50 kernel phase at batch {SERVE_BATCH}: "
          f"{time.perf_counter() - t0:.2f} s")
    if "gemm" in turns:
        t0 = time.perf_counter()
        parent_gemm_turns(args.parent)
        print(f"# int8_gemm in turns with the parent: "
              f"{time.perf_counter() - t0:.2f} s")
    windows = parent_window_ms(args.parent) if "window" in turns else None
    im2col_launches, im2col = stem_im2col_phase(
        r50, images(SERVE_BATCH, SEED + 1, device), windows)
    modes_err = stem_modes_phase(r50, images(SERVE_BATCH, SEED + 1, device))
    served50 = resnet50_serve_phase(
        r50, device, parent_stem_ms(args.parent) if "stem" in turns else None)
    t0 = time.perf_counter()
    engine = serving_phase(device, card, r50)
    print(f"# serving phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    axis = model_axis_phase(card)
    print(f"# model_axis phase: {time.perf_counter() - t0:.2f} s")
    del r50
    parent = parent_dw_turns(args.parent) if "dw" in turns else None
    mobile_err, dw, mobile_served, w8 = mobile_phase(device, parent)
    t0 = time.perf_counter()
    w4_err, w4_served = w4_phase(device, w8)
    c4_launches, c4_err = config4_phase(device)
    print(f"# w4 phases: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    zoo_grouped, zoo_launches, zoo_err = zoo_phase(device)
    print(f"# repvgg_zoo phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ghost_dw, ghost_served = ghost_effnet_phase(device)
    print(f"# ghost_effnet phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    routes = zoo_routes_phase(device, args.parent, turns)
    print(f"# zoo_routes phase: {time.perf_counter() - t0:.2f} s")
    data_phase(device, card)
    t0 = time.perf_counter()
    observers_phase(device)
    print(f"# observers phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    c2_launches, c2_err = config2_phase()
    print(f"# config2 phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    qat_launches, qat_err, r20_trainer, r50_trainer = qat_phase(device)
    print(f"# qat phase: {time.perf_counter() - t0:.2f} s")
    rootq, rootq_err, window, rootq_dw = rootq_serve_phase(
        device, card, r20_trainer, r50_trainer, windows)
    del r20_trainer, r50_trainer
    acc_launches, acc_err = accuracy_phase(device, card)
    t0 = time.perf_counter()
    lockstep_leg()
    distributed_phase(device)
    print(f"# lockstep + distributed phases: {time.perf_counter() - t0:.2f}"
          f" s")
    launches += (served["conv"] + ptq_convs + served50["conv"] + qat_launches
                 + mobile_served["conv"] + w4_served["conv"]
                 + c2_launches["conv"] + acc_launches + engine["conv"]
                 + rootq["conv"] + zoo_launches + ghost_served["conv"]
                 + axis["conv"])
    tot["err"] = max(err8, tot["err"], recon_err, res_err, r50_err,
                     r50_tot["err"], qat_err, mobile_err, w4_err, c2_err,
                     acc_err, rootq_err, zoo_err)
    stem = dict(r50_tot["stem_pool"], err=max(r50_err, r50_tot["err"],
                                              modes_err, w4_err))

    gemm_rows, gemm_launches = tool_path(gemm_sweep.main, G.int8_gemm,
                                         "gemm_sweep")
    gemm_launches += (served["gemm"] + ptq_gemms + served50["gemm"]
                      + mobile_served["gemm"] + w4_served["gemm"]
                      + c4_launches["gemm"] + c2_launches["gemm"]
                      + engine["gemm"] + rootq["gemm"] + ghost_served["gemm"]
                      + axis["gemm"] + routes["chunked"]["gemm"])
    gemm_err = max(w4_err, c4_err, c2_err, rootq_err)
    probe_rows, probe_launches = tool_path(lambda: mma_probe.main([]),
                                           P.int8_mma_probe, "mma_probe")
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    gemm_tot = exact_phase(
        "int8_gemm (default tile)", [r for r in gemm_rows if r["default"]],
        lambda row: gemm_calls(row, gen))
    probe_tot = exact_phase("int8_mma_probe", probe_rows,
                            lambda row: probe_calls(row, gen))
    gemm_tot["err"] = max(gemm_tot["err"], gemm_err, r50_tot["gemm"]["err"])
    # the kernels line's int8_gemm: the sweep's shapes and ResNet-50's 36
    # launches at batch SERVE_BATCH (library ms: torch._int_mm where it
    # computes the same function, the sweep's and the 4 int32 launches)
    for key in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
                "library_ms"):
        gemm_tot[key] += r50_tot["gemm"][key]

    print(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        kernel_entry("int8_conv3x3", "dlmc_quant_tpu/ops/pallas/rpconv.py:200",
                     launches, tot, None),
        kernel_entry("int8_gemm", "tools/pallas_gemm_sweep.py:37",
                     gemm_launches, gemm_tot, gemm_tot["library_ms"]),
        kernel_entry("int8_mma_probe", "tools/vmem_gemm_probe.py:33",
                     probe_launches, probe_tot, probe_tot["library_ms"]),
        kernel_entry("int8_im2col", "dlmc_quant_tpu/quant/layers.py:721-728",
                     im2col_launches + engine["im2col"] + axis["im2col"]
                     + routes["chunked"]["im2col"], im2col, None),
        kernel_entry("int8_stem_pool",
                     "dlmc_quant_tpu/quant/layers.py:721-728 + "
                     "dlmc_quant_tpu/quant/chain.py:135",
                     served50["stem_pool"] + w4_served["stem_pool"]
                     + engine["stem_pool"] + axis["stem_pool"], stem,
                     None),
        kernel_entry("int8_dwconv3x3",
                     "dlmc_quant_tpu/quant/layers.py:722-728 (XLA grouped "
                     "int8 conv, feature_group_count=C; no Pallas kernel)",
                     mobile_served["dwconv"] + w4_served["dwconv"]
                     + c4_launches["dwconv"] + c2_launches["dwconv"]
                     + ghost_served["dwconv"] - ghost_served["dwconv_5x5"]
                     - ghost_served["dwconv_ragged"],
                     dict({key: dw[key] + ghost_dw["aligned"][key]
                           for key in ("ms", "plain_ms", "bound_ms",
                                       "ops_ms", "bytes_ms")},
                          err=max(dw["err"], w4_err, c4_err, c2_err,
                                  rootq_dw[0])),
                     None),
        kernel_entry("int8_dwconv5x5",
                     "dlmc_quant_tpu/quant/layers.py:722-728 (XLA grouped "
                     "int8 conv, feature_group_count=C, 5x5 window; no "
                     "Pallas kernel)",
                     ghost_served["dwconv_5x5"], ghost_dw["5x5"], None),
        kernel_entry("int8_dwconv_ragged",
                     "dlmc_quant_tpu/quant/layers.py:722-728 (XLA grouped "
                     "int8 conv, feature_group_count=C, 3x3 at C % 8 != 0; "
                     "no Pallas kernel)",
                     ghost_served["dwconv_ragged"], ghost_dw["ragged"], None,
                     source="dlmc_quant_torch/ops/cuda/csrc/"
                            "int8_dwconv5x5.cu"),
        kernel_entry("int8_window_sum",
                     "dlmc_quant_tpu/quant/layers.py:459 (the integer plan "
                     "drops o_w, hazard C1; no Pallas kernel)",
                     rootq["window_sum"], window, None),
        kernel_entry("int8_conv3x3_grouped",
                     "dlmc_quant_tpu/quant/layers.py:721-728 (XLA grouped "
                     "int8 conv, feature_group_count=G; no Pallas kernel)",
                     zoo_grouped["launches"], zoo_grouped, None,
                     source="dlmc_quant_torch/ops/cuda/csrc/"
                            "int8_conv3x3_grouped.cu"),
        kernel_entry("int8_dwconv1x1",
                     "dlmc_quant_tpu/quant/layers.py:722-728 (XLA grouped "
                     "int8 conv, feature_group_count=C, 1x1 window: "
                     "MobileOne's scale branch; no Pallas kernel)",
                     routes["dwconv_1x1"]["launches"], routes["dwconv_1x1"],
                     None, source="dlmc_quant_torch/ops/cuda/csrc/"
                                  "int8_dwconv.cuh"),
        kernel_entry("int8_window_sum_grouped",
                     "dlmc_quant_tpu/quant/layers.py:459 (the integer plan "
                     "drops o_w, hazard C1; no Pallas kernel)",
                     routes["window_sum_grouped"]["launches"],
                     routes["window_sum_grouped"], None,
                     source="dlmc_quant_torch/ops/cuda/csrc/"
                            "int8_window_sum.cu"),
        kernel_entry("int8_conv3x3_grouped_term",
                     "dlmc_quant_tpu/quant/layers.py:721-728 (XLA grouped "
                     "int8 conv, feature_group_count=G; the term: "
                     "dlmc_quant_tpu/quant/layers.py:459, hazard C1; no "
                     "Pallas kernel)",
                     routes["conv_grouped_term"]["launches"],
                     routes["conv_grouped_term"], None,
                     source="dlmc_quant_torch/ops/cuda/csrc/"
                            "int8_conv3x3_grouped.cu")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

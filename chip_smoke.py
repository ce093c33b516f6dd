#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py            # T=2 separation (the default check)
    python3 chip_smoke.py --full     # also the full T=100 separations

Phases, each printed on its own lines; any failure raises (exit != 0):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 is turned off for cuDNN convs and matmuls so float32
   comparisons are float32;
2. build of the CUDA kernels from ``audiosourcesep_tpu_torch/csrc``, with
   ptxas' registers, spills and shared memory of each kernel (a spill in
   an instance of the f32 kernel's thin paths fails the phase);
3. both Winograd kernels (bf16 on the tensor cores, f32 on the CUDA
   cores) against their plain PyTorch version and F.conv2d at every conv
   class the NCSN v1 forward routes to them (batch 30), with errors, times
   and each class's bound (the least time the card could take), the bf16
   kernel's ptxas report (a spill fails the phase), each class's producer
   path and the host time of one launch; the f32 kernel's thin paths
   (``ops.winograd.f32_path``: begin_conv 1->192 ``thin_in``, end_conv
   192->1 ``thin_out``) beside the wide kernel forced on the same class;
   then the
   dilated route (the kernels on the d*d phase grids) at the cascade's
   dilated convs, 48x32 384->384 at d = 2 and 4 (one launch per conv,
   the phases read and written in place), against its plain version and
   the dilated F.conv2d; and the bf16 kernel above the dilations its
   TMA element stride reaches, 96x64 192->192 at d = 8 (batch 30) and
   d = 16 (batch 4), one launch each on its TMA path, with its time and
   F.conv2d's beside the card's name and power limit;
4. the full-width v1 score network (192 filters, ``[30, 96, 64, 1]``,
   random weights) with Winograd routing on and off, in bf16 and in f32
   (TF32 off, the CLIs' default ``--compute_dtype``);
5. the separation CLI in-process (``run_basis_sep.main``) on ~70 s of
   synthetic piano/violin wavs with two random-init priors written as
   JAX-format checkpoints: 30 frames, 10 noise levels, ``--winograd``,
   T=2 in bf16 with ``--inverse`` (sep1/sep2.wav) and T=1 in f32; each run
   must launch its dtype's kernel exactly 2 models x 10 levels x T x routed
   convs per forward times and the other kernel never (so ``nn.conv2d``
   routed no dilated conv), the bf16 kernel on its producer paths and the
   f32 kernel on its paths (2 thin, 62 wide a forward);
6. the inversion CLI (``melspec_inversion_basis.main``) on the card on the
   bf16 run's ``results.npz`` in three modes (reuse_phase with the Wiener
   filter, reuse_phase over the whole track, griffin), launching no
   kernel; ``mel_to_stft`` on the card, with TF32 switched on around it,
   against a float64 run on the CPU (and, as a control, the same solve in
   TF32); and the ground-truth Wiener inversion scored with the port's
   ``bss_eval`` against the raw stems, held to the JAX package's numbers
   on the same song (``benchmarks/jax_ground_truth_sdr.py``);
7. NCSN training at full width (v1, 192 filters, 10 levels, f32, TF32
   off): (a) ``wav_to_spec.main`` turns phase 5's wavs into a TFRecord
   dataset on the card (piano and violin to ``train/``, the mix to
   ``test/``); (b) one Adam train step at batch 2 on the card and on the
   CPU from the same init and the same injected sigma indices and noise;
   (c) two steps at batch 32 with Winograd routing on and off (the second
   step's loss shows that the cached U followed the first optimizer
   step; 64 f32 launches per forward, no bf16 one), with the step's time
   split into forward, backward and optimizer, routing off and on, and
   with TF32 on (PyTorch's default, which the training CLI keeps); (d) the
   training CLI (``train_ncsn.main``, ``--ema``, one epoch, a T=1 Langevin
   snapshot) and ``ncsn_generate_samples.main`` on its checkpoint, both
   with routing on, each launching the f32 kernel exactly 64 times per
   forward it runs; the checkpoint holds the JAX train state's keys and
   ``restore_ncsn_params(ema=True)`` loads it.
8. the Glow prior at the width of ``configs/melspec_glow.yml`` (L=3, K=40,
   512 filters, learntop, f32, TF32 off unless said): (a) the f32 kernel
   at the coupling nets' six 3x3 conv classes on its paths (five thin,
   8->512 wide), at batch 30 and at the chunks of 8 and 6 frames that
   ``--score_chunk 8`` scores, each launched once on its path, against
   its plain version and F.conv2d, with times and bounds, and the wide
   kernel forced on each thin class; the host time of a thin launch; the
   1x1 512->512 conv as a matmul against F.conv2d; (b) log p and the score of 2 frames on
   the card against the CPU; (c) the score of 30 frames routed against
   cuDNN, 240 f32 launches per forward; (d) one Adamax step at batch 2 on
   the card against the CPU, then the step at batch 32 split into
   forward, backward and optimizer, TF32 off (routing off and on) and on,
   against its bound; (e) ``train_glow`` (one epoch on phase 7's dataset)
   -> ``train_noisy_glow`` (2 levels, 10 with ``--full``) ->
   ``run_basis_sep --model_type glow --winograd`` (T=2) at
   ``--score_chunk 8`` and ``0``, with the f32 kernel's launches (80
   ``thin_in``, 120 ``thin_out`` and 40 ``wide`` a forward),
   ``Duration`` and the peak memory (``--full`` adds T=100 at ``0``).
9. the image path, on random uint8 images written in the MNIST and
   CIFAR-10 npz layouts (``ASR_MNIST_NPZ`` / ``ASR_CIFAR10_NPZ``): (a) both
   kernels at the image NCSN's conv classes (32x32 and 16x16, batch 50)
   and at Flow++'s (32x16, 16x16, 16x8, batch 64) against their plain
   version and F.conv2d, with times and bounds, the f32 kernel's thin
   classes beside the wide kernel forced on them, and the f32 kernel at
   the image Glow's six classes (16x16, 8x8, 4x4) in the chunks of 8 and
   2 images that (e) scores; (b) ``train_ncsn
   --dataset mnist`` (v1, 192 filters, routing on) ->
   ``ncsn_generate_samples`` -> ``run_basis_sep --dataset mnist
   --winograd`` at 50 mixtures, T=2, in bf16 and f32 (``--full`` adds
   T=100), each launching its kernel 64 times a forward; (c) RealNVP (32
   filters, 4 blocks): log p card vs CPU, the Adam step at batch 256
   against its bound, one epoch of ``train_realnvp``; (d) Flow++ at
   ``build_flowpp``'s defaults on [32, 32, 3]: log p card vs CPU and routed
   vs cuDNN (131 launches a forward), the bisection inverse on the card,
   the train step (Adam, clip 1) at batch 64 routing off and on, with
   peak memory and bound; (e) ``train_glow --dataset mnist`` (L=3, K=32,
   512 filters) -> ``train_noisy_glow`` -> ``run_basis_sep --model_type
   glow --dataset mnist --winograd`` at 50 mixtures, with the f32
   kernel's launches by path.
10. several processes on the one card (gloo, since NCCL refuses two ranks
   on one device; every rank of a phase on ``cuda:0``): (a)
   ``run_basis_sep --shard_sources`` under ``torchrun --nproc_per_node 2``
   with phase 5's priors (NCSN v1, 192 filters, 30 frames, 10 levels,
   T=2, bf16, ``--winograd``): the ranks launch the bf16 kernel 2 x 10 x 2
   x 64 times between them, as phase 5, and its ``results.npz`` holds to
   phase 5's; (b) the same with the frames sharded (each rank both priors,
   15 frames), and, in this process, each 15-frame half of phase 5's
   separation alone with the draws of the whole, which the ranks hold to;
   (c) ``train_ncsn --multihost``: with ``--num_processes 1``
   over NCCL as phase 7d (the same losses), and on 2 processes over gloo
   against one process on the same global batches, rank 0 alone writing
   checkpoints; (d) ``dryrun_multichip(2)`` on the card,
   and ``technique1_ncsnv2`` on 2,000 synthetic spectrograms against
   float64. 10a prints the mixing ``all_gather``'s time a step and 10c
   the train steps' and their gradient all-reduces' (ranks sharing the
   card).

Then one JSON line of per-kernel results, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository around this file, it exits non-zero and prints no result.
"""

import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# routed conv classes of one v1 forward at [96, 64, 1], 192 filters:
# (H, W, C_in, C_out) -> convs per forward (begin_conv and end_conv included)
CONV_CLASSES = {
    (96, 64, 1, 192): 1, (96, 64, 192, 192): 18, (96, 64, 192, 384): 1,
    (96, 64, 192, 1): 1, (48, 32, 384, 384): 32, (48, 32, 384, 192): 2,
    (48, 32, 192, 192): 9,
}
ROUTED_PER_FORWARD = sum(CONV_CLASSES.values())          # 64 of 75 convs
# the cascade's dilated 3x3 convs of one forward, all 48x32 384->384:
# dilation -> convs per forward (not routed; the dilated route's class)
DILATED_CLASS = (48, 32, 384, 384)
# the class whose host time of one launch phase 3 prints
HOST_CLASS = (48, 32, 384, 384)
# the bf16 kernel's design, for the kernels line
BF16_DESIGN = ("wgmma m64n64k16 (A = V from registers, B = U from shared "
               "memory), TMA loads of x and U into a 4-stage mbarrier ring "
               "from a producer warpgroup, two consumer warpgroups with "
               "A^T's rows folded (setmaxnreg 224/56), persistent blocks")
DILATED = {2: 5, 4: 5}
# the bf16 kernel above d = 4, where its x tensor map addresses groups of
# 2d pixels: dilation -> (batch, H, W, C_in, C_out), one conv each
WIDE_DILATED = {8: (30, 96, 64, 192, 192), 16: (4, 96, 64, 192, 192)}
BATCH = 30
# kernel vs plain version: (max|err| / max|plain|, mean|err| / mean|plain|,
# max|err| vs F.conv2d / max|plain|). f32 differs only in summation order.
# The bf16 kernel rounds U and V to bf16 as the JAX Pallas kernel does; that
# kernel itself differs from the plain version by up to 8.8e-3 max and
# 4.7e-3 mean (tests/test_torch_winograd.py pins it under 2e-2 and 1e-2).
# F.conv2d (direct, cuDNN) adds its own order and rounding.
TOL = {"float32": (1e-4, 1e-4, 1e-4), "bfloat16": (2e-2, 1e-2, 3e-2)}
# routed vs cuDNN forward, mean|diff| / mean|off|; f32 differs only in
# summation order
MODEL_TOL = {"bfloat16": 0.05, "float32": 1e-3}
# published H100 SXM peaks: bf16 dense tensor cores, f32 CUDA cores (FLOP/s)
PEAK = {"bfloat16": 989e12, "float32": 67e12}
HBM = 3.35e12      # bytes/s
SOURCES = {"bfloat16": "audiosourcesep_tpu_torch/csrc/winograd_mma.cu",
           "float32": "audiosourcesep_tpu_torch/csrc/winograd.cu"}
# the f32 kernel's designs (ops.winograd.f32_path): the source, the C entry
# and the __global__ kernel of each
F32_PATHS = {
    "wide": ("audiosourcesep_tpu_torch/csrc/winograd.cu",
             "winograd_f23_fwd_f32", "winograd_f23_f32_kernel"),
    "thin_in": ("audiosourcesep_tpu_torch/csrc/winograd_thin.cu",
                "winograd_f23_fwd_f32_thin",
                "winograd_f23_f32_thin_in_kernel"),
    "thin_out": ("audiosourcesep_tpu_torch/csrc/winograd_thin.cu",
                 "winograd_f23_fwd_f32_thin",
                 "winograd_f23_f32_thin_out_kernel"),
}
# mel_to_stft on the card (f32) against float64 on the CPU: max|err| /
# max|ref| and mean|err| / mean|ref| of the NNLS power. f32 on the CPU
# lands 3.4e-4 / 2.3e-4 from float64 on this song's ground truths.
NNLS_TOL = (1e-3, 1e-3)
# ground-truth Wiener inversion of this script's song, per source: SDR and
# SIR (dB) of the JAX package on the CPU (benchmarks/jax_ground_truth_sdr.py;
# the port on the CPU gives the same to 1e-3 dB). The card must come within
# GT_TOL dB of each, above or below.
JAX_SDR = (6.0076, 6.0152)
JAX_SIR = (52.2431, 49.9401)
GT_TOL = {"SDR": 0.1, "SIR": 1.0}
N_FFT, HOP = 2048, 512
# phase 7: card vs CPU train step in f32 (TF32 off), each as ||diff|| /
# ||CPU|| over all tensors: the loss, the gradients, and the params after
# one Adam step at lr 1e-3. Adam's first step moves every weight by at
# most lr, so an element whose gradient sits at the f32 noise floor can
# move differently by up to 2 lr (max|diff| is printed, not held); a
# wrong update moves most weights by ~lr, ||diff|| / ||p|| ~ 3e-2
TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3, "param": 1e-3}
TRAIN_BATCH = 32
# bench.py:137: 7.728 TFLOP per v1 forward at batch 30; a train step is
# about 3 forwards (the backward computes two products per conv)
FWD_TFLOP_30 = 7.728
TF32_PEAK = 495e12
# a raw ground-truth window and its inversion (HOP * 63), in samples
W_RAW, W_INV = 32640, HOP * 63
# phase 8, Glow at the width of configs/melspec_glow.yml: L=3, K=40, 512
# filters, learntop, [96, 64, 1] mel patches in dB. The coupling nets' 3x3
# convs are the routed classes, (H, W, C_in, C_out) -> convs per forward
GLOW = {"L": 3, "K": 40, "n_filters": 512}
GLOW_CLASSES = {
    (48, 32, 2, 512): 40, (48, 32, 512, 4): 40,
    (24, 16, 4, 512): 40, (24, 16, 512, 8): 40,
    (12, 8, 8, 512): 40, (12, 8, 512, 16): 40,
}
GLOW_ROUTED = sum(GLOW_CLASSES.values())                 # 240 per forward
# card vs CPU and routed vs cuDNN, ||diff|| / ||ref|| of log p and of the
# score (f32, TF32 off; the flow's 120 steps only reorder sums)
GLOW_TOL = 1e-4
# the coupling nets' last conv is zero at init (each coupling starts as
# the identity): phase 8 draws it from N(0, GLOW_CONV3_STD^2) so that the
# couplings, and the routed conv3, do work (|log_s| ~ 0.03)
GLOW_CONV3_STD = 1e-3
# phase 9, the image path. The image NCSN (v1, 192 filters, 10 levels) on
# [32, 32, 1] separates n_mixed 50 (benchmarks/bench_image_basis.py:82);
# its routed classes, (H, W, C_in, C_out) -> convs per forward
IMG_BATCH = 50
IMAGE_CLASSES = {
    (32, 32, 1, 192): 1, (32, 32, 192, 192): 18, (32, 32, 192, 384): 1,
    (32, 32, 192, 1): 1, (16, 16, 384, 384): 32, (16, 16, 384, 192): 2,
    (16, 16, 192, 192): 9,
}
# Flow++ at build_flowpp's defaults (Ho et al.'s CIFAR-10 configuration),
# [32, 32, 3], batch 64: the routed 3x3 convs of one forward: the
# dequantisation's processor (its conv and 3 gated convs, whose GLUs are
# convs), then per coupling net conv_in, each block's gated conv1 and
# conv_out (4 dequantisation couplings of 2 blocks, then 4 + 2 + 3 flow
# couplings of 10)
FLOWPP = {"n_components": 32, "n_blocks_flow": 10, "n_blocks_dequant": 2,
          "filters": 96, "heads": 4}
FLOWPP_BATCH = 64
FLOWPP_CLASSES = {
    (32, 16, 6, 32): 1, (32, 16, 64, 32): 3, (32, 16, 64, 64): 3,
    (32, 16, 3, 96): 8, (32, 16, 192, 96): 48, (32, 16, 96, 294): 8,
    (16, 16, 6, 96): 2, (16, 16, 192, 96): 20, (16, 16, 96, 588): 2,
    (16, 8, 12, 96): 3, (16, 8, 192, 96): 30, (16, 8, 96, 1176): 3,
}
FLOWPP_ROUTED = sum(FLOWPP_CLASSES.values())             # 131 per forward
# ||diff|| / ||ref|| of Flow++'s log p at build_flowpp's own init: card vs
# CPU in f32, where f32 log p lands 1e-7 from float64 on both devices
# (phase 9d prints it); routed vs cuDNN, where the Winograd transforms'
# f32 rounding over 131 convs gave 5.3e-5 (6.5e-5 to 8.6e-5 at a scaled
# init, from run to run); card vs CPU in float64 (summation order only)
FLOWPP_TOL = 1e-4
FLOWPP_ROUTED_TOL = 2e-4
FLOWPP_F64_TOL = 1e-9
# RealNVP at train_realnvp's defaults, and its batch
REALNVP = {"n_filters": 32, "n_blocks": 4}
REALNVP_BATCH = 256
# the image Glow of train_glow's defaults, trained at batch 64
IMAGE_GLOW = {"L": 3, "K": 32, "n_filters": 512}
IMAGE_GLOW_BATCH = 64
# its coupling nets' 3x3 convs on [32, 32, 1] (MNIST padded), (H, W, C_in,
# C_out) -> convs per forward
IMAGE_GLOW_CLASSES = {
    (16, 16, 2, 512): 32, (16, 16, 512, 4): 32,
    (8, 8, 4, 512): 32, (8, 8, 512, 8): 32,
    (4, 4, 8, 512): 32, (4, 4, 512, 16): 32,
}
IMAGE_GLOW_ROUTED = sum(IMAGE_GLOW_CLASSES.values())      # 192 a forward
# image-scale noise levels (span 256) and the step of the [0, 1] schedule
# scaled to it (2e-5 * 256^2)
IMAGE_SIGMAS = ["--sigma1", "256.0", "--sigmaL", "2.56", "--progression",
                "logarithmic"]
IMAGE_STEP_LR = str(2e-5 * 256.0 ** 2)
# phase 10, the ranks' separations against phase 5's run, (max, mean)
# |diff| in dB of x1 and x2 (a wrong layout is tens of dB off). The ranks
# run with this process's CPU thread count (_worker_env), so the mixture
# they prepare on the CPU is phase 5's bit for bit (MULTI_DATA_TOL; with
# another thread count the f32 front end rounds otherwise, 8.4e-5 dB in
# one run). With --shard_sources the same kernels then see the same 30
# frames a model: 1e-3 dB max, the bound written before the first run
# (the mean is within it too). The layout alone, on the same inputs, is
# held to 1e-6 by tests/test_torch_cuda.py.
MULTI_DATA_TOL = 0.0
MULTI_SRC_TOL = (1e-3, 1e-3)
# frames sharded: each rank's forwards see 15 frames, not 30, and a
# forward's rounding depends on its batch (10b reads it in one process:
# each half alone, held to the ranks at MULTI_SRC_TOL, and one forward at
# 15 frames against the same frames at 30). The readings of that batch
# effect, 0.048 max and 0.0033 mean (10b, 2 ranks), set this bound.
MULTI_FRAMES_TOL = (0.2, 1e-2)
# the train steps' times of phase 7d, beside which 10c prints its own
STEP_TIMES = {}
# technique 1: the f32 Gram distance on the card against float64 on the
# CPU, relative
TECH1_TOL = 1e-4


def fail(msg: str, code: int = 2):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()`` (ms): ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between two events, so that the
    host's time per call (the wrapper, the enqueue) leaves no gaps between
    the launches. ``cuda_ms`` times the calls as a caller makes them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[1] nvidia-smi: {smi}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[1] TF32 off for cuDNN convs and matmuls (f32 parity phases)")
    return smi


def phase_build():
    from audiosourcesep_tpu_torch.kernels import build
    t0 = time.time()
    so = build.build()
    lib = build.load_library()
    print(f"[2] kernels built/loaded in {time.time() - t0:.2f} s: "
          f"{os.path.relpath(so, HERE)}")
    for line in build.build_log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill",
                                   "Potential Performance Loss")):
            print(f"[2] ptxas: {line.strip()}")
    for name in build.SIGNATURES:
        if name.endswith("_smem_bytes"):
            print(f"[2] {name}: {getattr(lib, name)()} bytes of dynamic "
                  f"shared memory per block")
    thin = _ptxas_report(build.build_log, "winograd_f23_f32_thin")
    if len([ln for ln in thin if ln.startswith("Compiling")]) != 3 \
            or any(_spills(ln) for ln in thin):
        raise AssertionError(f"the f32 kernel's thin instances are missing "
                             f"from ptxas' report or spill: {thin}")


def conv_bound(h, w, cin, cout, dname, batch=BATCH):
    """Least time (ms) of one routed conv at ``batch``, and what sets it:
    the transform-domain work (16 * tiles * C_in * C_out multiply-adds) at
    the dtype's peak, or x, y and U moved once at the HBM rate. A dilated
    conv of the same shape has the same tiles (on its phase grids), so the
    same bound."""
    item = 2 if dname == "bfloat16" else 4
    flops = 2 * 16 * batch * (h // 2) * (w // 2) * cin * cout
    nbytes = item * (batch * h * w * (cin + cout) + 16 * cin * cout)
    t_ops, t_bytes = flops / PEAK[dname], nbytes / HBM
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def _new_result():
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "max_abs_err": 0.0, "by": {"operations": 0.0, "bytes": 0.0},
            "paths": {}, "wide_ms": 0.0, "device_ms": 0.0,
            "wide_device_ms": 0.0, "library_device_ms": 0.0, "by_path": {}}


def _has_thin(r) -> bool:
    """Whether a route's classes include one on the f32 kernel's thin
    paths (whose ``wide_ms`` then times the wide kernel forced on it)."""
    return any(p.startswith("thin") for p in r.get("paths", {}).values())


def _hold(r, label, dname, n, shape, run_kernel, run_plain, run_conv,
          tag="[3]", batch=BATCH, path=None, run_wide=None):
    """Run one conv class through the kernel, its plain version and
    F.conv2d on the same inputs; check the kernel's agreement, time all
    three, and add ``n`` times each to the route's result ``r``. ``path``
    (the bf16 kernel's producer path, or the f32 kernel's design, for this
    class) goes into ``r["paths"]``. ``run_wide`` (a thin class of the f32
    kernel) runs the wide design on the same inputs: held to the plain
    version too, timed, and its ms (the kernel's where it is None) added
    to ``r["wide_ms"]``. f32 classes also take device times (``graph_ms``:
    no host time between launches) of the kernel, the wide design and
    F.conv2d, into ``r["device_ms"]``, ``r["wide_device_ms"]`` and
    ``r["library_device_ms"]``, and the kernel's numbers also into
    ``r["by_path"][path]``, so that each design's source has its own.
    Returns the kernel's and F.conv2d's ms."""
    import torch
    tol_max, tol_mean, tol_conv = TOL[dname]
    y, ref, conv = run_kernel().float(), run_plain().float(), run_conv()
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise AssertionError(f"non-finite kernel output {label} {dname}")
    scale = ref.abs().max().item()
    e_plain = (y - ref).abs().max().item()
    e_mean = ((y - ref).abs().mean() / ref.abs().mean()).item()
    e_conv = (y - conv.float()).abs().max().item()
    r["max_abs_err"] = max(r["max_abs_err"], e_plain)
    ms_k = cuda_ms(run_kernel, 20, 2)
    ms_p = cuda_ms(run_plain, 3)
    ms_c = cuda_ms(run_conv, 20, 2)
    bound, by = conv_bound(*shape, dname, batch)
    name = label.split(" d=")[0].strip()
    if path is not None:
        r["paths"][name] = path
    ms_w = ms_k
    if dname == "float32":
        dev_k = dev_w = graph_ms(run_kernel)
        dev_c = graph_ms(run_conv)
    if run_wide is not None:
        e_wide = (run_wide().float() - ref).abs().max().item()
        ms_w, dev_w = cuda_ms(run_wide, 20, 2), graph_ms(run_wide)
        print(f"{tag} {dname:8s} {label} on {path}: device {dev_k:.4f} ms "
              f"(as called {ms_k:.4f}), the wide kernel forced {dev_w:.4f} "
              f"({ms_w:.4f}): {dev_w / dev_k:.2f}x; F.conv2d {dev_c:.4f} "
              f"({ms_c:.4f}); bound {bound:.4f} ms: thin at "
              f"{100 * bound / dev_k:.1f}%, wide at {100 * bound / dev_w:.1f}%"
              f"; the wide kernel's rel err vs plain {e_wide / scale:.2e}")
        if e_wide > tol_max * scale:
            raise AssertionError(f"the wide kernel disagrees at {label}")
    if dname == "float32":
        r["device_ms"] += n * dev_k
        r["wide_device_ms"] += n * dev_w
        r["library_device_ms"] += n * dev_c
        p = r["by_path"].setdefault(path, dict.fromkeys(
            ("ms", "device_ms", "plain_ms", "library_ms",
             "library_device_ms", "bound_ms", "max_abs_err", "classes"), 0))
        for key, ms in (("ms", ms_k), ("device_ms", dev_k),
                        ("plain_ms", ms_p), ("library_ms", ms_c),
                        ("library_device_ms", dev_c), ("bound_ms", bound)):
            p[key] += n * ms
        p["max_abs_err"] = max(p["max_abs_err"], e_plain)
        p["classes"] += 1
    r["wide_ms"] += n * ms_w
    r["ms"] += n * ms_k
    r["plain_ms"] += n * ms_p
    r["library_ms"] += n * ms_c
    r["bound_ms"] += n * bound
    r["by"][by] += n * bound
    print(f"{tag} {dname:8s} {label} x{n:2d}/fwd"
          f"{'' if path is None else f' ({path})'}: rel err vs plain max "
          f"{e_plain / scale:.2e} (tol {tol_max:g}) mean {e_mean:.2e} (tol "
          f"{tol_mean:g}), vs F.conv2d max {e_conv / scale:.2e} (tol "
          f"{tol_conv:g}); ms kernel {ms_k:.4f} plain {ms_p:.4f} F.conv2d "
          f"{ms_c:.4f} bound {bound:.4f} ({by}), kernel at "
          f"{100 * bound / ms_k:.1f}% of bound"
          + (f"; device ms kernel {dev_k:.4f} F.conv2d {dev_c:.4f}"
             if dname == "float32" else ""))
    if e_plain > tol_max * scale or e_mean > tol_mean \
            or e_conv > tol_conv * scale:
        raise AssertionError(f"kernel disagrees at {label} {dname}")
    return ms_k, ms_c


def _summary(r, what, dname, tag="[3]", batch=BATCH):
    print(f"{tag} {dname}: {what} (batch {batch}): kernel {r['ms']:.3f} ms, "
          f"plain {r['plain_ms']:.3f} ms, F.conv2d {r['library_ms']:.3f} ms, "
          f"bound {r['bound_ms']:.3f} ms ({100 * r['bound_ms'] / r['ms']:.1f}%"
          f" of it reached)")
    if dname == "float32":
        print(f"{tag} {dname}: {what}, device times (no host time between "
              f"launches): kernel {r['device_ms']:.3f} ms, F.conv2d "
              f"{r['library_device_ms']:.3f} ms")
    if _has_thin(r):
        print(f"{tag} {dname}: {what}, the same classes with the wide kernel "
              f"forced on the thin ones: {r['wide_ms']:.3f} ms as called "
              f"({r['wide_ms'] / r['ms']:.2f}x), {r['wide_device_ms']:.3f} ms "
              f"device ({r['wide_device_ms'] / r['device_ms']:.2f}x the "
              f"kernel's paths)")


def _ptxas_report(log: str, name: str):
    """ptxas' lines (registers, spills, wgmma serialisation) for the entry
    functions whose mangled name contains ``name``."""
    out, on = [], False
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            on = name in line
            if on:
                out.append(line.split("ptxas info    : ")[-1])
        elif "Potential Performance Loss" in line and name in line:
            out.append(line.split("ptxas info    : ")[-1])
        elif on and ("spill" in line or "Used" in line):
            out.append(line.split("ptxas info    : ")[-1])
    return out


def _spills(line: str) -> bool:
    """Whether a ptxas line reports a spill (or a stack frame)."""
    return "spill" in line and not line.startswith(
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill")


def _call_us(fn, n: int = 200):
    """Median host time of one call of ``fn`` (us): the wrapper's, and
    that of the C entry's ctypes call inside it (``load_library`` handing
    the wrapper entries that time themselves). ``n`` calls, each timed
    alone, without waiting for the card."""
    import statistics
    import torch
    from audiosourcesep_tpu_torch.kernels import build
    lib, calls, entries = build.load_library(), [], []

    class Timed:
        def __getattr__(self, name):
            entry = getattr(lib, name)

            def call(*args):
                t0 = time.perf_counter()
                err = entry(*args)
                entries.append(time.perf_counter() - t0)
                return err
            return call

    fn()
    torch.cuda.synchronize()
    real, build.load_library = build.load_library, Timed
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            calls.append(time.perf_counter() - t0)
    finally:
        build.load_library = real
    torch.cuda.synchronize()
    return (1e6 * statistics.median(calls), 1e6 * statistics.median(entries))


def _paths(W, x, u, cout):
    """The path of a conv class on its dtype's kernel (the bf16 producer's,
    or the f32 kernel's design) and, for a thin f32 class, a call of the
    wide f32 kernel forced on it (else None)."""
    import torch
    if x.dtype == torch.bfloat16:
        return W.bf16_path(x), None
    path = W.f32_path(x.shape, cout)
    if path == "wide":
        return path, None
    return path, lambda: W._winograd_cuda(x, u, path="wide")


def phase_kernel(smi: str):
    """Both kernels at the routed classes, then the dilated route, then
    the bf16 kernel above d = 4; returns the results of each route by
    dtype name (``bfloat16``, ``float32``, ``bfloat16_dilated``,
    ``float32_dilated``, ``bfloat16_wide_dilation``)."""
    import torch
    import torch.nn.functional as F
    from audiosourcesep_tpu_torch.ops import winograd as W
    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(h, w, cin, cout, dtype, batch=BATCH):
        x = torch.randn(batch, h, w, cin, device="cuda",
                        generator=g).to(dtype)
        k = torch.randn(3, 3, cin, cout, device="cuda", generator=g) \
            * (1.0 / (9 * cin)) ** 0.5
        return x, k, W.transform_weights(k).to(dtype), \
            x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(dtype)

    def nhwc(y):
        return y.permute(0, 2, 3, 1)

    from audiosourcesep_tpu_torch.kernels import build
    bf16_report = _ptxas_report(build.build_log, "winograd_f23_bf16")
    for line in bf16_report:
        print(f"[3] bf16 kernel ptxas: {line}")
    if not bf16_report or any(_spills(ln) for ln in bf16_report):
        raise AssertionError("the bf16 kernel's ptxas report is missing or "
                             "shows spills")
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        r = res[dname] = _new_result()
        for (h, w, cin, cout), n in CONV_CLASSES.items():
            x, k, u, xc, kc = inputs(h, w, cin, cout, dtype)
            path, wide = _paths(W, x, u, cout)
            _hold(r, f"{h}x{w} {cin:3d}->{cout:3d}", dname, n,
                  (h, w, cin, cout),
                  lambda: W._winograd_cuda(x, u),
                  lambda: W.winograd_conv2d_reference(x, k),
                  lambda: nhwc(F.conv2d(xc, kc, padding=1)),
                  path=path, run_wide=wide)
            if (h, w, cin, cout) == HOST_CLASS:
                r["host_us"] = _call_us(lambda: W._winograd_cuda(x, u))[0]
                print(f"[3] {dname} host time of one launch (the wrapper, "
                      f"the tensor maps and the enqueue, {HOST_CLASS}): "
                      f"{r['host_us']:.1f} us")
            del x, k, u, xc, kc
        _summary(r, "routed convs of one forward", dname)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        r = res[f"{dname}_dilated"] = _new_result()
        h, w, cin, cout = DILATED_CLASS
        for d, n in DILATED.items():
            x, k, u, xc, kc = inputs(h, w, cin, cout, dtype)
            before = dict(W.launch_counts)
            W.dilated_winograd_conv2d(x, k, d, u)
            if sum(W.launch_counts.values()) - sum(before.values()) != 1:
                raise AssertionError(f"dilated conv d={d} is not one launch")
            _hold(r, f"{h}x{w} {cin:3d}->{cout:3d} d={d}", dname, n,
                  DILATED_CLASS,
                  lambda: W.dilated_winograd_conv2d(x, k, d, u),
                  lambda: W.dilated_winograd_conv2d_reference(x, k, d),
                  lambda: nhwc(F.conv2d(xc, kc, padding=d, dilation=d)),
                  path=W.bf16_path(x, d) if dname == "bfloat16"
                  else W.f32_path(x.shape, cout, d))
            del x, k, u, xc, kc
        _summary(r, "dilated route over the cascade's dilated convs", dname)
    r = res["bfloat16_wide_dilation"] = _new_result()
    for d, (batch, h, w, cin, cout) in WIDE_DILATED.items():
        x, k, u, xc, kc = inputs(h, w, cin, cout, torch.bfloat16, batch)
        before, paths = dict(W.launch_counts), dict(W.bf16_path_counts)
        W.dilated_winograd_conv2d(x, k, d, u)
        name = W.KERNELS[torch.bfloat16]
        if W.launch_counts != {n: c + (n == name)
                               for n, c in before.items()} \
                or W.bf16_path_counts["tma"] != paths["tma"] + 1:
            raise AssertionError(f"bf16 d={d} is not one launch of the "
                                 f"bf16 kernel on its TMA path")
        ms_k, ms_c = _hold(
            r, f"{h}x{w} {cin:3d}->{cout:3d} d={d} batch {batch}",
            "bfloat16", 1, (h, w, cin, cout),
            lambda: W.dilated_winograd_conv2d(x, k, d, u),
            lambda: W.dilated_winograd_conv2d_reference(x, k, d),
            lambda: nhwc(F.conv2d(xc, kc, padding=d, dilation=d)),
            batch=batch, path=W.bf16_path(x, d))
        print(f"[3] bfloat16 d={d} on {smi}: kernel {ms_k:.4f} ms, "
              f"F.conv2d(dilation={d}) {ms_c:.4f} ms")
        del x, k, u, xc, kc
    _summary(r, "the bf16 kernel above d = 4", "bfloat16",
             batch="30 and 4")
    return res


def phase_model(dtype):
    import torch
    from audiosourcesep_tpu_torch import nn
    from audiosourcesep_tpu_torch.models.ncsn import get_score_model
    from audiosourcesep_tpu_torch.ops import winograd as W
    dname = str(dtype).split(".")[1]
    model = get_score_model("v1", (96, 64, 1), 192, 10, compute_dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(1))
    model = model.cuda().eval().requires_grad_(False)
    routed = sum(1 for m in model.modules() if isinstance(m, nn.Conv2d)
                 and m.kernel.shape[-1] == 3 and m.dilation == 1)
    if routed != ROUTED_PER_FORWARD:
        raise AssertionError(f"{routed} routable convs, expected "
                             f"{ROUTED_PER_FORWARD}")
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand(BATCH, 96, 64, 1, device="cuda", generator=g)
    idx = torch.full((BATCH,), 3, dtype=torch.long, device="cuda")
    try:
        nn.set_winograd(False)
        off = model(x, idx)
        ms_off = cuda_ms(lambda: model(x, idx), 3)
        nn.set_winograd(True)
        before = W.launch_counts[W.KERNELS[dtype]]
        on = model(x, idx)
        torch.cuda.synchronize()
        grew = W.launch_counts[W.KERNELS[dtype]] - before
        ms_on = cuda_ms(lambda: model(x, idx), 3)
    finally:
        nn.set_winograd(False)
    if grew != ROUTED_PER_FORWARD:
        raise AssertionError(f"one routed forward launched the {dname} "
                             f"kernel {grew} times, expected "
                             f"{ROUTED_PER_FORWARD}")
    if not (torch.isfinite(on).all() and torch.isfinite(off).all()):
        raise AssertionError("non-finite model output")
    rel = ((on - off).abs().mean() / off.abs().mean()).item()
    print(f"[4] v1 192 filters, x [{BATCH},96,64,1] {dname}: routing on "
          f"{ms_on:.2f} ms/forward, off {ms_off:.2f} ms/forward; launches "
          f"per forward {grew}; mean|on-off|/mean|off| {rel:.3e} "
          f"(tol {MODEL_TOL[dname]:g})")
    if rel > MODEL_TOL[dname]:
        raise AssertionError("routed forward disagrees with the cuDNN one")
    del model
    torch.cuda.empty_cache()


def _write_song(song_dir: str, seconds: float = 70.0, sr: int = 16000):
    """Piano and violin tones and their noisy mix. JAX_SDR and JAX_SIR
    hold for this song only: benchmarks/jax_ground_truth_sdr.py scores the
    JAX package on it."""
    import numpy as np
    from audiosourcesep_tpu_torch.data import write_wav
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(0)
    piano = 0.4 * np.sin(2 * np.pi * 220.0 * t) * (
        1 + 0.3 * np.sin(2 * np.pi * 2.0 * t))
    violin = 0.4 * np.sin(2 * np.pi * 554.4 * t + 3 * np.sin(
        2 * np.pi * 5.0 * t))
    mix = 0.5 * (piano + violin) + 0.01 * rng.standard_normal(t.shape)
    for name, a in (("piano", piano), ("violin", violin), ("mix", mix)):
        write_wav(os.path.join(song_dir, f"{name}.wav"),
                  a.astype(np.float32), sr)


def _write_prior(path: str, seed: int):
    import torch
    from audiosourcesep_tpu_torch.models.ncsn import get_score_model
    from audiosourcesep_tpu_torch.training.checkpoint import (
        CheckpointManager, params_to_jax)
    m = get_score_model("v1", (96, 64, 1), 192, 10)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    CheckpointManager(os.path.join(path, "ckpts")).save(
        {"params": params_to_jax(m.state_dict())}, 1)


def _reset_counts():
    from audiosourcesep_tpu_torch.ops import winograd as W
    W.launch_count = 0
    for name in W.launch_counts:
        W.launch_counts[name] = 0
    for counts in (W.bf16_path_counts, W.f32_path_counts):
        for name in counts:
            counts[name] = 0


def phase_cli(work: str, T: int, dtype: str = "bf16", inverse: bool = False):
    """One separation through the CLI; returns the launches of each
    kernel during it, the wall-clock and the output directory."""
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch import run_basis_sep
    from audiosourcesep_tpu_torch.data import read_wav
    from audiosourcesep_tpu_torch.ops import winograd as W
    song, p1, p2 = (os.path.join(work, n) for n in ("song", "p1", "p2"))
    out = os.path.join(work, f"sep_T{T}_{dtype}")
    if not os.path.isdir(song):
        for d in (song, p1, p2):
            os.makedirs(d, exist_ok=True)
        t0 = time.time()
        _write_song(song)
        _write_prior(p1, 11)
        _write_prior(p2, 12)
        print(f"[5] wrote 70 s of wavs and two JAX-format priors in "
              f"{time.time() - t0:.1f} s")
    L = 10
    _reset_counts()
    t0 = time.time()
    run_basis_sep.main([p1, p2, "--output", out, "--song_dir", song,
                        "--model_type", "ncsn", "--version", "v1",
                        "--n_filters", "192", "--num_classes", str(L),
                        "--scale", "dB", "--n_mixed", str(BATCH),
                        "--T", str(T), "--compute_dtype", dtype,
                        "--winograd", "--device", "cuda"]
                       + (["--inverse"] if inverse else []))
    wall = time.time() - t0
    launches = dict(W.launch_counts)
    paths = dict(W.bf16_path_counts if dtype == "bf16"
                 else W.f32_path_counts)
    expected = 2 * L * T * ROUTED_PER_FORWARD
    mine = W.KERNELS[torch.bfloat16 if dtype == "bf16" else torch.float32]
    res = np.load(os.path.join(out, "results.npz"))
    conv = np.load(os.path.join(out, "results_convergence.npz"))
    with open(os.path.join(out, "out.log")) as f:
        log = [ln for ln in f.read().splitlines()
               if ln.startswith(("Data Loaded", "Duration",
                                 "Inversion duration"))]
    inv_s = sum(float(ln.split()[2]) for ln in log
                if ln.startswith("Inversion duration"))
    print(f"[5] CLI T={T} {dtype}{' --inverse' if inverse else ''}: "
          f"wall-clock {wall:.2f} s (main(), data and model load included), "
          f"{wall - inv_s:.2f} s without the inversion; out.log: {log}")
    print(f"[5] kernel launches {launches}, expected {mine}: 2 models x {L} "
          f"levels x T={T} x {ROUTED_PER_FORWARD} = {expected}")
    if launches != {name: expected if name == mine else 0
                    for name in launches}:
        raise AssertionError(f"the {dtype} path did not launch {mine} for "
                             f"every routed conv, and only it")
    # bf16: begin_conv (1->192) by plain loads, the rest by TMA; f32:
    # begin_conv thin_in, end_conv (192->1) thin_out, the rest wide
    per = ({"tma": ROUTED_PER_FORWARD - 1, "plain": 1} if dtype == "bf16"
           else {"wide": ROUTED_PER_FORWARD - 2, "thin_in": 1,
                 "thin_out": 1})
    want = {k: 2 * L * T * n for k, n in per.items()}
    print(f"[5] {dtype} launches by path {paths}, expected {want}")
    if paths != want:
        raise AssertionError(f"the {dtype} kernel's paths are not the "
                             f"classes' paths")
    launches["paths"] = paths
    for key in ("x1", "x2", "gt1", "gt2", "mixed"):
        if res[key].shape != (BATCH, 96, 64):
            raise AssertionError(f"results.npz {key} {res[key].shape}")
        if not np.isfinite(res[key]).all():
            raise AssertionError(f"results.npz {key} not finite")
    if res["stft_mixture"].shape != (BATCH, 1025, 64) \
            or res["stft_mixture"].dtype != np.complex64:
        raise AssertionError("stft_mixture shape/dtype")
    for key in ("x1", "x2"):
        c = conv[key]
        if c.shape[0] != L + 1 or not np.isfinite(c).all():
            raise AssertionError(f"results_convergence {key} {c.shape}")
        if res[key].min() < -100.0 or res[key].max() > 20.0:
            raise AssertionError(f"{key} outside the dB range")
    moved = float(np.abs(conv["x1"][-1] - conv["x1"][0]).mean())
    print(f"[5] results.npz keys {sorted(res.files)}, x1 {res['x1'].shape}, "
          f"convergence {conv['x1'].shape}; mean|x1 final - init| "
          f"{moved:.3f} dB; all finite")
    if inverse:
        # the 30 frames of each source inverted as one spectrogram
        for name in ("sep1.wav", "sep2.wav"):
            audio, sr = read_wav(os.path.join(out, name))
            if audio.shape != (HOP * (BATCH * 64 - 1),) or sr != 16000 \
                    or not np.isfinite(audio).all() or not audio.any():
                raise AssertionError(f"{name}: {audio.shape} at {sr} Hz")
        print(f"[5] sep1.wav, sep2.wav: {HOP * (BATCH * 64 - 1)} samples "
              f"each, finite")
    return launches, wall, out


def _aligned_stems(basis_dir: str, inv_dir: str):
    """Raw ground-truth stems and their inversions, window by window (each
    raw window of W_RAW samples cut to its inversion's W_INV)."""
    import numpy as np
    from audiosourcesep_tpu_torch.data import read_wav
    refs, ests = [], []
    for i in (1, 2):
        raw, _ = read_wav(os.path.join(basis_dir, f"ground_truth{i}.wav"))
        est, _ = read_wav(os.path.join(inv_dir, f"gt{i}.wav"))
        refs.append(np.concatenate([raw[k * W_RAW:k * W_RAW + W_INV]
                                    for k in range(BATCH)]))
        ests.append(est[:BATCH * W_INV])
    return np.stack(refs)[:, :, None], np.stack(ests)[:, :, None]


def phase_inversion(basis_dir: str):
    """The inversion CLI on the card in three modes, mel_to_stft against
    float64 on the CPU, and the ground-truth SDR/SIR with the port's
    bss_eval. Returns the launches of the kernels during the CLI runs."""
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch import melspec_inversion_basis
    from audiosourcesep_tpu_torch.evaluation import bss_eval
    from audiosourcesep_tpu_torch.ops import inversion
    from audiosourcesep_tpu_torch.ops import winograd as W
    from audiosourcesep_tpu_torch.ops.mel import db_to_power
    mel_to_stft = inversion.mel_to_stft
    n_frame, n_whole = BATCH * W_INV, HOP * (BATCH * 64 - 1)
    runs = ((["--algorithm", "reuse_phase", "--wiener_filter"],
             "inverse_reuse_phase_frame_wiener_filter", n_frame),
            (["--algorithm", "reuse_phase", "--method", "whole"],
             "inverse_reuse_phase_whole", n_whole),
            (["--algorithm", "griffin"], "inverse_griffin_frame", n_frame))
    _reset_counts()
    for flags, sub, n in runs:
        t0 = time.time()
        melspec_inversion_basis.main([basis_dir, "--device", "cuda",
                                      *flags])
        wall = time.time() - t0
        out = os.path.join(basis_dir, sub)
        with open(os.path.join(out, "out.log")) as f:
            log = [ln for ln in f.read().splitlines()
                   if ln.startswith("Inversion duration")]
        inv = np.load(os.path.join(out, "inverse_spectrograms.npz"))
        for key in ("x1", "x2", "gt1", "gt2", "mix"):
            a = inv[f"{key}_audio"]
            if a.shape != (n,) or not np.isfinite(a).all() or not a.any():
                raise AssertionError(f"{sub} {key}_audio {a.shape}")
        for name in ("sep1", "sep2", "gt1", "gt2", "mix"):
            if not os.path.isfile(os.path.join(out, f"{name}.wav")):
                raise AssertionError(f"{sub}/{name}.wav missing")
        print(f"[6] inversion CLI {' '.join(flags)}: {log}, wall-clock "
              f"{wall:.2f} s; 5 tracks of {n} samples, finite")
    launches = dict(W.launch_counts)
    print(f"[6] kernel launches during the inversion CLI: {launches}")
    if any(launches.values()):
        raise AssertionError("the inversion path launched a conv kernel")

    # mel_to_stft on the card against float64 on the CPU, same input: the
    # ground-truth pair of the Wiener inversion, [2, 30, 96, 64] power. TF32
    # is on around the card's run: mel_to_stft must keep its matmuls in f32.
    res = np.load(os.path.join(basis_dir, "results.npz"))
    mels = db_to_power(torch.as_tensor(np.stack([res["gt1"], res["gt2"]]),
                                       dtype=torch.float64))
    t0 = time.time()
    ref = mel_to_stft(mels, power=1.0)
    cpu_s = time.time() - t0
    mels_dev = mels.float().cuda()

    def rel_err(got):
        err = (got.double().cpu() - ref).abs()
        return ((err.max() / ref.abs().max()).item(),
                (err.mean() / ref.abs().mean()).item())

    full_f32 = inversion._full_f32_matmul
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        max_rel, mean_rel = rel_err(mel_to_stft(mels_dev, power=1.0))
        if not torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("mel_to_stft did not restore TF32")
        ms = cuda_ms(lambda: mel_to_stft(mels_dev, power=1.0), 3)
        # control: the same solve with the f32 scope taken away (TF32)
        inversion._full_f32_matmul = contextlib.nullcontext
        tf32_max, tf32_mean = rel_err(mel_to_stft(mels_dev, power=1.0))
        tf32_ms = cuda_ms(lambda: mel_to_stft(mels_dev, power=1.0), 3)
    finally:
        inversion._full_f32_matmul = full_f32
        torch.backends.cuda.matmul.allow_tf32 = False
    cols = mels.numel() // 96                       # 2 x 30 x 64 frames
    flops = 300 * 2 * 1025 * 1025 * cols + 2 * 96 * 1025 * (1025 + cols)
    bound = 1e3 * flops / PEAK["float32"]
    print(f"[6] mel_to_stft [2,{BATCH},96,64] f32 on the card vs float64 on "
          f"the CPU: max-rel {max_rel:.2e} (tol {NNLS_TOL[0]:g}), mean-rel "
          f"{mean_rel:.2e} (tol {NNLS_TOL[1]:g}); {ms:.2f} ms on the card "
          f"(bound {bound:.2f} ms: {flops / 1e12:.3f} TFLOP at the f32 "
          f"peak), float64 CPU {cpu_s:.2f} s")
    print(f"[6] control, the same solve in TF32: max-rel {tf32_max:.2e}, "
          f"mean-rel {tf32_mean:.2e}; {tf32_ms:.2f} ms on the card")
    if not (max_rel <= NNLS_TOL[0] and mean_rel <= NNLS_TOL[1]):
        raise AssertionError("mel_to_stft on the card disagrees")

    refs, ests = _aligned_stems(
        basis_dir, os.path.join(basis_dir, runs[0][1]))
    t0 = time.time()
    sdr, _, sir, _, _ = bss_eval(refs, ests, window=np.inf, hop=np.inf,
                                 compute_permutation=False)
    bss_s = time.time() - t0
    for i in range(2):
        s_sdr, s_sir = float(np.nanmean(sdr[i])), float(np.nanmean(sir[i]))
        print(f"[6] ground truth {i + 1} (Wiener, frame): SDR {s_sdr:.4f} dB "
              f"(JAX {JAX_SDR[i]:.4f} +- {GT_TOL['SDR']}), SIR {s_sir:.4f} dB "
              f"(JAX {JAX_SIR[i]:.4f} +- {GT_TOL['SIR']})")
        if not (abs(s_sdr - JAX_SDR[i]) <= GT_TOL["SDR"]
                and abs(s_sir - JAX_SIR[i]) <= GT_TOL["SIR"]):
            raise AssertionError(f"ground-truth inversion {i + 1} off the "
                                 f"JAX package's SDR/SIR")
    print(f"[6] bss_eval of 2 x {refs.shape[1]} samples: {bss_s:.2f} s on "
          f"the host")


def _full_width_state(device, seed: int = 0):
    """A v1 192-filter train state with Adam (lr 1e-3) and EMA on
    ``device``, its weights drawn on the CPU from ``seed``."""
    import torch
    from audiosourcesep_tpu_torch.models.ncsn import get_score_model
    from audiosourcesep_tpu_torch.training import (init_train_state,
                                                   setup_optimizer)
    m = get_score_model("v1", (96, 64, 1), 192, 10, device=device)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    return init_train_state(m, setup_optimizer("adam", 1e-3), ema=True)


def _draws(batch: int, seed: int):
    """A batch in [0, 1), sigma indices and standard-normal noise, drawn
    on the CPU (the same on every device)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(batch, 96, 64, 1, generator=g),
            torch.randint(10, (batch,), generator=g),
            torch.randn(batch, 96, 64, 1, generator=g))


def phase_train_data(work: str):
    """7a: wav_to_spec on phase 5's wavs; returns the dataset directory
    and the (train, test) record counts."""
    import io
    import numpy as np
    from audiosourcesep_tpu_torch import wav_to_spec
    from audiosourcesep_tpu_torch.data import load_tf_records
    ds = os.path.join(work, "train_ds")
    counts = []
    t0 = time.time()
    for split, names in (("train", ("piano", "violin")), ("test", ("mix",))):
        wavs = os.path.join(work, f"wavs_{split}")
        os.makedirs(wavs, exist_ok=True)
        for n in names:
            shutil.copy(os.path.join(work, "song", f"{n}.wav"), wavs)
        with contextlib.redirect_stdout(io.StringIO()):
            wav_to_spec.main([wavs, os.path.join(ds, split), "--use_dB",
                              "--tfrecords", "--device", "cuda"])
        recs = [r for n in names for r in load_tf_records(
            [os.path.join(ds, split, f"{n}.tfrecord")])]
        for r in recs:
            if r.shape != (96, 64) or not np.isfinite(r).all() \
                    or r.min() < -100.0 or r.max() > 20.0:
                raise AssertionError(f"{split} record {r.shape} "
                                     f"[{r.min()}, {r.max()}]")
        counts.append(len(recs))
    print(f"[7a] wav_to_spec --use_dB --tfrecords on the card: train "
          f"{counts[0]} and test {counts[1]} records of (96, 64) in "
          f"[-100, 20] dB, {time.time() - t0:.2f} s")
    return ds, counts


def phase_train_step_vs_cpu():
    """7b: one full-width train step at batch 2 on the card and on the
    CPU, same init and draws."""
    import torch
    from audiosourcesep_tpu_torch.models.ncsn import get_sigmas
    from audiosourcesep_tpu_torch.training import make_ncsn_train_step
    sigmas = get_sigmas(1.0, 0.01, 10, "logarithmic")
    x, idx, noise = _draws(2, 20)
    out = {}
    for device in ("cuda", "cpu"):
        state = _full_width_state(device)
        step, _ = make_ncsn_train_step(sigmas, ema_decay=0.999)
        t0 = time.time()
        _, loss = step(state, x.to(device), sigma_idx=idx.to(device),
                       noise=noise.to(device))
        loss = float(loss)
        out[device] = (loss, time.time() - t0,
                       {n: p.detach().cpu() for n, p in state.params.items()},
                       {n: p.grad.cpu() for n, p in state.params.items()})
        del state
    torch.cuda.empty_cache()
    (l_gpu, s_gpu, p_gpu, g_gpu), (l_cpu, s_cpu, p_cpu, g_cpu) = \
        out["cuda"], out["cpu"]

    def rel(a, b):
        num = sum(((a[n] - t) ** 2).sum().item() for n, t in b.items())
        return (num / sum((t ** 2).sum().item() for t in b.values())) ** 0.5

    errs = {"loss": abs(l_gpu - l_cpu) / abs(l_cpu),
            "grad": rel(g_gpu, g_cpu), "param": rel(p_gpu, p_cpu)}
    max_abs = max((p_gpu[n] - p).abs().max().item() for n, p in p_cpu.items())
    max_rel = max((p_gpu[n] - p).abs().max().item() / p.abs().max().item()
                  for n, p in p_cpu.items())
    print(f"[7b] one Adam step, batch 2, card vs CPU: loss {l_gpu:.6f} vs "
          f"{l_cpu:.6f}; rel diff loss {errs['loss']:.2e}, gradients "
          f"{errs['grad']:.2e}, params after the step {errs['param']:.2e} "
          f"(tol {TRAIN_TOL}); params max|diff| {max_abs:.2e}, max-rel "
          f"(per tensor, of its max) {max_rel:.2e}; first step {s_gpu:.2f} "
          f"s on the card, {s_cpu:.2f} s on the CPU")
    if any(errs[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
        raise AssertionError("the train step on the card disagrees with "
                             "the CPU")


def _step_split(state, step, x, idx, noise, sigmas_dev):
    """ms of the loss (forward), of the loss and its backward, of the
    optimizer and EMA update, and of the whole train step, on the same
    inputs (CUDA events; the steps move the weights, which the times do
    not depend on)."""
    from audiosourcesep_tpu_torch.models.ncsn import dsm_loss
    from audiosourcesep_tpu_torch.training import ema_update

    def fwd():
        return dsm_loss(state.model, x, sigmas_dev, sigma_idx=idx,
                        noise=noise)

    def fwd_bwd():
        state.optimizer.zero_grad(set_to_none=True)
        fwd().backward()

    def update():
        state.optimizer.step()
        ema_update(state.ema_params.values(), state.params.values(), 0.999)

    t_fwd = cuda_ms(fwd, 3)
    t_fb = cuda_ms(fwd_bwd, 3)
    t_opt = cuda_ms(update, 3)
    t_step = cuda_ms(lambda: step(state, x, sigma_idx=idx, noise=noise), 3)
    return t_fwd, t_fb - t_fwd, t_opt, t_step


def phase_train_routing(smi: str):
    """7c: two full-width steps at batch 32, routing off and on, then the
    step times."""
    import torch
    from audiosourcesep_tpu_torch import nn
    from audiosourcesep_tpu_torch.models.ncsn import get_sigmas
    from audiosourcesep_tpu_torch.ops import winograd as W
    from audiosourcesep_tpu_torch.training import make_ncsn_train_step
    sigmas = get_sigmas(1.0, 0.01, 10, "logarithmic")
    sig_dev = torch.as_tensor(sigmas, device="cuda")
    draws = [[t.cuda() for t in _draws(TRAIN_BATCH, 30 + s)]
             for s in range(2)]
    f32, bf16 = W.KERNELS[torch.float32], W.KERNELS[torch.bfloat16]
    losses, times = {}, {}
    for routed in (False, True):
        state = _full_width_state("cuda")
        step, _ = make_ncsn_train_step(sigmas, ema_decay=0.999)
        try:
            nn.set_winograd(routed)
            losses[routed] = []
            for x, idx, noise in draws:
                _reset_counts()
                _, loss = step(state, x, sigma_idx=idx, noise=noise)
                losses[routed].append(float(loss))
                want = {f32: ROUTED_PER_FORWARD if routed else 0, bf16: 0}
                if dict(W.launch_counts) != want:
                    raise AssertionError(f"train step launches "
                                         f"{W.launch_counts}, expected "
                                         f"{want}")
            if routed:
                # the weights moved in step 2's optimizer update after its
                # forward cached U: a routed forward now must agree with
                # cuDNN's on the same weights
                x, idx = draws[0][0], draws[0][1]
                with torch.no_grad():
                    on = state.model(x, idx)
                    nn.set_winograd(False)
                    off = state.model(x, idx)
                    nn.set_winograd(True)
                u_rel = ((on - off).abs().mean() / off.abs().mean()).item()
            times[routed] = _step_split(state, step, *draws[0], sig_dev)
        finally:
            nn.set_winograd(False)
        del state, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    try:
        state = _full_width_state("cuda")
        step, _ = make_ncsn_train_step(sigmas, ema_decay=0.999)
        times["tf32"] = _step_split(state, step, *draws[0], sig_dev)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    del state, step
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False])]
    moved = abs(losses[False][1] - losses[False][0]) / losses[False][0]
    print(f"[7c] batch {TRAIN_BATCH}, routing on vs off: step 1 loss "
          f"{losses[True][0]:.4f} vs {losses[False][0]:.4f} (rel "
          f"{rel[0]:.2e}), step 2 {losses[True][1]:.4f} vs "
          f"{losses[False][1]:.4f} (rel {rel[1]:.2e}; tol "
          f"{MODEL_TOL['float32']:g}; the loss moved {moved:.2e} between "
          f"the steps); {ROUTED_PER_FORWARD} f32 launches per step, no bf16")
    print(f"[7c] after the routed steps, the scores of the updated weights "
          f"routed vs cuDNN: mean|on-off|/mean|off| {u_rel:.2e} (tol "
          f"{MODEL_TOL['float32']:g})")
    if max(rel) > MODEL_TOL["float32"] or u_rel > MODEL_TOL["float32"]:
        raise AssertionError("routed train step disagrees with cuDNN's "
                             "(is U stale after the optimizer step?)")
    flop = 3 * FWD_TFLOP_30 * 1e12 * TRAIN_BATCH / 30
    bound, bound_tf32 = 1e3 * flop / PEAK["float32"], 1e3 * flop / TF32_PEAK
    for key, what in ((False, "f32, TF32 off, routing off"),
                      (True, "f32, TF32 off, routing on"),
                      ("tf32", "TF32 convs (PyTorch default), routing off")):
        t_fwd, t_bwd, t_opt, t_step = times[key]
        print(f"[7c] train step batch {TRAIN_BATCH}, {what}: {t_step:.2f} "
              f"ms; apart: forward {t_fwd:.2f}, backward {t_bwd:.2f}, Adam "
              f"and EMA {t_opt:.2f}")
    print(f"[7c] step bound: {flop / 1e12:.3f} TFLOP (3 x {FWD_TFLOP_30} x "
          f"{TRAIN_BATCH}/30) at 67 TFLOP/s f32 = {bound:.1f} ms, at 495 "
          f"TFLOP/s TF32 = {bound_tf32:.1f} ms; card {smi}")
    return times


def phase_train_cli(work: str, ds: str, counts):
    """7d: train_ncsn and ncsn_generate_samples in-process at full width,
    routing on; returns the f32 launches of each."""
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch import (nn, ncsn_generate_samples,
                                          train_ncsn)
    from audiosourcesep_tpu_torch.models.ncsn import get_score_model
    from audiosourcesep_tpu_torch.ops import winograd as W
    from audiosourcesep_tpu_torch.training.checkpoint import (
        CheckpointManager, load_flat, restore_ncsn_params)
    f32, bf16 = W.KERNELS[torch.float32], W.KERNELS[torch.bfloat16]
    out, gen = os.path.join(work, "ncsn"), os.path.join(work, "ncsn_gen")
    L, T = 10, 1
    steps = counts[0] // TRAIN_BATCH
    forwards = steps + -(-counts[1] // TRAIN_BATCH) + L * T
    try:
        nn.set_winograd(True)
        _reset_counts()
        t0 = time.time()
        with timed_collectives() as times:
            train_ncsn.main(["--dataset", ds, "--output", out, "--version",
                             "v1", "--n_filters", "192", "--num_classes",
                             str(L), "--batch_size", str(TRAIN_BATCH),
                             "--ema", "--n_epochs", "1", "--T", str(T),
                             "--sample_every", "1", "--device", "cuda"])
        wall = time.time() - t0
        STEP_TIMES["7d"] = times["step"]
        train_launches = dict(W.launch_counts)
        _reset_counts()
        t0 = time.time()
        ncsn_generate_samples.main([out, "--output", gen, "--ema",
                                    "--version", "v1", "--n_filters", "192",
                                    "--num_classes", str(L), "--T", str(T),
                                    "--n_samples", "8", "--device", "cuda"])
        gen_wall = time.time() - t0
        gen_launches = dict(W.launch_counts)
    finally:
        nn.set_winograd(False)
    with open(os.path.join(out, "out.log")) as f:
        log = [ln.strip() for ln in f if ln.startswith(
            ("Total Trainable", "Epoch", "Training time"))]
    print(f"[7d] train_ncsn v1 192 filters, {L} levels, batch {TRAIN_BATCH}, "
          f"--ema, 1 epoch ({steps} steps), T={T} snapshot, routing on: "
          f"wall-clock {wall:.2f} s; steps {_ms(times['step'])} ms; "
          f"out.log: {log}")
    want = {f32: forwards * ROUTED_PER_FORWARD, bf16: 0}
    print(f"[7d] kernel launches {train_launches}, expected {want}: "
          f"({steps} steps + {forwards - steps - L * T} eval batches + "
          f"{L}x{T} Langevin) x {ROUTED_PER_FORWARD}")
    if train_launches != want:
        raise AssertionError("the training CLI did not launch the f32 "
                             "kernel for every routed conv, and only it")
    if not os.path.isfile(os.path.join(out, "ckpts", "checkpoint.json")):
        raise AssertionError("no ckpts/checkpoint.json")
    latest = CheckpointManager(os.path.join(out, "ckpts")).latest()
    flat, step = load_flat(latest)
    for key in ("['step']", "['opt_state'][0].count",
                "['params']['res1_1']['conv1']['kernel']",
                "['ema_params']['res1_1']['conv1']['kernel']",
                "['opt_state'][0].mu['res1_1']['conv1']['kernel']",
                "['opt_state'][0].nu['res1_1']['conv1']['kernel']"):
        if key not in flat:
            raise AssertionError(f"checkpoint lacks {key}")
    if step != steps or int(flat["['opt_state'][0].count"]) != steps:
        raise AssertionError(f"checkpoint at step {step}, expected {steps}")
    template = get_score_model("v1", (96, 64, 1), 192, L,
                               device="meta").state_dict()
    sd = restore_ncsn_params(out, template, ema=True)
    samples = np.load(os.path.join(out, "generated_samples",
                                   "generated_samples_1.npy"))
    if samples.shape != (L + 1, 32, 96, 64, 1) \
            or not np.isfinite(samples).all():
        raise AssertionError(f"Langevin snapshot {samples.shape}")
    print(f"[7d] {os.path.basename(latest)}.npz: {len(flat)} JAX keys "
          f"(params, ema_params, opt_state, step), step {step}; "
          f"restore_ncsn_params(ema=True) loaded {len(sd)} tensors; "
          f"snapshot {samples.shape}, finite")
    gen_want = {f32: L * T * ROUTED_PER_FORWARD, bf16: 0}
    g = np.load(os.path.join(gen, "generated_samples.npy"))
    print(f"[7d] ncsn_generate_samples --ema --T {T} --n_samples 8: "
          f"{gen_wall:.2f} s, {g.shape} in [{g.min():.2f}, {g.max():.2f}] dB; "
          f"launches {gen_launches}, expected {gen_want}")
    if g.shape != (8, 96, 64, 1) or not np.isfinite(g).all() \
            or g.min() < -100.0 or g.max() > 20.0:
        raise AssertionError("generated samples")
    if gen_launches != gen_want:
        raise AssertionError("the sampler did not launch the f32 kernel "
                             "for every routed conv, and only it")
    return train_launches[f32], gen_launches[f32]


def glow_forward_flop(batch: int) -> float:
    """Multiply-adds x 2 of one Glow forward: per step the 3x3 convs
    C/2 -> 512 -> C, the 1x1 512 -> 512 and the invertible 1x1 C -> C, at
    each level's resolution (C channels after its squeeze)."""
    f, flop = GLOW["n_filters"], 0
    for level in range(GLOW["L"]):
        hw = (96 >> (level + 1)) * (64 >> (level + 1))
        c = 4 << level
        flop += GLOW["K"] * 2 * hw * (9 * (c // 2) * f + f * f + 9 * f * c
                                      + c * c)
    return batch * flop


def _glow(device, init=True):
    """The full-width Glow on ``device``: with ``init``, initialised from a
    random dB minibatch (draws on the CPU, the same on any device) and each
    coupling's last conv drawn from N(0, GLOW_CONV3_STD^2); else left
    uninitialised, to load a state_dict into."""
    import torch
    from audiosourcesep_tpu_torch.bijectors import ShiftAndLogScaleConvNet
    from audiosourcesep_tpu_torch.models import build_glow
    g = torch.Generator().manual_seed(0)
    mb = torch.rand(8, 96, 64, 1, generator=g) * 120.0 - 100.0
    model = build_glow((96, 64, 1), **GLOW, learntop=True,
                       data_type="melspec", minibatch=mb.to(device)
                       if init else None, generator=g, device=device)
    if init:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, ShiftAndLogScaleConvNet):
                    m.conv3.kernel.copy_(GLOW_CONV3_STD * torch.randn(
                        m.conv3.kernel.shape, generator=g))
    return model


def _glow_data(n: int, seed: int):
    """``n`` random dB patches in [-100, 20), drawn on the CPU."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 96, 64, 1, generator=g) * 120.0 - 100.0


def _rel(a, b) -> float:
    """||a - b|| / ||b|| over a tensor or a dict of tensors (on the CPU)."""
    if isinstance(b, dict):
        num = sum(((a[n].cpu() - t.cpu()) ** 2).sum().item()
                  for n, t in b.items())
        return (num / sum((t.cpu() ** 2).sum().item()
                          for t in b.values())) ** 0.5
    return ((a.cpu() - b.cpu()).norm() / b.cpu().norm()).item()


def _f32_classes(r, classes, batches, tag, g, prefix=""):
    """The f32 kernel at each class of ``classes`` ({(H, W, C_in, C_out):
    convs per forward}) and batch of ``batches`` ({batch: chunks of it per
    forward}): launched once on its path (``f32_path_counts``), then held
    to its plain version and the wide kernel forced on it, and timed
    (``_hold``) into the route's result ``r``."""
    import torch
    import torch.nn.functional as F
    from audiosourcesep_tpu_torch.ops import winograd as W
    for (h, w, cin, cout), n in classes.items():
        for batch, chunks in batches.items():
            x = torch.randn(batch, h, w, cin, device="cuda", generator=g)
            k = torch.randn(3, 3, cin, cout, device="cuda", generator=g) \
                * (1.0 / (9 * cin)) ** 0.5
            u = W.transform_weights(k)
            xc, kc = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)
            path, wide = _paths(W, x, u, cout)
            label = (f"{prefix}{h}x{w} {cin:3d}->{cout:3d}"
                     + (f" batch {batch}" if len(batches) > 1 else ""))
            before = dict(W.f32_path_counts)
            W._winograd_cuda(x, u)
            if W.f32_path_counts != {p: c + (p == path)
                                     for p, c in before.items()}:
                raise AssertionError(f"{label} did not launch once on its "
                                     f"path {path}")
            _hold(r, label, "float32", n * chunks, (h, w, cin, cout),
                  lambda: W._winograd_cuda(x, u),
                  lambda: W.winograd_conv2d_reference(x, k),
                  lambda: F.conv2d(xc, kc, padding=1).permute(0, 2, 3, 1),
                  tag=tag, batch=batch, path=path, run_wide=wide)
            del x, k, u, xc, kc


def _thin_host_us(classes, batch):
    """Host time of one launch (us, medians) of each thin f32 design at the
    first class of ``classes`` that ``f32_path`` puts on it, and of the
    wide design forced on the same conv: the wrapper's, and the C entry's
    alone."""
    import torch
    from audiosourcesep_tpu_torch.ops import winograd as W
    out = {}
    for h, w, cin, cout in classes:
        path = W.f32_path((batch, h, w, cin), cout)
        if path == "wide" or path in out:
            continue
        x = torch.randn(batch, h, w, cin, device="cuda")
        u = torch.randn(16, cin, cout, device="cuda")
        us, entry_us = _call_us(lambda: W._winograd_cuda(x, u))
        wide_us, wide_entry_us = _call_us(
            lambda: W._winograd_cuda(x, u, path="wide"))
        out[path] = {"class": f"{batch}x{h}x{w} {cin}->{cout}", "us": us,
                     "entry_us": entry_us, "wide_us": wide_us,
                     "wide_entry_us": wide_entry_us}
    return out


def _print_host_us(host):
    for path, t in host.items():
        print(f"[8a] host time of one {path} launch at {t['class']} "
              f"(medians of 200): the wrapper {t['us']:.2f} us, its C entry "
              f"{t['entry_us']:.2f} us; the wide kernel forced there "
              f"{t['wide_us']:.2f} us, its C entry {t['wide_entry_us']:.2f}"
              f" us")


def phase_glow_kernel(smi: str):
    """8a: the f32 kernel at the six Glow conv classes against its plain
    version, the wide kernel forced on them and F.conv2d, at batch 30 (a
    separation's score at --score_chunk 0) and at the chunks of 8 and 6
    frames that --score_chunk 8 scores 30 frames in; the host time of a
    thin launch; the coupling nets' 1x1 512->512 conv as nn.conv1x1 (a
    matmul) against F.conv2d at each resolution. Returns the result of
    each route: ``glow`` (batch 30), ``glow_chunks`` (3 chunks of 8 and
    one of 6)."""
    import torch
    import torch.nn.functional as F
    from audiosourcesep_tpu_torch import nn
    g = torch.Generator(device="cuda").manual_seed(8)
    res = {}
    for route, batches, what in (
            ("glow", {BATCH: 1}, f"{BATCH}"),
            ("glow_chunks", {8: 3, 6: 1}, f"{BATCH} in chunks of 8, 8, 8, 6")):
        r = res[route] = _new_result()
        _f32_classes(r, GLOW_CLASSES, batches, "[8a]", g)
        _summary(r, "routed convs of one Glow forward", "float32",
                 tag="[8a]", batch=what)
        print(f"[8a] the Glow route, batch {what}, on {smi}, device times: "
              f"kernel's paths {r['device_ms']:.3f} ms, the wide kernel "
              f"forced {r['wide_device_ms']:.3f} ms, F.conv2d "
              f"{r['library_device_ms']:.3f} ms, bound {r['bound_ms']:.3f} "
              f"ms; as called: {r['ms']:.3f}, {r['wide_ms']:.3f}, "
              f"{r['library_ms']:.3f} ms")
    res["glow"]["thin_host_us"] = _thin_host_us(GLOW_CLASSES, 8)
    _print_host_us(res["glow"]["thin_host_us"])
    f = GLOW["n_filters"]
    for h, w in ((48, 32), (24, 16), (12, 8)):
        x = torch.randn(BATCH, f, h, w, device="cuda", generator=g
                        ).contiguous(memory_format=torch.channels_last)
        k = torch.randn(f, f, 1, 1, device="cuda", generator=g) / f ** 0.5
        mm, cv = nn.conv1x1(x, k), F.conv2d(x, k)
        err = _rel(mm, cv)
        ms_mm = cuda_ms(lambda: nn.conv1x1(x, k), 20, 2)
        ms_cv = cuda_ms(lambda: F.conv2d(x, k), 20, 2)
        bound = 1e3 * 2 * BATCH * h * w * f * f / PEAK["float32"]
        print(f"[8a] 1x1 {f}->{f} at {h}x{w}, batch {BATCH}: nn.conv1x1 "
              f"(matmul) {ms_mm:.4f} ms, F.conv2d {ms_cv:.4f} ms, bound "
              f"{bound:.4f} ms; x{GLOW['K']}/fwd; rel diff {err:.1e}")
        if err > GLOW_TOL:
            raise AssertionError("nn.conv1x1 disagrees with F.conv2d")
    return res


def phase_glow_score():
    """8b-8c: log p and the score of the full-width Glow on the card
    against the CPU (2 frames), then routed against unrouted on the card
    (batch 30)."""
    import torch
    from audiosourcesep_tpu_torch import nn
    from audiosourcesep_tpu_torch.ops import winograd as W
    t0 = time.time()
    gpu = _glow("cuda").requires_grad_(False)
    cpu = _glow("cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    cpu.requires_grad_(False)
    n_params = sum(p.numel() for p in gpu.parameters())
    print(f"[8b] Glow L={GLOW['L']} K={GLOW['K']} {GLOW['n_filters']} "
          f"filters, learntop: {n_params:,} parameters, built and "
          f"initialised on the card in {time.time() - t0:.2f} s")
    x = _glow_data(2, 81)
    t0 = time.time()
    lp_cpu, s_cpu = cpu.log_prob(x), cpu.score(x)
    t_cpu = time.time() - t0
    lp_gpu, s_gpu = gpu.log_prob(x.cuda()), gpu.score(x.cuda())
    errs = (_rel(lp_gpu, lp_cpu), _rel(s_gpu, s_cpu))
    print(f"[8b] 2 frames, card vs CPU: log p {lp_gpu.tolist()} vs "
          f"{lp_cpu.tolist()}; rel diff log p {errs[0]:.2e}, score "
          f"{errs[1]:.2e} (tol {GLOW_TOL:g}); |score| mean "
          f"{s_cpu.abs().mean().item():.3e}; CPU {t_cpu:.2f} s")
    if not all(torch.isfinite(t).all() for t in (lp_gpu, s_gpu)) \
            or max(errs) > GLOW_TOL:
        raise AssertionError("the Glow on the card disagrees with the CPU")
    del cpu
    x = _glow_data(BATCH, 82).cuda()
    scores, times = {}, {}
    try:
        for routed in (False, True):
            nn.set_winograd(routed)
            _reset_counts()
            scores[routed] = gpu.score(x)
            torch.cuda.synchronize()
            launched = dict(W.launch_counts)
            want = {name: GLOW_ROUTED if routed and dt == torch.float32
                    else 0 for dt, name in W.KERNELS.items()}
            if launched != want:
                raise AssertionError(f"Glow score launches {launched}, "
                                     f"expected {want}")
            times[routed] = cuda_ms(lambda: gpu.score(x), 3)
    finally:
        nn.set_winograd(False)
    err = _rel(scores[True], scores[False])
    print(f"[8c] score of {BATCH} frames (forward + input gradient), "
          f"routed vs cuDNN: rel diff {err:.2e} (tol {GLOW_TOL:g}); "
          f"{GLOW_ROUTED} f32 launches per forward; {times[False]:.2f} ms "
          f"cuDNN, {times[True]:.2f} ms routed; bound "
          f"{1e3 * 2 * glow_forward_flop(BATCH) / PEAK['float32']:.2f} ms "
          f"({2 * glow_forward_flop(BATCH) / 1e12:.3f} TFLOP, a forward and "
          f"its input gradient, at 67 TFLOP/s)")
    if err > GLOW_TOL:
        raise AssertionError("routed Glow score disagrees with cuDNN's")
    del gpu
    torch.cuda.empty_cache()


def _glow_step_split(state, step, x, dq):
    """ms of the loss, of the loss and its backward, of the Adamax update
    and of the whole step (CUDA events)."""
    def fwd():
        return -state.model.log_prob(x, dq).mean()

    def fwd_bwd():
        state.optimizer.zero_grad(set_to_none=True)
        fwd().backward()

    t_fwd = cuda_ms(fwd, 3)
    t_fb = cuda_ms(fwd_bwd, 3)
    t_opt = cuda_ms(state.optimizer.step, 3)
    t_step = cuda_ms(lambda: step(state, x, dequant=dq), 3)
    return t_fwd, t_fb - t_fwd, t_opt, t_step


def phase_glow_train(smi: str):
    """8d: one Adamax step at batch 2 on the card and on the CPU, then the
    step at batch 32 timed apart, TF32 off (routing off and on) and on."""
    import torch
    from audiosourcesep_tpu_torch import nn
    from audiosourcesep_tpu_torch.training import (init_train_state,
                                                   make_flow_train_step,
                                                   setup_optimizer)
    step, _ = make_flow_train_step()
    x, dq = _glow_data(2, 83), torch.rand(2, 96, 64, 1)
    gpu = _glow("cuda")
    cpu = _glow("cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    out = {}
    for device, model in (("cuda", gpu), ("cpu", cpu)):
        state = init_train_state(model, setup_optimizer("adamax", 1e-3))
        _, loss = step(state, x.to(device), dequant=dq.to(device))
        out[device] = (float(loss),
                       {n: p.grad.cpu() for n, p in state.params.items()},
                       {n: p.detach().cpu()
                        for n, p in state.params.items()})
        del state
    del cpu
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = out["cuda"], out["cpu"]
    errs = {"loss": abs(l_gpu - l_cpu) / abs(l_cpu),
            "grad": _rel(g_gpu, g_cpu), "param": _rel(p_gpu, p_cpu)}
    print(f"[8d] one Adamax step, batch 2, card vs CPU: loss {l_gpu:.4f} vs "
          f"{l_cpu:.4f}; rel diff loss {errs['loss']:.2e}, gradients "
          f"{errs['grad']:.2e}, params after the step {errs['param']:.2e} "
          f"(tol {TRAIN_TOL})")
    if any(errs[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
        raise AssertionError("the Glow train step on the card disagrees "
                             "with the CPU")
    del out, g_gpu, p_gpu, g_cpu, p_cpu
    xb = _glow_data(TRAIN_BATCH, 84).cuda()
    dqb = torch.rand(xb.shape, device="cuda")
    times = {}
    for key, routed, tf32 in (("f32", False, False),
                              ("f32 routed", True, False),
                              ("tf32", False, True)):
        state = init_train_state(gpu, setup_optimizer("adamax", 1e-3))
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            nn.set_winograd(routed)
            torch.cuda.reset_peak_memory_stats()
            times[key] = _glow_step_split(state, step, xb, dqb)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            nn.set_winograd(False)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        del state
        t_fwd, t_bwd, t_opt, t_step = times[key]
        onoff = {True: "on", False: "off"}
        print(f"[8d] Glow train step batch {TRAIN_BATCH}, {key} (TF32 "
              f"{onoff[tf32]}, routing {onoff[routed]}): {t_step:.2f} ms; "
              f"apart: forward {t_fwd:.2f}, "
              f"backward {t_bwd:.2f}, Adamax {t_opt:.2f}; peak memory "
              f"{peak:.2f} GiB")
    flop = 3 * glow_forward_flop(TRAIN_BATCH)
    print(f"[8d] step bound: {flop / 1e12:.3f} TFLOP (3 forwards of "
          f"{glow_forward_flop(1) / 1e9:.2f} GFLOP a frame) at 67 TFLOP/s "
          f"f32 = {1e3 * flop / PEAK['float32']:.2f} ms, at 495 TFLOP/s "
          f"TF32 = {1e3 * flop / TF32_PEAK:.2f} ms; card {smi}")
    del gpu
    torch.cuda.empty_cache()
    return times


def phase_glow_cli(work: str, ds: str, counts, full: bool):
    """8e: train_glow -> train_noisy_glow -> run_basis_sep --model_type
    glow --winograd at full width on phase 7a's dataset; returns the f32
    kernel's launches, in all and by path, in the T=2 separation at each
    --score_chunk (8 and 0), by chunk."""
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch import (run_basis_sep, train_glow,
                                          train_noisy_glow)
    from audiosourcesep_tpu_torch.ops import winograd as W
    from audiosourcesep_tpu_torch.training.checkpoint import load_flat
    width = ["--L", str(GLOW["L"]), "--K", str(GLOW["K"]), "--n_filters",
             str(GLOW["n_filters"]), "--learntop", "--device", "cuda"]
    glow, noisy = os.path.join(work, "glow"), os.path.join(work, "noisy")
    L = 10 if full else 2
    # Adamax moves every weight by ~lr a step, the couplings' zero-init
    # last convs too; a 512-filter coupling then sums 4,608 such weights,
    # and 40 couplings a level compound its scale. After two steps at the
    # configs' lr 1e-3, log p and the score overflow on the separation's
    # uniform init and the anneal goes NaN in its first level; at 1e-5 the
    # anneal of --full went NaN in its 7th level (a prior of 16 steps), with
    # the scores clipped. At lr 1e-6 the priors stay near their
    # data-dependent init. The separation clips the scores at +-1/sigma
    # (--score_clip, the JAX package's guard for grad-through-flow priors).
    lr = ["--learning_rate", "1e-6"]
    t0 = time.time()
    train_glow.main(["--dataset", ds, "--output", glow, "--n_epochs", "1",
                     "--batch_size", str(TRAIN_BATCH), *lr, *width])
    wall = time.time() - t0
    with open(os.path.join(glow, "out.log")) as f:
        log = [ln.strip() for ln in f if ln.startswith(
            ("Total Trainable", "Epoch", "Training time", "Validation"))]
    steps = counts[0] // TRAIN_BATCH
    flat, step = load_flat(os.path.join(glow, "ckpts", f"ckpt-{steps}"))
    samples = np.load(os.path.join(glow, "generated_samples",
                                   "generated_samples_1.npy"))
    print(f"[8e] train_glow, batch {TRAIN_BATCH}, 1 epoch ({steps} steps): "
          f"{wall:.2f} s; out.log: {log}; ckpt-{steps}.npz {len(flat)} JAX "
          f"keys; samples {samples.shape}")
    if step != steps or "['opt_state'][0].nu['prior']['loc']" not in flat \
            or samples.shape != (32, 96, 64, 1) \
            or not np.isfinite(samples).all():
        raise AssertionError("train_glow outputs")
    t0 = time.time()
    train_noisy_glow.main([glow, "--dataset", ds, "--output", noisy,
                           "--n_epochs", "1", "--batch_size",
                           str(TRAIN_BATCH), "--num_classes", str(L), *lr,
                           *width])
    sigma_dirs = sorted(d for d in os.listdir(noisy)
                        if d.startswith("sigma_"))
    print(f"[8e] train_noisy_glow --num_classes {L}, 1 epoch a level: "
          f"{time.time() - t0:.2f} s; {sigma_dirs}")
    if len(sigma_dirs) != L:
        raise AssertionError("train_noisy_glow sigma directories")
    song = os.path.join(work, "song")
    launches = {}
    # the T=100 run takes all 30 frames at once: a score of 8 frames costs
    # most of one of 30 (the flow's launches, not its FLOPs, set it)
    runs = [(2, 8), (2, 0)] + ([(100, 0)] if full else [])
    for T, chunk in runs:
        out = os.path.join(work, f"sep_glow_T{T}_c{chunk}")
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        run_basis_sep.main([noisy, noisy, "--output", out, "--song_dir",
                            song, "--model_type", "glow", "--winograd",
                            "--T", str(T), "--n_mixed", str(BATCH),
                            "--num_classes", str(L), "--score_chunk",
                            str(chunk), "--score_clip", "1", *width])
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got, paths = dict(W.launch_counts), dict(W.f32_path_counts)
        chunks = -(-BATCH // chunk) if chunk else 1
        want = {name: L * T * 2 * chunks * GLOW_ROUTED
                if dt == torch.float32 else 0
                for dt, name in W.KERNELS.items()}
        # conv1 (2/4 -> 512) thin_in, (8 -> 512) wide, conv3 (512 ->
        # 4/8/16) thin_out: each class's path at each chunk's frames
        want_paths = dict.fromkeys(W.f32_path_counts, 0)
        step = chunk or BATCH
        for (h, w, cin, cout), n in GLOW_CLASSES.items():
            for lo in range(0, BATCH, step):
                b = min(step, BATCH - lo)
                want_paths[W.f32_path((b, h, w, cin), cout)] += L * T * 2 * n
        with open(os.path.join(out, "out.log")) as f:
            dur = [ln.strip() for ln in f if ln.startswith("Duration")]
        res = np.load(os.path.join(out, "results.npz"))
        traj = np.load(os.path.join(out, "results_convergence.npz"))["x1"]
        finite = [float(np.isfinite(t).mean()) for t in traj]
        print(f"[8e] run_basis_sep --model_type glow --winograd --T {T} "
              f"--num_classes {L} --score_chunk {chunk} --score_clip 1: "
              f"{dur}, finite share of x1 after each level {finite}, "
              f"wall-clock "
              f"{wall:.2f} s; peak memory {peak:.2f} GiB; launches {got}, "
              f"expected {want} ({L} levels x T={T} x 2 sources x {chunks} "
              f"chunks x {GLOW_ROUTED}); by path {paths}, expected "
              f"{want_paths}; x1 {res['x1'].shape} in "
              f"[{res['x1'].min():.2f}, {res['x1'].max():.2f}] dB")
        if got != want or paths != want_paths:
            raise AssertionError("the Glow separation did not launch the "
                                 "f32 kernel for every routed conv, on its "
                                 "classes' paths")
        for key in ("x1", "x2"):
            if res[key].shape != (BATCH, 96, 64) \
                    or not np.isfinite(res[key]).all() \
                    or res[key].min() < -100.0 or res[key].max() > 20.0:
                raise AssertionError(f"results.npz {key}")
        launches[(T, chunk)] = got[W.KERNELS[torch.float32]], paths
    return {chunk: launches[(2, chunk)] for chunk in (8, 0)}


# ---------------------------------------------------------------------------
# phase 9: the image path (MNIST / CIFAR-10 stand-ins, RealNVP, Flow++)
# ---------------------------------------------------------------------------

def phase_image_data(work: str):
    """9: random uint8 images in the MNIST (28x28) and CIFAR-10 (32x32x3)
    npz layouts, named by ASR_MNIST_NPZ / ASR_CIFAR10_NPZ (the test set
    one eval batch). Returns the training-set size."""
    import numpy as np
    rng = np.random.default_rng(9)
    n_train, n_test = 512, 64
    for name, shape in (("MNIST", (28, 28)), ("CIFAR10", (32, 32, 3))):
        path = os.path.join(work, f"{name.lower()}.npz")
        np.savez(path, x_train=rng.integers(0, 256, (n_train, *shape),
                                            np.uint8),
                 x_test=rng.integers(0, 256, (n_test, *shape), np.uint8))
        os.environ[f"ASR_{name}_NPZ"] = path
    print(f"[9] wrote random uint8 MNIST-layout and CIFAR-10-layout npz "
          f"caches: {n_train} train, {n_test} test images each")
    return n_train


def phase_image_kernel():
    """9a: both kernels at the image NCSN's classes (batch IMG_BATCH) and
    at Flow++'s (batch FLOWPP_BATCH), against their plain version and
    F.conv2d; the f32 kernel at the image Glow's classes in the chunks of
    8 and 2 images that its separation (9e) scores IMG_BATCH images in.
    Returns the result of each route by name."""
    import torch
    import torch.nn.functional as F
    from audiosourcesep_tpu_torch.ops import winograd as W
    g = torch.Generator(device="cuda").manual_seed(9)
    res = {}
    for route, classes, batch in (("image", IMAGE_CLASSES, IMG_BATCH),
                                  ("flowpp", FLOWPP_CLASSES, FLOWPP_BATCH)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            r = res[f"{dname}_{route}"] = _new_result()
            for (h, w, cin, cout), n in classes.items():
                x = torch.randn(batch, h, w, cin, device="cuda",
                                generator=g).to(dtype)
                k = torch.randn(3, 3, cin, cout, device="cuda",
                                generator=g) * (1.0 / (9 * cin)) ** 0.5
                u = W.transform_weights(k).to(dtype)
                xc, kc = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(
                    dtype)
                path, wide = _paths(W, x, u, cout)
                _hold(r, f"{route} {h}x{w} {cin:3d}->{cout:4d}", dname, n,
                      (h, w, cin, cout), lambda: W._winograd_cuda(x, u),
                      lambda: W.winograd_conv2d_reference(x, k),
                      lambda: F.conv2d(xc, kc, padding=1).permute(0, 2, 3,
                                                                  1),
                      tag="[9a]", batch=batch, path=path, run_wide=wide)
                del x, k, u, xc, kc
            _summary(r, f"routed convs of one {route} forward", dname,
                     tag="[9a]", batch=batch)
    r = res["float32_image_glow"] = _new_result()
    what = f"{IMG_BATCH} in chunks of 8 (6) and 2"
    _f32_classes(r, IMAGE_GLOW_CLASSES, {8: IMG_BATCH // 8,
                                         IMG_BATCH % 8: 1}, "[9a]", g,
                 prefix="image glow ")
    _summary(r, "routed convs of one image Glow forward", "float32",
             tag="[9a]", batch=what)
    torch.cuda.empty_cache()
    return res


def phase_image_ncsn(work: str, n_train: int, full: bool):
    """9b: train_ncsn --dataset mnist at full width (routing on),
    ncsn_generate_samples, and run_basis_sep --dataset mnist --winograd at
    n_mixed IMG_BATCH in bf16 and f32; returns each separation's kernel
    launches by dtype name."""
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch import (nn, ncsn_generate_samples,
                                          run_basis_sep, train_ncsn)
    from audiosourcesep_tpu_torch.ops import winograd as W
    f32, bf16 = W.KERNELS[torch.float32], W.KERNELS[torch.bfloat16]
    out, gen = os.path.join(work, "ncsn_img"), os.path.join(work,
                                                            "ncsn_img_gen")
    L, T = 10, 1
    per_fwd = sum(IMAGE_CLASSES.values())
    width = ["--version", "v1", "--n_filters", "192", "--num_classes",
             str(L), "--device", "cuda"]
    steps = n_train // TRAIN_BATCH
    forwards = steps + 1 + L * T            # steps, one eval batch, sampling
    try:
        nn.set_winograd(True)
        _reset_counts()
        t0 = time.time()
        train_ncsn.main(["--dataset", "mnist", "--output", out,
                         "--batch_size", str(TRAIN_BATCH), "--ema",
                         "--n_epochs", "1", "--T", str(T), "--sample_every",
                         "1", *width])
        wall = time.time() - t0
        train_launches = dict(W.launch_counts)
        _reset_counts()
        ncsn_generate_samples.main([out, "--dataset", "mnist", "--output",
                                    gen, "--ema", "--T", str(T),
                                    "--n_samples", "8", *width])
        gen_launches = dict(W.launch_counts)
    finally:
        nn.set_winograd(False)
    with open(os.path.join(out, "out.log")) as f:
        log = [ln.strip() for ln in f if ln.startswith(
            ("Total Trainable", "Epoch", "Training time"))]
    samples = np.load(os.path.join(gen, "generated_samples.npy"))
    print(f"[9b] train_ncsn --dataset mnist, v1 192 filters, batch "
          f"{TRAIN_BATCH}, 1 epoch ({steps} steps), routing on: {wall:.2f} "
          f"s; out.log: {log}; launches {train_launches}; "
          f"ncsn_generate_samples: {samples.shape}, launches "
          f"{gen_launches}")
    if train_launches != {f32: forwards * per_fwd, bf16: 0} \
            or gen_launches != {f32: L * T * per_fwd, bf16: 0}:
        raise AssertionError(f"the image NCSN's training did not launch "
                             f"the f32 kernel {per_fwd} times a forward")
    if samples.shape != (8, 32, 32, 1) or not np.isfinite(samples).all():
        raise AssertionError("image NCSN samples")
    launches = {}
    runs = [(2, "bf16"), (2, "f32")] + ([(100, "bf16")] if full else [])
    for T_sep, dtype in runs:
        sep = os.path.join(work, f"sep_img_T{T_sep}_{dtype}")
        _reset_counts()
        t0 = time.time()
        run_basis_sep.main([out, out, "--dataset", "mnist", "--output", sep,
                            "--ema", "--n_mixed", str(IMG_BATCH), "--T",
                            str(T_sep), "--compute_dtype", dtype,
                            "--winograd", *width])
        wall = time.time() - t0
        got = dict(W.launch_counts)
        mine = f32 if dtype == "f32" else bf16
        want = {name: 2 * L * T_sep * per_fwd if name == mine else 0
                for name in got}
        with open(os.path.join(sep, "out.log")) as f:
            dur = [ln.strip() for ln in f if ln.startswith(
                ("Data Loaded", "Duration"))]
        res = np.load(os.path.join(sep, "results.npz"), allow_pickle=True)
        print(f"[9b] run_basis_sep --dataset mnist --winograd --T {T_sep} "
              f"--compute_dtype {dtype}, {IMG_BATCH} mixtures: {dur}, "
              f"wall-clock {wall:.2f} s; launches {got}, expected {want}; "
              f"results.npz {sorted(res.files)}, x1 {res['x1'].shape}")
        if got != want:
            raise AssertionError("the image separation did not launch its "
                                 "dtype's kernel for every routed conv")
        for key in ("x1", "x2", "mixed"):
            a = res[key]
            if a.shape != (IMG_BATCH, 32, 32) or a.min() < 0 \
                    or a.max() > 255 or not np.array_equal(a, np.round(a)):
                raise AssertionError(f"results.npz {key}")
        if (T_sep, dtype) in ((2, "bf16"), (2, "f32")):
            launches[dtype] = got[mine]
    return launches


def forward_flop(model, run) -> float:
    """FLOPs of the products of one forward ``run()`` of ``model``: its
    convs (2 k^2 C_in C_out per output pixel), dense layers and the
    attention's two products (4 T^2 C per image), from the shapes that
    reach them (forward pre-hooks)."""
    import torch
    from audiosourcesep_tpu_torch import nn
    from audiosourcesep_tpu_torch.bijectors.flowpp_nets import GatedAttn
    total = [0.0]

    def conv(m, args):
        w = m.kernel if isinstance(m, nn.Conv2d) else m.v
        x = args[0]
        total[0] += 2.0 * x.shape[0] * x.shape[2] * x.shape[3] * w.numel()

    def dense(m, args):
        total[0] += 2.0 * args[0].numel() * m.kernel.shape[1]

    def attn(m, args):
        n, h, w, c = args[0].shape
        total[0] += 4.0 * n * (h * w) ** 2 * c

    hooks = []
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.WNConv2d)):
            hooks.append(m.register_forward_pre_hook(conv))
        elif isinstance(m, nn.Dense):
            hooks.append(m.register_forward_pre_hook(dense))
        elif isinstance(m, GatedAttn):
            hooks.append(m.register_forward_pre_hook(attn))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _flow_step_times(state, step, x, noise):
    """ms of the loss (forward), of its backward, of the optimizer (with
    its clip) and of the whole step (CUDA events), and the peak memory
    (GiB) over them."""
    import torch
    from audiosourcesep_tpu_torch.training.train_utils import \
        clip_by_global_norm_

    def fwd():
        return -state.model.log_prob(x, noise).mean()

    def fwd_bwd():
        state.optimizer.zero_grad(set_to_none=True)
        fwd().backward()

    def update():
        if state.spec.clipnorm is not None:
            clip_by_global_norm_([p.grad for p in state.params.values()],
                                 state.spec.clipnorm)
        state.optimizer.step()

    torch.cuda.reset_peak_memory_stats()
    t_fwd = cuda_ms(fwd, 3)
    t_fb = cuda_ms(fwd_bwd, 3)
    t_opt = cuda_ms(update, 3)
    t_step = cuda_ms(lambda: step(state, x, dequant=noise), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return (t_fwd, t_fb - t_fwd, t_opt, t_step), peak


def _print_step(tag, what, times, peak, flop, smi):
    t_fwd, t_bwd, t_opt, t_step = times
    bound = 1e3 * 3 * flop / PEAK["float32"]
    print(f"{tag} {what}: step {t_step:.2f} ms (forward {t_fwd:.2f}, "
          f"backward {t_bwd:.2f}, optimizer {t_opt:.2f}); peak memory "
          f"{peak:.2f} GiB; bound {bound:.2f} ms ({3 * flop / 1e12:.3f} "
          f"TFLOP, 3 forwards, at 67 TFLOP/s f32), {100 * bound / t_step:.1f}"
          f"% of it reached; card {smi}")


def phase_realnvp(work: str, smi: str):
    """9c: RealNVP at train_realnvp's defaults: log p card vs CPU, the
    train step at batch REALNVP_BATCH against its bound, then one epoch of
    train_realnvp --dataset mnist."""
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch import train_realnvp
    from audiosourcesep_tpu_torch.models import build_realnvp
    from audiosourcesep_tpu_torch.training import (init_train_state,
                                                   make_flow_train_step,
                                                   setup_optimizer)
    shape = (32, 32, 1)
    g = torch.Generator().manual_seed(90)
    x = torch.randint(0, 256, (8, *shape), generator=g).float()
    u = torch.rand(x.shape, generator=g)
    gpu = build_realnvp(shape, learntop=True, minibatch=x.cuda(),
                        generator=g, device="cuda", **REALNVP)
    with torch.no_grad():
        # the zero-init output convs drawn small, so the couplings work
        for name, p in gpu.named_parameters():
            if "conv_out.v" in name:
                p.copy_(1e-2 * torch.randn(p.shape, generator=g))
    cpu = build_realnvp(shape, learntop=True, **REALNVP)
    cpu.load_state_dict(gpu.state_dict())
    with torch.no_grad():
        lp_c, lp_g = cpu.log_prob(x, u), gpu.log_prob(x.cuda(), u.cuda())
    err = _rel(lp_g, lp_c)
    n_params = sum(p.numel() for p in gpu.parameters())
    print(f"[9c] RealNVP {REALNVP['n_filters']} filters, "
          f"{REALNVP['n_blocks']} blocks, learntop, {n_params:,} parameters; "
          f"log p of 8 images card vs CPU: rel diff {err:.2e} (tol "
          f"{GLOW_TOL:g}); mean {lp_c.mean().item():.2f}")
    if not torch.isfinite(lp_g).all() or err > GLOW_TOL:
        raise AssertionError("RealNVP on the card disagrees with the CPU")
    del cpu
    xb = torch.randint(0, 256, (REALNVP_BATCH, *shape), device="cuda").float()
    ub = torch.rand(xb.shape, device="cuda")
    flop = forward_flop(gpu, lambda: gpu.log_prob(xb, ub))
    state = init_train_state(gpu, setup_optimizer("adam", 1e-3))
    step, _ = make_flow_train_step()
    times, peak = _flow_step_times(state, step, xb, ub)
    _print_step("[9c]", f"RealNVP train step, Adam, batch {REALNVP_BATCH}, "
                f"f32, TF32 off (convs on cuDNN)", times, peak, flop, smi)
    del state, gpu
    torch.cuda.empty_cache()
    out = os.path.join(work, "realnvp")
    t0 = time.time()
    train_realnvp.main(["--dataset", "mnist", "--output", out, "--learntop",
                        "--n_epochs", "1", "--batch_size",
                        str(REALNVP_BATCH), "--device", "cuda"])
    with open(os.path.join(out, "out.log")) as f:
        log = [ln.strip() for ln in f if ln.startswith(
            ("Total Trainable", "Epoch", "Validation"))]
    print(f"[9c] train_realnvp --dataset mnist (random images), 1 epoch: "
          f"{time.time() - t0:.2f} s; out.log: {log}")
    bpd = [float(ln.split()[-1]) for ln in log if ln.startswith("Valid")]
    if len(bpd) != 1 or not np.isfinite(bpd[0]):
        raise AssertionError("train_realnvp: no finite Validation bits/dim")
    return times


def _flowpp_precision(gpu, cpu, x, eps) -> dict:
    """log p of ``x`` (with ``eps``) by the Flow++ ``gpu`` on the card and
    by ``cpu`` (the same weights) on the CPU, each in f32 and in float64,
    routing off; ``{(device, dtype): log p}`` on the CPU in float64. Both
    models are left in f32."""
    import torch
    lps = {}
    with torch.no_grad():
        for dev, m in (("card", gpu), ("CPU", cpu)):
            where = next(m.parameters()).device
            for dtype in (torch.float32, torch.float64):
                m.to(dtype)
                lps[dev, dtype] = m.log_prob(
                    x.to(where, dtype), eps.to(where, dtype)).cpu().double()
            m.float()
    return lps


def phase_flowpp(smi: str):
    """9d: Flow++ at build_flowpp's defaults and own init on [32, 32, 3]:
    log p card vs CPU (in f32 and float64) and routed vs cuDNN, the
    bisection inverse on the card, and the
    train step (Adam, clip 1) at batch FLOWPP_BATCH, routing off and on;
    returns every kernel's launches in the routed step."""
    import torch
    from audiosourcesep_tpu_torch import nn
    from audiosourcesep_tpu_torch.bijectors.mixlogcdf import (
        mixlog_inv_cdf, mixlog_logcdf)
    from audiosourcesep_tpu_torch.models import build_flowpp
    from audiosourcesep_tpu_torch.ops import winograd as W
    from audiosourcesep_tpu_torch.training import (init_train_state,
                                                   make_flow_train_step,
                                                   setup_optimizer)
    shape = (32, 32, 3)
    g = torch.Generator().manual_seed(91)
    t0 = time.time()
    mb = torch.randint(0, 256, (8, *shape), generator=g).float()
    gpu = build_flowpp(shape, minibatch=mb.cuda(), generator=g,
                       device="cuda", **FLOWPP)
    cpu = build_flowpp(shape, **FLOWPP)
    cpu.load_state_dict(gpu.state_dict())
    n_params = sum(p.numel() for p in gpu.parameters())
    print(f"[9d] Flow++ {FLOWPP}: {n_params:,} parameters, built and "
          f"initialised on the card in {time.time() - t0:.2f} s")
    x = torch.randint(0, 256, (2, *shape), generator=g).float()
    eps = torch.randn(x.shape, generator=g)
    # at build_flowpp's own init (where training starts): log p in f32 and
    # float64 on both devices. In float64 card and CPU must agree; f32's
    # distance from float64 on each device is its rounding, which the
    # mixture CDFs' clip amplifies where they saturate
    lps = _flowpp_precision(gpu, cpu, x, eps)
    f64 = _rel(lps["card", torch.float64], lps["CPU", torch.float64])
    f32 = {d: _rel(lps[d, torch.float32], lps[d, torch.float64])
           for d in ("card", "CPU")}
    print(f"[9d] log p of 2 images, routing off: card vs CPU in float64 "
          f"{f64:.2e} (tol {FLOWPP_F64_TOL:g}); f32 vs float64 on the card "
          f"{f32['card']:.2e}, on the CPU {f32['CPU']:.2e}; float64 "
          f"{lps['CPU', torch.float64].tolist()}")
    if not f64 <= FLOWPP_F64_TOL:
        raise AssertionError("Flow++ in float64 on the card disagrees with "
                             "the CPU")
    lp_g, lp_c = lps["card", torch.float32], lps["CPU", torch.float32]
    err = _rel(lp_g, lp_c)
    print(f"[9d] log p of 2 images in f32 card vs CPU: {lp_g.tolist()} vs "
          f"{lp_c.tolist()}; rel diff {err:.2e} (tol {FLOWPP_TOL:g})")
    if not torch.isfinite(lp_g).all() or err > FLOWPP_TOL:
        raise AssertionError("Flow++ on the card disagrees with the CPU")
    del cpu
    xb = torch.randint(0, 256, (FLOWPP_BATCH, *shape), device="cuda").float()
    eb = torch.randn(xb.shape, device="cuda")
    lps = {}
    try:
        for routed in (False, True):
            nn.set_winograd(routed)
            _reset_counts()
            with torch.no_grad():
                lps[routed] = gpu.log_prob(xb, eb)
            torch.cuda.synchronize()
            want = {name: FLOWPP_ROUTED if routed and dt == torch.float32
                    else 0 for dt, name in W.KERNELS.items()}
            if dict(W.launch_counts) != want:
                raise AssertionError(f"Flow++ log p launches "
                                     f"{W.launch_counts}, expected {want}")
    finally:
        nn.set_winograd(False)
    err = _rel(lps[True], lps[False])
    print(f"[9d] log p of {FLOWPP_BATCH} images routed vs cuDNN: rel diff "
          f"{err:.2e} (tol {FLOWPP_ROUTED_TOL:g}); {FLOWPP_ROUTED} f32 "
          f"launches per forward")
    if err > FLOWPP_ROUTED_TOL:
        raise AssertionError("routed Flow++ log p disagrees with cuDNN's")
    # the bisection inverse at one coupling's size: the checkerboard split
    # at 32x16, 3 channels, 32 components
    k = FLOWPP["n_components"]
    gc = torch.Generator(device="cuda").manual_seed(92)
    size = (FLOWPP_BATCH, 32, 16, 3)
    logits = torch.randn(*size, k, device="cuda", generator=gc)
    means = 2.0 * torch.randn(*size, k, device="cuda", generator=gc)
    log_scales = -torch.rand(*size, k, device="cuda", generator=gc) - 0.2
    xs = 6.0 * torch.rand(size, device="cuda", generator=gc) - 3.0
    ys = torch.exp(mixlog_logcdf(xs, logits, means, log_scales))
    ms_inv = cuda_ms(lambda: mixlog_inv_cdf(ys, logits, means, log_scales),
                     3)
    x_rec = mixlog_inv_cdf(ys, logits, means, log_scales)
    # where a mixture's CDF is flat to f32's resolution (its tails) x is
    # not determined by cdf(x): the round trip is held in CDF space, and
    # the error in x is printed
    cdf_err = (torch.exp(mixlog_logcdf(x_rec, logits, means, log_scales))
               - ys).abs().max().item()
    x_err = (x_rec - xs).abs().flatten()
    print(f"[9d] mixlog_inv_cdf (64 bisection steps) on the card at "
          f"{list(size)} x {k} components, x in [-3, 3]: max|cdf(inv(y)) "
          f"- y| {cdf_err:.2e} (tol 1e-6); |x - inv(cdf(x))| median "
          f"{x_err.median().item():.2e}, max {x_err.max().item():.2e}; "
          f"{ms_inv:.2f} ms")
    if not cdf_err <= 1e-6:
        raise AssertionError("the bisection inverse on the card")
    del logits, means, log_scales, xs, ys, x_rec, x_err
    flop = forward_flop(gpu, lambda: gpu.log_prob(xb, eb))
    step, _ = make_flow_train_step()
    times, launches = {}, None
    for routed in (False, True):
        state = init_train_state(gpu, setup_optimizer("adam", 1e-3,
                                                      clipnorm=1.0))
        try:
            nn.set_winograd(routed)
            if routed:
                _reset_counts()
                step(state, xb, dequant=eb)
                torch.cuda.synchronize()
                launches = dict(W.launch_counts)
                want = {name: FLOWPP_ROUTED if dt == torch.float32 else 0
                        for dt, name in W.KERNELS.items()}
                if launches != want:
                    raise AssertionError(f"the routed Flow++ step launched "
                                         f"{launches}, expected {want}")
            times[routed], peak = _flow_step_times(state, step, xb, eb)
        finally:
            nn.set_winograd(False)
        _print_step("[9d]", f"Flow++ train step, Adam + clip 1, batch "
                    f"{FLOWPP_BATCH}, f32, TF32 off, routing "
                    f"{'on' if routed else 'off'}", times[routed], peak,
                    flop, smi)
        del state
    del gpu
    torch.cuda.empty_cache()
    return launches


def phase_image_glow(work: str, n_train: int, full: bool):
    """9e: train_glow -> train_noisy_glow -> run_basis_sep --model_type
    glow --dataset mnist --winograd at train_glow's width; returns the f32
    kernel's launches in the separation, in all and by path."""
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch import (run_basis_sep, train_glow,
                                          train_noisy_glow)
    from audiosourcesep_tpu_torch.ops import winograd as W
    width = ["--L", str(IMAGE_GLOW["L"]), "--K", str(IMAGE_GLOW["K"]),
             "--n_filters", str(IMAGE_GLOW["n_filters"]), "--learntop",
             "--device", "cuda"]
    glow, noisy = (os.path.join(work, n) for n in ("glow_img", "noisy_img"))
    L = 10 if full else 2
    sig = [*IMAGE_SIGMAS, "--num_classes", str(L)]
    # lr 1e-6 and the score clip as in phase 8e: a 512-filter Glow two
    # steps from its init separates to NaN at the configs' lr
    lr = ["--learning_rate", "1e-6"]
    t0 = time.time()
    train_glow.main(["--dataset", "mnist", "--output", glow, "--n_epochs",
                     "1", "--batch_size", str(IMAGE_GLOW_BATCH), *lr,
                     *width])
    with open(os.path.join(glow, "out.log")) as f:
        log = [ln.strip() for ln in f if ln.startswith(
            ("Total Trainable", "Epoch", "Training time", "Validation"))]
    print(f"[9e] train_glow --dataset mnist, L={IMAGE_GLOW['L']} "
          f"K={IMAGE_GLOW['K']} {IMAGE_GLOW['n_filters']} filters, batch "
          f"{IMAGE_GLOW_BATCH}, 1 epoch ({n_train // IMAGE_GLOW_BATCH} "
          f"steps): {time.time() - t0:.2f} s; out.log: {log}")
    if not any(ln.startswith("Validation bits/dim") for ln in log):
        raise AssertionError("train_glow --dataset mnist: no bits/dim")
    t0 = time.time()
    train_noisy_glow.main([glow, "--dataset", "mnist", "--output", noisy,
                           "--n_epochs", "1", "--batch_size",
                           str(IMAGE_GLOW_BATCH), *lr, *sig, *width])
    levels = sorted(d for d in os.listdir(noisy) if d.startswith("sigma_"))
    print(f"[9e] train_noisy_glow --dataset mnist, {L} levels: "
          f"{time.time() - t0:.2f} s; {levels}")
    if len(levels) != L:
        raise AssertionError("train_noisy_glow sigma directories")
    out, chunk, T = os.path.join(work, "sep_glow_img"), 8, 2
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    run_basis_sep.main([noisy, noisy, "--dataset", "mnist", "--model_type",
                        "glow", "--winograd", "--output", out, "--n_mixed",
                        str(IMG_BATCH), "--T", str(T), "--score_chunk",
                        str(chunk), "--score_clip", "1", "--step_lr",
                        IMAGE_STEP_LR, *sig, *width])
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got, paths = dict(W.launch_counts), dict(W.f32_path_counts)
    chunks = -(-IMG_BATCH // chunk)
    want = {name: L * T * 2 * chunks * IMAGE_GLOW_ROUTED
            if dt == torch.float32 else 0 for dt, name in W.KERNELS.items()}
    # each class's path at each chunk's images (8, ..., 8, 2)
    want_paths = dict.fromkeys(W.f32_path_counts, 0)
    for (h, w, cin, cout), n in IMAGE_GLOW_CLASSES.items():
        for lo in range(0, IMG_BATCH, chunk):
            b = min(chunk, IMG_BATCH - lo)
            want_paths[W.f32_path((b, h, w, cin), cout)] += L * T * 2 * n
    with open(os.path.join(out, "out.log")) as f:
        dur = [ln.strip() for ln in f if ln.startswith("Duration")]
    res = np.load(os.path.join(out, "results.npz"), allow_pickle=True)
    print(f"[9e] run_basis_sep --model_type glow --dataset mnist --winograd "
          f"--T {T} --score_chunk {chunk}, {IMG_BATCH} mixtures: {dur}, "
          f"wall-clock {wall:.2f} s, peak memory {peak:.2f} GiB; launches "
          f"{got}, expected {want}; by path {paths}, expected {want_paths}; "
          f"x1 {res['x1'].shape} in "
          f"[{res['x1'].min():.0f}, {res['x1'].max():.0f}]")
    if got != want or paths != want_paths:
        raise AssertionError("the image Glow separation did not launch the "
                             "f32 kernel for every routed conv, on its "
                             "classes' paths")
    for key in ("x1", "x2"):
        a = res[key]
        if a.shape != (IMG_BATCH, 32, 32) or a.min() < 0 or a.max() > 255 \
                or not np.array_equal(a, np.round(a)):
            raise AssertionError(f"results.npz {key}")
    return got[W.KERNELS[torch.float32]], paths


# ---------------------------------------------------------------------------
# phase 10: several processes on the one card
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _worker_env():
    """The ranks' environment: the package importable, and this process's
    CPU thread count (torchrun would set 1), so that the data they prepare
    on the CPU rounds as phase 5's."""
    import torch
    return dict(os.environ, PYTHONPATH=HERE,
                OMP_NUM_THREADS=str(torch.get_num_threads()))


def _run_all(cmds, tag: str, timeout: float = 600.0):
    """Run the commands at once; every one must exit 0 in ``timeout``
    seconds (all are killed otherwise). Returns their outputs."""
    procs = [subprocess.Popen(c, env=_worker_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{tag}: a rank exited {p.returncode}:\n"
                                 + out[-6000:])
    return outs


@contextlib.contextmanager
def timed_collectives():
    """While open, time every train step that ``train_ncsn`` makes, the
    bucketed gradient all-reduces inside each (``_mean_over_ranks_``) and
    every ``torch.distributed.all_gather`` (the BASIS mixing's), each on
    the host clock between two ``torch.cuda.synchronize``. Yields
    ``{"step": [s], "all_reduce": [s a step], "all_gather": [[bytes,
    s]]}``. The syncs add no work to the card; they end each span."""
    import torch
    import torch.distributed as dist
    from audiosourcesep_tpu_torch import train_ncsn
    from audiosourcesep_tpu_torch.training import trainers
    rec = {"step": [], "all_reduce": [], "all_gather": []}
    make, mean, gather = (train_ncsn.make_ncsn_train_step,
                          trainers._mean_over_ranks_, dist.all_gather)
    in_step = []

    def clocked(fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def make_timed(*a, **k):
        step, eval_loss = make(*a, **k)

        def timed_step(*sa, **sk):
            in_step.append(0.0)
            out, dt = clocked(step, *sa, **sk)
            rec["step"].append(dt)
            rec["all_reduce"].append(in_step.pop())
            return out
        return timed_step, eval_loss

    def timed_mean(tensors, layout):
        if not in_step:                     # an eval loss's mean
            return mean(tensors, layout)
        _, dt = clocked(mean, tensors, layout)
        in_step[-1] += dt

    def timed_gather(out, t, *a, **k):
        res, dt = clocked(gather, out, t, *a, **k)
        rec["all_gather"].append([t.numel() * t.element_size(), dt])
        return res

    train_ncsn.make_ncsn_train_step = make_timed
    trainers._mean_over_ranks_ = timed_mean
    dist.all_gather = timed_gather
    try:
        yield rec
    finally:
        train_ncsn.make_ncsn_train_step = make
        trainers._mean_over_ranks_ = mean
        dist.all_gather = gather


def _ms(times):
    return [round(1e3 * t, 2) for t in times]


def rank_worker(argv):
    """``chip_smoke.py --rank-worker OUT CLI ARGS...``: one rank of a
    phase 10 run. TF32 off and, for ``train_ncsn``, Winograd routing on,
    as in phases 5 and 7d; the CLI's ``main(ARGS)`` under
    :func:`timed_collectives`; then this rank's kernel launches, peak
    memory and times to ``OUT`` (``{rank}`` replaced by the rank)."""
    import torch
    from audiosourcesep_tpu_torch import nn, run_basis_sep, train_ncsn
    from audiosourcesep_tpu_torch.ops import winograd as W
    out, name, args = argv[0], argv[1], argv[2:]
    rank = os.environ.get("RANK") or args[args.index("--process_id") + 1]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    nn.set_winograd(name == "train_ncsn")
    _reset_counts()
    with timed_collectives() as times:
        {"run_basis_sep": run_basis_sep, "train_ncsn": train_ncsn}[
            name].main(args)
    with open(out.replace("{rank}", rank), "w") as f:
        json.dump({"launches": dict(W.launch_counts),
                   "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                   "times": times}, f)


def _rank_reports(pattern, n):
    reports = []
    for r in range(n):
        with open(pattern.replace("{rank}", str(r))) as f:
            reports.append(json.load(f))
    return reports


def _log_lines(path, prefixes):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.startswith(prefixes)]


def _one_process_halves(work: str):
    """Phase 5's separation once more in this process, and beside it, on
    the same inputs, each half of its 30 frames alone: rank r's 15 frames
    of the frame-sharded run, with the draws of the whole (``x_init`` and
    every Langevin noise drawn at 30 frames from the seed and the half
    kept, as each rank does). Returns the 30-frame ``results.npz``, the
    halves' x1 and x2 side by side (post-processed as it is), and the
    score's max|diff| between one forward at 30 frames and one at 15."""
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch import run_basis_sep
    from audiosourcesep_tpu_torch.separation import postprocess
    real = run_basis_sep.basis_separate_per_level
    got = {}

    def with_halves(score_fn, mixed, x_init, sigmas, gen, cfg, **kw):
        start = gen.get_state()
        out = real(score_fn, mixed, x_init, sigmas, gen, cfg, **kw)
        n = x_init.shape[1] // 2
        if 2 * n != x_init.shape[1]:
            raise AssertionError(f"{x_init.shape[1]} frames do not halve")
        halves = []
        for fr in (slice(0, n), slice(n, 2 * n)):
            g = torch.Generator(device=gen.device)
            g.set_state(start)
            x, _ = real(score_fn, mixed[fr], x_init[:, fr], sigmas, None,
                        cfg._replace(collect_trajectory=False),
                        noise_fn=lambda level, step: torch.randn(
                            x_init.shape, generator=g,
                            device=x_init.device)[:, fr])
            halves.append(x)
        got["x"] = torch.cat(halves, 1)[..., 0]
        with torch.no_grad():
            labels = torch.zeros(2 * n, dtype=torch.long,
                                 device=x_init.device)
            whole = score_fn(x_init, labels, 0)[:, :n]
            half = score_fn(x_init[:, :n], labels[:n], 0)
        got["score"] = (float((whole - half).abs().max()),
                        float(whole.abs().max()))
        return out

    out = os.path.join(work, "sep_halves")
    song, p1, p2 = (os.path.join(work, n) for n in ("song", "p1", "p2"))
    run_basis_sep.basis_separate_per_level = with_halves
    try:
        run_basis_sep.main([p1, p2, "--output", out, "--song_dir", song,
                            "--model_type", "ncsn", "--version", "v1",
                            "--n_filters", "192", "--num_classes", "10",
                            "--scale", "dB", "--n_mixed", str(BATCH),
                            "--T", "2", "--compute_dtype", "bf16",
                            "--winograd", "--device", "cuda"])
    finally:
        run_basis_sep.basis_separate_per_level = real
    halves = {k: postprocess(got["x"][i], -100.0, 20.0).cpu().numpy()
              for i, k in enumerate(("x1", "x2"))}
    return np.load(os.path.join(out, "results.npz")), halves, got["score"]


def _diffs(a, b):
    """(max, mean) |a - b| of x1 and x2."""
    import numpy as np
    return {k: (float(np.abs(a[k] - b[k]).max()),
                float(np.abs(a[k] - b[k]).mean())) for k in ("x1", "x2")}


def _within(diffs, tol) -> bool:
    return all(d[0] <= tol[0] and d[1] <= tol[1] for d in diffs.values())


def phase_multi_basis(work: str, shard_sources: bool, ref_out: str,
                      smi: str):
    """10a / 10b: the T=2 bf16 separation of phase 5 on 2 ranks under
    torchrun, with 10a's mixing all_gather times; returns the bf16
    launches of both ranks together."""
    import statistics
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch.ops import winograd as W
    tag = "[10a]" if shard_sources else "[10b]"
    L, T = 10, 2
    song, p1, p2 = (os.path.join(work, n) for n in ("song", "p1", "p2"))
    out = os.path.join(work, "sep_shard_sources" if shard_sources
                       else "sep_frames")
    report = os.path.join(work, f"{os.path.basename(out)}_{{rank}}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_addr", "localhost",
           "--master_port", str(_free_port()),
           os.path.join(HERE, "chip_smoke.py"), "--rank-worker", report,
           "run_basis_sep", p1, p2, "--output", out, "--song_dir", song,
           "--model_type", "ncsn", "--version", "v1", "--n_filters", "192",
           "--num_classes", str(L), "--scale", "dB", "--n_mixed",
           str(BATCH), "--T", str(T), "--compute_dtype", "bf16",
           "--winograd", "--device", "cuda"] + (
               ["--shard_sources"] if shard_sources else [])
    t0 = time.time()
    _run_all([cmd], tag)
    wall = time.time() - t0
    reports = _rank_reports(report, 2)
    bf16, f32 = W.KERNELS[torch.bfloat16], W.KERNELS[torch.float32]
    per_rank = [r["launches"] for r in reports]
    models = 1 if shard_sources else 2
    want = models * L * T * ROUTED_PER_FORWARD
    logs = [_log_lines(os.path.join(out, n), ("Multi-host", "Layout",
                                              "Duration", "--shard"))
            for n in ("out.log", "out_rank1.log")]
    print(f"{tag} torchrun 2 ranks on cuda:0 (gloo), {BATCH} frames, {L} "
          f"levels, T={T}, bf16, --winograd"
          f"{', --shard_sources' if shard_sources else ''}: wall-clock "
          f"{wall:.2f} s (2 process starts included); rank logs {logs}")
    print(f"{tag} launches per rank {per_rank}, expected {bf16} {want} "
          f"each ({models} model(s) x {L} x T={T} x {ROUTED_PER_FORWARD}); "
          f"peak memory per rank "
          f"{[round(r['peak_mib'], 1) for r in reports]} MiB")
    if any(r.get(bf16) != want or r.get(f32) != 0 for r in per_rank):
        raise AssertionError(f"{tag} kernel launches {per_rank}")
    if shard_sources:
        # each step gathers the other source's [1, 30, 96, 64, 1] f32
        # iterate; the last gather of that size is the result's
        size = BATCH * 96 * 64 * 4
        for r, rep in enumerate(reports):
            g = [t for b, t in rep["times"]["all_gather"] if b == size]
            if len(g) != L * T + 1:
                raise AssertionError(f"{tag} rank {r}: {len(g)} gathers of "
                                     f"{size} bytes, not {L * T + 1}")
            print(f"{tag} rank {r}: mixing all_gather of {size / 1e6:.2f} "
                  f"MB, one a step: median "
                  f"{1e3 * statistics.median(g[:-1]):.3f} ms over "
                  f"{L * T} steps ({_ms(g[:-1])} ms) [{smi}; ranks sharing "
                  f"one card, not scaling]")
    if [lg[0] for lg in logs] != [
            f"Multi-host initialised: process {r} of 2, backend gloo"
            for r in range(2)]:
        raise AssertionError(f"{tag} the ranks did not run on gloo")
    got = np.load(os.path.join(out, "results.npz"))
    ref = np.load(os.path.join(ref_out, "results.npz"))
    conv = np.load(os.path.join(out, "results_convergence.npz"))
    if conv["x1"].shape != (L + 1, BATCH, 96, 64, 1):
        raise AssertionError(f"{tag} convergence {conv['x1'].shape}")
    data = max(float(np.abs(got[k] - ref[k]).max())
               for k in ("gt1", "gt2", "mixed"))
    if data > MULTI_DATA_TOL:
        raise AssertionError(f"{tag} gt1, gt2, mixed differ from phase 5's "
                             f"by {data} dB")
    diffs = _diffs(got, ref)
    tol = MULTI_SRC_TOL if shard_sources else MULTI_FRAMES_TOL
    print(f"{tag} results.npz vs phase 5 (one process, 30 frames), (max, "
          f"mean) |diff| dB: {diffs}, tolerance {tol}; gt1, gt2, mixed "
          f"max|diff| {data} dB (tolerance {MULTI_DATA_TOL})")
    ok = _within(diffs, tol)
    if not shard_sources:
        # the same frames a forward in one process: the layout alone
        again, halves, (score_diff, score_max) = _one_process_halves(work)
        same, alone, batch = (_diffs(again, ref), _diffs(got, halves),
                              _diffs(halves, ref))
        print(f"{tag} one process, phase 5's separation again: (max, mean) "
              f"|diff| vs phase 5 {same}; each 15-frame half alone with the "
              f"draws of the whole: vs this run {alone} (tolerance "
              f"{MULTI_SRC_TOL}), vs phase 5's 30 frames {batch}; one "
              f"forward at 15 frames vs the same frames at 30: max|diff| "
              f"{score_diff:.3e} of max|score| {score_max:.3e}")
        ok = ok and _within(same, MULTI_SRC_TOL) \
            and _within(alone, MULTI_SRC_TOL)
    if not ok:
        raise AssertionError(f"{tag} results differ from one process")
    if sorted(os.listdir(out)) != sorted(
            ["ground_truth1.wav", "ground_truth2.wav", "mix.wav", "out.log",
             "out_rank1.log", "results.npz", "results_convergence.npz"]):
        raise AssertionError(f"{tag} outputs {sorted(os.listdir(out))}")
    return sum(r[bf16] for r in per_rank)


def _epoch_line(path):
    lines = _log_lines(path, ("Epoch",))
    if len(lines) != 1:
        raise AssertionError(f"{path}: epoch lines {lines}")
    return lines[0]


def _losses(line):
    """(train, val) of an ``Epoch ...: Train Loss: a Val Loss: b`` line."""
    parts = line.split()
    return float(parts[4]), float(parts[7])


def _close(got, want) -> bool:
    """Logged (train, val) losses against others, to TRAIN_TOL's loss
    bound or the log's precision (3 and 6 decimals)."""
    return all(abs(g - w) <= max(TRAIN_TOL["loss"] * abs(w), 1e-3)
               for g, w in zip(got, want))


def _param_rel(flat_a, flat_b, prefix):
    import numpy as np
    keys = [k for k in flat_b if k.startswith(prefix)]
    num = sum(float(np.sum((flat_a[k] - flat_b[k]) ** 2)) for k in keys)
    den = sum(float(np.sum(flat_b[k] ** 2)) for k in keys)
    return (num / den) ** 0.5


def phase_multi_train(work: str, ds: str, train_launches: int, smi: str):
    """10c: train_ncsn --multihost, 1 process over NCCL and 2 over gloo,
    with their step and all-reduce times; returns the f32 launches of the
    2 ranks together."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from audiosourcesep_tpu_torch import nn, train_ncsn
    from audiosourcesep_tpu_torch.data import load_melspec_ds
    from audiosourcesep_tpu_torch.models.ncsn import (get_score_model,
                                                      get_sigmas)
    from audiosourcesep_tpu_torch.ops import winograd as W
    from audiosourcesep_tpu_torch.training import (init_train_state,
                                                   make_ncsn_train_step,
                                                   setup_optimizer)
    from audiosourcesep_tpu_torch.training.checkpoint import (
        _flatten, latest_checkpoint, load_flat)
    f32 = W.KERNELS[torch.float32]
    L, T = 10, 1
    args = ["--dataset", ds, "--version", "v1", "--n_filters", "192",
            "--num_classes", str(L), "--batch_size", str(TRAIN_BATCH),
            "--ema", "--n_epochs", "1", "--T", str(T), "--sample_every",
            "1", "--device", "cuda"]
    ref_line = _epoch_line(os.path.join(work, "ncsn", "out.log"))
    ref_flat, ref_step = load_flat(latest_checkpoint(
        os.path.join(work, "ncsn", "ckpts")))

    # one process over NCCL, in this process as phase 7d ran
    out = os.path.join(work, "ncsn_nccl1")
    try:
        nn.set_winograd(True)
        _reset_counts()
        t0 = time.time()
        with timed_collectives() as times:
            train_ncsn.main(args + ["--output", out, "--multihost",
                                    "--coordinator_address",
                                    f"localhost:{_free_port()}",
                                    "--num_processes", "1", "--process_id",
                                    "0"])
        wall = time.time() - t0
    finally:
        nn.set_winograd(False)
    launches = W.launch_counts[f32]
    init = _log_lines(os.path.join(out, "out.log"), ("Multi-host",))
    line = _epoch_line(os.path.join(out, "out.log"))
    flat, step = load_flat(latest_checkpoint(os.path.join(out, "ckpts")))
    rel = {p: _param_rel(flat, ref_flat, p)
           for p in ("['params']", "['ema_params']")}
    print(f"[10c] train_ncsn --multihost --num_processes 1: {init}, "
          f"wall-clock {wall:.2f} s; '{line}' vs phase 7d's '{ref_line}'; "
          f"params ||diff|| / ||7d|| {rel}; f32 launches {launches} "
          f"(7d {train_launches}); steps {_ms(times['step'])} ms (7d's "
          f"{_ms(STEP_TIMES['7d'])}; at world size 1 the step has no "
          f"collective) [{smi}]")
    if init != ["Multi-host initialised: process 0 of 1, backend nccl"]:
        raise AssertionError("[10c] NCCL was not initialised")
    if dist.is_initialized():
        raise AssertionError("[10c] the process group outlived the CLI")
    if not _close(_losses(line), _losses(ref_line)) or step != ref_step \
            or launches != train_launches \
            or max(rel.values()) > TRAIN_TOL["param"]:
        raise AssertionError("[10c] the NCCL run differs from phase 7d")

    # two processes over gloo, each with its own --output
    outs = [os.path.join(work, f"ncsn_gloo_r{r}") for r in range(2)]
    report = os.path.join(work, "ncsn_gloo_{rank}.json")
    port = _free_port()
    cmds = [[sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--rank-worker", report, "train_ncsn", *args, "--output",
             outs[r], "--multihost", "--coordinator_address",
             f"localhost:{port}", "--num_processes", "2", "--process_id",
             str(r)] for r in range(2)]
    t0 = time.time()
    _run_all(cmds, "[10c]")
    wall = time.time() - t0
    reports = _rank_reports(report, 2)
    logs = [os.path.join(outs[0], "out.log"),
            os.path.join(outs[1], "out_rank1.log")]
    lines = [_epoch_line(lg) for lg in logs]
    backends = [_log_lines(lg, ("Multi-host",)) for lg in logs]
    # the reference: one process on the global batches (each the two
    # ranks' shard batches, in rank order) with the same draws
    shards = [load_melspec_ds(os.path.join(ds, "train"),
                              os.path.join(ds, "test"),
                              batch_size=TRAIN_BATCH // 2, num_hosts=2,
                              host_id=r) for r in range(2)]
    for d in shards:
        for split in d[:2]:
            split.data = train_ncsn.preprocess(split.data, -100.0, 20.0,
                                               False, 1e-6)
    sigmas = get_sigmas(1.0, 0.01, L, "logarithmic")
    model = get_score_model("v1", (96, 64, 1), 192, L, sigmas=sigmas,
                            device="cuda")
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = init_train_state(model, setup_optimizer("adam", 1e-3), ema=True)
    step, eval_loss = make_ncsn_train_step(sigmas, ema_decay=0.999)
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        nn.set_winograd(True)
        losses = []
        for b0, b1 in zip(shards[0][0], shards[1][0]):
            state, loss = step(state, torch.as_tensor(
                np.concatenate([b0, b1]), device="cuda"), gen)
            losses.append(float(loss))
        vals = [float(eval_loss(state, torch.as_tensor(
            np.concatenate([e0, e1]), device="cuda"), gen))
            for e0, e1 in zip(shards[0][1], shards[1][1])]
    finally:
        nn.set_winograd(False)
    want = (float(np.mean(losses)), float(np.mean(vals)))
    got = _losses(lines[0])
    flat, step_n = load_flat(latest_checkpoint(os.path.join(outs[0],
                                                            "ckpts")))
    ref_tree = _flatten(state.tree())
    rel = {p: _param_rel(flat, ref_tree, p)
           for p in ("['params']", "['ema_params']")}
    per_rank = [r["launches"] for r in reports]
    forwards = len(losses) + len(vals) + L * T
    print(f"[10c] train_ncsn --multihost, 2 processes on cuda:0: {backends}; "
          f"wall-clock {wall:.2f} s (2 process starts included); epoch "
          f"lines {lines}; one process on the same global batches: train "
          f"{want[0]:.3f}, val {want[1]:.6f}; params ||diff|| / ||one|| "
          f"{rel}; launches per rank {per_rank}, expected {f32} "
          f"{forwards * ROUTED_PER_FORWARD} each ({len(losses)} steps + "
          f"{len(vals)} eval + {L}x{T} Langevin); peak memory per rank "
          f"{[round(r['peak_mib'], 1) for r in reports]} MiB")
    n_grad = sum(t.numel() for t in state.params.values())
    for r, rep in enumerate(reports):
        print(f"[10c] rank {r}: steps at batch {TRAIN_BATCH // 2} a rank "
              f"{_ms(rep['times']['step'])} ms, of them the bucketed "
              f"all-reduce of {n_grad:,} f32 gradients "
              f"{_ms(rep['times']['all_reduce'])} ms [{smi}; ranks sharing "
              f"one card, not scaling]")
    if not all(b == [f"Multi-host initialised: process {r} of 2, backend "
                     f"gloo"] for r, b in enumerate(backends)):
        raise AssertionError("[10c] the 2 ranks did not run on gloo")
    if lines[0] != lines[1]:
        raise AssertionError("[10c] the ranks logged different losses")
    if not _close(got, want) or max(rel.values()) > TRAIN_TOL["param"] \
            or step_n != len(losses):
        raise AssertionError("[10c] 2 ranks differ from one process")
    if os.path.exists(os.path.join(outs[1], "ckpts", "checkpoint.json")):
        raise AssertionError("[10c] rank 1 wrote a checkpoint")
    if any(r.get(f32) != forwards * ROUTED_PER_FORWARD for r in per_rank):
        raise AssertionError(f"[10c] launches {per_rank}")
    print("[10c] rank 0 alone wrote ckpts/ (rank 1's --output has none)")
    return sum(r[f32] for r in per_rank)


def phase_multi_tools(work: str):
    """10d: dryrun_multichip(2) on the card, and technique1 against
    float64."""
    import numpy as np
    from audiosourcesep_tpu_torch import technique1_ncsnv2
    from audiosourcesep_tpu_torch.data import save_tf_records
    from audiosourcesep_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.time()
    loss = dryrun_multichip(2, "cuda", timeout=300)
    print(f"[10d] dryrun_multichip(2) on cuda:0 (gloo): DP NCSN step, "
          f"frame-sharded NCSN and Glow anneals, source-sharded NCSN and "
          f"Glow anneals, all finite; loss {loss:.4f}; "
          f"{time.time() - t0:.1f} s")
    ds = os.path.join(work, "technique1")
    specs = np.random.default_rng(0).uniform(
        -100.0, 20.0, (2000, 96, 64)).astype(np.float32)
    t0 = time.time()
    for split, arr in (("train", specs), ("test", specs[:8])):
        os.makedirs(os.path.join(ds, split))
        save_tf_records(list(arr), os.path.join(ds, split, "x.tfrecord"))
    written = time.time() - t0
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        got = technique1_ncsnv2.main([ds, "--device", "cuda"])
    wall = time.time() - t0
    flat = ((specs.reshape(2000, -1) + 100.0) / 120.0).astype(np.float64)
    sq = (flat * flat).sum(1)
    want = float(np.sqrt(max((sq[:, None] + sq[None] - 2 * flat @ flat.T)
                             .max(), 0.0)))
    rel = abs(got - want) / want
    print(f"[10d] technique1_ncsnv2 --device cuda on 2,000 synthetic "
          f"spectrograms: {got:.6f} (float64 on the CPU {want:.6f}, rel "
          f"{rel:.2e}, tolerance {TECH1_TOL}); {wall:.2f} s with the load "
          f"(the TFRecords written in {written:.2f} s)")
    if rel > TECH1_TOL:
        raise AssertionError("[10d] technique 1 differs from float64")


def kernels_line(res, routes):
    """The ``kernels`` entries of the JSON line, one per kernel of
    ``ops.winograd.KERNELS``. ``res[dname]`` holds a kernel's numbers over
    one v1 forward's 64 routed convs (batch 30) and ``res[f"{dname}_{r}"]``
    those of its route ``r`` (``dilated``: the cascade's 10 dilated convs;
    ``wide_dilation``: the bf16 kernel at d = 8 and 16, one conv each;
    ``glow``, ``image``, ``flowpp``: the routed convs of one such forward;
    ``glow_chunks``, ``image_glow``: those of a Glow separation's forward
    in its chunks of 8); ``routes[dname][r]`` the launches of route ``r``'s
    main-path run (``""`` for the NCSN separation CLI), which the dilated
    route has none of, and ``routes[dname][f"{r}_paths"]`` the same by
    path. The f32 entry also names the source, C entry and kernel of each
    of its designs (``path_sources``), and each route's numbers by design
    (``by_path``)."""
    from audiosourcesep_tpu_torch.ops.winograd import KERNELS

    def numbers(r):
        out = {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": max(r["by"], key=r["by"].get),
               "library_ms": r["library_ms"]}       # cuDNN F.conv2d
        if r.get("paths"):             # the path of each class
            out["paths"] = r["paths"]
        if r.get("device_ms"):         # f32: no host time between launches
            out["device_ms"] = r["device_ms"]
            out["library_device_ms"] = r["library_device_ms"]
        if r.get("by_path"):           # f32: each design's own numbers
            out["by_path"] = r["by_path"]
        if _has_thin(r):               # the wide f32 kernel forced on them
            out["wide_ms"] = r["wide_ms"]
            out["wide_device_ms"] = r["wide_device_ms"]
        if "host_us" in r:
            out["host_us"] = r["host_us"]
        if "thin_host_us" in r:
            out["thin_host_us"] = r["thin_host_us"]
        return out

    kernels = []
    for dtype, name in KERNELS.items():
        dname = str(dtype).split(".")[1]
        entry = {"name": name, "route": "cuda", "source": SOURCES[dname],
                 "replaces": "audiosourcesep_tpu/ops/winograd.py:136",
                 "launches": routes[dname][""], **numbers(res[dname])}
        if dname == "bfloat16":
            entry["design"] = BF16_DESIGN
        else:
            entry["path_sources"] = {
                p: {"source": src, "entry": c, "kernel": k}
                for p, (src, c, k) in F32_PATHS.items()}
        if "paths" in routes[dname]:
            entry["path_launches"] = routes[dname]["paths"]
        for key in sorted(res):
            if key.startswith(dname + "_"):
                route = key[len(dname) + 1:]
                entry[f"{route}_route"] = numbers(res[key])
                if route in routes[dname]:
                    entry[f"{route}_route"]["launches"] = \
                        routes[dname][route]
                if f"{route}_paths" in routes[dname]:
                    entry[f"{route}_route"]["path_launches"] = \
                        routes[dname][f"{route}_paths"]
        kernels.append(entry)
    return kernels


def main(argv):
    t_start = time.time()
    full = "--full" in argv
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs only on a GPU")
    if not os.path.isdir(os.path.join(HERE, "audiosourcesep_tpu_torch")):
        fail(f"audiosourcesep_tpu_torch not found next to {__file__}")
    sys.path.insert(0, HERE)
    if argv[:1] == ["--rank-worker"]:
        rank_worker(argv[1:])
        return
    if argv[:1] == ["--host-times"]:
        # phase 8a's host time of a launch of each f32 design, alone (no
        # result line): the same measurement on another tree of the port
        phase_device()
        _print_host_us(_thin_host_us(GLOW_CLASSES, 8))
        return

    smi = phase_device()
    phase_build()
    res = phase_kernel(smi)
    phase_model(torch.bfloat16)
    phase_model(torch.float32)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        bf16_launches, _, bf16_out = phase_cli(work, 2, "bf16", inverse=True)
        f32_launches, _, _ = phase_cli(work, 1, "f32")
        launches = {"bfloat16": bf16_launches, "float32": f32_launches}
        phase_inversion(bf16_out)
        ds, counts = phase_train_data(work)
        phase_train_step_vs_cpu()
        phase_train_routing(smi)
        train_launches, _ = phase_train_cli(work, ds, counts)
        res.update({f"float32_{route}": r for route, r in
                    phase_glow_kernel(smi).items()})
        phase_glow_score()
        phase_glow_train(smi)
        glow_launches = phase_glow_cli(work, ds, counts, full)
        if full:
            phase_cli(work, 100, "bf16")
        n_train = phase_image_data(work)
        res.update(phase_image_kernel())
        image_launches = phase_image_ncsn(work, n_train, full)
        phase_realnvp(work, smi)
        flowpp_launches = phase_flowpp(smi)
        image_glow_launches = phase_image_glow(work, n_train, full)
        multi = {"shard_sources": phase_multi_basis(work, True, bf16_out,
                                                    smi),
                 "frame_sharded": phase_multi_basis(work, False, bf16_out,
                                                    smi),
                 "multihost_train": phase_multi_train(work, ds,
                                                      train_launches, smi)}
        phase_multi_tools(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    from audiosourcesep_tpu_torch.ops.winograd import KERNELS
    f32, bf16 = "float32", "bfloat16"
    name = {str(dt).split(".")[1]: n for dt, n in KERNELS.items()}
    routes = {
        # the CLI separation of this dtype (phase 5)
        f32: {"": launches[f32][name[f32]],
              # the same run's launches by path
              "paths": launches[f32]["paths"],
              # the Glow separation CLI (phase 8e), and by path: all 30
              # frames at once, and in chunks of 8
              "glow": glow_launches[0][0], "glow_paths": glow_launches[0][1],
              "glow_chunks": glow_launches[8][0],
              "glow_chunks_paths": glow_launches[8][1],
              # the image Glow separation CLI (phase 9e), chunks of 8
              "image_glow": image_glow_launches[0],
              "image_glow_paths": image_glow_launches[1],
              # the image separation of this dtype (phase 9b)
              "image": image_launches["f32"],
              # one routed Flow++ train step (phase 9d)
              "flowpp": flowpp_launches[name[f32]]},
        bf16: {"": launches[bf16][name[bf16]],
               # the same run's launches by producer path
               "paths": launches[bf16]["paths"],
               "image": image_launches["bf16"],
               # the same step: the flows run in f32, so phase 9d holds
               # this to 0
               "flowpp": flowpp_launches[name[bf16]]},
    }
    kernels = kernels_line(res, routes)
    # phase 10's launches, all ranks together: the two separation layouts
    # (bf16) and the 2-rank training CLI (f32)
    for key, n in multi.items():
        dt = f32 if key == "multihost_train" else bf16
        next(k for k in kernels if k["name"] == name[dt])[
            f"{key}_launches"] = n
    print(f"[10] card: {smi}; chip_smoke.py ran {time.time() - t_start:.0f}"
          f" s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])

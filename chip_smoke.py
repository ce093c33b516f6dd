#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py            # T=2 separation (the default check)
    python3 chip_smoke.py --full     # also the full T=100 separation

Phases, each printed on its own lines; any failure raises (exit != 0):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 is turned off for cuDNN convs and matmuls so float32
   comparisons are float32;
2. build of the CUDA kernels from ``audiosourcesep_tpu_torch/csrc``, with
   ptxas' registers, spills and shared memory of each kernel;
3. both Winograd kernels (bf16 on the tensor cores, f32 on the CUDA
   cores) against their plain PyTorch version and F.conv2d at every conv
   class the NCSN v1 forward routes to them (batch 30), with errors, times
   and each class's bound (the least time the card could take);
4. the full-width v1 score network (192 filters, ``[30, 96, 64, 1]``,
   bf16, random weights) with Winograd routing on and off;
5. the separation CLI in-process (``run_basis_sep.main``) on ~70 s of
   synthetic piano/violin wavs with two random-init priors written as
   JAX-format checkpoints: 30 frames, 10 noise levels, ``--winograd``,
   T=2 in bf16 and T=1 in f32; each run must launch its dtype's kernel
   2 models x 10 levels x T x routed convs per forward times, and the
   other kernel never.

Then one JSON line of per-kernel results, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository around this file, it exits non-zero and prints no result.
"""

import json
import os
import shutil
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
BATCH = 30
# kernel vs plain version: (max|err| / max|plain|, mean|err| / mean|plain|,
# max|err| vs F.conv2d / max|plain|). f32 differs only in summation order.
# The bf16 kernel rounds U and V to bf16 as the JAX Pallas kernel does; that
# kernel itself differs from the plain version by up to 8.8e-3 max and
# 4.7e-3 mean (tests/test_torch_winograd.py pins it under 2e-2 and 1e-2).
# F.conv2d (direct, cuDNN) adds its own order and rounding.
TOL = {"float32": (1e-4, 1e-4, 1e-4), "bfloat16": (2e-2, 1e-2, 3e-2)}
MODEL_TOL = 0.05   # routed vs cuDNN forward, mean|diff| / mean|off|, bf16
# published H100 SXM peaks: bf16 dense tensor cores, f32 CUDA cores (FLOP/s)
PEAK = {"bfloat16": 989e12, "float32": 67e12}
HBM = 3.35e12      # bytes/s
SOURCES = {"bfloat16": "audiosourcesep_tpu_torch/csrc/winograd_mma.cu",
           "float32": "audiosourcesep_tpu_torch/csrc/winograd.cu"}


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
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"[2] ptxas: {line.strip()}")
    print(f"[2] bf16 kernel: {lib.winograd_f23_bf16_smem_bytes()} bytes of "
          f"dynamic shared memory per block")


def conv_bound(h, w, cin, cout, dname):
    """Least time (ms) of one routed conv at batch BATCH, and what sets it:
    the transform-domain work (16 * tiles * C_in * C_out multiply-adds) at
    the dtype's peak, or x, y and U moved once at the HBM rate."""
    item = 2 if dname == "bfloat16" else 4
    flops = 2 * 16 * BATCH * (h // 2) * (w // 2) * cin * cout
    nbytes = item * (BATCH * h * w * (cin + cout) + 16 * cin * cout)
    t_ops, t_bytes = flops / PEAK[dname], nbytes / HBM
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from audiosourcesep_tpu_torch.ops import winograd as W
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        tol_max, tol_mean, tol_conv = TOL[dname]
        r = res[dname] = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                          "bound_ms": 0.0, "max_abs_err": 0.0,
                          "by": {"operations": 0.0, "bytes": 0.0}}
        for (h, w, cin, cout), n in CONV_CLASSES.items():
            x = torch.randn(BATCH, h, w, cin, device="cuda",
                            generator=g).to(dtype)
            k = torch.randn(3, 3, cin, cout, device="cuda", generator=g) \
                * (1.0 / (9 * cin)) ** 0.5
            u = W.transform_weights(k).to(dtype)
            y = W._winograd_cuda(x, u).float()
            ref = W.winograd_conv2d_reference(x, k).float()
            xc = x.permute(0, 3, 1, 2)
            kc = k.permute(3, 2, 0, 1).to(dtype)
            conv = F.conv2d(xc, kc, padding=1).permute(0, 2, 3, 1).float()
            torch.cuda.synchronize()
            if not torch.isfinite(y).all():
                raise AssertionError(f"non-finite kernel output {h}x{w} "
                                     f"{cin}->{cout} {dname}")
            scale = ref.abs().max().item()
            e_plain = (y - ref).abs().max().item()
            e_mean = ((y - ref).abs().mean() / ref.abs().mean()).item()
            e_conv = (y - conv).abs().max().item()
            r["max_abs_err"] = max(r["max_abs_err"], e_plain)
            ms_k = cuda_ms(lambda: W._winograd_cuda(x, u), 20, 2)
            ms_p = cuda_ms(lambda: W.winograd_conv2d_reference(x, k), 3)
            ms_c = cuda_ms(lambda: F.conv2d(xc, kc, padding=1), 20, 2)
            bound, by = conv_bound(h, w, cin, cout, dname)
            r["ms"] += n * ms_k
            r["plain_ms"] += n * ms_p
            r["library_ms"] += n * ms_c
            r["bound_ms"] += n * bound
            r["by"][by] += n * bound
            print(f"[3] {dname:8s} {h}x{w} {cin:3d}->{cout:3d} x{n:2d}/fwd: "
                  f"rel err vs plain max {e_plain / scale:.2e} (tol "
                  f"{tol_max:g}) mean {e_mean:.2e} (tol {tol_mean:g}), vs "
                  f"F.conv2d max {e_conv / scale:.2e} (tol {tol_conv:g}); "
                  f"ms kernel {ms_k:.4f} plain {ms_p:.4f} F.conv2d "
                  f"{ms_c:.4f} bound {bound:.4f} ({by}), kernel at "
                  f"{100 * bound / ms_k:.1f}% of bound")
            if e_plain > tol_max * scale or e_mean > tol_mean \
                    or e_conv > tol_conv * scale:
                raise AssertionError(f"kernel disagrees at {h}x{w} "
                                     f"{cin}->{cout} {dname}")
            del x, y, ref, conv, u
        print(f"[3] {dname}: routed convs of one forward (batch {BATCH}): "
              f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"F.conv2d {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({100 * r['bound_ms'] / r['ms']:.1f}% "
              f"of it reached)")
    return res


def phase_model():
    import torch
    from audiosourcesep_tpu_torch import nn
    from audiosourcesep_tpu_torch.models.ncsn import get_score_model
    from audiosourcesep_tpu_torch.ops import winograd as W
    model = get_score_model("v1", (96, 64, 1), 192, 10,
                            compute_dtype=torch.bfloat16)
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
        before = W.launch_counts[W.KERNELS[torch.bfloat16]]
        on = model(x, idx)
        torch.cuda.synchronize()
        grew = W.launch_counts[W.KERNELS[torch.bfloat16]] - before
        ms_on = cuda_ms(lambda: model(x, idx), 3)
    finally:
        nn.set_winograd(False)
    if grew != ROUTED_PER_FORWARD:
        raise AssertionError(f"one routed forward launched the bf16 kernel "
                             f"{grew} times, expected {ROUTED_PER_FORWARD}")
    if not (torch.isfinite(on).all() and torch.isfinite(off).all()):
        raise AssertionError("non-finite model output")
    rel = ((on - off).abs().mean() / off.abs().mean()).item()
    print(f"[4] v1 192 filters, x [{BATCH},96,64,1] bf16: routing on "
          f"{ms_on:.2f} ms/forward, off {ms_off:.2f} ms/forward; launches "
          f"per forward {grew}; mean|on-off|/mean|off| {rel:.3e} "
          f"(tol {MODEL_TOL})")
    if rel > MODEL_TOL:
        raise AssertionError("routed forward disagrees with the cuDNN one")
    del model
    torch.cuda.empty_cache()


def _write_song(song_dir: str, seconds: float = 70.0, sr: int = 16000):
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


def phase_cli(work: str, T: int, dtype: str = "bf16"):
    """One separation through the CLI; returns the launches of each
    kernel during it and the wall-clock."""
    import numpy as np
    import torch
    from audiosourcesep_tpu_torch import run_basis_sep
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
    W.launch_count = 0
    for name in W.launch_counts:
        W.launch_counts[name] = 0
    t0 = time.time()
    run_basis_sep.main([p1, p2, "--output", out, "--song_dir", song,
                        "--model_type", "ncsn", "--version", "v1",
                        "--n_filters", "192", "--num_classes", str(L),
                        "--scale", "dB", "--n_mixed", str(BATCH),
                        "--T", str(T), "--compute_dtype", dtype,
                        "--winograd", "--device", "cuda"])
    wall = time.time() - t0
    launches = dict(W.launch_counts)
    expected = 2 * L * T * ROUTED_PER_FORWARD
    mine = W.KERNELS[torch.bfloat16 if dtype == "bf16" else torch.float32]
    res = np.load(os.path.join(out, "results.npz"))
    conv = np.load(os.path.join(out, "results_convergence.npz"))
    with open(os.path.join(out, "out.log")) as f:
        duration = [ln for ln in f.read().splitlines()
                    if ln.startswith("Duration")]
    print(f"[5] CLI T={T} {dtype}: wall-clock {wall:.2f} s (main(), data "
          f"and model load included); out.log: {duration}")
    print(f"[5] kernel launches {launches}, expected {mine}: 2 models x {L} "
          f"levels x T={T} x {ROUTED_PER_FORWARD} = {expected}")
    if launches != {name: expected if name == mine else 0
                    for name in launches}:
        raise AssertionError(f"the {dtype} path did not launch {mine} for "
                             f"every routed conv, and only it")
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
    return launches, wall


def main(argv):
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

    smi = phase_device()
    phase_build()
    res = phase_kernel()
    phase_model()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = {"bfloat16": phase_cli(work, 2, "bf16")[0],
                    "float32": phase_cli(work, 1, "f32")[0]}
        if full:
            phase_cli(work, 100, "bf16")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    from audiosourcesep_tpu_torch.ops.winograd import KERNELS
    kernels = []
    for dtype, name in KERNELS.items():
        dname = str(dtype).split(".")[1]
        r = res[dname]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[dname],
            "replaces": "audiosourcesep_tpu/ops/winograd.py:136",
            # the CLI run of this dtype (phase 5)
            "launches": launches[dname][name],
            "max_abs_err": r["max_abs_err"],
            # batch 30, summed over the 64 routed convs of one v1 forward
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": max(r["by"], key=r["by"].get),
            "library_ms": r["library_ms"],      # cuDNN F.conv2d
        })
    print(f"[6] card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])

#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py            # T=2 separation (the default check)
    python3 chip_smoke.py --full     # also the full T=100 separation

Phases, each printed on its own lines; any failure raises (exit != 0):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 is turned off for cuDNN convs and matmuls so float32
   comparisons are float32;
2. build of the CUDA kernels from ``audiosourcesep_tpu_torch/csrc``;
3. the Winograd kernel against its plain PyTorch version and F.conv2d at
   every conv class the NCSN v1 forward routes to it (batch 30, bf16 and
   f32), with errors and times;
4. the full-width v1 score network (192 filters, ``[30, 96, 64, 1]``,
   bf16, random weights) with Winograd routing on and off;
5. the separation CLI in-process (``run_basis_sep.main``) on ~70 s of
   synthetic piano/violin wavs with two random-init priors written as
   JAX-format checkpoints: 30 frames, 10 noise levels, T=2, bf16,
   ``--winograd``; the kernel's launch count over this run must equal
   2 models x 10 levels x T x routed convs per forward.

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
# kernel vs plain version, as max|err| / max|plain|: f32 differs only in
# summation order; bf16 may round the f32 sum to the neighbouring bf16
# value (2^-7 relative) on either side. F.conv2d (direct, cuDNN) adds its
# own order and, in bf16, its own rounding.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2e-2)}   # (plain, conv)
MODEL_TOL = 0.05   # routed vs cuDNN forward, mean|diff| / mean|off|, bf16


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
    build.load_library()
    print(f"[2] kernels built/loaded in {time.time() - t0:.2f} s: "
          f"{os.path.relpath(so, HERE)}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[2] ptxas: {line.strip()}")


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from audiosourcesep_tpu_torch.ops import winograd as W
    g = torch.Generator(device="cuda").manual_seed(0)
    per_forward = {"bfloat16": [0.0, 0.0, 0.0], "float32": [0.0, 0.0, 0.0]}
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        tol_plain, tol_conv = TOL[dname]
        for (h, w, cin, cout), n in CONV_CLASSES.items():
            x = torch.randn(BATCH, h, w, cin, device="cuda",
                            generator=g).to(dtype)
            k = torch.randn(3, 3, cin, cout, device="cuda", generator=g) \
                * (1.0 / (9 * cin)) ** 0.5
            u = W.transform_weights(k)
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
            e_conv = (y - conv).abs().max().item()
            if dtype == torch.bfloat16:
                max_err = max(max_err, e_plain)
            iters = 10 if h * w * cin * cout < 1e9 else 5
            ms_k = cuda_ms(lambda: W._winograd_cuda(x, u), iters)
            ms_p = cuda_ms(lambda: W.winograd_conv2d_reference(x, k), 3)
            ms_c = cuda_ms(lambda: F.conv2d(xc, kc, padding=1), iters)
            acc = per_forward[dname]
            acc[0] += n * ms_k
            acc[1] += n * ms_p
            acc[2] += n * ms_c
            print(f"[3] {dname:8s} {h}x{w} {cin:3d}->{cout:3d} x{n:2d}/fwd: "
                  f"max|err| vs plain {e_plain:.3e} (rel "
                  f"{e_plain / scale:.2e}, tol {tol_plain:g}), vs F.conv2d "
                  f"{e_conv:.3e} (rel {e_conv / scale:.2e}, tol "
                  f"{tol_conv:g}); ms kernel {ms_k:.4f} plain {ms_p:.4f} "
                  f"F.conv2d {ms_c:.4f}")
            if e_plain > tol_plain * scale or e_conv > tol_conv * scale:
                raise AssertionError(f"kernel disagrees at {h}x{w} "
                                     f"{cin}->{cout} {dname}")
            del x, y, ref, conv, u
    for dname, (a, b, c) in per_forward.items():
        print(f"[3] {dname}: routed convs of one forward (batch {BATCH}): "
              f"kernel {a:.3f} ms, plain {b:.3f} ms, F.conv2d {c:.3f} ms")
    return per_forward["bfloat16"], max_err


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
        before = W.launch_count
        on = model(x, idx)
        torch.cuda.synchronize()
        grew = W.launch_count - before
        ms_on = cuda_ms(lambda: model(x, idx), 3)
    finally:
        nn.set_winograd(False)
    if grew != ROUTED_PER_FORWARD:
        raise AssertionError(f"one routed forward launched the kernel "
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


def phase_cli(work: str, T: int):
    import numpy as np
    from audiosourcesep_tpu_torch import run_basis_sep
    from audiosourcesep_tpu_torch.ops import winograd as W
    song, p1, p2 = (os.path.join(work, n) for n in ("song", "p1", "p2"))
    out = os.path.join(work, f"sep_T{T}")
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
    t0 = time.time()
    run_basis_sep.main([p1, p2, "--output", out, "--song_dir", song,
                        "--model_type", "ncsn", "--version", "v1",
                        "--n_filters", "192", "--num_classes", str(L),
                        "--scale", "dB", "--n_mixed", str(BATCH),
                        "--T", str(T), "--compute_dtype", "bf16",
                        "--winograd", "--device", "cuda"])
    wall = time.time() - t0
    launches = W.launch_count
    expected = 2 * L * T * ROUTED_PER_FORWARD
    res = np.load(os.path.join(out, "results.npz"))
    conv = np.load(os.path.join(out, "results_convergence.npz"))
    with open(os.path.join(out, "out.log")) as f:
        duration = [ln for ln in f.read().splitlines()
                    if ln.startswith("Duration")]
    print(f"[5] CLI T={T}: wall-clock {wall:.2f} s (main(), data and model "
          f"load included); out.log: {duration}")
    print(f"[5] kernel launches {launches}, expected 2 models x {L} levels "
          f"x T={T} x {ROUTED_PER_FORWARD} = {expected}")
    if launches != expected:
        raise AssertionError("the main path did not launch the kernel for "
                             "every routed conv")
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
    (ms_k, ms_p, _), max_err = phase_kernel()
    phase_model()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, _ = phase_cli(work, 2)
        if full:
            phase_cli(work, 100)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{
        "name": "winograd_f23_fwd", "route": "cuda",
        "source": "audiosourcesep_tpu_torch/csrc/winograd.cu",
        "replaces": "audiosourcesep_tpu/ops/winograd.py:136",
        "launches": launches, "max_abs_err": max_err,
        # bf16, batch 30: the 64 routed convs of one v1 forward
        "ms": ms_k, "plain_ms": ms_p,
    }]
    print(f"[6] card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])

#!/usr/bin/env python3
"""Where the port's bf16 Winograd kernel spends its time, on one CUDA card.

    python3 benchmarks/torch_winograd_probe.py

Builds ``audiosourcesep_tpu_torch/csrc/winograd_mma.cu`` a second time
with ``-DWINOGRAD_PROBE``: each warp then sums the ``clock64`` cycles it
spends in each phase of its loop over 16-channel chunks. For each conv
class that the NCSN v1 forward routes to the kernel (batch 30) it prints
the plain build's time, the probed build's time, and the cycles per
chunk of each phase (the MMAs, the V transform, issuing the copies,
waiting for copies, the barrier), averaged over the eight warps. The
probe build is slower than the plain one; the phase shares are what it
is for.
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = [(96, 64, 1, 192), (96, 64, 192, 192), (96, 64, 192, 384),
           (96, 64, 192, 1), (48, 32, 384, 384), (48, 32, 384, 192),
           (48, 32, 192, 192)]
BATCH = 30
PHASES = ("mma", "transform", "copies", "wait", "barrier")


def build_probe(build):
    src = os.path.join(build.CSRC, "winograd_mma.cu")
    so = os.path.join(build.BUILD_DIR, f"winograd_probe_{os.getpid()}.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-DWINOGRAD_PROBE",
           "-shared", "-o", so, src]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    os.unlink(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.winograd_f23_fwd_bf16.argtypes = [P, P, P, I, I, I, I, I, P]
    lib.winograd_f23_fwd_bf16.restype = I
    lib.winograd_f23_bf16_probe.restype = I
    return lib


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the probe runs only on a GPU")
    sys.path.insert(0, HERE)
    from audiosourcesep_tpu_torch.kernels import build
    from audiosourcesep_tpu_torch.ops import winograd as W
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    lib = build_probe(build)
    buf = (ctypes.c_ulonglong * 40)()
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    for h, w, cin, cout in CLASSES:
        x = torch.randn(BATCH, h, w, cin, device="cuda",
                        generator=g).bfloat16()
        u = torch.randn(16, cin, cout, device="cuda", generator=g).bfloat16()
        y = torch.empty(BATCH, h, w, cout, device="cuda",
                        dtype=torch.bfloat16)

        def probed():
            err = lib.winograd_f23_fwd_bf16(x.data_ptr(), u.data_ptr(),
                                            y.data_ptr(), BATCH, h, w, cin,
                                            cout, stream)
            assert err == 0, err

        ms_plain = ms(lambda: W._winograd_cuda(x, u))
        probed()
        assert lib.winograd_f23_bf16_probe(buf) == 0
        ms_probe = ms(probed)
        assert lib.winograd_f23_bf16_probe(buf) == 0
        blocks = BATCH * -(-h // 8) * -(-w // 16) * -(-cout // 64)
        chunks = 21 * blocks * -(-cin // 16)      # 1 warm-up + 20 timed
        per = [sum(buf[wp * 5 + i] for wp in range(8)) / 8 / chunks
               for i in range(5)]
        tot = sum(per)
        shares = ", ".join(f"{n} {c:.0f} ({100 * c / tot:.0f}%)"
                           for n, c in zip(PHASES, per))
        print(f"{h}x{w} {cin:3d}->{cout:3d}: kernel {ms_plain:.4f} ms, "
              f"probed {ms_probe:.4f} ms; clk per chunk per warp: {shares}; "
              f"total {tot:.0f}")


if __name__ == "__main__":
    main()

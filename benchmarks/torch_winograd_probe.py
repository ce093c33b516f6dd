#!/usr/bin/env python3
"""Where the port's Winograd kernels spend their time, on one CUDA card.

    python3 benchmarks/torch_winograd_probe.py

Builds ``audiosourcesep_tpu_torch/csrc/winograd_mma.cu`` (bf16) and
``csrc/winograd.cu`` (f32) a second time with ``-DWINOGRAD_PROBE``: each
warp then sums the ``clock64`` cycles it spends in each phase of its role
over input-channel chunks (bf16: 16 channels; f32: 8). The bf16 kernel's
warps have two roles: the eight consumer warps (two warpgroups) wait for a
stage to land, form V (the transform), run the wgmmas (issue, and the wait
for the previous chunk's group), and write the output (the epilogue); the
producer warp waits for a free stage and issues its copies. Shares that
add up to more than the consumers' loop show the roles overlapping. For
each conv class that the NCSN v1 forward routes to the kernels (batch 30)
it prints the plain build's time, the probed build's time, and the cycles
per chunk of each phase, averaged over the warps of a role (the epilogue
spread over the chunks). The probe build is slower than the plain one;
the phase shares are what it is for.
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
# dtype name -> source, C entry, probe entry, channels per chunk, and the
# phases of each role as (role, first warp, warps, phase names)
KERNELS = {
    "bfloat16": ("winograd_mma.cu", "winograd_f23_fwd_bf16",
                 "winograd_f23_bf16_probe", 16,
                 (("consumer", 0, 8, ("full wait", "transform", "wgmma",
                                      "epilogue")),
                  ("producer", 8, 1, ("empty wait", "issue")))),
    # (the bf16 kernel's buffer holds 12 warps; on the TMA path only the
    # producer's first warp runs)
    "float32": ("winograd.cu", "winograd_f23_fwd_f32",
                "winograd_f23_f32_probe", 8,
                (("all", 0, 8, ("fma+transform+copies", "wait", "barrier",
                                "epilogue")),)),
}


def build_probe(build, source, entry, probe):
    so = os.path.join(build.BUILD_DIR, f"probe_{os.getpid()}_{entry}.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-DWINOGRAD_PROBE",
           "-shared", "-o", so, os.path.join(build.CSRC, source)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    os.unlink(so)
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = build.SIGNATURES[entry]
    getattr(lib, probe).restype = ctypes.c_int
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

    for dname, (source, entry, probe, kc, roles) in KERNELS.items():
        dtype = getattr(torch, dname)
        lib = build_probe(build, source, entry, probe)
        width = max(len(names) for *_, names in roles)
        n_warps = 12 if dname == "bfloat16" else 8
        buf = (ctypes.c_ulonglong * (n_warps * width))()
        print(f"{dname} ({source}): clk per {kc}-channel chunk per warp")
        for h, w, cin, cout in CLASSES:
            x = torch.randn(BATCH, h, w, cin, device="cuda",
                            generator=g).to(dtype)
            u = torch.randn(16, cin, cout, device="cuda",
                            generator=g).to(dtype)
            y = torch.empty(BATCH, h, w, cout, device="cuda", dtype=dtype)
            if dname == "bfloat16":
                u = W._bf16_u(u)
                p_rows, tc = W._bf16_block(h // 2, w // 2, 1)
                sizes = (cin, cout, u.shape[2], 1)
                geometry = (p_rows, tc, int(W.bf16_path(x) == "tma"))
                blocks = BATCH * -(-h // 2 // (64 // tc)) \
                    * -(-w // 2 // tc) * -(-cout // 64)
            else:
                sizes = (cin, cout, 1)
                geometry = (4,)
                blocks = BATCH * -(-h // 8) * -(-w // 16) * -(-cout // 64)

            def probed():
                err = getattr(lib, entry)(x.data_ptr(), u.data_ptr(),
                                          y.data_ptr(), BATCH, h, w, *sizes,
                                          *geometry, stream)
                assert err == 0, err

            ms_plain = ms(lambda: W._winograd_cuda(x, u))
            probed()
            assert getattr(lib, probe)(buf) == 0
            ms_probe = ms(probed)
            assert getattr(lib, probe)(buf) == 0
            chunks = 21 * blocks * -(-cin // kc)      # 1 warm-up + 20 timed
            parts = []
            for role, w0, n, names in roles:
                per = [sum(buf[wp * width + i] for wp in range(w0, w0 + n))
                       / n / chunks for i in range(len(names))]
                tot = sum(per)
                parts.append(f"{role}: " + ", ".join(
                    f"{p} {c:.0f} ({100 * c / tot:.0f}%)"
                    for p, c in zip(names, per)) + f"; total {tot:.0f}")
            print(f"  {h}x{w} {cin:3d}->{cout:3d}: kernel {ms_plain:.4f} ms, "
                  f"probed {ms_probe:.4f} ms; " + " | ".join(parts))
            del x, u, y

if __name__ == "__main__":
    main()

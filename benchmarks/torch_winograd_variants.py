#!/usr/bin/env python3
"""What the bf16 Winograd kernel's design choices are worth, on one card.

    python3 benchmarks/torch_winograd_variants.py [--old FILE] [name ...]

Builds ``audiosourcesep_tpu_torch/csrc/winograd_mma.cu`` as it is and, for
each variant named below (all by default), a copy with one text edit;
prints each build's ptxas report (spills) and times every build, cuDNN
and, with ``--old``, an earlier source of the kernel with the earlier C
interface (the ``mma.sync`` kernel of ``git show
e10cdac:audiosourcesep_tpu_torch/csrc/winograd_mma.cu``) at the conv
classes that the NCSN v1 forward routes (batch 30), with the totals over
one forward's 64 convs. The ablations compute wrong results on
purpose: they take one part of the work away to show what it costs.

- ``late_wait``: a warpgroup waits for its previous chunk's wgmmas after
  forming the next chunk's row transforms, not before (more overlap, more
  registers);
- ``loads_first``: the slab reads of a chunk before that wait;
- ``no_setmaxnreg``: every warp at the launch's 168 registers;
- ``stages3``: a ring of 3 stages instead of 4;
- ``no_mma``: no wgmma (the transform and the copies alone);
- ``no_lds``: no slab reads (the adds on made-up values);
- ``no_u`` / ``no_x``: no TMA load of U / of the x slab;
- ``no_row_adds``: the row transforms (Bᵀ d) read as made-up rows, not
  formed by adds (what a consumer would save if another warp formed
  them).
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "audiosourcesep_tpu_torch", "csrc",
                      "winograd_mma.cu")
CLASSES = {(96, 64, 1, 192): 1, (96, 64, 192, 192): 18,
           (96, 64, 192, 384): 1, (96, 64, 192, 1): 1,
           (48, 32, 384, 384): 32, (48, 32, 384, 192): 2,
           (48, 32, 192, 192): 9}
BATCH = 30

WAIT = """      if (j > 0) {               // the previous chunk's wgmmas are done:
        wgmma_wait0();           // release its stage
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int e = 0; e < 32; ++e) fence_operand(acc[v][e]);
        if (lane == 0)
          mbar_arrive(bars + 8 * (STAGES + (s == 0 ? STAGES - 1 : s - 1)));
      }
"""
SWEEP = """        uint2 R[5];
#pragma unroll
        for (int r = 0; r < 5; ++r) R[r] = ld_shared8(src + r * rs);
"""


def _sub(src, old, new):
    if old not in src:
        raise ValueError(f"variant edit does not apply: {old[:60]!r}")
    return src.replace(old, new, 1)


def late_wait(src):
    src = _sub(src, WAIT + "      PROBE(2);\n      mbar_wait(",
               "      PROBE(2);\n      mbar_wait(")
    return _sub(src, "      // (B^T d) B along the columns",
                WAIT + "      // (B^T d) B along the columns")


def loads_first(src):
    src = _sub(src, WAIT + "      PROBE(2);\n      mbar_wait(",
               "      PROBE(2);\n      mbar_wait(")
    src = _sub(src, SWEEP, "        uint2 R[5];\n#pragma unroll\n"
               "        for (int r = 0; r < 5; ++r) R[r] = RR[jj][r];\n")
    return _sub(src, "      __nv_bfloat162 tt[3][2][4][2];",
                "      uint2 RR[4][5];\n#pragma unroll\n"
                "      for (int jj = 0; jj < 4; ++jj)\n#pragma unroll\n"
                "        for (int r = 0; r < 5; ++r)\n"
                "          RR[jj][r] = ld_shared8(stage + xoff + (jj & 1) *"
                " X_HALF + (jj >> 1) * 32 + r * rs);\n" + WAIT
                + "      __nv_bfloat162 tt[3][2][4][2];")


def no_setmaxnreg(src):
    for op, n in (("inc", 232), ("inc", 224), ("dec", 40), ("dec", 56)):
        src = _sub(src, f'asm volatile("setmaxnreg.{op}.sync.aligned.u32 '
                   f'{n};\\n" ::: "memory");', ";")
    return src


def stages3(src):
    return _sub(src, "constexpr int STAGES = 4;", "constexpr int STAGES = 3;")


def no_mma(src):
    return _sub(src, """          if (G == 1 && k > 0)
            wgmma_rs<-1>(acc[v], A[v], desc);
          else
            wgmma_rs<1>(acc[v], A[v], desc);""",
                """          asm volatile("" :: "r"(A[v][0]), "r"(A[v][1]),
                       "r"(A[v][2]), "r"(A[v][3]), "l"(desc));""")


def no_lds(src):
    return _sub(src, SWEEP, "        uint2 R[5];\n#pragma unroll\n"
                "        for (int r = 0; r < 5; ++r)\n"
                "          R[r] = make_uint2(src + r, rs * r + j);\n")


def no_u(src):
    src = _sub(src, "mbar_expect_tx(full, p.x_bytes + U_BYTES);",
               "mbar_expect_tx(full, p.x_bytes);")
    return _sub(src, "          tma_load_5d(stage, &tmu, full, k.co0, 0, 4 * j,"
                " 0, 0);\n", "")


def no_x(src):
    src = _sub(src, "mbar_expect_tx(full, p.x_bytes + U_BYTES);",
               "mbar_expect_tx(full, U_BYTES);")
    return _sub(src, "          for (int par = 0; par < 2; ++par)\n",
                "          for (int par = 0; par < 0; ++par)\n")


def no_row_adds(src):
    start = src.index(SWEEP)
    end = src.index("      PROBE(1);\n      // (B^T d) B along the columns")
    body = src[start:end]
    rows = """        uint2 R[6];
#pragma unroll
        for (int r = 0; r < 6; ++r)
          R[r] = ld_shared8(src + (r % 5) * rs + (r / 5) * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ss = 0; ss < 2; ++ss)
#pragma unroll
            for (int k = 0; k < 3; ++k)
              tt[k][ss][jj][h] = u2b(h ? R[3 * ss + k].y : R[3 * ss + k].x);
      }
"""
    return src[:start] + rows + src[end:]


VARIANTS = {f.__name__: f for f in (late_wait, loads_first, no_setmaxnreg,
                                    stages3, no_mma, no_lds, no_u, no_x,
                                    no_row_adds)}


def build_so(build, text, name, workdir):
    src = os.path.join(workdir, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(workdir, f"{name}.so")
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                        so, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    spills = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
              if "spill" in ln or "Performance Loss" in ln]
    return ctypes.CDLL(so), spills


def main(argv):
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the variants run only on a GPU")
    sys.path.insert(0, HERE)
    from audiosourcesep_tpu_torch.kernels import build
    from audiosourcesep_tpu_torch.ops import winograd as W
    old_source = None
    if argv[:1] == ["--old"]:
        old_source, argv = argv[1], argv[2:]
    names = argv or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    text = open(SOURCE).read()
    work = tempfile.mkdtemp(prefix="wino_variants_")
    try:
        run_all(text, names, old_source, work, build, W)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_all(text, names, old_source, work, build, W):
    import torch
    import torch.nn.functional as F
    fns = {}
    for name in ["kernel", *names]:
        lib, spills = build_so(build, text if name == "kernel"
                               else VARIANTS[name](text), name, work)
        fn = lib.winograd_f23_fwd_bf16
        fn.argtypes, fn.restype = build.SIGNATURES["winograd_f23_fwd_bf16"]
        fns[name] = fn
        print(f"{name}: ptxas {' | '.join(spills)}")
    if old_source is not None:
        lib, _ = build_so(build, open(old_source).read(), "mma_sync",
                          work)
        fn = lib.winograd_f23_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns["mma_sync"] = fn
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

    totals = {name: 0.0 for name in [*fns, "cudnn"]}
    for (h, w, cin, cout), n in CLASSES.items():
        x = torch.randn(BATCH, h, w, cin, device="cuda",
                        generator=g).bfloat16()
        k = torch.randn(3, 3, cin, cout, device="cuda", generator=g) \
            * (1.0 / (9 * cin)) ** 0.5
        u = W._bf16_u(W.transform_weights(k).bfloat16())
        y = torch.empty(BATCH, h, w, cout, device="cuda",
                        dtype=torch.bfloat16)
        P, TC = W._bf16_block(h // 2, w // 2, 1)
        tma = int(W.bf16_path(x) == "tma")
        xc, kc = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).bfloat16()
        row = {}
        for name, fn in fns.items():
            if name == "mma_sync":
                args = (BATCH, h, w, cin, cout, 1, 4)
            else:
                args = (BATCH, h, w, cin, cout, u.shape[2], 1, P, TC, tma)

            def run(fn=fn, args=args):
                err = fn(x.data_ptr(), u.data_ptr(), y.data_ptr(), *args,
                         stream)
                assert err == 0, err
            row[name] = ms(run)
        row["cudnn"] = ms(lambda: F.conv2d(xc, kc, padding=1))
        for name, t in row.items():
            totals[name] += n * t
        print(f"{h}x{w} {cin:3d}->{cout:3d} x{n:2d}: " + ", ".join(
            f"{name} {t:.4f}" for name, t in row.items()) + " ms")
    print("64 routed convs of one forward: " + ", ".join(
        f"{name} {t:.3f}" for name, t in totals.items()) + " ms")


if __name__ == "__main__":
    main(sys.argv[1:])

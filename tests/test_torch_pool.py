"""The pool kernels' wrapper (``audiosourcesep_tpu_torch/ops/pool.py``) on
the CPU: what it can show without a card. The kernels themselves
(``csrc/pool.cu``) run in ``tests/test_torch_cuda.py`` and
``chip_smoke.py --pool``; the CPU pools are held to the JAX package in
``tests/test_torch_nn.py``."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from audiosourcesep_tpu_torch.kernels import build
from audiosourcesep_tpu_torch.ops import counting, pool

SRC = (pathlib.Path(pool.__file__).parent.parent / "csrc" / "pool.cu")


def test_ops_pool_imports_with_no_nvcc_and_no_card():
    """Importing the wrapper (and the nets that call it) builds and loads
    nothing: a process with no CUDA toolkit on its PATH and no card
    imports it, runs the CPU pools and counts no launch."""
    code = ("import torch\n"
            "from audiosourcesep_tpu_torch import nn\n"
            "from audiosourcesep_tpu_torch.kernels import build\n"
            "from audiosourcesep_tpu_torch.ops import counting, pool\n"
            "x = torch.ones(1, 3, 6, 6)\n"
            "nn.avg_pool_same(x, 5); nn.max_pool_same(x, 5); "
            "nn.avg_pool2(x)\n"
            "assert build._lib is None\n"
            "assert counting.COUNTS['pool']['launch_count'] == 0\n")
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(pathlib.Path(__file__).parent.parent),
           "JAX_PLATFORMS": "cpu"}
    got = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr


def test_signatures_list_the_pool_entries():
    """``kernels.build.SIGNATURES`` binds each C entry of csrc/pool.cu with
    as many arguments as the source declares."""
    src = SRC.read_text()
    for name in ("pool5_fwd", "pool5_blocks_per_sm", "avg_pool2_fwd"):
        assert name in build.SIGNATURES, name
        decl = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert decl, name
        assert len(build.SIGNATURES[name][0]) == len(decl.group(1)
                                                     .split(",")), name
    assert set(pool.ENTRIES.values()) <= set(build.SIGNATURES)


def test_kernel_limits_are_the_cuda_sources():
    """The wrapper's copies of csrc/pool.cu's limits and modes."""
    src = SRC.read_text()
    for name, value in (("VEC", pool.VEC), ("WIN", pool.WINDOW),
                        ("MAX_THREADS", pool.MAX_THREADS),
                        ("MAX_N", pool.MAX_N)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert f"constexpr int MAX_SMEM = {pool.MAX_SMEM // 1024} * 1024;" in src
    assert "enum { AVG = %d, MAX = %d };" % (pool.MODES["avg5"],
                                             pool.MODES["max5"]) in src


@pytest.mark.parametrize("w,c,want", [
    # the cells' classes: 32 or 64 columns whole, 256 threads a block
    (32, 384, (8, 32)), (64, 192, (4, 64)), (64, 128, (4, 64)),
    (32, 256, (8, 32)),
    # few channels: one group of 3 or 12; narrow maps take more groups,
    # within the shared memory; wide ones are cut into tiles
    (5, 3, (1, 5)), (9, 12, (2, 9)), (1, 4096, (153, 1)),
    (128, 64, (2, 128)), (300, 24, (2, 124))])
def test_block_shape(w, c, want):
    g, tw = pool.block_shape(w, c)
    assert (g, tw) == want
    cols = min(w, tw + 4)
    assert cols * g <= pool.MAX_THREADS
    assert 64 * (tw + 4) * g <= pool.MAX_SMEM


@pytest.mark.parametrize("blocks,h,resident,want", [
    # v1's 48x32 384-channel CRP at batch 30 (6 slabs), 2 blocks an SM of
    # 132: 7-row strips, 1,260 blocks in 5 waves; 3 an SM: 8 rows
    (180, 48, 264, 7), (180, 48, 396, 8),
    # v1's 96x64 and v2's 48x32 and 96x64 classes
    (180, 96, 264, 8), (90, 48, 264, 6), (120, 48, 396, 8),
    # one sample of a small map: strips of a row to spread it over the SMs
    (1, 7, 264, 1), (2, 3, 264, 1),
    # more blocks than the card holds: the longest strips
    (100000, 48, 264, 8)])
def test_strip_rows(blocks, h, resident, want):
    rows = pool.strip_rows(blocks, h, resident)
    assert rows == want and 1 <= rows <= min(h, pool.MAX_ROWS)


def test_counters_layout_and_arithmetic():
    """The pools' counts in ``ops.counting``, under ``pool``: the launches
    in all and by kind, and the layout copies; ``since`` and ``add`` as a
    graph's owner uses them, and a kind the layout lacks refused."""
    before = counting.snapshot()
    assert set(before["pool"]) == {"launch_count", "launch_counts",
                                   "layout_copies"}
    assert set(before["pool"]["launch_counts"]) == set(pool.MODES) | {"avg2"}
    counting.add({"pool": {"launch_count": 3, "layout_copies": 1,
                           "launch_counts": {"avg5": 2, "max5": 0,
                                             "avg2": 1}}}, 2)
    got = counting.since(before)
    assert got["pool"] == {"launch_count": 6, "layout_copies": 2,
                           "launch_counts": {"avg5": 4, "max5": 0,
                                             "avg2": 2}}
    assert got["launch_count"] == got["instnorm"]["launch_count"] == 0
    counting.add(got, -1)
    assert counting.snapshot() == before
    with pytest.raises(KeyError):
        counting.add({"pool": {"launch_counts": {"avg3": 1}}})
    assert counting.snapshot() == before


@pytest.mark.parametrize("fn,args,name", [
    (pool.avg_pool_same, (5,), "avg_pool2d"),
    (pool.max_pool_same, (5,), "max_pool2d"),
    (pool.avg_pool2, (), "avg_pool2d")])
def test_cpu_tensors_take_pytorchs_pools_uncounted(monkeypatch, fn, args,
                                                   name):
    """On the CPU each pool is PyTorch's, forward and backward, and the
    kernels' counters do not move."""
    calls = []
    real = getattr(F, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(F, name, spy)
    x = torch.randn(2, 5, 7, 9, generator=torch.Generator().manual_seed(0))
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    before = counting.snapshot()
    fn(x, *args).sum().backward()
    assert calls and counting.snapshot() == before
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("kind", ["max5", "avg2"])
def test_card_route_backward_is_pytorchs_vjp(monkeypatch, kind):
    """The card's autograd Function: its forward the kernel (here a stand-in
    on the CPU, PyTorch's pool counted as a launch) and its backward the
    VJP of PyTorch's pool recomputed from x, bit for bit the gradient of
    autograd through PyTorch's pool."""
    def kernel(x, k):
        counting.add({"pool": {"launch_count": 1, "launch_counts": {k: 1}}})
        return (F.max_pool2d(x, 5, 1, 2) if k == "max5"
                else F.avg_pool2d(x, 2, 2))

    monkeypatch.setattr(pool, "_pool_cuda", kernel)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 7, 6, generator=g)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    before = counting.snapshot()
    out = pool._Pooled.apply(xs[0], kind)
    gy = torch.randn(out.shape, generator=g)
    out.backward(gy)
    assert counting.since(before)["pool"]["launch_counts"][kind] == 1
    (F.max_pool2d(xs[1], 5, 1, 2) if kind == "max5"
     else F.avg_pool2d(xs[1], 2, 2)).backward(gy)
    assert torch.equal(xs[0].grad, xs[1].grad)
    counting.add(counting.since(before), -1)


def test_the_kernel_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        pool._pool_cuda(torch.ones(2, 8, 5, 5), "avg5")

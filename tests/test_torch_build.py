"""The port's kernel build (audiosourcesep_tpu_torch/kernels/build.py) on
the CPU: what can be checked without nvcc."""

import re

from audiosourcesep_tpu_torch.kernels import build


def test_cached_build_reads_nvcc_log_back(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_log", "")
    so = tmp_path / f"libasrkernels_{build._digest(build._sources())}.so"
    so.write_bytes(b"")
    so.with_suffix(".log").write_text("ptxas info    : Used 200 registers")
    assert build.build() == so
    assert "Used 200 registers" in build.build_log


def test_every_signature_is_exported_with_its_arity():
    text = "\n".join(p.read_text() for p in build._sources())
    for name, (argtypes, _) in build.SIGNATURES.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert m, name
        params = [a for a in m.group(1).split(",") if a.strip()]
        assert len(params) == len(argtypes), name


def test_digest_follows_sources_and_flags(monkeypatch):
    before = build._digest(build._sources())
    monkeypatch.setattr(build, "NVCC_FLAGS", [*build.NVCC_FLAGS, "-lineinfo"])
    assert build._digest(build._sources()) != before


def test_chip_smoke_kernels_line_puts_each_route_under_its_kernel():
    """Each route's numbers and launches sit under the kernel of its
    dtype (the f32 kernel's Glow route once landed under the bf16 entry,
    which followed the f32 one in ``ops.winograd.KERNELS``)."""
    import chip_smoke

    def result(ms):
        return {"ms": ms, "plain_ms": 0.0, "library_ms": 0.0,
                "bound_ms": 1.0, "max_abs_err": 0.0,
                "by": {"operations": 1.0, "bytes": 0.0}}

    res = {"float32": result(1), "float32_dilated": result(2),
           "float32_glow": result(3), "float32_image": result(4),
           "bfloat16": dict(result(11), paths={"96x64 1->192": "plain"}),
           "bfloat16_dilated": result(12), "bfloat16_image": result(14),
           "bfloat16_wide_dilation": result(13)}
    routes = {"float32": {"": 100, "glow": 300, "image": 400},
              "bfloat16": {"": 110, "image": 410,
                           "paths": {"tma": 108, "plain": 2}}}
    line = {k["name"]: k for k in chip_smoke.kernels_line(res, routes)}
    f32, bf16 = line["winograd_f23_fwd_f32"], line["winograd_f23_fwd_bf16"]
    assert f32["source"].endswith("csrc/winograd.cu")
    assert bf16["source"].endswith("csrc/winograd_mma.cu")
    assert (f32["ms"], f32["launches"]) == (1, 100)
    assert (f32["glow_route"]["ms"], f32["glow_route"]["launches"]) == \
        (3, 300)
    assert (f32["image_route"]["ms"], f32["image_route"]["launches"]) == \
        (4, 400)
    assert f32["dilated_route"]["ms"] == 2
    assert "launches" not in f32["dilated_route"]
    assert "glow_route" not in bf16
    assert (bf16["ms"], bf16["image_route"]["launches"]) == (11, 410)
    # the bf16 kernel above d = 4, timed apart from any main-path run
    assert bf16["wide_dilation_route"]["ms"] == 13
    assert "launches" not in bf16["wide_dilation_route"]
    assert "wide_dilation_route" not in f32
    # the bf16 entry names its design and the producer path of each class
    # and of the main path's launches; the f32 entry has neither
    assert bf16["design"] == chip_smoke.BF16_DESIGN
    assert bf16["paths"] == {"96x64 1->192": "plain"}
    assert bf16["path_launches"] == {"tma": 108, "plain": 2}
    assert "design" not in f32 and "paths" not in f32

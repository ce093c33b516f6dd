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

    def result(ms, **kw):
        return dict({"ms": ms, "plain_ms": 0.0, "library_ms": 0.0,
                     "bound_ms": 1.0, "max_abs_err": 0.0,
                     "by": {"operations": 1.0, "bytes": 0.0}}, **kw)

    res = {"float32": result(1, paths={"96x64 1->192": "thin_in",
                                       "96x64 192->192": "wide"},
                             wide_ms=1.2,
                             device_ms=0.9, wide_device_ms=1.1,
                             library_device_ms=1.5),
           "float32_dilated": result(2),
           "float32_glow": result(3, paths={"48x32 2->512": "thin_in"},
                                  wide_ms=9.0,
                                  device_ms=2.5, wide_device_ms=8.5,
                                  library_device_ms=12.0),
           "float32_glow_chunks": result(
               5, paths={"48x32 2->512 batch 8": "thin_in"}, wide_ms=10.0,
               device_ms=3.0, wide_device_ms=9.0, library_device_ms=13.0,
               by_path={"thin_in": {"ms": 5, "device_ms": 3.0}}),
           "float32_image": result(4),
           "bfloat16": dict(result(11), paths={"96x64 1->192": "plain"}),
           "bfloat16_dilated": result(12), "bfloat16_image": result(14),
           "bfloat16_wide_dilation": result(13)}
    routes = {"float32": {"": 100, "glow": 300, "image": 400,
                          "paths": {"wide": 62, "thin_in": 1,
                                    "thin_out": 1},
                          "glow_paths": {"wide": 0, "thin_in": 150,
                                         "thin_out": 150},
                          "glow_chunks": 500,
                          "glow_chunks_paths": {"wide": 100, "thin_in": 200,
                                                "thin_out": 200}},
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
    # and of the main path's launches
    assert bf16["design"] == chip_smoke.BF16_DESIGN
    assert bf16["paths"] == {"96x64 1->192": "plain"}
    assert bf16["path_launches"] == {"tma": 108, "plain": 2}
    assert "design" not in f32 and "wide_ms" not in bf16
    # the f32 entry: the design of each class, the main path's launches by
    # design, the Glow route's too, the wide kernel forced on the thin
    # classes of each route that has them, and device times (no host time
    # between launches)
    assert f32["paths"] == {"96x64 1->192": "thin_in",
                            "96x64 192->192": "wide"}
    assert f32["path_launches"] == {"wide": 62, "thin_in": 1, "thin_out": 1}
    assert f32["glow_route"]["path_launches"] == \
        {"wide": 0, "thin_in": 150, "thin_out": 150}
    assert f32["glow_route"]["paths"] == {"48x32 2->512": "thin_in"}
    assert (f32["wide_ms"], f32["glow_route"]["wide_ms"]) == (1.2, 9.0)
    assert (f32["glow_route"]["device_ms"],
            f32["glow_route"]["wide_device_ms"],
            f32["glow_route"]["library_device_ms"]) == (2.5, 8.5, 12.0)
    assert "wide_ms" not in f32["image_route"]
    assert "device_ms" not in bf16
    assert "path_launches" not in f32["image_route"]
    # the Glow separation's chunks: their own numbers and launches
    chunks = f32["glow_chunks_route"]
    assert (chunks["ms"], chunks["launches"]) == (5, 500)
    assert chunks["path_launches"] == {"wide": 100, "thin_in": 200,
                                       "thin_out": 200}
    # each design of the f32 kernel names its source, C entry and kernel,
    # and a route's numbers come by design too
    import pathlib
    root = pathlib.Path(chip_smoke.__file__).parent
    assert set(f32["path_sources"]) == {"wide", "thin_in", "thin_out"}
    for path, src in f32["path_sources"].items():
        assert (root / src["source"]).is_file()
        assert src["kernel"] in (root / src["source"]).read_text()
        assert f"int {src['entry']}(" in (root / src["source"]).read_text()
    assert f32["path_sources"]["thin_out"]["source"].endswith(
        "csrc/winograd_thin.cu")
    assert chunks["by_path"] == {"thin_in": {"ms": 5, "device_ms": 3.0}}
    assert "path_sources" not in bf16

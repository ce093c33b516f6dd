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

"""The port's kernel build (``ops/_build.py``) on the CPU: what names a
library. nvcc exists only where the card is, so nothing is compiled here."""

from efficientat_tpu_torch.ops import _build


def _csrc(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_bytes(b'#include "shared.cuh"\nextern "C" int f() { return g(); }\n')
    (csrc / "shared.cuh").write_bytes(b"inline int g() { return 1; }\n")
    return csrc


def test_lib_path_follows_the_source_and_every_header(tmp_path, monkeypatch):
    # a library is named by its source, every csrc/*.cuh (which a source may
    # include) and the flags: a changed header rebuilds, it is never loaded
    # stale
    csrc = _csrc(tmp_path)
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build._lib_path("k")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk_")
    assert _build._lib_path("k") == first
    (csrc / "shared.cuh").write_bytes(b"inline int g() { return 2; }\n")
    second = _build._lib_path("k")
    assert second != first
    (csrc / "other.cuh").write_bytes(b"// a new header\n")
    third = _build._lib_path("k")
    assert third not in (first, second)
    (csrc / "k.cu").write_bytes(b'extern "C" int f() { return 3; }\n')
    assert _build._lib_path("k") not in (first, second, third)


def test_lib_path_ignores_what_is_not_a_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path)
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build._lib_path("k")
    (csrc / "notes.txt").write_text("not compiled")
    (csrc / "other.cu").write_bytes(b"// another library's source\n")
    assert _build._lib_path("k") == first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._lib_path("k") != first


def test_the_port_sources_share_one_wgmma_body():
    # K1's library and the probe's include the one header that holds the
    # wgmma kernel: the header has its only body, neither source has one
    # (mel_kernel_tc is gone); K1 launches it at 3 and 6 passes, each at 128
    # and 256 mels
    k1 = (_build.CSRC / "mel_kernel.cu").read_text()
    probe = (_build.CSRC / "mel_probe_kernel.cu").read_text()
    header = (_build.CSRC / "mel_wgmma.cuh").read_text()
    assert '#include "mel_wgmma.cuh"' in k1 and '#include "mel_wgmma.cuh"' in probe
    assert header.count("__global__") == 1 and "mel_kernel_wgmma(" in header
    assert probe.count("__global__") == 0
    assert k1.count("__global__") == 0 and "mel_kernel_tc" not in k1
    assert "eat_mel_log(" not in k1 and "eat_mel_log_wgmma(" in k1
    assert "launch<false, PASSES>" in k1
    assert "launch<false, PASSES, 2 * mel_wgmma::MAX_MELS>" in k1
    assert "launch_mels<3>" in k1 and "launch_mels<6>" in k1

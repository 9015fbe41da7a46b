"""The port's kernel build (infimum_tpu_torch.kernels) with a stand-in
compiler: each source's object is keyed on its own source, the local
headers it includes and the flags, so an edit rebuilds only what it
touches. The stand-in writes each output file and logs what it compiled."""

import sys

import pytest
import torch

from infimum_tpu_torch import kernels


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "field.cuh").write_text("// header\n")
    (csrc / "a.cu").write_text('#include "field.cuh"\nint a;\n')
    (csrc / "b.cu").write_text('#include "field.cuh"\nint b;\n')
    (csrc / "c.cu").write_text("int c;\n")
    log = tmp_path / "compiled.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "if args[-1].endswith('.cu'):\n"
        f"    open({str(log)!r}, 'a').write(args[-1].rsplit('/', 1)[1] + '\\n')\n"
        "open(args[args.index('-o') + 1], 'w').write('object')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "SOURCES", ("a.cu", "b.cu", "c.cu"))
    monkeypatch.setattr(kernels, "BUILD_INFO", {})
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))

    def compiled():
        names = log.read_text().split() if log.exists() else []
        log.write_text("")
        return sorted(names)
    return csrc, compiled


def test_build_reuses_unchanged_objects(tree):
    csrc, compiled = tree
    first = kernels.build()
    assert compiled() == ["a.cu", "b.cu", "c.cu"]
    assert all(t is not None for t in kernels.BUILD_INFO["sources"].values())
    assert kernels.build() == first          # nothing changed: cached
    assert compiled() == []
    assert kernels.BUILD_INFO["log"] == "(cached)"
    (csrc / "b.cu").write_text('#include "field.cuh"\nint b2;\n')
    second = kernels.build()
    assert second != first
    assert compiled() == ["b.cu"]
    assert kernels.BUILD_INFO["sources"]["a.cu"] is None
    assert kernels.BUILD_INFO["sources"]["b.cu"] is not None


def test_header_edit_rebuilds_its_includers(tree):
    csrc, compiled = tree
    kernels.build()
    compiled()
    (csrc / "field.cuh").write_text("// header, edited\n")
    kernels.build()
    assert compiled() == ["a.cu", "b.cu"]


def test_port_sources_key_on_field_header():
    """Every CUDA source of the port includes field.cuh, so its key moves
    with the header; the keys of two sources differ."""
    keys = {src: kernels._object_key(src) for src in kernels.SOURCES}
    assert len(set(keys.values())) == len(keys)
    for src in kernels.SOURCES:
        assert '#include "field.cuh"' in (kernels.CSRC / src).read_text()


def test_kernel_refuses_tensors_off_one_card():
    """A launch goes to the card its tensors lie on: tensors on two devices,
    or on none that is a card, are refused before the library is loaded."""
    k = kernels.Kernel("inf_none", 2, 1)
    for a, b in ((torch.zeros(1), torch.zeros(1, device="meta")),
                 (torch.zeros(1), torch.zeros(1))):
        with pytest.raises(ValueError, match="one card"):
            k(a, b, 1)
    assert k.launches == 0

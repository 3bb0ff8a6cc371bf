"""Port: the kernel library's name (ops/_cuda.py::library_name) is a hash of
every source and shared header under csrc/ and of the nvcc flags, so that a
build is reused only while none of them changes. Checked on a temporary
directory, without nvcc."""

import pytest

from owlvit_tpu_torch.ops import _cuda


def _tree(tmp_path):
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text('#include "shared.cuh"\nint b;\n')
    (tmp_path / "shared.cuh").write_text("inline int helper() { return 1; }\n")
    return tmp_path


@pytest.mark.parametrize("edit", ["header", "source", "new_header", "flags"])
def test_library_name_follows_every_input(tmp_path, edit):
    csrc = _tree(tmp_path)
    flags = _cuda.NVCC_FLAGS
    before = _cuda.library_name(csrc, flags)
    assert before == _cuda.library_name(csrc, flags)  # reused while nothing changes
    if edit == "header":
        (csrc / "shared.cuh").write_text("inline int helper() { return 2; }\n")
    elif edit == "source":
        (csrc / "a.cu").write_text('#include "shared.cuh"\nint a2;\n')
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// another shared header\n")
    else:
        flags = (*flags, "-DOWLVIT_PK_BWD_NO_DQ_RED")
    assert _cuda.library_name(csrc, flags) != before


def test_library_name_ignores_other_files(tmp_path):
    csrc = _tree(tmp_path)
    before = _cuda.library_name(csrc, _cuda.NVCC_FLAGS)
    (csrc / "notes.txt").write_text("not a source\n")
    assert _cuda.library_name(csrc, _cuda.NVCC_FLAGS) == before


def test_the_tree_has_its_shared_header():
    """Both attention sources include the shared Hopper header, so the
    tree's library name must follow it."""
    header = _cuda.CSRC / "hopper_mma.cuh"
    assert header.exists()
    for src in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        assert '#include "hopper_mma.cuh"' in (_cuda.CSRC / src).read_text()

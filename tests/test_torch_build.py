"""The kernel build's cache key (``repro_torch.kernels.build``), without
nvcc: a library is rebuilt when its source, any local header the source
includes (directly or through another header), or the flags change."""
import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops


def _tree(tmp_path):
    inc = tmp_path / "inc"
    inc.mkdir()
    (inc / "shared.cuh").write_text('#pragma once\n#include "deep.cuh"\n'
                                    "int shared();\n")
    (inc / "deep.cuh").write_text("int deep();\n")
    src = tmp_path / "k" / "kernel.cu"
    src.parent.mkdir()
    (src.parent / "local.cuh").write_text("int local();\n")
    src.write_text('#include <stdint.h>\n#include "local.cuh"\n'
                   '  #  include "shared.cuh"\nint main() { return 0; }\n')
    return src, inc


def test_local_headers_follow_includes(tmp_path):
    src, inc = _tree(tmp_path)
    got = build.local_headers(src, [inc])
    assert [h.name for h in got] == ["local.cuh", "shared.cuh", "deep.cuh"]


@pytest.mark.parametrize("edited", ["kernel.cu", "local.cuh", "shared.cuh",
                                    "deep.cuh"])
def test_digest_changes_with_the_source_or_any_header(tmp_path, edited):
    src, inc = _tree(tmp_path)
    before = build.source_digest(src, include_dirs=[inc])
    assert build.source_digest(src, include_dirs=[inc]) == before
    path = {"kernel.cu": src, "local.cuh": src.parent / "local.cuh"}.get(
        edited, inc / edited)
    path.write_text(path.read_text() + "// edited\n")
    assert build.source_digest(src, include_dirs=[inc]) != before


def test_digest_changes_with_the_flags(tmp_path):
    src, inc = _tree(tmp_path)
    a = build.source_digest(src, include_dirs=[inc])
    b = build.source_digest(src, flags=build.NVCC_FLAGS + ("-lineinfo",),
                            include_dirs=[inc])
    assert a != b


def test_missing_header_raises(tmp_path):
    src, inc = _tree(tmp_path)
    with pytest.raises(FileNotFoundError, match="shared.cuh"):
        build.source_digest(src, include_dirs=[])


@pytest.mark.parametrize("ops", [fa_ops, gmm_ops], ids=["flash", "gmm"])
def test_wgmma_kernels_hash_the_shared_hopper_header(ops):
    """The two wgmma sources include kernels/csrc/hopper.cuh, so an edit
    of it rebuilds both."""
    headers = build.local_headers(ops.SOURCE)
    assert [h.name for h in headers] == ["hopper.cuh"]
    assert headers[0].parent == build.INCLUDE_DIRS[0]

"""The kernel build's cache key: a library is reused only if its source,
the headers of ``csrc`` and the flags are unchanged.  Needs no ``nvcc``:
only the key is computed."""
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_every_target_source_exists(csrc):
    for source, _ in build.TARGETS.values():
        assert (csrc / f"{source}.cu").is_file(), source
    assert {s for s, _ in build.TARGETS.values()} <= set(build.SIGNATURES)


@pytest.mark.parametrize("target", ["decode_attention", "fused_overlap",
                                    "packed_attention", "swiglu"])
def test_digest_follows_the_headers(csrc, target):
    """Editing only a header changes every target's key, so a stale
    library is never loaded; the key is stable otherwise."""
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["attn_decode.cuh", "gemm_sm90.cuh"]
    for header in headers:
        before = build._digest(*build.TARGETS[target])
        assert build._digest(*build.TARGETS[target]) == before
        header.write_text(header.read_text() + "\n// edited\n")
        assert build._digest(*build.TARGETS[target]) != before


def test_digest_follows_source_and_flags(csrc):
    source, defines = build.TARGETS["packed_attention_quant"]
    before = build._digest(source, defines)
    assert build._digest(source, defines[:1]) != before
    path = csrc / f"{source}.cu"
    path.write_text(path.read_text() + "\n")
    assert build._digest(source, defines) != before

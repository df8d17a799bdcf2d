"""What the SwiGLU wrapper computes in Python for its bf16 kernel
(``repro_torch.kernels.swiglu``): the tile and CTA groups (``plan``),
replayed here against the split ``csrc/swiglu.cu`` derives from them, and
the checks that make the wrapper raise instead of falling back.  Needs no
card: the schedule is integer arithmetic on the shapes, and the checks run
on CPU tensors.  The card tests at ragged shapes check the kernel's own
coverage."""
import pytest
import torch

from repro_torch.kernels import swiglu as sw

# (M, N): chip_smoke's Qwen3-8B (d_ff 12288) and Jamba-1.5-Large (24576)
# shapes, then ragged ones and the card tests' shapes
CHIP_SMOKE = [(8, 12288), (64, 12288), (256, 12288), (257, 12288),
              (8, 24576), (256, 24576)]
RAGGED = [(1, 200), (63, 200), (64, 384), (65, 200), (257, 384),
          (8, 1280), (200, 1280), (513, 12288), (4000, 8), (8, 139 * 256)]


def work(m, n, bm, bn, groups):
    """The kernel's split (csrc/swiglu.cu ``swiglu_bf16_kernel``): (CTA, M
    tile, column strip) for every output tile, each over all of K.  CTA
    c is group c // mt, M tile c % mt; group g takes strips [g ns /
    groups, (g + 1) ns / groups)."""
    mt, ns = -(-m // bm), -(-n // bn)
    return [(g * mt + j, j, s) for g in range(groups)
            for s in range(g * ns // groups, (g + 1) * ns // groups)
            for j in range(mt)]


def _covered_once(m, n, bm, bn, groups):
    """Every (M tile, column strip) is computed by exactly one CTA of the
    grid, a CTA only ever takes its own M tile, and a group's strips are
    one contiguous run.  Returns the most strips a CTA takes."""
    mt, ns = -(-m // bm), -(-n // bn)
    seen = {}
    for cta, m_tile, strip in work(m, n, bm, bn, groups):
        assert 0 <= cta < groups * mt and cta % mt == m_tile
        assert (m_tile, strip) not in seen
        seen[(m_tile, strip)] = cta
    assert sorted(seen) == [(j, s) for j in range(mt) for s in range(ns)]
    for j in range(mt):
        ctas = [seen[(j, s)] for s in range(ns)]
        assert ctas == sorted(ctas)
    return max(sum(1 for c in seen.values() if c == cta)
               for cta in set(seen.values()))


@pytest.mark.parametrize("sms", [132, 114, 78, 1])
@pytest.mark.parametrize("m,n", CHIP_SMOKE + RAGGED)
def test_plan_covers_every_output_tile_once(m, n, sms):
    """Up to 64 rows the swap-AB tile of the fewest rows that hold M,
    above 128 x 128, both 128 columns wide; a grid that fits one wave (or
    is one group), reaching the makespan of the most groups that fit
    (strips per CTA) with as few groups as that takes."""
    bm, bn, groups = sw.plan(m, n, sms)
    assert (bm, bn) in sw.TILES and bn == 128
    assert bm == min(r for r in sw.SWAP_ROWS + (128,) if r >= min(m, 128))
    ns = -(-n // bn)
    assert 1 <= groups <= max(1, ns)
    assert groups * -(-m // bm) <= sms or groups == 1
    fit = max(1, min(ns, sms // -(-m // bm)))
    span = _covered_once(m, n, bm, bn, groups)
    assert span == -(-ns // fit)
    assert groups == 1 or -(-ns // (groups - 1)) > span


@pytest.mark.parametrize("m,n", [(8, 1280), (200, 1280), (65, 4096)])
def test_any_group_count_covers_every_output_tile_once(m, n):
    """The kernel's split is right for every tile and every group count up
    to the strips (the C entry refuses more), strips dividing evenly or
    not."""
    for bm, bn in sorted(sw.TILES):
        for groups in range(1, -(-n // bn) + 1):
            _covered_once(m, n, bm, bn, groups)


def test_chip_smoke_shapes():
    """At the serve's widths: the swap-AB tile at decode sizes, one
    128-column strip per CTA for Qwen3-8B (96 CTAs) and two for Jamba (96
    CTAs, not 192 in two waves), and at prefill sizes the same number of
    strips for every CTA, as few CTAs as reach the makespan of one
    wave."""
    assert sw.plan(8, 12288, 132) == (8, 128, 96)
    assert sw.plan(64, 12288, 132) == (64, 128, 96)
    assert sw.plan(8, 24576, 132) == (8, 128, 96)
    assert sw.plan(256, 12288, 132) == (128, 128, 48)
    assert sw.plan(257, 12288, 132) == (128, 128, 32)
    assert sw.plan(256, 24576, 132) == (128, 128, 64)


@pytest.mark.parametrize("bad,match", [
    ("k_odd", "K > 0 and K and N % 8"), ("n_odd", "K > 0 and K and N % 8"),
    ("k_zero", "K > 0 and K and N % 8"), ("misaligned", "16-byte aligned"),
    ("dtype", "share a dtype"), ("strided", "contiguous"),
    ("shape", "shapes"), ("f32_rows", "its grid's y")])
def test_operand_checks_raise(bad, match):
    """The checks the wrapper makes before any launch: bf16 widths that
    are not multiples of 8, K = 0, a base that is not 16-byte aligned,
    mixed dtypes, a strided x, mismatched shapes and more f32 rows than
    the f32 kernel's grid holds raise ValueError."""
    bf = torch.bfloat16
    x, wg, wu = (torch.zeros(16, 64, dtype=bf), torch.zeros(64, 64, dtype=bf),
                 torch.zeros(64, 64, dtype=bf))
    flat = torch.zeros(16 * 64 + 8, dtype=bf)
    cases = {
        "k_odd": (x[:, :60].contiguous(), wg[:60].contiguous(),
                  wu[:60].contiguous()),
        "n_odd": (x, wg[:, :60].contiguous(), wu[:, :60].contiguous()),
        "k_zero": (x[:, :0].contiguous(), wg[:0], wu[:0]),
        "misaligned": (flat[1:1 + 16 * 64].view(16, 64), wg, wu),
        "dtype": (x, wg.float(), wu),
        "strided": (torch.zeros(16, 128, dtype=bf)[:, ::2], wg, wu),
        "shape": (x, wg, wu[:32]),
        "f32_rows": (torch.zeros(65535 * 64 + 1, 1), torch.zeros(1, 8),
                     torch.zeros(1, 8)),
    }
    with pytest.raises(ValueError, match=match):
        sw.check_operands(*cases[bad])
    sw.check_operands(x, wg, wu)
    sw.check_operands(x.float()[:, :60].contiguous(),
                      wg.float()[:60].contiguous(),
                      wu.float()[:60].contiguous())   # f32 takes any width


def test_wrapper_never_falls_back_to_the_plain_version():
    """A CPU tensor is refused by the kernel's wrapper (the plain version is
    only reached through ``ops``), and nothing is counted as launched."""
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    before = sw.swiglu_cuda.launches
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        sw.swiglu_cuda(x, w, w)
    assert sw.swiglu_cuda.launches == before

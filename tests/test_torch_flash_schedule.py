"""What the flash-attention wrapper computes in Python for its bf16 kernel
(``repro_torch.kernels.flash_attention``): the key chunks (``plan``) and
the items the kernel decodes from its grid (``items``), replayed here
against the causal ranges they must cover.  Needs no card: the schedule is
integer arithmetic on the shapes and offsets.  The card tests at ragged
shapes (``tests/test_torch_cuda.py``) check the kernel's own coverage."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import pytest

from repro_torch.kernels import flash_attention as fa

# (B, Sq, Skv, KV, group, head_dim, offsets): chip_smoke's two shapes at
# Qwen3-8B's heads, the card tests' shapes, then ragged ones
CHIP_SMOKE = [(1, 256, 1024, 8, 4, 128, (512,)),
              (1, 513, 513, 8, 4, 128, (0,))]
SHAPES = CHIP_SMOKE + [
    (3, 37, 280, 2, 4, 128, (0, 100, 250)),
    (2, 77, 77, 2, 2, 256, (0, 0)),
    (1, 256, 2048, 2, 4, 128, (1536,)),
    (2, 50, 40, 1, 8, 64, (0, 3)),
    (3, 13, 200, 2, 1, 64, (186, 0, 63)),
    (1, 1, 5, 1, 1, 128, (4,)),
    (2, 300, 310, 8, 8, 128, (10, 0)),
    (1, 9, 0, 2, 4, 64, (0,)),
]


def _check_schedule(b, sq, skv, kvh, group, d, offsets, sms):
    """Every key a row sees is in exactly one item with keys of the row's
    tile; a tile's chunks with keys are 0 .. live - 1 in grid order, each
    a whole number of 64-key stages but the last; items without keys exit,
    except the one item of a tile that sees no key at all (it writes the
    zeros); a split never takes more CTAs than SMs.  Returns the items."""
    sched = fa.plan(b, sq, skv, kvh, group, sms)
    q_tiles, chunk, n_chunks = sched
    pt = fa.BLOCK_M // group
    assert q_tiles == -(-sq // pt) and chunk % fa.BLOCK_N == 0
    assert n_chunks == max(1, -(-skv // chunk))
    assert n_chunks == 1 or q_tiles * kvh * b * n_chunks <= sms
    its = fa.items(sched, b, sq, skv, kvh, group, offsets)
    assert [it.cta for it in its] == list(range(q_tiles * kvh * b * n_chunks))
    by_tile = {}
    for it in its:
        by_tile.setdefault((it.b, it.kvh, it.qt), []).append(it)
    assert len(by_tile) == q_tiles * kvh * b
    for (bb, _, qt), tile in by_tile.items():
        assert [it.chunk for it in tile] == list(range(n_chunks))
        rows = range(qt * pt, min(qt * pt + pt, sq))
        kend = max(max(0, min(skv, offsets[bb] + p + 1)) for p in rows)
        live = [it for it in tile if it.k1 > it.k0]
        assert all(it.live == len(live) for it in tile)
        assert [it.chunk for it in live] == list(range(len(live)))
        keys = [key for it in live for key in range(it.k0, it.k1)]
        assert keys == list(range(kend))           # each key once, in order
        assert all((it.k1 - it.k0) % fa.BLOCK_N == 0 for it in live[:-1])
        for p in rows:                               # a row's keys are inside
            assert min(skv, offsets[bb] + p + 1) <= kend
        if kend == 0:
            assert tile[0].k0 == tile[0].k1 == 0 and tile[0].live == 0
    return its


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_items_cover_every_key_once(shape, sms):
    _check_schedule(*shape, sms)


@pytest.mark.parametrize("shape", CHIP_SMOKE)
def test_longest_ranges_start_first(shape):
    """One batch row and one offset: within each chunk the CTAs with more
    keys come first in grid order, and every chunk's items come before the
    next chunk's."""
    its = _check_schedule(*shape, 132)
    assert [it.chunk for it in its] == sorted(it.chunk for it in its)
    for c in {it.chunk for it in its}:
        keys = [it.k1 - it.k0 for it in its if it.chunk == c]
        assert keys == sorted(keys, reverse=True)


def test_plan_splits_only_long_ranges_of_few_tiles():
    """The chunk comes from the tiles, Skv and the SM count, never the
    offsets (the plan has none to read): tiles that would need a second
    wave of CTAs to split are not split (chip_smoke's shapes, 128 and
    264 tiles), nor ranges under two chunks of MIN_CHUNK_TILES stages;
    fewer tiles over longer ranges split into as many such chunks as the
    idle SMs take."""
    stages = fa.MIN_CHUNK_TILES * fa.BLOCK_N
    assert fa.plan(1, 256, 1024, 8, 4, 132) == (16, 1024, 1)
    assert fa.plan(1, 513, 513, 8, 4, 132) == (33, 576, 1)
    assert fa.plan(1, 256, 2048, 8, 4, 132) == (16, 2048, 1)
    assert fa.plan(8, 256, 8192, 8, 4, 132)[2] == 1
    assert fa.plan(1, 1, 1024, 8, 4, 132) == (1, 1024, 1)
    assert fa.plan(1, 16, 2 * stages - 64, 8, 4, 132)[2] == 1
    assert fa.plan(1, 16, 2 * stages, 8, 4, 132) == (1, stages, 2)
    assert fa.plan(1, 256, 2 * stages, 1, 4, 132) == (16, stages, 2)
    assert fa.plan(1, 16, 8 * stages, 1, 4, 132) == (1, stages, 8)
    assert fa.plan(1, 16, 8 * stages, 1, 4, 2) == (1, 4 * stages, 2)
    assert fa.plan(1, 16, 100, 1, 4, 132) == (1, 128, 1)

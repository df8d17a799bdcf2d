"""The bf16 flash-attention backward's scratch sizes, on the CPU:
``flash_attention.bwd_scratch`` against the query tiles that the packed
rows of every (batch row, position, query head) fall in, counted one by
one.  The kernel itself runs on the card (tests/test_torch_cuda.py).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import pytest

from repro_torch.kernels import flash_attention as fa

# (batch, S, KV heads, group, head_dim): ragged S, groups whose tiles hold
# 63 rows, one position
SHAPES = [(2, 2048, 8, 4, 128), (1, 1000, 2, 7, 128), (1, 1000, 2, 3, 128),
          (1, 1000, 2, 9, 128), (2, 300, 2, 1, 64), (1, 129, 1, 8, 64),
          (1, 1, 1, 2, 64), (3, 257, 2, 2, 64)]


@pytest.mark.parametrize("b,s,kv,g,d", SHAPES)
def test_bwd_scratch_covers_every_packed_row(b, s, kv, g, d):
    """A query tile holds 64 // group positions of one (batch row, KV
    head), the group's heads beside each other: 64 rows, or 63 at groups
    3, 7 and 9.  The scratch holds two f32 per row of every tile that
    some row falls in, 64 x d f32 dQ sums per tile, and one counter per
    tile plus the work counter."""
    pt = 64 // g
    tiles, rows = set(), set()
    for bb in range(b):
        for pos in range(s):
            for h in range(kv * g):
                tile = (bb, h // g, pos // pt)
                row = (pos % pt) * g + h % g
                assert row < 64
                tiles.add(tile)
                rows.add((tile, row))
    assert len(rows) == b * s * kv * g
    n = len(tiles)
    assert fa.bwd_scratch(b, s, kv, g, d) == (n * 2 * 64, n * 64 * d, n + 1)

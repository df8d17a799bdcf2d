"""Whether opening the attention kernels to GQA groups 3, 7 and 9 (at
head_dim 128) changed the code of the groups built before.

``cuobjdump -sass`` of every kernel library, built from this tree's
sources and from an earlier tree's (``--parent DIR``, a ``git archive``
of the commit under ``build/``), compared function by function: of the
functions the earlier tree has, how many are identical instruction for
instruction, and which differ (a second build of the earlier source
tells a build's own variation apart).  Functions only this tree has are
the new groups' instantiations, counted per library.

    python3 tools/group_probe.py --parent build/parent     (~2 min)
"""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "src"))

from packed_attention_probe import nvcc_build, sass_functions  # noqa: E402

OUT_DIR = ROOT / "build" / "group_probe"
ATTENTION = ("packed_attention", "packed_attention_quant",
             "packed_attention_block", "packed_attention_block_quant",
             "decode_attention", "fused_overlap", "flash_attention")


def libraries(tree: Path, tag: str) -> dict:
    """target -> {function: SASS lines} of ``tree``'s sources."""
    from repro_torch.kernels import build

    def one(target):
        source, defines = build.TARGETS[target]
        return target, sass_functions(nvcc_build(
            tree / f"src/repro_torch/kernels/csrc/{source}.cu", defines,
            OUT_DIR / f"{tag}-{target}.cubin", cubin=True))
    with ThreadPoolExecutor(len(ATTENTION)) as ex:
        return dict(ex.map(one, ATTENTION))


def main() -> int:
    if "--parent" not in sys.argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    old, new = libraries(parent, "parent"), libraries(ROOT, "tree")
    again = None
    for target in ATTENTION:
        a, b = old[target], new[target]
        same = [f for f in a if a[f] == b.get(f)]
        differ = sorted(f for f in a if f not in same)
        print(f"SASS {target}: {len(a)} functions in the parent, {len(b)} in "
              f"this tree ({len(set(b) - set(a))} new), {len(same)} of the "
              f"parent's identical instruction for instruction", flush=True)
        if differ:
            if again is None:
                again = libraries(parent, "parent2")
            noise = {f for f in a if a[f] != again[target].get(f)}
            for f in differ:
                diff = sum(x != y for x, y in zip(a[f], b.get(f, [])))
                print(f"  differs: {f[:90]} ({len(a[f])} / "
                      f"{len(b.get(f, []))} lines, {diff} differ"
                      f"{'; the parent built twice differs too' if f in noise else ''})",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The wgmma/TMA GEMM mainloop (csrc/gemm_sm90.cuh) under SwiGLU and the
fused op's GEMM role, on one NVIDIA card.

    python3 tools/gemm_probe.py [--sweep] [--parent DIR]   # 1 (, 2) (, 3, 4)
    python3 tools/gemm_probe.py --ptxas                    # 5

1. The fused op's GEMM role alone (x (1024, 4096) @ w (4096, 4096),
   chip_smoke's shape) on every CTA beside ``torch.matmul``, and with only
   half the CTAs on GEMM tiles (one per SM).
2. ``--sweep``: SwiGLU's bf16 schedules through its C entry, at Qwen3-8B's
   widths (4096 -> 12288) for T = 8, 16, 32, 64, 256 and 257 and at
   Jamba-1.5-Large's (8192 -> 24576) for T = 8 and 256: every tile of
   ``swiglu.TILES`` that fits T (a swap-AB tile only at the fewest rows
   that hold T) at whole-strip group counts (every strip its own CTA,
   half of that, the CTAs of one and of two waves, the plan's), each
   checked against the plain version and timed.
3. With ``--parent DIR`` (an unpacked tree of an earlier commit): DIR's
   csrc/swiglu.cu and csrc/fused_overlap.cu built here and timed against
   this tree's on the same inputs in turns (parent, this tree, this tree,
   parent): SwiGLU at every T of 2 (with the library pair, two
   torch.matmul and silu·mul), the GEMM role alone, and the fused op at
   gemm_fraction 0.5.  A parent whose C entry takes a schedule gets it
   from the parent's own kernels/swiglu.py ``plan``.
4. With ``--parent DIR``, ``cuobjdump -sass`` of every library: HGMMA and
   UTMALDG (TMA loads) counted in this tree's bf16 SwiGLU and fused-op
   kernels and in the parent's, and the other libraries compared with the
   parent's function by function.
5. ``--ptxas``: registers, shared memory and spills of each SwiGLU and
   fused-op kernel, from this run's build (start from an empty build/).

Each time is the median of 20 calls after an L2 flush and a spin
(chip_smoke's ``Timer``).  Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import importlib.util
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402  (Timer, card_info, the kernels' cases)
from packed_attention_probe import nvcc_build, sass_functions  # noqa: E402

OUT_DIR = ROOT / "build" / "gemm_probe"
QWEN_TS = (8, 16, 32, 64, 256, 257)
JAMBA_TS = (8, 256)


def shapes(torch):
    from repro_torch.configs import get_config
    q, j = get_config("qwen3-8b"), get_config(chip_smoke.JAMBA)
    return [((q.d_model, q.d_ff), QWEN_TS), ((j.d_model, j.d_ff), JAMBA_TS)]


def gemm_role(torch, timer) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_overlap as fo
    args, _, _, desc = chip_smoke.overlap_case(torch, get_config("qwen3-8b"),
                                               torch.bfloat16)
    x, w, q, k, v, clen = args
    gemm_only = (x, w, q[:0], k[:0], v[:0], clen[:0])
    go, _ = fo.fused_overlap_cuda(*gemm_only)
    chip_smoke.check_close("gemm role", go, torch.matmul(
        x.float(), w.float()).to(torch.bfloat16))
    ms = timer(partial(fo.fused_overlap_cuda, *gemm_only))
    ctas = fo.fused_overlap_cuda.schedule
    mm = timer(partial(torch.matmul, x, w))
    # one attention unit of one row: the GEMM keeps half the CTAs, one per SM
    tiny = (x, w, q[:1], k[:1, :64], v[:1, :64],
            torch.ones(1, dtype=torch.int32, device="cuda"))
    half = timer(partial(fo.fused_overlap_cuda, *tiny, gemm_fraction=0.5))
    print(f"gemm role {desc.split(' beside')[0]}: alone on all {ctas[0]} CTAs "
          f"({ctas[2]} per SM) {ms:.4f} ms, {2 * x.shape[0] * x.shape[1] * w.shape[1] / ms / 1e9:.1f}"
          f" TFLOP/s; torch.matmul {mm:.4f}; on {fo.fused_overlap_cuda.schedule[1]}"
          f" CTAs (gemm_fraction 0.5 beside one attention unit) {half:.4f}",
          flush=True)


def sweep(torch, timer) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels import swiglu as sw
    fn = build.build().fn("swiglu")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for (d, ff), ts in shapes(torch):
        gen, wg, wu, _ = chip_smoke.swiglu_case(torch, d, ff)
        for t in ts:
            x = torch.randn(t, d, generator=gen, device="cuda") \
                .to(torch.bfloat16)
            want = sw.swiglu_ref(x, wg, wu)
            out = torch.empty(t, ff, dtype=torch.bfloat16, device="cuda")
            chosen = sw.plan(t, ff, sms)
            runs = {chosen}
            for bm, bn in sorted(sw.TILES):
                if bm < 128 and bm != chosen[0]:
                    continue     # a swap-AB tile other than the one for t
                mt, ns = -(-t // bm), -(-ff // bn)
                for g in (ns, -(-ns // 2), sms // mt, 2 * sms // mt):
                    if 1 <= g <= ns:
                        runs.add((bm, bn, g))
            for bm, bn, g in sorted(runs):
                def call():
                    rc = fn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                            out.data_ptr(), 1, t, ff, d, bm, bn, g, stream)
                    if rc != 0:
                        raise RuntimeError(f"swiglu {bm}x{bn} {g}: {rc}")
                    return out
                chip_smoke.check_close(f"sweep swiglu T={t} {bm}x{bn} {g}",
                                       call(), want)
                ms = timer(call)
                mb = (t * d + 2 * d * ff + t * ff) * 2 / 1e6
                print(f"sweep swiglu T={t} ({d}x{ff}) tile {bm}x{bn} groups "
                      f"{g} ({g * -(-t // bm)} CTAs, {-(-ff // bn)} strips): "
                      f"{ms:.4f} ms, {mb / ms / 1e3:.3f} TB/s"
                      + ("  <- plan" if (bm, bn, g) == chosen else ""),
                      flush=True)
            del x, want, out
        del wg, wu
        torch.cuda.empty_cache()


def parent_plan(parent: Path):
    """The parent's SwiGLU schedule arguments, (t, n, sms) -> tuple: none
    for a C entry without them, else its own kernels/swiglu.py ``plan``."""
    src = (parent / "src/repro_torch/kernels/csrc/swiglu.cu").read_text()
    head = src[src.index('extern "C" int repro_swiglu('):]
    ints = head[:head.index(")")].count("int ")
    if ints == 5:     # dtype, M, N, K: no schedule
        return ints, lambda t, n, sms: ()
    spec = importlib.util.spec_from_file_location(
        "parent_swiglu", parent / "src/repro_torch/kernels/swiglu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return ints, mod.plan


def parent_ab(torch, timer, parent: Path) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_overlap as fo
    from repro_torch.kernels import swiglu as sw
    csrc = parent / "src/repro_torch/kernels/csrc"
    with ThreadPoolExecutor(2) as ex:
        so_sw, so_fo = ex.map(
            lambda src: nvcc_build(csrc / f"{src}.cu", (),
                                   OUT_DIR / f"parent-{src}.so", cubin=False),
            ("swiglu", "fused_overlap"))
    ints, pplan = parent_plan(parent)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    psw = ctypes.CDLL(str(so_sw)).repro_swiglu
    psw.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (ints - 1) \
        + [ctypes.c_void_p]
    psw.restype = ctypes.c_int
    pfo = ctypes.CDLL(str(so_fo)).repro_fused_overlap
    pfo.argtypes, pfo.restype = build.SIGNATURES["fused_overlap"][1], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for (d, ff), ts in shapes(torch):
        gen, wg, wu, library = chip_smoke.swiglu_case(torch, d, ff)
        for t in ts:
            x = torch.randn(t, d, generator=gen, device="cuda") \
                .to(torch.bfloat16)
            want = sw.swiglu_ref(x, wg, wu)
            out = torch.empty(t, ff, dtype=torch.bfloat16, device="cuda")

            sched = pplan(t, ff, sms)

            def old():
                rc = psw(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                         out.data_ptr(), 1, t, ff, d, *sched, stream)
                if rc != 0:
                    raise RuntimeError(f"parent swiglu: {rc}")
                return out
            new = partial(sw.swiglu_cuda, x, wg, wu)
            chip_smoke.check_close(f"parent swiglu T={t}", old(), want)
            chip_smoke.check_close(f"swiglu T={t}", new(), want)
            ms = [timer(old), timer(new), timer(new), timer(old)]
            print(f"A/B swiglu T={t} ({d}x{ff}): parent {ms[0]:.4f} / "
                  f"{ms[3]:.4f} ms, this tree {ms[1]:.4f} / {ms[2]:.4f} ms "
                  f"(parent, tree, tree, parent); library pair "
                  f"{timer(partial(library, x)):.4f}", flush=True)
        del wg, wu, library
        torch.cuda.empty_cache()
    args, _, _, _ = chip_smoke.overlap_case(torch, get_config("qwen3-8b"),
                                            torch.bfloat16)
    x, w, q, k, v, clen = args
    libs = build.build()
    tree_fo = libs.fn("fused_overlap")
    for label, a, frac in (("GEMM role alone", (x, w, q[:0], k[:0], v[:0],
                                                clen[:0]), 0.5),
                           ("fused op at gemm_fraction 0.5", args, 0.5)):
        run = partial(fo.fused_overlap_cuda, *a, gemm_fraction=frac)
        ms = []
        for fn in (pfo, tree_fo, tree_fo, pfo):
            libs._fns["fused_overlap"] = fn
            run()
            ms.append(timer(run))
        libs._fns["fused_overlap"] = tree_fo
        print(f"A/B {label}: parent {ms[0]:.4f} / {ms[3]:.4f} ms, this tree "
              f"{ms[1]:.4f} / {ms[2]:.4f} ms (parent, tree, tree, parent)",
              flush=True)


def compare_sass(parent: Path) -> None:
    from repro_torch.kernels import build

    def cubins(tree: Path, tag: str) -> dict:
        def one(target):
            source, defines = build.TARGETS[target]
            return target, sass_functions(nvcc_build(
                tree / f"src/repro_torch/kernels/csrc/{source}.cu", defines,
                OUT_DIR / f"{tag}-{target}.cubin", cubin=True))
        with ThreadPoolExecutor(len(build.TARGETS)) as ex:
            return dict(ex.map(one, build.TARGETS))
    old, new = cubins(parent, "parent"), cubins(ROOT, "tree")
    for target in ("swiglu", "fused_overlap"):
        for tag, funcs in (("this tree", new[target]), ("parent", old[target])):
            for name, lines in funcs.items():
                if "bf16" in name or "nv_bfloat16" in name:
                    text = "\n".join(lines)
                    print(f"SASS {target} ({tag}) {name[:90]}: "
                          f"{len(re.findall(r'HGMMA', text))} HGMMA, "
                          f"{len(re.findall(r'UTMALDG', text))} UTMALDG, "
                          f"{len(re.findall(r'HMMA', text))} HMMA", flush=True)
    for target in build.TARGETS:
        if target in ("swiglu", "fused_overlap"):
            continue
        a, b = old[target], new[target]
        same = [f for f in a if a[f] == b.get(f)]
        print(f"SASS {target}: {len(a)} functions in the parent, {len(b)} in "
              f"this tree, {len(same)} identical instruction for instruction"
              + ("" if len(same) == len(a) == len(b) else
                 f"; differ: {sorted(set(a) ^ set(same))[:4]}"), flush=True)


def ptxas_table() -> None:
    from repro_torch.kernels import build
    target = fn = None
    stack = ""
    for line in build.build().ptxas_log.splitlines():
        if line.startswith("--- "):
            target = line[4:]
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            stack = f"{m.group(1)} B stack, {m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and target in ("swiglu", "fused_overlap"):
            print(f"ptxas {target} {fn[-60:]}: {m.group(1)} registers, "
                  f"{m.group(2) or 0} B static smem, {stack}", flush=True)
        if "C75" in line and target in ("swiglu", "fused_overlap"):
            print(f"ptxas {target}: {line.strip()[:200]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemm_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    chip_smoke.card_info(torch)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    build.build()
    if "--ptxas" in sys.argv:
        ptxas_table()
        return 0
    timer = chip_smoke.Timer(torch)
    gemm_role(torch, timer)
    if "--sweep" in sys.argv:
        sweep(torch, timer)
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
        parent_ab(torch, timer, parent)
        compare_sass(parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())

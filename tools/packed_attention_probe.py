#!/usr/bin/env python3
"""Where packed attention's tile kernel spends its time, on one NVIDIA card.

    python3 tools/packed_attention_probe.py [--parent DIR]   # 4, 1, 2 (, 3)
    python3 tools/packed_attention_probe.py --parts-only     # 4
    python3 tools/packed_attention_probe.py --ptxas [--parent DIR]   # 5
    python3 tools/packed_attention_probe.py --unit --parent DIR      # 6

1. The sweep: chip_smoke's packed-attention shape (8 decode tokens, a
   200-token chunk at positions 300-499 and a 37-token chunk over 10 slots
   of 1024 rows, bucket 1024, Qwen3-8B's 32/8 heads, bf16 q) in each of the
   four variants, for tokens per tile group ``tq`` in {16, 8, 4} (64, 32
   and 16 rows at group 4) and ``chunk`` in {64, 128, 256, 512, 1024} key
   rows: ms, and the K/V megabytes the tiling streams beside the distinct
   rows' megabytes (chip_smoke's ``kv_stream``; the bound counts those).
2. Decode only: chip_smoke's decode shape (8 rows over (8, 1024, 8, 128)
   caches, 1837 rows attended) as an 8-token packed stream through the
   tile kernel at each chunk, beside decode attention (the split-KV unit
   of csrc/attn_decode.cuh) on the same caches.
3. With ``--parent DIR`` (an unpacked tree of an earlier commit): DIR's
   csrc/packed_attention.cu built here in its four packed variants and
   timed on the same inputs in turns (parent, this tree, this tree,
   parent), with the host's time per call of each tree's C entry point
   (ctypes, the device kept busy so that only enqueueing is timed), then
   ``cuobjdump -sass`` of decode_attention.cu (decode and paged decode)
   and fused_overlap.cu from both trees, compared function by function.
4. Before the sweep: each part of the stream alone (decode tokens, the
   200-token chunk, the 37-token chunk, the whole) by chunk, cold and as
   the kernel's own device time, beside flash attention on the 200-token
   chunk.
5. ``--ptxas``: stack and spills of every tile-kernel instantiation (f32
   and bf16 q); with ``--parent`` also part 3's SASS comparison.
6. ``--unit --parent DIR``: the kernels on the split-KV unit of
   csrc/attn_decode.cuh, each in turns with DIR's build of it (parent,
   tree, tree, parent) at chip_smoke's shapes: paged decode attention
   (``paged_case``; DIR's as trees before the unit's paged form built
   it: the -DREPRO_PA_DECODE per-token loop of packed_attention.cu),
   decode attention
   (``decode_case``) and the fused op at gemm_fraction 0.5
   (``overlap_case``); then part 3's SASS comparison.

Each time is the median of 20 calls after an L2 flush and a spin
(chip_smoke's ``Timer``) unless it says it is the kernel's own device
time (torch.profiler, warm L2).  Prints the card's name and power limit
first.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (Timer, card_info, the kernels' cases)

OUT_DIR = ROOT / "build" / "packed_attention_probe"
TQS = (16, 8, 4)
CHUNKS = (64, 128, 256, 512, 1024)   # the least chunk the kernel may take
CUBIN_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3")
# the earlier C entry point: no tile scratch, tq or chunk arguments
_c = ctypes
PARENT_ARGS = ([_c.c_void_p] * 9 + [_c.c_int] * 10 + [_c.c_longlong] * 6
               + [_c.c_float, _c.c_void_p])


def sweep(torch, timer, cfg) -> None:
    from repro_torch.kernels import packed_attention as pa
    for kname, ((blocked, quant), _) in chip_smoke.ATTENTION.items():
        args, kw, nbytes, _ = chip_smoke.variant_case(
            torch, cfg, 1024, torch.bfloat16, blocked, quant)
        want = pa.packed_attention_ref(*args, kv_bucket=1024, **kw)
        for tq in TQS:
            mb = chip_smoke.kv_stream(args, kw, 1024, tq)
            times = []
            for chunk in CHUNKS:
                run = partial(pa.launch, kname, *args, kv_bucket=1024,
                              tq=tq, chunk=chunk, **kw)
                got = run()
                torch.cuda.synchronize()
                chip_smoke.check_close(f"{kname} tq {tq} chunk {chunk}", got,
                                       want)
                times.append(f"{chunk}: {timer(run):.4f}")
            print(f"sweep {kname} tq {tq} ({tq * 4} rows): streams "
                  f"{mb['tiled']:.1f} MB of K/V (distinct "
                  f"{mb['distinct']:.1f} MB, bound bytes "
                  f"{nbytes / 1e6:.1f} MB); ms by chunk {', '.join(times)}",
                  flush=True)


def kernel_ms(torch, fn, key: str, reps: int = 10) -> float:
    """Mean device duration of the kernels whose name holds ``key`` over
    ``reps`` back-to-back calls (torch.profiler, warm L2): the kernel
    alone, without launch gaps."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if key in e.key]
    return (sum(e.device_time_total for e in ev) / 1e3
            / max(1, sum(e.count for e in ev)))


def parts(torch, timer, cfg) -> None:
    """The contiguous variant on each part of chip_smoke's stream alone
    (the 8 decode tokens, the 200-token chunk, the 37-token chunk) and on
    the whole, by chunk; the 200-token chunk also through flash attention (a causal 64-row tile
    per CTA, csrc/flash_attention.cu).  Each time is Timer's (cold L2),
    then the profiler's kernel duration (warm L2)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_attention as pa
    args, kw, _, _ = chip_smoke.variant_case(torch, cfg, 1024, torch.bfloat16,
                                             False, False)
    q, k, v, slot, lens = args
    for name, (a, b) in (("decode tokens", (0, 8)), ("200-token chunk",
                                                     (8, 208)),
                         ("37-token chunk", (208, 245)), ("whole", (0, 245))):
        sub = (q[a:b], k, v, slot[a:b], lens[a:b])
        want = pa.packed_attention_ref(*sub, kv_bucket=1024)
        times = []
        for chunk in (128, 512):
            run = partial(pa.launch, "packed_attention", *sub,
                          kv_bucket=1024, chunk=chunk)
            chip_smoke.check_close(f"part {name}", run(), want)
            times.append(f"chunk {chunk}: {timer(run):.4f} / "
                         f"{kernel_ms(torch, run, 'packed_attention'):.4f}")
        print(f"part {name} ({b - a} tokens), ms (cold / kernel alone): "
              f"{'; '.join(times)}", flush=True)
    off = torch.tensor([300], dtype=torch.int32, device="cuda")
    run = partial(fa.flash_attention_cuda, q[8:208][None], k[8:9], v[8:9],
                  q_offset=off)
    print(f"part 200-token chunk through flash attention: {timer(run):.4f} / "
          f"{kernel_ms(torch, run, 'flash'):.4f} ms", flush=True)


def decode_only(torch, timer, cfg) -> None:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import packed_attention as pa
    (q, k, v, clen), _, nbytes, _, _ = chip_smoke.decode_case(
        torch, cfg, torch.bfloat16)
    slot = torch.arange(8, dtype=torch.int32, device="cuda")
    want = da.decode_attention_ref(q, k, v, clen)
    ms = timer(partial(da.decode_attention_cuda, q, k, v, clen))
    print(f"decode only ({int(clen.sum())} rows, {nbytes / 1e6:.1f} MB): "
          f"decode_attention (the split-KV unit) {ms:.4f} ms", flush=True)
    for chunk in CHUNKS:
        run = partial(pa.launch, "packed_attention", q, k, v, slot, clen,
                      chunk=chunk)
        chip_smoke.check_close(f"decode-only chunk {chunk}", run(), want)
        print(f"decode only as an 8-token packed stream, chunk {chunk}: "
              f"{timer(run):.4f} ms", flush=True)


def nvcc_build(src: Path, defines, out: Path, cubin: bool) -> Path:
    from repro_torch.kernels import build
    flags = CUBIN_FLAGS + ("-cubin",) if cubin else build.NVCC_FLAGS
    res = subprocess.run([build._nvcc(), *flags, *defines, "-o", str(out),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src}: {res.stdout}{res.stderr}")
    return out


def host_us(torch, call, n: int = 400) -> float:
    """Host microseconds per call of ``call`` (a kernel launch) while the
    device sleeps through the loop: the enqueue cost alone."""
    import time
    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # ~0.1 s at the SM clock
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def parent_ab(torch, timer, cfg, parent: Path) -> None:
    """The parent tree's per-token loop against this tree's tile kernel, in
    turns, on the same inputs; then the host's cost of each C entry point
    per launch, in turns."""
    from repro_torch.kernels import build
    from repro_torch.kernels import packed_attention as pa
    src = parent / "src/repro_torch/kernels/csrc/packed_attention.cu"
    for kname, ((blocked, quant), _) in chip_smoke.ATTENTION.items():
        so = nvcc_build(src, build.TARGETS[kname][1],
                        OUT_DIR / f"parent-{kname}.so", cubin=False)
        fn = ctypes.CDLL(str(so)).repro_packed_attention
        fn.argtypes, fn.restype = PARENT_ARGS, ctypes.c_int
        args, kw, _, _ = chip_smoke.variant_case(torch, cfg, 1024,
                                                 torch.bfloat16, blocked,
                                                 quant)
        q, k, v, slot, lens = args
        n, s, kvh, d = k.shape
        out = torch.empty_like(q)
        bt = kw.get("block_tables")
        ks, vs = kw.get("k_scale"), kw.get("v_scale")
        s_str = (ks.stride(0), ks.stride(1)) if quant else (0, 0)
        stream = torch.cuda.current_stream().cuda_stream

        def old():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    ks.data_ptr() if quant else None,
                    vs.data_ptr() if quant else None, slot.data_ptr(),
                    lens.data_ptr(), bt.data_ptr() if blocked else None,
                    out.data_ptr(), 1, int(quant), q.shape[0], q.shape[1],
                    kvh, d, n, 1024, bt.shape[1] if blocked else 0,
                    s // bt.shape[1] if blocked else 0, k.stride(0),
                    k.stride(1), v.stride(0), v.stride(1), *s_str,
                    d ** -0.5, stream)
            if rc != 0:
                raise RuntimeError(f"parent {kname}: {rc}")
            return out
        new = partial(pa.launch, kname, *args, kv_bucket=1024, **kw)
        want = pa.packed_attention_ref(*args, kv_bucket=1024, **kw)
        chip_smoke.check_close(f"parent {kname}", old(), want)
        chip_smoke.check_close(f"tile {kname}", new(), want)
        t = [timer(old), timer(new), timer(new), timer(old)]
        print(f"A/B {kname}: parent {t[0]:.4f} / {t[3]:.4f} ms, this tree "
              f"{t[1]:.4f} / {t[2]:.4f} ms (parent, tree, tree, parent)",
              flush=True)
        # this tree's C entry point with the arguments pa.launch passes
        plan = pa.tile_plan(q.shape[0], q.shape[1] // kvh, 1024)
        scratch = [torch.empty(q.shape[0] * kvh * plan[2] * m,
                               dtype=torch.float32, device="cuda")
                   for m in (2 * q.shape[1] // kvh, q.shape[1] // kvh * d)]
        tickets = pa.split_kv_tickets(q.device, stream, q.shape[0] * kvh)
        tree_fn = build.build().fn(kname)
        out2 = torch.empty_like(q)

        def raw():
            rc = tree_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         ks.data_ptr() if quant else None,
                         vs.data_ptr() if quant else None, slot.data_ptr(),
                         lens.data_ptr(), bt.data_ptr() if blocked else None,
                         out2.data_ptr(), scratch[0].data_ptr(),
                         scratch[1].data_ptr(), tickets.data_ptr(), 1,
                         int(quant), q.shape[0], q.shape[1], kvh, d, n, 1024,
                         bt.shape[1] if blocked else 0,
                         s // bt.shape[1] if blocked else 0, *plan,
                         k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                         *s_str, d ** -0.5, stream)
            if rc != 0:
                raise RuntimeError(f"tree {kname}: {rc}")
            return out2
        chip_smoke.check_close(f"tile {kname} (C entry)", raw(), want)
        h = [host_us(torch, old), host_us(torch, raw), host_us(torch, raw),
             host_us(torch, old)]
        print(f"host per launch {kname}: parent {h[0]:.2f} / {h[3]:.2f} us, "
              f"this tree {h[1]:.2f} / {h[2]:.2f} us (C entry through "
              f"ctypes; parent, tree, tree, parent)", flush=True)


# the C entry of csrc/packed_attention.cu before paged decode left it
PAGED_PARENT_ARGS = ([_c.c_void_p] * 12 + [_c.c_int] * 13
                     + [_c.c_longlong] * 6 + [_c.c_float, _c.c_void_p])


def unit_ab(torch, timer, cfg, parent: Path) -> None:
    """Paged decode, decode attention and the fused op, each in turns with
    DIR's build at chip_smoke's shapes (bf16)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fused_overlap as fo
    csrc = parent / "src/repro_torch/kernels/csrc"
    # DIR's paged decode: the -DREPRO_PA_DECODE build of its packed source
    so = nvcc_build(csrc / "packed_attention.cu",
                    ("-DREPRO_PA_DECODE=1", "-DREPRO_PA_BLOCK_TABLE=1"),
                    OUT_DIR / "parent-paged.so", cubin=False)
    pfn = ctypes.CDLL(str(so)).repro_packed_attention
    pfn.argtypes, pfn.restype = PAGED_PARENT_ARGS, ctypes.c_int
    args, _, _, _ = chip_smoke.paged_case(torch, cfg, torch.bfloat16)
    q, kp, vp, table, lens = args
    out = torch.empty_like(q)
    t, h, d = q.shape
    npg, ps, kvh, _ = kp.shape
    stream = torch.cuda.current_stream().cuda_stream

    def old():
        rc = pfn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
                 None, lens.data_ptr(), table.data_ptr(), out.data_ptr(),
                 None, None, None, 1, 0, t, h, kvh, d, t,
                 table.shape[1] * ps, table.shape[1], ps, 0, 0, 0,
                 kp.stride(0), kp.stride(1), vp.stride(0), vp.stride(1), 0,
                 0, d ** -0.5, stream)
        if rc != 0:
            raise RuntimeError(f"parent paged decode: {rc}")
        return out
    new = partial(da.paged_decode_attention_cuda, *args)
    want = da.paged_decode_attention_ref(*args)
    chip_smoke.check_close("parent paged decode", old(), want)
    chip_smoke.check_close("paged decode", new(), want)
    ms = [timer(old), timer(new), timer(new), timer(old)]
    print(f"A/B paged_decode_attention: parent {ms[0]:.4f} / {ms[3]:.4f} "
          f"ms, this tree {ms[1]:.4f} / {ms[2]:.4f} ms (parent, tree, tree, "
          f"parent); grid {da.launch.units}", flush=True)
    # DIR's decode_attention.cu and fused_overlap.cu under this tree's
    # wrappers (their C entries are unchanged)
    libs = build.build()
    dargs, _, _, _, _ = chip_smoke.decode_case(torch, cfg, torch.bfloat16)
    oargs, _, _, _ = chip_smoke.overlap_case(torch, cfg, torch.bfloat16)
    for target, call, want in (
            ("decode_attention", partial(da.decode_attention_cuda, *dargs),
             da.decode_attention_ref(*dargs)),
            ("fused_overlap", partial(fo.fused_overlap_cuda, *oargs,
                                      gemm_fraction=0.5),
             fo.fused_overlap_ref(*oargs)[1])):
        so = nvcc_build(csrc / f"{target}.cu", (),
                        OUT_DIR / f"parent-{target}.so", cubin=False)
        fn = getattr(ctypes.CDLL(str(so)), build.SIGNATURES[target][0])
        fn.argtypes, fn.restype = build.SIGNATURES[target][1], ctypes.c_int
        tree_fn = libs.fn(target)
        ms = []
        for lib in (fn, tree_fn, tree_fn, fn):
            libs._fns[target] = lib
            got = call()
            chip_smoke.check_close(
                f"{target} ({'tree' if lib is tree_fn else 'parent'})",
                got[1] if target == "fused_overlap" else got, want)
            ms.append(timer(call))
        libs._fns[target] = tree_fn
        print(f"A/B {target}: parent {ms[0]:.4f} / {ms[3]:.4f} ms, this "
              f"tree {ms[1]:.4f} / {ms[2]:.4f} ms (parent, tree, tree, "
              "parent)", flush=True)


def sass_functions(cubin: Path) -> dict:
    """Function name -> its SASS lines.  Names in an anonymous namespace
    carry a hash of the source's path, which differs between two trees, so
    it is taken out of names and instructions alike."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    text = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "_GLOBAL__N_", text)
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(line.strip())
    return funcs


def compare_sass(parent: Path) -> None:
    from repro_torch.kernels import build
    for target in ("decode_attention", "fused_overlap"):
        source, defines = build.TARGETS[target]
        rel = f"src/repro_torch/kernels/csrc/{source}.cu"
        a = sass_functions(nvcc_build(parent / rel, defines,
                                      OUT_DIR / f"parent-{target}.cubin",
                                      cubin=True))
        b = sass_functions(nvcc_build(ROOT / rel, defines,
                                      OUT_DIR / f"tree-{target}.cubin",
                                      cubin=True))
        same = [f for f in a if a[f] == b.get(f)]
        print(f"SASS {target}: {len(a)} functions in the parent, {len(b)} in "
              f"this tree, {len(same)} identical instruction for instruction"
              + ("" if len(same) == len(a) == len(b) else
                 f"; differ: {sorted(set(a) ^ set(same))[:4]}"), flush=True)
        for f in sorted(set(a) - set(same))[:2]:
            diff = [(x, y) for x, y in zip(a[f], b.get(f, [])) if x != y]
            print(f"  {f}: {len(a[f])} / {len(b.get(f, []))} lines, "
                  f"{len(diff)} differ; first: {diff[:2]}", flush=True)


def ptxas_table() -> None:
    """Stack and spills of each tile-kernel instantiation of the four
    packed builds, from the build's ptxas log."""
    from repro_torch.kernels import build
    target = fn = None
    for line in build.build().ptxas_log.splitlines():
        if line.startswith("--- "):
            target = line[4:]
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and "tile_kernel" in (fn or "") and target in chip_smoke.ATTENTION:
            inst = re.search(r"kernelI(\w+?)Li(\d)ELi(\d+)E", fn)
            spill = f"{m.group(2)} B spilled" if m.group(2) != "0" else "no spill"
            print(f"ptxas {target} <{inst.group(1)}, G {inst.group(2)}, D "
                  f"{inst.group(3)}>: {m.group(1)} B stack, {spill}",
                  flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("packed_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    chip_smoke.card_info(torch)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    build.build()
    cfg = get_config("qwen3-8b")
    timer = chip_smoke.Timer(torch)
    if "--unit" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
        unit_ab(torch, timer, cfg, parent)
        compare_sass(parent)
        return 0
    if "--ptxas" in sys.argv:
        ptxas_table()
        if "--parent" in sys.argv:
            compare_sass(Path(sys.argv[sys.argv.index("--parent") + 1]).resolve())
        return 0
    parts(torch, timer, cfg)
    if "--parts-only" in sys.argv:
        return 0
    sweep(torch, timer, cfg)
    decode_only(torch, timer, cfg)
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
        parent_ab(torch, timer, cfg, parent)
        compare_sass(parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())

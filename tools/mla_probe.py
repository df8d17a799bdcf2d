#!/usr/bin/env python3
"""Where absorbed MLA's latent-attention kernel spends its time, on one
NVIDIA card.

    python3 tools/mla_probe.py [--parent DIR] [--sweep]

At chip_smoke's four MLA shapes (``chip_smoke.mla_case``: DeepSeek-V2's 128
heads over rank 512 + rope 64 in bf16; the mixed stream, 8 decode rows, a
256-token chunk at offset 512 and a 513-token recompute):

1. ptxas's registers, stack, spills and shared memory of each kernel in
   csrc/mla_attention.cu (this run's own ``nvcc -Xptxas -v``), and ptxas's
   C75xx notes; ``cuobjdump -sass`` counts of HGMMA, UTMALDG (TMA loads)
   and HMMA in each kernel of the library.
2. This tree's kernel at each shape with its plan (CTAs, CTAs with rows,
   chunk), checked against the plain version, its TFLOP/s and its bound,
   and two launches compared bit for bit; and the launch's floor: the
   decode shape with every length 0 (each CTA reads its token's slot and
   length, and chunk 0 writes zeros).
3. Variants of this tree's source, each a copy with one edit (``EDITS``),
   timed in turns with the tree's build
   (tree, variant, variant, tree) at every shape: the ring alone (loads,
   barriers and the softmax's exchanges, no products; not checked: its
   output is garbage), the ring and S without P V, the products alone
   (the producer fills the two stages once and then only arrives, so the
   consumers run every stage on stale rows; not checked), every chunk
   storing its own output with no partial, ticket or merge (not
   checked), and P as bf16 alone (no lo products; its error is reported
   against the tolerance, not held to it).
4. ``--sweep``: the decode and mixed shapes at every chunk of the plan's
   form (64, 128, ... rows), each checked and timed: what ``plan`` chooses
   against the rest.
5. The host's microseconds per call while the device sleeps: the C entry
   alone (its three tensor-map encodes included) and the Python wrapper
   (``mla_attention_cuda``).
6. With ``--parent DIR`` (an unpacked tree of an earlier commit): DIR's
   mla_attention.cu built here and DIR's wrapper (with its own plan and
   scratch), timed in turns with this tree's (parent, tree, tree, parent)
   at every shape, both checked against the plain version; the host's
   microseconds per call of either wrapper, in turns; the SASS counts of
   DIR's library.

Each time is the median of 20 calls after an L2 flush and a spin
(chip_smoke's ``Timer``).  Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import importlib.util
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (Timer, card_info, mla_case, host_us)

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT_DIR = ROOT / "build" / "mla_probe"
CASES = ("packed", "decode", "chunk", "recompute")
# label -> the (anchor, replacement) edits of csrc/mla_attention.cu that
# make the variant.  Each anchor must occur once in the source, and the
# probe raises when one does not: an edit to these lines of the kernel
# must bring its anchor here up to date.
_PV = ("        g9::mma_rs<128>(acc, ah, desc, 1);\n"
       "        g9::mma_rs<128>(acc, al, desc, 1);\n")
EDITS = {
    "ring alone": (
        ("      mma_kk_n32(sc, g9::kmajor_desc",
         "      if (false) mma_kk_n32(sc, g9::kmajor_desc"),
        (_PV, "")),
    "+ S, no P V": ((_PV, ""),),
    "products alone": (
        ("        g9::mbar_expect_tx(bar, STAGE_BYTES);\n",
         "        g9::mbar_expect_tx(bar, j < STAGES ? STAGE_BYTES : 0);\n"
         "        if (j >= STAGES) continue;\n"),),
    "no partials or merge": (
        ("  if (n_live <= 1) {\n    cs.store(dst);",
         "  if (true) {\n    cs.store(dst);"),),
    "P in bf16 alone": (
        ("        g9::mma_rs<128>(acc, al, desc, 1);\n", ""),),
}
UNCHECKED = ("ring alone", "+ S, no P V", "products alone",
             "no partials or merge")
REPORTED = ("P in bf16 alone",)     # error reported, not held
# the C entry of the kernel before the redesign: no tickets
PARENT_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
               + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_void_p])


def nvcc(src: Path, defines, out: Path, cubin: bool = False) -> tuple:
    """Builds src (a .so, or a cubin) with the repo's flags and this
    source's directory and csrc/ on the include path; returns (out, the
    compiler's output: ptxas -v)."""
    from repro_torch.kernels import build
    flags = list(build.NVCC_FLAGS)
    if cubin:
        flags = [f for f in flags if f not in ("-shared",)] + ["-cubin"]
        flags = [f for f in flags if f not in ("-Xcompiler", "-fPIC")]
    res = subprocess.run([build._nvcc(), *flags, *defines, f"-I{CSRC}", "-o",
                          str(out), str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src}: {res.stdout}{res.stderr}")
    return out, res.stdout + res.stderr


def lib_fn(so: Path, argtypes):
    fn = ctypes.CDLL(str(so)).repro_mla_attention
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def sass(cubin: Path) -> dict:
    """Function name -> its SASS text (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(line.strip())
    return {k: "\n".join(v) for k, v in funcs.items()}


def sass_counts(tag: str, cubin: Path) -> None:
    for name, text in sorted(sass(cubin).items()):
        print(f"SASS mla_attention ({tag}) {name[:60]}: "
              f"{len(re.findall(r'HGMMA', text))} HGMMA, "
              f"{len(re.findall(r'UTMALDG', text))} UTMALDG, "
              f"{len(re.findall(r'HMMA', text))} HMMA, "
              f"{len(re.findall(r'LDGSTS', text))} LDGSTS", flush=True)


def ptxas_table(log: str, tag: str) -> None:
    fn, spills = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spills = (f"{m.group(1)} B stack, {m.group(2)} B spill stores, "
                      f"{m.group(3)} B spill loads")
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            print(f"ptxas mla_attention ({tag}) {fn[-50:]}: {m.group(1)} "
                  f"registers, {m.group(2) or 0} B static smem, {spills}",
                  flush=True)
        if "C75" in line or "setmaxnreg" in line:
            print(f"ptxas mla_attention ({tag}): {line.strip()[:200]}",
                  flush=True)


def shapes(torch) -> dict:
    """use -> (args, kwargs, plain output, flops, bytes, description)."""
    from repro_torch.kernels import mla_attention as mla
    out = {}
    for use in CASES:
        args, kw, _, nbytes, flops, desc = chip_smoke.mla_case(
            torch, use, torch.bfloat16)
        want = mla.mla_attention_ref(*args, **kw)
        out[use] = (args, kw, want, flops, nbytes, desc)
    return out


def tree_kernel(torch, timer, cases, bw, peak) -> None:
    from repro_torch.kernels import mla_attention as mla
    for use, (args, kw, want, flops, nbytes, desc) in cases.items():
        got = mla.mla_attention_cuda(*args, **kw)
        err = chip_smoke.check_close(f"mla [{use}]", got, want)
        same = bool(torch.equal(got, mla.mla_attention_cuda(*args, **kw)))
        ms = timer(partial(mla.mla_attention_cuda, *args, **kw))
        bound = max(nbytes / bw, flops / peak) * 1e3
        print(f"tree [{use}] {desc}: {chip_smoke.mla_schedule(args, kw)}; "
              f"max_abs_err "
              f"{err:.3e}; two launches bit-equal {same}; {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bound:.4f} ms "
              f"({ms / bound:.1f}x)", flush=True)
    args, kw = cases["decode"][:2]
    zero = (*args[:4], torch.zeros_like(args[4]))
    assert not mla.mla_attention_cuda(*zero, **kw).any()
    print(f"floor [decode shape, every length 0]: "
          f"{timer(partial(mla.mla_attention_cuda, *zero, **kw)):.4f} ms",
          flush=True)


def variants(torch, timer, cases) -> None:
    """Each of ``EDITS`` built here, timed in turns with the tree's build at
    every shape."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mla_attention as mla
    text = (CSRC / "mla_attention.cu").read_text()
    labels = list(EDITS)

    def make(i_label):
        i, label = i_label
        src = text
        for old, new in EDITS[label]:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {label!r}: anchor {old!r} "
                                   f"found {src.count(old)} times")
            src = src.replace(old, new)
        path = OUT_DIR / f"variant-{i}.cu"
        path.write_text(src)
        return nvcc(path, (), OUT_DIR / f"variant-{i}.so")
    with ThreadPoolExecutor(len(labels)) as ex:
        built = list(ex.map(make, enumerate(labels)))
    libs = build.build()
    tree = libs.fn("mla_attention")
    for label, (so, log) in zip(labels, built):
        ptxas_table(log, label)
        fn = lib_fn(so, build.SIGNATURES["mla_attention"][1])
        for use, (args, kw, want, flops, _, _) in cases.items():
            run = partial(mla.launch, *args, **kw)
            ms, note = [], ""
            for lib in (tree, fn, fn, tree):
                libs._fns["mla_attention"] = lib
                if lib is tree or label not in UNCHECKED + REPORTED:
                    chip_smoke.check_close(
                        f"{label} [{use}] "
                        f"{'tree' if lib is tree else 'variant'}", run(), want)
                elif label in REPORTED and not note:
                    got = run().float()
                    err = (got - want.float()).abs()
                    atol, rtol = chip_smoke.BF16_TOL
                    share = float((err / (atol + rtol * want.float().abs()))
                                  .max())
                    note = (f"; max_abs_err {float(err.max()):.3e}, "
                            f"{share:.3f} of the tolerance")
                ms.append(timer(run))
            libs._fns["mla_attention"] = tree
            print(f"A/B {label} [{use}] ms (tree, variant, variant, tree): "
                  f"tree {ms[0]:.4f} / {ms[3]:.4f}, variant {ms[1]:.4f} / "
                  f"{ms[2]:.4f}; variant {flops / min(ms[1:3]) / 1e9:.1f} "
                  f"TFLOP/s{note}", flush=True)


def chunk_sweep(torch, timer, cases) -> None:
    from repro_torch.kernels import mla_attention as mla
    for use in ("decode", "packed"):
        args, kw, want, _, _, _ = cases[use]
        sweep = kw.get("kv_bucket") or args[1].shape[1]
        plan = mla.plan(args[0].shape[0], args[0].shape[1], sweep,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)
        line, last = [], None
        for chunk in range(mla.STAGE, sweep + 1, mla.STAGE):
            sched = (chunk, -(-sweep // chunk))
            if sched[1] == last:
                continue          # as many chunks as the last, longer
            last = sched[1]
            run = partial(mla.launch, *args, **kw, sched=sched)
            chip_smoke.check_close(f"sweep [{use}] {sched}", run(), want)
            line.append(f"{chunk}/{sched[1]}: {timer(run):.4f}"
                        + (" <- plan" if sched == plan else ""))
        print(f"sweep [{use}] ms by chunk/chunks: " + ", ".join(line),
              flush=True)


def c_entry(torch, args, kw):
    """This tree's C entry on a case's inputs, as one call (the wrapper's
    arguments and scratch built once)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mla_attention as mla
    q, c_kv, k_rope, slot, lens = args
    t, h, _ = q.shape
    sweep = kw.get("kv_bucket") or c_kv.shape[1]
    chunk, splits = mla.plan(t, h, sweep, torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(t, h, mla.RANK, dtype=q.dtype, device="cuda")
    part = torch.empty(t * (h // 64) * splits * mla.PART, device="cuda")
    tickets = mla.split_kv_tickets(q.device, stream, t * (h // 64))
    return partial(build.build().fn("mla_attention"), q.data_ptr(),
                   c_kv.data_ptr(), k_rope.data_ptr(), slot.data_ptr(),
                   lens.data_ptr(), out.data_ptr(), None, part.data_ptr(),
                   tickets.data_ptr(), 1, t, h, c_kv.shape[0], sweep, chunk,
                   splits, c_kv.stride(0), c_kv.stride(1), k_rope.stride(0),
                   k_rope.stride(1), kw["logit_scale"], stream), (out, part)


def host_cost(torch, cases) -> None:
    from repro_torch.kernels import mla_attention as mla
    for use, (args, kw, _, _, _, _) in cases.items():
        call, _keep = c_entry(torch, args, kw)
        c_us = chip_smoke.host_us(torch, call)
        w_us = chip_smoke.host_us(torch, partial(mla.mla_attention_cuda,
                                                 *args, **kw))
        print(f"host [{use}]: C entry {c_us:.2f} us per call, "
              f"mla_attention_cuda {w_us:.2f} us per call", flush=True)


def load_parent(parent: Path):
    """DIR's wrapper with its library call routed to DIR's kernel built
    here; and the cubin of that kernel."""
    src = parent / "src/repro_torch/kernels/csrc/mla_attention.cu"
    so, log = nvcc(src, (), OUT_DIR / "parent-mla.so")
    ptxas_table(log, "parent")
    pfn = lib_fn(so, PARENT_ARGS)
    spec = importlib.util.spec_from_file_location(
        "parent_mla", parent / "src/repro_torch/kernels/mla_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = SimpleNamespace(build=lambda: SimpleNamespace(
        fn=lambda name: pfn))
    return mod


def parent_ab(torch, timer, cases, parent: Path) -> None:
    from repro_torch.kernels import mla_attention as mla
    pmod = load_parent(parent)
    for use, (args, kw, want, flops, _, _) in cases.items():
        old = partial(pmod.mla_attention_cuda, *args, **kw)
        new = partial(mla.mla_attention_cuda, *args, **kw)
        e_old = chip_smoke.check_close(f"parent mla [{use}]", old(), want)
        psched = pmod.launch.schedule
        e_new = chip_smoke.check_close(f"mla [{use}]", new(), want)
        ms = [timer(old), timer(new), timer(new), timer(old)]
        best_old, best_new = min(ms[0], ms[3]), min(ms[1:3])
        print(f"A/B mla [{use}]: parent {ms[0]:.4f} / {ms[3]:.4f} ms "
              f"(schedule {psched}, err {e_old:.3e}), this tree {ms[1]:.4f} "
              f"/ {ms[2]:.4f} ms (schedule {mla.launch.schedule}, err "
              f"{e_new:.3e}) (parent, tree, tree, parent); "
              f"{best_new / best_old:.3f} of the parent's time, "
              f"{flops / best_old / 1e9:.1f} -> {flops / best_new / 1e9:.1f}"
              f" TFLOP/s", flush=True)
        host = [chip_smoke.host_us(torch, f) for f in (old, new, new, old)]
        print(f"host [{use}] wrapper us per call in turns (parent, tree, "
              f"tree, parent): {' / '.join(f'{x:.2f}' for x in host)}",
              flush=True)
    cubin, _ = nvcc(parent / "src/repro_torch/kernels/csrc/mla_attention.cu",
                    (), OUT_DIR / "parent-mla.cubin", cubin=True)
    sass_counts("parent", cubin)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mla_probe: no CUDA device", file=sys.stderr)
        return 2
    _, bw, peak = chip_smoke.card_info(torch)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
    src = CSRC / "mla_attention.cu"
    with ThreadPoolExecutor(2) as ex:
        built = list(ex.map(lambda c: nvcc(src, (), OUT_DIR / (
            "tree-mla.cubin" if c else "tree-mla.so"), cubin=c),
            (False, True)))
    ptxas_table(built[0][1], "this tree")
    sass_counts("this tree", built[1][0])
    timer = chip_smoke.Timer(torch)
    cases = shapes(torch)
    tree_kernel(torch, timer, cases, bw, peak)
    if parent is not None:
        parent_ab(torch, timer, cases, parent)
    variants(torch, timer, cases)
    if "--sweep" in sys.argv:
        chunk_sweep(torch, timer, cases)
    host_cost(torch, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the selective scan spends its time, on one NVIDIA card.

    python3 tools/scan_probe.py [--parent DIR]

At chip_smoke's two scan shapes (``chip_smoke.scan_case`` at
Jamba-1.5-Large's 16384 channels and 16 states: a 256-token chunk from a
carried f32 state and a 513-token prompt from zero state, bf16 x, b, c):

1. With ``--parent DIR`` (an unpacked tree of an earlier commit): DIR's
   csrc/ssm_scan.cu in three modes, each a copy with one edit built here
   (``PARENT_MODES``): the staging alone (tiles loaded, no token loop),
   staging + exponentials (the token loop with its exp and y store but no
   state chain or shuffle reduction), and the full kernel.
2. This tree's kernel (csrc/ssm_scan.cu): checked against the plain
   version in f32 and bf16 (y and h_final, the largest error and the
   largest share of its tolerance), timed, with the bound and the share of
   the special-function units' rate it reaches, and at one token (the
   launch floor); registers and spills from ptxas.
3. Variants of this tree's source, each a copy with one edit (``EDITS``),
   checked and timed in turns with the tree's build (tree, variant,
   variant, tree) at both shapes.
4. With ``--parent DIR``: DIR's full kernel in turns with this tree's
   (parent, tree, tree, parent) at both shapes.
5. The opcode mix of the bf16, N = 16 kernel (Jamba's) from
   ``cuobjdump -sass``, and its whole listing in build/scan_probe/sass.txt.

Each time is the median of 20 calls after an L2 flush and a spin
(chip_smoke's ``Timer``).  Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (Timer, card_info, scan_case, sfu_rate)

SOURCE = "src/repro_torch/kernels/csrc/ssm_scan.cu"
OUT_DIR = ROOT / "build" / "scan_probe"
CASES = (("chunk", 256, True), ("prompt", 513, False))
# label -> the (anchor, replacement) edits that make a copy (each anchor
# must occur once); PARENT_MODES apply to DIR's source, EDITS to this tree's
PARENT_MODES = {
    "staging alone": (("for (int t = 0; t < nt; ++t) {",
                       "for (int t = 0; t < 0; ++t) {"),),
    "staging + exponentials": (
        ("        h[j] = expf(dtt * av[j]) * h[j] + dtx * bv[j];\n"
         "        acc += h[j] * cv[j];\n",
         "        acc += expf(dtt * av[j]);\n"),
        ("for (int off = 1; off < L; off <<= 1)",
         "for (int off = 1; off < 1; off <<= 1)")),
    "full": (),
}
# variants without a check: they compute no y, or another one
UNCHECKED = ("staging alone", "exp as multiply", "no y reduction",
             "no state chain", "no b, c loads", "no ring", "no y stores",
             "no dt, x loads")
# the group loop, and the design measured before it (PERF.md §6, PR 20):
# groups of 4 in pairs, each group's factors issued in the same
# straight-line code as the previous group's chain
GROUP_LOOP = """\
    const int groups = (nt + U - 1) / U;
    for (int g = 0; g < groups; ++g) {
      const int tg = g * U;
      float dtv[U], xv[U], da[U][SPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        dtv[u] = dtb[(tg + u) * CH + ch];
        xv[u] = to_f32(xb[(tg + u) * CH + ch]);
      }
      // the group's factors first: none depends on the state
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < SPL; ++j) da[u][j] = ex2(dtv[u] * a2[j]);
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float bv[SPL], cv[SPL];
        lds(bcb + (tg + u) * 2 * N + n0, bv);
        lds(bcb + ((tg + u) * 2 + 1) * N + n0, cv);
        const float dtx = dtv[u] * xv[u];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          h[j] = fmaf(da[u][j], h[j], dtx * bv[j]);
          acc = fmaf(h[j], cv[j], acc);
        }
        p[u] = fmaf(dl, xv[u], acc);
      }
      transpose_reduce<L / 2, U>(p, r);
      constexpr int TPL = U >= L ? U / L : 1;     // token sums a lane holds
      if ((r * U) % L == 0) {
        const int first = tg + r * U / L;
#pragma unroll
        for (int i = 0; i < TPL; ++i) yb[(first + i) * YLD + ch] = from_f32<T>(p[i]);
      }
    }
"""
PAIR_LOOP = """\
    // groups in pairs (a pair past nt runs on the tile's zero rows, the
    // look-ahead past the last reads ring rows it never uses), each group's
    // factors fetched while the one before it is scanned
    auto fetch = [&](int g, float (&dtv)[U], float (&xv)[U],
                     float (&da)[U][SPL]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        dtv[u] = dtb[(g * U + u) * CH + ch];
        xv[u] = to_f32(xb[(g * U + u) * CH + ch]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < SPL; ++j) da[u][j] = ex2(dtv[u] * a2[j]);
    };
    auto scan = [&](int g, const float (&dtv)[U], const float (&xv)[U],
                    const float (&da)[U][SPL]) {
      const int tg = g * U;
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float bv[SPL], cv[SPL];
        lds(bcb + (tg + u) * 2 * N + n0, bv);
        lds(bcb + ((tg + u) * 2 + 1) * N + n0, cv);
        const float dtx = dtv[u] * xv[u];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          h[j] = fmaf(da[u][j], h[j], dtx * bv[j]);
          acc = fmaf(h[j], cv[j], acc);
        }
        p[u] = fmaf(dl, xv[u], acc);
      }
      transpose_reduce<L / 2, U>(p, r);
      constexpr int TPL = U >= L ? U / L : 1;
      if ((r * U) % L == 0) {
        const int first = tg + r * U / L;
#pragma unroll
        for (int i = 0; i < TPL; ++i) yb[(first + i) * YLD + ch] = from_f32<T>(p[i]);
      }
    };
    const int pairs = (nt + 2 * U - 1) / (2 * U);
    float dtA[U], xA[U], daA[U][SPL], dtB[U], xB[U], daB[U][SPL];
    fetch(0, dtA, xA, daA);
    for (int g = 0; g < 2 * pairs; g += 2) {
      fetch(g + 1, dtB, xB, daB);
      scan(g, dtA, xA, daA);
      fetch(g + 2, dtA, xA, daA);
      scan(g + 1, dtB, xB, daB);
    }
"""
EDITS = {
    "staging alone": (("const int groups = (nt + U - 1) / U;",
                       "const int groups = 0 * nt;"),),
    "exp as multiply": (("da[u][j] = ex2(dtv[u] * a2[j]);",
                         "da[u][j] = fmaf(dtv[u], a2[j], 1.f);"),),
    "no y reduction": (("      transpose_reduce<L / 2, U>(p, r);\n", ""),),
    "no state chain": (("h[j] = fmaf(da[u][j], h[j], dtx * bv[j]);",
                        "h[j] = fmaf(da[u][j], bv[j], dtx);"),),
    "no ring": (("    if (ahead < n_tiles) {\n      const int na",
                 "    if (ahead < 0 * n_tiles) {\n      const int na"),),
    "no y stores": (("    if (k > 0) write_y((k - 1) & 1, t0 - TS);",
                     "    if (k < 0) write_y((k - 1) & 1, t0 - TS);"),),
    "no dt, x loads": (("        dtv[u] = dtb[(tg + u) * CH + ch];\n"
                        "        xv[u] = to_f32(xb[(tg + u) * CH + ch]);\n",
                        "        dtv[u] = a2[u % SPL] * -0.01f;\n"
                        "        xv[u] = a2[(u + 1) % SPL];\n"),),
    "no b, c loads": (("        lds(bcb + (tg + u) * 2 * N + n0, bv);\n"
                       "        lds(bcb + ((tg + u) * 2 + 1) * N + n0, cv);\n",
                       "#pragma unroll\n"
                       "        for (int j = 0; j < SPL; ++j) bv[j] = cv[j] = a2[j];\n"),),
    "expf": (("a2[j] = a.a[(long long)cg * N + n0 + j] * LOG2E;",
              "a2[j] = a.a[(long long)cg * N + n0 + j];"),
             ("da[u][j] = ex2(dtv[u] * a2[j]);",
              "da[u][j] = expf(dtv[u] * a2[j]);")),
    "SPL 2": (("constexpr int SPL = 4;", "constexpr int SPL = 2;"),),
    "SPL 8": (("constexpr int SPL = 4;", "constexpr int SPL = 8;"),),
    "SPL 16, 128 threads": (("constexpr int SPL = 4;",
                             "constexpr int SPL = 16;"),
                            ("constexpr int THREADS = 256;",
                             "constexpr int THREADS = 128;")),
    "U 4": (("constexpr int U = 8;", "constexpr int U = 4;"),),
    "U 16": (("constexpr int U = 8;", "constexpr int U = 16;"),),
    "pairs of 4, look-ahead": (("constexpr int U = 8;", "constexpr int U = 4;"),
                               (GROUP_LOOP, PAIR_LOOP)),
    "TS 64": (("constexpr int TS = 32;", "constexpr int TS = 64;"),),
    "STAGES 3": (("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),),
    "128 threads": (("constexpr int THREADS = 256;",
                     "constexpr int THREADS = 128;"),),
}
ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])


def edited(text: str, edits, label: str) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{label!r}: anchor {old!r} found "
                               f"{text.count(old)} times")
        text = text.replace(old, new)
    return text


def nvcc_so(src_text: str, tag: str):
    """Build one copy of the scan's source into a library; returns (its C
    entry, ptxas's lines about the scan kernels)."""
    from repro_torch.kernels import build
    src = OUT_DIR / f"{tag}.cu"
    src.write_text(src_text)
    so = OUT_DIR / f"lib{tag}.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {tag}: {res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(so)).repro_ssm_scan
    fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    return fn, ptxas_lines(res.stdout + res.stderr)


def ptxas_lines(log: str) -> list:
    """'<instantiation>: registers, stack, spills' for each scan kernel."""
    out, fn, stack = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack = f"{m.group(1)} B stack, {m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "ssm_scan" in fn:
            inst = re.search(r"kernelI(\w+?)Li(\d+)E", fn)
            out.append(f"<{inst.group(1) if inst else fn[-30:]}, N "
                       f"{inst.group(2) if inst else '?'}>: {m.group(1)} "
                       f"registers, {stack}")
    return out


def runner(fn):
    """``ssm_scan_cuda`` with its library call routed to ``fn``."""
    from repro_torch.kernels import ssm_scan as mod
    libs = SimpleNamespace(build=lambda: SimpleNamespace(fn=lambda name: fn))

    def call(*args):
        saved, mod.build = mod.build, libs
        try:
            return mod.ssm_scan_cuda(*args)
        finally:
            mod.build = saved
    return call


def inputs(torch, cfg, dtype):
    """(case, args, want y, want h, bytes, exponentials) of both shapes."""
    from repro_torch.kernels.ssm_scan import ssm_scan_ref
    out = []
    for case, s, carried in CASES:
        args, nbytes, exps, _ = chip_smoke.scan_case(torch, cfg, s, carried,
                                                     dtype)
        want_y, want_h = ssm_scan_ref(*args)
        out.append((case, args, want_y, want_h, nbytes, exps))
    return out


def check(tag: str, call, args, want_y, want_h, dtype, torch) -> str:
    """Errors of y and h_final against the plain version, each as the
    largest |err| and the largest share of the stated tolerance (raises
    past 1)."""
    y, h = call(*args)
    torch.cuda.synchronize()
    tol_y = chip_smoke.SCAN_F32_TOL if dtype == torch.float32 \
        else chip_smoke.BF16_TOL
    parts = []
    for name, got, want, (atol, rtol) in (("y", y, want_y, tol_y),
                                          ("h", h, want_h,
                                           chip_smoke.SCAN_F32_TOL)):
        err = (got.float() - want.float()).abs()
        share = float((err / (atol + rtol * want.float().abs())).max())
        parts.append(f"{name} {float(err.max()):.3e} ({share:.2f} of tol)")
        if share > 1:
            raise AssertionError(f"{tag}: {name} outside its tolerance "
                                 f"({share:.2f})")
    return ", ".join(parts)


def parent_modes(torch, timer, cfg, parent: Path) -> None:
    text = (parent / SOURCE).read_text()
    with ThreadPoolExecutor(len(PARENT_MODES)) as ex:
        built = dict(zip(PARENT_MODES, ex.map(
            lambda i_m: nvcc_so(edited(text, PARENT_MODES[i_m[1]], i_m[1]),
                                f"parent-mode-{i_m[0]}"),
            enumerate(PARENT_MODES))))
    for line in built["full"][1]:
        print(f"ptxas parent {line}", flush=True)
    for case, args, want_y, want_h, _, _ in inputs(torch, cfg,
                                                   torch.bfloat16):
        ms = {}
        for mode, (fn, _) in built.items():
            call = runner(fn)
            if mode == "full":
                check(f"parent [{case}]", call, args, want_y, want_h,
                      torch.bfloat16, torch)
            ms[mode] = timer(partial(call, *args))
        print(f"step 0 parent [{case}] ms: "
              + ", ".join(f"{m} {t:.4f}" for m, t in ms.items()), flush=True)


def tree_kernel(torch, timer, cfg, sfu: float, bw: float):
    fn, regs = nvcc_so((ROOT / SOURCE).read_text(), "tree")
    for line in regs:
        print(f"ptxas tree {line}", flush=True)
    call = runner(fn)
    for dtype in (torch.float32, torch.bfloat16):
        for case, args, want_y, want_h, nbytes, exps in inputs(torch, cfg,
                                                               dtype):
            errs = check(f"tree [{case}] {dtype}", call, args, want_y, want_h,
                         dtype, torch)
            ms = timer(partial(call, *args))
            t_sfu, t_bytes = exps / sfu * 1e3, nbytes / bw * 1e3
            print(f"tree [{case}] {dtype}: {ms:.4f} ms; bound "
                  f"{max(t_sfu, t_bytes):.4f} (exponentials {t_sfu:.4f}, "
                  f"bytes {t_bytes:.4f}); special-function units "
                  f"{t_sfu / ms:.3f} busy; errors {errs}", flush=True)
    # the launch floor: one token over the same channels
    args, _, _, _ = chip_smoke.scan_case(torch, cfg, 1, True, torch.bfloat16)
    print(f"tree [one token] bfloat16: {timer(partial(call, *args)):.4f} ms",
          flush=True)
    return fn


def variants(torch, timer, cfg, tree_fn) -> None:
    text = (ROOT / SOURCE).read_text()
    with ThreadPoolExecutor(len(EDITS)) as ex:
        built = dict(zip(EDITS, ex.map(
            lambda i_l: nvcc_so(edited(text, EDITS[i_l[1]], i_l[1]),
                                f"variant-{i_l[0]}"),
            enumerate(EDITS))))
    tree = runner(tree_fn)
    for label, (fn, regs) in built.items():
        for line in regs:
            print(f"ptxas {label}: {line}", flush=True)
        var = runner(fn)
        dtypes = (torch.float32, torch.bfloat16) if label == "expf" \
            else (torch.bfloat16,)
        for dtype in dtypes:
            for case, args, want_y, want_h, _, _ in inputs(torch, cfg, dtype):
                errs = "" if label in UNCHECKED else check(
                    f"{label} [{case}]", var, args, want_y, want_h, dtype,
                    torch)
                if dtype == torch.float32:
                    print(f"variant {label} [{case}] f32 errors {errs}",
                          flush=True)
                    continue
                ms = [timer(partial(f, *args)) for f in (tree, var, var,
                                                         tree)]
                print(f"A/B {label} [{case}] ms (tree, variant, variant, "
                      f"tree): tree {ms[0]:.4f} / {ms[3]:.4f}, variant "
                      f"{ms[1]:.4f} / {ms[2]:.4f}"
                      + (f"; errors {errs}" if errs else ""), flush=True)


def sass_mix() -> None:
    """Opcode counts of the bf16, N = 16 instantiation; the listing goes
    to OUT_DIR / "sass.txt"."""
    import shutil
    from repro_torch.kernels import build
    cubin = OUT_DIR / "tree.cubin"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                      "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                    str(ROOT / SOURCE)], capture_output=True, check=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    lines, keep = [], False
    for line in text.splitlines():
        if "Function :" in line:
            keep = "ssm_scan_kernelI13__nv_bfloat16Li16E" in line
        if keep and line.strip():
            lines.append(line.strip())
    (OUT_DIR / "sass.txt").write_text("\n".join(lines) + "\n")
    ops = {}
    for line in lines:
        m = re.match(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m:
            op = m.group(1).split(".")[0]
            ops[op] = ops.get(op, 0) + 1
    top = sorted(ops.items(), key=lambda kv: -kv[1])
    print(f"SASS <bf16, N 16>: {sum(ops.values())} instructions; "
          + ", ".join(f"{k} {v}" for k, v in top[:30]), flush=True)


def parent_ab(torch, timer, cfg, parent: Path, tree_fn) -> None:
    fn, _ = nvcc_so((parent / SOURCE).read_text(), "parent")
    old, new = runner(fn), runner(tree_fn)
    for case, args, want_y, want_h, _, _ in inputs(torch, cfg,
                                                   torch.bfloat16):
        check(f"parent [{case}]", old, args, want_y, want_h, torch.bfloat16,
              torch)
        ms = [timer(partial(f, *args)) for f in (old, new, new, old)]
        print(f"A/B parent [{case}] ms (parent, tree, tree, parent): parent "
              f"{ms[0]:.4f} / {ms[3]:.4f}, tree {ms[1]:.4f} / {ms[2]:.4f}; "
              f"tree / parent {(ms[1] + ms[2]) / (ms[0] + ms[3]):.3f}",
              flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    _, bw, _ = chip_smoke.card_info(torch)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cfg = get_config(chip_smoke.JAMBA)
    timer = chip_smoke.Timer(torch)
    parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
        parent_modes(torch, timer, cfg, parent)
    tree_fn = tree_kernel(torch, timer, cfg, chip_smoke.sfu_rate(torch), bw)
    sass_mix()
    variants(torch, timer, cfg, tree_fn)
    if parent is not None:
        parent_ab(torch, timer, cfg, parent, tree_fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())

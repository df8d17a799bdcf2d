#!/usr/bin/env python3
"""Where flash attention's backward kernel spends its time, on one NVIDIA
card.

    python3 tools/flash_bwd_probe.py [--against FILE] [--parent DIR]
    python3 tools/flash_bwd_probe.py --ptxas

At chip_smoke's train shape (Qwen3-8B's attention: q, O, dO (2, 2048, 32,
128), k, v (2, 2048, 8, 128), causal, bf16; 171.9 GFLOP in five causal
products):

1. This tree's kernel (csrc/flash_attention_bwd.cu) checked against the
   plain backward, its time and TFLOP/s beside SDPA's backward
   (``is_causal``, ``enable_gqa``), two calls bitwise equal, and the
   device time of each of its three launches (the preprocess, the
   key-major kernel, the dQ postprocess) from one profiled call.
2. Variants of this tree's source, each a copy with the edits of
   ``EDITS`` (each anchor must occur once), built here with ptxas's
   registers and spills, and timed in turns with the tree's build (tree,
   variant, variant, tree): the ring alone (loads and barriers: no
   products, no dQ adds), no dQ adds (the products, the writers only
   handing the buffers back), the register split between the producer
   and the consumer warpgroups, and the step's products in the order
   that packs P^T to bf16 before dP^T is taken (one f32 tile at a time).
   With ``--against FILE``, FILE too (another revision of
   flash_attention_bwd.cu with this tree's C entry), built and timed the
   same way, and checked.
3. With ``--parent DIR`` (an unpacked tree of an earlier commit): DIR's
   flash_attention_bwd.cu built here and timed in turns with this tree's
   (parent, tree, tree, parent), checked against the plain backward,
   with TFLOP/s and SDPA's backward beside them.  DIR's C entry is the
   one before the key-major redesign (a (B, H, S) f32 scratch, no dQ sums
   or counters).
4. ``--ptxas``: registers, stack and spills of each kernel of
   flash_attention_bwd.cu and ptxas's C75xx notes, and the bf16 kernels'
   SASS counts
   (HGMMA, HMMA, TMA loads, bulk copies, spills, the highest register);
   parts 1-2 print the same for the tree's and each variant's bf16
   kernels.

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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402  (Timer, card_info, relnorm, bwd_inputs)

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT_DIR = ROOT / "build" / "flash_bwd_probe"
SHAPE = (2, 2048, 32, 8, 128)   # batch, S, heads, KV heads, head_dim
FLOPS = 5 * 2 * SHAPE[0] * SHAPE[2] * (SHAPE[1] * (SHAPE[1] + 1) // 2) \
    * SHAPE[4]
# the writer's handling of one step's partial, from its wait for the
# partial to its counter update
_WRITER = """          if (it.j == 0) {
            bulk_out<false>(dst, src, L::DQ_BYTES);
          } else {
            while (ld_acquire(ctr) != it.j) __nanosleep(32);
            fence_proxy_global();
            bulk_out<true>(dst, src, L::DQ_BYTES);
          }
          asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
          g9::mbar_arrive(bar(DQ_EMPTY + s));
          asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");
          fence_proxy_global();
          const int last = last_key_tile(p, i);
          if (it.j < last)
            asm volatile("red.release.gpu.global.add.s32 [%0], %1;\\n" ::"l"(
                             ctr),
                         "r"(1)
                         : "memory");
          else if (it.j > 0)
            *ctr = 0;   // the query tile's last add: ready for the next call
"""
_NO_ADDS = (_WRITER, "          g9::mbar_arrive(bar(DQ_EMPTY + s));\n")
# a step's products up to dK in two orders: S^T alone, P^T packed to
# bf16, then dP^T and dV in flight together, dS^T from P^T's bf16
# fragments (_ORDER); and the tree's, both f32 tiles at once (S^T and
# dP^T in flight together, P^T computed under dP^T, dS^T from P^T in f32)
_ORDER = """      // S^T = K Q^T: this warpgroup's 64 keys x 64 rows
      float st[32];
      g9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        g9::mma_kk_n64(
            st,
            g9::kmajor_desc(sk + (kk / 4) * L::KV_BOX + cw * 64 * ROW +
                            (kk % 4) * 32),
            g9::kmajor_desc(sq + (kk / 4) * L::Q_BOX + (kk % 4) * 32), kk > 0);
      g9::wgmma_commit();
      g9::wgmma_wait<0>();
      g9::fence_acc(st);
      // P^T = 2^(s sl2 - L log2 e); keys past S or past a row's causal
      // limit are selected to 0 only where the tile reaches them
      const int pos0 = i * p.pt;
      const bool masked =
          key0 + BKEY - 1 > pos0 + p.q_offset || key0 + BKEY > p.s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ld + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * j + e;
          const float pv = ex2(fmaf(st[idx], sl2, (e & 1) ? -l2.y : -l2.x));
          if (masked) {
            const int cp = col_pos[8 * j + cq + (e & 1)];
            const int pos = pos0 + cp;
            const int lim =
                cp >= 0 && pos < p.s ? min(p.s, pos + p.q_offset + 1) : 0;
            st[idx] = my_key + 8 * (e >> 1) < lim ? pv : 0.f;
          } else {
            st[idx] = pv;
          }
        }
      }
      // P^T in bf16 as A fragments (rows 16 kk .. of the reduction axis
      // are the sums 8 kk .. 8 kk + 7); then dP^T = V dO^T and dV += P^T dO
      // in flight together (B MN-major: the stage's rows are the reduction
      // axis).  P^T is packed before dP^T is taken: both f32 tiles at once
      // would not fit beside dK and dV
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          pa[kk][f] = pack_bf16(st[8 * kk + 2 * f], st[8 * kk + 2 * f + 1]);
      float dpt[32];
      g9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        g9::mma_kk_n64(
            dpt,
            g9::kmajor_desc(sv + (kk / 4) * L::KV_BOX + cw * 64 * ROW +
                            (kk % 4) * 32),
            g9::kmajor_desc(sdo + (kk / 4) * L::Q_BOX + (kk % 4) * 32),
            kk > 0);
      g9::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        g9::mma_rs<D>(dv, pa[kk], g9::mnmajor_desc(sdo + kk * 16 * ROW),
                      !(first && kk == 0));
      g9::wgmma_commit();
      g9::wgmma_wait<1>();
      g9::fence_acc(dpt);
      // dS^T = P^T (dP^T - D), P^T as the bf16 fragments dV takes; then
      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float2 pf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&pa[kk][f]));
          const float2 dd = *reinterpret_cast<const float2*>(
              ld + BQ + 8 * (2 * kk + (f >> 1)) + cq);
          da[kk][f] = pack_bf16(pf.x * (dpt[8 * kk + 2 * f] - dd.x),
                                pf.y * (dpt[8 * kk + 2 * f + 1] - dd.y));
        }
      g9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        g9::mma_rs<D>(dk, da[kk], g9::mnmajor_desc(sq + kk * 16 * ROW),
                      !(first && kk == 0));
      g9::wgmma_commit();
"""
_BOTH = """      // S^T = K Q^T and dP^T = V dO^T in flight together: this
      // warpgroup's 64 keys x 64 rows each, both f32 tiles beside dK and dV
      float st[32], dpt[32];
      g9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        g9::mma_kk_n64(
            st,
            g9::kmajor_desc(sk + (kk / 4) * L::KV_BOX + cw * 64 * ROW +
                            (kk % 4) * 32),
            g9::kmajor_desc(sq + (kk / 4) * L::Q_BOX + (kk % 4) * 32), kk > 0);
      g9::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        g9::mma_kk_n64(
            dpt,
            g9::kmajor_desc(sv + (kk / 4) * L::KV_BOX + cw * 64 * ROW +
                            (kk % 4) * 32),
            g9::kmajor_desc(sdo + (kk / 4) * L::Q_BOX + (kk % 4) * 32),
            kk > 0);
      g9::wgmma_commit();
      g9::wgmma_wait<1>();
      g9::fence_acc(st);
      // P^T = 2^(s sl2 - L log2 e); keys past S or past a row's causal
      // limit are selected to 0 only where the tile reaches them
      const int pos0 = i * p.pt;
      const bool masked =
          key0 + BKEY - 1 > pos0 + p.q_offset || key0 + BKEY > p.s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ld + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * j + e;
          const float pv = ex2(fmaf(st[idx], sl2, (e & 1) ? -l2.y : -l2.x));
          if (masked) {
            const int cp = col_pos[8 * j + cq + (e & 1)];
            const int pos = pos0 + cp;
            const int lim =
                cp >= 0 && pos < p.s ? min(p.s, pos + p.q_offset + 1) : 0;
            st[idx] = my_key + 8 * (e >> 1) < lim ? pv : 0.f;
          } else {
            st[idx] = pv;
          }
        }
      }
      // dS^T = P^T (dP^T - D) in f32, in place of dP^T; then P^T and dS^T
      // in bf16 as A fragments (rows 16 kk .. of the reduction axis are
      // the sums 8 kk .. 8 kk + 7), and dV += P^T dO, dK += dS^T Q (B
      // MN-major: the stage's rows are the reduction axis)
      g9::wgmma_wait<0>();
      g9::fence_acc(dpt);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd =
            *reinterpret_cast<const float2*>(ld + BQ + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] =
              st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          pa[kk][f] = pack_bf16(st[8 * kk + 2 * f], st[8 * kk + 2 * f + 1]);
          da[kk][f] = pack_bf16(dpt[8 * kk + 2 * f], dpt[8 * kk + 2 * f + 1]);
        }
      g9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        g9::mma_rs<D>(dv, pa[kk], g9::mnmajor_desc(sdo + kk * 16 * ROW),
                      !(first && kk == 0));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        g9::mma_rs<D>(dk, da[kk], g9::mnmajor_desc(sq + kk * 16 * ROW),
                      !(first && kk == 0));
      g9::wgmma_commit();
"""
_Q_WAIT = "      g9::mbar_wait(bar(Q_FULL + s), (step >> 1) & 1);\n"
# label -> edits; a variant without the products or the adds is not
# checked (its outputs are not the gradient)
EDITS = {
    "ring alone": (_NO_ADDS, (_Q_WAIT, _Q_WAIT + """\
      {
        __syncwarp();
        if (lead) g9::mbar_arrive(bar(Q_EMPTY + s));
        if (does_dq) {
          if (step >= 2) g9::mbar_wait(bar(DQ_EMPTY + s), ((step >> 1) + 1) & 1);
          __syncwarp();
          if (lead) g9::mbar_arrive(bar(DQ_FULL + s));
        }
        continue;
      }
""")),
    "no dQ adds": (_NO_ADDS,),
    "registers 40 / 232": (
        ("constexpr int PRODUCER_REGS = 24;", "constexpr int PRODUCER_REGS = 40;"),
        ("constexpr int CONSUMER_REGS = 240;", "constexpr int CONSUMER_REGS = 232;")),
}
EDITS["P^T to bf16 before dP^T"] = ((_BOTH, _ORDER),)
CHECKED = ("registers 40 / 232", "P^T to bf16 before dP^T")
# the C entry before the key-major redesign: (B, H, S) f32 scratch only
PARENT_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]


def nvcc(src: Path, out: Path) -> tuple[Path, str]:
    """``src`` built as the tree's libraries are (ptxas -v on): the
    library and the compiler's log."""
    from repro_torch.kernels import build
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{CSRC}",
                          "-o", str(out), str(src)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src}: {res.stdout}{res.stderr}")
    return out, res.stdout + res.stderr


def ptxas_lines(log: str, tag: str) -> list[str]:
    """Registers, stack and spills of each kernel in ``log``, and its
    C75xx notes."""
    lines, fn, stack = [], "", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack = f"{m.group(1)} B stack, {m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name = re.sub(r"^_ZN\w+?_cu_\w{8}", "", fn)[:60]
            lines.append(f"ptxas {tag} {name}: {m.group(1)} registers, "
                         f"{stack}")
        if "C75" in line:
            lines.append(f"ptxas {tag}: {line.strip()[:160]}")
    return lines


def sass_summary(so: Path, tag: str) -> None:
    """Per bf16 kernel of ``so``: instructions, HGMMA (wgmma), HMMA
    (mma.sync), UTMALDG (TMA loads), the bulk copies and reduces, spill
    stores and loads (STL, LDL), and the highest register it names."""
    from packed_attention_probe import sass_functions
    for name, lines in sass_functions(so).items():
        if "bwd_bf16_kernel" not in name:
            continue
        ops = [next(t for t in re.sub(r"^/\*\w+\*/\s*", "", x).split()
                    if not t.startswith("@"))
               for x in lines if x.startswith("/*") and len(x.split()) > 1]
        count = {op: sum(o.split(".")[0] == op for o in ops)
                 for op in ("HGMMA", "HMMA", "UTMALDG", "UBLKCP", "UBLKRED",
                            "STL", "LDL")}
        regs = [int(r) for x in lines for r in re.findall(r"\bR(\d+)\b", x)]
        print(f"SASS {tag} {name[-48:]}: {len(ops)} instructions, "
              + ", ".join(f"{k} {v}" for k, v in count.items())
              + f", highest register R{max(regs, default=0)}", flush=True)


def inputs(torch):
    """The train shape's inputs, the forward's output and row
    log-sum-exp, and the plain backward."""
    from repro_torch.kernels import flash_attention as fa
    b, s, h, kv, d = SHAPE
    q, k, v, do = chip_smoke.bwd_inputs(torch, torch.bfloat16, b, s, h, kv,
                                        d, seed=3)
    lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    out = fa.flash_attention_cuda(q, k, v, lse=lse)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do)
    return (q, k, v, out, lse, do), want


def check(tag: str, got, want) -> str:
    from repro_torch.kernels import flash_attention as fa  # noqa: F401
    errs = [chip_smoke.relnorm(g, w) for g, w in zip(got, want)]
    if max(errs) > chip_smoke.TRAIN_BWD_REL["bfloat16"]:
        raise AssertionError(f"{tag}: dq/dk/dv rel-norm {errs}")
    return "rel-norm " + " ".join(f"{e:.2e}" for e in errs)


def sdpa_ms(torch, timer, args) -> float:
    q, k, v, _, _, do = args
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = do.transpose(1, 2).contiguous()
    return timer(lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                             retain_graph=True))


def launches_ms(torch, call) -> str:
    """Device ms of each launch of one call, from a profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = re.sub(r"^.*?(flash_bwd_\w+?_kernel).*$", r"\1", e.name())
            by[name] = by.get(name, 0.0) + e.duration_ns() / 1e6
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(by.items()))


def tree_kernel(torch, timer) -> None:
    from repro_torch.kernels import flash_attention as fa
    args, want = inputs(torch)
    call = partial(fa.flash_attention_bwd_cuda, *args)
    got = call()
    same = all(torch.equal(a, c) for a, c in zip(got, call()))
    ms = timer(call)
    lib = sdpa_ms(torch, timer, args)
    print(f"tree bwd {SHAPE}: {check('tree', got, want)}, two calls bitwise "
          f"equal {same}; {ms:.4f} ms = {FLOPS / ms / 1e9:.1f} TFLOP/s; "
          f"SDPA backward {lib:.4f} ms ({FLOPS / lib / 1e9:.1f} TFLOP/s); "
          f"device ms per launch (warm L2): {launches_ms(torch, call)}",
          flush=True)


def variants(torch, timer, against: Path | None) -> None:
    """Each variant of ``EDITS``, and with ``against`` that source (a
    revision of flash_attention_bwd.cu with this tree's C entry), built
    and timed in turns with the tree's build."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    sources, checked = {}, set(CHECKED)
    for label, edits in EDITS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {label!r}: anchor {old[:60]!r} "
                                   f"found {src.count(old)} times")
            src = src.replace(old, new)
        sources[label] = src
    if against is not None:
        sources[f"against {against}"] = against.read_text()
        checked.add(f"against {against}")

    def make(i_label):
        i, label = i_label
        path = OUT_DIR / f"variant-{i}.cu"
        path.write_text(sources[label])
        return nvcc(path, OUT_DIR / f"variant-{i}.so")
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(make, enumerate(sources)))
    libs = build.build()
    tree = libs.fn("flash_attention_bwd")
    args, want = inputs(torch)
    call = partial(fa.flash_attention_bwd_cuda, *args)
    for label, (so, log) in zip(sources, built):
        for line in ptxas_lines(log, label):
            if "bf16_kernel" in line or "C75" in line:
                print(line, flush=True)
        sass_summary(so, label)
        fn = ctypes.CDLL(str(so)).repro_flash_attention_bwd
        fn.argtypes = build.SIGNATURES["flash_attention_bwd"][1]
        fn.restype = ctypes.c_int
        ms = []
        try:
            for lib in (tree, fn, fn, tree):
                libs._fns["flash_attention_bwd"] = lib
                got = call()
                if lib is tree or label in checked:
                    check(f"{label} {'tree' if lib is tree else 'variant'}",
                          got, want)
                ms.append(timer(call))
        finally:
            libs._fns["flash_attention_bwd"] = tree
        print(f"A/B {label} ms (tree, variant, variant, tree): tree "
              f"{ms[0]:.4f} / {ms[3]:.4f}, variant {ms[1]:.4f} / "
              f"{ms[2]:.4f}", flush=True)


def parent_ab(torch, timer, parent: Path) -> None:
    from repro_torch.kernels import flash_attention as fa
    so, log = nvcc(parent / "src/repro_torch/kernels/csrc/"
                   "flash_attention_bwd.cu", OUT_DIR / "parent-bwd.so")
    for line in ptxas_lines(log, "parent"):
        print(line, flush=True)
    pfn = ctypes.CDLL(str(so)).repro_flash_attention_bwd
    pfn.argtypes, pfn.restype = PARENT_ARGS, ctypes.c_int
    args, want = inputs(torch)
    q, k, v, out, lse, do = args
    b, s, h, kv, d = SHAPE
    delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    grads = [torch.empty_like(x) for x in (q, k, v)]

    def old():
        rc = pfn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 *(g.data_ptr() for g in grads), 1, b, s, h, kv, d, 0,
                 d ** -0.5, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent backward: {rc}")
        return grads
    new = partial(fa.flash_attention_bwd_cuda, *args)
    print(f"parent bwd: {check('parent', old(), want)}; tree: "
          f"{check('tree', new(), want)}", flush=True)
    ms = [timer(old), timer(new), timer(new), timer(old)]
    lib = sdpa_ms(torch, timer, args)
    print(f"A/B parent vs tree bwd {SHAPE} ms (parent, tree, tree, parent): "
          f"parent {ms[0]:.4f} / {ms[3]:.4f} ({FLOPS / ms[0] / 1e9:.1f} "
          f"TFLOP/s), tree {ms[1]:.4f} / {ms[2]:.4f} "
          f"({FLOPS / ms[1] / 1e9:.1f} TFLOP/s); SDPA backward {lib:.4f}",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    chip_smoke.card_info(torch)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    # the tree's source built here too, for its compiler log whether or
    # not build/ already holds the library
    with ThreadPoolExecutor(1) as ex:
        tree = ex.submit(nvcc, CSRC / "flash_attention_bwd.cu",
                         OUT_DIR / "tree.so")
        build.build()
        so, log = tree.result()
    for line in ptxas_lines(log, "tree"):
        if "--ptxas" in sys.argv or "bf16_kernel" in line or "C75" in line:
            print(line, flush=True)
    sass_summary(so, "tree")
    if "--ptxas" in sys.argv:
        return 0
    timer = chip_smoke.Timer(torch)
    tree_kernel(torch, timer)
    against = None
    if "--against" in sys.argv:
        against = Path(sys.argv[sys.argv.index("--against") + 1]).resolve()
    variants(torch, timer, against)
    if "--parent" in sys.argv:
        parent_ab(torch, timer,
                  Path(sys.argv[sys.argv.index("--parent") + 1]).resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())

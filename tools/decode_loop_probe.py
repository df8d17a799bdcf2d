#!/usr/bin/env python3
"""Where a decode-attention loop spends its time, on one NVIDIA card.

    python3 tools/decode_loop_probe.py

Part 1 builds ``tools/decode_loop_probe.cu`` (a copy of the register-resident
row loop that decode attention and the fused op's attention role ran before
``csrc/attn_decode.cuh``) with ``nvcc -Xptxas -v`` and times it in three
modes -- loads only, loads + scoring, the full loop -- at chip_smoke's two
shapes (Qwen3-8B heads, bf16):
  decode  8 rows over (8, 1024, 8, 128) caches, lengths as chip_smoke's
          ``decode_case``, one CTA per (row, KV head);
  role    64 rows over (64, 1024, 8, 128) caches, lengths as chip_smoke's
          ``overlap_case``, a persistent grid of 2 CTAs per SM over
          (row, KV head, 256-row chunk) units: the fused op's attention
          role alone.
Part 2 streams the role's caches through a copy of the new unit's cp.async
ring with no arithmetic (as stored, and as a head-major copy), then times
the port's decode attention (``csrc/decode_attention.cu``) at the decode
shape and the fused op's attention role alone (no GEMM rows), each for
several chunk sizes.

Each time is the median of 20 calls after an L2 flush and a spin
(chip_smoke's ``Timer``); GB/s counts the K/V rows attended, q and out
once.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (Timer, card_info)

PROBE = Path(__file__).resolve().parent / "decode_loop_probe.cu"
OUT_DIR = ROOT / "build" / "decode_loop_probe"
MODES = {0: "loads only", 1: "loads + scoring", 2: "full loop"}
DECODE_CHUNKS = (64, 128, 256, 1024)
ROLE_CHUNKS = (128, 256, 512, 1024)


def build_probe():
    from repro_torch.kernels import build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / "libdecode_loop_probe.so"
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                          str(PROBE)], capture_output=True, text=True)
    print(out.stdout + out.stderr, flush=True)
    out.check_returncode()
    lib = ctypes.CDLL(str(so))
    fn = lib.probe_decode_loop
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 9 + [i] * 7 + [ctypes.c_float, vp]
    fn.restype = i
    lib.probe_ring.argtypes = [vp] * 4 + [i] * 6 + [vp]
    lib.probe_ring.restype = i
    return fn, lib.probe_ring


def inputs(torch, shape: str):
    """(q, k, v, cache_len, lens) at one of the two shapes."""
    if shape == "decode":
        b, seed = 8, 13
        lens = np.random.default_rng(0).integers(16, 601, 8) + 16
    else:
        b, seed = 64, 23
        lens = np.random.default_rng(23).integers(1, 1025, 64)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = randn(b, 32, 128), randn(b, 1024, 8, 128), randn(b, 1024, 8, 128)
    clen = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, clen, lens


def gbps(lens, ms: float) -> float:
    nbytes = int(lens.sum()) * 8 * 128 * 2 * 2 + 2 * len(lens) * 32 * 128 * 2
    return nbytes / (ms * 1e-3) / 1e9


def part1(torch, timer, fn) -> None:
    from repro_torch.kernels.decode_attention import decode_attention_ref
    ctas = torch.cuda.get_device_properties(0).multi_processor_count * 2
    for shape, layout in (("decode", 0), ("role", 1)):
        q, k, v, clen, lens = inputs(torch, shape)
        b, s = k.shape[0], k.shape[1]
        n_chunks = s // 256
        grid = b * 8 if layout == 0 else ctas
        out = torch.empty_like(q)
        sink = torch.zeros(grid * 256, device="cuda")
        part_ml = torch.empty(b * 8 * n_chunks * 2 * 4, device="cuda")
        part_acc = torch.empty(b * 8 * n_chunks * 4 * 128, device="cuda")
        tickets = torch.zeros(b * 8, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run(mode):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), clen.data_ptr(),
                    out.data_ptr(), sink.data_ptr(), part_ml.data_ptr(),
                    part_acc.data_ptr(), tickets.data_ptr(), mode, layout, b,
                    8, s, 256, ctas, 128 ** -0.5, stream)
            if rc != 0:
                raise RuntimeError(f"probe launch failed: {rc}")
        run(2)
        torch.cuda.synchronize()
        err = chip_smoke.check_close(f"probe {shape}", out,
                                     decode_attention_ref(q, k, v, clen))
        for mode, what in MODES.items():
            ms = timer(partial(run, mode))
            print(f"probe {shape} ({grid} CTAs, {int(lens.sum())} rows): "
                  f"mode {mode} {what}: {ms:.4f} ms, {gbps(lens, ms):.1f} GB/s"
                  + (f"  (max abs err vs plain {err:.3e})" if mode == 2
                     else ""), flush=True)


def ring_only(torch, timer, ring) -> None:
    """The new unit's cp.async ring without arithmetic, over the role's
    caches as stored and over a head-major copy, for two chunk sizes."""
    q, k, v, clen, lens = inputs(torch, "role")
    ctas = torch.cuda.get_device_properties(0).multi_processor_count * 2
    sink = torch.zeros(ctas * 256, device="cuda")
    kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))
    stream = torch.cuda.current_stream().cuda_stream
    for chunk in (512, 1024):
        for head_major, (kk, vv) in ((0, (k, v)), (1, (kh, vh))):
            def run():
                rc = ring(kk.data_ptr(), vv.data_ptr(), clen.data_ptr(),
                          sink.data_ptr(), 64, 8, 1024, chunk, ctas,
                          head_major, stream)
                if rc != 0:
                    raise RuntimeError(f"ring probe launch failed: {rc}")
            ms = timer(run)
            print(f"ring only, role shape, chunk {chunk}, "
                  + ("(B, KV, S, D) copy" if head_major else
                     "(B, S, KV, D) as stored")
                  + f": {ms:.4f} ms, {gbps(lens, ms):.1f} GB/s", flush=True)


def part2(torch, timer) -> None:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fused_overlap as fo
    q, k, v, clen, lens = inputs(torch, "decode")
    want = da.decode_attention_ref(q, k, v, clen)
    for chunk in DECODE_CHUNKS:
        got = da.launch(q, k, v, clen, chunk=chunk)
        torch.cuda.synchronize()
        err = chip_smoke.check_close(f"decode chunk {chunk}", got, want)
        live = int(sum(-(-int(n) // chunk) for n in lens)) * 8
        ms = timer(partial(da.launch, q, k, v, clen, chunk=chunk))
        print(f"decode_attention chunk {chunk}: grid {da.launch.units[0]} "
              f"units, {live} live: {ms:.4f} ms, {gbps(lens, ms):.1f} GB/s "
              f"(max abs err {err:.3e})", flush=True)
    q, k, v, clen, lens = inputs(torch, "role")
    x = torch.empty((0, 4096), dtype=torch.bfloat16, device="cuda")
    w = torch.empty((4096, 4096), dtype=torch.bfloat16, device="cuda")
    want = da.decode_attention_ref(q, k, v, clen)
    for chunk in ROLE_CHUNKS:
        _, got = fo.launch(x, w, q, k, v, clen, chunk=chunk)
        torch.cuda.synchronize()
        err = chip_smoke.check_close(f"role chunk {chunk}", got, want)
        ms = timer(partial(fo.launch, x, w, q, k, v, clen, chunk=chunk))
        print(f"fused_overlap attention role alone, chunk {chunk}: "
              f"{fo.launch.units[0]} units on {fo.launch.schedule[0]} CTAs: "
              f"{ms:.4f} ms, {gbps(lens, ms):.1f} GB/s (max abs err "
              f"{err:.3e})", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_loop_probe: no CUDA device", file=sys.stderr)
        return 2
    chip_smoke.card_info(torch)
    timer = chip_smoke.Timer(torch)
    loop, ring = build_probe()
    part1(torch, timer, loop)
    if "--old-only" not in sys.argv:
        ring_only(torch, timer, ring)
        part2(torch, timer)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""NanoFlow §5.5: run the automatic parameter search for any architecture
and print the resulting overlapped schedule (the port's counterpart of
``examples/autosearch_plan.py``, with its flags and lines; the resource
occupancy render is left to the benchmarks).

    PYTHONPATH=src python -m repro_torch.launch.plan --arch deepseek-v2-236b

Host arithmetic on the cost model's data-sheet constants: it touches no
device and needs no card.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.core.autosearch import (autosearch, sequential_schedule,
                                         throughput_estimate)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--hw", default="H100", choices=sorted(cm.HARDWARE))
    ap.add_argument("--prefill", type=float, default=1024)
    ap.add_argument("--decode", type=float, default=512)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    hw = cm.HARDWARE[args.hw]
    w = cm.Workload(args.prefill, args.decode)
    ms = cm.model_stats(cfg)
    if cm.e_kv(hw, ms, args.devices) <= 0:
        gb = ms.p_model * ms.dtype_bytes / 1e9
        ap.error(f"{args.arch}'s weights ({gb:.1f} GB) leave no room for a "
                 f"KV cache on {args.devices}x{hw.name} "
                 f"({hw.mem_size / 1e9:g} GB each)")

    print(f"=== {args.arch} @ {args.devices}x{hw.name}, p={args.prefill} "
          f"d={args.decode} ===")
    print(f"hardware (data-sheet constants of the model, not measured): "
          f"{hw.compute / 1e12:g} TFLOP/s, {hw.mem_bw / 1e9:g} GB/s, "
          f"{hw.mem_size / 1e9:g} GB, {hw.net_bw / 1e9:g} GB/s network")
    print(f"classification: {cm.classify(hw, ms, w, args.devices)} "
          f"(T_R={cm.t_r(hw, ms, w, args.devices):.3f})")
    opt = cm.optimal_throughput(hw, ms, args.devices)
    print(f"optimal (Eq.9): {opt:.0f} tok/s total, "
          f"{opt/args.devices:.0f} tok/s/chip")

    nano = autosearch(cfg, w, hw, args.devices)
    seq = sequential_schedule(cfg, w, hw, args.devices)
    tp = throughput_estimate(cfg, nano, w, hw, args.devices)
    print(f"\nautosearch: nano_kqv={nano.nano_kqv} nano_dense={nano.nano_dense}")
    print(f"iter time: {nano.iter_time*1e3:.3f} ms/layer "
          f"(sequential {seq.iter_time*1e3:.3f} ms = "
          f"{seq.iter_time/nano.iter_time:.2f}x slower)")
    print(f"modeled throughput: {tp:.0f} tok/s/chip "
          f"({100*tp*args.devices/opt:.1f}% of optimal)")
    print(f"critical path: {' -> '.join(nano.critical_path)}")
    print("\nunit assignment (execution-unit scheduling):")
    for name, u in sorted(nano.unit_assignment.items()):
        node = nano.pipeline.nodes[name]
        print(f"  {name:10s} {node.kind:8s} units={u:.2f} "
              f"[{node.start*1e3:7.3f}, {node.end*1e3:7.3f}] ms")


if __name__ == "__main__":
    main()

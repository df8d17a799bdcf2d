"""NanoFlow §3: analytical cost model of LLM serving (port of
``repro.core.costmodel``, the same names, signatures and arithmetic).

Implements Eqs. 1–9 and the Table-2 per-operation breakdown, parameterized by
(hardware, model config, user query statistics).  ``core/autosearch.py``
collapses ``op_costs`` into the Figure-4 op classes it schedules, and
``launch/plan.py`` prints a plan from them.

The hardware table reproduces the paper's Table 1 (GPUs) and keeps the JAX
package's TPU v5e entry.  Every entry is a data-sheet constant of the model
(peak FLOP/s, memory bandwidth and size, interconnect), not a measurement:
no TPU number here was measured.  ``H100`` is the card the port runs on;
``chip_smoke.py``'s planner phase prints its entry beside the card's
measured times.  Host arithmetic only: no tensor is touched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ATTN, ModelConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    compute: float          # FLOP/s (peak, serving dtype)
    mem_bw: float           # B/s
    mem_size: float         # B per chip
    net_bw: float           # B/s per chip (interconnect, one-way)
    year: int = 0

    @property
    def ratio(self) -> float:
        """FLOP per byte of HBM — paper Table 1 last column (~250 modern)."""
        return self.compute / self.mem_bw

    @property
    def net_bw_oneway(self) -> float:
        """Paper Table-2 footnote: one-way bandwidth for T_net."""
        return self.net_bw / 2


TB, GB = 1e12, 1e9

HARDWARE: dict[str, Hardware] = {h.name: h for h in [
    Hardware("V100", 125e12, 900 * GB, 32 * GB, 300 * GB, 2017),
    Hardware("A100-40G", 312e12, 1555 * GB, 40 * GB, 600 * GB, 2020),
    Hardware("A100-80G", 312e12, 2000 * GB, 80 * GB, 600 * GB, 2021),
    Hardware("H100", 989e12, 3352 * GB, 80 * GB, 600 * GB, 2023),
    Hardware("H200", 989e12, 4800 * GB, 141 * GB, 900 * GB, 2024),
    Hardware("B100", 1800e12, 8000 * GB, 192 * GB, 1800 * GB, 2024),
    Hardware("B200", 2250e12, 8000 * GB, 192 * GB, 1800 * GB, 2024),
    Hardware("MI250", 362e12, 3352 * GB, 128 * GB, 800 * GB, 2021),
    Hardware("MI300", 1307e12, 5300 * GB, 192 * GB, 1024 * GB, 2023),
    # The JAX package's target, as data-sheet constants (197 TF bf16, 819
    # GB/s HBM, ~50 GB/s/link ICI one-way => 100 GB/s bidirectional here),
    # not measurements.
    Hardware("TPUv5e", 197e12, 819 * GB, 16 * GB, 100 * GB, 2023),
]}

TPU_V5E = HARDWARE["TPUv5e"]
A100_80G = HARDWARE["A100-80G"]
H100 = HARDWARE["H100"]


@dataclasses.dataclass(frozen=True)
class Workload:
    """User query statistics (paper §3.1): avg prompt / decode lengths."""
    p: float
    d: float
    name: str = ""


# paper's evaluation workloads (Table 3)
WORKLOADS = {
    "splitwise": Workload(1155, 211, "splitwise"),
    "lmsys": Workload(102, 222, "lmsys"),
    "sharegpt": Workload(246, 322, "sharegpt"),
    "const_512_1024": Workload(512, 1024, "const_512_1024"),
    "const_1024_512": Workload(1024, 512, "const_1024_512"),
}


@dataclasses.dataclass(frozen=True)
class ModelStats:
    """The model-side quantities the paper's equations consume."""
    p_model: int             # total params
    p_active: int            # active params / token (MoE)
    d_model: int
    n_layers: int
    r_gqa: float             # q heads per kv head
    kv_per_token: int        # KV-cache elements per token (all layers)
    dtype_bytes: int = 2
    # bytes per stored KV element (DESIGN.md §15).  Equals ``dtype_bytes``
    # for native caches; for int8 it is <~1.1: one byte per element plus the
    # amortized f32 per-(row, kv-head) scale overhead.  Weight/activation
    # terms keep using ``dtype_bytes`` — only the cache residency (e_kv) and
    # the KV streaming terms (DecodeAttention, prefill KV write) see it.
    kv_bytes_per_elem: float = 0.0

    def __post_init__(self):
        if self.kv_bytes_per_elem == 0.0:
            object.__setattr__(self, "kv_bytes_per_elem",
                               float(self.dtype_bytes))


def model_stats(cfg: ModelConfig,
                kv_dtype: Optional[str] = None) -> ModelStats:
    """``kv_dtype`` mirrors ``EngineConfig.kv_dtype``: None/"bf16" keeps the
    serving dtype for the cache; "int8" prices the quantized layout —
    1 B/element plus one f32 scale per (row, kv-head) for GQA or per row
    (latent + rope leaves) for absorbed MLA."""
    from repro_torch.models.model import active_params, num_params
    kv_elems = 0
    kv_bytes = 0.0
    hd = cfg.resolved_head_dim
    for spec in cfg.layer_specs():
        if spec.mixer == ATTN:
            if cfg.mla is not None:
                e = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
                s = 2                       # c_kv + k_rope scale rows
            else:
                e = 2 * cfg.n_kv_heads * hd
                s = 2 * cfg.n_kv_heads      # k + v scale per kv head
            kv_elems += e
            kv_bytes += e * 1 + s * 4       # int8 pricing (scales are f32)
        # recurrent mixers hold O(1) state — no per-token KV
    dt = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    return ModelStats(
        p_model=num_params(cfg),
        p_active=active_params(cfg),
        d_model=cfg.d_model,
        n_layers=cfg.n_layers,
        r_gqa=cfg.n_heads / max(cfg.n_kv_heads, 1),
        kv_per_token=kv_elems,
        dtype_bytes=dt,
        kv_bytes_per_elem=(kv_bytes / kv_elems
                           if kv_dtype == "int8" and kv_elems else float(dt)),
    )


# ---------------------------------------------------------------------------
# Eqs. 1–9
# ---------------------------------------------------------------------------
def e_kv(hw: Hardware, ms: ModelStats, n_dev: int) -> float:
    """Max KV-cache elements the cluster can hold (Appendix A).

    Weights stay at ``dtype_bytes``; the leftover bytes are divided by the
    cache's *storage* rate (``kv_bytes_per_elem``), so an int8 cache holds
    ~2x the elements at the same residency (DESIGN.md §15)."""
    free = n_dev * hw.mem_size - ms.p_model * ms.dtype_bytes
    return max(free / ms.kv_bytes_per_elem, 0.0)


def b_req(hw: Hardware, ms: ModelStats, w: Workload, n_dev: int) -> float:
    """Eq. 5 — largest request batch the KV capacity sustains."""
    if ms.kv_per_token == 0:
        # attention-free: state is O(1); batch bounded by activations — use a
        # large nominal cap so dense batch is compute-limited instead.
        return 4096.0
    per_req = (w.p + w.d / 2) * ms.kv_per_token
    return e_kv(hw, ms, n_dev) / per_req


def b_dense(hw: Hardware, ms: ModelStats, w: Workload, n_dev: int) -> float:
    """Eq. 2 — average dense-op token batch per iteration."""
    return b_req(hw, ms, w, n_dev) * (w.p + w.d) / (w.d + 1)


def t_mem(hw: Hardware) -> float:
    """Eq. 1 — whole-device-memory sweep per iteration."""
    return hw.mem_size / hw.mem_bw


def t_compute(hw: Hardware, ms: ModelStats, w: Workload, n_dev: int,
              bdense: Optional[float] = None) -> float:
    """Eq. 3/4/6 — dense-GEMM-dominated compute time per iteration."""
    bd = bdense if bdense is not None else b_dense(hw, ms, w, n_dev)
    return 2 * bd * ms.p_active / (n_dev * hw.compute)


def t_net(hw: Hardware, ms: ModelStats, w: Workload, n_dev: int,
          bdense: Optional[float] = None) -> float:
    """Eq. 7 — two AllGathers + one AllReduce of the dense activations."""
    bd = bdense if bdense is not None else b_dense(hw, ms, w, n_dev)
    total = 4 * bd * ms.d_model * ms.dtype_bytes * ms.n_layers
    return total / (n_dev * hw.net_bw)


def t_r(hw: Hardware, ms: ModelStats, w: Workload, n_dev: int) -> float:
    """Eq. 8 — memory/compute time ratio.  >1 memory-bound, <1 compute-bound."""
    return t_mem(hw) / t_compute(hw, ms, w, n_dev)


def classify(hw: Hardware, ms: ModelStats, w: Workload, n_dev: int) -> str:
    tr = t_r(hw, ms, w, n_dev)
    tn = t_net(hw, ms, w, n_dev) / t_compute(hw, ms, w, n_dev)
    if tn > 1 and tn > tr:
        return "network-bound"
    return "memory-bound" if tr > 1 else "compute-bound"


def optimal_throughput(hw: Hardware, ms: ModelStats, n_dev: int) -> float:
    """Eq. 9 — tokens/s at full compute utilization (total, prefill+decode).

    Depends only on aggregate compute and (active) parameter count."""
    return n_dev * hw.compute / (2 * ms.p_active)


# ---------------------------------------------------------------------------
# Table 2: per-operation resource usage for one iteration
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class OpCost:
    name: str
    kind: str                # compute | memory | network
    flops: float
    mem_bytes: float
    net_bytes: float

    def times(self, hw: Hardware, n_dev: int) -> tuple[float, float, float]:
        # T_net uses one-way bandwidth (paper Table-2 footnote 5)
        return (self.flops / (n_dev * hw.compute),
                self.mem_bytes / (n_dev * hw.mem_bw),
                self.net_bytes / (n_dev * hw.net_bw_oneway))

    def bound(self, hw: Hardware, n_dev: int) -> str:
        tc, tm, tn = self.times(hw, n_dev)
        return ("compute", "memory", "network")[max(range(3), key=lambda i: (tc, tm, tn)[i])]


def op_costs(cfg: ModelConfig, w: Workload, hw: Hardware, n_dev: int,
             bdense: Optional[float] = None,
             kv_dtype: Optional[str] = None) -> list[OpCost]:
    """NanoFlow Table-2-style per-op breakdown, generalized over configs.

    All quantities are *global* (whole iteration across all layers / devices);
    divide by n_dev for per-device.  Decode attention loads the entire KV
    cache once (paper's model); prefill attention is quadratic in p.
    ``kv_dtype="int8"`` prices the quantized cache (DESIGN.md §15): more
    resident elements at fewer bytes each, so DecodeAttention streams the
    bigger cache at the int8 rate and prefill's KV writes shrink.
    """
    ms = model_stats(cfg, kv_dtype)
    dt = ms.dtype_bytes
    bd = bdense if bdense is not None else b_dense(hw, ms, w, n_dev)
    breq = b_req(hw, ms, w, n_dev)
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.resolved_head_dim
    nh, kv = cfg.n_heads, cfg.n_kv_heads

    costs: list[OpCost] = []

    def gemm(name, n_in, n_out, count=1.0, batch=None):
        b = bd if batch is None else batch
        w_bytes = n_in * n_out * dt * count
        costs.append(OpCost(
            name, "compute",
            flops=2 * b * n_in * n_out * count * L,
            mem_bytes=(w_bytes + b * (n_in + n_out) * dt * count) * L,
            net_bytes=0.0))

    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        gemm("GEMM-Q(lora)", d, m.q_lora_rank)
        gemm("GEMM-Q(up)", m.q_lora_rank, nh * qk)
        gemm("GEMM-KV(lora)", d, m.kv_lora_rank + m.qk_rope_dim)
        gemm("GEMM-KV(up)", m.kv_lora_rank, nh * (m.qk_nope_dim + m.v_head_dim))
        gemm("GEMM-O", nh * m.v_head_dim, d)
    else:
        gemm("GEMM-KQV", d, (nh + 2 * kv) * hd)
        gemm("GEMM-O", nh * hd, d)

    if cfg.moe is not None:
        mo = cfg.moe
        n_moe = sum(1 for s in cfg.layer_specs() if "moe" in s.ffn)
        n_dense = sum(1 for s in cfg.layer_specs() if s.ffn == "dense"
                      or s.ffn == "moe+dense")
        if n_dense:
            ug = 2 * bd * d * (2 * cfg.d_ff) * n_dense
            dn = 2 * bd * d * cfg.d_ff * n_dense
            costs.append(OpCost("GEMM-UG(dense)", "compute", ug,
                                (2 * d * cfg.d_ff * dt + bd * (d + 2 * cfg.d_ff) * dt) * n_dense, 0))
            costs.append(OpCost("GEMM-D(dense)", "compute", dn,
                                (d * cfg.d_ff * dt + bd * (cfg.d_ff + d) * dt) * n_dense, 0))
        # routed experts: top_k active per token; weights for *all* experts
        # stream from HBM only insofar as tokens hit them — at large batch all
        # experts are hit, so weight bytes = full expert set.
        eff = mo.expert_d_ff
        act_flops = 2 * bd * mo.top_k * d * 3 * eff * n_moe
        w_bytes = mo.num_experts * 3 * d * eff * dt * n_moe
        costs.append(OpCost("MoE-experts", "compute", act_flops,
                            w_bytes + bd * mo.top_k * (2 * d + 3 * eff) * dt * n_moe, 0))
        if mo.num_shared_experts:
            sh = mo.shared_d_ff
            costs.append(OpCost("MoE-shared", "compute",
                                2 * bd * d * 3 * sh * n_moe,
                                (3 * d * sh * dt + bd * (2 * d + 3 * sh) * dt) * n_moe, 0))
        costs.append(OpCost("MoE-router", "compute",
                            2 * bd * d * mo.num_experts * n_moe,
                            (d * mo.num_experts * dt + bd * d * dt) * n_moe, 0))
        # EP all-to-all: tokens leave/return to their home shard
        a2a = 2 * bd * mo.top_k * d * dt * n_moe
        costs.append(OpCost("MoE-AllToAll", "network", 0, a2a, a2a))
    elif cfg.d_ff:
        gemm("GEMM-UG", d, (2 if cfg.ffn_gated else 1) * cfg.d_ff)
        gemm("GEMM-D", cfg.d_ff, d)

    # ---- attention ----
    if ms.kv_per_token:
        # decode attention: stream the whole KV cache (memory-bound GEMV).
        # Bytes use the cache *storage* rate — int8 streams ~2x the elements
        # at ~half the bytes each, so the byte term is ~unchanged while the
        # resident batch (b_req) doubles (DESIGN.md §15).
        kv_bytes = e_kv(hw, ms, n_dev) * ms.kv_bytes_per_elem
        dec_flops = 2 * e_kv(hw, ms, n_dev) * ms.r_gqa
        costs.append(OpCost("DecodeAttention", "memory", dec_flops, kv_bytes, 0))
        # prefill attention: (B_req/(d+1)) requests of p tokens, 4·p²·D per layer
        n_prefill = breq / (w.d + 1)
        pf_flops = 4 * n_prefill * w.p * w.p * d * L
        pf_bytes = n_prefill * w.p * (
            2 * (ms.kv_per_token / L) * ms.kv_bytes_per_elem
            + 2 * nh * hd * dt) * L
        costs.append(OpCost("PrefillAttention", "compute", pf_flops, pf_bytes, 0))
    else:
        # recurrent mixers: state update streams the state per token
        costs.append(OpCost("RecurrentScan", "memory",
                            2 * bd * d * 32 * L, bd * d * 32 * dt * L, 0))

    # ---- TP collectives: 2 AG + 1 AR of the dense activations (paper §2.3).
    # Wire bytes include the (N-1)/N ring amplification so the Table-2 row
    # reproduces the paper's 75.2 GB for LLaMA-2-70B @ B_dense=2048, TP=8.
    act = bd * d * dt * L
    costs.append(OpCost("Comm-AG1", "network", 0, act,
                        act * (n_dev - 1) if n_dev > 1 else 0))
    costs.append(OpCost("Comm-AG2", "network", 0, act,
                        act * (n_dev - 1) if n_dev > 1 else 0))
    costs.append(OpCost("Comm-AR", "network",
                        (n_dev - 1) * bd * d * L, 2 * act,
                        2 * act * (n_dev - 1) if n_dev > 1 else 0))
    return costs


def table2(cfg: ModelConfig, w: Workload, hw: Hardware, n_dev: int,
           bdense: Optional[float] = None,
           kv_dtype: Optional[str] = None) -> list[dict]:
    """Paper Table 2 rows: per-op estimated times + the dominant resource."""
    rows = []
    for c in op_costs(cfg, w, hw, n_dev, bdense, kv_dtype):
        tc, tm, tn = c.times(hw, n_dev)
        rows.append({
            "op": c.name, "kind": c.kind,
            "gflops": c.flops / 1e9, "mem_gb": c.mem_bytes / 1e9,
            "net_gb": c.net_bytes / 1e9,
            "t_compute_ms": tc * 1e3, "t_mem_ms": tm * 1e3, "t_net_ms": tn * 1e3,
            "bound": c.bound(hw, n_dev),
        })
    return rows

"""Whether the xLSTM packed step's conv formula is what parts its bf16
logits from the prefill's.

A step convolves its window as one einsum; a prefill as K shifted
multiply-adds in the model dtype.  The probe teacher-forces one seeded
token stream through ``forward_packed`` (the packed step's formulas) and
``forward_full`` (the prefill's) on scaled-down xLSTM-1.3B in bf16 and
prints their largest logit gap and argmax agreement, then again with the
step's conv computed as the prefill computes it.  If the second gap is 0,
the conv is the only formula the two paths do not share.

    python3 tools/xlstm_conv_probe.py      (CPU; --device cuda on a card)
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import scale_down  # noqa: E402
from repro_torch.models import layers, model, xlstm  # noqa: E402


def conv_step_as_prefill(x_t, conv_state, w, b):
    """``layers.causal_conv1d_step`` with ``layers.causal_conv1d``'s
    formula: K shifted multiply-adds accumulated in x's dtype."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)
    out = torch.zeros_like(x_t)
    for i in range(w.shape[-1]):
        out = out + window[:, i] * w[:, i]
    if b is not None:
        out = out + b
    return out, window[:, 1:, :]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--tokens", type=int, default=300)
    args = ap.parse_args()
    dev = args.device
    cfg = dataclasses.replace(scale_down(get_config("xlstm-1.3b"),
                                         n_layers=8), dtype="bfloat16")
    params = model.init(cfg, seed=0, device=dev)
    seq = np.random.default_rng(0).integers(0, cfg.vocab_size, args.tokens)
    ids = torch.tensor(seq[None], dtype=torch.int32, device=dev)
    n = args.tokens

    def packed():
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        cache = model.init_cache(cfg, 1, 1024, device=dev)
        lg, _ = model.forward_packed(
            cfg, params, ids, cache, torch.zeros(n, dtype=torch.int32,
                                                 device=dev), pos, pos,
            torch.ones(n, dtype=torch.bool, device=dev), kv_bucket=1024,
            impl="plain")
        return lg[0].float()

    lf = model.forward_full(cfg, params, ids, impl="plain")[0][0].float()
    for what in ("as the port computes it",
                 "its step conv as shifted multiply-adds"):
        if what.startswith("its"):
            layers.causal_conv1d_step = conv_step_as_prefill
            xlstm.causal_conv1d_step = conv_step_as_prefill
        lp = packed()
        print(f"{cfg.name} bf16, {n} tokens, forward_packed {what} vs "
              f"forward_full: largest logit gap "
              f"{float((lp - lf).abs().max()):.4f}, argmax agreement "
              f"{float((lp.argmax(-1) == lf.argmax(-1)).float().mean()):.4f}")


if __name__ == "__main__":
    main()

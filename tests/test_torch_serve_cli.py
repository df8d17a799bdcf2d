"""``python -m repro_torch.launch.serve`` against ``repro.launch.serve``:
both CLIs run in-process on tiny-toy with the same argv (the port's
with ``--device cpu``), and every line that counts (requests finished,
iterations, tokens, dispatches and syncs per iteration, pad and overshoot
tokens, the batch and KV-bucket histograms, the offload line, and on the
pool path the shed and fault-tolerance counters and each replica's line)
must be equal.  Timings are left out.

The weights differ (each package draws its own from ``--seed``), which no
count line reads: the workload has no EOS, so every request runs to its
token budget.  The pool case runs at async depth 0: at depth 1 how many
tokens a killed replica had committed depends on when an iteration's
result is ready, at once on the port's CPU path and whenever XLA's CPU
thread is done in JAX.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import re
import sys

import pytest

from repro.launch import serve as jax_serve
from repro_torch.launch import serve

BASE = ["--arch", "tiny-toy", "--requests", "8"]
CASES = {"offline": BASE,
         "pool-kill": BASE + ["--replicas", "2", "--fault-plan", "kill@3:r1",
                              "--async-depth", "0"]}
# timings inside a counted line, and the throughput line (a rate and the
# device's label)
_TIMED = (r"blocked \d+ ms, host \d+ ms, dispatch \d+ ms \(wall \d+ ms\)",
          r"in \d+ ms \([\d.]+ tok/s[^)]*\)", r"throughput .*")


def _count_lines(out: str) -> list[str]:
    lines = []
    for line in out.splitlines():
        for pat in _TIMED:
            line = re.sub(pat, "", line)
        # which syncs blocked is timing; the syncs are counted
        line = re.sub(r"\d+/(\d+) blocking syncs \([\d.]+/iter\)",
                      r"\1 syncs", line)
        lines.append(line.rstrip())
    return lines


def _run_jax(argv, capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_count_lines_match_jax(case, capsys, monkeypatch):
    argv = CASES[case]
    want = _count_lines(_run_jax(argv, capsys, monkeypatch))
    serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    got = _count_lines(out)
    assert got == want
    if case == "offline":
        assert "finished 8/8 requests" in out
        assert "1.00 dispatches/iter, 1.00 host syncs/iter" in out
        assert "(on cpu)" in out
    else:
        assert "finished 8/8 requests, 0 shed" in out
        assert "1 faults injected" in out
        assert "r1 [dead]" in out


def test_cli_refuses_what_the_port_refuses():
    """tp > 1 serves the offline batch on one engine (a pool of tp > 1
    replicas and online arrivals are not ported); the JAX attention
    variants are refused."""
    with pytest.raises(ValueError, match="--tp"):
        serve.main(BASE + ["--tp", "2", "--replicas", "2", "--device",
                           "cpu"])
    with pytest.raises(ValueError, match="--tp"):
        serve.main(BASE + ["--tp", "2", "--online", "--device", "cpu"])
    with pytest.raises(ValueError):
        serve.main(BASE + ["--attn-fast", "--device", "cpu"])


def test_cli_flags_are_jax_flags():
    """The port's CLI takes the JAX CLI's flags with the same
    defaults, plus ``--device``."""
    import argparse

    from repro.serving.config import EngineConfig as JaxEngineConfig
    from repro.serving.config import PoolConfig as JaxPoolConfig
    from repro_torch.serving.config import EngineConfig, PoolConfig

    def flags(engine, pool):
        ap = argparse.ArgumentParser()
        engine.add_args(ap)
        pool.add_args(ap)
        return {a.dest: (a.default, a.option_strings) for a in ap._actions}
    assert flags(EngineConfig, PoolConfig) == flags(JaxEngineConfig,
                                                    JaxPoolConfig)

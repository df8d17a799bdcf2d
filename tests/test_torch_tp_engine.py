"""Tensor-parallel packed serving (DESIGN.md §11): the port at tp = 2 over
two gloo ranks against the JAX engine at tp = 1, case by case after
``tests/test_tp_engine.py``.

The port at tp = 2 must be f32 token-exact against the JAX engine at
tp = 1 on the same (converted) weights: the four mixer families
(tiny-toy's GQA, DeepSeek-V2's MLA + MoE, xLSTM's mLSTM + sLSTM, Jamba's
Mamba + attention + MoE; MoE at capacity factor 16, so that routing
cannot differ at capacity edges) at async depths 0 and 1, prefix caching,
speculative decoding at depths 0 and 1, and int8 KV on tiny-toy and
DeepSeek-V2.  Each iteration stays one dispatch and one sync, the
modeled collective bytes equal JAX's model times the launched tokens,
and both ranks serve the same tokens through the same plans.  The JAX
side runs here; every port case runs inside one spawned pair of ranks,
which is started once for the file.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.distributed import tp as jax_tp
from repro.models import model as jax_model
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import get_config, scale_down
from repro_torch.launch import mesh, serve
from repro_torch.models import model
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine

import _torch_tp_ranks

FAMILIES = ["tiny-toy", "deepseek-v2-236b", "xlstm-1.3b",
            "jamba-1.5-large-398b"]
SIZES = (16, 8)
TP = 2
# bf16 tokens of the CLI at tp 2 vs tp 1, the bound chip_smoke.py holds a
# bf16 serve to against a teacher-forced forward (SERVE_AGREE_MIN)
CLI_AGREE_MIN = 0.9
BASE = dict(max_slots=2, max_len=48, discrete_sizes=SIZES,
            avg_decode_len=4.0)


def _cfgs(name):
    """(JAX config, port config): f32, MoE dropless."""
    if name == "tiny-toy":
        pair = (jax_get_config(name), get_config(name))
    else:
        pair = (jax_scale_down(jax_get_config(name)),
                scale_down(get_config(name)))
    out = []
    for cfg in pair:
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=16.0))
        out.append(dataclasses.replace(cfg, dtype="float32"))
    return out


def _mixed(vocab, seed):
    """test_tp_engine.py's workload: prompts long enough to chunk and short
    ones that decode while others prefill, through slot reuse."""
    rng = np.random.default_rng(seed)
    return [[(i, [int(t) for t in rng.integers(0, vocab, size=n)], 4)
             for i, n in enumerate([3, 11, 5, 9, 4])]]


def _prefix_waves():
    base = list(range(11, 21))
    return [[(0, base + [30], 6)], [(i, base + [30 + i], 6) for i in (1, 2)]]


def _spec_waves():
    motif = [5, 9, 3, 7]
    return [[(i, list(p), 8) for i, p in enumerate(
        [motif * 5, ([2, 4] * 6)[:11], motif * 3])]]


def _jax_run(cfg, params, waves, **kw):
    eng = JaxServeEngine(cfg, params, JaxEngineConfig(**kw))
    out = {}
    for wave in waves:
        for rid, prompt, n in wave:
            eng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        for r in eng.run():
            out[r.rid] = tuple(r.output)
    return eng, out


@pytest.fixture(scope="module")
def runs():
    """JAX at tp = 1 here, every port case at tp = 2 in one spawned pair,
    which serves while the JAX engines run here."""
    cases, jax_jobs = [], {}
    models = {}
    for name in FAMILIES:
        jcfg, tcfg = _cfgs(name)
        jp = jax_model.init(jcfg, jax.random.PRNGKey(0))
        models[name] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp))
    for name in FAMILIES:
        jcfg, tcfg, jp, npp = models[name]
        waves = _mixed(jcfg.vocab_size, 7)
        jax_jobs[name] = (jcfg, jp, waves, dict(async_depth=0, **BASE))
        for depth in (0, 1):
            cases.append((f"{name}/{depth}", tcfg, npp,
                          dict(BASE, tp=TP, async_depth=depth), waves))
    jcfg, tcfg, jp, npp = models["tiny-toy"]
    cases.append(("late", tcfg, npp,
                  dict(BASE, tp=TP, async_depth=1, async_harvest=True,
                       late_rank=1), _mixed(jcfg.vocab_size, 7)))
    prefix = dict(BASE, kv_block_size=8)
    jax_jobs["prefix"] = (jcfg, jp, _prefix_waves(),
                          dict(prefix_caching=True, **prefix))
    for on in (False, True):
        cases.append((f"prefix/{on}", tcfg, npp,
                      dict(prefix, tp=TP, prefix_caching=on),
                      _prefix_waves()))
    spec = dict(BASE, max_len=64, async_harvest=False)
    jax_jobs["spec/base"] = (jcfg, jp, _spec_waves(),
                             dict(async_depth=0, **spec))
    for depth in (0, 1):
        jax_jobs[f"spec/{depth}"] = (jcfg, jp, _spec_waves(),
                                     dict(async_depth=depth, spec_k=3,
                                          **spec))
        cases.append((f"spec/{depth}", tcfg, npp,
                      dict(spec, tp=TP, async_depth=depth, spec_k=3),
                      _spec_waves()))
    for name in ("tiny-toy", "deepseek-v2-236b"):
        jcfg, tcfg, jp, npp = models[name]
        waves = _mixed(jcfg.vocab_size, 1)
        jax_jobs[f"int8/{name}"] = (jcfg, jp, waves,
                                    dict(kv_dtype="int8", **BASE))
        cases.append((f"int8/{name}", tcfg, npp,
                      dict(BASE, tp=TP, kv_dtype="int8"), waves))
    wrong = dataclasses.replace(scale_down(get_config("qwen3-8b")),
                                dtype="float32")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mesh.spawn_tp, TP, _torch_tp_ranks.serve_cases,
                            cases, wrong, device="cpu", timeout_s=300)
        jax_out = {key: _jax_run(cfg, params, waves, **kw)
                   for key, (cfg, params, waves, kw) in jax_jobs.items()}
        port = ranks.result()
    return models, jax_out, port


def _check_invariants(res):
    st = res["stats"]
    assert st["dispatches_per_iter"] == 1.0
    assert st["syncs_per_iter"] == 1.0
    assert res["ranks_agree"]


def _launched(st):
    """Tokens launched at spec_k 0: every real token and the padding."""
    return st["prefill_model_tokens"] + st["decode_tokens"] \
        + st["packed_pad_tokens"]


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("name", FAMILIES)
def test_tp2_token_exact_vs_jax_tp1(runs, name, depth):
    models, jax_out, port = runs
    jcfg = models[name][0]
    res = port[f"{name}/{depth}"]
    assert len(res["outputs"]) == 5
    assert res["outputs"] == jax_out[name][1], (name, depth)
    _check_invariants(res)
    st = res["stats"]
    assert st["tp_collective_bytes"] == _launched(st) * \
        jax_tp.collective_bytes_per_iter(jcfg, 1, TP, 4) > 0
    # the same iterations as the JAX engine, the same padding
    jst = jax_out[name][0].stats
    assert st["iterations"] == jst.iterations
    assert st["packed_pad_tokens"] == jst.packed_pad_tokens


def test_tp2_harvest_agreed_when_a_rank_lags(runs):
    """At async depth 1 with harvesting on, rank 1 sees its newest payload
    land only one iteration later than rank 0 does.  The ranks retire the
    least of their ready counts, so they still plan alike and serve JAX's
    tokens.  Retiring by each rank's own count would commit a finished
    request on rank 0 first: the ranks would plan apart, and their
    collectives would no longer match."""
    _, jax_out, port = runs
    res = port["late"]
    assert res["outputs"] == jax_out["tiny-toy"][1]
    _check_invariants(res)
    lagged = [r["stats"]["blocking_syncs"] for r in res["ranks"]]
    assert lagged[1] > lagged[0] == 0


def test_tp2_shards_widths(runs):
    """The ranks hold their shards: half the heads and FFN columns (GQA),
    half the experts and MLA heads, the latent cache whole."""
    _, _, port = runs
    toy = port["tiny-toy/0"]
    cfg = get_config("tiny-toy")
    assert toy["shapes"]["mixer/wq"][1] == cfg.n_heads // TP
    assert toy["shapes"]["ffn/w_gate"][1] == cfg.d_ff // TP
    assert toy["cache_shapes"]["k"][2] == cfg.n_kv_heads // TP
    ds = port["deepseek-v2-236b/0"]
    dcfg = scale_down(get_config("deepseek-v2-236b"))
    assert ds["shapes"]["mixer/wuq"][1] == dcfg.n_heads // TP
    assert ds["cache_shapes"]["c_kv"][2] == dcfg.mla.kv_lora_rank


def test_tp2_prefix_caching_token_exact(runs):
    """Block ids index the rank-local (head-sharded, slot·seq-replicated)
    cache alike on every rank: shared-prefix serving at tp = 2 equals the
    run without sharing and JAX's tp = 1 run with it."""
    _, jax_out, port = runs
    off, on = port["prefix/False"], port["prefix/True"]
    assert on["outputs"] == off["outputs"] == jax_out["prefix"][1]
    assert on["kv"]["prefix_hit_tokens"] == 20       # 2 requests x 10
    assert on["kv"]["cow_copies"] == 2
    _check_invariants(on)


@pytest.mark.parametrize("depth", [0, 1])
def test_tp2_spec_decode_token_exact(runs, depth):
    """Speculative decoding at tp = 2 equals JAX's plain engine, and
    accepts what JAX's tp = 1 speculation accepts."""
    _, jax_out, port = runs
    res = port[f"spec/{depth}"]
    assert res["outputs"] == jax_out["spec/base"][1]
    jst = jax_out[f"spec/{depth}"][0].stats
    assert res["stats"]["spec_verify_segments"] > 0
    assert res["stats"]["spec_accepted_tokens"] == jst.spec_accepted_tokens
    _check_invariants(res)


@pytest.mark.parametrize("name", ["tiny-toy", "deepseek-v2-236b"])
def test_tp2_int8_kv_token_exact(runs, name):
    """int8 KV at tp = 2 equals JAX's int8 engine at tp = 1: GQA's values
    and scales on the rank's kv heads, MLA's latent and its scales whole."""
    _, jax_out, port = runs
    res = port[f"int8/{name}"]
    assert res["outputs"] == jax_out[f"int8/{name}"][1]
    assert res["stats"]["kv_quant_bytes_saved"] > 0
    _check_invariants(res)
    shapes = res["cache_shapes"]
    if name == "tiny-toy":
        assert shapes["k_s"][2] == get_config(name).n_kv_heads // TP
    else:
        assert shapes["c_kv_s"] == shapes["c_kv"][:2]


def test_tp_errors():
    """No group: RuntimeError; the legacy step at tp 2: ValueError;
    widths that cannot shard: ValueError naming them, before any group is
    looked for."""
    cfg = dataclasses.replace(get_config("tiny-toy"), dtype="float32")
    params = model.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        ServeEngine(cfg, params, EngineConfig(tp=2), device="cpu")
    with pytest.raises(ValueError, match="packed step"):
        EngineConfig(tp=2, step_mode="legacy")
    bad = dataclasses.replace(cfg, n_heads=3, n_kv_heads=3, head_dim=64)
    with pytest.raises(ValueError, match="n_heads"):
        ServeEngine(bad, params, EngineConfig(tp=2), device="cpu")


def test_tp_wrong_world_size_raises(runs):
    """An engine at tp 4 inside a group of 2 ranks raises RuntimeError."""
    _, _, port = runs
    assert "process group of 4 ranks" in port["wrong_world"]


def _agreement(a: dict, b: dict) -> float:
    """Share of the tokens that agree before each request's first
    difference."""
    same = total = 0
    for rid, toks in a.items():
        for x, y in zip(toks, b[rid]):
            if x != y:
                break
            same += 1
        total += len(toks)
    return same / total


def test_cli_tp2_matches_tp1(capfd):
    """``--tp 2 --device cpu`` serves the CLI's workload on two ranks:
    the same count lines as ``--tp 1``, the tp line with JAX's collective
    model, and the same tokens up to bf16 near-ties (the CLI's weights
    are bf16, and tp = 2 sums the row-parallel partials in another order;
    f32 is token-exact, above): every first token, and at least
    ``CLI_AGREE_MIN`` of all tokens before each request's first
    difference."""
    argv = ["--arch", "tiny-toy", "--requests", "8", "--device", "cpu"]
    one = serve.main(argv)
    out_one = capfd.readouterr().out
    two = serve.main(argv + ["--tp", "2"])
    out_two = capfd.readouterr().out
    assert set(two) == set(one) and len(two) == 8
    assert all(two[rid][0] == one[rid][0] for rid in one)
    assert _agreement(one, two) >= CLI_AGREE_MIN
    lines = [ln for ln in out_two.splitlines() if ln.startswith("tp=2: ")]
    assert len(lines) == 1 and "modeled collective traffic/iter" in lines[0]
    keep = ("finished", "tokens:", "dense batch", "kv bucket")
    assert [ln for ln in out_two.splitlines() if ln.startswith(keep)] == \
        [ln for ln in out_one.splitlines() if ln.startswith(keep)]

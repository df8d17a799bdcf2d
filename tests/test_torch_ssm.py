"""The port's selective scan and Mamba mixer against the JAX package, on
the CPU.

On the CPU ``ops.ssm_scan`` runs its plain version, so these hold
``ssm_scan_ref`` against ``repro.kernels.ref.ssm_scan_ref`` and the Pallas
kernel in interpret mode, on the same numpy-seeded inputs, and the conv
helpers and ``mamba_full`` / ``mamba_decode`` / ``mamba_packed`` against
their JAX functions on the same weights.  ``test_torch_cuda.py`` holds the
CUDA kernel against the plain version on the card.

Tolerances: the scan in f32 at rtol/atol 1e-5 (the packages sum the N
states in different orders); with bf16 x, b and c, y at one output
rounding (|a - b| <= 1e-3 + 1e-2·|ref|: a bf16 step is at most 2^-7 of
the value) and h_final, which stays f32, at 1e-5; the mixers in f32 at
atol 1e-4, as the other model-level tests of the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.kernels import ref as jax_ref
from repro.kernels import ssm_scan as jax_ss
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro.models.param import init_params as jax_init_params
from repro_torch.configs import get_config, scale_down
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssm_scan_ref, ssm_step_ref
from repro_torch.models import layers, ssm

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-3)
ATOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _scan_case(seed, bsz, s, ch, n=16, h0=True):
    """x, dt > 0, a < 0, b, c, d and (optionally) h0 as f32 numpy arrays,
    at the magnitudes of a Mamba layer (dt around softplus of small
    values, a = -(1..N))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, ch)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-2.0, 1.0, (bsz, s, ch)))).astype(
        np.float32)
    a = -np.exp(rng.uniform(0.0, np.log(n), (ch, n))).astype(np.float32)
    b = rng.normal(size=(bsz, s, n)).astype(np.float32)
    c = rng.normal(size=(bsz, s, n)).astype(np.float32)
    d = rng.normal(size=(ch,)).astype(np.float32)
    h = rng.normal(size=(bsz, ch, n)).astype(np.float32) if h0 else None
    return x, dt, a, b, c, d, h


def _jax_args(case, dtype):
    x, dt, a, b, c, d, h = case
    md = JNP[dtype]
    return (jnp.asarray(x, md), jnp.asarray(dt), jnp.asarray(a),
            jnp.asarray(b, md), jnp.asarray(c, md), jnp.asarray(d),
            None if h is None else jnp.asarray(h))


def _torch_args(case, dtype):
    x, dt, a, b, c, d, h = case
    md = TORCH[dtype]
    return (torch.from_numpy(x).to(md), torch.from_numpy(dt),
            torch.from_numpy(a), torch.from_numpy(b).to(md),
            torch.from_numpy(c).to(md), torch.from_numpy(d),
            None if h is None else torch.from_numpy(h))


def _check_scan(got, want, dtype):
    (ty, th), (jy, jh) = got, want
    assert ty.dtype == TORCH[dtype] and th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    np.testing.assert_allclose(_np(th), _np(jh), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("s", [1, 5, 37])
def test_ssm_scan_ref_matches_jax(s, h0, dtype):
    """Two batch rows, 70 channels (a ragged edge for the kernel's 64
    channels per block), N 16: the port's wrapper on the CPU against the
    JAX ref and the Pallas kernel in interpret mode."""
    case = _scan_case(s, 2, s, 70, h0=h0)
    targs = _torch_args(case, dtype)
    got = ops.ssm_scan(*targs)
    _check_scan(got, jax_ref.ssm_scan_ref(*_jax_args(case, dtype)), dtype)
    _check_scan(got, jax_ss.ssm_scan(*_jax_args(case, dtype),
                                     interpret=True), dtype)
    _check_scan(got, ssm_scan_ref(*targs), dtype)


def test_ssm_scan_ref_matches_pallas_ragged_block():
    """520 channels: the Pallas kernel's 512-channel block leaves a ragged
    second block, which it pads; the port's version is held to it."""
    case = _scan_case(9, 1, 5, 520)
    _check_scan(ssm_scan_ref(*_torch_args(case, "float32")),
                jax_ss.ssm_scan(*_jax_args(case, "float32"), interpret=True),
                "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_step_chained_equals_scan(dtype):
    """``ssm_step_ref`` applied token by token gives the scan's y and
    final state."""
    x, dt, a, b, c, d, h = _torch_args(_scan_case(4, 2, 9, 24), dtype)
    want_y, want_h = ssm_scan_ref(x, dt, a, b, c, d, h)
    ys = []
    for t in range(x.shape[1]):
        y_t, h = ssm_step_ref(x[:, t], dt[:, t], a, b[:, t], c[:, t], d, h)
        ys.append(y_t)
    torch.testing.assert_close(torch.stack(ys, 1), want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)


def test_ssm_scan_of_nothing_returns_the_state():
    x, dt, a, b, c, d, h = _torch_args(_scan_case(2, 2, 0, 8), "float32")
    y, hf = ssm_scan_ref(x, dt, a, b, c, d, h)
    assert y.shape == (2, 0, 8) and torch.equal(hf, h)


# ---------------------------------------------------------------------------
# the conv helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 2, 3, 7])
def test_conv_helpers_match_jax(s):
    """``causal_conv1d`` over S tokens, ``causal_conv1d_step`` from a
    random history, and ``conv_tail`` of (history ++ chunk) for chunks
    shorter than, equal to and longer than d_conv - 1 = 3, and of a chunk
    alone (left-zero-padded)."""
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    hist = rng.normal(size=(2, 3, 6)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, w=w, b=bias, h=hist).items()}
    np.testing.assert_allclose(
        layers.causal_conv1d(t["x"], t["w"], t["b"]).numpy(),
        np.asarray(jax_layers.causal_conv1d(x, w, bias)), atol=1e-6)
    np.testing.assert_allclose(
        layers.causal_conv1d(t["x"], t["w"], None).numpy(),
        np.asarray(jax_layers.causal_conv1d(x, w, None)), atol=1e-6)
    out, state = layers.causal_conv1d_step(t["x"][:, 0], t["h"], t["w"],
                                           t["b"])
    jout, jstate = jax_layers.causal_conv1d_step(x[:, 0], hist, w, bias)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    ext = np.concatenate([hist, x], axis=1)
    np.testing.assert_array_equal(
        layers.conv_tail(torch.from_numpy(ext), 3).numpy(),
        np.asarray(jax_layers.conv_tail(ext, 3)))
    np.testing.assert_array_equal(
        layers.conv_tail(t["x"], 3).numpy(),
        np.asarray(jax_layers.conv_tail(x, 3)))


# ---------------------------------------------------------------------------
# the Mamba mixer
# ---------------------------------------------------------------------------
def _mixer():
    """Jamba's Mamba mixer at scaled-down width (d_model 128, d_in 256,
    dt_rank 8, N 16, d_conv 4), f32, with the JAX init's weights."""
    jcfg = dataclasses.replace(
        jax_scale_down(jax_get_config("jamba-1.5-large-398b")),
        dtype="float32")
    tcfg = dataclasses.replace(
        scale_down(get_config("jamba-1.5-large-398b")), dtype="float32")
    jp = jax_init_params(jax_ssm.mamba_defs(jcfg, 1), jax.random.PRNGKey(3))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert set(tp) == set(ssm.mamba_defs(tcfg))
    return jcfg, tcfg, jp, tp


def _state(rng, bsz, tcfg):
    d_in, _, n = ssm._dims(tcfg)
    k = tcfg.mamba.d_conv - 1
    return {"conv": rng.normal(size=(bsz, k, d_in)).astype(np.float32),
            "ssm": rng.normal(size=(bsz, d_in, n)).astype(np.float32)}


def _close_state(got, want):
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("s", [2, 9])
@pytest.mark.parametrize("initial", [False, True], ids=["fresh", "carried"])
def test_mamba_full_matches_jax(initial, s):
    """Outputs and returned states, from zero state and from a carried
    state; 2 tokens is a chunk shorter than d_conv - 1."""
    jcfg, tcfg, jp, tp = _mixer()
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, tcfg.d_model)).astype(np.float32)
    init = _state(rng, 2, tcfg) if initial else None
    jout, jst = jax_ssm.mamba_full(
        jcfg, jp, jnp.asarray(x), return_state=True,
        initial=None if init is None else jax.tree.map(jnp.asarray, init))
    tout, tst = ssm.mamba_full(
        tcfg, tp, torch.from_numpy(x), return_state=True,
        initial=None if init is None else
        {k: torch.from_numpy(v) for k, v in init.items()})
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    _close_state(tst, jst)
    assert torch.equal(ssm.mamba_full(
        tcfg, tp, torch.from_numpy(x),
        initial=None if init is None else
        {k: torch.from_numpy(v) for k, v in init.items()}), tout)


def test_mamba_decode_matches_jax():
    """Three decode steps of 3 rows from a random state."""
    jcfg, tcfg, jp, tp = _mixer()
    rng = np.random.default_rng(5)
    st = _state(rng, 3, tcfg)
    jst = jax.tree.map(jnp.asarray, st)
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    for _ in range(3):
        x = rng.normal(size=(3, 1, tcfg.d_model)).astype(np.float32)
        jout, jst = jax_ssm.mamba_decode(jcfg, jp, jnp.asarray(x), jst)
        before = {k: v.clone() for k, v in tst.items()}
        tout, new = ssm.mamba_decode(tcfg, tp, torch.from_numpy(x), tst)
        assert all(torch.equal(tst[k], before[k]) for k in tst)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=ATOL)
        _close_state(new, jst)
        tst = new


def test_mamba_packed_matches_jax():
    """A packed stream over 4 slots of random state: a 3-token chunk of
    slot 2, a decode token of slot 0, a 4-token chunk of slot 3 and two
    padding tokens (slot 0, inactive), which must leave slot 0 as its
    decode token left it; slot 1 is untouched."""
    jcfg, tcfg, jp, tp = _mixer()
    rng = np.random.default_rng(11)
    st = _state(rng, 4, tcfg)
    slot = np.asarray([2, 2, 2, 0, 3, 3, 3, 3, 0, 0], np.int32)
    active = np.asarray([1] * 8 + [0, 0], bool)
    x = rng.normal(size=(1, len(slot), tcfg.d_model)).astype(np.float32)
    jout, jst = jax_ssm.mamba_packed(jcfg, jp, jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, st),
                                     jnp.asarray(slot), jnp.asarray(active))
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    tout, tst = ssm.mamba_packed(tcfg, tp, torch.from_numpy(x), tst,
                                 torch.from_numpy(slot),
                                 torch.from_numpy(active))
    np.testing.assert_allclose(tout[0, :8].numpy(), np.asarray(jout)[0, :8],
                               rtol=0, atol=ATOL)
    _close_state(tst, jst)
    for name in ("conv", "ssm"):
        np.testing.assert_array_equal(tst[name][1].numpy(), st[name][1])

"""The port's attention (models/attention.py) against a naive softmax and
against the JAX package's flash_attention, forward and gradients.

Twin of tests/test_attention.py: causal, windowed, windowed with sink
positions, non-causal, GQA, a distinct v-dim, ragged lengths,
`causal_skip`, one query chunk (`q_chunk=0`, the reference's "qfull"),
position offsets, the decode step (a ring-buffer window too) and the
fully masked chunk. Inputs are drawn with numpy from a seed; the naive
reference is float64 numpy for the forward and torch autograd through a
float64 softmax for the gradients, and each option is held to the JAX
package's flash_attention / decode_attention on the same inputs.
Bounds: the reference tests' 2e-5 (1e-6 between two chunkings of the
port, as the reference's; `causal_skip` is bit-identical).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models.attention import (NEG_INF, _attn_chunk_step,
                                          decode_attention, flash_attention)

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)


def _mask(sq, sk, causal, window, n_sink=0):
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        in_w = kpos > qpos - window
        if n_sink:
            in_w |= kpos < n_sink
        mask &= in_w
    return mask


def naive(q, k, v, *, causal=True, window=0, n_sink=0):
    """tests/test_attention.py's naive softmax, in float64 numpy."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    s = np.einsum("bqkgd,bskd->bkgqs", q.reshape(b, sq, kv, h // kv, dh),
                  k) * dh**-0.5
    s = np.where(_mask(sq, k.shape[1], causal, window, n_sink), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
    out = np.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, sq, h, v.shape[-1])


def naive_torch(q, k, v, *, causal=True, window=0):
    """The same naive softmax in torch float64, for autograd."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     q.double().reshape(b, sq, kv, h // kv, dh),
                     k.double()) * dh**-0.5
    mask = torch.from_numpy(_mask(sq, k.shape[1], causal, window))
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.double())
    return out.reshape(b, sq, h, v.shape[-1])


def make(b=2, sq=64, sk=64, h=4, kv=2, dh=16, dv=None, seed=7):
    rng = np.random.default_rng(seed)
    dv = dv or dh
    return (rng.normal(size=(b, sq, h, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kv, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kv, dv)).astype(np.float32))


def _flash(q, k, v, **kw):
    return flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                           **kw).numpy()


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_causal_matches_naive(chunk):
    q, k, v = make()
    np.testing.assert_allclose(_flash(q, k, v, causal=True, chunk=chunk),
                               naive(q, k, v), **TOL)


def test_gqa_and_vdim():
    q, k, v = make(h=8, kv=2, dh=24, dv=16)
    np.testing.assert_allclose(_flash(q, k, v, causal=True, chunk=16),
                               naive(q, k, v), **TOL)


def test_window():
    q, k, v = make(sq=96, sk=96)
    np.testing.assert_allclose(
        _flash(q, k, v, causal=True, window=24, chunk=16),
        naive(q, k, v, window=24), **TOL)


def test_noncausal_cross():
    q, k, v = make(sq=48, sk=80)
    np.testing.assert_allclose(_flash(q, k, v, causal=False, chunk=16),
                               naive(q, k, v, causal=False), **TOL)


@pytest.mark.parametrize("sq", [3, 17, 33, 50])
def test_ragged_lengths(sq):
    q, k, v = make(sq=sq, sk=sq)
    np.testing.assert_allclose(_flash(q, k, v, causal=True, chunk=16),
                               naive(q, k, v), **TOL)


def test_ragged_noncausal():
    q, k, v = make(sq=10, sk=37)
    np.testing.assert_allclose(_flash(q, k, v, causal=False, chunk=16),
                               naive(q, k, v, causal=False), **TOL)


def test_decode_matches_last_row():
    q, k, v = make(sq=32, sk=32)
    full = _flash(q, k, v, causal=True, chunk=16)
    out = decode_attention(torch.from_numpy(q[:, -1:]), torch.from_numpy(k),
                           torch.from_numpy(v), cache_len=32).numpy()
    np.testing.assert_allclose(out[:, 0], full[:, -1], **TOL)


def test_grad_finite():
    q, k, v = (torch.from_numpy(t).requires_grad_(True)
               for t in make(sq=32, sk=32))
    flash_attention(q, k, v, causal=True, chunk=8).square().sum().backward()
    for t in (q, k, v):
        assert bool(torch.isfinite(t.grad).all())


# name: (make() arguments, flash_attention arguments)
GRAD_CASES = {
    "causal": (dict(sq=32, sk=32), dict(causal=True, chunk=8)),
    "window": (dict(sq=48, sk=48), dict(causal=True, window=12, chunk=16)),
    "gqa_vdim": (dict(h=8, kv=2, dh=24, dv=16, sq=32, sk=32),
                 dict(causal=True, chunk=16)),
    "ragged": (dict(sq=17, sk=17), dict(causal=True, chunk=8)),
    "cross": (dict(sq=10, sk=37), dict(causal=False, chunk=16)),
}


def _grads(fn, q, k, v, w):
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = fn(*ts)
    (out * torch.from_numpy(w).to(out.dtype)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_gradients_match_naive_and_jax(name):
    """The online softmax's gradients, through autograd of the chunked
    loops, against autograd of the naive softmax and jax.grad of the
    reference's flash_attention, for a random cotangent."""
    shape, kw = GRAD_CASES[name]
    q, k, v = make(**shape)
    w = np.random.default_rng(8).normal(
        size=q.shape[:3] + (v.shape[-1],)).astype(np.float32)
    got = _grads(lambda *t: flash_attention(*t, **kw), q, k, v, w)
    naive_kw = {key: kw[key] for key in ("causal", "window") if key in kw}
    want = _grads(lambda *t: naive_torch(*t, **naive_kw), q, k, v, w)
    jgrads = jax.grad(
        lambda *t: jnp.sum(jattn.flash_attention(*t, **kw) * w),
        argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    for g, ng, jg in zip(got, want, jgrads):
        np.testing.assert_allclose(g, ng, **TOL)
        np.testing.assert_allclose(g, np.asarray(jg), **TOL)


def test_forward_matches_jax():
    q, k, v = make(h=8, kv=2, sq=40, sk=40)
    for kw in (dict(causal=True, chunk=16), dict(causal=True, window=8,
                                                  chunk=16)):
        want = jattn.flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                     **kw)
        np.testing.assert_allclose(_flash(q, k, v, **kw), np.asarray(want),
                                   **TOL)


def test_additive_bias_fully_masked_chunk_is_zero():
    """A chunk whose every key is masked (a strictly-future kv chunk)
    leaves acc/l at 0 and produces no NaN, in value and in gradient."""
    rng = np.random.default_rng(9)
    b, cq, ck, kv, g, dh = 1, 4, 4, 1, 2, 8
    q = torch.from_numpy(rng.normal(size=(b, cq, kv, g, dh)).astype(
        np.float32)).requires_grad_(True)
    k = torch.from_numpy(rng.normal(size=(b, ck, kv, dh)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, ck, kv, dh)).astype(np.float32))
    acc = torch.zeros((b, kv, g, cq, dh))
    m = torch.full((b, kv, g, cq), NEG_INF)
    l = torch.zeros((b, kv, g, cq))
    acc2, m2, l2 = _attn_chunk_step(acc, m, l, q, k, v, torch.arange(4),
                                    torch.arange(100, 104), causal=True,
                                    window=0, scale=1.0)
    assert not bool(torch.isnan(acc2).any())
    assert bool((acc2 == 0).all()) and bool((l2 == 0).all())
    (acc2.sum() + l2.sum()).backward()
    assert bool(torch.isfinite(q.grad).all())


def test_window_and_sink():
    q, k, v = make(sq=96, sk=96)
    np.testing.assert_allclose(
        _flash(q, k, v, causal=True, window=24, chunk=16, n_sink=4),
        naive(q, k, v, window=24, n_sink=4), **TOL)


def test_causal_skip_identical():
    q, k, v = make(sq=64, sk=64)
    base = _flash(q, k, v, causal=True, chunk=16)
    skip = _flash(q, k, v, causal=True, chunk=16, causal_skip=True)
    assert np.array_equal(base, skip)


@pytest.mark.parametrize("window", [0, 24])
def test_qfull_mode_matches_naive(window):
    """q_chunk=0 (one query chunk) against the naive softmax and the
    chunked grid."""
    q, k, v = make(sq=50, sk=50)
    out = _flash(q, k, v, causal=True, window=window, chunk=16, q_chunk=0)
    np.testing.assert_allclose(out, naive(q, k, v, window=window), **TOL)
    grid = _flash(q, k, v, causal=True, window=window, chunk=16)
    np.testing.assert_allclose(out, grid, rtol=1e-6, atol=1e-6)


def test_qfull_with_sink_tokens():
    q, k, v = make(sq=64, sk=64)
    out = _flash(q, k, v, causal=True, window=24, n_sink=8, chunk=16,
                 q_chunk=0)
    np.testing.assert_allclose(out, naive(q, k, v, window=24, n_sink=8),
                               **TOL)


def test_window_of_zero_or_less_is_full_attention():
    q, k, v = make(sq=40, sk=40)
    full = _flash(q, k, v, causal=True, chunk=16)
    for window in (0, -1):
        assert np.array_equal(_flash(q, k, v, causal=True, window=window,
                                     chunk=16, n_sink=4), full)


# name: (make() arguments, flash_attention arguments), each against the
# reference's flash_attention on the same inputs
JAX_CASES = {
    "window_and_sink": (dict(sq=96, sk=96),
                        dict(causal=True, window=24, chunk=16, n_sink=4)),
    "noncausal_cross": (dict(sq=48, sk=80), dict(causal=False, chunk=16)),
    "ragged_17": (dict(sq=17, sk=17), dict(causal=True, chunk=16)),
    "ragged_50": (dict(sq=50, sk=50), dict(causal=True, chunk=16)),
    "ragged_noncausal": (dict(sq=10, sk=37), dict(causal=False, chunk=16)),
    "causal_skip": (dict(sq=64, sk=64),
                    dict(causal=True, chunk=16, causal_skip=True)),
    "causal_skip_ragged": (dict(sq=50, sk=50),
                           dict(causal=True, chunk=16, causal_skip=True)),
    "qfull": (dict(sq=50, sk=50), dict(causal=True, chunk=16, q_chunk=0)),
    "qfull_window": (dict(sq=50, sk=50),
                     dict(causal=True, window=24, chunk=16, q_chunk=0)),
    "qfull_sink": (dict(sq=64, sk=64), dict(causal=True, window=24,
                                            n_sink=8, chunk=16, q_chunk=0)),
    "q_chunk_8": (dict(sq=40, sk=40), dict(causal=True, chunk=16,
                                           q_chunk=8)),
    "offsets": (dict(sq=16, sk=48), dict(causal=True, chunk=16,
                                         q_offset=32, k_offset=0)),
    "offsets_window": (dict(sq=20, sk=52),
                       dict(causal=True, window=12, chunk=16, q_offset=32,
                            k_offset=0)),
    "gqa_vdim": (dict(h=8, kv=2, dh=24, dv=16, sq=33, sk=33),
                 dict(causal=True, chunk=16)),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_options_match_jax(name):
    shape, kw = JAX_CASES[name]
    q, k, v = make(**shape)
    want = jattn.flash_attention(*(jnp.asarray(t) for t in (q, k, v)), **kw)
    np.testing.assert_allclose(_flash(q, k, v, **kw), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("cache_len,window", [(32, 0), (20, 0), (32, 16),
                                              (12, 16)])
def test_decode_matches_jax(cache_len, window):
    """decode_attention against the reference's, a ring-buffer window
    (every slot valid once the ring is full) too."""
    q, k, v = make(sq=32, sk=32)
    want = jattn.decode_attention(
        jnp.asarray(q[:, -1:]), jnp.asarray(k), jnp.asarray(v),
        cache_len=jnp.int32(cache_len), window=window)
    got = decode_attention(torch.from_numpy(q[:, -1:]), torch.from_numpy(k),
                           torch.from_numpy(v), cache_len=cache_len,
                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sink_gradients_match_jax():
    q, k, v = make(sq=40, sk=40)
    kw = dict(causal=True, window=12, n_sink=4, chunk=16, q_chunk=0)
    w = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    got = _grads(lambda *t: flash_attention(*t, **kw), q, k, v, w)
    jgrads = jax.grad(
        lambda *t: jnp.sum(jattn.flash_attention(*t, **kw) * w),
        argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    for g, jg in zip(got, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), **TOL)

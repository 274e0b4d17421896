"""The port's gated-linear-attention engine (models/ssm.py) against the
JAX package's: tests/test_ssm.py's three properties on the port (the
chunked form equals the stepwise form, the conv's segment invariance,
the state decay bound), and each function held to the reference on the
same inputs, drawn with numpy from a seed.

Bounds: the reference tests' own (2e-4 chunked against stepwise, 1e-5
for the conv); float32 against JAX, the same math summed in another
order, within 2e-5 (2e-4 for the normalized chunked form over 70 steps,
whose denominators amplify the order's rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models.ssm import causal_conv1d, gla_chunked, gla_step

hp = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

torch.set_num_threads(2)


def _inputs(seed, b, h, t, dk, dv):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, h, t, dk)).astype(f),
            rng.normal(size=(b, h, t, dk)).astype(f),
            rng.normal(size=(b, h, t, dv)).astype(f),
            (-np.abs(rng.normal(size=(b, h, t)))).astype(f),
            (-np.abs(rng.normal(size=(b, h, t)))).astype(f))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _stepwise(q, k, v, a, b, normalize):
    bsz, h, t, dk = q.shape
    state = (torch.zeros((bsz, h, dk, v.shape[-1])), torch.zeros((bsz, h, dk)))
    ys = []
    for i in range(t):
        y, state = gla_step(q[:, :, i], k[:, :, i], v[:, :, i], a[:, :, i],
                            b[:, :, i], state, normalize=normalize)
        ys.append(y)
    return torch.stack(ys, dim=2), state


@hp.given(
    t=st.integers(1, 70),
    chunk=st.sampled_from([4, 8, 16, 32]),
    dk=st.sampled_from([4, 8]),
    dv=st.sampled_from([4, 16]),
    normalize=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
@hp.settings(max_examples=30, deadline=None)
def test_chunked_equals_stepwise(t, chunk, dk, dv, normalize, seed):
    q, k, v, a, b = _t(*_inputs(seed, 2, 3, t, dk, dv))
    y_chunk, (s_f, n_f) = gla_chunked(q, k, v, a, b, chunk=chunk,
                                      normalize=normalize)
    y_seq, (s_seq, n_seq) = _stepwise(q, k, v, a, b, normalize)
    np.testing.assert_allclose(y_chunk.numpy(), y_seq.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(s_f.numpy(), s_seq.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(n_f.numpy(), n_seq.numpy(), rtol=2e-4,
                               atol=2e-4)


@hp.given(
    t=st.integers(1, 50),
    split=st.integers(0, 50),
    kk=st.sampled_from([2, 4]),
    seed=st.integers(0, 2**31 - 1),
)
@hp.settings(max_examples=20, deadline=None)
def test_conv_segment_invariance(t, split, kk, seed):
    split = min(split, t)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, t, 5)).astype(np.float32))
    kern = torch.from_numpy(rng.normal(size=(kk, 5)).astype(np.float32))
    full, _ = causal_conv1d(x, kern)
    y1, st1 = causal_conv1d(x[:, :split], kern)
    y2, _ = causal_conv1d(x[:, split:], kern, state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(),
                               full.numpy(), rtol=1e-5, atol=1e-5)


def test_state_decay_bound():
    """With all-zero input gates the state never grows (stability)."""
    q, k, v, _, _ = _t(*_inputs(0, 1, 1, 100, 4, 4))
    a = torch.full((1, 1, 100), -0.1)
    b = torch.full((1, 1, 100), -1e30)  # no input
    y, (s, n) = gla_chunked(q, k, v, a, b, chunk=16)
    assert float(s.abs().max()) == 0.0 and float(n.abs().max()) == 0.0
    assert float(y.abs().max()) == 0.0


# (seed, t, chunk, dk, dv, normalize): ragged tails, one chunk, many
CASES = [(1, 70, 16, 8, 16, True), (2, 33, 8, 4, 4, False),
         (3, 16, 16, 8, 4, True), (4, 5, 32, 4, 16, False),
         (5, 64, 16, 16, 16, False)]


@pytest.mark.parametrize("seed,t,chunk,dk,dv,normalize", CASES)
def test_gla_chunked_matches_jax(seed, t, chunk, dk, dv, normalize):
    arrs = _inputs(seed, 2, 3, t, dk, dv)
    init = (np.random.default_rng(seed + 100).normal(
        size=(2, 3, dk, dv)).astype(np.float32) * 0.1,
        np.abs(np.random.default_rng(seed + 200).normal(
            size=(2, 3, dk))).astype(np.float32))
    jy, (js, jn) = jssm.gla_chunked(*map(jnp.asarray, arrs), chunk=chunk,
                                    normalize=normalize,
                                    initial_state=tuple(map(jnp.asarray,
                                                            init)))
    ty, (ts, tn) = gla_chunked(*_t(*arrs), chunk=chunk, normalize=normalize,
                               initial_state=tuple(_t(*init)))
    tol = 2e-4 if normalize else 2e-5
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_gla_step_matches_jax(normalize):
    q, k, v, a, b = (x[:, :, 0] for x in _inputs(7, 2, 3, 1, 8, 16))
    rng = np.random.default_rng(8)
    state = (rng.normal(size=(2, 3, 8, 16)).astype(np.float32),
             rng.normal(size=(2, 3, 8)).astype(np.float32))
    jy, (js, jn) = jssm.gla_step(*map(jnp.asarray, (q, k, v, a, b)),
                                 tuple(map(jnp.asarray, state)),
                                 normalize=normalize)
    ty, (ts, tn) = gla_step(*_t(q, k, v, a, b), tuple(_t(*state)),
                            normalize=normalize)
    for got, want in ((ty, jy), (ts, js), (tn, jn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("t,kk,with_state", [(9, 4, False), (9, 4, True),
                                            (1, 4, True), (6, 2, False)])
def test_causal_conv1d_matches_jax(t, kk, with_state):
    rng = np.random.default_rng(t * 10 + kk)
    x = rng.normal(size=(2, t, 5)).astype(np.float32)
    kern = rng.normal(size=(kk, 5)).astype(np.float32)
    state = rng.normal(size=(2, kk - 1, 5)).astype(np.float32) \
        if with_state else None
    jy, jst = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(kern),
                                 state=None if state is None
                                 else jnp.asarray(state))
    ty, tst = causal_conv1d(torch.from_numpy(x), torch.from_numpy(kern),
                            state=None if state is None
                            else torch.from_numpy(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_chunked_gradients_match_jax():
    """Gradients through the chunk loop (recomputed in the backward pass)
    against jax.grad of the reference's chunked form."""
    import jax

    arrs = _inputs(11, 1, 2, 21, 4, 8)
    w = np.random.default_rng(12).normal(size=(1, 2, 21, 8)).astype(
        np.float32)

    def jf(*xs):
        return jnp.sum(jssm.gla_chunked(*xs, chunk=8, normalize=True)[0] * w)

    jg = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in arrs]
    y, _ = gla_chunked(*ts, chunk=8, normalize=True)
    (y * torch.from_numpy(w)).sum().backward()
    for t_, g in zip(ts, jg):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(g), rtol=2e-4,
                                   atol=2e-4)


def test_long_chunk_gate_gradients_are_finite():
    """ROADMAP.md §3 fault 7: over a chunk longer than ~128 steps of a
    decay near hymba's (-0.7 a step), the reference's decay tile
    overflows above its diagonal and its gate gradients are NaN; the
    port masks the exponent first, so its gradients are finite and equal
    those of short chunks (the same math), the reference's included."""
    import jax

    t = 200
    q, k, v, _, _ = _inputs(13, 1, 2, t, 4, 4)
    a = np.full((1, 2, t), -0.7, np.float32)
    b = np.full((1, 2, t), -0.7, np.float32)

    def jgrads(chunk):
        return jax.grad(lambda *xs: jnp.sum(jssm.gla_chunked(
            *xs, chunk=chunk)[0]), argnums=(0, 1, 2, 3, 4))(
            *map(jnp.asarray, (q, k, v, a, b)))

    def tgrads(chunk):
        ts = [torch.from_numpy(x).requires_grad_(True)
              for x in (q, k, v, a, b)]
        gla_chunked(*ts, chunk=chunk)[0].sum().backward()
        return [t_.grad.numpy() for t_ in ts]

    assert np.isnan(np.asarray(jgrads(256)[3])).any()  # the fault
    short = jgrads(16)
    for got, want in zip(tgrads(256), short):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4)

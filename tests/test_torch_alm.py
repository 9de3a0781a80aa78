"""ops/alm of the port against the JAX package on the same inputs.

Integers (lmax, index tables) equal; float64 results within 1e-13 of the
largest |value| (the same sums in another order); synalm from the same
normals within 1e-12 relative in float64, 1e-6 in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orphics_tpu.ops import alm as jalm
from orphics_tpu_torch.ops import alm as talm

torch.set_num_threads(1)

LMAX = 31


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def alms():
    rng = np.random.default_rng(0)
    n = talm.nalm(LMAX)
    a = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    return a


@pytest.mark.parametrize("lmax", [0, 1, 7, 32])
def test_index_tables(lmax):
    assert talm.nalm(lmax) == jalm.nalm(lmax)
    assert talm.getlmax(talm.nalm(lmax)) == lmax
    for t, j in zip(talm.lm_indices(lmax), jalm.lm_indices(lmax)):
        np.testing.assert_array_equal(t, np.asarray(j))
    with pytest.raises(ValueError):
        talm.getlmax(talm.nalm(lmax) + 1)


def test_almxfl_alm2cl(alms):
    fl = np.linspace(1.0, 0.1, LMAX - 3)          # shorter than lmax + 1
    ref = jalm.almxfl(jnp.asarray(alms), jnp.asarray(fl))
    got = talm.almxfl(torch.as_tensor(alms), fl)
    assert _rel(got, ref) <= 1e-13
    ref = jalm.alm2cl(jnp.asarray(alms[0]), jnp.asarray(alms[1]))
    got = talm.alm2cl(torch.as_tensor(alms[0]), torch.as_tensor(alms[1]))
    assert _rel(got, ref) <= 1e-13
    ref = jalm.alm2cl(jnp.asarray(alms))                 # stacked auto
    got = talm.alm2cl(torch.as_tensor(alms))
    assert got.shape == (3, LMAX + 1) and _rel(got, ref) <= 1e-13


@pytest.mark.parametrize("lmax_new", [20, 31, 40])
def test_change_alm_lmax(alms, lmax_new):
    ref = jalm.change_alm_lmax(alms, lmax_new)
    got = talm.change_alm_lmax(torch.as_tensor(alms), lmax_new)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_synalm_from_noise(dtype):
    """Both packages turn the same normals into the same alms (the JAX
    draw is reproduced from its own key's normals)."""
    cl = 1.0 / (np.arange(LMAX + 1) + 10.0) ** 2
    key = jax.random.PRNGKey(3)
    jdt = jnp.complex128 if dtype == "float64" else jnp.complex64
    ref = jalm.synalm(key, jnp.asarray(cl, dtype), lmax=LMAX, dtype=jdt)
    kr, ki = jax.random.split(key)
    n = talm.nalm(LMAX)
    re = np.asarray(jax.random.normal(kr, (n,)))
    im = np.asarray(jax.random.normal(ki, (n,)))
    got = talm.synalm_from_noise(torch.as_tensor(re).to(getattr(torch,
                                                                dtype)),
                                 torch.as_tensor(im).to(getattr(torch,
                                                                dtype)),
                                 cl, LMAX)
    assert _rel(got, ref) <= (1e-12 if dtype == "float64" else 1e-6)
    ms = talm.lm_indices(LMAX)[1]
    assert (got.imag.numpy()[ms == 0] == 0).all()


def test_synalm_generator_law():
    """The generator draw has the spectrum it was asked for."""
    cl = np.full(64, 2.0)
    gen = torch.Generator().manual_seed(5)
    a = talm.synalm(gen, cl, batch=(40,), dtype=torch.complex128,
                    device="cpu")
    got = talm.alm2cl(a).mean(0)[2:].numpy()
    assert a.shape == (40, talm.nalm(63)) and a.dtype == torch.complex128
    assert abs(got.mean() / 2.0 - 1.0) < 0.02

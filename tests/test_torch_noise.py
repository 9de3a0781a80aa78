"""models/noise of the port against the JAX package.

Deterministic functions on the same inputs: 1e-12 relative in float64,
1e-6 in float32 (the pixel-size maps are float32 on both sides). The draws
take a ``torch.Generator``: they are held to their law's parts (the JAX
per-pixel sigma, the port's own GRF times the JAX rms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import noise as JN

import orphics_tpu_torch as tp
from orphics_tpu_torch.models import grf as TG
from orphics_tpu_torch.models import noise as TN

torch.set_num_threads(1)


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


ELLS = np.arange(0, 3000, 7.0)


@pytest.mark.parametrize("lknee,alpha", [(0.0, 1.0), (3000.0, -4.0)])
def test_spectra(lknee, alpha):
    assert _rel(TN.atm_factor(ELLS, lknee, alpha, device="cpu") + 1.0,
                JN.atm_factor(ELLS, lknee, alpha) + 1.0) <= 1e-12
    assert _rel(TN.rednoise(ELLS, 10.0, lknee, alpha, device="cpu"),
                JN.rednoise(ELLS, 10.0, lknee, alpha)) <= 1e-12
    assert _rel(TN.noise_func(ELLS, 1.4, 10.0, lknee, alpha, True,
                              device="cpu"),
                JN.noise_func(ELLS, 1.4, 10.0, lknee, alpha, True)) <= 1e-12
    assert _rel(TN.white_noise_with_atm_func(ELLS, 6.0, lknee, alpha,
                                             device="cpu"),
                JN.white_noise_with_atm_func(ELLS, 6.0, lknee, alpha)) \
        <= 1e-12
    # a tensor's ells keep their device
    ells = torch.as_tensor(ELLS)
    assert _rel(TN.atm_factor(ells, lknee, alpha) + 1.0,
                JN.atm_factor(ELLS, lknee, alpha) + 1.0) <= 1e-12


def test_atmosphere():
    for b in (1.4, np.array([0.5, 1.4, 8.0])):
        for t, j in zip(TN.get_atmosphere(b), JN.get_atmosphere(b)):
            np.testing.assert_allclose(t, j, rtol=1e-14)
    fns = TN.getAtmosphere(returnFunctions=True)
    assert [f(1.4) for f in fns] == list(JN.get_atmosphere(1.4))
    assert TN.getAtmosphere(1.4) == JN.getAtmosphere(1.4)


def test_ivar_and_draws():
    jg = jgeo.rect_geometry(width_deg=4.0, px_res_arcmin=4.0, y0_deg=-40.0)
    tg = tp.rect_geometry(width_deg=4.0, px_res_arcmin=4.0, y0_deg=-40.0)
    iv = TN.ivar(tg, 10.0, device="cpu")
    assert iv.dtype == torch.float32 and _rel(iv, JN.ivar(jg, 10.0)) <= 1e-6
    ivm = iv * torch.as_tensor(np.random.default_rng(1).uniform(
        0.5, 2.0, tg.shape).astype(np.float32))
    ivm[0, :5] = 0.0
    ref = JN.rms_from_ivar(jnp.asarray(ivm.numpy()), geom=jg)
    assert _rel(TN.rms_from_ivar(ivm, geom=tg), ref) <= 1e-6
    # white noise: the JAX per-pixel sigma, drawn by the generator
    key = jax.random.PRNGKey(2)
    sig_j = np.asarray(JN.white_noise(key, jg, 10.0)) \
        / np.asarray(jax.random.normal(key, jg.shape, jnp.float32))
    got = TN.white_noise(torch.Generator().manual_seed(3), tg, 10.0,
                         device="cpu")
    z = torch.randn(tg.shape, generator=torch.Generator().manual_seed(3))
    assert _rel(got / z, sig_j) <= 1e-6
    # modulated noise: a unit-shape GRF times the rms
    got = TN.modulated_noise_map(torch.Generator().manual_seed(4), ivm, tg,
                                 lknee=2000.0, alpha=-3.0, lmax=4000)
    nl = np.nan_to_num((JN.atm_factor(np.arange(4001), 2000.0, -3.0))) + 1.0
    smap = TG.MapGen(tg, nl[None, None], device="cpu").get_map(
        torch.Generator().manual_seed(4))
    want = TN.rms_from_ivar(ivm, geom=tg) * smap * np.pi / 180.0 / 60.0
    assert got.shape == tg.shape and _rel(got, want) <= 1e-6
    # masked ivar: the ivar zeroed within 10' of its empty pixels; the JAX
    # mask growth run eagerly (see tests/test_torch_distance.py), a
    # selection of the same values, so equal
    with jax.disable_jit():
        want = np.asarray(JN.get_masked_ivar(jnp.asarray(ivm.numpy()), jg))
    got = TN.get_masked_ivar(ivm, tg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).sum() > (ivm.numpy() == 0).sum()

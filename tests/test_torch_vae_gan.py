"""The VAE and GAN confs against the JAX package, on the CPU.

- `vae_conf`: the port's copy builds the JAX package's conf; on the same
  numpy parameters and feed (images in [0, 1], eps from a seed) the
  loss and every gradient equal the JAX `Network`'s within 1e-5 of
  max(1, the largest entry), at the conf's defaults and narrow.
- `gan_conf` in its three modes builds the same conf in both packages;
  the `GAN` trainer, started in both packages from one numpy parameter
  dict, gives the same losses and every parameter after one `train_d`
  and one `train_g`, under momentum and adam; the generator's
  parameters do not move in the D step, the discriminator's not in the
  G step.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import OptimizationConf as JOpt
from paddle_tpu.models import gan as jgan
from paddle_tpu.models import vae as jvae
from paddle_tpu.network import Network as JNetwork
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.config import OptimizationConf as TOpt
from paddle_tpu_torch.models import gan as tgan
from paddle_tpu_torch.models import vae as tvae
from paddle_tpu_torch.network import Network as TNetwork

TOL = 1e-5


def _close(got, want, what=""):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(
        1.0, float(np.abs(want).max())), err_msg=what)


def _same_conf(jconf, tconf):
    assert tconf.to_json() == jconf.to_json()
    assert [dataclasses.asdict(lc) for lc in tconf.layers] == [
        dataclasses.asdict(lc) for lc in jconf.layers]


@pytest.mark.parametrize("kw", [{}, dict(x_dim=12, hidden=8, latent=3)])
def test_vae_loss_and_gradients_match_jax(kw):
    jconf, tconf = jvae.vae_conf(**kw), tvae.vae_conf(**kw)
    _same_conf(jconf, tconf)
    jnet, tnet = JNetwork(jconf), TNetwork(tconf)
    params = {k: np.asarray(v) for k, v in jnet.init_params(
        jax.random.key(0)).items()}
    x_dim = jconf.layer("x").size
    latent = jconf.layer("eps").size
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (8, x_dim)).astype(np.float32)
    eps = rng.standard_normal((8, latent)).astype(np.float32)
    jfeed = {"x": jarg.non_seq(jnp.asarray(x)),
             "eps": jarg.non_seq(jnp.asarray(eps))}
    (jloss, (jouts, _)), jg = jax.value_and_grad(jnet.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jfeed)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tloss, (touts, _) = tnet.loss_fn(tp, {"x": targ.non_seq(x),
                                          "eps": targ.non_seq(eps)})
    tloss.backward()
    assert sorted(tnet.cost_names) == sorted(jnet.cost_names) == [
        "kl_cost", "recon_cost"]
    _close(tloss.detach().numpy(), jloss, "loss")
    for n in ("recon_cost", "kl_cost", "prob"):
        _close(touts[n].value.detach().numpy(), jouts[n].value, n)
    assert sorted(jg) == sorted(tp)
    for k, g in jg.items():
        _close(tp[k].grad.numpy(), g, k)


@pytest.mark.parametrize("mode", ["generator_training",
                                  "discriminator_training", "generator"])
def test_gan_conf_is_the_same(mode):
    _same_conf(jgan.gan_conf(mode), tgan.gan_conf(mode))
    _same_conf(jgan.gan_conf(mode, 4, 3, 16), tgan.gan_conf(mode, 4, 3, 16))


@pytest.mark.parametrize("method", ["momentum", "adam"])
def test_gan_steps_match_jax(method):
    kw = dict(learning_method=method, learning_rate=1e-2, momentum=0.9)
    jg = jgan.GAN(JOpt(**kw), noise_dim=10, sample_dim=2, hidden=16, seed=3)
    start = {k: np.asarray(v) for k, v in jg.params.items()}
    tg = tgan.GAN(TOpt(**kw), noise_dim=10, sample_dim=2, hidden=16,
                  params=start, device="cpu")
    rng = np.random.default_rng(4)
    real = rng.standard_normal((16, 2)).astype(np.float32)
    noise = rng.standard_normal((16, 10)).astype(np.float32)
    noise2 = rng.standard_normal((16, 10)).astype(np.float32)
    _close(tg.sample(noise).numpy(), jg.sample(jnp.asarray(noise)), "sample")

    jd = jg.train_d(jnp.asarray(real), jnp.asarray(noise), 0)
    td = tg.train_d(real, noise, 0)
    _close(np.float32(td), np.float32(jd), "d loss")
    after_d = {k: v.numpy().copy() for k, v in tg.params.items()}
    for k, v in after_d.items():
        _close(v, jg.params[k], f"after train_d: {k}")
        if k.startswith("_gen") or k.startswith("gen"):
            np.testing.assert_array_equal(v, start[k])

    jgl = jg.train_g(jnp.asarray(noise2), 0)
    tgl = tg.train_g(noise2, 0)
    _close(np.float32(tgl), np.float32(jgl), "g loss")
    for k, v in tg.params.items():
        _close(v.numpy(), jg.params[k], f"after train_g: {k}")
        if k.startswith("dis"):
            np.testing.assert_array_equal(v.numpy(), after_d[k])
    assert {k for k in start if k.startswith("gen")} and {
        k for k in start if k.startswith("dis")}

"""GAN demo (v1_api_demo/gan/gan_conf.py + gan_trainer.py):
`paddle_tpu/models/gan.py` on torch.

One config per training mode, as in the reference: the generator and
the discriminator share parameters by name across the two training
configs, and each config marks the other network's parameters
is_static, so its optimizer leaves them as they are
(`optimizers.Optimizer.update`). `GAN` keeps one parameter dict for
both phases and runs each phase's step through `parallel/dp.py::
TrainStep` (a parameter the phase's loss does not reach gets a zero
gradient, as `jax.grad` gives it). The JAX `GAN` draws its initial
parameters from `jax.random`; the port's `params=` takes a numpy dict
(the JAX names), so both packages start from the same point.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch import dsl
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.config import ModelConf, ParameterConf
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.parallel.dp import TrainStep
from paddle_tpu_torch.weights import params_from_numpy


def _p(name, static):
    return ParameterConf(name=name, is_static=static)


def _fc(x, size, act, name, pname, static):
    # the weight and the bias carry is_static: the reference freezes
    # whole layers (gan_conf.py:51-53)
    return dsl.fc(x, size=size, act=act, name=name,
                  param=_p(pname, static),
                  bias_param=_p(pname + "_b", static))


def _generator(noise, sample_dim, hidden, static):
    h = _fc(noise, hidden, "relu", "gen_h1", "gen_w1", static)
    h = _fc(h, hidden, "relu", "gen_h2", "gen_w2", static)
    return _fc(h, sample_dim, "", "gen_out", "gen_w3", static)


def _discriminator(sample, hidden, static):
    h = _fc(sample, hidden, "relu", "dis_h1", "dis_w1", static)
    h = _fc(h, hidden, "relu", "dis_h2", "dis_w2", static)
    return _fc(h, 2, "", "dis_out", "dis_w3", static)


def gan_conf(mode: str, noise_dim=10, sample_dim=2, hidden=64) -> ModelConf:
    """mode in {generator_training, discriminator_training, generator}
    (gan_conf.py:16-24)."""
    assert mode in ("generator_training", "discriminator_training",
                    "generator")
    with dsl.model() as g:
        if mode == "discriminator_training":
            sample = dsl.data("sample", sample_dim)
            label = dsl.data("label", 1, is_ids=True)
            logits = _discriminator(sample, hidden, static=False)
            dsl.classification_cost(logits, label, name="cost")
        else:
            noise = dsl.data("noise", noise_dim)
            sample = _generator(noise, sample_dim, hidden,
                                static=(mode == "generator"))
            g.conf.output_layer_names.append("gen_out")
            if mode == "generator_training":
                label = dsl.data("label", 1, is_ids=True)
                logits = _discriminator(sample, hidden, static=True)
                dsl.classification_cost(logits, label, name="cost")
    return g.conf


class GAN:
    """Alternating trainer (gan_trainer.py): a D step on real and fake
    samples, a G step through the frozen discriminator, one parameter
    dict shared by both. `params`: a numpy dict of every parameter
    (else they are drawn from `seed`); on the card unless
    `device="cpu"`."""

    def __init__(self, opt_conf, noise_dim=10, sample_dim=2, hidden=64,
                 seed=0, params=None, device=None):
        self.device = resolve_device(device)
        self.noise_dim = noise_dim
        self.g_net = Network(
            gan_conf("generator_training", noise_dim, sample_dim, hidden))
        self.d_net = Network(
            gan_conf("discriminator_training", noise_dim, sample_dim,
                     hidden))
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = {k: v.numpy() for k, v in self.g_net.init_params(
                gen, device="cpu").items()}
            params.update({k: v.numpy() for k, v in self.d_net.init_params(
                gen, device="cpu").items()})
        self.params = params_from_numpy(params, device=self.device)
        g_opt = create_optimizer(opt_conf, self.g_net.param_confs)
        d_opt = create_optimizer(opt_conf, self.d_net.param_confs)
        self._g_step = TrainStep(self.g_net, g_opt, device=self.device)
        self._d_step = TrainStep(self.d_net, d_opt, device=self.device)
        self.g_opt_state = g_opt.init_state(self.params)
        self.d_opt_state = d_opt.init_state(self.params)

    def _tensor(self, x):
        """x as a tensor on the device, in the parameters' dtype."""
        dtype = next(iter(self.params.values())).dtype
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, dtype=dtype).to(self.device)

    @torch.no_grad()
    def sample(self, noise) -> torch.Tensor:
        outs, _ = self.g_net.forward(
            self.params, {"noise": Arg(value=self._tensor(noise))},
            outputs=["gen_out"])
        return outs["gen_out"].value

    def train_d(self, real, noise, step_i) -> float:
        real = self._tensor(real)
        fake = self.sample(noise)
        n_real, n_fake = real.shape[0], fake.shape[0]
        labels = torch.cat([
            torch.ones(n_real, dtype=torch.int64, device=self.device),
            torch.zeros(n_fake, dtype=torch.int64, device=self.device)])
        feed = {"sample": Arg(value=torch.cat([real, fake])),
                "label": Arg(ids=labels)}
        self.params, self.d_opt_state, _state, loss, _outs = self._d_step(
            self.params, self.d_opt_state, {}, feed, step_i, None)
        return float(loss)

    def train_g(self, noise, step_i) -> float:
        noise = self._tensor(noise)
        # the generator wants its fakes scored as real (label 1)
        feed = {"noise": Arg(value=noise),
                "label": Arg(ids=torch.ones(noise.shape[0],
                                            dtype=torch.int64,
                                            device=self.device))}
        self.params, self.g_opt_state, _state, loss, _outs = self._g_step(
            self.params, self.g_opt_state, {}, feed, step_i, None)
        return float(loss)

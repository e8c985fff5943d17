"""VAE demo (v1_api_demo/vae/vae_conf.py).

Encoder q(z|x) -> (mu, logvar); reparameterization z = mu +
exp(0.5*logvar) * eps with eps fed as a data input (the reference feeds
its noise the same way, vae_conf.py:27-32); decoder p(x|z) with sigmoid
output; loss = binary cross-entropy reconstruction
(vae_conf.py:94-96) + 0.5 * sum(exp(logvar) + mu^2 - 1 - logvar)
(vae_conf.py:99-103), both as cost layers summed by the trainer.
"""

from __future__ import annotations

from paddle_tpu_torch import dsl
from paddle_tpu_torch.core.config import ModelConf


def vae_conf(x_dim=784, hidden=256, latent=16) -> ModelConf:
    with dsl.model() as g:
        x = dsl.data("x", x_dim)
        eps = dsl.data("eps", latent)

        # encoder
        h = dsl.fc(x, size=hidden, act="relu", name="enc_h")
        mu = dsl.fc(h, size=latent, name="mu")
        logvar = dsl.fc(h, size=latent, name="logvar")

        # z = mu + exp(0.5 * logvar) * eps
        std = dsl.addto(
            dsl.slope_intercept(logvar, slope=0.5), act="exponential",
            name="std",
        )
        z = dsl.addto(dsl.dot_mul(std, eps), mu, name="z")

        # decoder
        dh = dsl.fc(z, size=hidden, act="relu", name="dec_h")
        prob = dsl.fc(dh, size=x_dim, act="sigmoid", name="prob")
        g.conf.output_layer_names.append("prob")

        # reconstruction: elementwise binary CE against the input
        dsl.soft_binary_cross_entropy(prob, x, name="recon_cost")

        # KL(q || N(0,1)) = 0.5 * sum(exp(logvar) + mu^2 - 1 - logvar)
        exp_logvar = dsl.addto(logvar, act="exponential")
        mu_sq = dsl.addto(mu, act="square")
        neg_logvar_m1 = dsl.slope_intercept(
            logvar, slope=-1.0, intercept=-1.0
        )
        inner = dsl.addto(exp_logvar, mu_sq, neg_logvar_m1)
        dsl.sum_cost(inner, name="kl_cost", coeff=0.5)
    return g.conf

"""Tensor ops of the port: spectral norm, resampling, SA-GAN attention,
fused bias-activation, the fractional row shift and the int8 conv.

Importing the package registers the ``torch.library`` ops
``ic_gan_tpu::sagan_attention_fwd`` and ``ic_gan_tpu::bias_act_fwd``, which
a program saved by ``io/deploy.py:export_sampler`` calls."""

from ic_gan_tpu_torch.ops import attention, bias_act  # noqa: F401

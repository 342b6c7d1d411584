"""Score-distillation (SDS) guidance with an injected diffusion backbone.

Counterpart of ``samnerf_tpu/generative/stable_diffusion.py``: the
scaled-linear schedule, the SDS gradient and its surrogate loss,
classifier-free guidance, the DDIM (eta 0) loop and the VAE latent
scaling, with the UNet, VAE and text encoder passed in as callables (no
Stable Diffusion weights ship with the package; :func:`load_stable_diffusion`
says so).  Random draws come from a ``torch.Generator``;
:func:`sds_gradient` also takes the timestep and noise, so a caller can
hand it draws made elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

CONST_SCALE = 0.18215
"""Stable Diffusion's VAE latent scaling."""


def scaled_linear_alphas_cumprod(num_train_timesteps: int = 1000,
                                 beta_start: float = 0.00085, beta_end: float = 0.012,
                                 device="cuda") -> torch.Tensor:
    """alpha-bar [T] f32 of Stable Diffusion's ``scaled_linear`` betas."""
    betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                           device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def sds_gradient(denoise_fn: Callable, latents: torch.Tensor,
                 text_embedding: torch.Tensor, generator: Optional[torch.Generator],
                 alphas_cumprod: torch.Tensor,
                 t_range: Tuple[float, float] = (0.02, 0.98),
                 guidance_scale: float = 100.0,
                 t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The score-distillation gradient w(t) * (eps_pred - eps) (DreamFusion
    eq. 4) at latents [B, H, W, C].  ``denoise_fn(noisy, t, embedding)``
    predicts the noise (classifier-free guidance already combined where
    wanted).  The timestep is drawn uniformly from
    [t_range[0] T, t_range[1] T) and the noise from N(0, 1), both from
    ``generator``, unless ``t`` / ``noise`` are given."""
    num_steps = alphas_cumprod.shape[0]
    if t is None:
        t = torch.randint(int(t_range[0] * num_steps), int(t_range[1] * num_steps), (),
                          generator=generator, device=latents.device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=latents.device)
    a = alphas_cumprod[t]
    noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
    eps_pred = denoise_fn(noisy, t, text_embedding)
    return (1.0 - a) * (eps_pred - noise)


def sds_loss(denoise_fn, latents, text_embedding, generator, alphas_cumprod,
             **kw) -> torch.Tensor:
    """A scalar whose gradient with respect to ``latents`` is
    :func:`sds_gradient` (which carries no gradient itself)."""
    with torch.no_grad():
        grad = sds_gradient(denoise_fn, latents.detach(), text_embedding, generator,
                            alphas_cumprod, **kw)
    return torch.sum(latents * grad)


@dataclasses.dataclass
class StableDiffusionGuidance:
    """Stable Diffusion guidance over injected components; a method raises
    ImportError when a component it needs was not given.

    unet_fn: (latents [B, H, W, C], t, text embeddings [B, S, D]) -> noise.
    vae_encode_fn: images [B, H, W, 3] in [0, 1] -> latent mean.
    vae_decode_fn: latents -> images in [0, 1].
    text_embed_fn: list of prompts -> [B, S, D].
    """
    unet_fn: Optional[Callable] = None
    vae_encode_fn: Optional[Callable] = None
    vae_decode_fn: Optional[Callable] = None
    text_embed_fn: Optional[Callable] = None
    num_train_timesteps: int = 1000
    guidance_scale: float = 100.0
    device: str = "cuda"

    def __post_init__(self):
        self.alphas_cumprod = scaled_linear_alphas_cumprod(self.num_train_timesteps,
                                                           device=self.device)
        self.min_step = int(self.num_train_timesteps * 0.02)
        self.max_step = int(self.num_train_timesteps * 0.98)

    def _need(self, name):
        fn = getattr(self, name)
        if fn is None:
            raise ImportError(
                f"StableDiffusionGuidance.{name} was not given: no diffusion backbone "
                "ships with this package; pass a callable with the documented signature")
        return fn

    def get_text_embeds(self, prompt, negative_prompt="") -> torch.Tensor:
        """[2B, S, D]: the negative (unconditional) embeddings, then the
        prompts', the layout classifier-free guidance reads."""
        embed = self._need("text_embed_fn")
        if isinstance(prompt, str):
            prompt, negative_prompt = [prompt], [negative_prompt]
        return torch.cat([embed(negative_prompt), embed(prompt)], 0)

    def _cfg_eps(self, latents, t, text_embeddings):
        """Classifier-free guidance: eps_u + s (eps_c - eps_u)."""
        unet = self._need("unet_fn")
        eps = unet(torch.cat([latents, latents], 0), t, text_embeddings)
        eps_u, eps_c = torch.chunk(eps, 2, dim=0)
        return eps_u + self.guidance_scale * (eps_c - eps_u)

    def sds(self, text_embeddings, images, generator=None, t=None, noise=None):
        """The SDS surrogate loss of images [B, H, W, 3] through the VAE
        and the guided UNet."""
        latents = self.imgs_to_latent(images)
        return sds_loss(self._cfg_eps, latents, text_embeddings, generator,
                        self.alphas_cumprod,
                        t_range=(self.min_step / self.num_train_timesteps,
                                 self.max_step / self.num_train_timesteps),
                        guidance_scale=self.guidance_scale, t=t, noise=noise)

    def produce_latents(self, text_embeddings, height=512, width=512,
                        num_inference_steps=50, generator=None,
                        latents=None) -> torch.Tensor:
        """DDIM (eta 0) from noise (drawn from ``generator`` unless
        ``latents`` are given), guided at every step; the timesteps are
        linspace(T - 1, 0, steps) rounded half to even."""
        b = text_embeddings.shape[0] // 2
        dev = text_embeddings.device
        if latents is None:
            latents = torch.randn((b, height // 8, width // 8, 4), generator=generator,
                                  device=dev)
        ts = torch.linspace(self.num_train_timesteps - 1, 0, num_inference_steps,
                            device=dev).round().to(torch.int64)
        a_bar = self.alphas_cumprod
        z = latents
        for i in range(num_inference_steps):
            t = ts[i]
            a_t = a_bar[t]
            a_prev = (a_bar[ts[i + 1]] if i + 1 < num_inference_steps
                      else torch.ones((), device=dev))
            eps = self._cfg_eps(z, t, text_embeddings)
            x0 = (z - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
            z = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return z

    def latents_to_img(self, latents) -> torch.Tensor:
        return self._need("vae_decode_fn")(latents / CONST_SCALE)

    def imgs_to_latent(self, imgs) -> torch.Tensor:
        return self._need("vae_encode_fn")(imgs) * CONST_SCALE

    def prompt_to_img(self, prompts, negative_prompts="", height=512, width=512,
                      num_inference_steps=50, generator=None) -> torch.Tensor:
        emb = self.get_text_embeds(prompts, negative_prompts)
        lat = self.produce_latents(emb, height, width, num_inference_steps,
                                   generator=generator)
        return self.latents_to_img(lat)


def load_stable_diffusion(*args, **kwargs):
    raise ImportError(
        "Stable Diffusion weights need the `diffusers` package, which this package does "
        "not use. Construct a `StableDiffusionGuidance` with your own components "
        "(unet_fn / vae_encode_fn / vae_decode_fn / text_embed_fn).")

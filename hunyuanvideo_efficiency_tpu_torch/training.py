"""Flow-matching training steps on one device (JAX counterpart:
training.py on a (1, 1, 1) mesh).

The reference repo is inference-only, but the framework fine-tunes the DiT
with the rectified-flow objective
    x_t = (1 - sigma) * x0 + sigma * noise,   target v = noise - x0
(the inverse of the sampler's Euler update x <- x + v * dsigma).

PyTorch parameters live in the model, so the steps update it IN PLACE (the
JAX steps return a new tree): `make_train_step` is plain SGD and returns
the loss; `make_train_step_adamw` is AdamW written in optax's form with an
optional global-norm clip, an fp32 master copy when any parameter is not
fp32, and an fp32 EMA, and returns (state, loss). Blocks are checkpointed
(`remat_blocks`) to keep activation memory flat in depth. One device: no
gradient mean over a mesh.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional

import torch

from .models.dit import HYVideoDiT, patchify_raw
from .models.dit_config import DiTConfig
from .ops.quantization import TIER_OF

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adamw's defaults


def flow_match_loss(model: HYVideoDiT, x0, noise, t, pe, mask, pe2, f_cos,
                    f_sin, guidance, token_grid=None) -> torch.Tensor:
    """Rectified-flow MSE on token-form latents [B, L, C*pt*ph*pw]; t in
    [0, 1]. token_grid (T', H', W') is needed under attn_mode "sta"."""
    sigma = t[:, None, None].float()
    x_t = (1.0 - sigma) * x0.float() + sigma * noise.float()
    v_target = noise.float() - x0.float()
    v = model.forward_tokens(x_t, t * 1000.0, pe, mask, pe2, f_cos, f_sin,
                             guidance, token_grid=token_grid)
    return torch.mean((v.float() - v_target) ** 2)


def _prepare_model(model: HYVideoDiT) -> DiTConfig:
    """Checks that `model` can train and switches block checkpointing on
    (on the model and on every block, which hold the config too)."""
    for name, mod in model.named_modules():
        if type(mod) in TIER_OF:
            raise NotImplementedError(
                f"{name} holds a quantized weight tier "
                f"({type(mod).__name__}): the fp8/int8/int4 tiers are "
                f"inference only, train the bf16 or fp32 model")
    if model.cfg.attn_mode == "flash_int8":
        raise NotImplementedError(
            "attn_mode 'flash_int8' is inference only: it has no backward")
    if not any(p.requires_grad for p in model.parameters()):
        raise ValueError("no parameter of the model takes a gradient "
                         "(build_dit(..., trainable=True))")
    for m in model.modules():
        if isinstance(getattr(m, "cfg", None), DiTConfig):
            m.cfg = replace(m.cfg, remat_blocks=True)
    return model.cfg


def _loss_and_grads(model, cfg, x0, noise, t, pe, mask, pe2, f_cos_grid,
                    f_sin_grid) -> torch.Tensor:
    """Loss of one batch of 5-D latents with grid RoPE tables [T', H', W',
    D]; the gradients are left in each parameter's .grad."""
    d = f_cos_grid.shape[-1]
    guidance = (torch.full((x0.shape[0],), 1000.0, device=x0.device)
                if cfg.guidance_embed else None)
    for p in model.parameters():
        p.grad = None
    with torch.enable_grad():
        loss = flow_match_loss(
            model, patchify_raw(x0, cfg.patch_size),
            patchify_raw(noise, cfg.patch_size), t, pe, mask, pe2,
            f_cos_grid.reshape(-1, d), f_sin_grid.reshape(-1, d), guidance,
            token_grid=tuple(f_cos_grid.shape[:3]))
        loss.backward()
    return loss.detach()


def _grad(p: torch.Tensor) -> torch.Tensor:
    """fp32 gradient of p (zero when p did not reach the loss)."""
    return (p.grad.float() if p.grad is not None
            else torch.zeros_like(p, dtype=torch.float32))


def make_train_step(model: HYVideoDiT, lr: float = 1e-5):
    """SGD step (JAX `make_sp_train_step`):
    step(x0, noise, t, pe, mask, pe2, f_cos_grid, f_sin_grid) -> loss, with
    every parameter replaced in place by (p - lr * g.float()) rounded to
    p's dtype. Inputs keep the 5-D latent + grid-RoPE API."""
    cfg = _prepare_model(model)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x0, noise, t, pe, mask, pe2, f_cos_grid, f_sin_grid):
        loss = _loss_and_grads(model, cfg, x0, noise, t, pe, mask, pe2,
                               f_cos_grid, f_sin_grid)
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.copy_((p.float() - lr * p.grad.float()).to(p.dtype))
                    p.grad = None
        return loss

    return step


def make_train_step_adamw(model: HYVideoDiT, lr: float = 1e-5,
                          weight_decay: float = 1e-4,
                          grad_clip: Optional[float] = None,
                          ema_decay: Optional[float] = 0.9999):
    """AdamW step with optional EMA (JAX `make_sp_train_step_optax` with
    optax.chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay))).

    Returns (step_fn, init_fn):
      init_fn() -> state {opt_state: {mu, nu, count}, master (or None),
                          ema (or None), step}
      step_fn(state, x0, noise, t, pe, mask, pe2, f_cos_grid, f_sin_grid)
          -> (state, loss); the model and the state are updated in place.

    mu, nu, master and ema are {parameter name: fp32 tensor} dicts with the
    model's state-dict names. Mixed precision: when any parameter is not
    fp32 the state carries an fp32 MASTER copy and the optimizer runs on it
    (with lr ~1e-5 a bf16 update rounds to zero); each step re-rounds the
    master into the parameters. The update is optax's: the clip scales by
    max_norm / norm only when norm >= max_norm, the moments are
    bias-corrected (b1 0.9, b2 0.999, eps 1e-8), and the decay joins the
    update before the learning rate,
    p <- p - lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)."""
    cfg = _prepare_model(model)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}

    def init_fn() -> Dict:
        needs_master = any(p.dtype != torch.float32 for p in named.values())

        def f32():
            return {n: p.detach().float().clone() for n, p in named.items()}

        return {
            "opt_state": {
                "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in named.items()},
                "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in named.items()},
                "count": 0},
            "master": f32() if needs_master else None,
            "ema": f32() if ema_decay is not None else None,
            "step": 0,
        }

    def step(state, x0, noise, t, pe, mask, pe2, f_cos_grid, f_sin_grid):
        loss = _loss_and_grads(model, cfg, x0, noise, t, pe, mask, pe2,
                               f_cos_grid, f_sin_grid)
        opt = state["opt_state"]
        opt["count"] += 1
        c1 = 1.0 - ADAM_B1 ** opt["count"]
        c2 = 1.0 - ADAM_B2 ** opt["count"]
        with torch.no_grad():
            clip = 1.0
            if grad_clip is not None:
                norm = torch.sqrt(sum(_grad(p).square().sum()
                                      for p in named.values()))
                clip = torch.where(norm < grad_clip, torch.ones_like(norm),
                                   grad_clip / norm)
            for n, p in named.items():
                g = _grad(p) * clip
                p.grad = None
                mu, nu = opt["mu"][n], opt["nu"][n]
                mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                w = state["master"][n] if state["master"] is not None else p
                upd = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
                w.sub_(lr * (upd + weight_decay * w))
                if state["master"] is not None:
                    p.copy_(w)          # the master rounded to p's dtype
                if state["ema"] is not None:
                    state["ema"][n].mul_(ema_decay).add_(
                        w.float(), alpha=1.0 - ema_decay)
        state["step"] += 1
        return state, loss

    return step, init_fn

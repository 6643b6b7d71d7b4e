"""Flow-matching discrete Euler scheduler (JAX counterpart:
diffusion/scheduler.py; reference: hyvideo/diffusion/schedulers/
scheduling_flow_match_discrete.py:48-257).

sigmas = linspace(1, 0, N+1) with the SD3 shift
sigma' = shift*sigma / (1 + (shift-1)*sigma); timesteps = sigmas[:-1]*1000;
step x_{i+1} = x_i + v * (sigma_{i+1} - sigma_i) in fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def sd3_time_shift(t: np.ndarray, shift: float) -> np.ndarray:
    return (shift * t) / (1 + (shift - 1) * t)


def get_sigmas(num_inference_steps: int, shift: float = 1.0,
               reverse: bool = True, num_train_timesteps: int = 1000
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(sigmas [N+1], timesteps [N]), float32 numpy."""
    sigmas = np.linspace(1.0, 0.0, num_inference_steps + 1, dtype=np.float64)
    sigmas = sd3_time_shift(sigmas, shift)
    if not reverse:
        sigmas = 1.0 - sigmas
    sigmas = sigmas.astype(np.float32)
    return sigmas, (sigmas[:-1] * num_train_timesteps).astype(np.float32)


def get_linear_quadratic_sigmas(num_inference_steps: int,
                                linear_steps: Optional[int] = None,
                                num_train_timesteps: int = 1000
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """MovieGen-style linear-quadratic schedule (reference config.py:204-216
    accepts the flag)."""
    if linear_steps is None:
        linear_steps = num_inference_steps // 2
    lin = [i * 1.0 / (2 * linear_steps) for i in range(linear_steps)]
    threshold = linear_steps / (2 * num_inference_steps)
    q_steps = num_inference_steps - linear_steps
    coef = (1 - threshold) / q_steps ** 2 if q_steps else 0.0
    quad = [coef * ((i - linear_steps) ** 2) + threshold
            for i in range(linear_steps, num_inference_steps)]
    sigmas = 1.0 - np.asarray(lin + quad + [1.0], dtype=np.float32)
    return sigmas, (sigmas[:-1] * num_train_timesteps).astype(np.float32)


def euler_step(sample: torch.Tensor, model_output: torch.Tensor,
               sigma: float, sigma_next: float) -> torch.Tensor:
    """One Euler step in fp32 (reference: :236-242); the sigma difference is
    taken in fp32 too."""
    dt = float(np.float32(sigma_next) - np.float32(sigma))
    return sample.float() + model_output.float() * dt


class FlowMatchDiscreteScheduler:
    """The reference scheduler: `set_timesteps` fills `sigmas` [N+1] and
    `timesteps` [N]; the pipeline steps with `euler_step`, and `step` is the
    reference's stateful API over the same update (JAX
    diffusion/scheduler.py:106-147): a loop of `step` over `timesteps`
    equals the pipeline's Euler loop."""

    order = 1
    supported_solver = ("euler",)

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.0,
                 reverse: bool = True, solver: str = "euler",
                 n_tokens: Optional[int] = None,
                 use_linear_quadratic_schedule: bool = False,
                 linear_schedule_end: Optional[int] = None):
        if solver not in self.supported_solver:
            raise ValueError(f"Solver {solver} not supported. Supported: "
                             f"{self.supported_solver}")
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.reverse = reverse
        self.solver = solver
        self.use_linear_quadratic_schedule = use_linear_quadratic_schedule
        self.linear_schedule_end = linear_schedule_end
        sigmas = np.linspace(1, 0, num_train_timesteps + 1, dtype=np.float32)
        if not reverse:
            sigmas = sigmas[::-1].copy()
        self.sigmas = sigmas
        self.timesteps = (sigmas[:-1] * num_train_timesteps).astype(np.float32)
        self.num_inference_steps = None
        self._step_index = None

    @property
    def step_index(self) -> Optional[int]:
        return self._step_index

    def set_timesteps(self, num_inference_steps: int, device=None,
                      n_tokens: Optional[int] = None):
        """n_tokens is accepted for the reference's signature; the schedule
        does not depend on it."""
        self.num_inference_steps = num_inference_steps
        if self.use_linear_quadratic_schedule:
            self.sigmas, self.timesteps = get_linear_quadratic_sigmas(
                num_inference_steps, self.linear_schedule_end,
                self.num_train_timesteps)
        else:
            self.sigmas, self.timesteps = get_sigmas(
                num_inference_steps, self.shift, self.reverse,
                self.num_train_timesteps)
        self._step_index = None

    def scale_model_input(self, sample, timestep=None):
        return sample

    def index_for_timestep(self, timestep) -> int:
        """The exact match where one exists (the second of two, as the
        reference), else the nearest timestep: a reduced-precision scalar
        (a bf16 device value) still finds its step."""
        t = float(timestep)
        idx = np.nonzero(self.timesteps == t)[0]
        if len(idx) == 0:
            return int(np.argmin(np.abs(np.asarray(self.timesteps) - t)))
        return int(idx[1 if len(idx) > 1 else 0])

    def step(self, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, return_dict: bool = False):
        """One Euler step from `timestep`'s sigma to the next; returns
        (prev_sample,) in fp32 and advances `step_index`."""
        if self._step_index is None:
            self._step_index = self.index_for_timestep(timestep)
        prev = euler_step(sample, model_output,
                          float(self.sigmas[self._step_index]),
                          float(self.sigmas[self._step_index + 1]))
        self._step_index += 1
        return (prev,)

    def __len__(self) -> int:
        return self.num_train_timesteps

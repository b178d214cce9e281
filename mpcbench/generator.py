"""The one traffic generator: episodes of a closed loop, drawn from a seed.

A traffic mix is a JSON file under ``mpcbench/traffic/``; this module reads
its parameters and nothing else:

* ``batch``: lanes solved together at each control step;
* ``episode_steps``: control steps of an episode; an episode starts cold;
* ``start_std`` (one number or one per state) and ``start_command`` (one
  number or one per input): the pool of starts, ``batch`` states
  ``start_std * N(0, 1)`` drawn once from ``start_pool_seed``, and the last
  commands ``start_command``; every episode hands the pool's states to the
  lanes in an order drawn from the run's seed, so every seed runs the same
  set of starts and the same work;
* ``noise_std`` (one number or one per state): process noise added by the
  plant at every step, ``noise_std * N(0, 1)``, drawn from the run's seed;
* ``warmup_steps``: steps run before the window, from a seed of their own;
* ``check_lanes_per_step``: lanes of each step kept for the check of
  ``correct``, drawn from the seed;
* ``profile_steps`` and ``profile_from_episode_start``: the sub-window a
  traced run profiles after its window.

Every draw comes from a ``torch.Generator`` on the device, so one seed gives
the same episodes in every run, and different seeds give the same sizes and
the same starts in another order.
"""

from __future__ import annotations

import torch

_MIX = 6364136223846793005  # Knuth's MMIX multiplier: derived seeds
_MASK = (1 << 63) - 1


def derived_seed(seed: int, stream: int) -> int:
    """A seed of its own for ``stream`` (0 the window, 1 the warm-up, 2 the
    check's sample), for any whole ``seed``."""
    return (int(seed) * _MIX + stream * 1442695040888963407) & _MASK


def _per_dim(v, n, ref):
    t = torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
    return t.expand(n) if t.dim() == 0 else t


class Episodes:
    """Starts and noise of the episodes of one stream."""

    def __init__(self, traffic: dict, nx: int, nu: int, seed: int, stream: int,
                 dtype, device):
        self.batch = int(traffic["batch"])
        self.length = int(traffic["episode_steps"])
        self.nx, self.nu = nx, nu
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derived_seed(seed, stream))
        z = torch.zeros((), dtype=dtype, device=device)
        pool_gen = torch.Generator(device=device)
        pool_gen.manual_seed(int(traffic["start_pool_seed"]))
        self.pool = torch.randn((self.batch, nx), generator=pool_gen, dtype=dtype,
                                device=device) * _per_dim(traffic["start_std"], nx, z)
        self.start_cmd = _per_dim(traffic.get("start_command", 0.0), nu, z)
        self.noise_std = _per_dim(traffic.get("noise_std", 0.0), nx, z)
        self.noisy = bool((self.noise_std != 0).any())
        self.dtype, self.device = dtype, device

    def start(self):
        """States (B, nx) and last commands (B, nu) of a new episode."""
        x = self.pool[torch.randperm(self.batch, generator=self.gen, device=self.device)]
        u = self.start_cmd.expand(self.batch, self.nu).clone()
        return x, u

    def noise(self):
        """This step's process noise (B, nx), or None for a noise-free plant."""
        if not self.noisy:
            return None
        return torch.randn((self.batch, self.nx), generator=self.gen, dtype=self.dtype,
                           device=self.device) * self.noise_std


def sample_lanes(traffic: dict, seed: int, n_steps: int, device) -> torch.Tensor:
    """(n_steps, k) lane indices kept for the check, k lanes a step drawn
    with replacement (the caller wraps around past ``n_steps``)."""
    B, k = int(traffic["batch"]), int(traffic["check_lanes_per_step"])
    gen = torch.Generator()
    gen.manual_seed(derived_seed(seed, 2))
    return torch.randint(B, (n_steps, k), generator=gen).to(device)

"""Actor-critic networks and running normalization.

Port of `bez_isaacgym_tpu/rl/networks.py`: shared ELU MLP [400, 200, 100],
a continuous head with a state-independent log-std, a value head, running
mean/std normalization, and the recurrent variant whose cell follows flax's
`OptimizedLSTMCell`.  Weights come across from the JAX package's
checkpoints through `portbench.reference.convert`; a network built here
is initialized as flax initializes it (LeCun-normal kernels, orthogonal
recurrent kernels, zero biases and log-std), from an explicit generator.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

Tensor = torch.Tensor
F32 = torch.float32
# rl-games action-space parity (rl/ppo.py:126-132): env actions are
# ACTION_LIMIT * clip(a, -1, 1).
ACTION_LIMIT = 1.0


def init_flax_like(module: nn.Module, gen: torch.Generator) -> None:
    """LeCun-normal weights (flax's Dense default: truncated normal, std
    sqrt(1/fan_in) / .87962566) and zero biases, for every Linear; an
    LSTM cell's four recurrent kernels orthogonal, each on its own (flax's
    `recurrent_kernel_init`)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / .87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
        for m in module.modules():
            if isinstance(m, LSTMCell):
                for gate in m.hidden.weight.chunk(4, dim=0):
                    nn.init.orthogonal_(gate, generator=gen)


def _mlp(n_in: int, units: Sequence[int]) -> nn.ModuleList:
    dims = [n_in, *units]
    return nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))


def _trunk(layers: nn.ModuleList, x: Tensor) -> Tensor:
    for lin in layers:
        x = F.elu(lin(x))
    return x


class ActorCritic(nn.Module):
    """obs (B, num_obs) -> (mu, log_std, value); flax `Dense_0..n-1` are
    `hidden`, `Dense_n` is `mu` and `Dense_n+1` is `value`."""

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (400, 200, 100)):
        super().__init__()
        self.hidden = _mlp(num_obs, units)
        self.mu = nn.Linear(units[-1], num_actions)
        self.value = nn.Linear(units[-1], 1)
        self.log_std = nn.Parameter(torch.zeros(num_actions))

    def forward(self, obs: Tensor):
        x = _trunk(self.hidden, obs)
        mu = self.mu(x)
        return mu, self.log_std.expand_as(mu), self.value(x)[..., 0]


class CentralValue(nn.Module):
    """Standalone value network (the runner's central-value option)."""

    def __init__(self, num_obs: int, units: Sequence[int] = (400, 200, 100)):
        super().__init__()
        self.hidden = _mlp(num_obs, units)
        self.value = nn.Linear(units[-1], 1)

    def forward(self, obs: Tensor) -> Tensor:
        return self.value(_trunk(self.hidden, obs))[..., 0]


class WithCentralValue(nn.Module):
    """The runner's central-value option: an ActorCritic (`ac`) whose value
    head is replaced by a separate CentralValue network (`cv`) on the same
    observations."""

    def __init__(self, ac: ActorCritic, cv: CentralValue):
        super().__init__()
        self.ac = ac
        self.cv = cv

    def forward(self, obs: Tensor):
        mu, log_std, _ = self.ac(obs)
        return mu, log_std, self.cv(obs)


class RunningMeanStd(NamedTuple):
    """Streaming mean/var (rl-games running_mean_std parity)."""

    mean: Tensor
    var: Tensor
    count: Tensor

    @staticmethod
    def create(shape=(), device="cpu") -> "RunningMeanStd":
        return RunningMeanStd(mean=torch.zeros(shape, dtype=F32, device=device),
                              var=torch.ones(shape, dtype=F32, device=device),
                              count=torch.tensor(1e-4, dtype=F32,
                                                 device=device))

    def update(self, batch: Tensor, group=None) -> "RunningMeanStd":
        """Merge batch moments (batch axes 0 ... -mean.dim()-1) by Chan's
        algorithm.

        group: the process group whose ranks' batch moments are summed
        first (the JAX `axis_name` psum, in its two rounds: the count and
        the mean, then the variance about the global mean), so every rank
        folds in the global batch and the stats stay replicated."""
        axes = tuple(range(batch.dim() - self.mean.dim()))
        b_mean = batch.mean(dim=axes)
        b_var = batch.var(dim=axes, unbiased=False)
        b_count = torch.tensor(batch.numel() / max(1, self.mean.numel()),
                               dtype=F32, device=batch.device)
        if group is not None:
            # One all_reduce of [count, mean * count], then one of the
            # variance terms.
            first = torch.cat([b_count.reshape(1),
                               (b_mean * b_count).reshape(-1)])
            dist.all_reduce(first, group=group)
            tot = first[0]
            g_mean = first[1:].reshape(b_mean.shape) / tot
            g_var = (b_var + (b_mean - g_mean) ** 2) * b_count
            dist.all_reduce(g_var, group=group)
            b_mean, b_var, b_count = g_mean, g_var / tot, tot
        delta = b_mean - self.mean
        tot = self.count + b_count
        new_mean = self.mean + delta * b_count / tot
        m_a = self.var * self.count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta * delta * self.count * b_count / tot
        return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)

    def normalize(self, x: Tensor) -> Tensor:
        return ((x - self.mean) * torch.rsqrt(self.var + 1e-5)).clamp(-5.0,
                                                                      5.0)

    def denormalize(self, x: Tensor) -> Tensor:
        return x * torch.sqrt(self.var + 1e-5) + self.mean


def gaussian_logp(mu: Tensor, log_std: Tensor, action: Tensor) -> Tensor:
    """Diagonal Gaussian log-density."""
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * ((action - mu) ** 2) / var - log_std
                     - 0.5 * math.log(2.0 * math.pi), dim=-1)


def gaussian_kl(mu1, log_std1, mu2, log_std2) -> Tensor:
    """KL(p1 || p2) between diagonal Gaussians (adaptive-LR metric)."""
    v1, v2 = torch.exp(2.0 * log_std1), torch.exp(2.0 * log_std2)
    return torch.sum(log_std2 - log_std1
                     + (v1 + (mu1 - mu2) ** 2) / (2.0 * v2) - 0.5, dim=-1)


class LSTMCell(nn.Module):
    """flax `OptimizedLSTMCell`: the input kernels ii/if/ig/io (no bias)
    stacked in `input`, the hidden kernels hi/hf/hg/ho (with bias) in
    `hidden`, gates i, f, o sigmoid and g tanh; the carry is (c, h)."""

    def __init__(self, num_in: int, units: int):
        super().__init__()
        self.input = nn.Linear(num_in, 4 * units, bias=False)
        self.hidden = nn.Linear(units, 4 * units)

    def forward(self, carry, x: Tensor):
        c, h = carry
        i, f, g, o = (self.hidden(h) + self.input(x)).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class ActorCriticLSTM(nn.Module):
    """Recurrent actor-critic: an LSTM before the MLP, its output
    concatenated with the input (the reference's rnn spec: lstm, 128 units,
    1 layer, before_mlp, concat_input)."""

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (400, 200, 100),
                 lstm_units: int = 128, concat_input: bool = True):
        super().__init__()
        self.lstm_units = lstm_units
        self.concat_input = concat_input
        self.cell = LSTMCell(num_obs, lstm_units)
        n_in = lstm_units + (num_obs if concat_input else 0)
        self.hidden = _mlp(n_in, units)
        self.mu = nn.Linear(units[-1], num_actions)
        self.value = nn.Linear(units[-1], 1)
        self.log_std = nn.Parameter(torch.zeros(num_actions))

    def forward(self, obs: Tensor, carry):
        """obs (B, num_obs), carry ((B, lstm), (B, lstm)) -> (carry', mu,
        log_std, value)."""
        carry, y = self.cell(carry, obs)
        x = torch.cat([y, obs], dim=-1) if self.concat_input else y
        x = _trunk(self.hidden, x)
        mu = self.mu(x)
        return carry, mu, self.log_std.expand_as(mu), self.value(x)[..., 0]

    def initial_carry(self, batch: int):
        z = torch.zeros((batch, self.lstm_units), dtype=F32,
                        device=self.log_std.device)
        return (z, z)

"""Core network blocks: pre-net, highway, conv bank, CBHG.

Port of `sstts/model/modules.py` (26-262).  Batch norm follows the module's
mode: in `train()` it normalizes with statistics over the valid positions
of the (B, T) mask and updates its running statistics at momentum 0.99; in
`eval()` it uses the running statistics (eps 1e-3).  Layouts follow the JAX
package at the module boundary — (B, T, D) batch-major with an optional
(B, T) mask — and convolutions transpose to PyTorch's (B, D, T) inside.  Parameter names
follow flax, so `sstts_torch.convert` maps one tree onto the other.

`dtype` is flax's compute dtype: parameters stay f32 and the inputs and
weights of each dense layer and convolution are cast to it at use.  Batch
norm computes its statistics and normalisation in f32 and returns the
compute dtype, and the BiGRU computes and returns f32
(`sstts_torch.model.rnn`), cast here to the compute dtype, as in the
reference.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sstts_torch.model.attention import linear
from sstts_torch.model.rnn import BiGRU


def _mask3(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask[..., None].to(like.dtype)


def _conv(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype,
          pad: Optional[Tuple[int, int]] = None, padding: int = 0) -> torch.Tensor:
    """(B, T, D) -> (B, T, C): conv1d of input and kernel in the compute
    dtype, after explicit (left, right) padding of time (`pad`) or with the
    conv's own symmetric `padding`."""
    xc = x.to(dtype).transpose(1, 2)
    if pad is not None:
        xc = F.pad(xc, pad)
    return F.conv1d(xc, weight.to(dtype), padding=padding).transpose(1, 2)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (batch, time) of (B, T, C) inputs.  Train mode: mean
    and (biased) variance over the valid positions only, and the running
    statistics move towards them (EMA at `momentum`); eval mode: the
    running statistics.  With a `group` (a mesh's data group,
    `sstts_torch.parallel.mesh.shard_model`) the train-mode sums and the
    count are taken over every rank's rows, as GSPMD takes them over the
    global batch, through a differentiable all-reduce; the running
    statistics then stay equal on every rank."""

    def __init__(self, features: int, epsilon: float = 1e-3, momentum: float = 0.99,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.group = None

    def _global_stats(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        from sstts_torch.parallel.mesh import all_reduce_sum

        m = (torch.ones(x.shape[:2], device=x.device) if mask is None else mask)[..., None].float()
        sums = all_reduce_sum(torch.cat([(x * m).sum((0, 1)), m.sum()[None]]), self.group)
        count = torch.clamp(sums[-1], min=1.0)
        mean = sums[:-1] / count
        var = all_reduce_sum((((x - mean) ** 2) * m).sum((0, 1)), self.group) / count
        return mean, var

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            if self.group is not None:
                mean, var = self._global_stats(x, mask)
            elif mask is not None:
                m = mask[..., None].float()  # f32 statistics under bf16 compute
                count = torch.clamp(m.sum(), min=1.0)
                mean = (x * m).sum((0, 1)) / count
                var = (((x - mean) ** 2) * m).sum((0, 1)) / count
            else:
                mean = x.mean((0, 1))
                var = x.var((0, 1), unbiased=False)
            with torch.no_grad():
                mom = self.momentum
                self.mean.copy_(mom * self.mean + (1 - mom) * mean)
                self.var.copy_(mom * self.var + (1 - mom) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) / torch.sqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(self.dtype)


class PreNet(nn.Module):
    """FC-ReLU-dropout stack.  Dropout takes explicit keep masks (one
    (..., P) {0, 1} tensor per layer, or None for no dropout) so that every
    path — plain, kernel, batch of one — can be fed the same noise;
    `keep_masks` draws them from a `torch.Generator`."""

    def __init__(self, d_in: int, units: Sequence[int], dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.units = tuple(units)
        dims = [d_in, *units]
        for i in range(len(units)):
            setattr(self, f"fc{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n_layers = len(units)

    def keep_masks(self, shape: Tuple[int, ...], generator: torch.Generator):
        """Per-layer keep masks (*shape, P_i), kept with probability
        1 - dropout; None at rate 0, where dropout is the identity."""
        if self.dropout <= 0.0:
            return None
        return [
            (torch.rand(*shape, p, generator=generator, device=generator.device)
             >= self.dropout).float()
            for p in self.units
        ]

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        scale = 1.0 / (1.0 - self.dropout) if self.dropout < 1.0 else 0.0
        for i in range(self.n_layers):
            x = F.relu(linear(x, getattr(self, f"fc{i}"), self.dtype))
            if keep is not None:
                x = torch.where(keep[i] > 0, x * scale, torch.zeros_like(x))
        return x


class Highway(nn.Module):
    """Single highway layer: T * H(x) + (1 - T) * x."""

    def __init__(self, units: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.h = nn.Linear(units, units)
        self.t = nn.Linear(units, units)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(linear(x, self.h, self.dtype))
        t = torch.sigmoid(linear(x, self.t, self.dtype))
        return h * t + x * (1.0 - t)


class Conv1dBank(nn.Module):
    """K parallel conv1d's of widths 1..K, each BN+ReLU, concatenated:
    (B, T, D) -> (B, T, K * channels).

    Kernel `conv{k}` is (channels, D, k), PyTorch's Conv1d layout.  SAME
    padding is asymmetric for even widths, ((k-1)//2, k//2), as in XLA, so
    each conv pads explicitly and runs unpadded.  `fused` runs the same
    parameters as one conv: each width-k kernel zero-padded to width K with
    its tap j at offset left - (k-1)//2 + j (left = (K-1)//2), the K kernels
    concatenated along the output channels, one conv padded (left,
    K-1-left), as the reference's fused bank (`sstts/model/modules.py:161-185`).
    """

    def __init__(self, d_in: int, bank_k: int, channels: int,
                 dtype: torch.dtype = torch.float32, fused: bool = False):
        super().__init__()
        self.bank_k = bank_k
        self.channels = channels
        self.dtype = dtype
        self.fused = fused
        for k in range(1, bank_k + 1):
            setattr(self, f"conv{k}", nn.Parameter(torch.empty(channels, d_in, k)))
            setattr(self, f"bn{k}", MaskedBatchNorm(channels, dtype=dtype))

    def fused_kernel(self) -> torch.Tensor:
        """The bank's kernels as one (K * channels, D, K) kernel."""
        K, left = self.bank_k, (self.bank_k - 1) // 2
        wide = []
        for k in range(1, K + 1):
            off = left - (k - 1) // 2
            wide.append(F.pad(getattr(self, f"conv{k}"), (off, K - k - off)))
        return torch.cat(wide, 0)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if mask is not None:
            x = x * _mask3(mask, x)
        K, C = self.bank_k, self.channels
        if self.fused:
            left = (K - 1) // 2
            y = _conv(x, self.fused_kernel(), self.dtype, (left, K - 1 - left))
            ys = [y[..., (k - 1) * C : k * C] for k in range(1, K + 1)]
        else:
            ys = [
                _conv(x, getattr(self, f"conv{k}"), self.dtype, ((k - 1) // 2, k // 2))
                for k in range(1, K + 1)
            ]
        outs = [F.relu(getattr(self, f"bn{k}")(y, mask)) for k, y in enumerate(ys, 1)]
        out = torch.cat(outs, dim=-1)
        if mask is not None:
            out = out * _mask3(mask, out)
        return out


class CBHG(nn.Module):
    """Conv bank -> max-pool(2, stride 1) -> two 3-wide conv projections
    (+BN, first ReLU) -> residual -> highway stack -> BiGRU.
    (B, T, D) -> (B, T, 2 * gru_units)."""

    def __init__(
        self,
        d_in: int,
        bank_k: int,
        bank_channels: int,
        proj_channels: Tuple[int, int],
        highway_layers: int,
        highway_units: int,
        gru_units: int,
        dtype: torch.dtype = torch.float32,
        fused_bank: bool = False,
    ):
        super().__init__()
        if proj_channels[1] != d_in:
            raise ValueError(
                f"CBHG residual dim mismatch: proj2={proj_channels[1]} vs input={d_in}"
            )
        self.dtype = dtype
        self.bank = Conv1dBank(d_in, bank_k, bank_channels, dtype, fused_bank)
        self.proj1 = nn.Conv1d(bank_k * bank_channels, proj_channels[0], 3, padding=1, bias=False)
        self.proj1_bn = MaskedBatchNorm(proj_channels[0], dtype=dtype)
        self.proj2 = nn.Conv1d(proj_channels[0], proj_channels[1], 3, padding=1, bias=False)
        self.proj2_bn = MaskedBatchNorm(proj_channels[1], dtype=dtype)
        if d_in != highway_units:
            self.highway_in = nn.Linear(d_in, highway_units)
        self.highway_layers = highway_layers
        for i in range(highway_layers):
            setattr(self, f"highway{i}", Highway(highway_units, dtype))
        self.gru = BiGRU(highway_units, gru_units)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        residual = x
        y = self.bank(x, mask)
        # Max-pool width 2, stride 1, SAME: max(y[t], y[t+1]), -inf past the end.
        right = F.pad(y[:, 1:], (0, 0, 0, 1), value=float("-inf"))
        y = torch.maximum(y, right)
        if mask is not None:
            y = torch.where(mask[..., None], y, torch.zeros_like(y))
        y = _conv(y, self.proj1.weight, self.dtype, padding=1)
        y = F.relu(self.proj1_bn(y, mask))
        if mask is not None:
            y = y * _mask3(mask, y)
        y = _conv(y, self.proj2.weight, self.dtype, padding=1)
        y = self.proj2_bn(y, mask)
        y = y + residual
        if hasattr(self, "highway_in"):
            y = linear(y, self.highway_in, self.dtype)
        for i in range(self.highway_layers):
            y = getattr(self, f"highway{i}")(y)
        if mask is not None:
            y = y * _mask3(mask, y)
        return self.gru(y, mask).to(self.dtype)

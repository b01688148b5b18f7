"""The traffic generator: a configuration and a mix in, a seeded pool of
files out.

Shapes never depend on the seed.  The configuration lists the files of one
unit (a fold of a dataset, a track) as ``files``: groups of
``[channels, rate, samples per channel, count]``; a call is one unit, and
the pool holds the mix's ``pool_units`` units of exactly these shapes,
called in order.  The seed
chooses only the content of every file and the order of the files within
a unit.

Content is made on the device from the seed with a ``torch.Generator`` on
that device, a block of files at a time: tones with slow pitch and
envelope changes over band-limited noise for music, decaying noise bursts
and chirps for sound effects.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from .reference.tables import FRAME_LEN

# samples made per block: bounds the generator's device memory
_BLOCK_SAMPLES = 1 << 25


@dataclasses.dataclass(frozen=True)
class File:
    channels: int
    rate: int
    samples: int  # per channel

    @property
    def frames(self) -> int:
        return -(-self.samples // FRAME_LEN)


@dataclasses.dataclass
class Pool:
    files: List[File]
    units: List[List[int]]  # file indices of each unit, one unit a call, in call order
    signal: str


def unit_shapes(config: dict) -> List[File]:
    """The files of one unit, as the configuration lists them."""
    return [File(int(c), int(r), int(n))
            for c, r, n, count in config["files"] for _ in range(count)]


def make_pool(config: dict, traffic: dict, seed: int) -> Pool:
    shapes = unit_shapes(config)
    rng = np.random.default_rng(seed)
    files, units = [], []
    for _ in range(traffic["pool_units"]):
        units.append([len(files) + int(i) for i in rng.permutation(len(shapes))])
        files.extend(shapes)
    return Pool(files, units, config["signal"])


def _music(t, ch, g, n_chains, dev):
    """Tones with slow pitch and envelope changes over band-limited noise."""
    u = torch.rand((n_chains, 8), generator=g, device=dev, dtype=torch.float64)
    f0 = 110.0 * 4.0 ** u[:, 0]
    depth, nu = 0.002 + 0.008 * u[:, 1], 0.1 + 0.4 * u[:, 2]
    mu, theta = 0.05 + 0.25 * u[:, 3], 2 * math.pi * u[:, 4]
    noise_lvl, gain = 0.05 + 0.1 * u[:, 5], 8000.0 + 12000.0 * u[:, 6]
    pan = 0.8 + 0.4 * u[:, 7]
    tt = t
    warp = tt + (depth / (2 * math.pi * nu))[ch] * torch.sin(2 * math.pi * nu[ch] * tt)
    sig = torch.zeros_like(tt, dtype=torch.float32)
    for h, a in ((1, 0.5), (2, 0.25), (3, 0.15)):
        ph = torch.remainder(2 * math.pi * h * f0[ch] * warp, 2 * math.pi)
        sig += a * torch.sin(ph).float()
    env = 0.6 + 0.4 * torch.sin(2 * math.pi * mu[ch] * tt + theta[ch]).float()
    noise = torch.randn(tt.shape, generator=g, device=dev)
    noise = torch.nn.functional.avg_pool1d(noise[None, None], 4, 1, 2)[0, 0, : tt.numel()]
    return (sig * env + noise_lvl[ch].float() * noise) * (gain * pan)[ch].float()


def _effects(t, ch, g, n_chains, dev):
    """Decaying noise bursts and chirps."""
    u = torch.rand((n_chains, 7), generator=g, device=dev, dtype=torch.float64)
    tau1, tau2 = 0.05 + 0.95 * u[:, 0], 0.1 + 1.9 * u[:, 1]
    f0, k = 100.0 + 1900.0 * u[:, 2], -1000.0 + 5000.0 * u[:, 3]
    mix, gain = u[:, 4], 5000.0 + 20000.0 * u[:, 5]
    tt = t
    ph = torch.remainder(2 * math.pi * (f0[ch] * tt + 0.5 * k[ch] * tt * tt), 2 * math.pi)
    chirp = torch.sin(ph).float() * torch.exp(-tt / tau2[ch]).float()
    noise = torch.randn(tt.shape, generator=g, device=dev)
    noise = torch.nn.functional.avg_pool1d(noise[None, None], 2, 1, 1)[0, 0, : tt.numel()]
    burst = noise * torch.exp(-tt / tau1[ch]).float()
    m = mix[ch].float()
    return (m * burst + (1 - m) * chirp) * gain[ch].float()


_SIGNALS = {"music": _music, "effects": _effects}


def synth(pool: Pool, seed: int, device) -> List[torch.Tensor]:
    """Every file's PCM as a (channels, samples) int16 tensor on
    ``device``, made from ``seed`` in blocks of files."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    make = _SIGNALS[pool.signal]
    out: List[torch.Tensor] = []
    i = 0
    while i < len(pool.files):
        j, size = i, 0
        while j < len(pool.files) and (j == i or size + pool.files[j].samples
                                       * pool.files[j].channels <= _BLOCK_SAMPLES):
            size += pool.files[j].samples * pool.files[j].channels
            j += 1
        block = pool.files[i:j]
        lens = torch.tensor([f.samples for f in block for _ in range(f.channels)], device=dev)
        rate = torch.tensor([f.rate for f in block for _ in range(f.channels)],
                            device=dev, dtype=torch.float64)
        ch = torch.repeat_interleave(torch.arange(len(lens), device=dev), lens)
        starts = torch.cumsum(lens, 0) - lens
        pos = torch.arange(size, device=dev) - starts[ch]
        x = make(pos.to(torch.float64) / rate[ch], ch, g, len(lens), dev)
        pcm = torch.clamp(torch.round(x), -32768, 32767).to(torch.int16)
        off = 0
        for f in block:
            n = f.samples * f.channels
            out.append(pcm[off:off + n].view(f.channels, f.samples))
            off += n
        i = j
    return out

"""``parallel.batch_encode``: interleaved int16 PCM with its ``QoaDesc`` in,
QOA streams out."""

import numpy as np
import torch

from qoaudio_tpu_torch import QoaDesc, parallel

from qoabench import frames


def prepare(pool, pcm):
    """Each file's interleaved PCM as a read-only host array (one copy off
    the device for all of them), with its description."""
    flat = torch.cat([p.t().reshape(-1) for p in pcm]).cpu().numpy()
    flat.flags.writeable = False
    out, pos = [], 0
    for f in pool.files:
        n = f.samples * f.channels
        out.append((flat[pos:pos + n], QoaDesc(f.channels, f.rate, f.samples)))
        pos += n
    return out


def call(inputs, files, place):
    return parallel.batch_encode([inputs[i] for i in files], **place)


def chains(pool, inputs, files, device):
    pcm = [torch.from_numpy(np.array(inputs[i][0])).to(device)
           .view(pool.files[i].samples, pool.files[i].channels).t() for i in files]
    return frames.chains_of_pcm(pcm)

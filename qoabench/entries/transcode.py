"""``parallel.batch_transcode``: QOA streams in, QOA streams out.  The
inputs are the files' PCM encoded by the frozen reference; what the
program must re-encode is their reference decode."""

from qoaudio_tpu_torch import parallel

from qoabench import frames


def prepare(pool, pcm):
    return frames.streams_from_pcm(pool.files, pcm)


def call(inputs, files, place):
    return parallel.batch_transcode([inputs[i] for i in files], **place)


def chains(pool, inputs, files, device):
    return frames.decode_streams([pool.files[i] for i in files],
                                 [inputs[i] for i in files], device)

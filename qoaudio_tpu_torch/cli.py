"""Command-line tools of the port: encode / decode / play / info / transcode.

Port of ``qoaudio_tpu/cli.py``.  ``--backend`` is one of auto, native,
numpy, torch; the torch paths and ``transcode``'s batched device paths
run on ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  A CUDA device that is not there is an error: nothing runs on
the CPU in its place.

Usage:
  python -m qoaudio_tpu_torch encode  input.wav output.qoa
  python -m qoaudio_tpu_torch decode  input.qoa output.wav
  python -m qoaudio_tpu_torch play    input.qoa          (writes to sink/stdout)
  python -m qoaudio_tpu_torch info    input.qoa
  python -m qoaudio_tpu_torch transcode *.qoa --out-dir DIR [--hbm]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from qoaudio_tpu.cli import _cmd_info, _play_audio_sink
from qoaudio_tpu.types import QoaDesc
from qoaudio_tpu.utils.wav import read_wav, write_wav

from . import codec
from .parallel import corpus
from .source import QoaPcmSource
from .streaming import QoaDecoder


class CliError(Exception):
    """A usage fault: printed as one line, exit status 1."""


def _device(args) -> torch.device:
    """``--device``, checked: a CUDA device must be there."""
    try:
        dev = torch.device(args.device)
    except RuntimeError as e:
        raise CliError(f"--device {args.device}: {e}") from None
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CliError(f"--device {args.device}: no CUDA device is available")
    return dev


def _codec_device(args):
    """The device of a codec call: checked when the call runs on torch,
    None when it runs on a host backend."""
    if codec.resolve_backend(args.backend, args.device) == "torch":
        return _device(args)
    return None


def _out_paths(inputs, out_dir: str) -> list:
    """``out_dir/<input basename>.qoa`` for every input.  Raises CliError
    when ``out_dir`` is an existing non-directory or when two inputs would
    write the same file."""
    norm = os.path.normpath(out_dir)
    if os.path.exists(norm) and not os.path.isdir(norm):
        raise CliError(f"output directory {out_dir} exists and is not a directory")
    outs = [
        os.path.join(out_dir, os.path.splitext(os.path.basename(i))[0] + ".qoa")
        for i in inputs
    ]
    first = {}
    for i, o in zip(inputs, outs):
        if o in first:
            raise CliError(f"inputs {first[o]} and {i} would both be written to {o}")
        first[o] = i
    return outs


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _cmd_encode(args) -> int:
    inputs = args.input
    if len(inputs) > 1 or os.path.isdir(args.output) or args.output.endswith(os.sep):
        outs = _out_paths(inputs, args.output)
        os.makedirs(args.output, exist_ok=True)
    else:
        outs = [args.output]
    device = _codec_device(args)

    items = []
    for path in inputs:
        pcm, channels, rate = read_wav(path)
        items.append((pcm, QoaDesc(channels, rate, len(pcm) // channels)))

    t0 = time.perf_counter()
    streams = codec.encode_all_batch(items, backend=args.backend, device=device)
    dt = time.perf_counter() - t0

    total_samples = total_pcm_bytes = total_qoa_bytes = 0
    for path, out, (pcm, desc), data in zip(inputs, outs, items, streams):
        _write(out, data)
        pcm_bytes = len(pcm) * 2
        total_samples += len(pcm)
        total_pcm_bytes += pcm_bytes
        total_qoa_bytes += len(data)
        print(
            f"{path}: {desc.samples} samples/ch, {desc.channels} ch, "
            f"{desc.sample_rate} Hz -> {out} "
            f"({pcm_bytes} -> {len(data)} bytes, "
            f"compression {pcm_bytes / len(data):.2f}x)"
        )
    print(
        f"encoded {total_pcm_bytes} -> {total_qoa_bytes} bytes "
        f"(compression {total_pcm_bytes / total_qoa_bytes:.2f}x) in "
        f"{dt*1e3:.1f} ms ({total_samples/dt/1e6:.1f} Msamples/s)"
    )
    return 0


def _cmd_decode(args) -> int:
    device = _codec_device(args)
    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    out = codec.decode_all(data, backend=args.backend, device=device)
    dt = time.perf_counter() - t0
    write_wav(args.output, out.samples, out.num_channels, out.sample_rate)
    print(
        f"decoded {len(out.samples)} samples ({out.num_channels} ch, "
        f"{out.sample_rate} Hz, {out.duration_seconds:.1f} s) "
        f"in {dt*1e3:.1f} ms ({len(out.samples)/dt/1e6:.1f} Msamples/s)"
    )
    return 0


def _cmd_play(args) -> int:
    """Stream samples to an audio sink (``qoaudio_tpu.cli``'s ``play``,
    decoding through the port's ``QoaDecoder``).

    ``--sink audio`` plays through the default output device (needs the
    optional ``sounddevice`` package and a device, else it falls back to
    WAV); ``--sink wav`` (default) renders the first format segment to a
    WAV file; ``--sink raw`` streams raw PCM to stdout.
    """
    device = _device(args) if args.backend == "torch" else None
    src = QoaPcmSource(QoaDecoder.open(args.input, backend=args.backend,
                                       device=device))
    # one sample fixes the first block's format (a streaming-mode file
    # reports channels 0 until its first frame is pulled); then top up to
    # a channel-aligned block.  One read never spans a format change, but
    # consecutive reads do: a crossed block is held as pending.
    first = src.read(1)
    fmt0 = (src.block_channels, src.block_sample_rate)
    pending = None
    if len(first):
        top = src.read(8192 * max(1, fmt0[0]) - 1)
        if top.size:
            bf = (src.block_channels, src.block_sample_rate)
            if bf == fmt0:
                first = np.concatenate([first, top])
            else:
                pending = (top, bf)

    sink = args.sink
    if sink == "audio":
        # probe availability only; a failure mid-playback propagates
        try:
            import sounddevice as sd

            sd.check_output_settings(
                samplerate=max(1, fmt0[1]), channels=max(1, fmt0[0]),
                dtype="int16",
            )
        except Exception as e:  # no module or no usable device
            print(f"audio sink unavailable ({e}); falling back to WAV",
                  file=sys.stderr)
            sink = "wav"
        else:
            return _play_audio_sink(src, first, fmt0, pending)
    if sink == "raw":
        sys.stdout.buffer.write(first.astype("<i2").tobytes())
        if pending is not None:
            sys.stdout.buffer.write(pending[0].astype("<i2").tobytes())
        while True:
            more = src.read()
            if not more.size:
                break
            sys.stdout.buffer.write(more.astype("<i2").tobytes())
        return 0
    # a WAV holds one format: the first segment only
    blocks = [first]
    changed = pending is not None
    while not changed:
        b = src.read()
        if not b.size:
            break
        if (src.block_channels, src.block_sample_rate) != fmt0:
            changed = True
            break
        blocks.append(b)
    samples = np.concatenate(blocks)
    if samples.size == 0 or fmt0[0] == 0 or fmt0[1] == 0:
        print(f"{args.input}: no playable frames; nothing written")
        return 0
    ch0, rate0 = fmt0
    out = args.output or (os.path.splitext(args.input)[0] + ".play.wav")
    if changed:
        print(
            f"{args.input}: mid-stream format change — writing only the "
            "first segment (use --sink raw for the whole stream)",
            file=sys.stderr,
        )
    write_wav(out, samples, ch0, rate0)
    dur = src.total_duration()
    print(
        f"rendered {args.input} ({ch0} ch, {rate0} Hz"
        + (f", {dur:.1f} s" if dur else "")
        + f") -> {out}"
    )
    return 0


def _cmd_transcode(args) -> int:
    outs = None
    if args.out_dir:
        outs = _out_paths(args.inputs, args.out_dir)
        os.makedirs(args.out_dir, exist_ok=True)
    if args.backend != "auto" and not args.hbm:
        # an explicit backend pins every stage to that engine, file by file
        device = _codec_device(args)
        t0 = time.perf_counter()
        total = 0
        for i, p in enumerate(args.inputs):
            with open(p, "rb") as f:
                data = f.read()
            out = codec.decode_all(data, backend=args.backend, device=device)
            enc = codec.encode_all(
                out.samples,
                QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
                backend=args.backend,
                device=device,
            )
            total += len(out.samples)
            if outs:
                _write(outs[i], enc)
        dt = time.perf_counter() - t0
        print(
            f"transcoded {len(args.inputs)} files on backend="
            f"{args.backend}: {total} samples in {dt*1e3:.0f} ms "
            f"({total/dt/1e6:.1f} Msamples/s)"
        )
        return 0
    device = _device(args)
    if args.hbm:
        if args.backend != "auto":
            print("--hbm selects the device pipeline; --backend is ignored",
                  file=sys.stderr)
        # decode -> on-device relayout -> encode: the PCM never reaches the
        # host, so there is nothing to verify without a separate decode
        datas = []
        for p in args.inputs:
            with open(p, "rb") as f:
                datas.append(f.read())
        t0 = time.perf_counter()
        results = corpus.batch_transcode(datas, device)
        dt = time.perf_counter() - t0
        if outs:
            for o, data in zip(outs, results):
                _write(o, data)
        print(
            f"device transcode: {len(results)} files, "
            f"{sum(len(d) for d in datas)} -> {sum(len(d) for d in results)} "
            f"bytes in {dt*1e3:.0f} ms on {device} (PCM stayed on the device)"
        )
        return 0

    report = corpus.transcode_corpus(
        args.inputs, device, out_dir=args.out_dir, verify=not args.no_verify,
    )
    for line in report.lines():
        print(line)
    return 0 if report.ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qoaudio_tpu_torch", description=__doc__)
    p.add_argument(
        "--backend",
        choices=list(codec.BACKENDS),
        default="auto",
        help="execution backend for the codec core (auto = native host "
        "engine when available, else the torch kernels on --device)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="device of the torch paths: a CUDA device runs the kernels, "
        "cpu their plain PyTorch versions (default: cuda)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="WAV -> QOA (many inputs batch)")
    pe.add_argument("input", nargs="+")
    pe.add_argument(
        "output",
        help="output .qoa file, or a directory with multiple inputs",
    )
    pe.set_defaults(fn=_cmd_encode)

    pd = sub.add_parser("decode", help="QOA -> WAV")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.set_defaults(fn=_cmd_decode)

    pp = sub.add_parser("play", help="decode to an audio sink")
    pp.add_argument("input")
    pp.add_argument("--output", default=None)
    pp.add_argument(
        "--sink",
        choices=["audio", "wav", "raw"],
        default="wav",
        help="audio = play through the default device (sounddevice; falls "
        "back to wav when unavailable)",
    )
    pp.set_defaults(fn=_cmd_play)

    pi = sub.add_parser("info", help="print stream metadata")
    pi.add_argument("input")
    pi.set_defaults(fn=_cmd_info)

    pt = sub.add_parser("transcode", help="batched corpus transcode")
    pt.add_argument("inputs", nargs="+")
    pt.add_argument("--out-dir", default=None)
    pt.add_argument("--no-verify", action="store_true")
    pt.add_argument(
        "--hbm",
        action="store_true",
        help="device-resident pipeline: PCM never leaves the device; only "
        "compressed data crosses the host<->device link",
    )
    pt.set_defaults(fn=_cmd_transcode)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except CliError as e:
        print(f"qoaudio_tpu_torch: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())

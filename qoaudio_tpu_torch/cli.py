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

from . import bitstream as bs
from . import codec
from . import format as fmt
from .errors import QoaError
from .parallel import corpus
from .source import QoaPcmSource
from .streaming import QoaDecoder
from .types import QoaDesc
from .utils.wav import read_wav, write_wav


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


def _play_audio_sink(src, block, bf, pending) -> int:
    """Stream decoded PCM to a real audio device via sounddevice.

    ``qoaudio_tpu/cli.py``'s sink, the analog of the reference's rodio sink
    (examples/play.rs:11-25, src/lib.rs:914-989): blocks stream to the
    device as frames decode, so playback starts before the file finishes
    decoding.  ``bf`` is ``block``'s (channels, rate); ``pending`` is an
    already-read (block, format) of the NEXT segment, or None.
    """
    import sounddevice as sd  # availability probed by the caller

    while len(block):
        # one OutputStream per format segment: a read never spans a
        # format change, and each block carries its own format (the
        # source's channels/sample_rate can already describe the NEXT
        # staged frame when a read stopped at the boundary)
        ch, rate = bf
        with sd.OutputStream(
            samplerate=rate, channels=ch, dtype="int16"
        ) as stream:
            while len(block):
                # a ``pending`` block was read with the PREVIOUS segment's
                # value limit and can stop mid-frame at a non-multiple of
                # THIS segment's channel count: write only whole samples
                # and carry the tail into the next read.  The carry always
                # resolves within the segment (segments hold whole frames,
                # so each segment's total length is a multiple of its
                # channel count), leaving it empty at every format change.
                whole = len(block) - len(block) % ch
                if whole:
                    stream.write(
                        np.ascontiguousarray(block[:whole].reshape(-1, ch))
                    )
                carry = block[whole:]
                if pending is not None:
                    (block, bf), pending = pending, None
                else:
                    block = src.read(8192 * ch)
                    bf = (src.block_channels, src.block_sample_rate)
                if carry.size:
                    if not len(block):
                        break  # defensive: a mid-sample EOF drops the tail
                    block = np.concatenate([carry, block])
                if bf != (ch, rate):
                    break  # reopen the device for the new format
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


def _cmd_info(args) -> int:
    """Print stream metadata without decoding any samples
    (``qoaudio_tpu/cli.py``'s ``info``).

    A pure header walk: reads each 8-byte frame header and skips the
    spc-derived body (the reference reader's stride, src/lib.rs:291-330)
    — no slice-word staging, O(frames) work and O(1) memory.  Damaged
    files report everything parsed up to the corruption instead of a
    traceback (that is exactly when one runs ``info``).
    """
    with open(args.input, "rb") as f:
        data = f.read()
    total = fmt.unpack_file_header(data)
    mode = "streaming" if total == 0 else "fixed"
    frames = 0
    channels = rates = None
    samples = 0
    damage = None
    off = fmt.QOA_HEADER_SIZE
    n = len(data)
    while off + 8 <= n:
        word = int.from_bytes(data[off : off + 8], "big")
        ch, rate, spc, fsize = fmt.unpack_frame_header(word)
        try:
            bs._validate_frame_header(ch, rate, fsize)
        except QoaError as e:
            damage = f"invalid frame header at byte {off} ({e.__class__.__name__})"
            break
        nw = -(-spc // fmt.QOA_SLICE_LEN)
        body = fmt.QOA_LMS_STATE_BYTES * ch + 8 * nw * ch
        if off + 8 + body > n:
            damage = f"truncated frame at byte {off}"
            break
        frames += 1
        channels, rates = ch, rate
        samples += spc
        off += 8 + body
    if 0 < n - off < 8 and damage is None:
        damage = f"trailing {n - off} bytes after the last frame"
    print(f"{args.input}: {mode} mode, {frames} frames")
    if frames == 0 or not rates or not samples:
        # degenerate but parseable (e.g. header-only stream): counts only
        print(f"  {len(data)} bytes, no frames")
        return 0
    print(f"  channels {channels}, sample rate {rates} Hz")
    print(
        f"  {samples} samples/ch ({samples / rates:.2f} s), "
        f"{len(data)} bytes, "
        f"{len(data) * 8 / (samples * (channels or 1)):.2f} bits/sample"
    )
    if total and total != samples:
        print(f"  note: header declares {total} samples/ch")
    if damage:
        print(f"  note: {damage}")
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

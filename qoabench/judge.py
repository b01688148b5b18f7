"""The comparison that decides ``correct``: the program's QOA bytes against
the frozen reference's, file by file and frame by frame.

The reference encoder is a serial chain over a whole file, which plain
PyTorch could not follow over hundreds of thousands of steps in time.  So
it runs every frame at once, each from a guess of the LMS state that frame
starts from: the state in the program's own frame header.  It then checks
each guess against the state the reference itself ends the frame before
with, and runs again every frame whose guess was wrong though its header
agreed (a weight outside 16 bits, which the header cannot hold), from the
reference's own state, until no frame's start changes.  The stream it then
assembles starts from the encoder's initial state and carries its own
states from frame to frame: it is the serial reference's stream, whatever
the program wrote.  The program's states only choose what may run side by
side.  A frame whose header disagrees is wrong, and the frames after it
are judged from the program's states, so that each wrong frame counts once.

``teacher_forced`` makes the control's streams: each frame encoded by
another encoder (the reference in lower precision) from the program's
states, carried the same way.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import frames as fr
from .generate import File
from .reference import codec as ref
from .reference import stream

# rounds of re-encoding frames whose start state the header cannot hold;
# past this a run's judge gives up and the run is not correct
MAX_ROUNDS = 64


def _guesses(b: fr.Batch, parsed: Sequence[Optional[stream.Parsed]], device) -> torch.Tensor:
    start = ref.initial_state(b.chains, "cpu").numpy()
    for i, p in enumerate(parsed):
        if p is not None and p.geometry.frames > 1:
            idx = b.frame_chains(i)
            start[idx[1:]] = p.states[1:]
    return torch.from_numpy(start).to(device)


def _prev_chain(b: fr.Batch) -> np.ndarray:
    """The chain of the same channel one frame before; -1 for frame 0."""
    prev = np.full(b.chains, -1, np.int64)
    for i in range(len(b.files)):
        idx = b.frame_chains(i)
        prev[idx[1:]] = idx[:-1]
    return prev


def _to_i16(t: torch.Tensor) -> torch.Tensor:
    return ((t.to(torch.int64) & 0xFFFF) ^ 0x8000) - 0x8000


def reference_chain(b: fr.Batch, x: torch.Tensor, guess: torch.Tensor,
                    predict: str = "int32"):
    """Every frame encoded from the state the encoder carries into it,
    starting from ``guess``.  Returns (start, words, end, rounds) with
    start[n] = end[prev[n]] for every chain whose guess agreed with the
    16-bit header of that state."""
    prev = torch.from_numpy(_prev_chain(b)).to(x.device)
    start = guess.clone()
    words, end = fr.encode(x, start, b.nsamp, predict)
    has_prev = prev >= 0
    prev_c = prev.clamp_min(0)
    rounds = 0
    while True:
        carried = end[prev_c]
        redo = has_prev & (carried != start).any(1) & (_to_i16(carried) == _to_i16(guess)).all(1)
        idx = torch.nonzero(redo).flatten()
        if idx.numel() == 0:
            return start, words, end, rounds
        rounds += 1
        if rounds > MAX_ROUNDS:
            raise RuntimeError(f"judge: frame states still moving after {MAX_ROUNDS} rounds")
        start[idx] = carried[idx]
        sub = idx.cpu().numpy()
        w2, e2 = fr.encode(x[:, :, idx], start[idx], b.nsamp[sub], predict)
        words[idx] = w2
        end[idx] = e2


def _frame_ranges(f: File) -> np.ndarray:
    return 8 * stream.geometry(f.samples, f.channels).starts


def compare(files: Sequence[File], x: torch.Tensor, outputs: Sequence[Optional[bytes]]) -> Dict[str, int]:
    """Counts of the program's files and frames that differ from the
    reference.  ``x`` holds the files' samples as chains of
    ``frames.batch(files)``."""
    b = fr.batch(files)
    parsed: List[Optional[stream.Parsed]] = []
    for f, out in zip(files, outputs):
        ok = isinstance(out, (bytes, bytearray))
        parsed.append(stream.parse(bytes(out), f.channels, f.samples) if ok else None)
    counts = {"files": len(files), "frames": sum(f.frames for f in files),
              "files_wrong": 0, "frames_wrong": 0}
    if len(outputs) != len(files):
        counts["files_wrong"] = len(files)
        counts["frames_wrong"] = counts["frames"]
        return counts
    guess = _guesses(b, parsed, x.device)
    _, words, end, counts["rounds"] = reference_chain(b, x, guess)
    words, end = words.cpu().numpy(), end.cpu().numpy()
    init = ref.initial_state(1, "cpu").numpy()[0]
    for i, (f, out, p) in enumerate(zip(files, outputs, parsed)):
        if p is None:
            counts["files_wrong"] += 1
            counts["frames_wrong"] += f.frames
            continue
        idx = b.frame_chains(i)
        states = np.empty((f.frames, f.channels, 8), np.int32)
        states[0] = init
        states[1:] = end[idx[:-1]]
        want = stream.assemble(f.channels, f.rate, f.samples, states, fr.file_words(b, i, words))
        if want == bytes(out):
            continue
        counts["files_wrong"] += 1
        a = np.frombuffer(want, np.uint8)
        o = np.frombuffer(bytes(out), np.uint8)
        cuts = _frame_ranges(f)
        bad = [not np.array_equal(a[s:e], o[s:e]) for s, e in zip(cuts[:-1], cuts[1:])]
        bad[0] = bad[0] or not np.array_equal(a[:8], o[:8])
        counts["frames_wrong"] += int(sum(bad))
    return counts


def teacher_forced(files: Sequence[File], x: torch.Tensor, outputs: Sequence[bytes],
                   predict: str) -> List[bytes]:
    """Streams of the encoder ``predict``, every frame started from the
    state in the program's header (the encoder's initial state for the
    first frame), the next header holding the state it ends with."""
    b = fr.batch(files)
    parsed = [stream.parse(bytes(o), f.channels, f.samples) for f, o in zip(files, outputs)]
    if any(p is None for p in parsed):
        raise ValueError("teacher_forced: the program's output does not parse")
    words, end = fr.encode(x, _guesses(b, parsed, x.device), b.nsamp, predict)
    words, end = words.cpu().numpy(), end.cpu().numpy()
    init = ref.initial_state(1, "cpu").numpy()[0]
    out = []
    for i, f in enumerate(files):
        idx = b.frame_chains(i)
        states = np.empty((f.frames, f.channels, 8), np.int32)
        states[0] = init
        states[1:] = end[idx[:-1]]
        out.append(stream.assemble(f.channels, f.rate, f.samples, states, fr.file_words(b, i, words)))
    return out

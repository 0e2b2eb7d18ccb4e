"""Demo CLI: WAV-pair echo cancellation (the reference's main.cc, rebuilt).

The port of webrtc_aecm_tpu/utils/cli.py over the port's AecmPipeline.
Usage mirrors the reference (`aecm-torch far_file.wav near_file.wav`, or
`python -m webrtc_aecm_tpu_torch far.wav near.wav`, main.cc:174-195):
output is written next to the near file as `<near>_out.wav`, echoMode
defaults to 1 and msInSndCardBuf to 40 (main.cc:163-164), and wall-clock
time is printed (main.cc:165-168).  The samples past the last whole 10 ms
chunk keep the near file's values.

Extras the C demo lacks, as in the JAX package: echo-mode/CNG flags,
explicit `--out`, optional ERLE report, and `--batch` to process many pairs
concurrently through one batched pipeline; and `--device` (the CUDA card
unless given, "cpu" for the plain PyTorch versions).  Exit code 2 on a rate
mismatch, an unsupported rate, an empty batch list or no usable device.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _out_path(near_file: str) -> str:
    root, ext = os.path.splitext(near_file)
    return f"{root}_out{ext or '.wav'}"


def _process_pair(far_pcm, near_pcm, rate, echo_mode, cng, ms, device):
    from ..models import AecmPipeline
    pipe = AecmPipeline(1, rate, cng_mode=cng, echo_mode=echo_mode,
                        device=device)
    chunk = pipe.chunk
    n = (min(len(far_pcm), len(near_pcm)) // chunk) * chunk
    out = pipe.run(far_pcm[None, :n], near_pcm[None, :n],
                   ms_in_sndcard_buf=ms)[0].cpu().numpy()
    full = near_pcm.copy()
    full[:n] = out
    return full.astype(np.int16)


def _run_batch(args, device) -> int:
    """Batched file processing: all pairs padded to one length and run
    through one batched pipeline (the serving shape)."""
    from .wav import read_wav_int16, write_wav_int16
    from .metrics import erle_db

    pairs = []
    with open(args.batch) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if len(parts) == 2:
                parts.append(_out_path(parts[1]))
            pairs.append(parts[:3])
    if not pairs:
        print("error: empty batch list", file=sys.stderr)
        return 2

    fars, nears, rates, lengths = [], [], [], []
    for far_f, near_f, _ in pairs:
        far, fr = read_wav_int16(far_f)
        near, nr = read_wav_int16(near_f)
        if fr != nr or fr not in (8000, 16000):
            print(f"error: bad rates for {far_f}/{near_f}", file=sys.stderr)
            return 2
        rates.append(fr)
        fars.append(far)
        nears.append(near)
        lengths.append(min(len(far), len(near)))
    if len(set(rates)) != 1:
        print("error: all pairs in a batch must share a sample rate",
              file=sys.stderr)
        return 2
    rate = rates[0]
    chunk = min(160, rate // 100)
    n = (max(lengths) // chunk) * chunk
    far_b = np.zeros((len(pairs), n), np.int16)
    near_b = np.zeros((len(pairs), n), np.int16)
    for i, (f, d) in enumerate(zip(fars, nears)):
        m = min(lengths[i], n)
        far_b[i, :m] = f[:m]
        near_b[i, :m] = d[:m]

    from ..models import AecmPipeline
    t0 = time.monotonic()
    pipe = AecmPipeline(len(pairs), rate,
                        cng_mode=0 if args.no_cng else 1,
                        echo_mode=args.echo_mode, device=device)
    out = pipe.run(far_b, near_b, ms_in_sndcard_buf=args.ms_in_sndcard_buf
                   ).cpu().numpy().astype(np.int16)
    elapsed = time.monotonic() - t0

    for i, (_, near_f, out_f) in enumerate(pairs):
        full = nears[i].copy()
        m = min(lengths[i], n)
        full[:m] = out[i, :m]
        write_wav_int16(out_f, full, rate)
        if args.erle:
            e = erle_db(nears[i][:m], full[:m], fars[i][:m])
            print(f"{out_f}: ERLE {e:.2f} dB")
    audio_s = sum(lengths) / rate
    print(f"{len(pairs)} pairs, {audio_s:.1f}s audio in "
          f"{int(elapsed * 1000)} ms ({audio_s / max(elapsed, 1e-9):.1f}x "
          "real time)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="aecm-torch",
        description="WebRTC-AECM echo cancellation on the PyTorch/CUDA "
                    "port: far (echo) + near (mic) WAV in, cleaned WAV "
                    "out.")
    p.add_argument("far_file", nargs="?",
                   help="far-end (loudspeaker/echo) WAV")
    p.add_argument("near_file", nargs="?",
                   help="near-end (microphone) WAV")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: <near>_out.wav)")
    p.add_argument("--echo-mode", type=int, default=1, choices=range(5),
                   help="suppression aggressiveness 0-4 (default 1, as the "
                        "reference demo)")
    p.add_argument("--no-cng", action="store_true",
                   help="disable comfort-noise generation")
    p.add_argument("--ms-in-sndcard-buf", type=int, default=40,
                   help="reported sound-card buffer delay in ms (default 40)")
    p.add_argument("--erle", action="store_true",
                   help="print ERLE (dB) of the processed file")
    p.add_argument("--batch", metavar="LIST",
                   help="process many pairs concurrently through one "
                        "batched pipeline: LIST is a text file with one "
                        "'far.wav near.wav [out.wav]' triple per line; the "
                        "positional far/near arguments are ignored")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch versions)")
    args = p.parse_args(argv)

    from .. import _device
    try:
        device = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.batch:
        return _run_batch(args, device)
    if not args.far_file or not args.near_file:
        p.error("far_file and near_file are required (or use --batch)")

    from .wav import read_wav_int16, write_wav_int16
    from .metrics import erle_db

    near, rate = read_wav_int16(args.near_file)
    far, far_rate = read_wav_int16(args.far_file)
    if rate != far_rate:
        print(f"error: near ({rate} Hz) and far ({far_rate} Hz) sample "
              "rates differ", file=sys.stderr)
        return 2
    if rate not in (8000, 16000):
        print(f"error: unsupported sample rate {rate} (AECM supports "
              "8000/16000 Hz)", file=sys.stderr)
        return 2

    t0 = time.monotonic()
    out = _process_pair(far, near, rate, args.echo_mode,
                        0 if args.no_cng else 1, args.ms_in_sndcard_buf,
                        device)
    elapsed = time.monotonic() - t0

    out_path = args.out or _out_path(args.near_file)
    write_wav_int16(out_path, out, rate)
    audio_s = len(near) / rate
    print(f"time interval: {int(elapsed * 1000)} ms "
          f"({audio_s / max(elapsed, 1e-9):.1f}x real time)")
    if args.erle:
        print(f"ERLE: {erle_db(near, out, far):.2f} dB")
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

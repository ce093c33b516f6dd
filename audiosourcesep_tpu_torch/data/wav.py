"""WAV read/write + resampling with numpy and scipy.

A copy of ``audiosourcesep_tpu/data/wav.py``: that module is numpy-only,
but importing it runs the JAX package's ``__init__``, which imports JAX.
RIFF/WAVE PCM and float formats are parsed directly with numpy, and
resampling uses a polyphase filter (scipy), in place of librosa/soundfile.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> (float32 samples in [-1, 1], sample_rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/64, any channel count.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    fmt_ext = b""
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_ext = body[16:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the real format is the first 2 bytes of the SubFormat GUID in the
        # fmt extension (cbSize[2] + validBits[2] + channelMask[4] + GUID);
        # guessing from the bit depth misreads 32-bit-int-PCM as float
        if len(fmt_ext) < 24:
            raise ValueError(
                f"{path}: extensible WAVE without a SubFormat GUID")
        audio_format = struct.unpack("<H", fmt_ext[8:10])[0]
        if audio_format not in (1, 3):
            raise ValueError(
                f"{path}: unsupported extensible sub-format {audio_format}")

    if audio_format == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            val = (b[:, 0].astype(np.int32)
                   | (b[:, 1].astype(np.int32) << 8)
                   | (b[:, 2].astype(np.int32) << 16))
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8"
                          ).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAVE format {audio_format}")

    if n_channels > 1:
        x = x.reshape(-1, n_channels)
        if mono:
            x = x.mean(axis=1)
    return x, sample_rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int,
              subtype: str = "pcm16") -> None:
    """Write mono/stereo float audio as PCM16 (soundfile default) or float32."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        n_channels = 1
    else:
        n_channels = audio.shape[1]
    if subtype == "pcm16":
        fmt_code, bits = 1, 16
        payload = np.clip(np.round(audio * 32768.0), -32768,
                          32767).astype("<i2").tobytes()
    elif subtype == "float32":
        fmt_code, bits = 3, 32
        payload = audio.astype("<f4").tobytes()
    else:
        raise ValueError("subtype should be 'pcm16' or 'float32'")

    byte_rate = sample_rate * n_channels * bits // 8
    block_align = n_channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_code, n_channels,
                            sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy.signal.resample_poly; equivalent in
    quality to librosa's default kaiser_best path for these rates)."""
    if orig_sr == target_sr:
        return audio
    # imported here: scipy.signal takes seconds to import, and only a
    # resampling load needs it
    from scipy.signal import resample_poly
    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    return resample_poly(audio, frac.numerator, frac.denominator
                         ).astype(np.float32)


def load_audio(path: str, sr: Optional[int] = None,
               mono: bool = True) -> Tuple[np.ndarray, int]:
    """librosa.core.load equivalent: read + optional resample to ``sr``."""
    x, orig_sr = read_wav(path, mono=mono)
    if sr is not None and sr != orig_sr:
        x = resample(x, orig_sr, sr)
        return x, sr
    return x, orig_sr

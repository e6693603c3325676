"""Container-agnostic audio decode for the serving path (the port's copy of
the reference package's ``audio/decode.py``).

WAV goes through the RIFF parser in ``audio/wavio.py``; anything else is
decoded by ffmpeg to a temporary float WAV at its original sample rate and
channel count (resampling and downmix stay the caller's, as with
``torchaudio.load``). Without ffmpeg a non-WAV file raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Tuple

import numpy as np

from synthetic_audio_detection_tpu_torch.audio import wavio


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode an audio file → (waveform [C, T] float32, sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return wavio.read_wav(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if not have_ffmpeg():
        raise RuntimeError(
            f"{path}: decoding {ext or 'extension-less'} audio requires "
            "ffmpeg (not installed); install ffmpeg or convert to WAV.")
    fd, tmp = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    try:
        # float WAV, so 24-bit and float sources keep their precision
        res = subprocess.run(
            ["ffmpeg", "-loglevel", "error", "-y", "-i", path, "-c:a", "pcm_f32le", tmp],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{path}: ffmpeg decode failed: {res.stderr.strip()}")
        return wavio.read_wav(tmp)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass

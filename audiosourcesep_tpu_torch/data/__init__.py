"""Audio IO and the separation front end."""

from .loaders import get_song_extract, load_wav
from .wav import load_audio, read_wav, resample, write_wav

__all__ = ["get_song_extract", "load_wav", "load_audio", "read_wav",
           "resample", "write_wav"]

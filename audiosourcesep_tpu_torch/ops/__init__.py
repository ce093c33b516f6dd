"""Ops: the Winograd conv kernels and the audio front end (the names of
``audiosourcesep_tpu.ops``; its split complex transfer
``as_device_complex`` is a TPU workaround the port does not need)."""
from .stft import stft, istft, hann_window, frame_signal
from .mel import (mel_filterbank, linear_to_mel_weight_matrix, power_to_db,
                  db_to_power, hz_to_mel_slaney, mel_to_hz_slaney,
                  hz_to_mel_htk, mel_to_hz_htk)
from .spectrogram import (melspectrogram, melspectrogram_tf_signal,
                          db_limits_to_power)
from .inversion import (mel_to_stft, griffin_lim, mel_to_audio,
                        single_channel_wiener_filter, phase_reuse,
                        invert_melspec_reuse_phase)

__all__ = [
    "stft", "istft", "hann_window", "frame_signal",
    "mel_filterbank", "linear_to_mel_weight_matrix", "power_to_db",
    "db_to_power", "hz_to_mel_slaney", "mel_to_hz_slaney", "hz_to_mel_htk",
    "mel_to_hz_htk",
    "melspectrogram", "melspectrogram_tf_signal", "db_limits_to_power",
    "mel_to_stft", "griffin_lim", "mel_to_audio",
    "single_channel_wiener_filter", "phase_reuse",
    "invert_melspec_reuse_phase",
]

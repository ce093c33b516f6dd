"""Audio IO, TFRecord IO, datasets and the separation front end."""

from .loaders import (ArrayDataset, get_mixture_toydata, get_song_extract,
                      load_melspec_ds, load_multiple_wav, load_spec,
                      load_spec_tf, load_toydata, load_wav,
                      save_mel_spectrograms)
from .tfrecord import (load_tf_records, masked_crc32c, parse_example,
                       read_records, save_tf_records, serialize_example,
                       write_records)
from .wav import load_audio, read_wav, resample, write_wav

__all__ = ["ArrayDataset", "get_mixture_toydata", "get_song_extract",
           "load_melspec_ds", "load_toydata",
           "load_multiple_wav", "load_spec", "load_spec_tf", "load_wav",
           "save_mel_spectrograms", "load_tf_records", "masked_crc32c",
           "parse_example", "read_records", "save_tf_records",
           "serialize_example", "write_records", "load_audio", "read_wav",
           "resample", "write_wav"]

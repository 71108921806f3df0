"""The Musicologist on the device: STFT, mel and feature extraction, the
mood CNN, and the brief (port of ``ame_tpu/analysis``)."""

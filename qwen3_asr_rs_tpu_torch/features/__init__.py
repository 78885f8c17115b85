"""Log-mel frontend."""

from .mel import LogMelFrontend, create_mel_filterbank, num_mel_frames

__all__ = ["LogMelFrontend", "create_mel_filterbank", "num_mel_frames"]

from .engine import AsrEngine, TranscribeResult
from .prompt import build_prompt, parse_asr_output

__all__ = ["AsrEngine", "TranscribeResult", "build_prompt", "parse_asr_output"]

"""Chat-template prompt construction and output parsing.

Token-exact with the reference (src/inference.rs:215-257 for the prompt,
:276-313 for parsing). The prompt is:

    <|im_start|> system \n <|im_end|> \n <|im_start|> user \n
    <|audio_start|> <|audio_pad|> x N <|audio_end|> <|im_end|> \n
    <|im_start|> assistant \n [ "language {Lang}" when forced ]

Audio pad positions always begin at index 9 (AUDIO_OFFSET) — the engine's
embedding-injection step relies on that static offset.
"""

from __future__ import annotations

from typing import Optional

from ..tokenizer import (
    ASSISTANT_TOKEN_ID,
    AUDIO_END_TOKEN_ID,
    AUDIO_PAD_TOKEN_ID,
    AUDIO_START_TOKEN_ID,
    IM_END_TOKEN_ID,
    IM_START_TOKEN_ID,
    NEWLINE_TOKEN_ID,
    SYSTEM_TOKEN_ID,
    USER_TOKEN_ID,
)

PROMPT_HEADER = [
    IM_START_TOKEN_ID,   # <|im_start|>
    SYSTEM_TOKEN_ID,     # system
    NEWLINE_TOKEN_ID,    # \n
    IM_END_TOKEN_ID,     # <|im_end|>
    NEWLINE_TOKEN_ID,    # \n
    IM_START_TOKEN_ID,   # <|im_start|>
    USER_TOKEN_ID,       # user
    NEWLINE_TOKEN_ID,    # \n
    AUDIO_START_TOKEN_ID,  # <|audio_start|>
]

PROMPT_TAIL = [
    AUDIO_END_TOKEN_ID,  # <|audio_end|>
    IM_END_TOKEN_ID,     # <|im_end|>
    NEWLINE_TOKEN_ID,    # \n
    IM_START_TOKEN_ID,   # <|im_start|>
    ASSISTANT_TOKEN_ID,  # assistant
    NEWLINE_TOKEN_ID,    # \n
]

AUDIO_OFFSET = len(PROMPT_HEADER)  # == 9


def build_prompt(
    num_audio_tokens: int,
    language: Optional[str] = None,
    tokenizer=None,
) -> list[int]:
    """Token id sequence with ``num_audio_tokens`` audio pads at offset 9."""
    tokens = list(PROMPT_HEADER)
    tokens.extend([AUDIO_PAD_TOKEN_ID] * num_audio_tokens)
    tokens.extend(PROMPT_TAIL)
    if language is not None:
        if tokenizer is None:
            raise ValueError("forcing a language requires a tokenizer")
        tokens.extend(tokenizer.encode(f"language {capitalize_first(language)}"))
    return tokens


def capitalize_first(s: str) -> str:
    return s[:1].upper() + s[1:] if s else s


def parse_asr_output(raw: str, language_forced: bool) -> tuple[str, str]:
    """Split model output into (language, text).

    Mirrors src/inference.rs:276-305: forced -> ("forced", raw);
    otherwise expect "language {lang}<asr_text>{text}", falling back to the
    first non-alphabetic boundary, else ("unknown", raw).
    """
    if language_forced:
        return "forced", raw.strip()

    raw = raw.strip()
    if raw.startswith("language "):
        rest = raw[len("language "):]
        marker = "<asr_text>"
        pos = rest.find(marker)
        if pos != -1:
            return rest[:pos].strip(), rest[pos + len(marker):].strip()
        lang_end = 0
        for i, c in enumerate(rest):
            if c.isspace() or not c.isalpha():
                lang_end = i
                break
            lang_end = i + 1
        if lang_end > 0:
            return rest[:lang_end], rest[lang_end:].strip()

    return "unknown", raw

# A copy of qwen3_asr_rs_tpu/tokenizer.py: the port keeps its own, so that it imports nothing of the JAX package.
"""Tokenizer wrapper around HuggingFace ``tokenizer.json``.

Mirrors the reference contract (src/tokenizer.rs): load tokenizer.json from
the model directory (with an actionable error message when absent), encode
text, decode ids skipping special tokens. Special token IDs are the fixed
Qwen3-ASR vocabulary ids (src/tokenizer.rs:53-59).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

# Special token IDs for Qwen3-ASR (src/tokenizer.rs:53-59)
IM_START_TOKEN_ID = 151644
IM_END_TOKEN_ID = 151645
ENDOFTEXT_TOKEN_ID = 151643
AUDIO_START_TOKEN_ID = 151669
AUDIO_END_TOKEN_ID = 151670
AUDIO_PAD_TOKEN_ID = 151676
ASR_TEXT_TOKEN_ID = 151704

# Plain-vocab ids used in the chat template (src/inference.rs:220-254)
SYSTEM_TOKEN_ID = 8948
USER_TOKEN_ID = 872
ASSISTANT_TOKEN_ID = 77091
NEWLINE_TOKEN_ID = 198

EOS_TOKEN_IDS = (ENDOFTEXT_TOKEN_ID, IM_END_TOKEN_ID)


class AsrTokenizer:
    """HF tokenizers-backed encode/decode."""

    def __init__(self, tokenizer):
        self._tok = tokenizer

    @classmethod
    def from_dir(cls, model_dir: str | Path) -> "AsrTokenizer":
        model_dir = Path(model_dir)
        path = model_dir / "tokenizer.json"
        if not path.exists():
            from .errors import TokenizerError

            raise TokenizerError(
                f"tokenizer.json not found in {model_dir}. Generate it with:\n"
                f'  python -c "from transformers import AutoTokenizer; '
                f"tok = AutoTokenizer.from_pretrained('{model_dir}', "
                f"trust_remote_code=True); "
                f"tok.backend_tokenizer.save('{model_dir}/tokenizer.json')\""
            )
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(str(path)))

    def encode(self, text: str) -> list[int]:
        return list(self._tok.encode(text, add_special_tokens=False).ids)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=True)

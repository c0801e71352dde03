"""Tokenizer access: HF tokenizer from a local dir, byte-level fallback.

Counterpart of dnet_tpu/utils/tokenizer.py: `transformers.AutoTokenizer`
when tokenizer files exist locally (imported only then), otherwise a
self-contained byte-level tokenizer (vocab 256 + BOS/EOS).  Both expose
encode / decode / chat template / eos_token_ids, plus an incremental
`Detokenizer` for SSE streaming.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence


class ByteTokenizer:
    """Byte-level tokenizer: token = byte value; 256=BOS, 257=EOS."""

    vocab_size = 258
    bos_token_id = 256
    eos_token_id = 257

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    @property
    def eos_token_ids(self) -> set[int]:
        return {self.eos_token_id}

    def apply_chat_template(self, messages: List[dict], add_generation_prompt: bool = True) -> str:
        parts = [f"<|{m['role']}|>\n{m['content']}" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "\n".join(parts)


class HFTokenizer:
    """Thin wrapper over transformers.AutoTokenizer (local files only)."""

    def __init__(self, model_dir: str | Path):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(str(model_dir), local_files_only=True)
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    @property
    def eos_token_ids(self) -> set[int]:
        ids = set()
        if self._tok.eos_token_id is not None:
            ids.add(int(self._tok.eos_token_id))
        extra = getattr(self._tok, "additional_eos_token_ids", None)
        if extra:
            ids.update(int(i) for i in extra)
        return ids

    def apply_chat_template(self, messages: List[dict], add_generation_prompt: bool = True) -> str:
        if getattr(self._tok, "chat_template", None):
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=add_generation_prompt
            )
        parts = [f"<|{m['role']}|>\n{m['content']}" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "\n".join(parts)


def load_tokenizer(model_dir: Optional[str | Path]):
    """HF tokenizer if the dir has tokenizer files, else ByteTokenizer.

    Tokenizer files that fail to load are an error: byte-encoding against a
    real model's vocab would corrupt every request.
    """
    if model_dir:
        d = Path(model_dir)
        if any(
            (d / f).is_file()
            for f in ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")
        ):
            return HFTokenizer(d)
    return ByteTokenizer()


class Detokenizer:
    """Incremental detokenizer for SSE streaming: feed token ids, get text
    deltas, holding back bytes that may be a partial multi-byte char."""

    TAIL = 16  # ids kept in the working window (enough for any multi-byte char run)
    HARD_CAP = 128  # force-finalize beyond this: the window must stay bounded

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []  # working tail window only
        self._done = ""  # text already finalized out of the window
        self._emitted_len = 0  # chars emitted so far (over done + window text)

    def add(self, token_id: int) -> str:
        self._ids.append(int(token_id))
        window_text = None
        if len(self._ids) > 2 * self.TAIL:
            # finalize the head of the window at a boundary whose remainder
            # decodes to a literal suffix of the in-context text (a boundary
            # inside a multi-byte char fails that check; a char spans <= 4
            # ids, so one of several consecutive boundaries is clean)
            full = self._tok.decode(self._ids)
            limit = len(self._ids) - self.TAIL
            over_cap = len(self._ids) > self.HARD_CAP
            tries = range(self.TAIL, limit if over_cap else min(self.TAIL + 4, limit))
            for j in tries:
                rest_text = self._tok.decode(self._ids[j:])
                if rest_text and full.endswith(rest_text):
                    self._done += full[: len(full) - len(rest_text)]
                    self._ids = self._ids[j:]
                    window_text = rest_text
                    break
            else:
                window_text = full
                if over_cap:
                    self._done += full
                    self._ids = []
                    window_text = ""
        if window_text is None:
            window_text = self._tok.decode(self._ids)
        if window_text.endswith("�"):
            window_text = window_text[:-1]
        total = self._done + window_text
        delta = total[self._emitted_len:]
        if delta:
            self._emitted_len = len(total)
        return delta

    def flush(self) -> str:
        total = self._done + self._tok.decode(self._ids)
        delta = total[self._emitted_len:]
        self._emitted_len = len(total)
        return delta

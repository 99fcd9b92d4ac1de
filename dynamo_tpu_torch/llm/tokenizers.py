"""Byte-level tokenizer with incremental decode.

Port of the `ByteTokenizer` and `DecodeStream` of
`dynamo_tpu/llm/tokenizers.py` (the default served tokenizer; the HF and
GGUF backends belong to the preprocessor slice).
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class DecodeStream:
    """Incremental detokenizer: feed token ids one at a time, get text deltas
    that are valid UTF-8 and stable (reference DecodeStream in tokenizers.rs).

    Implementation: keep a window of undecoded ids; a delta is emitted when
    decoding the window extends the previously yielded text and ends outside
    a UTF-8 replacement char (pending multi-byte sequences stay buffered).
    """

    def __init__(self, tokenizer: "ByteTokenizer", skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip = skip_special_tokens
        self._ids: List[int] = []
        self._prefix_text = ""
        self._prefix_index = 0

    def step(self, token_id: int) -> Optional[str]:
        return self.step_batch([token_id])

    def step_batch(self, token_ids: Sequence[int]) -> Optional[str]:
        """Feed a whole delta batch with ONE tokenizer decode call.

        Equivalent to concatenating `step()` deltas for the same ids:
        decode is prefix-stable (decoding more ids only extends the text),
        so the joined delta is identical — this is what makes engine-side
        emit batching free for the detokenizer instead of K× cost."""
        if not token_ids:
            return None
        self._ids.extend(token_ids)
        text = self._tok.decode(self._ids[self._prefix_index :], self._skip)
        # withhold the trailing pending-multibyte run (replacement chars):
        # those bytes stay buffered until later tokens complete them; the
        # decodable prefix before the run IS stable and emits now
        emit_upto = len(text)
        while emit_upto > 0 and text[emit_upto - 1] == "�":
            emit_upto -= 1
        stable = text[:emit_upto]
        if len(stable) <= len(self._prefix_text):
            # no new visible text yet (special token skipped / all pending)
            return None
        delta = stable[len(self._prefix_text) :]
        # slide the window to bound cost — only when nothing is pending,
        # so buffered partial bytes keep decoding against their prefix
        if (
            emit_upto == len(text)
            and len(self._ids) - self._prefix_index > 16
            and delta
        ):
            self._prefix_index = len(self._ids)
            self._prefix_text = ""
        else:
            self._prefix_text = stable
        return delta or None

    def snapshot(self) -> tuple:
        """Cheap state capture for replay (stop-string hit attribution:
        llm/backend.py re-steps a batch per-token to find the hit index)."""
        return (len(self._ids), self._prefix_text, self._prefix_index)

    def restore(self, state: tuple) -> None:
        n_ids, prefix_text, prefix_index = state
        del self._ids[n_ids:]
        self._prefix_text = prefix_text
        self._prefix_index = prefix_index


class ByteTokenizer:
    """Byte-level tokenizer: token id = byte value + 3 specials.

    ids: 0=PAD, 1=BOS, 2=EOS, 3..258 = bytes 0..255. Deterministic, needs no
    assets; round-trips arbitrary UTF-8. Vocab padded to 32000 by default so
    model shapes look realistic; ids in the padded region decode to a
    distinct printable placeholder (U+0100 + id) rather than disappearing —
    silently dropping generated tokens would make a stream look stalled
    (and break token accounting for any client counting content chunks).
    """

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3
    PLACEHOLDER_BASE = 0x100  # Latin Extended-A onward: printable, 1 char/id

    def __init__(self, vocab_size: int = 32000):
        self._vocab_size = max(vocab_size, 256 + self.OFFSET)

    def encode(self, text: str) -> List[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        parts: List[str] = []
        run: List[int] = []  # pending byte-range ids

        def flush():
            if run:
                parts.append(bytes(run).decode("utf-8", errors="replace"))
                run.clear()

        for i in ids:
            if self.OFFSET <= i < self.OFFSET + 256:
                run.append(i - self.OFFSET)
            elif i >= self.OFFSET + 256:
                flush()
                cp = self.PLACEHOLDER_BASE + (i - self.OFFSET - 256)
                if cp >= 0xD800:
                    # skip the UTF-16 surrogate block: chr() there makes a
                    # lone surrogate that no JSON/UTF-8 serializer accepts
                    # (a 128k-vocab id sampled into it crashed the SSE
                    # stream serializer mid-benchmark)
                    cp += 0x800
                parts.append(chr(cp))
            # specials (PAD/BOS/EOS) are always dropped
        flush()
        return "".join(parts)

    def decode_stream(self, skip_special_tokens: bool = True) -> DecodeStream:
        return DecodeStream(self, skip_special_tokens)

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    @property
    def eos_token_ids(self) -> List[int]:
        return [self.EOS]

    @property
    def bos_token_id(self) -> Optional[int]:
        return self.BOS

"""Tokenizers with incremental decode.

Port of `dynamo_tpu/llm/tokenizers.py`: `ByteTokenizer` (the default
served tokenizer), `GgufTokenizer` (a .gguf file's embedded vocabulary),
`DecodeStream` and `load_tokenizer`. An HF `tokenizer.json` needs the
`tokenizers` package, which the port does not use: `load_tokenizer`
refuses one with `UnsupportedConfigError`.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union


class DecodeStream:
    """Incremental detokenizer: feed token ids one at a time, get text deltas
    that are valid UTF-8 and stable (reference DecodeStream in tokenizers.rs).

    Implementation: keep a window of undecoded ids; a delta is emitted when
    decoding the window extends the previously yielded text and ends outside
    a UTF-8 replacement char (pending multi-byte sequences stay buffered).
    """

    def __init__(self, tokenizer, skip_special_tokens: bool = True):
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


class GgufTokenizer:
    """Tokenizer over a GGUF file's embedded vocabulary (reference
    gguf_tokenizer.rs): greedy longest-match over the token list, with the
    llama.cpp `▁`-for-space convention. Enough for serving a .gguf model
    card end-to-end without external tokenizer files."""

    SPACE = "\u2581"  # '▁'

    def __init__(self, gguf_path: str):
        from .gguf import read_gguf

        g = read_gguf(gguf_path)
        tokens = g.tokens
        if not tokens:
            raise ValueError(f"{gguf_path}: no embedded tokenizer vocabulary")
        self._tokens = tokens
        self._ids = {t: i for i, t in enumerate(tokens)}
        self._max_len = max(len(t) for t in tokens)
        self._eos = [g.eos_token_id] if g.eos_token_id is not None else []
        self._bos = g.bos_token_id
        self._unk = 0 if tokens and tokens[0].startswith("<") else None

    def encode(self, text: str) -> List[int]:
        s = text.replace(" ", self.SPACE)
        out: List[int] = []
        i = 0
        while i < len(s):
            match = None
            for n in range(min(self._max_len, len(s) - i), 0, -1):
                tid = self._ids.get(s[i : i + n])
                if tid is not None:
                    match = (tid, n)
                    break
            if match is None:
                if self._unk is not None:
                    out.append(self._unk)
                i += 1
            else:
                out.append(match[0])
                i += match[1]
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        parts = []
        for i in ids:
            if 0 <= i < len(self._tokens):
                t = self._tokens[i]
                if skip_special_tokens and t.startswith("<") and t.endswith(">"):
                    continue
                parts.append(t)
        return "".join(parts).replace(self.SPACE, " ")

    def decode_stream(self, skip_special_tokens: bool = True) -> DecodeStream:
        return DecodeStream(self, skip_special_tokens)

    @property
    def vocab_size(self) -> int:
        return len(self._tokens)

    @property
    def eos_token_ids(self) -> List[int]:
        return list(self._eos)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._bos


def load_tokenizer(spec: str) -> Union[ByteTokenizer, GgufTokenizer]:
    """Resolve a tokenizer spec: 'byte' | 'byte:<vocab>' | 'gguf:<path>'
    (embedded vocab). A path to a tokenizer.json (or a folder holding one)
    raises UnsupportedConfigError: the port reads no HF tokenizer."""
    if spec == "byte":
        return ByteTokenizer()
    if spec.startswith("byte:"):
        return ByteTokenizer(int(spec.split(":", 1)[1]))
    if spec.startswith("gguf:"):
        return GgufTokenizer(spec.split(":", 1)[1])
    p = Path(spec)
    if p.is_dir():
        p = p / "tokenizer.json"
    if p.exists():
        from ..engine.config import UnsupportedConfigError

        raise UnsupportedConfigError(
            f"{p}: HF tokenizer.json files are not read by the PyTorch/CUDA port "
            "(it does not use the `tokenizers` package); serve with 'byte' or a "
            ".gguf checkpoint's embedded vocabulary"
        )
    raise FileNotFoundError(f"no tokenizer at {spec!r} (use 'byte' for the builtin)")

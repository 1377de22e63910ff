"""Tokenizers for the serving engine.

Reference: ``agentainer_tpu/engine/tokenizer.py`` — an own copy. The default
is a self-contained byte-level tokenizer (any vocab ≥ 259 works; ids are
stable across runs, which matters because conversation state persists
across engine restarts). When a checkpoint directory carries a HuggingFace
``tokenizer.json`` the real BPE is used instead; the ``tokenizers`` package
is imported only then. Where it is missing (the machine with the card does
not have it) ``load_tokenizer`` raises: the byte tokenizer over real
weights would serve garbage.
"""

from __future__ import annotations

import os


class ByteTokenizer:
    """utf-8 bytes shifted by 3 specials: 0=pad, 1=bos, 2=eos."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _OFFSET = 3

    def __init__(self, vocab_size: int):
        if vocab_size < 256 + self._OFFSET:
            raise ValueError(f"vocab {vocab_size} too small for byte tokenizer")
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + self._OFFSET for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        data = bytes(i - self._OFFSET for i in ids if i >= self._OFFSET and i - self._OFFSET < 256)
        return data.decode("utf-8", "replace")


class HFTokenizer:
    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()
        self.pad_id = 0
        self.bos_id = self._tok.token_to_id("<|begin_of_text|>") or 1
        self.eos_id = self._tok.token_to_id("<|end_of_text|>") or 2

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text).ids
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode([i for i in ids if i not in (self.pad_id, self.bos_id, self.eos_id)])


def load_tokenizer(vocab_size: int, checkpoint: str = ""):
    if checkpoint:
        cand = os.path.join(checkpoint, "tokenizer.json")
        if os.path.isfile(cand):
            try:
                import tokenizers  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    f"{cand} needs the 'tokenizers' package, which is not installed; "
                    "install it to serve this checkpoint"
                ) from e
            return HFTokenizer(cand)
    return ByteTokenizer(vocab_size)

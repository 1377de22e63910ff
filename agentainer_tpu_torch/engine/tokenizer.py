"""Tokenizers for the serving engine.

Reference: ``agentainer_tpu/engine/tokenizer.py`` — an own copy. The default
is a self-contained byte-level tokenizer (any vocab ≥ 259 works; ids are
stable across runs, which matters because conversation state persists
across engine restarts). When a checkpoint directory carries a HuggingFace
``tokenizer.json`` the real BPE is used instead: the reference reads it
with the ``tokenizers`` package, which the machine with the card does not
have, so ``HFTokenizer`` here reads the file itself, on the standard
library, for two families: the byte-level BPE that Llama-3 publishes,

- ``normalizer`` null;
- ``pre_tokenizer`` ``Sequence[Split(LLAMA3_SPLIT, "Isolated"),
  ByteLevel(add_prefix_space=false, use_regex=false)]``;
- ``model`` ``BPE`` (``ignore_merges`` either way, merges as ``"a b"``
  strings or ``[a, b]`` pairs, no dropout, unk, prefixes or byte fallback);
- ``added_tokens`` (no ``single_word``/``lstrip``/``rstrip``), split out of
  the text before pre-tokenizing;
- ``post_processor`` null, ``TemplateProcessing``, ``ByteLevel`` or a
  ``Sequence`` of those two;
- ``decoder`` ``ByteLevel``;

and the SentencePiece-style BPE that Mistral and Mixtral publish, in its
two forms:

- older: ``normalizer`` ``Sequence[Prepend("▁"), Replace(" ", "▁")]`` and
  no pre-tokenizer; newer: no normalizer and ``pre_tokenizer``
  ``Metaspace(replacement "▁", split false)`` with any ``prepend_scheme``
  ("first" prepends "▁" only to text at offset 0 of the input, never to a
  segment after an added token);
- ``model`` ``BPE`` with ``byte_fallback`` (a character outside the
  vocabulary becomes its utf-8 bytes' ``<0xNN>`` tokens, or ``unk_token``
  where one of those is missing) and ``fuse_unk`` either way;
- ``added_tokens`` as above, none of them ``normalized``: every segment
  between two added tokens is normalized (or pre-tokenized) on its own, so
  under the older form each non-empty one gets its own "▁";
- ``post_processor`` as above;
- ``decoder`` ``Sequence[Replace("▁", " "), ByteFallback, Fuse, Strip(" ",
  1, 0)]``: byte tokens are joined and decoded as utf-8 (a run that is not
  valid utf-8 gives one U+FFFD per byte), then one leading space goes.

Its ids, text and special ids equal the reference's ``HFTokenizer`` over
``tokenizers`` (``tests/test_torch_tokenizer.py``). Any other component
raises ``NotImplementedError`` naming it and the file: the byte tokenizer
over real weights would serve garbage, so nothing falls back to it.

The split pattern's ``\\p{L}``/``\\p{N}`` are not in Python's ``re`` (and the
machine with the card has no ``regex`` package), so ``_llama3_split`` is a
hand-written scanner over ``unicodedata`` that follows the pattern
alternative by alternative, as the backtracking engine ``tokenizers`` runs
it (Oniguruma) matches it. Both classify characters by their Unicode
tables: a character assigned in a newer Unicode than Python's
``unicodedata.unidata_version`` is a letter there and unassigned here.
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import re
import unicodedata


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


# Llama-3's pre-tokenizer split, as its tokenizer.json spells it
LLAMA3_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

# the pattern's classes: \s (Oniguruma's Unicode whitespace: \t-\r, NEL and
# the Zs/Zl/Zp categories), \p{L}, \p{N}
_SPACE, _LETTER, _NUMBER, _OTHER = range(4)
_NEWLINES = "\r\n"
# (?i:...) folds: 's' also matches U+017F LATIN SMALL LETTER LONG S
_CONTRACTIONS = (("sSſ",), ("tT",), ("rR", "eE"), ("vV", "eE"), ("mM",), ("lL", "lL"), ("dD",))


@functools.lru_cache(maxsize=65536)
def _klass(c: str) -> int:
    cat = unicodedata.category(c)
    if cat[0] == "L":
        return _LETTER
    if cat[0] == "N":
        return _NUMBER
    if cat in ("Zs", "Zl", "Zp") or c in "\t\n\x0b\x0c\r\x85":
        return _SPACE
    return _OTHER


def _llama3_split(text: str) -> list[str]:
    """``text`` cut at the matches of ``LLAMA3_SPLIT`` ("Isolated": every
    match is a piece; the pattern matches at every position, so there are
    no gaps). At each position the alternatives are tried in order and the
    first that matches wins, with its greedy length."""
    n = len(text)
    k = [_klass(c) for c in text]
    out = []
    i = 0
    while i < n:
        out.append(text[i : (i := _match_at(text, k, i, n))])
    return out


def _match_at(s: str, k: list[int], i: int, n: int) -> int:
    """The end of the pattern's match at ``i``."""
    c = s[i]
    # (?i:'s|'t|'re|'ve|'m|'ll|'d)
    if c == "'":
        for alt in _CONTRACTIONS:
            if i + len(alt) < n and all(s[i + 1 + j] in ch for j, ch in enumerate(alt)):
                return i + 1 + len(alt)
    # [^\r\n\p{L}\p{N}]?\p{L}+
    j = i
    if k[i] != _LETTER and k[i] != _NUMBER and c not in _NEWLINES and i + 1 < n and k[i + 1] == _LETTER:
        j = i + 1
    if k[j] == _LETTER:
        while j < n and k[j] == _LETTER:
            j += 1
        return j
    # \p{N}{1,3}
    if k[i] == _NUMBER:
        j = i
        while j < n and j < i + 3 and k[j] == _NUMBER:
            j += 1
        return j
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    j = i + 1 if c == " " and i + 1 < n and k[i + 1] == _OTHER else i
    if k[j] == _OTHER:
        while j < n and k[j] == _OTHER:
            j += 1
        while j < n and s[j] in _NEWLINES:
            j += 1
        return j
    # the rest start at whitespace: its maximal run is s[i:end]
    end = i
    while end < n and k[end] == _SPACE:
        end += 1
    # \s*[\r\n]+: up to the run's last newline
    last = max((m for m in range(i, end) if s[m] in _NEWLINES), default=-1)
    if last >= 0:
        return last + 1
    # \s+(?!\S): the run, less its last character when a non-space follows
    if end == n:
        return end
    if end - 1 > i:
        return end - 1
    # \s+
    return end


@functools.cache
def _byte_chars() -> list[str]:
    """GPT-2's byte-level alphabet: byte b -> a printable character."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    chars = {b: chr(b) for b in keep}
    extra = 0
    for b in range(256):
        if b not in chars:
            chars[b] = chr(256 + extra)
            extra += 1
    return [chars[b] for b in range(256)]


@functools.cache
def _char_bytes() -> dict[str, int]:
    return {c: b for b, c in enumerate(_byte_chars())}


# the SentencePiece-style family's components, as tokenizer.json spells them
_SP = "\u2581"
_SP_NORMALIZER = {
    "type": "Sequence",
    "normalizers": [
        {"type": "Prepend", "prepend": _SP},
        {"type": "Replace", "pattern": {"String": " "}, "content": _SP},
    ],
}
_SP_DECODER = {
    "type": "Sequence",
    "decoders": [
        {"type": "Replace", "pattern": {"String": _SP}, "content": " "},
        {"type": "ByteFallback"},
        {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0},
    ],
}
_BYTE_TOKEN = re.compile(r"<0x([0-9A-Fa-f]{2})>")


class HFTokenizer:
    """A ``tokenizer.json`` of Llama-3's family or of Mixtral's, read on the
    standard library (module docstring). ``encode``, ``decode``, ``vocab_size``,
    ``bos_id``, ``eos_id`` and ``pad_id`` are the reference's: ``encode``
    applies the file's post-processor (as ``tokenizers``' ``encode`` does
    by default) and then puts ``bos_id`` in front; ``decode`` leaves out
    pad, bos and eos, special tokens and ids the vocabulary lacks."""

    def __init__(self, path: str):
        self.path = path
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            self._unsupported("the document", type(doc).__name__)
        for key in ("truncation", "padding"):
            if doc.get(key) is not None:
                self._unsupported(key, doc[key])
        norm, pre = doc.get("normalizer"), doc.get("pre_tokenizer")
        # the family: SentencePiece-style when either of its two forms'
        # front ends is there, byte-level otherwise
        self._metaspace = norm == _SP_NORMALIZER or (
            isinstance(pre, dict) and pre.get("type") == "Metaspace"
        )
        if self._metaspace:
            self._read_metaspace(norm, pre)
        else:
            if norm is not None:
                self._unsupported("normalizer", norm)
            self._read_pre_tokenizer(pre)
        self._read_model(doc.get("model"))
        self._read_added(doc.get("added_tokens") or [])
        self._read_post_processor(doc.get("post_processor"))
        dec = doc.get("decoder")
        if self._metaspace and dec != _SP_DECODER:
            self._unsupported("decoder", dec)
        if not self._metaspace and (not isinstance(dec, dict) or dec.get("type") != "ByteLevel"):
            self._unsupported("decoder", dec)
        self.vocab_size = len(set(self._vocab) | set(self._added))
        self.pad_id = 0
        self.bos_id = self._token_to_id("<|begin_of_text|>") or 1
        self.eos_id = self._token_to_id("<|end_of_text|>") or 2

    def _unsupported(self, what: str, value) -> None:
        text = json.dumps(value)
        if len(text) > 200:
            text = text[:200] + "..."
        raise NotImplementedError(
            f"{self.path}: {what} {text} is not supported (this reader takes Llama-3's "
            "tokenizer.json family, byte-level BPE, and Mixtral's, SentencePiece-style BPE "
            "with byte fallback)"
        )

    # -- reading the file ---------------------------------------------------
    def _read_pre_tokenizer(self, pre) -> None:
        parts = pre.get("pretokenizers") if isinstance(pre, dict) and pre.get("type") == "Sequence" else None
        if not isinstance(parts, list) or len(parts) != 2:
            self._unsupported("pre_tokenizer", pre)
        split, byte_level = parts
        if (
            split.get("type") != "Split"
            or split.get("pattern") != {"Regex": LLAMA3_SPLIT}
            or split.get("behavior") != "Isolated"
            or split.get("invert", False)
        ):
            self._unsupported("pre_tokenizer", split)
        if (
            byte_level.get("type") != "ByteLevel"
            or byte_level.get("add_prefix_space", True)
            or byte_level.get("use_regex", True)
        ):
            self._unsupported("pre_tokenizer", byte_level)

    def _read_metaspace(self, norm, pre) -> None:
        """The SentencePiece-style front end: the older form's normalizer
        with no pre-tokenizer, or the newer form's ``Metaspace``
        pre-tokenizer with no normalizer."""
        if norm is not None:
            if pre is not None:
                self._unsupported("pre_tokenizer beside the Prepend/Replace normalizer", pre)
            self._prepend = "normalizer"
            return
        if pre.get("replacement") != _SP or pre.get("split", True):
            self._unsupported("pre_tokenizer", pre)
        self._prepend = pre.get("prepend_scheme", "always")
        if self._prepend not in ("always", "first", "never"):
            self._unsupported("pre_tokenizer", pre)

    def _read_model(self, model) -> None:
        if not isinstance(model, dict) or model.get("type") != "BPE":
            self._unsupported("model", {k: v for k, v in (model or {}).items() if k not in ("vocab", "merges")})
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key) is not None:
                self._unsupported(f"model.{key}", model[key])
        # byte fallback and an unknown token belong to the SentencePiece
        # style, and it has both
        if bool(model.get("byte_fallback", False)) != self._metaspace:
            self._unsupported("model.byte_fallback", model.get("byte_fallback", False))
        unk = model.get("unk_token")
        if (unk is None) == self._metaspace or (unk is not None and unk not in model["vocab"]):
            self._unsupported("model.unk_token", unk)
        self._unk = model["vocab"][unk] if unk is not None else None
        self._fuse_unk = bool(model.get("fuse_unk", False))
        self._ignore_merges = bool(model.get("ignore_merges", False))
        self._vocab: dict[str, int] = model["vocab"]
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        # (left id, right id) -> (rank, merged id)
        self._merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                self._merges[(self._vocab[a], self._vocab[b])] = (rank, self._vocab[a + b])
            except KeyError:
                raise ValueError(f"{self.path}: merge {m!r} names a token outside the vocabulary") from None

    def _read_added(self, added: list) -> None:
        """The added vocabulary, with the ids ``tokenizers`` gives it: a
        token the model's vocabulary holds keeps that id, any other takes
        the next id after the vocabulary (or after the last added id)."""
        self._added: dict[str, int] = {}
        self._added_ids: dict[int, str] = {}
        self._special: set[str] = set()
        split_first, split_after = [], []
        n_vocab = len(self._vocab)
        for tok in added:
            for opt in ("single_word", "lstrip", "rstrip"):
                if tok.get(opt, False):
                    self._unsupported(f"added token {tok.get('content')!r} option {opt}", True)
            if self._metaspace and tok.get("normalized", not tok.get("special", False)):
                # it would be matched in the normalized text
                self._unsupported(f"added token {tok.get('content')!r} option normalized", True)
            content = tok["content"]
            tid = self._token_to_id(content)
            if tid is None:
                top = max(self._added.values(), default=None)
                tid = n_vocab if top is None or (top < n_vocab and n_vocab > 0) else top + 1
            self._added[content] = tid
            self._added_ids[tid] = content
            special = bool(tok.get("special", False))
            if special:
                self._special.add(content)
            (split_after if tok.get("normalized", not special) else split_first).append(content)
        # special (non-normalized) tokens come out of the text first, then
        # the normalized ones from what is left; leftmost-longest each time
        self._splitters = [
            re.compile("|".join(re.escape(t) for t in sorted(toks, key=len, reverse=True)))
            for toks in (split_first, split_after)
            if toks
        ]

    def _read_post_processor(self, post) -> None:
        """The ids a single sequence gets around it: TemplateProcessing's
        ``single`` template; ByteLevel changes offsets only."""
        self._prefix: list[int] = []
        self._suffix: list[int] = []
        procs = post.get("processors") if isinstance(post, dict) and post.get("type") == "Sequence" else [post]
        for p in procs or []:
            if p is None or (isinstance(p, dict) and p.get("type") == "ByteLevel"):
                continue
            if not isinstance(p, dict) or p.get("type") != "TemplateProcessing":
                self._unsupported("post_processor", p)
            seen_a = False
            for piece in p.get("single", []):
                if "Sequence" in piece and piece["Sequence"].get("id") == "A" and not seen_a:
                    seen_a = True
                elif "SpecialToken" in piece:
                    ids = p.get("special_tokens", {})[piece["SpecialToken"]["id"]]["ids"]
                    (self._suffix if seen_a else self._prefix).extend(ids)
                else:
                    self._unsupported("post_processor single template", p.get("single"))
            if not seen_a:
                self._unsupported("post_processor single template", p.get("single"))

    def _token_to_id(self, token: str) -> int | None:
        tid = self._added.get(token)
        return tid if tid is not None else self._vocab.get(token)

    # -- encode -------------------------------------------------------------
    def _split_added(self, text: str) -> list[tuple[str, bool]]:
        pieces = [(text, False)]
        for splitter in self._splitters:
            out = []
            for piece, is_added in pieces:
                if is_added:
                    out.append((piece, True))
                    continue
                at = 0
                for m in splitter.finditer(piece):
                    if m.start() > at:
                        out.append((piece[at : m.start()], False))
                    out.append((m.group(), True))
                    at = m.end()
                if at < len(piece):
                    out.append((piece[at:], False))
            pieces = out
        return pieces

    def _symbols(self, word: str) -> list[int]:
        """A word's ids before any merge, as ``tokenizers``' ``merge_word``
        makes them: each character's token; under byte fallback a missing
        character's ``<0xNN>`` tokens, or else the unknown token (a missing
        character is dropped without byte fallback). The unknown token is
        held back until the next character found in the vocabulary or the
        word's end, so byte tokens in between come before it, and a run of
        unknowns held back together is one token with ``fuse_unk``."""
        if not self._metaspace:
            return [self._vocab[c] for c in word if c in self._vocab]
        ids: list[int] = []
        held = False
        for c in word:
            tid = self._vocab.get(c)
            if tid is not None:
                if held:
                    ids.append(self._unk)
                    held = False
                ids.append(tid)
                continue
            fallback = [self._vocab.get(f"<0x{b:02X}>") for b in c.encode("utf-8")]
            if None not in fallback:
                ids.extend(fallback)
            elif held and not self._fuse_unk:
                ids.append(self._unk)
            else:
                held = True
        if held:
            ids.append(self._unk)
        return ids

    def _bpe(self, word: str) -> list[int]:
        """One pre-tokenized word's ids: merges applied lowest rank first
        (leftmost on a tie), as ``tokenizers``' ``Word::merge_all``."""
        if self._ignore_merges and word in self._vocab:
            return [self._vocab[word]]
        ids = self._symbols(word)
        prev = list(range(-1, len(ids) - 1))
        nxt = list(range(1, len(ids) + 1))
        alive = [True] * len(ids)
        heap = []
        for pos in range(len(ids) - 1):
            m = self._merges.get((ids[pos], ids[pos + 1]))
            if m is not None:
                heap.append((m[0], pos, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= len(ids):
                continue
            right = nxt[pos]
            m = self._merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < len(ids):
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = self._merges.get((ids[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] < len(ids):
                m = self._merges.get((new_id, ids[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(ids, alive) if a]

    def _encode_text(self, text: str) -> list[int]:
        chars = _byte_chars()
        ids: list[int] = []
        for n, (piece, is_added) in enumerate(self._split_added(text)):
            if is_added:
                ids.append(self._added[piece])
            elif self._metaspace:
                # the whole segment is one word: spaces become "▁", and "▁"
                # goes in front: always under the older form's Prepend;
                # under Metaspace unless the word starts with one, and for
                # "first" only at the input's offset 0
                word = piece.replace(" ", _SP)
                if self._prepend == "normalizer" or (
                    not word.startswith(_SP)
                    and (self._prepend == "always" or (self._prepend == "first" and n == 0))
                ):
                    word = _SP + word
                ids.extend(self._bpe(word))
            else:
                for word in _llama3_split(piece):
                    ids.extend(self._bpe("".join(chars[b] for b in word.encode("utf-8"))))
        return ids


    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._prefix + self._encode_text(text) + self._suffix
        return ([self.bos_id] + ids) if add_bos else ids

    # -- decode -------------------------------------------------------------
    def decode(self, ids: list[int]) -> str:
        table = _char_bytes()
        out = bytearray()
        tokens = []
        for i in ids:
            if i in (self.pad_id, self.bos_id, self.eos_id):
                continue
            token = self._added_ids.get(i)
            if token is None:
                token = self._id_to_token.get(i)
            if token is None or token in self._special:
                continue
            tokens.append(token)
        if self._metaspace:
            return self._decode_metaspace(tokens)
        for token in tokens:
            if all(c in table for c in token):
                out.extend(table[c] for c in token)
            else:
                out.extend(token.encode("utf-8"))
        return out.decode("utf-8", "replace")

    @staticmethod
    def _decode_metaspace(tokens: list[str]) -> str:
        """The SentencePiece-style decoder chain: "▁" to " ", runs of byte
        tokens decoded as utf-8 (one U+FFFD per byte of a run that is not
        valid), everything joined, one leading space stripped."""
        parts: list[str] = []
        run = bytearray()
        n_run = 0

        def flush() -> None:
            nonlocal n_run
            if n_run:
                try:
                    parts.append(run.decode("utf-8"))
                except UnicodeDecodeError:
                    parts.append("\ufffd" * n_run)
                run.clear()
                n_run = 0

        for token in tokens:
            token = token.replace(_SP, " ")
            m = _BYTE_TOKEN.fullmatch(token)
            if m:
                run.append(int(m.group(1), 16))
                n_run += 1
                continue
            flush()
            parts.append(token)
        flush()
        text = "".join(parts)
        return text[1:] if text.startswith(" ") else text


def load_tokenizer(vocab_size: int, checkpoint: str = ""):
    if checkpoint:
        cand = os.path.join(checkpoint, "tokenizer.json")
        if os.path.isfile(cand):
            return HFTokenizer(cand)
    return ByteTokenizer(vocab_size)

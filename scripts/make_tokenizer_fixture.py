"""Write the ``tokenizer.json`` fixtures and their expected ids.

    python scripts/make_tokenizer_fixture.py [--check]

Trains ``tokenizers``' byte-level BPE on the repo's own text (``docs/*.md``,
which stays as it is, so a fresh training reproduces the files; nothing is
downloaded) with Llama-3's pipeline: its
split pattern and byte-level pre-tokenizer, ``ignore_merges``, the
``ByteLevel`` decoder, and its post-processor (``ByteLevel`` then a
``TemplateProcessing`` that puts ``<|begin_of_text|>`` in front). The two
specials ``<|begin_of_text|>`` and ``<|end_of_text|>`` are added after
training: ``tokenizers`` gives an added token the next id after the
vocabulary whatever id a file names (Llama-3's own file names 128000 and
128001 right after its 128,000-token vocabulary, so the rule is the same),
so here they sit at ``VOCAB`` and ``VOCAB + 1``.

Two more fixtures are of the SentencePiece-style BPE that Mistral and
Mixtral publish, trained on the same text: ``BPE(byte_fallback,
fuse_unk, unk_token "<unk>")`` with the specials ``<unk>``, ``<s>`` and
``</s>`` at ids 0-2, the byte tokens ``<0x00>``-``<0xEF>`` at ids 3-242
(``<0xF0>``-``<0xFF>`` are left out, so a four-byte character is
``<unk>``: Mixtral's file has all 256, and the reader must take both
cases), Mixtral's decoder ``Sequence[Replace("▁", " "), ByteFallback,
Fuse, Strip(" ", 1, 0)]`` and a ``TemplateProcessing`` that puts ``<s>``
in front. ``mixtral_style_tokenizer.json`` is the older form (normalizer
``Sequence[Prepend("▁"), Replace(" ", "▁")]``, no pre-tokenizer),
``mixtral_style_metaspace_tokenizer.json`` the newer one (no normalizer,
``Metaspace(prepend_scheme "first", split false)``).

Writes each fixture under ``tests/fixtures/`` and, beside it, its
``.expected.json``: for each of its strings the ids ``tokenizers`` gives
(post-processor included) and the text its ``decode`` gives back once pad,
bos and eos are left out (what the serving reader's ``decode`` returns),
with the ``tokenizers`` version and Python's ``unicodedata`` version.
``--check`` writes nothing and exits 1 unless a fresh training reproduces
every file. The port's reader is held to these
files on the card, where ``tokenizers`` is not installed (``chip_smoke.py``
phase 1c), and to ``tokenizers`` itself on the CPU
(``tests/test_torch_tokenizer.py``).
"""

from __future__ import annotations

import glob
import json
import os
import sys
import unicodedata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "llama3_style_tokenizer.json")
EXPECTED = os.path.join(FIXTURES, "llama3_style_tokenizer.expected.json")
VOCAB = 3000
SP_SPECIALS = ("<unk>", "<s>", "</s>")
SP_FORMS = ("mixtral_style", "mixtral_style_metaspace")
# byte tokens the SentencePiece-style fixtures leave out (module docstring)
SP_MISSING_BYTES = range(0xF0, 0x100)
SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>")
LLAMA3_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# contractions (either case, U+017F), digit runs of 1-4 and longer, CRLF and
# lone CR, trailing and runs of spaces, tabs, emoji (ZWJ sequences, flags,
# skin tones), CJK, combining marks, NBSP and other Unicode spaces, the
# specials inside text, a lone special, an empty string
STRINGS = (
    "Hello, world! I'm here; you're there, they've gone, we'll see, he'd know.",
    "IT'S THE 'S CASE: DON'T, WE'LL, I'D, THEY'RE, WE'VE, I'M; x'ſ 'S 'T",
    "1 22 333 4444 55555 123456789 3.14159 1e-9 v2.0.1 0x7fff",
    "line one\r\nline two\rline three\n\n\nend  ",
    "trailing spaces   ",
    "   leading spaces and\ttabs\t\there",
    "emoji 😀 👍🏽 👨‍👩‍👧‍👦 🇺🇸 ✔️ end",
    "中文字符和日本語のテキスト、한국어 텍스트。",
    "combining: é ä ñ ́alone, Zalgo z̶͓a̷",
    "spaces: a b c　d e  f g\x85h",
    "<|begin_of_text|>Hi there<|end_of_text|> and <|begin_of_text|>",
    "<|end_of_text|>",
    "",
    '{"tool": "search", "args": {"q": "agentainer", "n": 5}}\n',
    "def f(x):\n    return x ** 2  # square\n",
    "Ünïcödé ÀÉÎÕÜ ßẞ ﬁ ﬂ Ωμέγα Кириллица עברית العربية हिन्दी",
)


# the same strings with the SentencePiece specials, and the places its two
# forms differ: leading spaces, segments after a special, "▁" in the text
SP_STRINGS = tuple(
    t.replace("<|begin_of_text|>", "<s>").replace("<|end_of_text|>", "</s>") for t in STRINGS
) + (
    " leading space", "  two leading", "<s> after a special", "a</s>b<s> c<unk>d", "<unk>",
    "\u2581already \u2581marked", "tail </s>", "x\u00a0y\u3000z",
)


def sp_paths(form: str) -> tuple[str, str]:
    return (os.path.join(FIXTURES, f"{form}_tokenizer.json"),
            os.path.join(FIXTURES, f"{form}_tokenizer.expected.json"))


def corpus() -> list[str]:
    return sorted(glob.glob(os.path.join(ROOT, "docs", "*.md")))


def _expected(tok, strings, specials: dict, dropped: set) -> str:
    import tokenizers

    cases = []
    for s in strings:
        ids = tok.encode(s).ids
        cases.append({"text": s, "ids": ids, "decoded": tok.decode([i for i in ids if i not in dropped])})
    return json.dumps({
        "tokenizers": tokenizers.__version__,
        "unidata_version": unicodedata.unidata_version,
        "vocab_size": tok.get_vocab_size(),
        "specials": specials,
        "cases": cases,
    }, ensure_ascii=False, indent=1) + "\n"


def build_sp(form: str) -> tuple[str, str]:
    """A SentencePiece-style fixture of ``form`` and its expected ids."""
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(byte_fallback=True, unk_token="<unk>", fuse_unk=True))
    if form == "mixtral_style":
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("\u2581"), normalizers.Replace(" ", "\u2581")])
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="\u2581", prepend_scheme="first", split=False)
    tok.decoder = decoders.Sequence([
        decoders.Replace("\u2581", " "), decoders.ByteFallback(), decoders.Fuse(), decoders.Strip(" ", 1, 0),
    ])
    tok.train(corpus(), trainers.BpeTrainer(vocab_size=VOCAB, show_progress=False,
                                            special_tokens=list(SP_SPECIALS)))
    doc = json.loads(tok.to_str())
    # the byte tokens go right after the specials, as in Mixtral's file;
    # the trained tokens follow them
    nb = 256 - len(SP_MISSING_BYTES)
    vocab = {t: (i if i < len(SP_SPECIALS) else i + nb) for t, i in doc["model"]["vocab"].items()}
    for b in range(256):
        if b not in SP_MISSING_BYTES:
            vocab[f"<0x{b:02X}>"] = len(SP_SPECIALS) + b
    doc["model"]["vocab"] = dict(sorted(vocab.items(), key=lambda kv: kv[1]))
    doc["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                 {"SpecialToken": {"id": "<s>", "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}},
    }
    fixture = json.dumps(doc, ensure_ascii=False, separators=(",", ":")) + "\n"
    tok = Tokenizer.from_str(fixture)
    # the reference's decode leaves out ids 0, 1 and 2 first: <unk>, <s>, </s>
    return fixture, _expected(tok, SP_STRINGS, {s: tok.token_to_id(s) for s in SP_SPECIALS}, {0, 1, 2})


def build() -> tuple[str, str]:
    """The Llama-3-style fixture's text and the expected ids' text."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, processors, trainers

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=VOCAB, show_progress=False, initial_alphabet=pre_tokenizers.ByteLevel.alphabet()
    )
    tok.train(corpus(), trainer)
    tok.add_special_tokens(list(SPECIALS))
    bos = tok.token_to_id(SPECIALS[0])
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single=f"{SPECIALS[0]} $A", pair=f"{SPECIALS[0]} $A {SPECIALS[0]} $B:1",
            special_tokens=[(SPECIALS[0], bos)],
        ),
    ])
    fixture = json.dumps(json.loads(tok.to_str()), ensure_ascii=False, separators=(",", ":")) + "\n"
    tok = Tokenizer.from_str(fixture)
    # the serving reader's decode leaves out pad (0), bos and eos first, as
    # the reference's HFTokenizer does: in a byte-level vocabulary id 0 is
    # "!", so a lone "!" does not come back
    dropped = {0, bos, tok.token_to_id(SPECIALS[1])}
    return fixture, _expected(tok, STRINGS, {s: tok.token_to_id(s) for s in SPECIALS}, dropped)


def main(argv: list[str]) -> int:
    fixture, expected = build()
    files = [(FIXTURE, fixture), (EXPECTED, expected)]
    for form in SP_FORMS:
        files += zip(sp_paths(form), build_sp(form))
    if "--check" in argv:
        same = all(os.path.exists(p) and open(p, encoding="utf-8").read() == text for p, text in files)
        print("fixtures reproduced" if same else "a fixture differs from a fresh training")
        return 0 if same else 1
    os.makedirs(FIXTURES, exist_ok=True)
    for p, text in files:
        with open(p, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {os.path.relpath(p, ROOT)} ({len(text.encode())} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

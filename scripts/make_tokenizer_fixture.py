"""Write the Llama-3-style ``tokenizer.json`` fixture and its expected ids.

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

Writes ``tests/fixtures/llama3_style_tokenizer.json`` and, beside it,
``llama3_style_tokenizer.expected.json``: for each of ``STRINGS`` the ids
``tokenizers`` gives (post-processor included) and the text its
``decode`` gives back once pad, bos and eos are left out (what the serving
reader's ``decode`` returns), with the ``tokenizers`` version and Python's
``unicodedata`` version. ``--check`` writes nothing and exits 1 unless a
fresh training reproduces both files. The port's reader is held to these
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
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "llama3_style_tokenizer.json")
EXPECTED = os.path.join(ROOT, "tests", "fixtures", "llama3_style_tokenizer.expected.json")
VOCAB = 3000
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


def corpus() -> list[str]:
    return sorted(glob.glob(os.path.join(ROOT, "docs", "*.md")))


def build() -> tuple[str, str]:
    """The fixture's text and the expected ids' text."""
    import tokenizers
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
    cases = []
    for s in STRINGS:
        ids = tok.encode(s).ids
        cases.append({"text": s, "ids": ids, "decoded": tok.decode([i for i in ids if i not in dropped])})
    expected = json.dumps({
        "tokenizers": tokenizers.__version__,
        "unidata_version": unicodedata.unidata_version,
        "vocab_size": tok.get_vocab_size(),
        "specials": {s: tok.token_to_id(s) for s in SPECIALS},
        "cases": cases,
    }, ensure_ascii=False, indent=1) + "\n"
    return fixture, expected


def main(argv: list[str]) -> int:
    fixture, expected = build()
    if "--check" in argv:
        same = all(
            os.path.exists(p) and open(p, encoding="utf-8").read() == text
            for p, text in ((FIXTURE, fixture), (EXPECTED, expected))
        )
        print("fixture reproduced" if same else "fixture differs from a fresh training")
        return 0 if same else 1
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    for p, text in ((FIXTURE, fixture), (EXPECTED, expected)):
        with open(p, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {os.path.relpath(p, ROOT)} ({len(text.encode())} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
